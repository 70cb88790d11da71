"""The port's group-commit applier against the JAX package's.

The recorded storm of tests/test_plan_batch.py (six jobs of four
two-copy groups on eight nodes, fused through the JAX package's
verifying planner), with the contended ask of
tests/test_torch_batch.py (800 cpu a copy: more than the eight nodes
hold, so lanes conflict and retry), is replayed through both applier stacks — broker,
plan queue, ``PlanApplier`` (partitioned window verify, committer
thread), ``InmemRaft`` and ``NomadFSM`` — on fresh twin worlds, as one
drained window and as the applier thread drains it.  Every plan's
verdict (accepted alloc ids per node, failed allocs, refresh) and the
final store digest must be byte-equal.  The port's side carries the
plans as ``convert.plans_from_reference`` rebuilds them.

Also the window mechanics of tests/test_plan_batch.py TestApplierWindow
on the port: one batched raft apply per window, the single-plan legacy
wire, the token fence, and the ``raft.apply`` fault site (an errored
batch apply answers every member and moves no state; the retry commits
exactly once).
"""
from __future__ import annotations

import time

import pytest

import nomad_tpu.mock as jmock
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.scheduler.batch import BatchEvalRunner as JRunner
from nomad_tpu.scheduler.harness import VerifyingPlanner as JVerifying
from nomad_tpu.server.eval_broker import EvalBroker as JBroker
from nomad_tpu.server.fsm import NomadFSM as JFSM
from nomad_tpu.server.plan_apply import PlanApplier as JApplier
from nomad_tpu.server.plan_queue import PlanQueue as JQueue
from nomad_tpu.server.raft import InmemRaft as JRaft
from nomad_tpu.structs import (
    EVAL_TRIGGER_JOB_REGISTER,
    Evaluation,
    NetworkResource,
    Resources,
    Task,
    TaskGroup,
    generate_uuid,
)
from nomad_tpu.structs import codec as jcodec
from nomad_tpu_torch import convert, faultinject
from nomad_tpu_torch.server.eval_broker import EvalBroker as TBroker
from nomad_tpu_torch.server.fsm import NomadFSM as TFSM
from nomad_tpu_torch.server.plan_apply import PlanApplier as TApplier
from nomad_tpu_torch.server.plan_queue import PlanQueue as TQueue
from nomad_tpu_torch.server.raft import InmemRaft as TRaft
from nomad_tpu_torch.structs import Allocation as TAllocation
from nomad_tpu_torch.structs import Plan as TPlan
from nomad_tpu_torch.structs import Resources as TResources
from nomad_tpu_torch.structs import codec as tcodec

STACKS = {
    "jax": (JBroker, JFSM, JRaft, JQueue, JApplier),
    "torch": (TBroker, TFSM, TRaft, TQueue, TApplier),
}


@pytest.fixture(scope="module")
def recorded():
    """The plans the JAX package's fused storm submitted through its
    verifying planner: first attempts and the retries of conflicted
    lanes, in submission order."""
    nodes = [jmock.node(i) for i in range(8)]
    h = JHarness()
    for n in nodes:
        h.state.upsert_node(h.next_index(), n.copy())
    jobs = []
    for _ in range(6):
        job = jmock.job()
        job.task_groups = [
            TaskGroup(name=f"tg-{g}", count=2,
                      tasks=[Task(name="web", driver="exec",
                                  resources=Resources(
                                      cpu=800, memory_mb=256,
                                      networks=[NetworkResource(
                                          mbits=5,
                                          dynamic_ports=["http"])]))])
            for g in range(4)]
        h.state.upsert_job(h.next_index(), job)
        jobs.append(job)
    h.planner = JVerifying(h)
    evals = [Evaluation(id=generate_uuid(), priority=50, type=j.type,
                        triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                        job_id=j.id) for j in jobs]
    JRunner(h.state.snapshot(), h, state_refresh=h.snapshot).process(evals)
    assert h.plans, "storm recorded no plans"
    return nodes, jobs, evals, list(h.plans)


class _Rig:
    """One package's leader commit pipeline on an empty world."""

    def __init__(self, package: str) -> None:
        broker_c, fsm_c, raft_c, queue_c, applier_c = STACKS[package]
        self.codec = jcodec if package == "jax" else tcodec
        self.applied: list = []
        self.broker = broker_c()
        self.broker.set_enabled(True)
        self.fsm = fsm_c(eval_broker=self.broker,
                         on_apply=lambda i, t, p: self.applied.append(t))
        self.raft = raft_c(self.fsm)
        self.queue = queue_c()
        self.queue.set_enabled(True)
        self.applier = applier_c(self.queue, self.broker, self.raft,
                                 lambda: self.fsm.state)

    def apply(self, msg_type, payload):
        return self.raft.apply(self.codec.encode(msg_type,
                                                 payload)).wait(5.0)

    def outstanding(self, ev_dict) -> str:
        """Commit an eval, hand it out, return its delivery token."""
        self.apply(jcodec.EVAL_UPDATE_REQUEST, {"evals": [ev_dict]})
        got, token = self.broker.dequeue([ev_dict["type"]], timeout=2.0)
        assert got.id == ev_dict["id"]
        return token

    def close(self) -> None:
        self.queue.set_enabled(False)
        self.broker.set_enabled(False)
        self.applier.shutdown(5.0)
        self.broker.shutdown()


def _verdict(result) -> tuple:
    return (
        {n: sorted(a.id for a in v)
         for n, v in result.node_update.items()},
        {n: sorted(a.id for a in v)
         for n, v in result.node_allocation.items()},
        sorted(a.id for a in result.failed_allocs),
        result.refresh_index > 0,
    )


def _replay(package, recorded, threaded):
    nodes, jobs, evals, plans = recorded
    if package == "torch":
        plans = convert.plans_from_reference(plans)
    rig = _Rig(package)
    try:
        for n in nodes:
            rig.apply(jcodec.NODE_REGISTER_REQUEST, {"node": n.to_dict()})
        for j in jobs:
            rig.apply(jcodec.JOB_REGISTER_REQUEST, {"job": j.to_dict()})
        by_eval = {}
        for ev in evals:
            d = ev.to_dict()
            d["status"] = "pending"
            by_eval[ev.id] = rig.outstanding(d)
        futures = []
        for plan in plans:
            plan.eval_token = by_eval[plan.eval_id]
            futures.append(rig.queue.enqueue(plan))
        if threaded:
            rig.applier.start()
        else:
            window = [rig.queue.dequeue(0)] + rig.queue.drain_pending(63)
            assert len(window) == len(plans)
            if package == "torch":
                rig.applier._apply_window(window, None)
            else:
                rig.applier._apply_window(window, None, None)
        verdicts = [_verdict(f.wait(10.0)) for f in futures]
        stats = rig.applier.stats()
        return (verdicts, rig.fsm.state.fingerprint(),
                rig.fsm.state.fingerprint(changelog_since=10**9), stats,
                rig.applied)
    finally:
        rig.close()


@pytest.mark.parametrize("threaded", [False, True],
                         ids=["one-window", "applier-thread"])
def test_recorded_storm_through_both_applier_stacks(recorded, threaded):
    j = _replay("jax", recorded, threaded)
    t = _replay("torch", recorded, threaded)
    assert t[0] == j[0], "verdicts differ"
    assert any(v[3] for v in t[0]), "the replay was meant to conflict"
    assert t[2] == j[2], "final stores differ"
    if not threaded:
        # one window, one batched apply: the changelogs match too
        assert t[1] == j[1]
        assert t[3]["commits"] == j[3]["commits"] == 1
        assert t[4] == j[4]
        assert t[3]["conflict_fallbacks"] == j[3]["conflict_fallbacks"]
    assert t[3]["plans_committed"] == j[3]["plans_committed"]


def _port_rig_with_node():
    rig = _Rig("torch")
    node = convert.nodes_from_reference([jmock.node()])[0]
    rig.apply(tcodec.NODE_REGISTER_REQUEST, {"node": node.to_dict()})
    rig.applied.clear()
    return rig, node


def _outstanding_plan(rig, node, cpu=500):
    ev = Evaluation(id=generate_uuid(), priority=50, type="service",
                    job_id=generate_uuid(), status="pending",
                    triggered_by="job-register")
    token = rig.outstanding(ev.to_dict())
    plan = TPlan(eval_id=ev.id, eval_token=token)
    plan.append_alloc(TAllocation(
        id=generate_uuid(), node_id=node.id, job_id=ev.job_id,
        task_group="web", resources=TResources(cpu=cpu, memory_mb=256),
        desired_status="run", client_status="pending"))
    return plan


def test_window_commits_as_one_batched_apply():
    rig, node = _port_rig_with_node()
    try:
        plans = [_outstanding_plan(rig, node) for _ in range(4)]
        rig.applied.clear()
        futures = [rig.queue.enqueue(p) for p in plans]
        window = [rig.queue.dequeue(0)] + rig.queue.drain_pending(63)
        rig.applier._apply_window(window, None)
        results = [f.wait(5.0) for f in futures]
        assert rig.applied == [tcodec.PLAN_BATCH_APPLY_REQUEST]
        assert len({r.alloc_index for r in results}) == 1
        assert len(rig.fsm.state.allocs_by_node(node.id)) == 4
        stats = rig.applier.stats()
        assert (stats["commits"], stats["plans_committed"],
                stats["batch_occupancy"]) == (1, 4, 4.0)
    finally:
        rig.close()


def test_single_plan_keeps_the_legacy_wire():
    rig, node = _port_rig_with_node()
    try:
        plan = _outstanding_plan(rig, node)
        rig.applied.clear()
        f = rig.queue.enqueue(plan)
        rig.applier._apply_window([rig.queue.dequeue(0)], None)
        assert f.wait(5.0).alloc_index > 0
        assert rig.applied == [tcodec.ALLOC_UPDATE_REQUEST]
    finally:
        rig.close()


def test_bad_tokens_fenced_out_of_window():
    rig, node = _port_rig_with_node()
    try:
        good = _outstanding_plan(rig, node)
        bad = _outstanding_plan(rig, node)
        bad.eval_token = "not-the-token"
        f_bad, f_good = rig.queue.enqueue(bad), rig.queue.enqueue(good)
        window = [rig.queue.dequeue(0)] + rig.queue.drain_pending(63)
        rig.applier._apply_window(window, None)
        with pytest.raises(RuntimeError, match="token does not match"):
            f_bad.wait(5.0)
        assert f_good.wait(5.0).alloc_index > 0
    finally:
        rig.close()


def test_expired_plan_dropped_before_verification():
    from nomad_tpu_torch.server.overload import ErrDeadlineExceeded

    rig, node = _port_rig_with_node()
    try:
        plan = _outstanding_plan(rig, node)
        plan.deadline = time.monotonic() - 1.0
        f = rig.queue.enqueue(plan)
        rig.applier._apply_window([rig.queue.dequeue(0)], None)
        with pytest.raises(ErrDeadlineExceeded):
            f.wait(5.0)
        assert rig.applier.stats()["expired_drops"] == 1
        assert not rig.fsm.state.allocs_by_node(node.id)
    finally:
        rig.close()


def test_errored_batch_apply_answers_every_member_and_retries_once():
    """The port's ``raft.apply`` fault site: an errored batch apply
    answers every member future with the error and moves no state; the
    retry commits the whole window exactly once."""
    rig, node = _port_rig_with_node()
    try:
        plans = [_outstanding_plan(rig, node) for _ in range(3)]
        fplan = faultinject.FaultPlan.parse("raft.apply=error(count=1)")
        with faultinject.injected(fplan):
            futures = [rig.queue.enqueue(p) for p in plans]
            window = [rig.queue.dequeue(0)] + rig.queue.drain_pending(63)
            rig.applier._apply_window(window, None)
            for f in futures:
                with pytest.raises(faultinject.FaultInjected):
                    f.wait(5.0)
            assert rig.fsm.state.allocs_by_node(node.id) == []
            futures = [rig.queue.enqueue(p) for p in plans]
            window = [rig.queue.dequeue(0)] + rig.queue.drain_pending(63)
            rig.applier._apply_window(window, None)
            for f in futures:
                assert f.wait(5.0).alloc_index > 0
        assert len(rig.fsm.state.allocs_by_node(node.id)) == 3
        assert fplan.fire_count("raft.apply") == 1
        assert rig.applier.stats()["dispatch_failures"] == 1
    finally:
        rig.close()


def test_k6_staging_is_never_shared_between_two_threads():
    """The applier thread launches K6 while the batch worker's thread
    launches K4/K5: K6's descriptor staging (``parallel/mesh._UPLOAD``,
    a ``PinnedStaging``) is thread-local, so a buffer one thread fills
    is never the one another thread is rewriting."""
    import threading

    import torch

    from nomad_tpu_torch.parallel import devices, mesh

    assert isinstance(mesh._UPLOAD, devices.PinnedStaging)
    assert isinstance(mesh._UPLOAD, threading.local)
    seen = {}
    barrier = threading.Barrier(2)

    def fill(name):
        staging = mesh._UPLOAD
        seen[name + ":before"] = staging.host
        staging.host = torch.full((4,), float(len(name)))
        barrier.wait(5.0)
        seen[name] = staging.host

    threads = [threading.Thread(target=fill, args=(n,))
               for n in ("applier", "worker-0")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5.0)
        assert not t.is_alive()
    assert seen["applier:before"] is None
    assert seen["worker-0:before"] is None
    assert seen["applier"] is not seen["worker-0"]
    assert seen["applier"].tolist() == [7.0] * 4
    assert seen["worker-0"].tolist() == [8.0] * 4


def test_the_port_applier_has_no_sequential_baseline():
    """The JAX applier's ``sequential=True`` (bench 5f's in-run
    baseline: per-plan fence, one flat walk, one apply in flight on the
    applier thread) is not ported; every other knob is, with the JAX
    defaults (ROADMAP Queue 3)."""
    import inspect

    jparams = dict(inspect.signature(JApplier).parameters)
    tparams = dict(inspect.signature(TApplier).parameters)
    assert "sequential" in jparams and "sequential" not in tparams
    del jparams["sequential"]
    assert set(tparams) == set(jparams) | {"device"}
    for name, param in jparams.items():
        assert tparams[name].default == param.default, name
