"""The port's system schedulers against the JAX package's.

``system`` is the vectorized scheduler (nomad_tpu_torch/scheduler/
system_vec.py: numpy fit + ScoreFit over the fleet, then the native
bulk finish of csrc/port_alloc.cpp, object contract, node-pinned
coalescing), ``system-seq`` the sequential iterator chain
(scheduler/system.py).  Twins of tests/test_system_vec.py: each world is
built once with the JAX package's mock, run through its ``system``, and
converted (nomad_tpu_torch.convert) into the port, where ``system`` and
``system-seq`` run on the same nodes and job.  Plans must agree in the
nodes and task groups placed and the failures; the port's ``system``
also equals the JAX ``system`` in ports (Python's ``random``, which
seeds each plan's port LCG, is seeded alike) and in scores (rtol 1e-6:
both fit in numpy float32/float64 alike).
"""
from __future__ import annotations

import contextlib
import random

import pytest
import torch

import nomad_tpu.mock as mock
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.structs import (
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_NODE_UPDATE,
    Constraint,
    Evaluation,
    NetworkResource,
    Resources,
)
from nomad_tpu_torch import convert
from nomad_tpu_torch.scheduler import Harness as THarness
from nomad_tpu_torch.scheduler import VectorSystemScheduler
from nomad_tpu_torch.scheduler import torch_binpack
from nomad_tpu_torch.structs import Evaluation as TEvaluation
from nomad_tpu_torch.structs import allocs_fit as t_allocs_fit

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)


def sys_eval(job, trigger=EVAL_TRIGGER_JOB_REGISTER):
    return Evaluation(id=f"ev-{job.id}-{trigger}", priority=job.priority,
                      type="system", triggered_by=trigger, job_id=job.id)


def plan_summary(plan):
    """Comparable plan shape: node -> (tg names), failed count."""
    placed = {}
    for node_id, allocs in plan.node_allocation.items():
        placed[node_id] = sorted((a.task_group, a.name) for a in allocs)
    return placed, len(plan.failed_allocs)


def plan_ports(plan):
    """node -> sorted (alloc name, reserved ports)."""
    return {node_id: sorted((a.name, tuple(
        p for tr in a.task_resources.values() for n in tr.networks
        for p in n.reserved_ports)) for a in allocs)
        for node_id, allocs in plan.node_allocation.items()}


def plan_scores(plan):
    return {node_id: sorted(v for a in allocs
                            for v in a.metrics.scores.values())
            for node_id, allocs in plan.node_allocation.items()}


@contextlib.contextmanager
def _seeded(seed=11):
    saved = random.getstate()
    random.seed(seed)
    try:
        yield
    finally:
        random.setstate(saved)


def build_nodes(n: int, constrained: bool = False):
    nodes = []
    for i in range(n):
        node = mock.node(i)
        if constrained and i % 3 == 0:
            node.attributes["kernel.name"] = "windows"
        nodes.append(node)
    return nodes


class World:
    """One world (JAX nodes and a JAX job) in three harnesses: the JAX
    package under ``system``, the port under ``system`` and under
    ``system-seq``."""

    NAMES = ("jax", "system", "system-seq")

    def __init__(self, nodes, job) -> None:
        self.nodes = nodes
        self.job = job
        self.h = {"jax": JHarness(), "system": THarness(device="cpu"),
                  "system-seq": THarness(device="cpu")}
        for name, h in self.h.items():
            for n in self._nodes(name):
                h.state.upsert_node(h.next_index(), n)
            h.state.upsert_job(h.next_index(), self._convert(name, [job])[0])

    def _convert(self, name, objs):
        return objs if name == "jax" else convert.jobs_from_reference(objs)

    def _nodes(self, name):
        return self.nodes if name == "jax" else \
            convert.nodes_from_reference(self.nodes)

    def upsert_node(self, node) -> None:
        for name, h in self.h.items():
            (n,) = [node] if name == "jax" else \
                convert.nodes_from_reference([node])
            h.state.upsert_node(h.next_index(), n)

    def process(self, trigger=EVAL_TRIGGER_JOB_REGISTER) -> dict:
        ev = sys_eval(self.job, trigger)
        plans = {}
        for name, h in self.h.items():
            with _seeded():
                if name == "jax":
                    h.process("system", ev)
                else:
                    h.process(name, TEvaluation.from_dict(ev.to_dict()))
            assert h.plans, name
            plans[name] = h.plans[-1]
        return plans


def run_all(n_nodes: int, job_fn, constrained=False) -> tuple:
    world = World(build_nodes(n_nodes, constrained), job_fn())
    return world, world.process()


def assert_parity(plans):
    """The port's system and system-seq equal the JAX system in nodes,
    task groups and failures; the port's system equals it in ports."""
    want = plan_summary(plans["jax"])
    assert plan_summary(plans["system"]) == want
    assert plan_summary(plans["system-seq"]) == want
    assert plan_ports(plans["system"]) == plan_ports(plans["jax"])
    return want


def test_system_parity_simple():
    _w, plans = run_all(17, mock.system_job)
    placed, failed = assert_parity(plans)
    assert len(placed) == 17 and failed == 0


def test_system_parity_constrained_nodes():
    _w, plans = run_all(20, mock.system_job, constrained=True)
    placed, _ = assert_parity(plans)
    # Only linux nodes take the job (mock system job requires linux).
    assert len(placed) == 20 - 7


def test_system_parity_multi_tg_and_network():
    def job_fn():
        j = mock.system_job()
        tg2 = j.task_groups[0].copy()
        tg2.name = "sidecar"
        tg2.tasks[0].resources = Resources(
            cpu=64, memory_mb=32,
            networks=[NetworkResource(mbits=4, dynamic_ports=["metrics"])])
        j.task_groups.append(tg2)
        return j

    _w, plans = run_all(9, job_fn)
    placed, failed = assert_parity(plans)
    assert failed == 0
    assert all(len(v) == 2 for v in placed.values())
    # Dynamic ports actually assigned, unique per node.
    for node_id, rows in plan_ports(plans["system"]).items():
        ports = [p for _name, ps in rows for p in ps]
        assert ports and len(ports) == len(set(ports))


def test_system_parity_exhaustion():
    """Nodes too small for the ask fail identically on every path."""
    def job_fn():
        j = mock.system_job()
        j.task_groups[0].tasks[0].resources = Resources(
            cpu=100_000, memory_mb=64)
        return j

    _w, plans = run_all(5, job_fn)
    placed, failed = assert_parity(plans)
    assert not placed
    # One failed alloc, the rest coalesced (every path coalesces).
    assert failed == 1
    assert {name: p.failed_allocs[0].metrics.coalesced_failures
            for name, p in plans.items()} == \
        {name: 4 for name in World.NAMES}


def test_system_vec_plans_fit_and_scores_match():
    """Every plan fits its nodes; the port's system records the JAX
    system's binpack scores, and the sequential chain's within 1e-4."""
    world, plans = run_all(8, mock.system_job)
    assert_parity(plans)
    by_id = {n.id: n for n in world.h["system"].state.nodes()}
    for node_id, allocs in plans["system"].node_allocation.items():
        fit, dim, _ = t_allocs_fit(by_id[node_id], allocs)
        assert fit, dim
        for a in allocs:
            assert a.metrics.scores  # binpack score recorded
    s_jax, s_vec, s_seq = (plan_scores(plans[n]) for n in World.NAMES)
    assert set(s_vec) == set(s_jax) == set(s_seq)
    for nid in s_vec:
        assert s_vec[nid] == pytest.approx(s_jax[nid], rel=1e-6)
        assert s_vec[nid] == pytest.approx(s_seq[nid], abs=1e-4)


def test_system_vec_node_update_migrates():
    """Node-update trigger: the drained node's allocs stop, on every
    path alike."""
    world, plans = run_all(4, mock.system_job)
    assert_parity(plans)
    drained = world.nodes[0].copy()
    drained.drain = True
    world.upsert_node(drained)
    plans = world.process(EVAL_TRIGGER_NODE_UPDATE)
    stopped = {name: sorted((a.node_id, a.name) for allocs in
                            p.node_update.values() for a in allocs)
               for name, p in plans.items()}
    assert stopped["system"] == stopped["system-seq"] == stopped["jax"]
    assert any(nid == drained.id for nid, _n in stopped["system"])


def test_system_parity_count_gt_one_tight_node():
    """System TG with count > 1 on nodes that fit only one copy: the
    batched fit must not check both copies against pre-accumulation
    usage (the exact per-placement walk takes the slot)."""
    def job_fn():
        j = mock.system_job()
        tg = j.task_groups[0]
        tg.count = 2
        # One copy fits a mock node (4000 cpu / 8192 mb); two do not.
        tg.tasks[0].resources = Resources(cpu=2500, memory_mb=5000)
        return j

    world, plans = run_all(5, job_fn)
    s1, _f1 = assert_parity(plans)
    h = world.h["system"]
    for node_id, placed in s1.items():
        node = h.state.node_by_id(node_id)
        allocs = [a for al in plans["system"].node_allocation.values()
                  for a in al if a.node_id == node_id]
        fit, _dim, _util = t_allocs_fit(node, allocs)
        assert fit, f"oversubscribed node {node_id}: {placed}"


def test_system_vec_failures_carry_explanations():
    """A mask-rejected system placement's failed alloc carries the
    node's actual constraint verdict, as in the JAX package and the
    sequential chain."""
    def job_fn():
        j = mock.system_job()
        j.task_groups[0].constraints = [
            Constraint(hard=True, l_target="$attr.kernel.name",
                       r_target="plan9", operand="=")]
        return j

    _w, plans = run_all(4, job_fn)
    assert_parity(plans)
    verdicts = {}
    for name, plan in plans.items():
        assert plan.failed_allocs
        m = plan.failed_allocs[0].metrics
        assert sum(m.constraint_filtered.values()) >= 1, (
            m.constraint_filtered)
        verdicts[name] = (m.constraint_filtered, m.coalesced_failures)
    assert verdicts["system"] == verdicts["jax"]


def test_system_native_prefix_equals_python_tail(monkeypatch):
    """The vectorized scheduler's native finish (bulk_finish, node-pinned
    coalescing) against its Python loop alone, same LCG seed: equal
    nodes, ports and failures, on a world with failures."""
    def job_fn():
        j = mock.system_job()
        tg2 = j.task_groups[0].copy()
        tg2.name = "big"
        tg2.tasks[0].resources = Resources(
            cpu=3000, memory_mb=64,
            networks=[NetworkResource(mbits=4, dynamic_ports=["a", "b"])])
        j.task_groups.append(tg2)
        return j

    nodes = build_nodes(12, constrained=True)
    job = job_fn()
    out = []
    for native_on in (True, False):
        with monkeypatch.context() as m:
            if not native_on:
                m.setattr(torch_binpack, "_native_bulk", lambda: None)
            plans = World(nodes, job).process()
        out.append((plan_summary(plans["system"]),
                    plan_ports(plans["system"]),
                    [a.metrics.coalesced_failures
                     for a in plans["system"].failed_allocs]))
    assert out[0] == out[1]
    assert out[0][0][1] > 0  # the constrained nodes failed


def test_system_scheduler_needs_a_device(monkeypatch):
    """Like the other schedulers: no device means cuda, and without
    one it raises; the harness's device is the scheduler's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        VectorSystemScheduler(None, None)
    h = THarness(device="cpu")
    from nomad_tpu_torch.scheduler import new_scheduler
    sched = new_scheduler("system", h.snapshot(), h)
    assert isinstance(sched, VectorSystemScheduler)
    assert sched.device == torch.device("cpu")
