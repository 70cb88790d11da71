"""The port's pipelined eval runner (nomad_tpu_torch/scheduler/pipeline.py).

Twins of tests/test_pipeline_runner.py on device="cpu" (the kernels'
plain versions): the pipelined runner must plan exactly what processing
the same evals one at a time plans; it changes only WHEN results are
collected.  Then the runner against the JAX package's on twin clusters
(nodes and ports, eval by eval, Python's ``random`` seeded alike for
the ports), and its entry point without a card.  Both packages read
NOMAD_TPU_EXECUTOR; every test here sets it.
"""
from __future__ import annotations

import queue
import random
import threading
import time

import numpy as np
import pytest
import torch

import nomad_tpu.mock as jmock
from nomad_tpu_torch import convert
from nomad_tpu_torch.scheduler import Harness, TorchBinPackScheduler
from nomad_tpu_torch.scheduler.executor import executor_override
from nomad_tpu_torch.scheduler.pipeline import (
    _STOP,
    PipelinedEvalRunner,
    _Item,
    same_walk,
)
from nomad_tpu_torch.structs import (
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_NODE_UPDATE,
    Evaluation,
    allocs_fit,
    generate_uuid,
)

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)


def make_eval(job):
    return Evaluation(
        id=generate_uuid(), priority=job.priority, type=job.type,
        triggered_by=EVAL_TRIGGER_JOB_REGISTER, job_id=job.id,
    )


def _cluster(n_nodes: int, n_jobs: int, count: int = 3, ref_jobs=None):
    """A port Harness on the CPU with ``n_nodes`` mock nodes and
    ``n_jobs`` mock jobs (or ``ref_jobs``, JAX-package jobs, converted);
    returns (harness, nodes, jobs)."""
    h = Harness(device="cpu")
    nodes = convert.nodes_from_reference([jmock.node(i)
                                          for i in range(n_nodes)])
    for n in nodes:
        h.state.upsert_node(h.next_index(), n)
    if ref_jobs is None:
        ref_jobs = []
        for _ in range(n_jobs):
            j = jmock.job()
            j.task_groups[0].count = count
            ref_jobs.append(j)
    jobs = convert.jobs_from_reference(ref_jobs)
    for j in jobs:
        h.state.upsert_job(h.next_index(), j)
    return h, nodes, jobs


def _plans(h, plans=None):
    """Each plan's placements (alloc name, node name, ports) and failed
    alloc names, in submit order."""
    names = {n.id: n.name for n in h.state.nodes()}
    return [(sorted((a.name, names[node_id], tuple(
        p for tr in a.task_resources.values() for n in tr.networks
        for p in n.reserved_ports))
        for node_id, allocs in p.node_allocation.items() for a in allocs),
        sorted(a.name for a in p.failed_allocs))
        for p in (h.plans if plans is None else plans)]


def _per_job(h):
    return {p.node_allocation and sorted(
        a.job_id for v in p.node_allocation.values() for a in v)[0]:
        sum(len(v) for v in p.node_allocation.values()) for p in h.plans}


@pytest.mark.parametrize("executor", ["host", "device"])
def test_pipeline_matches_sequential_processing(executor):
    """Same snapshot, same evals: the pipelined runner's plans equal
    one-at-a-time processing against that snapshot (nodes and ports),
    and its per-job placement counts equal Harness.process committing
    between evals."""
    h, _nodes, jobs = _cluster(16, 6)
    snap = h.state.snapshot()
    random.seed(31)
    with executor_override(executor):
        runner = PipelinedEvalRunner(snap, h, depth=3, device="cpu")
        runner.process([make_eval(j) for j in jobs])
    piped = _plans(h)

    h1, _, _ = _cluster(16, 0)
    for j in jobs:
        h1.state.upsert_job(h1.next_index(), j)
    snap1 = h1.state.snapshot()
    random.seed(31)
    with executor_override(executor):
        for j in jobs:
            TorchBinPackScheduler(snap1, h1, batch=False,
                                  device="cpu").process(make_eval(j))
    assert piped == _plans(h1)

    h2, _, _ = _cluster(16, 0)
    for j in jobs:
        h2.state.upsert_job(h2.next_index(), j)
    with executor_override(executor):
        for j in jobs:
            h2.process("torch-binpack", make_eval(j))
    assert len(h.plans) == len(jobs)
    assert _per_job(h) == _per_job(h2)
    assert all(e.status == "complete" for e in h.evals)
    assert len(runner.latencies) == len(jobs)


def test_pipeline_depth_one_equals_depth_many():
    h1, _, jobs = _cluster(12, 5)
    with executor_override("device"):
        PipelinedEvalRunner(h1.state.snapshot(), h1, depth=1,
                            device="cpu").process(
            [make_eval(j) for j in jobs])
        h2, _, _ = _cluster(12, 0)
        for j in jobs:
            h2.state.upsert_job(h2.next_index(), j)
        PipelinedEvalRunner(h2.state.snapshot(), h2, depth=8,
                            device="cpu").process(
            [make_eval(j) for j in jobs])

    def shape(plans):
        return sorted(
            (sum(len(v) for v in p.node_allocation.values()),
             len(p.failed_allocs)) for p in plans)

    assert shape(h1.plans) == shape(h2.plans)
    assert [[x[:2] for x in p[0]] for p in _plans(h1)] == \
        [[x[:2] for x in p[0]] for p in _plans(h2)]


def test_pipeline_plans_fit():
    h, nodes, jobs = _cluster(4, 3, count=2)
    for j in jobs:
        j.task_groups[0].tasks[0].resources.cpu = 1000
        h.state.upsert_job(h.next_index(), j)
    with executor_override("device"):
        runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=4,
                                     device="cpu")
        runner.process([make_eval(j) for j in jobs])
    by_node = {n.id: n for n in nodes}
    assert h.plans
    for plan in h.plans:
        for node_id, allocs in plan.node_allocation.items():
            fit, dim, _ = allocs_fit(by_node[node_id], allocs)
            assert fit, dim


def test_pipeline_serializes_same_job_evals():
    h, _, jobs = _cluster(8, 1, count=4)
    job = jobs[0]
    with executor_override("device"):
        runner = PipelinedEvalRunner(
            h.state.snapshot(), h, depth=4,
            state_refresh=lambda: h.state.snapshot(), device="cpu")
        runner.process([make_eval(job), make_eval(job)])
    live = [a for a in h.state.allocs_by_job(job.id)
            if not a.terminal_status()]
    assert len(live) == 4


def test_pipeline_windowed_drain_matches_sequential():
    """The drain stage's windowed finish driven DIRECTLY with the whole
    stream as one window (shared uuid slab, one native
    bulk_finish_many call): plans equal one-at-a-time processing.
    Deterministic on purpose: the window is built by hand (the front
    stage's steps inline) instead of racing the two threads."""
    h, _, jobs = _cluster(16, 6)
    random.seed(32)
    with executor_override("device"):
        runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=8,
                                     device="cpu")
        window = []
        for j in jobs:
            start = time.perf_counter()
            sched = runner._begin_eval(make_eval(j), finish_noop=False)
            assert sched is not None and sched.deferred is not None
            place, args = sched.deferred
            handles = sched.dispatch_device(args, pipelined=True)
            window.append(_Item(sched, place, args, handles, start))
        runner._drain_window(window)
    assert runner.windows == [len(jobs)]
    assert len(runner.latencies) == len(jobs)

    h2, _, _ = _cluster(16, 0)
    for j in jobs:
        h2.state.upsert_job(h2.next_index(), j)
    snap2 = h2.state.snapshot()
    random.seed(32)
    with executor_override("device"):
        for j in jobs:
            TorchBinPackScheduler(snap2, h2, batch=False,
                                  device="cpu").process(make_eval(j))
    assert _plans(h) == _plans(h2)
    assert all(e.status == "complete" for e in h.evals)


def test_pipeline_drain_error_propagates():
    """A failure in the drain stage surfaces to the caller instead of
    hanging the front stage on a full window."""
    class Boom(RuntimeError):
        pass

    class FailingDrain(PipelinedEvalRunner):
        def _drain_window(self, window):
            raise Boom("drain stage failure")

    h, _, jobs = _cluster(8, 4)
    with executor_override("device"):
        runner = FailingDrain(h.state.snapshot(), h, depth=2,
                              device="cpu")
        with pytest.raises(Boom):
            runner.process([make_eval(j) for j in jobs])
    assert runner._inflight <= runner.depth


def test_pipeline_drain_error_after_sentinel_in_window():
    """When the window gather has already consumed the _STOP sentinel
    and THEN the window fails, the error path must not wait for a
    sentinel that will never come (the front is in drain.join())."""
    class Boom(RuntimeError):
        pass

    class FailingDrain(PipelinedEvalRunner):
        def _drain_window(self, window):
            raise Boom("fails after sentinel consumed")

    h, _, _jobs = _cluster(4, 0)
    runner = FailingDrain(h.state.snapshot(), h, depth=4, device="cpu")
    q: queue.Queue = queue.Queue()
    q.put(_Item(None, None, None, None, 0.0))
    q.put(_STOP)  # gathered into the same window as the item
    t = threading.Thread(target=runner._drain_loop, args=(q,),
                         daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "drain loop deadlocked after sentinel"
    with runner._err_lock:
        assert isinstance(runner._drain_err, Boom)


def test_pipeline_handles_migrations_and_noops():
    """Evals whose plans carry deltas (node drain -> migrate) and no-op
    evals pipeline like any other."""
    h, nodes, jobs = _cluster(8, 2)
    with executor_override("device"):
        for j in jobs:
            h.process("torch-binpack", make_eval(j))
    for p in list(h.plans):
        allocs = [a for v in p.node_allocation.values() for a in v]
        h.state.upsert_allocs(h.next_index(), allocs)
    h.plans.clear()

    # Drain one node: its allocs must migrate.
    h.state.update_node_drain(h.next_index(), nodes[0].id, True)
    evs = []
    for j in jobs:
        ev = make_eval(j)
        ev.triggered_by = EVAL_TRIGGER_NODE_UPDATE
        evs.append(ev)
    with executor_override("device"):
        runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                     device="cpu")
        runner.process(evs)
    assert all(e.status == "complete" for e in h.evals)
    assert h.plans
    for plan in h.plans:
        for node_id in plan.node_allocation:
            assert node_id != nodes[0].id, "placed onto draining node"


@pytest.mark.parametrize("executor", ["host", "device", "auto"])
def test_pipeline_places_like_the_jax_pipeline(executor):
    """Twin clusters, the same stream (a config-1 job and a config-2
    shape with distinct_hosts): the port's PipelinedEvalRunner under
    each executor commits what the JAX package's does (its host
    executor, unsharded), node and ports, eval by eval."""
    from nomad_tpu.parallel.mesh import mesh_override
    from nomad_tpu.scheduler import Harness as JHarness
    from nomad_tpu.scheduler.executor import \
        executor_override as j_executor_override
    from nomad_tpu.scheduler.pipeline import \
        PipelinedEvalRunner as JRunner
    from nomad_tpu.structs import (CONSTRAINT_DISTINCT_HOSTS, Constraint,
                                   Evaluation as JEvaluation)

    ref_nodes = [jmock.node(i) for i in range(12)]
    ref_jobs = []
    for k in range(5):
        j = jmock.job()
        j.id = f"pipe-{k}"
        j.task_groups[0].count = 2 + k
        if k % 2:
            j.type = "batch"
            j.task_groups[0].constraints = [
                Constraint(hard=True, operand=CONSTRAINT_DISTINCT_HOSTS)]
        ref_jobs.append(j)
    evals = [make_eval(j) for j in ref_jobs]

    jh = JHarness()
    for n in ref_nodes:
        jh.state.upsert_node(jh.next_index(), n)
    for j in ref_jobs:
        jh.state.upsert_job(jh.next_index(), j)
    random.seed(33)
    with mesh_override("off"), j_executor_override("host"):
        JRunner(jh.state.snapshot(), jh, depth=3).process(
            [JEvaluation.from_dict(e.to_dict()) for e in evals])

    th = Harness(device="cpu")
    for n in convert.nodes_from_reference(ref_nodes):
        th.state.upsert_node(th.next_index(), n)
    for j in convert.jobs_from_reference(ref_jobs):
        th.state.upsert_job(th.next_index(), j)
    random.seed(33)
    with executor_override(executor):
        runner = PipelinedEvalRunner(th.state.snapshot(), th, depth=3,
                                     device="cpu")
        runner.process(evals)
    assert _plans(th) == _plans(jh)
    assert sum(len(p[0]) for p in _plans(th)) == 2 + 3 + 4 + 5 + 6
    assert runner.host_dispatches + runner.device_dispatches == 5
    if executor == "device":
        assert runner.device_dispatches == 5


@pytest.mark.parametrize("executor", ["host", "device", "auto"])
def test_the_runner_raises_without_a_card(executor, monkeypatch):
    """No device given means cuda, whatever the executor: without a
    card the constructor raises, it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h, _, _ = _cluster(4, 0)
    with executor_override(executor):
        with pytest.raises(RuntimeError):
            PipelinedEvalRunner(h.state.snapshot(), h)
        with pytest.raises(RuntimeError):
            Harness()


def test_same_walk_ignores_scores_where_nothing_was_placed():
    chosen = np.asarray([3, -1, 0], dtype=np.int32)
    assert same_walk((chosen, np.asarray([1.0, 9.0, 2.0])),
                     (chosen, np.asarray([1.0, 0.0, 2.0])))
    assert not same_walk((chosen, np.asarray([1.0, 0.0, 2.5])),
                         (chosen, np.asarray([1.0, 0.0, 2.0])))
    assert not same_walk((chosen, np.zeros(3)),
                         (chosen[::-1].copy(), np.zeros(3)))
