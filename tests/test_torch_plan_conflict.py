"""The port's window verify (nomad_tpu_torch/ops/plan_conflict.py) and
plan verifier (server/plan_apply.py) against the JAX package's.

Every world is built twice, once in each package, from the same nodes
and allocs (nomad_tpu_torch.convert); plans made in the JAX package are
carried over with ``plans_from_reference``, which keeps alloc ids.  The
JAX side verifies with its host engine, ``verify_override("host")``:
the engine the port has (the JAX package runs its device engine only on
a mesh of two or more devices).  Results must be identical: per plan
the accepted evictions, placements and failed allocs by alloc id and
whether a refresh was asked for, the fallback flags, and the final
store (every alloc's fields and the table indexes).
"""
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import nomad_tpu.mock as mock
from nomad_tpu.ops.plan_conflict import evaluate_window as j_window
from nomad_tpu.ops.verify_policy import verify_override
from nomad_tpu.parallel.mesh import mesh_override
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.scheduler.batch import BatchEvalRunner as JRunner
from nomad_tpu.scheduler.executor import executor_override
from nomad_tpu.scheduler.harness import VerifyingPlanner as JVerifying
from nomad_tpu.server.plan_apply import OptimisticSnapshot as JOverlay
from nomad_tpu.server.plan_apply import evaluate_plan as j_evaluate_plan
from nomad_tpu.state.store import StateStore as JStore
from nomad_tpu.structs import (
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    ALLOC_DESIRED_STATUS_STOP,
    EVAL_TRIGGER_JOB_REGISTER,
    Allocation,
    Evaluation,
    NetworkResource,
    Plan,
    Resources,
    Task,
    TaskGroup,
    generate_uuid,
)
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops.plan_conflict import MIN_CONCURRENT_COMPONENT
from nomad_tpu_torch.ops.plan_conflict import evaluate_window as t_window
from nomad_tpu_torch.ops.plan_conflict import partition_window
from nomad_tpu_torch.server.plan_apply import OptimisticSnapshot as TOverlay
from nomad_tpu_torch.server.plan_apply import evaluate_plan as t_evaluate_plan
from nomad_tpu_torch.state import StateStore as TStore
from nomad_tpu_torch.utils.metrics import metrics

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)

FREE_CPU = 3900  # mock node capacity 4000 minus 100 reserved


def make_alloc(node, *, cpu=1000, mem=1024, job_id="j1",
               desired=ALLOC_DESIRED_STATUS_RUN) -> Allocation:
    return Allocation(
        id=generate_uuid(), node_id=node.id, job_id=job_id,
        task_group="web", resources=Resources(cpu=cpu, memory_mb=mem),
        desired_status=desired, client_status=ALLOC_CLIENT_STATUS_PENDING)


def net_alloc(node, *, cpu=200, ports=(), mbits=10) -> Allocation:
    """An alloc whose offer claims ports/bandwidth on the node's one
    network."""
    a = make_alloc(node, cpu=cpu)
    ip = node.reserved.networks[0].ip
    a.task_resources = {"web": Resources(
        cpu=cpu, memory_mb=64,
        networks=[NetworkResource(device="eth0", ip=ip, mbits=mbits,
                                  reserved_ports=list(ports))])}
    return a


def place_plan(*allocs) -> Plan:
    plan = Plan(eval_id=generate_uuid(), priority=50)
    for a in allocs:
        plan.append_alloc(a)
    return plan


def result_key(result) -> tuple:
    return (
        {n: [a.id for a in v] for n, v in result.node_update.items()},
        {n: [a.id for a in v] for n, v in result.node_allocation.items()},
        [a.id for a in result.failed_allocs],
        result.refresh_index > 0,
    )


def store_image(store) -> tuple:
    return (
        {a.id: a.to_dict() for a in store.allocs()},
        {t: store.get_index(t) for t in ("nodes", "jobs", "evals", "allocs")},
    )


def _accepted(result) -> list:
    allocs = []
    for v in result.node_update.values():
        allocs.extend(v)
    for v in result.node_allocation.values():
        allocs.extend(v)
    allocs.extend(result.failed_allocs)
    return allocs


def _worlds(nodes, existing=()):
    """The same nodes (indexes 1000+) and existing allocs (index 1500)
    in a JAX store and a port store."""
    js, ts = JStore(), TStore()
    for i, (jn, tn) in enumerate(zip(nodes,
                                     convert.nodes_from_reference(nodes))):
        js.upsert_node(1000 + i, jn.copy())
        ts.upsert_node(1000 + i, tn)
    if existing:
        js.upsert_allocs(1500, [a.copy() for a in existing])
        ts.upsert_allocs(1500, convert.allocs_from_reference(existing))
    return js, ts


def grouped_apply(window, store, plans, base_index, partition=True,
                  executor=None):
    """One window verify, one batched upsert, one index per plan."""
    outcomes = window(store, plans, executor=executor, partition=partition)
    items = [(base_index + i, _accepted(o.result))
             for i, o in enumerate(outcomes) if _accepted(o.result)]
    if items:
        store.upsert_allocs_batched(items)
    return outcomes


def sequential_apply(evaluate, store, plans, base_index):
    """The reference semantics: each plan against live state in eval
    order, its accepted portion committed before the next."""
    results = []
    for i, plan in enumerate(plans):
        result = evaluate(store, plan)
        if _accepted(result):
            store.upsert_allocs(base_index + i, _accepted(result))
        results.append(result)
    return results


def partition_info(outcomes):
    """The claim-graph partition a window reported, or None."""
    if outcomes.info is None:
        return None
    return {k: outcomes.info[k] for k in ("components", "sizes", "order")}


def _both_windows(nodes, plans, existing=(), partition=True,
                  executors=(None, None)):
    """The window through both packages on twin worlds; asserts equal
    verdicts, fallbacks, component indexes, partitions and stores and
    returns the port's outcomes."""
    js, ts = _worlds(nodes, existing)
    tplans = convert.plans_from_reference(plans)
    with verify_override("host"):
        j_out = grouped_apply(j_window, js, plans, 2000, partition,
                              executors[0])
    t_out = grouped_apply(t_window, ts, tplans, 2000, partition,
                          executors[1])
    assert [result_key(o.result) for o in t_out] == \
        [result_key(o.result) for o in j_out]
    assert [o.fallback for o in t_out] == [o.fallback for o in j_out]
    assert [o.component for o in t_out] == [o.component for o in j_out]
    assert partition_info(t_out) == partition_info(j_out)
    assert store_image(ts) == store_image(js)
    return t_out


# -- window semantics, on both packages ------------------------------------


@pytest.mark.parametrize("partition", [True, False])
class TestWindowSemanticsLikeJax:
    """Twins of tests/test_plan_batch.py TestWindowSemantics."""

    def test_disjoint_window_full_accepts(self, partition):
        nodes = [mock.node(i) for i in range(4)]
        plans = [place_plan(make_alloc(n)) for n in nodes]
        out = _both_windows(nodes, plans, partition=partition)
        tplans = convert.plans_from_reference(plans)
        assert all(o.result.full_commit(p)[0]
                   for o, p in zip(out, tplans))
        assert not any(o.fallback for o in out)

    def test_prefix_conflict_is_order_sensitive(self, partition):
        node = mock.node()
        first = place_plan(make_alloc(node, cpu=FREE_CPU))
        second = place_plan(make_alloc(node, cpu=1000))
        out = _both_windows([node], [first, second], partition=partition)
        assert result_key(out[0].result)[1] == \
            {node.id: [a.id for a in first.node_allocation[node.id]]}
        assert out[1].result.node_allocation == {}
        assert out[1].result.refresh_index > 0
        assert not out[0].fallback and out[1].fallback

    def test_window_port_collision_rejects_later_plan(self, partition):
        node = mock.node()
        first = place_plan(net_alloc(node, ports=[8080]))
        second = place_plan(net_alloc(node, ports=[8080]))
        out = _both_windows([node], [first, second], partition=partition)
        assert out[0].result.node_allocation
        assert out[1].result.node_allocation == {}

    def test_window_evict_frees_capacity_for_later_plan(self, partition):
        node = mock.node()
        existing = make_alloc(node, cpu=FREE_CPU)
        evict = Plan(eval_id=generate_uuid())
        evict.append_update(existing, ALLOC_DESIRED_STATUS_STOP, "gone")
        refill = place_plan(make_alloc(node, cpu=FREE_CPU))
        out = _both_windows([node], [evict, refill], existing=[existing],
                            partition=partition)
        assert out[0].result.node_update
        assert out[1].result.node_allocation, \
            "the window overlay must see the eviction's freed capacity"

    def test_all_at_once_window_member(self, partition):
        good, full = mock.node(), mock.node(1)
        plan = place_plan(make_alloc(good), make_alloc(full, cpu=1000))
        plan.all_at_once = True
        out = _both_windows(
            [good, full], [plan, place_plan(make_alloc(good, cpu=100))],
            existing=[make_alloc(full, cpu=FREE_CPU)], partition=partition)
        assert out[0].result.node_allocation == {}
        assert out[0].result.refresh_index > 0
        assert out[1].result.node_allocation


def test_window_respects_inflight_overlay_like_jax():
    """Claims against a node the in-flight apply already filled reject,
    in both packages."""
    a, b = mock.node(), mock.node(1)
    js, ts = _worlds([a, b])
    inflight = make_alloc(a, cpu=FREE_CPU)
    plans = [place_plan(make_alloc(a, cpu=1000)),
             place_plan(make_alloc(b, cpu=1000))]
    jsnap = JOverlay(js.snapshot())
    jsnap.upsert_allocs([inflight])
    tsnap = TOverlay(ts.snapshot())
    tsnap.upsert_allocs(convert.allocs_from_reference([inflight]))
    with verify_override("host"):
        j_out = j_window(jsnap, plans)
    t_out = t_window(tsnap, convert.plans_from_reference(plans))
    assert [result_key(o.result) for o in t_out] == \
        [result_key(o.result) for o in j_out]
    assert t_out[0].result.node_allocation == {}
    assert t_out[1].result.node_allocation
    # the caller's overlay ends as sequential application leaves it
    assert sorted(tsnap._overlay) == sorted(jsnap._overlay)


def test_evaluate_plan_matches_jax():
    """The per-plan verifier (vector pass + exact scalar walk) on a
    plan that fits one node and over-commits another."""
    nodes = [mock.node(i) for i in range(3)]
    existing = [make_alloc(nodes[1], cpu=3000), net_alloc(nodes[2],
                                                          ports=[7000])]
    plan = place_plan(make_alloc(nodes[0], cpu=2000),
                      make_alloc(nodes[1], cpu=1000),
                      net_alloc(nodes[2], ports=[7000]))
    js, ts = _worlds(nodes, existing)
    j_res = j_evaluate_plan(js, plan)
    before = metrics.timers.get("nomad.plan.evaluate", [0, 0.0])[0]
    t_res = t_evaluate_plan(ts, convert.plans_from_reference([plan])[0])
    assert result_key(t_res) == result_key(j_res)
    assert set(t_res.node_allocation) == {nodes[0].id}
    # the verify time went to the metrics timer
    count, seconds = metrics.timers["nomad.plan.evaluate"]
    assert count == before + 1 and seconds > 0


class _PoolExecutor:
    """A component executor: runs the walks on a thread pool and
    returns their results in task order."""

    def __init__(self) -> None:
        self.pool = ThreadPoolExecutor(max_workers=2)
        self.batches = 0
        self.components_run = 0

    def run_components(self, tasks, descs=None):
        self.batches += 1
        self.components_run += len(tasks)
        return [f.result() for f in [self.pool.submit(t) for t in tasks]]


def test_big_component_rides_the_executor_like_jax():
    """Twin of tests/test_plan_batch.py test_big_component_rides_the_
    executor: a contended component of MIN_CONCURRENT_COMPONENT plans on
    one node sends the window's walks to the executor in both packages,
    and the verdicts equal the JAX package's and sequential
    application."""
    from nomad_tpu.server.plan_apply import ComponentExecutor

    shared = mock.node()
    others = [mock.node(i + 1) for i in range(4)]
    nodes = [shared] + others
    plans = [place_plan(make_alloc(shared, cpu=600))
             for _ in range(MIN_CONCURRENT_COMPONENT)]
    plans += [place_plan(make_alloc(n)) for n in others]
    j_exec, t_exec = ComponentExecutor(workers=2), _PoolExecutor()
    try:
        out = _both_windows(nodes, plans, executors=(j_exec, t_exec))
        assert j_exec.stats()["batches"] >= 1
    finally:
        j_exec.stop()
        t_exec.pool.shutdown()
    assert (t_exec.batches, t_exec.components_run) == (1, 5)
    assert partition_info(out)["sizes"] == [MIN_CONCURRENT_COMPONENT,
                                            1, 1, 1, 1]
    assert any(o.result.refresh_index for o in out), \
        "the shared node was meant to overflow"
    _js, ts_seq = _worlds(nodes)
    seq = sequential_apply(t_evaluate_plan, ts_seq,
                           convert.plans_from_reference(plans), 2000)
    assert [result_key(r) for r in seq] == \
        [result_key(o.result) for o in out]


def test_partition_window_components():
    nodes = [mock.node(i) for i in range(4)]
    plans = convert.plans_from_reference([
        place_plan(make_alloc(nodes[0])),
        place_plan(make_alloc(nodes[1])),
        place_plan(make_alloc(nodes[0]), make_alloc(nodes[2])),
        place_plan(make_alloc(nodes[3])),
        place_plan(make_alloc(nodes[2]))])
    assert partition_window(plans) == [[0, 2, 4], [1], [3]]


# -- a recorded contended storm ---------------------------------------------


def _record_storm(cpu):
    """A real contended plan stream: a fused storm of 6 jobs x 4 groups
    of 2 copies on 8 nodes through the JAX package's VerifyingPlanner
    (tests/test_plan_batch.py test_recorded_contended_storm_stream_
    parity)."""
    nodes = [mock.node(i) for i in range(8)]
    h = JHarness()
    for n in nodes:
        h.state.upsert_node(h.next_index(), n.copy())
    jobs = []
    for _ in range(6):
        job = mock.job()
        job.task_groups = [
            TaskGroup(name=f"tg-{g}", count=2, tasks=[Task(
                name="web", driver="exec", resources=Resources(
                    cpu=cpu, memory_mb=256, networks=[NetworkResource(
                        mbits=5, dynamic_ports=["http"])]))])
            for g in range(4)]
        h.state.upsert_job(h.next_index(), job)
        jobs.append(job)
    h.planner = JVerifying(h)
    evals = [Evaluation(id=generate_uuid(), priority=50, type=j.type,
                        triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                        job_id=j.id) for j in jobs]
    with mesh_override("off"), executor_override("device"), \
            verify_override("host"):
        JRunner(h.state.snapshot(), h,
                state_refresh=h.snapshot).process(evals)
    assert h.plans, "storm recorded no plans"
    return nodes, h.plans


@pytest.mark.parametrize("partition", [True, False])
@pytest.mark.parametrize("cpu", [600, 800])
def test_recorded_storm_window_like_jax(cpu, partition):
    """The recorded stream applied as one window through each package's
    evaluate_window on twin worlds: identical verdicts and stores, both
    equal to sequential application in the port."""
    nodes, plans = _record_storm(cpu)
    out = _both_windows(nodes, plans, partition=partition)
    if cpu == 800:
        assert any(o.result.refresh_index for o in out), \
            "the recorded stream was meant to conflict"
    _js, ts_seq = _worlds(nodes)
    seq = sequential_apply(t_evaluate_plan, ts_seq,
                           convert.plans_from_reference(plans), 2000)
    assert [result_key(r) for r in seq] == \
        [result_key(o.result) for o in out]


def test_plans_round_trip_through_the_port():
    """JAX plan -> port plan -> to_dict() is the JAX plan's dict, alloc
    ids and all."""
    _nodes, plans = _record_storm(600)
    plans = plans + [place_plan(net_alloc(mock.node(), ports=[81]))]
    tplans = convert.plans_from_reference(plans)
    assert [type(p).__module__.split(".")[0] for p in tplans] == \
        ["nomad_tpu_torch"] * len(plans)
    assert [p.to_dict() for p in tplans] == [p.to_dict() for p in plans]
    assert convert.plans_from_reference([plans[0].to_dict()])[0].to_dict() \
        == plans[0].to_dict()


@pytest.mark.parametrize("cpu", [600, 800])
def test_sharded_device_window_like_jax(cpu, monkeypatch):
    """The applier's mesh path: the recorded stream as one window under
    the ``device`` verify policy on a mesh of eight cpu entries (the
    port) and on the JAX package's 8-device mesh.  Both verify on the
    device through window_verify_sharded, warmed outside the lock, and
    their verdicts and stores equal each other and the host engine's."""
    from nomad_tpu.ops.verify_policy import verify_override as jv
    from nomad_tpu_torch.ops.verify_policy import verify_override as tv
    from nomad_tpu_torch.parallel import mesh as tmesh

    nodes, plans = _record_storm(cpu)
    seen = []
    real = tmesh.window_verify_sharded
    monkeypatch.setattr(tmesh, "window_verify_sharded",
                        lambda mesh, *a, **kw: seen.append(mesh)
                        or real(mesh, *a, **kw))
    js, ts = _worlds(nodes)
    tplans = convert.plans_from_reference(plans)
    with jv("device"), mesh_override("auto"):
        # The JAX engine's first window on a fresh fleet generation
        # misses its lease (it warms before the mirror's first sync);
        # a throwaway window warms it.  The port's first window holds it.
        j_window(js, plans)
        j_out = grouped_apply(j_window, js, plans, 2000)
    with tv("device"), tmesh.mesh_override(["cpu"] * 8):
        t_out = grouped_apply(t_window, ts, tplans, 2000)
    assert j_out.info["device"]["dispatched"]
    assert t_out.info["device"]["dispatched"]
    assert t_out.info["device"]["fallback"] is None
    assert len(seen) == 1 and seen[0].shape == {"fleet": 8}
    assert [result_key(o.result) for o in t_out] == \
        [result_key(o.result) for o in j_out]
    assert store_image(ts) == store_image(js)
    _js, th = _worlds(nodes)
    with tv("host"):
        h_out = grouped_apply(t_window, th, convert.plans_from_reference(
            plans), 2000)
    assert [result_key(o.result) for o in h_out] == \
        [result_key(o.result) for o in t_out]
