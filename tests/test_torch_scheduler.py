"""The torch-binpack slice as a whole against jax-binpack.

One mock cluster (node sizes drawn from a seed) is loaded into the JAX
package's Harness and, through nomad_tpu_torch.convert, into the port's
Harness on the CPU.  The same jobs run through ``jax-binpack`` (forced
onto its jit kernels with executor_override("device")) and through
``torch-binpack`` (onto the kernels' plain versions by the port's own
override: the cost policy would keep these shapes on the numpy twins);
every plan is committed before the next eval, so the usage mirror's
sync and scatter path runs between evals.  For each
alloc name the node it landed on must be equal, as must the failed
allocs and the eval status.  Ports are random by design, so only their
count is compared.
"""
import numpy as np
import pytest
import torch

import nomad_tpu.mock as mock
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.scheduler.executor import executor_override
from nomad_tpu.structs import (
    CONSTRAINT_DISTINCT_HOSTS,
    EVAL_TRIGGER_JOB_REGISTER,
    Constraint,
    Evaluation,
    NetworkResource,
    Resources,
    Task,
    TaskGroup,
    generate_uuid,
)
from nomad_tpu_torch import convert
from nomad_tpu_torch.models.fleet import fleet_cache, mirror_for
from nomad_tpu_torch.scheduler import Harness as THarness
from nomad_tpu_torch.scheduler.executor import executor_override as \
    t_executor_override
from nomad_tpu_torch.structs import Evaluation as TEvaluation

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)


def _bench_task_group(name):
    """bench.py _bench_task_group: the config 4/5 workload shape."""
    return TaskGroup(name=name, count=1, tasks=[Task(
        name="web", driver="exec", resources=Resources(
            cpu=100, memory_mb=64,
            networks=[NetworkResource(mbits=5, dynamic_ports=["http"])]))])


def _config1_job():
    return mock.job()


def _config2_job():
    """bench.py _config2_jobs: batch, 10 TGs x 4 with a constraint
    stanza and distinct_hosts."""
    j = mock.job()
    j.type = "batch"
    groups = []
    for g in range(10):
        tg = _bench_task_group(f"tg-{g}")
        tg.count = 4
        tg.constraints = [
            Constraint(hard=True, l_target="$attr.kernel.name",
                       r_target="linux", operand="="),
            Constraint(hard=True, operand=CONSTRAINT_DISTINCT_HOSTS),
        ]
        groups.append(tg)
    j.task_groups = groups
    return j


def _config4_job(n_groups=40):
    j = mock.job()
    j.task_groups = [_bench_task_group(f"tg-{g}") for g in range(n_groups)]
    return j


def _sequence_job():
    """Asks large next to a node, so one more copy gains more packing
    score than the anti-affinity penalty costs: not rounds-eligible,
    the place_sequence kernel takes it."""
    j = mock.job()
    tg = j.task_groups[0]
    tg.count = 12
    tg.tasks[0].resources = Resources(
        cpu=1500, memory_mb=3000,
        networks=[NetworkResource(mbits=10, dynamic_ports=["http"])])
    return j


def _nodes(n, seed):
    rng = np.random.default_rng(seed)
    nodes = [mock.node(i) for i in range(n)]
    for node in nodes:
        node.resources.cpu = int(rng.integers(2000, 6000))
        node.resources.memory_mb = int(rng.integers(4096, 12288))
    return nodes


def _outcome(h, job_id):
    plan = h.plans[-1]
    placed = {}
    ports = {}
    for node_id, allocs in plan.node_allocation.items():
        for a in allocs:
            assert a.job_id == job_id
            placed[a.name] = node_id
            ports[a.name] = sum(len(n.reserved_ports)
                                for tr in a.task_resources.values()
                                for n in tr.networks)
    failed = sorted(a.name for a in plan.failed_allocs)
    return placed, ports, failed, h.evals[-1].status


def _run_both(jobs, nodes):
    jh = JHarness()
    th = THarness(device="cpu")
    for i, (jn, tn) in enumerate(zip(nodes,
                                     convert.nodes_from_reference(nodes))):
        jh.state.upsert_node(jh.next_index(), jn)
        th.state.upsert_node(th.next_index(), tn)
    outcomes = []
    for job in jobs:
        jh.state.upsert_job(jh.next_index(), job)
        (tjob,) = convert.jobs_from_reference([job])
        th.state.upsert_job(th.next_index(), tjob)
        ev = Evaluation(id=generate_uuid(), priority=job.priority,
                        type=job.type,
                        triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                        job_id=job.id)
        with executor_override("device"):
            jh.process("jax-binpack-batch" if job.type == "batch"
                       else "jax-binpack", ev)
        with t_executor_override("device"):
            th.process("torch-binpack-batch" if job.type == "batch"
                       else "torch-binpack",
                       TEvaluation.from_dict(ev.to_dict()))
        outcomes.append((_outcome(jh, job.id), _outcome(th, job.id)))
    return jh, th, outcomes


@pytest.mark.parametrize("seed", [1, 2])
def test_slice_places_like_jax_binpack(seed):
    nodes = _nodes(64, seed)
    jobs = [_config1_job(), _config2_job(), _config4_job(),
            _sequence_job(), _config4_job()]
    _jh, th, outcomes = _run_both(jobs, nodes)
    for (j_placed, j_ports, j_failed, j_status), \
            (t_placed, t_ports, t_failed, t_status) in outcomes:
        assert t_placed == j_placed
        assert t_ports == j_ports
        assert t_failed == j_failed
        assert t_status == j_status
    # config 2: distinct_hosts keeps the job to one alloc per node.
    c2 = outcomes[1][1][0]
    assert len(c2) == 40 and len(set(c2.values())) == 40
    # the mirror kept its device copy in step with the committed usage
    statics = fleet_cache.statics_for(th.state.snapshot())
    mirror = mirror_for(statics)
    assert mirror.sync(th.state.snapshot())
    np.testing.assert_array_equal(mirror.device_usage("cpu").numpy(),
                                  mirror.usage)


def test_slice_failed_placements_match_jax():
    """A fleet too small for the job: the unplaced copies fail the same
    way in both packages (coalesced failed allocs, same eval status)."""
    nodes = _nodes(8, 3)
    big = _sequence_job()
    big.task_groups[0].count = 30
    _jh, _th, outcomes = _run_both([big], nodes)
    (j_out, t_out), = outcomes
    assert t_out[0] == j_out[0]
    assert t_out[2] == j_out[2] and t_out[2]
    assert t_out[3] == j_out[3]


def test_rounds_past_fleet_fullness_like_jax():
    """5 roomy nodes and 25 with room for one copy: a 100-copy group
    needs the fit-aware rounds estimate (or the finish fallback) to
    place every copy (tests/test_jax_binpack.py
    test_rounds_mode_places_past_fleet_fullness), identically."""
    nodes = []
    for i in range(30):
        n = mock.node(i)
        if i >= 5:
            n.resources = Resources(
                cpu=260, memory_mb=160, disk_mb=10_000, iops=150,
                networks=n.resources.networks)
        nodes.append(n)
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 100
    tg.tasks[0].resources = Resources(
        cpu=100, memory_mb=64,
        networks=[NetworkResource(mbits=5, dynamic_ports=["http"])])
    _jh, _th, outcomes = _run_both([job], nodes)
    (j_out, t_out), = outcomes
    assert len(t_out[0]) == 100
    assert t_out == j_out


def test_failure_explanations_like_jax():
    """A constraint no node meets: the failed alloc carries the stack's
    explanation (nodes evaluated, constraint filter counts) as in the
    JAX package."""
    job = mock.job()
    job.task_groups[0].constraints = [
        Constraint(hard=True, l_target="$attr.kernel.name",
                   r_target="plan9", operand="=")]
    jh, th, outcomes = _run_both([job], _nodes(6, 4))
    (j_out, t_out), = outcomes
    assert t_out[2] == j_out[2] and t_out[2]
    jm = jh.plans[-1].failed_allocs[0].metrics
    tm = th.plans[-1].failed_allocs[0].metrics
    assert tm.nodes_evaluated == jm.nodes_evaluated
    assert tm.constraint_filtered == jm.constraint_filtered
    assert tm.coalesced_failures == jm.coalesced_failures


def test_divergence_recovery_never_oversubscribes(monkeypatch):
    """The exact host network check rejects the first two device
    winners: the finish re-plans the rest with place_sequence
    (_redispatch_remaining) and the plan never oversubscribes a node.
    The Python tail runs alone here (the native prefix would assign
    these ports in C, where the fault is not injected)."""
    from nomad_tpu_torch import mock as tmock
    from nomad_tpu_torch.scheduler import TorchBinPackScheduler
    from nomad_tpu_torch.scheduler import torch_binpack
    from nomad_tpu_torch.structs import allocs_fit

    monkeypatch.setattr(torch_binpack, "_native_bulk", lambda: None)

    h = THarness(device="cpu")
    nodes = [tmock.node(i) for i in range(4)]
    for n in nodes:
        h.state.upsert_node(h.next_index(), n)
    job = tmock.job()
    job.task_groups[0].count = 8
    job.task_groups[0].tasks[0].resources.cpu = 900
    h.state.upsert_job(h.next_index(), job)

    real = TorchBinPackScheduler._assign_networks_fast
    calls = {"n": 0, "redispatch": 0}

    def flaky(self, node_index, node, plan_tasks):
        calls["n"] += 1
        if calls["n"] <= 2:
            return None
        return real(self, node_index, node, plan_tasks)

    real_redispatch = TorchBinPackScheduler._redispatch_remaining

    def counted(self, *a):
        calls["redispatch"] += 1
        return real_redispatch(self, *a)

    monkeypatch.setattr(TorchBinPackScheduler, "_assign_networks_fast",
                        flaky)
    monkeypatch.setattr(TorchBinPackScheduler, "_redispatch_remaining",
                        counted)
    with t_executor_override("device"):
        h.process("torch-binpack", TEvaluation(
            id="e1", priority=50, type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER, job_id=job.id))
    assert calls["redispatch"] == 1
    plan = h.plans[0]
    by_node = {n.id: n for n in nodes}
    for node_id, allocs in plan.node_allocation.items():
        fit, dim, _ = allocs_fit(by_node[node_id], allocs)
        assert fit, f"node {node_id} oversubscribed: {dim}"
    assert sum(len(v) for v in plan.node_allocation.values()) >= 4


def test_fast_proto_matches_dataclass():
    """The network fast path fills factory fields explicitly instead of
    looping; it must fail loudly if the dataclasses grow new ones (as
    tests/test_jax_binpack.py test_fast_proto_matches_dataclass)."""
    from nomad_tpu_torch.scheduler.torch_binpack import (_NET_FACTORIES,
                                                         _RES_FACTORIES)

    assert {n for n, _ in _RES_FACTORIES} == {"networks"}
    assert {n for n, _ in _NET_FACTORIES} == {"reserved_ports",
                                              "dynamic_ports"}
