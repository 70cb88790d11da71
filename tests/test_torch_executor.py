"""The port's host executor against the JAX package's, and its policy.

The host twins of K2/K3 (nomad_tpu_torch/ops/binpack_host.py) are held
against the JAX package's (nomad_tpu/ops/binpack_host.py) on the same
seeded numpy inputs, bit for bit: chosen nodes, scores and usage
(signed zeros included), and against the port's plain PyTorch versions
(ops/binpack.py, CPU tensors) under the repo's parity contract: chosen
exactly, scores rtol=1e-4 / atol=1e-4 where placed, usage rtol=1e-5 /
atol=1e-3.  (A step that places nothing is not part of a plan: the
plain versions score every step as the JAX scans do, the host twins
leave 0 there.)

The policy tests are twins of tests/test_executor_parity.py on the port
(PipelinedEvalRunner and BatchEvalRunner on device="cpu", so "device"
means the kernels' plain versions).  Both packages read one environment
variable, NOMAD_TPU_EXECUTOR; every test sets it on purpose.  The
constants measured on the card are patched where a test needs the cost
rule to take one side.
"""
import random

import numpy as np
import pytest
import torch

import nomad_tpu.mock as mock
from nomad_tpu.models.fleet import build_fleet, build_usage
from nomad_tpu.ops import binpack_host as jhost
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.structs import Resources
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import binpack as tbp
from nomad_tpu_torch.ops import binpack_host as thost
from nomad_tpu_torch.scheduler import BatchEvalRunner, Harness
from nomad_tpu_torch.scheduler import torch_binpack
from nomad_tpu_torch.scheduler.executor import (
    ENV_VAR,
    EXECUTOR_AUTO,
    EXECUTOR_DEVICE,
    EXECUTOR_HOST,
    ExecutorPolicyError,
    executor_override,
    executor_policy,
    set_executor_policy,
    validate_executor,
)
from nomad_tpu_torch.scheduler.pipeline import PipelinedEvalRunner
from nomad_tpu_torch.scheduler.torch_binpack import TorchBinPackScheduler
from nomad_tpu_torch.structs import (
    EVAL_TRIGGER_JOB_REGISTER,
    Evaluation,
    generate_uuid,
)

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)

PENALTY = np.float32(10.0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- host twins: inputs ------------------------------------------------------


def _random_fleet(rng, n_nodes=23, used=False, neg_zero=False):
    """Random node sizes (the shape of tests/test_torch_binpack.py's
    cases); ``used`` puts usage and same-job counts on some nodes,
    ``neg_zero`` makes every zero of the usage -0.0."""
    nodes = [mock.node(i) for i in range(n_nodes)]
    for n in nodes:
        n.resources.cpu = int(rng.integers(800, 4000))
        n.resources.memory_mb = int(rng.integers(900, 8000))
    fleet = build_fleet(nodes)
    view = build_usage(fleet, [])
    usage = view.usage.astype(np.float32).copy()
    jc = view.job_counts.astype(np.int32).copy()
    if used:
        busy = rng.random(fleet.n_real) > 0.6
        usage[:fleet.n_real, 0] = np.where(
            busy, rng.integers(0, 600, fleet.n_real), 0)
        usage[:fleet.n_real, 1] = np.where(
            busy, rng.integers(0, 700, fleet.n_real), 0)
        jc[:fleet.n_real] = np.where(busy, rng.integers(0, 3, fleet.n_real),
                                     0)
    if neg_zero:
        usage[usage == 0] = np.float32(-0.0)
    return fleet, usage, jc


def _random_groups(rng, fleet, n_groups=3, g_pad=4):
    asks = np.zeros((g_pad, 6), dtype=np.float32)
    for g in range(n_groups):
        asks[g] = Resources(
            cpu=int(rng.integers(50, 700)),
            memory_mb=int(rng.integers(40, 900))).as_vector()
    feasible = np.zeros((g_pad, fleet.n_pad), dtype=bool)
    feasible[:n_groups, :fleet.n_real] = \
        rng.random((n_groups, fleet.n_real)) > 0.2
    distinct = rng.random(g_pad) > 0.7
    return asks, feasible, distinct


def _uniform(n_nodes, neg_zero=False):
    """``n_nodes`` identical nodes, slots 0-1 feasible everywhere: every
    score ties, so the tie order alone decides."""
    fleet = build_fleet([mock.node(i) for i in range(n_nodes)])
    view = build_usage(fleet, [])
    usage = view.usage.astype(np.float32).copy()
    if neg_zero:
        usage[usage == 0] = np.float32(-0.0)
    asks = np.zeros((4, 6), dtype=np.float32)
    asks[0] = Resources(cpu=100, memory_mb=64).as_vector()
    asks[1] = Resources(cpu=250, memory_mb=128).as_vector()
    feasible = np.zeros((4, fleet.n_pad), dtype=bool)
    feasible[:2, :fleet.n_real] = True
    distinct = np.zeros(4, dtype=bool)
    return fleet, usage, view.job_counts.astype(np.int32), asks, \
        feasible, distinct


SEQUENCE_CASES = ("random", "random-used", "uniform", "uniform-neg-zero",
                  "random-neg-zero")


def _sequence_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("uniform"):
        fleet, usage, jc, asks, feasible, distinct = _uniform(
            23, neg_zero="neg-zero" in name)
        group_idx = np.asarray([0, 1] * 8, dtype=np.int32)
    else:
        fleet, usage, jc = _random_fleet(rng, used="used" in name,
                                         neg_zero="neg-zero" in name)
        asks, feasible, distinct = _random_groups(rng, fleet)
        group_idx = rng.integers(0, 3, 16).astype(np.int32)
    valid = np.ones(16, dtype=bool)
    valid[[3, 14, 15]] = False
    return fleet, usage, jc, asks, feasible, distinct, group_idx, valid


ROUNDS_CASES = {
    # name: (k_cap, rounds, counts)
    "random-one-round": (8, 1, (5, 3, 7, 0)),
    "random-used-k-below-count": (4, 3, (9, 2, 6, 0)),
    "random-leftovers": (8, 2, (20, 1, 30, 0)),
    "uniform-ties-straddle-k": (8, 1, (5, 3, 0, 0)),
    "uniform-rounds-after-ties": (4, 3, (9, 2, 0, 0)),
    "uniform-k-is-n": (32, 1, (30, 40, 0, 0)),
    "uniform-neg-zero-ties": (8, 2, (12, 5, 0, 0)),
    "random-neg-zero": (8, 2, (10, 4, 3, 0)),
}


def _rounds_case(name):
    k_cap, rounds, counts = ROUNDS_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("uniform"):
        fleet, usage, jc, asks, feasible, distinct = _uniform(
            23, neg_zero="neg-zero" in name)
    else:
        fleet, usage, jc = _random_fleet(rng, used="used" in name,
                                         neg_zero="neg-zero" in name)
        asks, feasible, distinct = _random_groups(rng, fleet)
    return fleet, usage, jc, asks, feasible, distinct, \
        np.asarray(counts, dtype=np.int32), k_cap, rounds


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(
        np.int32)


def _assert_exact(j_out, t_out):
    """Chosen, scores and usage equal bit for bit (signed zeros too)."""
    (jc_, js_, ju_), (tc, ts, tu) = j_out, t_out
    assert tc.dtype == np.asarray(jc_).dtype
    assert np.array_equal(tc, jc_)
    assert np.array_equal(_bits(ts), _bits(js_))
    assert np.array_equal(_bits(tu), _bits(ju_))


def _assert_parity(host, plain):
    """The repo's parity contract, host twin against a plain version."""
    (hc, hs, hu), (pc, ps, pu) = host, plain
    pc, ps, pu = pc.numpy(), ps.numpy(), pu.numpy()
    assert np.array_equal(hc, pc)
    placed = hc >= 0
    np.testing.assert_allclose(hs[placed], ps[placed], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hu, pu, rtol=1e-5, atol=1e-3)


# -- host twins: against the JAX package's and the plain versions -----------


@pytest.mark.parametrize("name", SEQUENCE_CASES)
def test_place_sequence_host_equals_jax_bit_for_bit(name):
    fleet, usage, jc, asks, feasible, distinct, group_idx, valid = \
        _sequence_case(name)
    for n_real in (0, fleet.n_real):
        args = (fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
                distinct, group_idx, valid, PENALTY)
        _assert_exact(jhost.place_sequence_host(*args, n_real=n_real),
                      thost.place_sequence_host(*args, n_real=n_real))


@pytest.mark.parametrize("name", sorted(ROUNDS_CASES))
def test_place_rounds_host_equals_jax_bit_for_bit(name):
    fleet, usage, jc, asks, feasible, distinct, counts, k_cap, rounds = \
        _rounds_case(name)
    for n_real in (0, fleet.n_real):
        args = (fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
                distinct, counts, PENALTY)
        _assert_exact(
            jhost.place_rounds_host(*args, k_cap=k_cap, rounds=rounds,
                                    n_real=n_real),
            thost.place_rounds_host(*args, k_cap=k_cap, rounds=rounds,
                                    n_real=n_real))


@pytest.mark.parametrize("k", [0, 1, 5, 8, 9, 16, 17, 40])
def test_topk_exact_equals_jax(k):
    """Ties straddling k, -0.0 beside +0.0, masked rows: the packed
    int64 key and the +0.0 normalisation survive the copy."""
    vals = np.asarray([3.0, -0.0, 0.0, 7.5, 7.5, -1e30, 7.5, 0.0, -0.0,
                       2.0, 7.5, -1e30, 3.0, 0.0, 1.0, -0.0, 7.5],
                      dtype=np.float32)
    assert np.array_equal(thost._topk_exact(vals, k),
                          jhost._topk_exact(vals, k))


@pytest.mark.parametrize("name", SEQUENCE_CASES)
def test_place_sequence_host_matches_plain(name):
    fleet, usage, jc, asks, feasible, distinct, group_idx, valid = \
        _sequence_case(name)
    host = thost.place_sequence_host(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, group_idx, valid, PENALTY, n_real=fleet.n_real)
    plain = tbp.place_sequence_plain(
        _t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
        _t(feasible), _t(asks), _t(distinct), _t(group_idx), _t(valid),
        float(PENALTY))
    _assert_parity(host, plain[:3])


@pytest.mark.parametrize("name", sorted(ROUNDS_CASES))
def test_place_rounds_host_matches_plain(name):
    fleet, usage, jc, asks, feasible, distinct, counts, k_cap, rounds = \
        _rounds_case(name)
    host = thost.place_rounds_host(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, counts, PENALTY, k_cap=k_cap, rounds=rounds,
        n_real=fleet.n_real)
    plain = tbp.place_rounds_plain(
        _t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
        _t(feasible), _t(asks), _t(distinct), _t(counts), float(PENALTY),
        k_cap=k_cap, rounds=rounds)
    _assert_parity(host, plain[:3])


# -- the policy through the runners (twins of test_executor_parity.py) -----


def make_eval(job):
    return Evaluation(
        id=generate_uuid(), priority=job.priority, type=job.type,
        triggered_by=EVAL_TRIGGER_JOB_REGISTER, job_id=job.id)


def _cluster(n_nodes: int, n_jobs: int, count: int = 3):
    h = Harness(device="cpu")
    for i in range(n_nodes):
        h.state.upsert_node(h.next_index(), convert.nodes_from_reference(
            [mock.node(i)])[0])
    jobs = []
    for k in range(n_jobs):
        (j,) = convert.jobs_from_reference([mock.job()])
        j.id = f"job-{k}"
        j.task_groups[0].count = count
        h.state.upsert_job(h.next_index(), j)
        jobs.append(j)
    return h, jobs


def _plans(h):
    """Each plan's placements (alloc name, node name, ports) and failed
    allocs, in submit order."""
    names = {n.id: n.name for n in h.state.nodes()}
    return [(sorted((a.name, names[node_id], tuple(
        p for tr in a.task_resources.values() for n in tr.networks
        for p in n.reserved_ports))
        for node_id, allocs in p.node_allocation.items() for a in allocs),
        sorted(a.name for a in p.failed_allocs)) for p in h.plans]


def _run_stream(executor: str, depth: int = 3):
    h, jobs = _cluster(12, 5)
    random.seed(21)
    runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=depth,
                                 device="cpu")
    with executor_override(executor):
        runner.process([make_eval(j) for j in jobs])
    return h, runner


class TestParity:
    def test_forced_host_vs_forced_device_identical(self):
        """Same stream, executor forced both ways: identical plans,
        nodes and ports, and the dispatch counts say which side ran."""
        h_host, r_host = _run_stream(EXECUTOR_HOST)
        h_dev, r_dev = _run_stream(EXECUTOR_DEVICE)

        assert r_host.host_dispatches == len(h_host.plans) == 5
        assert r_host.device_dispatches == 0
        assert r_dev.device_dispatches == len(h_dev.plans) == 5
        assert r_dev.host_dispatches == 0

        assert _plans(h_host) == _plans(h_dev)
        assert all(e.status == "complete" for e in h_host.evals)
        assert all(e.status == "complete" for e in h_dev.evals)

    def test_forced_device_matches_auto_plans(self, monkeypatch):
        """auto keeps this micro shape on the host while its cost is
        under HOST_ALWAYS_COST and sends it to the device when the
        constant is 0; the plans never change."""
        monkeypatch.setattr(TorchBinPackScheduler, "HOST_ALWAYS_COST",
                            10**9)
        h_auto, r_auto = _run_stream(EXECUTOR_AUTO)
        assert r_auto.host_dispatches == 5
        monkeypatch.setattr(TorchBinPackScheduler, "HOST_ALWAYS_COST", 0)
        h_auto0, r_auto0 = _run_stream(EXECUTOR_AUTO)
        assert r_auto0.device_dispatches == 5
        h_dev, _ = _run_stream(EXECUTOR_DEVICE)
        assert _plans(h_auto) == _plans(h_dev) == _plans(h_auto0)

    def test_stage_times_and_windows_recorded(self):
        _, runner = _run_stream(EXECUTOR_DEVICE)
        assert runner.latencies and all(v >= 0 for v in runner.latencies)
        assert runner.windows and sum(runner.windows) == len(
            runner.latencies)
        # Every stage ran: begin/dispatch on the front thread,
        # collect/finish/submit on the drain thread.
        assert all(v >= 0.0 for v in runner.stage_times.values())
        assert runner.stage_times["begin"] > 0.0
        assert runner.stage_times["submit"] > 0.0
        stats = runner.stats()
        assert stats["evals"] == 5 and stats["device_fraction"] == 1.0
        assert stats["breaker_reruns"] == 0


class TestPolicyResolution:
    def test_env_wins_over_config(self, monkeypatch):
        monkeypatch.delenv(ENV_VAR, raising=False)
        set_executor_policy(EXECUTOR_HOST)
        try:
            monkeypatch.setenv(ENV_VAR, "device")
            assert executor_policy() == EXECUTOR_DEVICE
            monkeypatch.delenv(ENV_VAR)
            assert executor_policy() == EXECUTOR_HOST
        finally:
            set_executor_policy(EXECUTOR_AUTO)
        assert executor_policy() == EXECUTOR_AUTO

    def test_invalid_values_fail_loudly(self, monkeypatch):
        with pytest.raises(ExecutorPolicyError):
            set_executor_policy("tpu")
        with pytest.raises(ExecutorPolicyError):
            validate_executor("gpu", "server config")
        assert validate_executor(" Host ") == EXECUTOR_HOST
        monkeypatch.setenv(ENV_VAR, "gpu")
        with pytest.raises(ExecutorPolicyError):
            executor_policy()
        with pytest.raises(ExecutorPolicyError):
            executor_override("cuda")

    def test_override_restores_prior_env(self, monkeypatch):
        monkeypatch.setenv(ENV_VAR, "host")
        with executor_override(EXECUTOR_DEVICE):
            assert executor_policy() == EXECUTOR_DEVICE
            with executor_override(EXECUTOR_AUTO):
                assert executor_policy() == EXECUTOR_AUTO
            assert executor_policy() == EXECUTOR_DEVICE
        assert executor_policy() == EXECUTOR_HOST
        monkeypatch.delenv(ENV_VAR)
        with executor_override(EXECUTOR_HOST):
            pass
        assert ENV_VAR not in __import__("os").environ

    def test_one_variable_steers_both_packages(self, monkeypatch):
        from nomad_tpu.scheduler import executor as jexec

        monkeypatch.setenv(ENV_VAR, "host")
        assert executor_policy() == jexec.executor_policy() == "host"
        with executor_override(EXECUTOR_DEVICE):
            assert jexec.executor_policy() == "device"

    @pytest.mark.parametrize("executor", [EXECUTOR_HOST, EXECUTOR_DEVICE,
                                          EXECUTOR_AUTO])
    def test_batch_runner_honors_force(self, executor, monkeypatch):
        """The fused batch path obeys the same policy: every executor
        commits the same allocs as the device, and the lanes record
        which side ran."""
        calls = {"host": 0, "device": 0}
        real_host = BatchEvalRunner._dispatch_fused_host
        real_dev = BatchEvalRunner._dispatch_fused

        def host(self, pending):
            calls["host"] += 1
            return real_host(self, pending)

        def dev(self, pending):
            calls["device"] += 1
            return real_dev(self, pending)
        monkeypatch.setattr(BatchEvalRunner, "_dispatch_fused_host", host)
        monkeypatch.setattr(BatchEvalRunner, "_dispatch_fused", dev)
        # auto keeps this storm on the host while its fused cost is
        # under HOST_SINGLE_SHOT_COST.
        monkeypatch.setattr(TorchBinPackScheduler, "HOST_SINGLE_SHOT_COST",
                            10**9)
        placed = {}
        for ex in (executor, EXECUTOR_DEVICE):
            h, jobs = _cluster(10, 4)
            random.seed(22)
            with executor_override(ex):
                BatchEvalRunner(h.state.snapshot(), h,
                                state_refresh=h.snapshot,
                                device="cpu").process(
                    [make_eval(j) for j in jobs])
            placed[ex] = _plans(h)
        assert placed[executor] == placed[EXECUTOR_DEVICE]
        want_host = 0 if executor == EXECUTOR_DEVICE else 1
        assert calls == {"host": want_host, "device": 2 - want_host}


# -- the cost rule, constants patched ----------------------------------------


def _prepared(job_groups=1, n_nodes=8, count=2):
    h, jobs = _cluster(n_nodes, 1, count=count)
    job = jobs[0]
    runner = BatchEvalRunner(h.state.snapshot(), h, device="cpu")
    sched = runner._begin_eval(make_eval(job))
    return sched, sched.deferred[1]


@pytest.mark.parametrize("always,single,pipelined,want_host", [
    (10**9, 10**9, True, True),     # cost <= HOST_ALWAYS_COST: host
    (10**9, 10**9, False, True),
    (0, 10**9, True, False),        # pipelined: only the first constant
    (0, 10**9, False, True),        # single shot: below the second
    (0, 0, False, False),
    (0, 0, True, False),
])
def test_choose_host_executor_cost_rule(always, single, pipelined,
                                        want_host, monkeypatch):
    sched, args = _prepared()
    monkeypatch.setattr(TorchBinPackScheduler, "HOST_ALWAYS_COST", always)
    monkeypatch.setattr(TorchBinPackScheduler, "HOST_SINGLE_SHOT_COST",
                        single)
    with executor_override(EXECUTOR_AUTO):
        assert sched.choose_host_executor(args, pipelined) is want_host
    with executor_override(EXECUTOR_HOST):
        assert sched.choose_host_executor(args, pipelined) is True
    with executor_override(EXECUTOR_DEVICE):
        assert sched.choose_host_executor(args, pipelined) is False


def test_cost_is_steps_times_real_nodes_like_jax():
    """The port prices an eval as the JAX package does: rounds x groups
    (rounds mode) or placements, times the real node rows."""
    sched, args = _prepared(n_nodes=8, count=5)
    cost = torch_binpack.executor_cost(args)
    assert args.rounds_eligible
    assert cost == args.rounds * args.n_groups * 8
    args.rounds_eligible = False
    assert torch_binpack.executor_cost(args) == args.n_place * 8


def test_the_cost_boundary_is_inclusive(monkeypatch):
    sched, args = _prepared()
    cost = torch_binpack.executor_cost(args)
    monkeypatch.setattr(TorchBinPackScheduler, "HOST_SINGLE_SHOT_COST", 0)
    with executor_override(EXECUTOR_AUTO):
        monkeypatch.setattr(TorchBinPackScheduler, "HOST_ALWAYS_COST",
                            cost)
        assert sched.choose_host_executor(args, True)
        monkeypatch.setattr(TorchBinPackScheduler, "HOST_ALWAYS_COST",
                            cost - 1)
        assert not sched.choose_host_executor(args, True)


def test_dispatch_device_applies_the_policy_unless_forced():
    sched, args = _prepared()
    with executor_override(EXECUTOR_HOST):
        handles = sched.dispatch_device(args)
        assert sched.dispatched_host is True
        assert all(isinstance(x, np.ndarray) for x in handles)
        host = sched.collect_device(args, handles)
        sched.dispatch_device(args, force=True)
        assert sched.dispatched_host is False
        assert sched.dispatched_sharded is False
    with executor_override(EXECUTOR_DEVICE):
        dev = sched.collect_device(args, sched.dispatch_device(args))
        assert sched.dispatched_host is False
    assert np.array_equal(host[0], dev[0])


@pytest.mark.parametrize("single,want_host", [(10**9, True), (0, False)])
def test_storm_policy_prices_the_fused_storm(single, want_host,
                                             monkeypatch):
    """auto keeps a storm on the host while lanes x steps x real nodes
    is at most the single-shot bound (both constants patched); the
    force wins either way."""
    from nomad_tpu_torch.scheduler.batch import fused_cost

    h, jobs = _cluster(8, 3)
    runner = BatchEvalRunner(h.state.snapshot(), h, device="cpu")
    pending = []
    for j in jobs:
        sched = runner._begin_eval(make_eval(j))
        pending.append((sched,) + sched.deferred)
    args = pending[0][2]
    assert fused_cost(pending) == 3 * args.rounds * args.g_pad * 8
    for const in ("HOST_ALWAYS_COST", "HOST_SINGLE_SHOT_COST"):
        monkeypatch.setattr(TorchBinPackScheduler, const, single)
    with executor_override(EXECUTOR_AUTO):
        assert BatchEvalRunner._fused_on_host(pending) is want_host
    with executor_override(EXECUTOR_HOST):
        assert BatchEvalRunner._fused_on_host(pending) is True
    with executor_override(EXECUTOR_DEVICE):
        assert BatchEvalRunner._fused_on_host(pending) is False


def test_port_and_jax_price_the_same_eval_alike():
    """Twin clusters, the same job: the port's cost equals the JAX
    package's (steps x n_real from its DeviceArgs)."""
    from nomad_tpu.scheduler.batch import BatchEvalRunner as JRunner
    from nomad_tpu.structs import Evaluation as JEvaluation

    nodes = [mock.node(i) for i in range(12)]
    job = mock.job()
    job.task_groups[0].count = 7
    jh = JHarness()
    th = Harness(device="cpu")
    for jn, tn in zip(nodes, convert.nodes_from_reference(nodes)):
        jh.state.upsert_node(jh.next_index(), jn)
        th.state.upsert_node(th.next_index(), tn)
    jh.state.upsert_job(jh.next_index(), job)
    th.state.upsert_job(th.next_index(),
                        convert.jobs_from_reference([job])[0])
    ev = make_eval(job)
    jsched = JRunner(jh.state.snapshot(), jh)._begin_eval(
        JEvaluation.from_dict(ev.to_dict()))
    tsched = BatchEvalRunner(th.state.snapshot(), th,
                             device="cpu")._begin_eval(ev)
    ja, ta = jsched.deferred[1], tsched.deferred[1]
    jsteps = ja.rounds * ja.n_groups if ja.rounds_eligible else ja.n_place
    assert torch_binpack.executor_cost(ta) == jsteps * ja.statics.n_real


def _redispatch(monkeypatch, executor) -> dict:
    """Process a job whose fast network assignment misses twice, so the
    finish re-plans the remaining placements (_redispatch_remaining),
    under ``executor``; count the host walks and the K2 calls, and hold
    the plan to no oversubscribed node."""
    from nomad_tpu_torch.structs import allocs_fit

    monkeypatch.setattr(torch_binpack, "_native_bulk", lambda: None)
    h, jobs = _cluster(4, 1, count=8)
    job = jobs[0]
    job.task_groups[0].tasks[0].resources.cpu = 900
    h.state.upsert_job(h.next_index(), job)
    real_fast = TorchBinPackScheduler._assign_networks_fast
    calls = {"n": 0, "host": 0, "kernel": 0}

    def flaky(self, node_index, node, plan_tasks):
        calls["n"] += 1
        if calls["n"] <= 2:
            return None
        return real_fast(self, node_index, node, plan_tasks)

    real_host = thost.place_sequence_host
    real_kernel = tbp.place_sequence

    def host(*a, **kw):
        calls["host"] += 1
        return real_host(*a, **kw)

    def kernel(*a, **kw):
        calls["kernel"] += 1
        return real_kernel(*a, **kw)
    monkeypatch.setattr(TorchBinPackScheduler, "_assign_networks_fast",
                        flaky)
    monkeypatch.setattr(thost, "place_sequence_host", host)
    monkeypatch.setattr(tbp, "place_sequence", kernel)
    with executor_override(executor):
        h.process("torch-binpack", make_eval(job))
    nodes = {n.id: n for n in h.state.nodes()}
    for node_id, allocs in h.plans[0].node_allocation.items():
        fit, dim, _ = allocs_fit(nodes[node_id], allocs)
        assert fit, f"node {node_id} oversubscribed: {dim}"
    return calls


def test_redispatch_remaining_runs_the_host_walk(monkeypatch):
    """Divergence recovery re-plans with the host sequence walk (as the
    JAX package does) where the executor policy keeps it on the host,
    never with a kernel launch."""
    calls = _redispatch(monkeypatch, EXECUTOR_HOST)
    assert calls["host"] == 1 and calls["kernel"] == 0


def test_redispatch_remaining_launches_k2_under_device(monkeypatch):
    """Where the policy sends the re-plan to the device, it is K2 on the
    scheduler's device (its plain version here), not the host walk."""
    calls = _redispatch(monkeypatch, EXECUTOR_DEVICE)
    assert calls["kernel"] == 1 and calls["host"] == 0
