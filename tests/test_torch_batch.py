"""K4 and the fused eval storm of the port against the JAX package.

K4a/K4b (nomad_tpu_torch/ops/binpack.py place_rounds_batch /
place_sequence_batch) run their plain PyTorch versions here (the
tensors lie on the CPU) and are held against the JAX package's batch
kernels on the same seeded lanes, and lane by lane against the port's
single-eval K3/K2.  The CUDA kernels are held against those plain
versions on the card by chip_smoke.py.

The storm tests load one mock cluster into both packages
(nomad_tpu_torch.convert) and run BatchEvalRunner.process on each.  The
JAX side runs the unsharded device-executor batch kernel, as its own
tests pin it: mesh_override("off") (tests/conftest.py gives JAX eight
CPU devices, which would otherwise take the sharded path) and
executor_override("device") (small storms would otherwise take the
numpy host twins).  The port's side runs under its own
executor_override("device") for the same reason, on its device, here
"cpu".  Both packages draw each plan's dynamic ports from Python's
``random`` in the same order, so every storm run is seeded alike
(``_seeded``) and the ports are compared too.

Tolerances, the repo's JAX/numpy parity contract: chosen nodes exactly
equal; scores rtol=1e-4, atol=1e-4 where placed; usage rtol=1e-5,
atol=1e-3.  Placements of the storms are compared exactly.
"""
import contextlib
import random

import jax
import numpy as np
import pytest
import torch

import nomad_tpu.mock as mock
from nomad_tpu.models.fleet import build_fleet, build_usage
from nomad_tpu.ops import binpack as jbp
from nomad_tpu.parallel.mesh import mesh_override
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.scheduler.batch import BatchEvalRunner as JRunner
from nomad_tpu.scheduler.batch import pad_lanes as j_pad_lanes
from nomad_tpu.scheduler.executor import executor_override
from nomad_tpu.scheduler.harness import VerifyingPlanner as JVerifying
from nomad_tpu.structs import (
    EVAL_TRIGGER_JOB_REGISTER,
    Evaluation,
    NetworkResource,
    Resources,
    Task,
    TaskGroup,
    generate_uuid,
)
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import binpack as tbp
from nomad_tpu_torch.scheduler import BatchEvalRunner as TRunner
from nomad_tpu_torch.scheduler import Harness as THarness
from nomad_tpu_torch.scheduler import VerifyingPlanner as TVerifying
from nomad_tpu_torch.scheduler.executor import executor_override as \
    t_executor_override
from nomad_tpu_torch.scheduler import pad_lanes
from nomad_tpu_torch.structs import Evaluation as TEvaluation
from nomad_tpu_torch.structs import allocs_fit as t_allocs_fit

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)

LANES = 4      # the last lane is an all-invalid pad lane
REAL = 3
GROUPS = 4     # slots per lane (3 used)
PLACE = 16     # placements per lane (the last two invalid)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _lanes_case(rng, used, counts_g=(5, 3, 7)):
    """B=4 lanes shaped like tests/test_jax_binpack.py _random_case over
    one shared fleet of 23 random nodes (N padded to 32): per lane its
    own asks, 80% feasible rows, distinct_hosts slots, same-job counts
    and penalty (service 10 or batch 5).  ``used`` puts existing usage
    on some nodes and same-job counts in the lanes.  Lane 3 is a pad
    lane: nothing feasible, counts 0, every placement invalid."""
    nodes = [mock.node(i) for i in range(23)]
    for n in nodes:
        n.resources.cpu = int(rng.integers(800, 4000))
        n.resources.memory_mb = int(rng.integers(900, 8000))
    fleet = build_fleet(nodes)
    n_real, n_pad = fleet.n_real, fleet.n_pad
    usage = build_usage(fleet, []).usage.astype(np.float32)
    jc = np.zeros((LANES, n_pad), dtype=np.int32)
    if used:
        busy = rng.random(n_real) > 0.6
        usage[:n_real, 0] = np.where(busy, rng.integers(0, 600, n_real), 0)
        usage[:n_real, 1] = np.where(busy, rng.integers(0, 700, n_real), 0)
        for b in range(REAL):
            jc[b, :n_real] = np.where(busy, rng.integers(0, 3, n_real), 0)
    asks = np.zeros((LANES, GROUPS, 6), dtype=np.float32)
    feasible = np.zeros((LANES, GROUPS, n_pad), dtype=bool)
    distinct = np.zeros((LANES, GROUPS), dtype=bool)
    group_idx = np.zeros((LANES, PLACE), dtype=np.int32)
    valid = np.zeros((LANES, PLACE), dtype=bool)
    counts = np.zeros((LANES, GROUPS), dtype=np.int32)
    penalty = np.zeros(LANES, dtype=np.float32)
    for b in range(REAL):
        for g in range(3):
            asks[b, g] = Resources(
                cpu=int(rng.integers(50, 700)),
                memory_mb=int(rng.integers(40, 900))).as_vector()
        feasible[b, :3, :n_real] = rng.random((3, n_real)) > 0.2
        distinct[b] = rng.random(GROUPS) > 0.7
        group_idx[b] = rng.integers(0, 3, PLACE)
        valid[b, :-2] = True
        counts[b, :3] = np.roll(counts_g, b)
        penalty[b] = 10.0 if b % 2 == 0 else 5.0
    return (fleet, usage, jc, feasible, asks, distinct, group_idx, valid,
            counts, penalty)


def _check(j_out, t_out):
    j_chosen, j_scores, j_usage = (np.asarray(x) for x in j_out)
    t_chosen, t_scores, t_usage = (x.numpy() for x in t_out)
    assert np.array_equal(t_chosen, j_chosen)
    placed = j_chosen >= 0
    np.testing.assert_allclose(t_scores[placed], j_scores[placed],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_usage, j_usage, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("used", [False, True])
@pytest.mark.parametrize("k_cap,rounds", [
    (8, 1),   # one round places every copy
    (4, 2),   # k_cap below the slots' counts: the second round covers it
])
def test_place_rounds_batch_matches_jax(k_cap, rounds, used):
    rng = np.random.default_rng(21 + k_cap + rounds)
    (fleet, usage, jc, feasible, asks, distinct, _gi, _v, counts,
     penalty) = _lanes_case(rng, used)
    j_out = jbp.place_rounds_batch(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, counts, penalty, k_cap=k_cap, rounds=rounds)
    targs = (_t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
             _t(feasible), _t(asks), _t(distinct), _t(counts), _t(penalty))
    usage_before = targs[2].clone()
    t_out = tbp.place_rounds_batch(*targs, k_cap=k_cap, rounds=rounds)
    _check(j_out, t_out)
    assert torch.equal(targs[2], usage_before), "base usage was written"
    assert t_out[0].shape == (LANES, GROUPS, rounds * k_cap)
    assert t_out[2].shape == (LANES, fleet.n_pad, 6)
    # every lane equals K3's plain version run alone on that lane
    for b in range(LANES):
        alone = tbp.place_rounds_plain(
            *targs[:3], targs[3][b], targs[4][b], targs[5][b], targs[6][b],
            targs[7][b], float(penalty[b]), k_cap=k_cap, rounds=rounds)
        for got, want in zip(t_out, alone):
            assert torch.equal(got[b], want)
    # the pad lane places nothing and leaves the base usage as it was
    assert (t_out[0][REAL] == -1).all()
    assert torch.equal(t_out[2][REAL], usage_before)
    assert (t_out[0][:REAL] >= 0).any()
    if rounds > 1:  # a slot's count above k_cap placed in round two
        assert (t_out[0][:REAL, :, k_cap:] >= 0).any()


@pytest.mark.parametrize("k_cap,rounds", [
    (8, 1),    # ties straddle the k_cap-th key in every lane
    (32, 1),   # k_cap = N: every key, the masked padding rows last
])
def test_place_rounds_batch_equal_scores_like_jax(k_cap, rounds):
    """Lanes over 23 identical nodes (N padded to 32): every feasible
    score of a slot ties, as on the main path's mock fleets, where the
    kernel's select puts every key into one bin of each digit pass."""
    rng = np.random.default_rng(61)
    (_f, _u, jc, feasible, asks, distinct, _gi, _v, counts,
     penalty) = _lanes_case(rng, False, counts_g=(6, 40, 2))
    fleet = build_fleet([mock.node(i) for i in range(23)])
    usage = build_usage(fleet, []).usage.astype(np.float32)
    feasible[:REAL, :3] = False
    feasible[:REAL, :3, :fleet.n_real] = True
    distinct[:] = False
    j_out = jbp.place_rounds_batch(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, counts, penalty, k_cap=k_cap, rounds=rounds)
    targs = (_t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
             _t(feasible), _t(asks), _t(distinct), _t(counts), _t(penalty))
    t_out = tbp.place_rounds_batch(*targs, k_cap=k_cap, rounds=rounds)
    _check_every(j_out, t_out)
    for b in range(REAL):
        # ties go to the lower index: slot 0 takes nodes 0..
        got = t_out[0][b, 0, :k_cap].numpy()
        placed = got[got >= 0]
        assert placed.tolist() == list(range(len(placed)))
        alone = tbp.place_rounds_plain(
            *targs[:3], targs[3][b], targs[4][b], targs[5][b], targs[6][b],
            targs[7][b], float(penalty[b]), k_cap=k_cap, rounds=rounds)
        for got, want in zip(t_out, alone):
            assert torch.equal(got[b], want)


@pytest.mark.parametrize("used", [False, True])
def test_place_sequence_batch_matches_jax(used):
    rng = np.random.default_rng(31)
    (fleet, usage, jc, feasible, asks, distinct, group_idx, valid, _c,
     penalty) = _lanes_case(rng, used)
    j_out = jbp.place_sequence_batch(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, group_idx, valid, penalty)
    targs = (_t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
             _t(feasible), _t(asks), _t(distinct), _t(group_idx),
             _t(valid), _t(penalty))
    usage_before = targs[2].clone()
    t_out = tbp.place_sequence_batch(*targs)
    _check(j_out, t_out)
    assert torch.equal(targs[2], usage_before), "base usage was written"
    assert (t_out[0].numpy()[~valid] == -1).all()
    for b in range(LANES):
        alone = tbp.place_sequence_plain(
            *targs[:3], targs[3][b], targs[4][b], targs[5][b], targs[6][b],
            targs[7][b], targs[8][b], float(penalty[b]))
        for got, want in zip(t_out, alone):
            assert torch.equal(got[b], want)
    assert torch.equal(t_out[2][REAL], usage_before)


def test_batch_wrappers_count_no_launch_on_the_cpu():
    rng = np.random.default_rng(5)
    (fleet, usage, jc, feasible, asks, distinct, group_idx, valid, counts,
     penalty) = _lanes_case(rng, False)
    before = (tbp.place_rounds_batch.launches,
              tbp.place_sequence_batch.launches)
    shared = (_t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
              _t(feasible), _t(asks), _t(distinct))
    tbp.place_rounds_batch(*shared, _t(counts), _t(penalty), k_cap=8,
                           rounds=1)
    tbp.place_sequence_batch(*shared, _t(group_idx), _t(valid),
                             _t(penalty))
    assert (tbp.place_rounds_batch.launches,
            tbp.place_sequence_batch.launches) == before
    with pytest.raises(ValueError):
        tbp.place_rounds_batch(*shared, _t(counts), _t(penalty),
                               k_cap=fleet.n_pad + 1, rounds=1)


# -- where nothing is placed: every step and round scored, +0.0 added --------
#
# As tests/test_torch_binpack.py holds K2/K3: from a base usage whose
# zero entries are all -0.0, scores at every step and round (invalid
# steps, the all-infeasible slot 3, exhausted rounds, the pad lane) and
# the lanes' final usage bit for bit (int32 views).

_ORDERS = {
    "contiguous": [0] * 5 + [1] * 4 + [3] * 2 + [2] * 5,
    "interleaved": [0, 1, 2, 3] * 4,
}


def _negative_zero(usage):
    usage = usage.copy()
    usage[usage == 0] = np.float32(-0.0)
    return usage


def _neg_zeros(x) -> int:
    x = np.asarray(x)
    return int(((x == 0) & np.signbit(x)).sum())


def _check_every(j_out, t_out):
    j_chosen, j_scores, j_usage = (np.asarray(x) for x in j_out)
    t_chosen, t_scores, t_usage = (x.numpy() for x in t_out)
    assert np.array_equal(t_chosen, j_chosen)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-4, atol=1e-4)
    assert np.array_equal(
        np.ascontiguousarray(t_usage).view(np.int32),
        np.ascontiguousarray(j_usage.astype(np.float32)).view(np.int32))
    assert (t_scores[t_chosen < 0] > tbp.NEG_INF / 2).any()


@pytest.mark.parametrize("used", [False, True])
@pytest.mark.parametrize("k_cap,rounds", [(8, 1), (4, 2)])
def test_place_rounds_batch_scores_every_round_like_jax(k_cap, rounds,
                                                        used):
    rng = np.random.default_rng(51)
    (fleet, usage, jc, feasible, asks, distinct, _gi, _v, counts,
     penalty) = _lanes_case(rng, used, counts_g=(3, 0, 6))
    usage = _negative_zero(usage)
    counts[0, 3] = 2  # copies asked of the all-infeasible slot
    j_out = jbp.place_rounds_batch(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, counts, penalty, k_cap=k_cap, rounds=rounds)
    targs = (_t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
             _t(feasible), _t(asks), _t(distinct), _t(counts), _t(penalty))
    t_out = tbp.place_rounds_batch(*targs, k_cap=k_cap, rounds=rounds)
    _check_every(j_out, t_out)
    for b in range(LANES):
        assert _neg_zeros(t_out[2][b]) < _neg_zeros(usage)
        alone = tbp.place_rounds_plain(
            *targs[:3], targs[3][b], targs[4][b], targs[5][b], targs[6][b],
            targs[7][b], float(penalty[b]), k_cap=k_cap, rounds=rounds)
        for got, want in zip(t_out, alone):
            assert torch.equal(got[b], want)


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("used", [False, True])
def test_place_sequence_batch_scores_every_step_like_jax(order, used):
    rng = np.random.default_rng(53)
    (fleet, usage, jc, feasible, asks, distinct, _gi, valid, _c,
     penalty) = _lanes_case(rng, used)
    usage = _negative_zero(usage)
    group_idx = np.tile(np.asarray(_ORDERS[order], dtype=np.int32),
                        (LANES, 1))
    valid[:REAL, 6] = False  # an invalid step inside a run
    j_out = jbp.place_sequence_batch(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, group_idx, valid, penalty)
    targs = (_t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
             _t(feasible), _t(asks), _t(distinct), _t(group_idx),
             _t(valid), _t(penalty))
    t_out = tbp.place_sequence_batch(*targs)
    _check_every(j_out, t_out)
    for b in range(LANES):
        assert _neg_zeros(t_out[2][b]) < _neg_zeros(usage)
        alone = tbp.place_sequence_plain(
            *targs[:3], targs[3][b], targs[4][b], targs[5][b], targs[6][b],
            targs[7][b], targs[8][b], float(penalty[b]))
        for got, want in zip(t_out, alone):
            assert torch.equal(got[b], want)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 63, 64, 65])
def test_pad_lanes_like_jax(n):
    assert pad_lanes(n) == j_pad_lanes(n)
    assert pad_lanes(n) >= n and pad_lanes(n) & (pad_lanes(n) - 1) == 0


# -- the fused storm, end to end -----------------------------------------


def _make_eval(job):
    return Evaluation(id=generate_uuid(), priority=job.priority,
                      type=job.type, triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                      job_id=job.id)


def _worlds(nodes, jobs, verifying=False):
    """The same nodes and jobs in a JAX Harness and a port Harness
    (device "cpu"), optionally behind each package's VerifyingPlanner."""
    jh, th = JHarness(), THarness(device="cpu")
    for jn, tn in zip(nodes, convert.nodes_from_reference(nodes)):
        jh.state.upsert_node(jh.next_index(), jn)
        th.state.upsert_node(th.next_index(), tn)
    for job, tjob in zip(jobs, convert.jobs_from_reference(jobs)):
        jh.state.upsert_job(jh.next_index(), job)
        th.state.upsert_job(th.next_index(), tjob)
    if verifying:
        jh.planner = JVerifying(jh)
        th.planner = TVerifying(th)
    return jh, th


@contextlib.contextmanager
def _seeded(seed=7):
    """Python's ``random`` seeded for one run (the plan's dynamic-port
    generator is seeded from it), restored after."""
    saved = random.getstate()
    random.seed(seed)
    try:
        yield
    finally:
        random.setstate(saved)


def _run_jax(h, evals, refresh):
    with mesh_override("off"), executor_override("device"), _seeded():
        JRunner(h.state.snapshot(), h,
                state_refresh=h.snapshot if refresh else None
                ).process(evals)


def _run_port(h, evals, refresh):
    with t_executor_override("device"), _seeded():
        TRunner(h.state.snapshot(), h,
                state_refresh=h.snapshot if refresh else None,
                device="cpu").process(
            [TEvaluation.from_dict(e.to_dict()) for e in evals])


def _run_storm(jh, th, evals, refresh=False):
    """BatchEvalRunner.process on both packages with the same evals."""
    _run_jax(jh, evals, refresh)
    _run_port(th, evals, refresh)


def _committed(h):
    """(job, alloc name) -> (node id, reserved ports) of every live
    alloc in the store, the failed allocs per job across the harness's
    plans, and each eval's last status."""
    placed = {(a.job_id, a.name): (a.node_id, tuple(
        p for tr in a.task_resources.values() for n in tr.networks
        for p in n.reserved_ports))
        for a in h.state.allocs() if not a.terminal_status()}
    failed: dict = {}
    for plan in h.plans:
        for a in plan.failed_allocs:
            failed[a.job_id] = failed.get(a.job_id, 0) + 1
    status = {e.id: e.status for e in h.evals}
    return placed, failed, status


def _assert_same(jh, th):
    j, t = _committed(jh), _committed(th)
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert t[2] == j[2]
    return t


def _service_job(count, cpu=None):
    j = mock.job()
    j.task_groups[0].count = count
    if cpu is not None:
        j.task_groups[0].tasks[0].resources.cpu = cpu
    return j


def _batch_job(count):
    j = mock.job()
    j.type = "batch"
    j.task_groups[0].count = count
    return j


def _sized_nodes(n, seed):
    rng = np.random.default_rng(seed)
    nodes = [mock.node(i) for i in range(n)]
    for node in nodes:
        node.resources.cpu = int(rng.integers(2000, 6000))
        node.resources.memory_mb = int(rng.integers(4096, 12288))
    return nodes


def test_mixed_service_and_batch_storm_like_jax():
    jobs = [_service_job(4), _batch_job(3), _service_job(2, cpu=900),
            _batch_job(5), _service_job(4), _batch_job(1)]
    jh, th = _worlds(_sized_nodes(16, 1), jobs)
    _run_storm(jh, th, [_make_eval(j) for j in jobs])
    placed, failed, status = _assert_same(jh, th)
    assert len(placed) == 19 and not failed
    assert set(status.values()) == {"complete"}
    # each job's plan spreads over distinct nodes (anti-affinity)
    assert len(th.plans) == 6


def test_storm_plans_all_fit_like_jax():
    """Lanes plan optimistically against one snapshot; each plan still
    fits its nodes on an empty fleet."""
    jobs = [_service_job(2, cpu=1000) for _ in range(3)]
    nodes = [mock.node(i) for i in range(4)]
    jh, th = _worlds(nodes, jobs)
    _run_storm(jh, th, [_make_eval(j) for j in jobs])
    _assert_same(jh, th)
    by_node = {n.id: n for n in th.state.nodes()}
    for plan in th.plans:
        for node_id, allocs in plan.node_allocation.items():
            fit, dim, _ = t_allocs_fit(by_node[node_id], allocs)
            assert fit, dim


def test_noop_and_invalid_trigger_like_jax():
    job = mock.job()
    jh, th = _worlds([mock.node(i) for i in range(4)], [job])
    good, bad, missing = (_make_eval(job) for _ in range(3))
    bad.triggered_by = "bogus-trigger"
    missing.job_id = "no-such-job"
    _run_storm(jh, th, [good, bad, missing])
    _p, _f, status = _assert_same(jh, th)
    assert status == {good.id: "complete", bad.id: "failed",
                      missing.id: "complete"}


@pytest.mark.parametrize("refresh", [True, False])
def test_same_job_evals_like_jax(refresh):
    """Two evals of one job in one call: with state_refresh the second
    runs against the first's commits (no double placement); without it
    the second fails safe."""
    job = _service_job(4)
    jh, th = _worlds([mock.node(i) for i in range(8)], [job])
    e1, e2 = _make_eval(job), _make_eval(job)
    _run_storm(jh, th, [e1, e2], refresh=refresh)
    placed, _f, status = _assert_same(jh, th)
    assert len(placed) == 4
    assert status[e1.id] == "complete"
    assert status[e2.id] == ("complete" if refresh else "failed")


def test_sequence_storm_like_jax():
    """Asks large next to a node: not rounds-eligible, so the fused
    launch is K4b (place_sequence_batch) in both packages."""
    jobs = []
    for count in (6, 5, 4):
        j = mock.job()
        tg = j.task_groups[0]
        tg.count = count
        tg.tasks[0].resources = Resources(
            cpu=1500, memory_mb=3000,
            networks=[NetworkResource(mbits=10, dynamic_ports=["http"])])
        jobs.append(j)
    jh, th = _worlds(_sized_nodes(16, 2), jobs)
    calls = []
    real = tbp.place_sequence_batch

    def spy(*a, **kw):
        calls.append(a[4].shape)
        return real(*a, **kw)
    tbp.place_sequence_batch = spy
    try:
        _run_storm(jh, th, [_make_eval(j) for j in jobs])
    finally:
        tbp.place_sequence_batch = real
    placed, _f, _s = _assert_same(jh, th)
    assert calls and calls[0][0] == 4  # three lanes padded to four
    assert len(placed) > 0


def _contended_jobs(cpu):
    """tests/test_plan_batch.py's recorded storm: 6 jobs x 4 groups of 2
    copies on 8 nodes; at cpu 800 the lanes over-commit the nodes."""
    jobs = []
    for _ in range(6):
        job = mock.job()
        job.task_groups = [
            TaskGroup(name=f"tg-{g}", count=2, tasks=[Task(
                name="web", driver="exec", resources=Resources(
                    cpu=cpu, memory_mb=256, networks=[NetworkResource(
                        mbits=5, dynamic_ports=["http"])]))])
            for g in range(4)]
        jobs.append(job)
    return jobs


@pytest.mark.parametrize("cpu", [600, 800])
def test_contended_storm_through_verifying_planner_like_jax(cpu):
    """The storm through each package's VerifyingPlanner with
    state_refresh: no node is oversubscribed in the committed state,
    and conflicts, commits and the placed count equal the JAX run's
    (which is itself run twice and found stable first)."""
    nodes = [mock.node(i) for i in range(8)]
    jax_stats = []
    for _ in range(2):
        jobs = _contended_jobs(cpu)
        jh, th = _worlds(nodes, jobs, verifying=True)
        evals = [_make_eval(j) for j in jobs]
        _run_jax(jh, evals, refresh=True)
        vp = jh.planner
        jax_stats.append((vp.conflicts, vp.commits, len(_committed(jh)[0])))
    assert jax_stats[0] == jax_stats[1], "the JAX run is not stable"
    _run_port(th, evals, refresh=True)
    vp = th.planner
    placed, _failed, status = _assert_same(jh, th)
    assert (vp.conflicts, vp.commits, len(placed)) == jax_stats[0]
    assert set(status.values()) == {"complete"}
    if cpu == 800:
        assert vp.conflicts > 0, "the storm was meant to be contended"
    for node in th.state.nodes():
        live = [a for a in th.state.allocs_by_node(node.id)
                if not a.terminal_status()]
        fit, dim, _ = t_allocs_fit(node, live)
        assert fit, f"node {node.id} oversubscribed on {dim}"


@pytest.mark.parametrize("cpu,refresh", [(600, True), (800, False),
                                         (800, True)])
def test_solo_evals_count_the_per_eval_retries(cpu, refresh, monkeypatch):
    """``solo_evals`` counts the evals the runner hands to a scheduler
    of their own after its fused rounds (the per-eval path, K3 on the
    card): each call of that scheduler's ``process``, and none when
    every plan commits whole."""
    from nomad_tpu_torch.scheduler.torch_binpack import \
        TorchBinPackScheduler

    calls = []
    real = TorchBinPackScheduler.process

    def process(self, ev):
        calls.append(ev.id)
        return real(self, ev)
    monkeypatch.setattr(TorchBinPackScheduler, "process", process)
    jobs = _contended_jobs(cpu)
    _jh, th = _worlds([mock.node(i) for i in range(8)], jobs,
                      verifying=True)
    evals = [TEvaluation.from_dict(_make_eval(j).to_dict()) for j in jobs]
    runner = TRunner(th.state.snapshot(), th,
                     state_refresh=th.snapshot if refresh else None,
                     device="cpu")
    with t_executor_override("device"), _seeded():
        runner.process(evals)
    assert runner.solo_evals == len(calls)
    if th.planner.conflicts == 0:
        assert runner.solo_evals == 0
    if not refresh and cpu == 800:
        assert runner.solo_evals > 0, "the storm was meant to retry"


# -- the chained tail: the stragglers after the fused rounds ---------------


def _bits(x) -> np.ndarray:
    """A float32 array's bits (so -0.0 and +0.0 differ)."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x.astype(np.float32)).view(np.int32)


def _chain_lanes(rng, n_lanes, used):
    """``n_lanes`` lanes of K3 inputs on one fleet of _lanes_case: each
    its own same-job counts, feasibility, asks, distinct_hosts slots,
    counts and penalty.  Returns (fleet, usage, lanes)."""
    fleet = usage = None
    lanes = []
    while len(lanes) < n_lanes:
        (f, u, jc, feasible, asks, distinct, _gi, _v, counts,
         penalty) = _lanes_case(rng, used)
        if fleet is None:
            fleet, usage = f, u
        for b in range(min(REAL, n_lanes - len(lanes))):
            lanes.append((jc[b], feasible[b], asks[b], distinct[b],
                          counts[b], penalty[b]))
    return fleet, usage, lanes


@pytest.mark.parametrize("used", [False, True])
@pytest.mark.parametrize("k_cap,rounds", [(8, 1), (4, 2)])
@pytest.mark.parametrize("n_lanes", [1, 3, 8])
def test_chained_place_rounds_like_jax_chained(n_lanes, k_cap, rounds,
                                               used):
    """The chained tail's walk: K3 lane after lane, each on the usage
    the lane before it returned, equals the JAX package's place_rounds
    chained the same way: every lane's chosen nodes and the usage it
    leaves bit for bit, every round's scores to the score contract."""
    rng = np.random.default_rng(71 + n_lanes + k_cap + rounds)
    fleet, usage, lanes = _chain_lanes(rng, n_lanes, used)
    j_usage, t_usage = usage, _t(usage)
    cap, res = _t(fleet.capacity), _t(fleet.reserved)
    for jc, feasible, asks, distinct, counts, penalty in lanes:
        j_chosen, j_scores, j_usage = (np.asarray(x) for x in
                                       jbp.place_rounds(
            fleet.capacity, fleet.reserved, j_usage, jc, feasible, asks,
            distinct, counts, np.float32(penalty), k_cap=k_cap,
            rounds=rounds))
        t_chosen, t_scores, t_usage = tbp.place_rounds(
            cap, res, t_usage, _t(jc), _t(feasible), _t(asks),
            _t(distinct), _t(counts), float(penalty), k_cap=k_cap,
            rounds=rounds)
        assert np.array_equal(t_chosen.numpy(), j_chosen)
        # pow may round one ulp apart between the packages: the repo's
        # score contract (module docstring)
        np.testing.assert_allclose(t_scores.numpy(), j_scores, rtol=1e-4,
                                   atol=1e-4)
        assert np.array_equal(_bits(t_usage), _bits(j_usage))
        assert (t_chosen.numpy() >= 0).any()
    # every lane's placements stay in the usage the chain ends on
    assert not np.array_equal(_bits(t_usage), _bits(usage))


class _StalePlanner:
    """A planner that answers the first ``windows`` group submits with a
    refresh (the applier's stale-data answer) and passes the rest to
    its harness: it forces every lane through both fused rounds into
    the tail."""

    def __init__(self, h, windows: int) -> None:
        self.h = h
        self.windows = windows

    def submit_plans(self, plans):
        if self.windows:
            self.windows -= 1
            return [(None, self.h.snapshot()) for _ in plans]
        return self.h.submit_plans(plans)

    def submit_plan(self, plan):
        return self.h.submit_plan(plan)

    def update_eval(self, ev):
        self.h.update_eval(ev)

    def create_eval(self, ev):
        self.h.create_eval(ev)


def _tail_jobs():
    """Jobs that fit 8 mock nodes together but not as planned from one
    snapshot (every lane wants the same fullest nodes): service jobs
    and a batch job on K3, and one whose asks are too large next to a
    node for the rounds, on K2."""
    jobs = [_service_job(2, cpu=1000) for _ in range(5)]
    jobs.insert(2, _batch_job(3))
    big = mock.job()
    tg = big.task_groups[0]
    tg.count = 2
    tg.tasks[0].resources = Resources(
        cpu=1500, memory_mb=3000,
        networks=[NetworkResource(mbits=10, dynamic_ports=["http"])])
    jobs.insert(4, big)
    return jobs


# (jobs, nodes, placed, K2 lanes): the jobs fit the fleet together; or
# they do not, and the later lanes' copies find no room left by the
# lanes before them (service copies of 1,500 MHz, two a node).
_TAIL_SHAPES = {
    "fits": (_tail_jobs, 8, 15, 1),
    "full": (lambda: [_service_job(2, cpu=1500) for _ in range(6)], 4, 8,
             0),
}


@pytest.mark.parametrize("shape", sorted(_TAIL_SHAPES))
@pytest.mark.parametrize("executor", ["device", "host"])
def test_stragglers_plan_as_one_chained_window_like_jax_one_by_one(
        executor, shape, monkeypatch):
    """Stragglers forced into the tail plan as one chained window
    through the port's VerifyingPlanner: the window commits every plan
    at once with no conflict, nothing is retried alone, every eval
    completes, no node is oversubscribed, and each placement lands on
    the node the JAX package's scheduler picks when it processes the
    same evals one at a time in lane order, each on the state the one
    before it committed; on a full fleet the same copies fail (a lane's
    host fallback sees the earlier lanes' claims).  ``host``: the numpy
    twins carry the usage."""
    calls = []
    real = tbp.place_sequence

    def spy(*a, **kw):
        calls.append(a[4].shape)
        return real(*a, **kw)
    monkeypatch.setattr(tbp, "place_sequence", spy)
    jobs_of, n_nodes, n_placed, n_seq = _TAIL_SHAPES[shape]
    jobs = jobs_of()
    jh, th = _worlds([mock.node(i) for i in range(n_nodes)], jobs,
                     verifying=True)
    evals = [_make_eval(j) for j in jobs]
    with mesh_override("off"), executor_override("device"), _seeded():
        for ev in evals:
            jh.process("jax-binpack-batch" if ev.type == "batch"
                       else "jax-binpack", ev)
    runner = TRunner(th.state.snapshot(), _StalePlanner(th, 2),
                     state_refresh=th.snapshot, device="cpu")
    with t_executor_override(executor), _seeded():
        runner.process([TEvaluation.from_dict(e.to_dict()) for e in evals])
    vp = th.planner
    assert (runner.rounds_run, runner.chained_evals, runner.solo_evals) \
        == (2, len(jobs), 0)
    assert (vp.conflicts, vp.commits, vp.committed_plans) \
        == (0, 1, len(jobs))
    assert len(calls) == (n_seq if executor == "device" else 0)
    j_placed, j_failed, j_status = _committed(jh)
    t_placed, t_failed, t_status = _committed(th)
    assert {k: node for k, (node, _ports) in t_placed.items()} == \
        {k: node for k, (node, _ports) in j_placed.items()}
    assert len(t_placed) == n_placed
    assert t_failed == j_failed and bool(t_failed) == (shape == "full")
    assert set(t_status.values()) == set(j_status.values()) == {"complete"}
    shared = max(len({a.job_id for a in th.state.allocs_by_node(n.id)})
                 for n in th.state.nodes())
    assert shared >= (3 if shape == "fits" else 2), \
        "the lanes were meant to share nodes"
    for node in th.state.nodes():
        live = [a for a in th.state.allocs_by_node(node.id)
                if not a.terminal_status()]
        fit, dim, _ = t_allocs_fit(node, live)
        assert fit, f"node {node.id} oversubscribed on {dim}"


def test_on_a_mesh_the_stragglers_take_the_per_eval_retry():
    """Where a mesh resolves the chained window is not launched: each
    straggler takes the per-eval retry (a scheduler of its own, its
    walk sharded), and every eval still completes on a fleet no node of
    which is oversubscribed."""
    from nomad_tpu_torch.parallel import mesh as tmesh

    jobs = _tail_jobs()
    _jh, th = _worlds([mock.node(i) for i in range(8)], jobs,
                      verifying=True)
    runner = TRunner(th.state.snapshot(), _StalePlanner(th, 2),
                     state_refresh=th.snapshot, device="cpu")
    with tmesh.mesh_override(["cpu"] * 8), t_executor_override("device"), \
            _seeded():
        runner.process([TEvaluation.from_dict(_make_eval(j).to_dict())
                        for j in jobs])
    assert (runner.chained_evals, runner.solo_evals) == (0, len(jobs))
    placed, failed, status = _committed(th)
    assert len(placed) == 15 and not failed
    assert set(status.values()) == {"complete"}
    for node in th.state.nodes():
        live = [a for a in th.state.allocs_by_node(node.id)
                if not a.terminal_status()]
        assert t_allocs_fit(node, live)[0]


def test_runner_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TRunner(None, None)


# -- the sequence walk K2 and K4b share on the card, modelled in numpy --------
#
# csrc/binpack.cu place_sequence_cluster_lane keeps one score slot per
# group (one slot when there are more groups than MAX_SLOTS), scores a
# slot in full only when its group is first named (with one slot: at
# every group change), and after a placement rescores only the placed
# node in every slot; a step that places nothing adds +0.0 to its argmax
# row and rescores nothing.  The model runs that walk with the JAX
# package's own K1 (so scores compare bit for bit) and is held lane by
# lane to the JAX batch kernel, which rescores the whole fleet at every
# step.

MAX_SLOTS = 32  # MAX_SLOTS in csrc/binpack.cu

_jax_score = jax.jit(jbp.score_all_nodes)


def sequence_walk_model(cap, res, usage0, jc0, feas, asks, distinct,
                        group_idx, valid, penalty, stale_others=False):
    """One lane of the incremental walk: (chosen, scores, usage).
    ``stale_others`` leaves every slot but the step's own stale after a
    placement (for the mutation test)."""
    usage = usage0.copy()
    jc = jc0.copy()
    slot_of = (lambda g: g) if feas.shape[0] <= MAX_SLOTS else \
        (lambda g: 0)
    slot_group: dict = {}
    slot_scores: dict = {}

    def score(g):
        return np.array(_jax_score(cap, res, usage, jc, asks[g], feas[g],
                                   distinct[g], np.float32(penalty)))
    chosen = np.full(len(group_idx), -1, dtype=np.int32)
    scores = np.zeros(len(group_idx), dtype=np.float32)
    for p, (g, is_valid) in enumerate(zip(group_idx.tolist(),
                                          valid.tolist())):
        slot = slot_of(g)
        if slot_group.get(slot) != g:
            slot_group[slot] = g
            slot_scores[slot] = score(g)
        i = int(np.argmax(slot_scores[slot]))  # ties to the lower index
        scores[p] = slot_scores[slot][i]
        ok = is_valid and scores[p] > tbp.NEG_INF / 2
        usage[i] = usage[i] + (asks[g] if ok else asks[g] * np.float32(0.0))
        if not ok:
            continue
        chosen[p] = i
        jc[i] += 1
        for s, gs in slot_group.items():
            if s == slot or not stale_others:
                slot_scores[s][i] = score(gs)[i]
    return chosen, scores, usage


def _many_groups_case(rng, used, groups=40):
    """_lanes_case with G=40 slots per lane (more than MAX_SLOTS): every
    step names a group drawn from all 40."""
    (fleet, usage, jc, feasible, asks, distinct, _gi, valid, _c,
     penalty) = _lanes_case(rng, used)
    n_pad = feasible.shape[-1]
    feasible = np.zeros((LANES, groups, n_pad), dtype=bool)
    asks = np.zeros((LANES, groups, 6), dtype=np.float32)
    distinct = np.zeros((LANES, groups), dtype=bool)
    group_idx = np.zeros((LANES, PLACE), dtype=np.int32)
    for b in range(REAL):
        asks[b, :, 0] = rng.integers(50, 700, groups)
        asks[b, :, 1] = rng.integers(40, 900, groups)
        feasible[b, :, :fleet.n_real] = rng.random((groups, fleet.n_real)) \
            > 0.2
        distinct[b] = rng.random(groups) > 0.7
        group_idx[b] = rng.integers(0, groups, PLACE)
    return (fleet, usage, jc, feasible, asks, distinct, group_idx, valid,
            penalty)


def _walk_case(order, used):
    rng = np.random.default_rng(57)
    if order == "40 groups":
        case = _many_groups_case(rng, used)
    else:
        (fleet, usage, jc, feasible, asks, distinct, _gi, valid, _c,
         penalty) = _lanes_case(rng, used)
        group_idx = np.tile(np.asarray(_ORDERS[order], dtype=np.int32),
                            (LANES, 1))
        case = (fleet, usage, jc, feasible, asks, distinct, group_idx,
                valid, penalty)
    fleet, usage, *rest = case
    usage = _negative_zero(usage)
    rest[5][:REAL, 6] = False  # an invalid step inside a run
    return (fleet, usage, *rest)


@pytest.mark.parametrize("order", sorted(_ORDERS) + ["40 groups"])
@pytest.mark.parametrize("used", [False, True])
def test_sequence_walk_model_equals_jax_lane_by_lane(order, used):
    """Chosen nodes exactly, every step's score and the final usage bit
    for bit (-0.0 included), in every lane and the pad lane."""
    (fleet, usage, jc, feasible, asks, distinct, group_idx, valid,
     penalty) = _walk_case(order, used)
    j_chosen, j_scores, j_usage = (np.asarray(x) for x in
                                   jbp.place_sequence_batch(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, group_idx, valid, penalty))
    for b in range(LANES):
        chosen, scores, lane_usage = sequence_walk_model(
            fleet.capacity, fleet.reserved, usage, jc[b], feasible[b],
            asks[b], distinct[b], group_idx[b], valid[b], penalty[b])
        assert np.array_equal(chosen, j_chosen[b])
        assert np.array_equal(scores.view(np.int32),
                              j_scores[b].astype(np.float32).view(np.int32))
        assert np.array_equal(lane_usage.view(np.int32),
                              j_usage[b].astype(np.float32).view(np.int32))
    assert (j_chosen[:REAL] >= 0).sum() > 0
    assert _neg_zeros(j_usage[0]) < _neg_zeros(usage)


def test_sequence_walk_model_fails_with_a_stale_slot():
    """Groups interleaved, so a node placed for one group is scored again
    for the others: left stale in their slots, it keeps its score from
    before the placement and the model parts from JAX."""
    (fleet, usage, jc, feasible, asks, distinct, group_idx, valid,
     penalty) = _walk_case("interleaved", True)
    j_out = [np.asarray(x) for x in jbp.place_sequence_batch(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, group_idx, valid, penalty)]
    differs = 0
    for b in range(REAL):
        stale = sequence_walk_model(
            fleet.capacity, fleet.reserved, usage, jc[b], feasible[b],
            asks[b], distinct[b], group_idx[b], valid[b], penalty[b],
            stale_others=True)
        differs += not all(np.array_equal(
            np.asarray(x).view(np.int32),
            np.asarray(y[b]).astype(x.dtype).view(np.int32))
            for x, y in zip(stale, j_out))
    assert differs > 0


@pytest.mark.parametrize("kind", ["rounds", "sequence", "contended"])
def test_sharded_storm_byte_identical_placements(kind, monkeypatch):
    """Twin of tests/test_parallel.py's test of the name: the fused storm
    with the node axis and the lanes sharded (the port: a mesh of eight
    cpu entries; the JAX package: its 8-device mesh) commits byte for
    byte what the other package's sharded storm and the port's unsharded
    storm commit: rounds lanes (K4a's sharded form), lanes too large
    for the rounds (K4b's) and a contended storm through each package's
    VerifyingPlanner with state_refresh."""
    from nomad_tpu_torch.parallel import mesh as tmesh

    def jobs_of():
        if kind == "rounds":
            return [_service_job(4), _batch_job(3), _service_job(2, cpu=900),
                    _batch_job(5)]
        if kind == "sequence":
            jobs = []
            for count in (6, 5, 4):
                j = mock.job()
                tg = j.task_groups[0]
                tg.count = count
                tg.tasks[0].resources = Resources(
                    cpu=1500, memory_mb=3000, networks=[NetworkResource(
                        mbits=10, dynamic_ports=["http"])])
                jobs.append(j)
            return jobs
        return _contended_jobs(800)

    nodes = [mock.node(i) for i in range(8)] if kind == "contended" \
        else _sized_nodes(16, 3)
    jobs = jobs_of()
    evals = [_make_eval(j) for j in jobs]
    verifying = kind == "contended"
    sharded = []
    for name in ("place_rounds_batch_sharded",
                 "place_sequence_batch_sharded"):
        real = getattr(tmesh, name)
        monkeypatch.setattr(tmesh, name, lambda mesh, *a, _r=real, **kw:
                            sharded.append(mesh) or _r(mesh, *a, **kw))

    jh, th = _worlds(nodes, jobs, verifying=verifying)
    with mesh_override("auto"), executor_override("device"), _seeded():
        JRunner(jh.state.snapshot(), jh, state_refresh=jh.snapshot
                ).process(evals)
    with tmesh.mesh_override(["cpu"] * 8):
        _run_port(th, evals, refresh=True)
    assert sharded and all(m.devices == (torch.device("cpu"),) * 8
                           for m in sharded)
    placed, _failed, status = _assert_same(jh, th)
    assert placed and set(status.values()) == {"complete"}
    _jh, tu = _worlds(nodes, jobs, verifying=verifying)
    with tmesh.mesh_override("off"):
        _run_port(tu, evals, refresh=True)
    assert _committed(tu) == _committed(th)
