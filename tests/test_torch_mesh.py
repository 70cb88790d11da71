"""K7 of the port (nomad_tpu_torch/parallel/mesh.py: mesh resolution,
the mesh layouts and the five sharded wrappers) against the JAX
package's sharded forms (nomad_tpu/parallel/mesh.py) on the same seeded
inputs: a twin of every test in tests/test_parallel.py, and the cases
only the port has.

The port's meshes here are eight ``cpu`` entries (``mesh_override`` or
``fleet_mesh`` with a device list), so every shard is tensors of its
own on the CPU and every K7 kernel runs its plain version; the JAX
forms run on the eight CPU devices tests/conftest.py forces.  The CUDA
kernels are held against those plain versions on the card by
``chip_smoke.py --mesh``.

Tolerances, the repo's parity contract: chosen nodes exactly equal;
scores rtol=1e-4, atol=1e-4 where placed; usage rtol=1e-5, atol=1e-3.
Against the port's own unsharded kernels (their plain versions here),
every output is exactly equal.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import nomad_tpu.mock as jmock
from nomad_tpu.models.fleet import build_fleet, build_usage
from nomad_tpu.ops import binpack as jbp
from nomad_tpu.parallel import mesh as jmesh
from nomad_tpu.structs import Resources
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import binpack as tbp
from nomad_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _problem(n_nodes=64, n_place=16):
    """tests/test_parallel.py _problem: mock nodes, one 500 MHz/256 MB
    group feasible on every real node, no distinct_hosts."""
    nodes = [jmock.node(i) for i in range(n_nodes)]
    fleet = build_fleet(nodes)
    view = build_usage(fleet, [])
    asks = np.zeros((1, 6), dtype=np.float32)
    asks[0] = Resources(cpu=500, memory_mb=256).as_vector()
    feasible = np.zeros((1, fleet.n_pad), dtype=bool)
    feasible[0, :fleet.n_real] = True
    group_idx = np.zeros(n_place, dtype=np.int32)
    valid = np.ones(n_place, dtype=bool)
    distinct = np.zeros(1, dtype=bool)
    return fleet, view, feasible, asks, distinct, group_idx, valid


def _rounds_problem(n_nodes=64, count=24):
    fleet, view, feasible, asks, distinct, _gi, _v = _problem(n_nodes)
    counts = np.asarray([count], dtype=np.int32)
    return fleet, view, feasible, asks, distinct, counts


def _lanes(b, *arrays):
    return [np.broadcast_to(a, (b,) + a.shape).copy() for a in arrays]


def _held(got, jax_out, exact=None):
    """The port's (chosen, scores, usage) against the JAX form's, under
    the parity contract, and exactly against ``exact`` (the port's
    unsharded kernel on the same inputs)."""
    c, s, u = (np.asarray(x) for x in got)
    jc, js, ju = (np.asarray(x) for x in jax_out)
    assert c.tolist() == jc.tolist()
    placed = c >= 0
    np.testing.assert_allclose(s[placed], js[placed], rtol=1e-4, atol=1e-4)
    if ju.shape == u.shape:
        np.testing.assert_allclose(u, ju, rtol=1e-5, atol=1e-3)
    if exact is not None:
        for x, y in zip(got, exact):
            assert torch.equal(x, y)


def test_mesh_has_8_entries():
    """The JAX side's eight CPU devices; the port's mesh of eight cpu
    entries, cached, so equal requests get the same object."""
    assert len(jax.devices("cpu")) == 8
    with tmesh.mesh_override(CPU8):
        mesh = tmesh.dispatch_mesh(1, 64)
        assert mesh is tmesh.dispatch_mesh(1, 64)
    assert mesh.shape == {"fleet": 8} and len(mesh.devices) == 8
    assert mesh == tmesh.fleet_mesh(CPU8)
    assert mesh.shape == dict(jmesh.fleet_mesh(jax.devices("cpu")).shape)


def test_sharded_matches_single_device():
    fleet, view, feasible, asks, distinct, group_idx, valid = _problem()
    args = (fleet.capacity, fleet.reserved, view.usage, view.job_counts,
            feasible, asks, distinct, group_idx, valid)
    jax_out = jmesh.place_sequence_sharded(
        jmesh.fleet_mesh(jax.devices("cpu")), *args, 10.0)
    got = tmesh.place_sequence_sharded(tmesh.fleet_mesh(CPU8), *args, 10.0)
    want = tbp.place_sequence(*(_t(a) for a in args), 10.0)
    _held(got, jax_out, want)


def test_batched_evals_are_independent():
    """Lanes plan on their own copies of one snapshot: on a mesh of
    eight shards of one row each, every lane places its 8 copies on
    all 8 nodes, as the JAX batch kernel does."""
    fleet, view, feasible, asks, distinct, group_idx, valid = _problem(
        n_nodes=8, n_place=8)
    b = 4
    lanes = _lanes(b, view.job_counts, feasible, asks, distinct, group_idx,
                   valid)
    pen = np.full(b, 10.0, dtype=np.float32)
    jax_out = jbp.place_sequence_batch(
        fleet.capacity, fleet.reserved, view.usage, *lanes, pen)
    got = tmesh.place_sequence_batch_sharded(
        tmesh.fleet_mesh(CPU8), fleet.capacity, fleet.reserved, view.usage,
        *lanes, pen)
    want = tbp.place_sequence_batch(
        _t(fleet.capacity), _t(fleet.reserved), _t(view.usage),
        *(_t(a) for a in lanes), _t(pen))
    _held(got, jax_out, want)
    chosen = got[0].numpy()
    for lane in range(1, b):
        assert chosen[lane].tolist() == chosen[0].tolist()
    assert sorted(chosen[0].tolist()) == list(range(8))


def test_place_rounds_sharded_parity():
    """place_rounds on the mesh (shards of 8 rows, fewer than k_cap)
    == the JAX sharded form and the port's unsharded kernel."""
    fleet, view, feasible, asks, distinct, counts = _rounds_problem()
    args = (fleet.capacity, fleet.reserved, view.usage, view.job_counts,
            feasible, asks, distinct, counts)
    kw = dict(k_cap=32, rounds=1)
    jax_out = jmesh.place_rounds_sharded(
        jmesh.fleet_mesh(jax.devices("cpu")), *args, 10.0, **kw)
    got = tmesh.place_rounds_sharded(tmesh.fleet_mesh(CPU8), *args, 10.0,
                                     **kw)
    want = tbp.place_rounds(*(_t(a) for a in args), 10.0, **kw)
    _held(got, jax_out, want)


def _batch_rounds_args(b):
    fleet, view, feasible, asks, distinct, counts = _rounds_problem()
    lanes = _lanes(b, view.job_counts, feasible, asks, distinct, counts)
    pen = np.full(b, 10.0, dtype=np.float32)
    return (fleet.capacity, fleet.reserved, view.usage, *lanes, pen)


def _batch_sequence_args(b):
    fleet, view, feasible, asks, distinct, group_idx, valid = _problem()
    lanes = _lanes(b, view.job_counts, feasible, asks, distinct, group_idx,
                   valid)
    pen = np.full(b, 10.0, dtype=np.float32)
    return (fleet.capacity, fleet.reserved, view.usage, *lanes, pen)


def test_place_rounds_batch_sharded_parity():
    args = _batch_rounds_args(3)
    kw = dict(k_cap=32, rounds=1)
    jax_out = jmesh.place_rounds_batch_sharded(
        jmesh.fleet_mesh(jax.devices("cpu")), *args, **kw)
    got = tmesh.place_rounds_batch_sharded(tmesh.fleet_mesh(CPU8), *args,
                                           **kw)
    want = tbp.place_rounds_batch(*(_t(a) for a in args), **kw)
    _held(got, jax_out, want)


def test_place_sequence_batch_sharded_parity():
    args = _batch_sequence_args(3)
    jax_out = jmesh.place_sequence_batch_sharded(
        jmesh.fleet_mesh(jax.devices("cpu")), *args)
    got = tmesh.place_sequence_batch_sharded(tmesh.fleet_mesh(CPU8), *args)
    want = tbp.place_sequence_batch(*(_t(a) for a in args))
    _held(got, jax_out, want)


def test_storm_mesh_2d_lane_parallel_parity():
    """2-D (lanes, fleet) mesh, 2 lane rows x 4 shards: each row plans
    its own lanes; results equal the JAX forms on the JAX storm mesh and
    the port's unsharded kernels."""
    jax_2d = jmesh.storm_mesh(2, jax.devices("cpu"))
    port_2d = tmesh.storm_mesh(2, CPU8)
    assert port_2d.shape == dict(jax_2d.shape)
    args = _batch_rounds_args(4)
    kw = dict(k_cap=32, rounds=1)
    _held(tmesh.place_rounds_batch_sharded(port_2d, *args, **kw),
          jmesh.place_rounds_batch_sharded(jax_2d, *args, **kw),
          tbp.place_rounds_batch(*(_t(a) for a in args), **kw))
    args = _batch_sequence_args(4)
    _held(tmesh.place_sequence_batch_sharded(port_2d, *args),
          jmesh.place_sequence_batch_sharded(jax_2d, *args),
          tbp.place_sequence_batch(*(_t(a) for a in args)))


def test_storm_mesh_validates_lane_ways():
    with pytest.raises(ValueError, match="must divide"):
        jmesh.storm_mesh(3, jax.devices("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        tmesh.storm_mesh(3, CPU8)  # 3 does not divide 8


# -- end-to-end sharded parity ----------------------------------------------
# The full scheduler stream (reconcile, prep, device dispatch, finish,
# plan commit) run sharded and unsharded on twin clusters (the port's
# converted from the JAX package's), placements compared per eval as
# (node index, task group).


def _twin_rig(n_nodes: int, n_jobs: int, count: int):
    from nomad_tpu.scheduler import Harness as JHarness
    from nomad_tpu_torch.scheduler import Harness

    ref_nodes = [jmock.node(i) for i in range(n_nodes)]
    ref_jobs = []
    for k in range(n_jobs):
        job = jmock.job()
        job.id = f"mesh-{k}"
        job.task_groups[0].count = count
        ref_jobs.append(job)
    jh = JHarness()
    for n in ref_nodes:
        jh.state.upsert_node(jh.next_index(), n)
    for j in ref_jobs:
        jh.state.upsert_job(jh.next_index(), j)
    th = Harness(device="cpu")
    for n in convert.nodes_from_reference(ref_nodes):
        th.state.upsert_node(th.next_index(), n)
    for j in convert.jobs_from_reference(ref_jobs):
        th.state.upsert_job(th.next_index(), j)
    return jh, th, ref_jobs


def _placements(h) -> list:
    index_of = {n.id: i for i, n in enumerate(h.state.nodes())}
    out = []
    for plan in h.plans:
        out.append(sorted((index_of[node_id], a.task_group)
                          for node_id, allocs in plan.node_allocation.items()
                          for a in allocs))
    return out


def _port_eval(job):
    from nomad_tpu_torch.structs import (EVAL_TRIGGER_JOB_REGISTER,
                                         Evaluation, generate_uuid)

    return Evaluation(id=generate_uuid(), priority=job.priority,
                      type=job.type, triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                      job_id=job.id)


def _jax_eval(job):
    from nomad_tpu.structs import (EVAL_TRIGGER_JOB_REGISTER, Evaluation,
                                   generate_uuid)

    return Evaluation(id=generate_uuid(), priority=job.priority,
                      type=job.type, triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                      job_id=job.id)


def _port_stream(policy, n_nodes=24, n_jobs=6, count=8):
    """One committed eval stream through the port's PipelinedEvalRunner
    under a mesh policy, every commit landing before the next eval
    plans (each view rides the mirror's scatter-maintained copies)."""
    from nomad_tpu_torch.models.fleet import fleet_cache, mirror_for
    from nomad_tpu_torch.scheduler.executor import executor_override
    from nomad_tpu_torch.scheduler.pipeline import PipelinedEvalRunner

    _jh, th, jobs = _twin_rig(n_nodes, n_jobs, count)
    runner = PipelinedEvalRunner(th.state.snapshot(), th, depth=3,
                                 state_refresh=th.snapshot, device="cpu")
    with tmesh.mesh_override(policy), executor_override("device"):
        for job in jobs:
            runner.state = th.snapshot()
            runner.process([_port_eval(job)])
    statics = fleet_cache.statics_for(th.state)
    return _placements(th), runner, mirror_for(statics), th


def test_sharded_stream_byte_identical_placements():
    """Sharded and unsharded committed streams place byte-identically,
    every eval, including evals whose usage came off the mirror's
    scatter-maintained sharded twin; and as the JAX stream on its
    8-device mesh.  After the stream the twin equals the host mirror
    byte for byte."""
    from nomad_tpu.scheduler.executor import \
        executor_override as j_executor_override
    from nomad_tpu.scheduler.pipeline import \
        PipelinedEvalRunner as JRunner

    sharded, runner_s, mirror_s, th = _port_stream(CPU8)
    unsharded, runner_u, _m, _h = _port_stream("off")
    assert runner_s.device_dispatches > 0
    assert runner_s.sharded_dispatches == runner_s.device_dispatches
    assert runner_u.sharded_dispatches == 0
    assert sharded == unsharded
    assert sum(len(p) for p in sharded) == 6 * 8

    jh, _th, jobs = _twin_rig(24, 6, 8)
    jrunner = JRunner(jh.state.snapshot(), jh, depth=3,
                      state_refresh=jh.snapshot)
    with jmesh.mesh_override("auto"), j_executor_override("device"):
        for job in jobs:
            jrunner.state = jh.snapshot()
            jrunner.process([_jax_eval(job)])
    assert jrunner.sharded_dispatches == jrunner.device_dispatches > 0
    assert _placements(jh) == sharded

    from nomad_tpu_torch.models.fleet import fleet_cache

    statics = fleet_cache.statics_for(th.state)
    with tmesh.mesh_override(CPU8):
        mesh = tmesh.dispatch_mesh(1, statics.n_pad, device="cpu")
    assert mesh is not None
    mirror_s.sync(th.state)
    buf = mirror_s.device_usage_sharded(mesh, mirror_s.usage)
    assert buf is not None
    np.testing.assert_array_equal(tmesh.gather(buf).numpy(), mirror_s.usage)


def test_sharded_storm_byte_identical_placements():
    """The fused storm (BatchEvalRunner, the 2-D storm mesh of eight
    entries) against its unsharded twin and the JAX storm on its 8
    devices: byte-identical placements lane for lane."""
    from nomad_tpu.scheduler.batch import BatchEvalRunner as JBatch
    from nomad_tpu.scheduler.executor import \
        executor_override as j_executor_override
    from nomad_tpu_torch.scheduler.batch import BatchEvalRunner
    from nomad_tpu_torch.scheduler.executor import executor_override

    def run(policy):
        _jh, th, jobs = _twin_rig(16, 4, 6)
        with tmesh.mesh_override(policy), executor_override("device"):
            BatchEvalRunner(th.state.snapshot(), th,
                            state_refresh=th.snapshot,
                            device="cpu").process(
                [_port_eval(j) for j in jobs])
        return _placements(th)

    with tmesh.mesh_override(CPU8):
        storm = tmesh.dispatch_mesh(4, 16, device="cpu")
    assert storm.shape == {"lanes": 4, "fleet": 2}
    sharded = run(CPU8)
    assert sharded == run("off")
    jh, _th, jobs = _twin_rig(16, 4, 6)
    with jmesh.mesh_override("auto"), j_executor_override("device"):
        JBatch(jh.state.snapshot(), jh, state_refresh=jh.snapshot).process(
            [_jax_eval(j) for j in jobs])
    assert _placements(jh) == sharded


# -- the port's own cases ---------------------------------------------------


@pytest.mark.parametrize("cards", [1, 2, 8])
def test_dispatch_mesh_counts_distinct_cards(monkeypatch, cards):
    """Without an override the mesh spans the distinct CUDA devices, by
    the JAX package's rule: none below two, a fleet mesh for one lane,
    the storm layout for lanes that split; a caller on the CPU gets
    none.  No card is touched (torch.cuda.device_count is patched)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.delenv(tmesh.ENV_VAR, raising=False)
    mesh = tmesh.dispatch_mesh(1, 1024)
    assert tmesh.dispatch_mesh(1, 1024, device="cpu") is None
    if cards < 2:
        assert mesh is None
        return
    assert mesh.shape == {"fleet": cards}
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(cards))
    storm = tmesh.dispatch_mesh(4, 1024)
    ways = min(cards // 2, 4)
    assert storm.shape == ({"lanes": ways, "fleet": cards // ways}
                           if ways > 1 else {"fleet": cards})
    # A one-row node axis cannot split.
    assert tmesh.dispatch_mesh(1, 1) is None


@pytest.mark.parametrize("cards,card,want", [(2, 1, [1, 0]),
                                             (4, 2, [2, 3, 0, 1])])
def test_dispatch_mesh_leads_with_the_callers_card(monkeypatch, cards,
                                                   card, want):
    """A caller that names a card gets a mesh led by it: the results and
    the resident twins of a server on ``cuda:1`` land on ``cuda:1``.
    No card is touched (torch.cuda.device_count is patched)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.delenv(tmesh.ENV_VAR, raising=False)
    mesh = tmesh.dispatch_mesh(1, 1024, device=f"cuda:{card}")
    assert mesh.lead == torch.device("cuda", card)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in want)
    storm = tmesh.dispatch_mesh(4, 1024, device=f"cuda:{card}")
    assert storm.lead == torch.device("cuda", card)
    assert tmesh.dispatch_mesh(1, 1024).lead == torch.device("cuda", 0)


def _wide_fleet(n, seed=11):
    """A fleet of ``n`` real nodes of 4,096 MHz whose CPU usage, with a
    500 MHz ask, gives the score's pow an argument that ATen's scalar
    loop and its vectorized loop round apart on this CPU (about 2% of
    arguments do): so an element that falls in a scalar tail anywhere
    scores otherwise than the same element in a vectorized block."""
    rng = np.random.default_rng(seed)
    used = np.arange(0, 3500, dtype=np.float32)
    x = 1.0 - (torch.zeros(len(used)) + _t(used) + 500.0) / 4096.0
    blocks = torch.pow(10.0, torch.cat([x, x.new_zeros(-len(x) % 32)]))
    alone = torch.stack([torch.pow(10.0, v.reshape(1))[0] for v in x])
    apart = used[(blocks[:len(x)] != alone).numpy()]
    capacity = np.zeros((n, 6), dtype=np.float32)
    capacity[:, 0] = 4096
    capacity[:, 1] = rng.integers(4096, 32768, n)
    capacity[:, 2:] = 1e6
    usage = np.zeros_like(capacity)
    usage[:, 0] = rng.choice(apart if len(apart) else used, n)
    usage[:, 1] = rng.integers(0, 4096, n)
    return (capacity, np.zeros_like(capacity), usage,
            np.zeros(n, dtype=np.int32))


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_shards_score_as_the_whole_fleet_above_the_parallel_grain(threads):
    """A fleet of 131,072 rows, above ATen's parallel grain (32,768),
    on one thread, on three (which split the pass into chunks off a
    multiple of 32) and on eight: each of 8 shards scores its rows
    exactly as the whole fleet does, and the sharded rounds walk equals
    the unsharded one."""
    prior = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        n = 1 << 17
        capacity, reserved, usage, job_counts = _wide_fleet(n)
        ask = _t(np.asarray([500, 256, 0, 0, 0, 0], dtype=np.float32))
        feasible = torch.ones(n, dtype=torch.bool)
        args = [_t(a) for a in (capacity, reserved, usage, job_counts)]
        whole = tbp.score_all_nodes(*args, ask, feasible,
                                    torch.tensor(False), 10.0)
        rows = n // 8
        parts = torch.cat([tbp.score_all_nodes(
            *(a[s * rows:(s + 1) * rows] for a in args), ask,
            feasible[:rows], torch.tensor(False), 10.0)
            for s in range(8)])
        assert torch.equal(whole, parts)
        walk = (capacity, reserved, usage, job_counts,
                np.ones((1, n), dtype=bool), ask.numpy()[None],
                np.zeros(1, dtype=bool), np.asarray([256], dtype=np.int32))
        got = tmesh.place_rounds_sharded(tmesh.fleet_mesh(CPU8), *walk,
                                         10.0, k_cap=256, rounds=1)
        want = tbp.place_rounds(*(_t(a) for a in walk), 10.0, k_cap=256,
                                rounds=1)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    finally:
        torch.set_num_threads(prior)


@pytest.mark.parametrize("value,want", [("off", None), ("0", None),
                                        ("2", 2), ("auto", 8), ("", 8)])
def test_nomad_tpu_mesh_env(monkeypatch, value, want):
    """NOMAD_TPU_MESH, read per dispatch as in the JAX package: "off" /
    "0" force the unsharded kernels, an integer caps the devices; an
    override's device list wins over it."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setenv(tmesh.ENV_VAR, value)
    mesh = tmesh.dispatch_mesh(1, 1024)
    jax_mesh = jmesh.dispatch_mesh(1, 1024)
    if want is None:
        assert mesh is None and jax_mesh is None
    else:
        assert mesh.shape == {"fleet": want}
        assert dict(jax_mesh.shape) == {"fleet": want}
    with tmesh.mesh_override(CPU8):
        assert tmesh.dispatch_mesh(1, 1024).shape == {"fleet": 8}


@pytest.mark.parametrize("k_cap,rounds", [(32, 1), (64, 1), (12, 3)])
def test_a_shard_with_fewer_rows_than_k_cap(k_cap, rounds):
    """Shards of 8 rows hand K7b all of their rows when k_cap exceeds
    them (up to k_cap = N); the walk equals the unsharded kernel, over
    several rounds too, and the JAX sharded form."""
    rng = np.random.default_rng(7)
    fleet, view, feasible, asks, distinct, counts = _rounds_problem()
    usage = view.usage.copy()
    usage[:fleet.n_real, 0] = rng.integers(0, 3000, fleet.n_real)
    counts = np.asarray([40], dtype=np.int32)
    args = (fleet.capacity, fleet.reserved, usage, view.job_counts,
            feasible, asks, distinct, counts)
    kw = dict(k_cap=k_cap, rounds=rounds)
    got = tmesh.place_rounds_sharded(tmesh.fleet_mesh(CPU8), *args, 10.0,
                                     **kw)
    want = tbp.place_rounds(*(_t(a) for a in args), 10.0, **kw)
    _held(got, jmesh.place_rounds_sharded(
        jmesh.fleet_mesh(jax.devices("cpu")), *args, 10.0, **kw), want)


def test_ties_straddling_a_shard_edge():
    """A fleet of equal nodes: every score ties, so the top k_cap runs
    over shard edges (12 of 8-row shards) and each step's argmax is the
    lowest index of the fleet; both walks take the lower global index
    as the unsharded kernels do."""
    fleet, view, feasible, asks, distinct, counts = _rounds_problem()
    counts = np.asarray([12], dtype=np.int32)
    args = (fleet.capacity, fleet.reserved, view.usage, view.job_counts,
            feasible, asks, distinct, counts)
    got = tmesh.place_rounds_sharded(tmesh.fleet_mesh(CPU8), *args, 10.0,
                                     k_cap=12, rounds=1)
    assert got[0][0].tolist() == list(range(12))
    jax_mesh = jmesh.fleet_mesh(jax.devices("cpu"))
    _held(got, jmesh.place_rounds_sharded(jax_mesh, *args, 10.0, k_cap=12,
                                          rounds=1),
          tbp.place_rounds(*(_t(a) for a in args), 10.0, k_cap=12,
                           rounds=1))
    fleet, view, feasible, asks, distinct, group_idx, valid = _problem()
    args = (fleet.capacity, fleet.reserved, view.usage, view.job_counts,
            feasible, asks, distinct, group_idx, valid)
    got = tmesh.place_sequence_sharded(tmesh.fleet_mesh(CPU8), *args, 10.0)
    assert got[0].tolist() == list(range(16))  # spread, lowest first
    _held(got, jmesh.place_sequence_sharded(jax_mesh, *args, 10.0),
          tbp.place_sequence(*(_t(a) for a in args), 10.0))


def _raising(name):
    def broken(*a, **kw):
        raise RuntimeError(f"{name}: CUDA error 700")
    return broken


@pytest.mark.parametrize("site", ["scheduler", "storm", "verify"])
def test_a_k7_launch_that_fails_on_a_mesh_raises(monkeypatch, site):
    """No fallback: where a mesh resolves, a failed K7 launch surfaces
    from the entry point, and neither the unsharded kernels nor the host
    twins run in its place (every one of them is patched to fail the
    test if called)."""
    from nomad_tpu_torch.ops import binpack_host
    from nomad_tpu_torch.ops.plan_conflict import evaluate_window
    from nomad_tpu_torch.ops.verify_policy import verify_override
    from nomad_tpu_torch.scheduler.batch import BatchEvalRunner
    from nomad_tpu_torch.scheduler.executor import executor_override

    called = []
    for mod, name in ((tbp, "place_rounds"), (tbp, "place_sequence"),
                      (tbp, "place_rounds_batch"),
                      (tbp, "place_sequence_batch"),
                      (tmesh, "window_verify"),
                      (binpack_host, "place_rounds_host"),
                      (binpack_host, "place_sequence_host")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **kw:
                            called.append(_n))
    _jh, th, jobs = _twin_rig(16, 2, 3)
    with tmesh.mesh_override(CPU8), executor_override("device"):
        if site == "scheduler":
            monkeypatch.setattr(tbp, "shard_select",
                                _raising("shard_select"))
            with pytest.raises(RuntimeError, match="CUDA error"):
                th.process("torch-binpack", _port_eval(jobs[0]))
        elif site == "storm":
            monkeypatch.setattr(tbp, "merge_select",
                                _raising("merge_select"))
            with pytest.raises(RuntimeError, match="CUDA error"):
                BatchEvalRunner(th.state.snapshot(), th,
                                device="cpu").process(
                    [_port_eval(j) for j in jobs])
        else:
            from tests.test_torch_plan_conflict import (_worlds, make_alloc,
                                                        place_plan)

            nodes = [jmock.node(i) for i in range(8)]
            _js, ts = _worlds(nodes)
            plans = convert.plans_from_reference(
                [place_plan(make_alloc(n, cpu=100)) for n in nodes])
            monkeypatch.setattr(tmesh, "shard_gather",
                                _raising("shard_gather"))
            with verify_override("device"), \
                    pytest.raises(RuntimeError, match="CUDA error"):
                evaluate_window(ts, plans)
    assert called == []
    assert th.plans == []


def test_sharded_window_verify_equals_k6():
    """window_verify_sharded on eight shards (K7d's masked gathers summed,
    then K6's body) equals window_verify on the whole fleet, the packed
    form too."""
    rng = np.random.default_rng(11)
    n = 64
    cap = np.zeros((n, 6), dtype=np.float32)
    cap[:50, :4] = (4000, 8192, 102400, 150)
    res = np.zeros((n, 6), dtype=np.float32)
    res[:50, :2] = (100, 256)
    usage = np.zeros((n, 6), dtype=np.float32)
    usage[:50, 0] = rng.integers(0, 3000, 50)
    b = 16
    desc = dict(
        pair_ni=np.sort(rng.integers(0, 50, b)).astype(np.int32),
        row_pair=np.arange(b, dtype=np.int32),
        row_vec=np.tile(np.float32([500, 256, 0, 0]), (b, 1)),
        seq_ni=np.where(np.arange(b) < 10, rng.integers(0, 50, b),
                        -1).astype(np.int32),
        seq_vec=np.tile(np.float32([300, 100, 0, 0]), (b, 1)),
        seq_order=np.arange(b, dtype=np.int32),
        seq_comp=np.zeros(b, dtype=np.int32),
        pair_order=np.arange(b, dtype=np.int32),
        pair_comp=np.zeros(b, dtype=np.int32),
        pair_removed=np.zeros((b, 4), dtype=np.float32))
    want = tmesh.window_verify(_t(cap), _t(res), _t(usage), **desc)
    mesh = tmesh.fleet_mesh(CPU8)
    got = tmesh.window_verify_sharded(mesh, cap, res, usage, **desc)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    packed = tmesh.window_verify_sharded(mesh, cap, res, usage, packed=True,
                                         **desc)
    assert torch.equal(packed, tmesh.pack_results(*want))
    jax_out = jmesh.window_verify_sharded(
        jmesh.fleet_mesh(jax.devices("cpu")), cap, res, usage,
        *(desc[k] for k in ("pair_ni", "row_pair", "row_vec", "seq_ni",
                            "seq_vec", "seq_order", "seq_comp",
                            "pair_order", "pair_comp", "pair_removed")))
    for x, y in zip(got, jax_out):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_puts_count_one_transfer_per_array():
    """The transfer odometer counts a sharded upload as the JAX package's
    _put does: one h2d per array, none for an operand already resident
    with its layout."""
    from nomad_tpu_torch.parallel.devices import transfer_counts

    mesh = tmesh.fleet_mesh(CPU8)
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    before = transfer_counts()["h2d"]
    a = tmesh._put(x, mesh, tmesh.NODE)
    assert transfer_counts()["h2d"] == before + 1
    assert tmesh._put(a, mesh, tmesh.NODE) is a
    assert transfer_counts()["h2d"] == before + 1
    assert len(a) == 8 and all(s.shape == (2, 2) for s in a)
    assert torch.equal(tmesh.gather(a), torch.from_numpy(x))
