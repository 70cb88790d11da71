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


def _across_cards(monkeypatch, cap=3):
    """Make the eight cpu entries take the routes of shards that span
    cards: three shards a shard_step launch (so a row is several launch
    groups: shard_step + K7b), and three read in place by the sharded
    K6 (the other five send K7d partials)."""
    monkeypatch.setattr(tmesh, "device_groups",
                        lambda devs, _g=tmesh.device_groups: _g(devs, cap))
    monkeypatch.setattr(tmesh, "VERIFY_SHARDS", cap)


@pytest.mark.parametrize("site", ["scheduler", "storm", "verify",
                                  "walk-scheduler", "walk-storm",
                                  "walk-verify"])
def test_a_k7_launch_that_fails_on_a_mesh_raises(monkeypatch, site):
    """No fallback: where a mesh resolves, a failed K7 launch surfaces
    from the entry point, and neither the unsharded kernels nor the host
    twins run in its place (every one of them is patched to fail the
    test if called).  The first three sites take the routes of shards
    that span cards (shard_step, K7b, K7d fail); the ``walk-`` sites the
    one-card routes of the eight entries (shard_walk, K6's sharded
    form fail)."""
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
    walk = site.startswith("walk-")
    site = site.removeprefix("walk-")
    if not walk:
        _across_cards(monkeypatch)
    _jh, th, jobs = _twin_rig(16, 2, 3)
    with tmesh.mesh_override(CPU8), executor_override("device"):
        if site == "scheduler":
            name = "shard_walk" if walk else "shard_step"
            monkeypatch.setattr(tbp, name, _raising(name))
            with pytest.raises(RuntimeError, match="CUDA error"):
                th.process("torch-binpack", _port_eval(jobs[0]))
        elif site == "storm":
            name = "shard_walk" if walk else "merge_select"
            monkeypatch.setattr(tbp, name, _raising(name))
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
            name = "window_verify_shards" if walk else "shard_gather"
            monkeypatch.setattr(tmesh, name, _raising(name))
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


# -- shard_step (K7a+c): the per-shard half of a step, in one launch --------


def _step_case(walk: str, k: int, lanes: int = 2, n: int = 64,
               shards: int = 4, seed: int = 5):
    """``shards`` shards of an ``n``-row fleet as shard_step takes them
    (CPU tensors, ``lanes`` lanes), with the lead's candidate and update
    buffers: every node alike, so each step's scores tie across shard
    edges, and -0.0 in every usage entry, so an add of +0.0 (a winner
    not taken) shows in the bits."""
    rng = np.random.default_rng(seed)
    rows, g, p = n // shards, 3, 6
    cap = np.zeros((n, 6), dtype=np.float32)
    cap[:, :5] = (4000, 8192, 102400, 150, 1000)
    cap[:, 5] = 40000.0
    asks = np.zeros((lanes, g, 6), dtype=np.float32)
    asks[..., 0] = rng.integers(50, 700, (lanes, g))
    asks[..., 1] = rng.integers(40, 900, (lanes, g))
    feas = rng.random((lanes, g, n)) > 0.2
    base = dict(usage=np.full((lanes, n, 6), -0.0, dtype=np.float32),
                job_counts=np.zeros((lanes, n), dtype=np.int32))
    gi = rng.integers(0, g, (lanes, p)).astype(np.int32)
    kout = 1 if walk == "sequence" else k
    cand_v = torch.empty((shards, lanes, k), dtype=torch.float32)
    cand_i = torch.empty((shards, lanes, k), dtype=torch.int32)
    upd = torch.full((shards, lanes, kout), -1, dtype=torch.int32)
    out = []
    for s in range(shards):
        lo, hi = s * rows, (s + 1) * rows
        out.append(dict(
            capacity=_t(cap[lo:hi]), reserved=torch.zeros(rows, 6),
            usage=_t(base["usage"][:, lo:hi]),
            job_counts=_t(base["job_counts"][:, lo:hi]),
            feasible=_t(feas[..., lo:hi]), asks=_t(asks),
            distinct=torch.zeros((lanes, g), dtype=torch.bool),
            penalty=torch.full((lanes,), 10.0),
            group_idx=_t(gi) if walk == "sequence" else None,
            out=(cand_v[s], cand_i[s]), upd=upd[s], row_lo=lo))
    return out, (cand_v, cand_i, rows, upd)


def _merge(walk, merge, step, lanes, k):
    """K7b's plain version on the shards' candidates of ``step``: the
    sequence step's one copy is not taken in lane 0 (its valid flag is
    off), a round takes 2 of its ``k`` winners a lane (the rest get
    +0.0)."""
    cand_v, cand_i, rows, upd = merge
    if walk == "sequence":
        valid = torch.ones((lanes, 6), dtype=torch.bool)
        valid[0, step] = False
        chosen = torch.full((lanes, 6), -7, dtype=torch.int32)
        tbp.merge_select_plain(cand_v, cand_i, rows, upd, chosen,
                               torch.zeros((lanes, 6)), slot=step,
                               valid=valid)
    else:
        counts = torch.full((lanes, 3), 2, dtype=torch.int32)
        tbp.merge_select_plain(cand_v, cand_i, rows, upd,
                               torch.full((lanes, 3, k), -7,
                                          dtype=torch.int32),
                               torch.zeros((lanes, 3, k)), slot=step,
                               m=torch.zeros(lanes, dtype=torch.int32),
                               counts=counts)


def _state(shards) -> list:
    return [(sh["usage"].clone(), sh["job_counts"].clone(),
             sh["out"][0].clone(), sh["out"][1].clone()) for sh in shards]


def _same_state(got, want) -> None:
    for (u, j, v, i), (wu, wj, wv, wi) in zip(got, want):
        assert torch.equal(u.view(torch.int32), wu.view(torch.int32))
        assert torch.equal(j, wj)
        assert torch.equal(v.view(torch.int32), wv.view(torch.int32))
        assert torch.equal(i, wi)


@pytest.mark.parametrize("mode", ["first", "middle", "tail"])
@pytest.mark.parametrize("walk,k", [("sequence", 1), ("rounds", 1),
                                    ("rounds", 4)])
def test_shard_step_plain_is_apply_then_select(walk, k, mode):
    """shard_step on CPU tensors (its plain version) equals
    shard_apply_plain then shard_select_plain, shard by shard, in each
    of its three modes: a walk's first step (select only), a middle step
    (apply the step before's K7b updates, then select on the rows just
    written) and the tail (apply only), bit for bit.  The updates come
    from K7b's plain merge of the first step's candidates; every score
    ties, so the winners straddle shard edges (the lowest global indices
    win), and lane 0's sequence winner is not taken, so its row gets
    ask * 0.0 (-0.0 usage turns +0.0), as a round's untaken winners get
    0.0."""
    lanes = 2
    shards, merge = _step_case(walk, k, lanes)
    tbp.shard_step(shards, apply_step=-1, select_step=0, k=k)
    if mode == "first":
        got = _state(shards)
        want_shards, _m = _step_case(walk, k, lanes)
        for sh in want_shards:
            v, i = tbp.shard_select_plain(
                sh["capacity"], sh["reserved"], sh["usage"],
                sh["job_counts"], sh["feasible"], sh["asks"],
                sh["distinct"], sh["penalty"], 0, k, sh["row_lo"],
                sh["group_idx"])
            sh["out"][0].copy_(v)
            sh["out"][1].copy_(i)
        _same_state(got, _state(want_shards))
        rows = merge[2]
        if walk == "sequence" or k == 1:
            # The fleet's first feasible row of each lane's step-0 group.
            assert all(int(sh["out"][1][b, 0]) >= sh["row_lo"]
                       for sh in shards for b in range(lanes))
        else:
            assert merge[1][0, 0].tolist() == [
                r for r in range(rows)
                if shards[0]["feasible"][0, 0, r]][:k]
        return
    _merge(walk, merge, 0, lanes, k)
    upd = merge[3]
    assert (upd >= 0).any()
    if walk == "sequence":
        owner = [s for s in range(4) if upd[s, 0, 0] >= 0]
        assert len(owner) == 1 and int(upd[owner[0], 0, 0]) & 1 == 0
    want = [dict(sh, usage=sh["usage"].clone(),
                 job_counts=sh["job_counts"].clone(),
                 out=(sh["out"][0].clone(), sh["out"][1].clone()))
            for sh in shards]
    select = 1 if mode == "middle" else -1
    tbp.shard_step(shards, apply_step=0, select_step=select, k=k)
    for sh in want:
        tbp.shard_apply_plain(sh["usage"], sh["job_counts"], sh["upd"],
                              sh["asks"], slot=0,
                              group_idx=sh["group_idx"])
        if select >= 0:
            v, i = tbp.shard_select_plain(
                sh["capacity"], sh["reserved"], sh["usage"],
                sh["job_counts"], sh["feasible"], sh["asks"],
                sh["distinct"], sh["penalty"], select, k, sh["row_lo"],
                sh["group_idx"])
            sh["out"][0].copy_(v)
            sh["out"][1].copy_(i)
    _same_state(_state(shards), _state(want))
    # Every winner's row changed bits (+ask, or -0.0 to +0.0).
    for s, sh in enumerate(shards):
        for b in range(lanes):
            for e in upd[s, b][upd[s, b] >= 0].tolist():
                assert not torch.equal(
                    sh["usage"][b, e >> 1].view(torch.int32),
                    torch.full((6,), -0.0).view(torch.int32))


@pytest.mark.parametrize("devices,want", [
    (["cuda:0"] * 4, [("cuda:0", [0, 1, 2, 3])]),
    (["cuda:0", "cuda:1"] * 2, [("cuda:0", [0, 2]), ("cuda:1", [1, 3])]),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"],
     [("cuda:0", [0]), ("cuda:1", [1]), ("cuda:2", [2]), ("cuda:3", [3])]),
])
def test_device_groups(devices, want):
    """One shard_step launch a card of a mesh row: positions grouped by
    device, in the order each device first appears (no card is
    touched: the devices are objects only)."""
    got = tmesh.device_groups([torch.device(d) for d in devices])
    assert got == [(torch.device(d), cs) for d, cs in want]
    assert got[0][0] == torch.device(devices[0])


def test_device_groups_cut_at_the_launch_cap():
    """A card holding more of a row's shards than one launch takes gets
    a launch per run of at most the cap; contiguous positions copy to
    the lead as one slice."""
    assert tmesh.device_groups(["cpu"] * 8, cap=3) == [
        (torch.device("cpu"), [0, 1, 2]), (torch.device("cpu"), [3, 4, 5]),
        (torch.device("cpu"), [6, 7])]
    assert len(tmesh.device_groups(["cpu"] * 40)) == \
        -(-40 // tbp.STEP_SHARDS)
    assert tmesh._runs([2, 3]) == [(slice(2, 4), slice(None))]
    assert tmesh._runs([1, 3]) == [(1, 0), (3, 1)]


@pytest.mark.parametrize("cap", [1, 3])
def test_a_row_in_several_launches_equals_the_unsharded_kernels(
        monkeypatch, cap):
    """A mesh row whose shards take several shard_step launches (the
    cap forced down) walks as one launch does: each sharded walk equals
    the port's unsharded kernel exactly."""
    monkeypatch.setattr(tmesh, "device_groups",
                        lambda devs, _g=tmesh.device_groups: _g(devs, cap))
    mesh = tmesh.fleet_mesh(CPU8)
    fleet, view, feasible, asks, distinct, group_idx, valid = _problem()
    args = (fleet.capacity, fleet.reserved, view.usage, view.job_counts,
            feasible, asks, distinct, group_idx, valid)
    got = tmesh.place_sequence_sharded(mesh, *args, 10.0)
    want = tbp.place_sequence(*(_t(a) for a in args), 10.0)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    args = _batch_rounds_args(3)
    got = tmesh.place_rounds_batch_sharded(mesh, *args, k_cap=32, rounds=1)
    want = tbp.place_rounds_batch(*(_t(a) for a in args), k_cap=32,
                                  rounds=1)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("walk", ["sequence", "rounds", "sequence_batch",
                                  "rounds_batch"])
def test_walks_on_the_overridden_mesh_equal_jax(walk):
    """Each sharded walk on the mesh ``mesh_override(["cpu"] * 8)``
    resolves (one shard_walk for the row's eight shards) equals the JAX
    package's sharded form on its eight CPU devices and the port's
    unsharded kernel, with -0.0 usage
    entries and the last four sequence steps invalid (their winners
    get ask * 0.0, not ask)."""
    fleet, view, feasible, asks, distinct, group_idx, valid = _problem()
    usage = view.usage.copy()
    usage[:fleet.n_real, 2] = -0.0
    valid = valid.copy()
    valid[-4:] = False
    jax_mesh = jmesh.fleet_mesh(jax.devices("cpu"))
    with tmesh.mesh_override(CPU8):
        mesh = tmesh.dispatch_mesh(1, fleet.n_pad)
    assert mesh.shape == {"fleet": 8}
    if walk == "sequence":
        args = (fleet.capacity, fleet.reserved, usage, view.job_counts,
                feasible, asks, distinct, group_idx, valid)
        _held(tmesh.place_sequence_sharded(mesh, *args, 10.0),
              jmesh.place_sequence_sharded(jax_mesh, *args, 10.0),
              tbp.place_sequence(*(_t(a) for a in args), 10.0))
    elif walk == "rounds":
        counts = np.asarray([24], dtype=np.int32)
        args = (fleet.capacity, fleet.reserved, usage, view.job_counts,
                feasible, asks, distinct, counts)
        kw = dict(k_cap=32, rounds=1)
        _held(tmesh.place_rounds_sharded(mesh, *args, 10.0, **kw),
              jmesh.place_rounds_sharded(jax_mesh, *args, 10.0, **kw),
              tbp.place_rounds(*(_t(a) for a in args), 10.0, **kw))
    elif walk == "sequence_batch":
        lanes = _lanes(3, view.job_counts, feasible, asks, distinct,
                       group_idx, valid)
        args = (fleet.capacity, fleet.reserved, usage, *lanes,
                np.full(3, 10.0, dtype=np.float32))
        _held(tmesh.place_sequence_batch_sharded(mesh, *args),
              jmesh.place_sequence_batch_sharded(jax_mesh, *args),
              tbp.place_sequence_batch(*(_t(a) for a in args)))
    else:
        args = list(_batch_rounds_args(3))
        args[2] = usage
        kw = dict(k_cap=32, rounds=1)
        _held(tmesh.place_rounds_batch_sharded(mesh, *args, **kw),
              jmesh.place_rounds_batch_sharded(jax_mesh, *args, **kw),
              tbp.place_rounds_batch(*(_t(a) for a in args), **kw))


@pytest.mark.parametrize("site", ["scheduler", "storm", "pipeline"])
def test_a_failed_shard_step_raises_from_every_walk_entry(monkeypatch,
                                                          site):
    """No fallback for shard_step: where a mesh resolves on the route of
    shards that span cards, a failed launch surfaces from torch_binpack's
    eval, the fused storm and the pipelined runner (held to the card's
    rule: no host re-run), and neither the unsharded kernels nor the
    host twins run in its place."""
    from nomad_tpu_torch.ops import binpack_host
    from nomad_tpu_torch.scheduler.batch import BatchEvalRunner
    from nomad_tpu_torch.scheduler.executor import executor_override
    from nomad_tpu_torch.scheduler.pipeline import PipelinedEvalRunner

    called = []
    for mod, name in ((tbp, "place_rounds"), (tbp, "place_sequence"),
                      (tbp, "place_rounds_batch"),
                      (tbp, "place_sequence_batch"),
                      (binpack_host, "place_rounds_host"),
                      (binpack_host, "place_sequence_host")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **kw:
                            called.append(_n))
    monkeypatch.setattr(tbp, "shard_step", _raising("shard_step"))
    _across_cards(monkeypatch)
    _jh, th, jobs = _twin_rig(16, 2, 3)
    with tmesh.mesh_override(CPU8), executor_override("device"), \
            pytest.raises(RuntimeError, match="CUDA error"):
        if site == "scheduler":
            th.process("torch-binpack", _port_eval(jobs[0]))
        elif site == "storm":
            BatchEvalRunner(th.state.snapshot(), th, device="cpu").process(
                [_port_eval(j) for j in jobs])
        else:
            runner = PipelinedEvalRunner(th.state.snapshot(), th, depth=2,
                                         device="cpu")
            runner.host_reruns = False
            runner.process([_port_eval(j) for j in jobs])
    assert called == []
    assert th.plans == []


def test_step_plan_table_matches_the_kernels_layout(monkeypatch):
    """The host table a shard_step launch passes: per shard the words of
    csrc/binpack.cu's StepShard in its order (capacity, reserved, usage,
    job counts, feasibility, asks, distinct, penalty, group_idx, the
    candidates' values and indices, the updates, the key regions,
    row_lo), STEP_WORDS of them, and the launch cap the kernel's
    MAX_STEP_SHARDS.  No card is touched: the library is a stand-in."""
    import re

    from nomad_tpu_torch.ops import kernels

    source = (kernels.CSRC / "binpack.cu").read_text()
    words = int(re.search(r"#define STEP_WORDS (\d+)", source).group(1))
    cap = int(re.search(r"#define MAX_STEP_SHARDS (\d+)", source).group(1))
    assert cap == tbp.STEP_SHARDS
    struct = re.search(r"struct StepShard \{(.*?)\};", source, re.S).group(1)
    fields = re.findall(r"(\w+);", struct)
    assert fields == ["cap", "res", "usage", "jc", "feas", "asks",
                      "distinct", "penalty", "group_idx", "out_v", "out_i",
                      "upd", "scratch", "row_lo"]
    assert len(fields) == words

    class Lib:
        nomad_shard_step = object()

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "stream_handle", lambda device: 7)
    shards, _merge = _step_case("sequence", 1, lanes=2)
    plan = tbp.step_plan(shards, 1)
    want = []
    for sh in shards:
        want += [sh[name].data_ptr() for name in (
            "capacity", "reserved", "usage", "job_counts", "feasible",
            "asks", "distinct", "penalty", "group_idx")]
        want += [sh["out"][0].data_ptr(), sh["out"][1].data_ptr(),
                 sh["upd"].data_ptr(), 0, sh["row_lo"]]
    assert list(plan.table) == want
    assert plan.head[2:] == (4, 2, 16, 3, 6)  # shards, lanes, rows, G, P
    assert plan.tail == (1, 1, 0, 7)          # k, kout, path, stream
    with pytest.raises(ValueError, match="1 to 16 shards"):
        tbp.step_plan(shards * 5, 1)


# -- shard_walk: a sharded walk on one card in one launch -------------------


def _walk_case(walk: str):
    """The four walks' inputs as the sharded wrappers take them: the
    equal mock nodes (every score ties, so the winners run over shard
    edges, lowest global index first), -0.0 in a usage column (an
    untaken winner's +0.0 shows in the bits), the last four sequence
    steps invalid, and k_cap = 32, more than a shard's rows at four and
    eight shards."""
    fleet, view, feasible, asks, distinct, group_idx, valid = _problem()
    usage = view.usage.copy()
    usage[:fleet.n_real, 2] = -0.0
    valid = valid.copy()
    valid[-4:] = False
    counts = np.asarray([24], dtype=np.int32)
    base = (fleet.capacity, fleet.reserved, usage)
    if walk == "sequence":
        return base + (view.job_counts, feasible, asks, distinct,
                       group_idx, valid, 10.0), {}
    if walk == "rounds":
        return base + (view.job_counts, feasible, asks, distinct, counts,
                       10.0), dict(k_cap=32, rounds=1)
    pen = np.full(3, 10.0, dtype=np.float32)
    if walk == "sequence_batch":
        return base + tuple(_lanes(3, view.job_counts, feasible, asks,
                                   distinct, group_idx, valid)) + (pen,), {}
    return base + tuple(_lanes(3, view.job_counts, feasible, asks, distinct,
                               counts)) + (pen,), dict(k_cap=32, rounds=1)


@pytest.mark.parametrize("ways", [4, 8])
@pytest.mark.parametrize("walk", ["sequence", "rounds", "sequence_batch",
                                  "rounds_batch"])
def test_shard_walk_plain_equals_jax(monkeypatch, walk, ways):
    """Each walk on ``mesh_override(["cpu"] * ways)`` takes the one-card
    route (one shard_walk a walk, its plain version here) and equals
    the JAX package's sharded form on as many CPU devices, its unsharded
    kernel and the port's unsharded kernel."""
    args, kw = _walk_case(walk)
    with tmesh.mesh_override(["cpu"] * ways):
        mesh = tmesh.dispatch_mesh(1, args[0].shape[0])
    assert mesh.shape == {"fleet": ways}
    jax_mesh = jmesh.fleet_mesh(jax.devices("cpu")[:ways])
    port = getattr(tmesh, f"place_{walk}_sharded")
    calls = []
    real = tbp.shard_walk
    routes = dict(tmesh.WALK_ROUTES)
    monkeypatch.setattr(tbp, "shard_walk", lambda *a, **k: calls.append(1)
                        or real(*a, **k))
    got = port(mesh, *args, **kw)
    assert calls == [1]
    assert tmesh.WALK_ROUTES == dict(
        routes, shard_walk=routes["shard_walk"] + 1)
    want = getattr(tbp, f"place_{walk}")(
        *(a if isinstance(a, float) else _t(a) for a in args), **kw)
    _held(got, getattr(jmesh, f"place_{walk}_sharded")(jax_mesh, *args,
                                                       **kw), want)
    _held(got, getattr(jbp, f"place_{walk}")(*args, **kw))
    if walk == "sequence":
        assert got[0].tolist()[:12] == list(range(12))  # across the edges
        assert (got[0][-4:] == -1).all()


@pytest.mark.parametrize("devices,route,verify", [
    (["cuda:0"] * 4, "shard_walk", ([0, 1, 2, 3], [])),
    (["cuda:0"] * 16, "shard_walk", (list(range(16)), [])),
    (["cpu"] * 8, "shard_walk", (list(range(8)), [])),
    (["cuda:0", "cuda:1"] * 2, "shard_step", ([0, 2], [1, 3])),
    (["cuda:0"] * 2 + ["cuda:1"] * 2, "shard_step", ([0, 1], [2, 3])),
    (["cuda:0"] * 32, "shard_step", (list(range(16)), list(range(16, 32)))),
])
def test_the_route_follows_the_layout(devices, route, verify):
    """One launch group (every shard on one card, at most 16) walks in
    one shard_walk; a row spanning cards, or more than 16 shards, steps
    with shard_step + K7b.  The window verify reads the lead card's
    shards in place (at most 16) and gathers every other with K7d.  No
    card is touched: the devices are objects only."""
    devs = [torch.device(d) for d in devices]
    assert tmesh.walk_route(devs) == route
    assert tmesh.verify_layout(devs) == verify


@pytest.mark.parametrize("cap,route", [(16, "shard_walk"),
                                       (3, "shard_step")])
def test_a_walk_counts_its_route(monkeypatch, cap, route):
    """Each mesh row of a walk is counted on the route its layout gives,
    and the rows of a 2x4 storm mesh run alike: two rows, two shard_walk
    launches (or two stepped rows), equal to the unsharded kernel."""
    monkeypatch.setattr(tmesh, "device_groups",
                        lambda devs, _g=tmesh.device_groups: _g(devs, cap))
    before = dict(tmesh.WALK_ROUTES)
    args = _batch_rounds_args(4)
    got = tmesh.place_rounds_batch_sharded(tmesh.storm_mesh(2, CPU8), *args,
                                           k_cap=32, rounds=1)
    assert tmesh.WALK_ROUTES[route] == before[route] + 2
    assert sum(tmesh.WALK_ROUTES.values()) == sum(before.values()) + 2
    want = tbp.place_rounds_batch(*(_t(a) for a in args), k_cap=32,
                                  rounds=1)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_shard_walk_checks_its_shards():
    """shard_walk raises on what its kernel does not take: more shards
    than a launch, a shard that does not start at s * R, valid and
    counts together."""
    shards, _merge = _step_case("sequence", 1, lanes=2)
    walk = [{k: sh[k] for k in tbp.WALK_FIELDS + ("row_lo",)}
            for sh in shards]
    chosen = torch.empty((2, 6), dtype=torch.int32)
    scores = torch.empty((2, 6))
    valid = torch.ones((2, 6), dtype=torch.bool)
    with pytest.raises(ValueError, match="1 to 16 shards"):
        tbp.shard_walk(walk * 5, chosen, scores, valid=valid)
    with pytest.raises(ValueError, match="starts at row"):
        tbp.shard_walk(walk[1:] + walk[:1], chosen, scores, valid=valid)
    with pytest.raises(ValueError, match="not both"):
        tbp.shard_walk(walk, chosen, scores, valid=valid,
                       counts=torch.ones((2, 3), dtype=torch.int32))
    tbp.shard_walk(walk, chosen, scores, valid=valid)
    assert (chosen[:, 0] >= 0).all()


def test_walk_table_matches_the_kernels_layout():
    """The host table a shard_walk launch passes: per shard the words of
    csrc/binpack.cu's WalkShard in its order (capacity, reserved, usage,
    job counts, feasibility, asks, distinct, penalty, group_idx, the key
    regions, row_lo), WALK_WORDS of them; and the sharded K6's: per
    shard VerifyShard's (capacity, reserved, usage, row_lo), VERIFY_WORDS
    of them, at most MAX_VERIFY_SHARDS.  No card is touched."""
    import re

    from nomad_tpu_torch.ops import kernels

    source = (kernels.CSRC / "binpack.cu").read_text()
    words = int(re.search(r"#define WALK_WORDS (\d+)", source).group(1))
    struct = re.search(r"struct WalkShard \{(.*?)\};", source, re.S).group(1)
    fields = re.findall(r"(\w+);", struct)
    assert fields == ["cap", "res", "usage", "jc", "feas", "asks",
                      "distinct", "penalty", "group_idx", "scratch",
                      "row_lo"]
    assert len(fields) == words == len(tbp.WALK_FIELDS) + 2
    shards, _merge = _step_case("rounds", 4, lanes=2)
    scratch = [None, torch.zeros(8, dtype=torch.int32), None, None]
    table = tbp.walk_table(shards, scratch)
    want = []
    for sh, sc in zip(shards, scratch):
        want += [sh[name].data_ptr() for name in (
            "capacity", "reserved", "usage", "job_counts", "feasible",
            "asks", "distinct", "penalty")]
        want += [0, 0 if sc is None else sc.data_ptr(), sh["row_lo"]]
    assert list(table) == want

    source = (kernels.CSRC / "window_verify.cu").read_text()
    words = int(re.search(r"#define VERIFY_WORDS (\d+)", source).group(1))
    cap = int(re.search(r"#define MAX_VERIFY_SHARDS (\d+)",
                        source).group(1))
    assert cap == tmesh.VERIFY_SHARDS
    struct = re.search(r"struct VerifyShard \{(.*?)\};", source,
                       re.S).group(1)
    fields = re.findall(r"(\w+);", struct)
    assert fields == ["capacity", "reserved", "usage", "row_lo"]
    assert len(fields) == words == len(tmesh.VERIFY_FIELDS) + 1
    vs = [dict(capacity=torch.zeros(8, 6), reserved=torch.zeros(8, 6),
               usage=torch.zeros(8, 6), row_lo=8 * c) for c in range(3)]
    assert list(tmesh.verify_table(vs)) == [
        w for sh in vs for w in (sh["capacity"].data_ptr(),
                                 sh["reserved"].data_ptr(),
                                 sh["usage"].data_ptr(), sh["row_lo"])]


def _signed_zero_window(rng, n=64, b=16):
    """A window on a 64-row fleet whose claimed nodes hold -0.0 in the
    usage, reserved and capacity columns 2-3 (K6 reads -0.0 capacity
    into ``caps`` as is)."""
    cap = np.zeros((n, 6), dtype=np.float32)
    cap[:50, :2] = (4000, 8192)
    cap[:, 2:4] = -0.0
    res = np.full((n, 6), -0.0, dtype=np.float32)
    res[:50, :2] = (100, 256)
    usage = np.full((n, 6), -0.0, dtype=np.float32)
    usage[:50, 0] = rng.integers(0, 3000, 50)
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
    return cap, res, usage, desc


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(
        np.int32)


@pytest.mark.parametrize("layout", ["one card", "across cards"])
def test_sharded_window_verify_reads_the_owners_bits(monkeypatch, layout):
    """K6's sharded form (its plain version: each pair's rows read from
    the shard that owns it, in place or, across cards, from that
    shard's K7d partial) equals K6 and the JAX package's
    _window_verify_jit bit for bit, with -0.0 in the claimed nodes'
    usage, reserved and capacity columns; a sum of every shard's
    partial from +0.0 would turn the -0.0 capacity into +0.0."""
    if layout == "across cards":
        monkeypatch.setattr(tmesh, "VERIFY_SHARDS", 3)
    gathered = []
    real = tmesh.shard_gather
    monkeypatch.setattr(tmesh, "shard_gather", lambda *a, **kw:
                        gathered.append(1) or real(*a, **kw))
    cap, res, usage, desc = _signed_zero_window(np.random.default_rng(3))
    got = tmesh.window_verify_sharded(tmesh.fleet_mesh(CPU8), cap, res,
                                      usage, **desc)
    assert len(gathered) == (0 if layout == "one card" else 5)
    want = tmesh.window_verify(_t(cap), _t(res), _t(usage), **desc)
    names = ("pair_ni", "row_pair", "row_vec", "seq_ni", "seq_vec",
             "seq_order", "seq_comp", "pair_order", "pair_comp",
             "pair_removed")
    jax_out = jmesh._window_verify_jit(cap, res, usage,
                                       *(desc[k] for k in names))
    for x, y, z in zip(got[:2], want[:2], jax_out[:2]):
        np.testing.assert_array_equal(_bits(x), _bits(y))
        np.testing.assert_array_equal(_bits(x), _bits(z))
    assert torch.equal(got[2], want[2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jax_out[2]))
    assert (_bits(got[1])[:, 2:] == _bits(np.float32(-0.0))).all()
    partials = torch.stack([tmesh.shard_gather_plain(
        _t(cap[c * 8:(c + 1) * 8]), _t(res[c * 8:(c + 1) * 8]),
        _t(usage[c * 8:(c + 1) * 8]), c * 8, _t(desc["pair_ni"]))
        for c in range(8)])
    summed = torch.zeros(16, 12) + partials.sum(0)
    assert not np.array_equal(_bits(summed[:, 8:12]), _bits(got[1]))
