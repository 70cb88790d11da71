"""Mesh-resident fleet tensors of the port (models/fleet.py
ShardedResidency, the statics' sharded capacity/reserved and
feasibility, the usage mirror's sharded twin) against the JAX package's:
a twin of every test in tests/test_mesh_resident.py, and the cases only
the port has.

A sharded dispatch must not re-upload capacity/reserved/usage per call:
the statics cache their (mesh, capacity, reserved) twins, the
UsageMirror keeps a node-axis-sharded twin of its usage maintained by
the same scatters (K5, on each shard that owns a touched row) as the
single-device copy, and ``mesh._put`` skips placement for an operand
already resident with its layout.  The port's meshes are eight ``cpu``
entries; the JAX package's the eight CPU devices tests/conftest.py
forces.  Twins hold the same host values exactly (usage is small
integers in fp32).
"""
from __future__ import annotations

import jax
import numpy as np
import torch

import nomad_tpu.mock as jmock
from nomad_tpu.models import fleet as jfleet
from nomad_tpu.parallel import mesh as jmesh
from nomad_tpu.state.store import StateStore as JStore
from nomad_tpu_torch import convert
from nomad_tpu_torch.models import fleet as tfleet
from nomad_tpu_torch.parallel import mesh as tmesh
from nomad_tpu_torch.parallel.devices import transfer_counts
from nomad_tpu_torch.state import StateStore as TStore
from tests.test_plan_verify_vec import bump, make_alloc

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _rig(n_nodes=16):
    """Twin stores holding the same mock nodes (indexes 10..)."""
    nodes = [jmock.node(i) for i in range(n_nodes)]
    js, ts = JStore(), TStore()
    idx = 10
    for jn, tn in zip(nodes, convert.nodes_from_reference(nodes)):
        js.upsert_node(idx, jn.copy())
        ts.upsert_node(idx, tn)
        idx += 1
    return js, ts, nodes, [idx]


def _commit(js, ts, cell, allocs):
    index = bump(cell)
    js.upsert_allocs(index, [a.copy() for a in allocs])
    ts.upsert_allocs(index, convert.allocs_from_reference(allocs))


def _host(buf) -> np.ndarray:
    return tmesh.gather(buf).numpy()


def test_statics_sharded_capres_cached():
    js, ts, _nodes, _cell = _rig()
    statics = tfleet.fleet_cache.statics_for(ts)
    mesh = tmesh.fleet_mesh(CPU8)
    cap1, res1 = statics.device_capacity_reserved_sharded(mesh)
    cap2, res2 = statics.device_capacity_reserved_sharded(mesh)
    assert cap1 is cap2 and res1 is res2  # resident, no re-upload
    assert cap1.mesh == mesh and cap1.spec == tmesh.NODE
    assert len(cap1) == 8 and cap1[0].shape == (statics.n_pad // 8, 6)
    np.testing.assert_array_equal(_host(cap1), statics.capacity)
    jstatics = jfleet.fleet_cache.statics_for(js)
    jcap, _jres = jstatics.device_capacity_reserved_sharded(
        jmesh.fleet_mesh(jax.devices("cpu")[:8]))
    np.testing.assert_array_equal(_host(cap1), np.asarray(jcap))
    # A different mesh re-uploads.
    cap3, _ = statics.device_capacity_reserved_sharded(
        tmesh.fleet_mesh(["cpu"] * 4))
    assert cap3 is not cap1


def test_put_skips_resident_arrays():
    mesh = tmesh.fleet_mesh(CPU8)
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    a = tmesh._put(x, mesh, tmesh.NODE)
    assert tmesh._put(a, mesh, tmesh.NODE) is a  # no-op when resident
    jsh = jax.sharding.NamedSharding(
        jmesh.fleet_mesh(jax.devices("cpu")[:8]),
        jax.sharding.PartitionSpec(jmesh.FLEET_AXIS))
    ja = jmesh._put(x, jsh)
    assert jmesh._put(ja, jsh) is ja
    np.testing.assert_array_equal(_host(a), np.asarray(ja))


def test_mirror_sharded_usage_scatter_maintained():
    js, ts, nodes, cell = _rig()
    statics = tfleet.fleet_cache.statics_for(ts)
    mirror = tfleet.mirror_for(statics)
    mirror.sync(ts)
    jmirror = jfleet.mirror_for(jfleet.fleet_cache.statics_for(js))
    jmirror.sync(js)
    mesh = tmesh.fleet_mesh(CPU8)
    jm = jmesh.fleet_mesh(jax.devices("cpu")[:8])

    us1 = mirror.device_usage_sharded(mesh, mirror.usage)
    assert us1 is not None
    assert us1.mesh == mesh and us1.spec == tmesh.NODE
    np.testing.assert_array_equal(_host(us1), mirror.usage)
    # Same view, same mesh: resident identity.
    assert mirror.device_usage_sharded(mesh, mirror.usage) is us1

    # Commit deltas: the per-shard scatters track the host mirror (and
    # the JAX twin) and keep the layout; only the shards that own a
    # touched row get a new tensor.
    _commit(js, ts, cell, [make_alloc(nodes[3], cpu=700),
                           make_alloc(nodes[5], cpu=900)])
    mirror.sync(ts)
    jmirror.sync(js)
    us2 = mirror.device_usage_sharded(mesh, mirror.usage)
    assert us2 is not None and us2 is not us1
    assert us2.mesh == mesh and us2.spec == tmesh.NODE
    np.testing.assert_array_equal(_host(us2), mirror.usage)
    np.testing.assert_array_equal(
        _host(us2), np.asarray(jmirror.device_usage_sharded(
            jm, jmirror.usage)))
    rows = statics.n_pad // 8
    owners = {statics.index_of[n.id] // rows for n in (nodes[3], nodes[5])}
    for c in range(8):
        assert (us2[c] is us1[c]) == (c not in owners)

    # A stale view (the mirror has moved past it) gets None, never a
    # silently-wrong resident buffer.
    stale = mirror.usage
    _commit(js, ts, cell, [make_alloc(nodes[0], cpu=100)])
    mirror.sync(ts)
    assert mirror.device_usage_sharded(mesh, stale) is None
    fresh = mirror.device_usage_sharded(mesh, mirror.usage)
    np.testing.assert_array_equal(_host(fresh), mirror.usage)
    assert mirror.window_lease(mesh) is fresh


def test_sharded_residency_is_one_policy():
    """ONE bounded residency for every node-axis-sharded cache: keyed
    entries, class-scoped evict-all-at-the-bound, per-entry scatter
    counters."""
    mesh = tmesh.fleet_mesh(CPU8)
    res = tfleet.ShardedResidency(max_resident=2)
    a = np.arange(32, dtype=np.float32).reshape(16, 2)
    (buf,) = res.install(("usage", mesh), mesh, (a,))
    assert res.lookup(("usage", mesh))[0] is buf
    assert buf.spec == tmesh.NODE
    assert res.scatters(("usage", mesh)) == 0
    res.replace(("usage", mesh), (buf,))
    assert res.scatters(("usage", mesh)) == 1
    # [G, N] rows shard on the node axis with the group axis whole.
    g = np.zeros((4, 16), dtype=bool)
    (gbuf,) = res.install(("feas", "k1", mesh), mesh, (g,),
                          spec=tmesh.GROUP_NODE)
    assert gbuf.spec == tmesh.GROUP_NODE and gbuf[0].shape == (4, 2)
    # The bound is per CLASS (key[0]).
    res.install(("feas", "k2", mesh), mesh, (g,), spec=tmesh.GROUP_NODE)
    res.install(("feas", "k3", mesh), mesh, (g,), spec=tmesh.GROUP_NODE)
    assert res.lookup(("feas", "k1", mesh)) is None
    assert res.lookup(("feas", "k2", mesh)) is None
    assert res.lookup(("feas", "k3", mesh)) is not None
    assert res.lookup(("usage", mesh)) is not None  # survived the churn
    # The same policy in the JAX package.
    jm = jmesh.fleet_mesh(jax.devices("cpu")[:8])
    jres = jfleet.ShardedResidency(max_resident=2)
    for k in ("k1", "k2", "k3"):
        jres.install(("feas", k, jm), jm, (g,),
                     spec=jax.sharding.PartitionSpec(None, jmesh.FLEET_AXIS))
    assert [k[:2] for k in jres.keys()] == [k[:2] for k in res.keys()
                                            if k[0] == "feas"]


def test_statics_sharded_feasibility_resident():
    """The per-job feasibility rows get mesh-resident twins keyed by the
    prep cache's feas_key, uploaded once (one counted transfer) and
    reused per dispatch."""
    _js, ts, _nodes, _cell = _rig()
    statics = tfleet.fleet_cache.statics_for(ts)
    mesh = tmesh.fleet_mesh(CPU8)
    host = np.zeros((8, statics.n_pad), dtype=bool)
    host[0, :statics.n_real] = True
    before = transfer_counts()["h2d"]
    f1 = statics.device_feasible_sharded(mesh, ("feas", "k1", 8), host)
    f2 = statics.device_feasible_sharded(mesh, ("feas", "k1", 8), host)
    assert transfer_counts()["h2d"] == before + 1
    assert f1 is f2
    assert f1.spec == tmesh.GROUP_NODE
    np.testing.assert_array_equal(_host(f1), host)
    statics.device_capacity_reserved_sharded(mesh)
    assert ("capres", mesh) in statics.sharded.keys()


def test_sharded_dispatch_uses_resident_primaries():
    """A forced-device single-eval dispatch on a mesh of eight entries
    runs node-axis-sharded and reuses the resident twins: the statics'
    capres/feas entries and the mirror's usage twin are the same across
    two dispatches of one job, whose placements equal each other and
    the JAX package's sharded dispatch."""
    from nomad_tpu.scheduler import Harness as JHarness
    from nomad_tpu.scheduler.executor import \
        executor_override as j_executor_override
    from nomad_tpu.scheduler.jax_binpack import JaxBinPackScheduler
    from nomad_tpu.structs import (EVAL_TRIGGER_JOB_REGISTER,
                                   Evaluation as JEvaluation,
                                   generate_uuid)
    from nomad_tpu_torch.scheduler import Harness, TorchBinPackScheduler
    from nomad_tpu_torch.scheduler.executor import executor_override
    from nomad_tpu_torch.structs import Evaluation

    nodes = [jmock.node(i) for i in range(16)]
    job = jmock.job()
    jh, th = JHarness(), Harness(device="cpu")
    for jn, tn in zip(nodes, convert.nodes_from_reference(nodes)):
        jh.state.upsert_node(jh.next_index(), jn)
        th.state.upsert_node(th.next_index(), tn)
    jh.state.upsert_job(jh.next_index(), job)
    (tjob,) = convert.jobs_from_reference([job])
    th.state.upsert_job(th.next_index(), tjob)

    def one_dispatch(h, cls, ev_cls, override, **kw):
        sched = cls(h.state.snapshot(), h, batch=False, **kw)
        sched.eval = ev_cls(
            id=generate_uuid(), priority=job.priority, type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER, job_id=job.id)
        sched.defer_device = True
        sched._begin()
        _place, args = sched.deferred
        with override:
            handles = sched.dispatch_device(args)
        chosen, _scores = sched.collect_device(args, handles)
        assert sched.dispatched_sharded
        return args.statics, chosen

    with tmesh.mesh_override(CPU8):
        statics1, chosen1 = one_dispatch(th, TorchBinPackScheduler,
                                         Evaluation,
                                         executor_override("device"),
                                         device="cpu")
        keys1 = set(statics1.sharded.keys())
        assert any(k[0] == "capres" for k in keys1)
        assert any(k[0] == "feas" for k in keys1)
        usage1 = statics1.mirror.window_lease(
            tmesh.dispatch_mesh(1, statics1.n_pad, device="cpu"))
        assert usage1 is not None
        statics2, chosen2 = one_dispatch(th, TorchBinPackScheduler,
                                         Evaluation,
                                         executor_override("device"),
                                         device="cpu")
    assert statics2 is statics1  # same fleet generation
    assert set(statics2.sharded.keys()) == keys1  # resident, no churn
    assert np.array_equal(chosen1, chosen2)
    _jstatics, jchosen = one_dispatch(jh, JaxBinPackScheduler, JEvaluation,
                                      j_executor_override("device"))
    assert np.array_equal(chosen1, jchosen)


def test_forget_drops_the_sharded_residency():
    """FleetCache.forget drops a generation's statics and with them
    every mesh-resident twin (capacity/reserved, feasibility, the
    mirror's usage), so a reaped server's shards stop holding memory."""
    _js, ts, _nodes, _cell = _rig()
    statics = tfleet.fleet_cache.statics_for(ts)
    mirror = tfleet.mirror_for(statics)
    mirror.sync(ts)
    mesh = tmesh.fleet_mesh(CPU8)
    statics.device_capacity_reserved_sharded(mesh)
    host = np.zeros((8, statics.n_pad), dtype=bool)
    statics.device_feasible_sharded(mesh, ("feas", "k", 8), host)
    assert mirror.device_usage_sharded(mesh, mirror.usage) is not None
    assert len(statics.sharded.keys()) == 2
    tfleet.fleet_cache.forget(ts)
    assert statics.sharded.keys() == []
    assert mirror.window_lease(mesh) is None
    assert tfleet.fleet_cache.statics_for(ts) is not statics
