"""K5 and the usage mirror of the port (nomad_tpu_torch/models/fleet.py)
against the JAX package (nomad_tpu/models/fleet.py) on the same inputs.

The port's scatter wrapper runs its plain version here (CPU tensors);
chip_smoke.py holds the CUDA kernel against that plain version on the
card.  Scatter results are exact copies of the given rows, so they are
compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nomad_tpu.mock as mock
from nomad_tpu.models import fleet as jfleet
from nomad_tpu.state import StateStore as JStore
from nomad_tpu.structs import ALLOC_DESIRED_STATUS_STOP, Resources
from nomad_tpu_torch import convert
from nomad_tpu_torch.models import fleet as tfleet
from nomad_tpu_torch.state import StateStore as TStore

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("n_rows", [1, 5, 8])
def test_scatter_rows_plain_matches_jax(n_rows):
    """The plain version against _scatter_jit_impl, with the padded
    duplicates _scatter_rows adds (5 rows pad to 8 by repeating idx[0]);
    the old tensor stays unchanged."""
    rng = np.random.default_rng(n_rows)
    usage = rng.random((32, 6)).astype(np.float32)
    idx = rng.choice(32, n_rows, replace=False).astype(np.int32)
    rows = rng.random((n_rows, 6)).astype(np.float32)
    padded = 1 << int(n_rows - 1).bit_length()
    p_idx = np.concatenate([idx, np.repeat(idx[:1], padded - n_rows)])
    p_rows = np.concatenate([rows, np.repeat(rows[:1], padded - n_rows,
                                             axis=0)])
    want = np.asarray(jfleet._ensure_scatter_jit()(
        jnp.asarray(usage), jnp.asarray(p_idx), jnp.asarray(p_rows)))

    old = torch.from_numpy(usage.copy())
    got = tfleet.scatter_rows(old, torch.from_numpy(p_idx),
                              torch.from_numpy(p_rows))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(old.numpy(), usage)

    via_pad = tfleet._scatter_rows(old, idx, rows)
    assert np.array_equal(via_pad.numpy(), want)
    assert np.array_equal(old.numpy(), usage)


@pytest.mark.parametrize("n_rows", [1, 5])
def test_scatter_rows_keeps_signed_zeros_like_jax(n_rows):
    """-0.0 in the old rows and in the new ones comes out as in
    _scatter_jit_impl, bit for bit (int32 views)."""
    rng = np.random.default_rng(10 + n_rows)
    usage = rng.random((32, 6)).astype(np.float32)
    usage[rng.random((32, 6)) > 0.5] = np.float32(-0.0)
    idx = rng.choice(32, n_rows, replace=False).astype(np.int32)
    rows = rng.random((n_rows, 6)).astype(np.float32)
    rows[:, ::2] = np.float32(-0.0)
    padded = 1 << int(n_rows - 1).bit_length()
    p_idx = np.concatenate([idx, np.repeat(idx[:1], padded - n_rows)])
    p_rows = np.concatenate([rows, np.repeat(rows[:1], padded - n_rows,
                                             axis=0)])
    want = np.asarray(jfleet._ensure_scatter_jit()(
        jnp.asarray(usage), jnp.asarray(p_idx), jnp.asarray(p_rows)))
    got = tfleet._scatter_rows(torch.from_numpy(usage.copy()), idx, rows)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_scatter_rows_rejects_out_of_range_rows():
    old = torch.zeros((8, 6))
    with pytest.raises(IndexError):
        tfleet._scatter_rows(old, np.array([8], dtype=np.int32),
                             np.ones((1, 6), dtype=np.float32))


def _alloc_on(node, job, cpu, mem):
    a = mock.alloc()
    a.node_id = node.id
    a.job = job
    a.job_id = job.id
    a.resources = Resources(cpu=cpu, memory_mb=mem)
    return a


def test_usage_mirror_matches_jax_after_each_sync():
    """One sequence of alloc upserts (new allocs, more allocs, stops,
    moves) into both packages' stores; after every sync the mirrors
    agree on usage and per-job counts, and the port's device copy —
    scatter-maintained since its first upload — equals its host usage."""
    rng = np.random.default_rng(3)
    nodes = [mock.node(i) for i in range(20)]
    jobs = [mock.job() for _ in range(3)]
    js, ts = JStore(), TStore()
    for i, (jn, tn) in enumerate(zip(nodes,
                                     convert.nodes_from_reference(nodes))):
        js.upsert_node(1 + i, jn)
        ts.upsert_node(1 + i, tn)
    jm = jfleet.UsageMirror(jfleet.build_fleet(list(js.nodes())))
    tm = tfleet.UsageMirror(tfleet.build_fleet(list(ts.nodes())))
    assert jm.statics.node_ids == tm.statics.node_ids

    live: list = []
    index = 100

    def commit(allocs):
        nonlocal index
        index += 1
        js.upsert_allocs(index, allocs)
        ts.upsert_allocs(index, convert.allocs_from_reference(allocs))

    def check():
        assert jm.sync(js.snapshot())
        assert tm.sync(ts.snapshot())
        np.testing.assert_array_equal(tm.usage, jm.usage)
        assert tm.job_counts == jm.job_counts
        dev = tm.device_usage(CPU)
        np.testing.assert_array_equal(dev.numpy(), tm.usage)
        np.testing.assert_array_equal(
            np.asarray(jm.device_usage()), jm.usage)

    check()  # empty fleet; uploads both device copies
    for _step in range(3):
        new = [_alloc_on(nodes[int(rng.integers(20))],
                         jobs[int(rng.integers(3))],
                         int(rng.integers(100, 900)),
                         int(rng.integers(64, 1024))) for _ in range(6)]
        commit(new)
        live.extend(new)
        check()
    stopped = []
    for a in live[:4]:
        b = a.copy()
        b.desired_status = ALLOC_DESIRED_STATUS_STOP
        stopped.append(b)
    commit(stopped)
    check()
    moved = []
    for a in live[4:7]:
        b = a.copy()
        b.node_id = nodes[(nodes.index(
            next(n for n in nodes if n.id == a.node_id)) + 1) % 20].id
        moved.append(b)
    commit(moved)
    check()
    assert tm.rebuilds == jm.rebuilds == 1


def test_mirror_view_deltas_match_jax():
    """view_at with in-flight plan deltas equals the JAX view."""
    from nomad_tpu.structs import Plan as JPlan
    from nomad_tpu_torch.structs import Plan as TPlan

    nodes = [mock.node(i) for i in range(10)]
    job = mock.job()
    js, ts = JStore(), TStore()
    for i, (jn, tn) in enumerate(zip(nodes,
                                     convert.nodes_from_reference(nodes))):
        js.upsert_node(1 + i, jn)
        ts.upsert_node(1 + i, tn)
    base = [_alloc_on(nodes[i], job, 200 + i, 100) for i in range(4)]
    js.upsert_allocs(50, base)
    ts.upsert_allocs(50, convert.allocs_from_reference(base))
    jplan, tplan = JPlan(), TPlan()
    extra = _alloc_on(nodes[7], job, 300, 300)
    jplan.append_alloc(extra)
    tplan.append_alloc(convert.allocs_from_reference([extra])[0])
    jm = jfleet.UsageMirror(jfleet.build_fleet(list(js.nodes())))
    tm = tfleet.UsageMirror(tfleet.build_fleet(list(ts.nodes())))
    for jp, tp in ((None, None), (jplan, tplan)):
        jv = jm.view_at(js.snapshot(), jp, job.id)
        tv = tm.view_at(ts.snapshot(), tp, job.id, CPU)
        np.testing.assert_array_equal(tv.usage, jv.usage)
        np.testing.assert_array_equal(tv.job_counts, jv.job_counts)
        assert (tv.usage_device is None) == (jv.usage_device is None)
