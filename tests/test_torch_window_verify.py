"""K6, the window-verify kernel (nomad_tpu_torch/parallel/mesh.py), against
the JAX package's ``_window_verify_jit``.

The same seeded numpy descriptors go through the JAX function, called
directly on the CPU, and through the port's plain version (the wrapper
routes CPU tensors to it).  Values are small integers in fp32, so both
sums are exact and the results must be equal bit for bit.  Only three
buckets are used: the recompile sentinel budgets 24 traces per kernel.
"""
import re

import numpy as np
import pytest
import torch

from nomad_tpu.parallel.mesh import _window_verify_jit
from nomad_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

N = 256  # fleet rows (a power of two, like fleet._pad_to)


def fleet(rng):
    cap = np.zeros((N, 6), dtype=np.float32)
    cap[:, 0] = rng.integers(2000, 6000, N)
    cap[:, 1] = rng.integers(2048, 8192, N)
    cap[:, 2] = 102400
    cap[:, 3] = 150
    cap[:, 4] = 1000
    cap[:, 5] = 40000
    res = np.zeros((N, 6), dtype=np.float32)
    res[:, :4] = (100, 256, 4096, 0)
    usage = np.zeros((N, 6), dtype=np.float32)
    usage[:, 0] = rng.integers(0, 2500, N)
    usage[:, 1] = rng.integers(0, 3000, N)
    usage[:, 3] = rng.integers(0, 100, N)
    return cap, res, usage


def descriptors(rng, b):
    """One window's padded descriptors: repeated nodes, several
    components, equal plan orders, removals (negative fold entries and
    pair_removed), and padding in every array."""
    n_pairs = max(1, b * 3 // 4)
    n_rows = max(1, b - b // 8)
    n_seq = max(1, b * 5 // 8)
    hot = rng.choice(N, max(2, b // 4), replace=False)  # repeated nodes
    n_plans = max(2, n_pairs // 3)

    def pad(vals, fill, shape=None):
        arr = np.full(shape or b, fill, dtype=np.asarray(vals).dtype)
        arr[:len(vals)] = vals
        return arr

    pair_ni = rng.choice(hot, n_pairs).astype(np.int32)
    pair_order = np.sort(rng.integers(0, n_plans, n_pairs)).astype(np.int32)
    pair_comp = (pair_order % 3).astype(np.int32)
    row_pair = np.concatenate([np.arange(n_pairs),
                               rng.integers(0, n_pairs,
                                            max(0, n_rows - n_pairs))])
    row_pair = row_pair[:n_rows].astype(np.int32)
    row_vec = np.zeros((n_rows, 4), dtype=np.float32)
    row_vec[:, 0] = rng.integers(0, 1500, n_rows)
    row_vec[:, 1] = rng.integers(0, 1024, n_rows)
    row_vec[:, 3] = rng.integers(0, 20, n_rows)
    # Fold entries: mostly on the hot nodes, some elsewhere; a third are
    # removals (negative deltas).
    seq_ni = np.where(rng.random(n_seq) < 0.8, rng.choice(hot, n_seq),
                      rng.integers(0, N, n_seq)).astype(np.int32)
    seq_order = rng.integers(0, n_plans, n_seq).astype(np.int32)
    seq_comp = (seq_order % 3).astype(np.int32)
    seq_comp[rng.random(n_seq) < 0.1] = 3  # a component no pair is in
    seq_vec = np.zeros((n_seq, 4), dtype=np.float32)
    seq_vec[:, 0] = rng.integers(0, 1200, n_seq)
    seq_vec[:, 1] = rng.integers(0, 800, n_seq)
    seq_vec[:, 3] = rng.integers(0, 10, n_seq)
    seq_vec[rng.random(n_seq) < 0.33] *= -1
    pair_removed = np.zeros((n_pairs, 4), dtype=np.float32)
    some = rng.random(n_pairs) < 0.3
    pair_removed[some, 0] = rng.integers(0, 1000, int(some.sum()))
    pair_removed[some, 1] = rng.integers(0, 500, int(some.sum()))
    return dict(
        pair_ni=pad(pair_ni, 0), row_pair=pad(row_pair, 0),
        row_vec=pad(row_vec, 0, (b, 4)), seq_ni=pad(seq_ni, -1),
        seq_vec=pad(seq_vec, 0, (b, 4)), seq_order=pad(seq_order, 0),
        seq_comp=pad(seq_comp, -1), pair_order=pad(pair_order, 0),
        pair_comp=pad(pair_comp, 0),
        pair_removed=pad(pair_removed, 0, (b, 4))), n_pairs


ORDER = ("pair_ni", "row_pair", "row_vec", "seq_ni", "seq_vec",
         "seq_order", "seq_comp", "pair_order", "pair_comp", "pair_removed")


@pytest.mark.parametrize("bucket", [8, 64, 512])
def test_plain_k6_equals_jax_window_verify(bucket):
    rng = np.random.default_rng(6000 + bucket)
    cap, res, usage = fleet(rng)
    desc, n_pairs = descriptors(rng, bucket)
    want = _window_verify_jit(cap, res, usage, *(desc[k] for k in ORDER))
    want = [np.asarray(x) for x in want]
    got = tmesh.window_verify(torch.from_numpy(cap), torch.from_numpy(res),
                              torch.from_numpy(usage), **desc)
    got = [x.numpy() for x in got]
    for name, g, w in zip(("used", "caps", "fits"), got, want):
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name
    fits = got[2][:n_pairs]
    assert fits.any() and not fits.all(), "the case was meant to be mixed"
    # The wrapper and the plain version agree, and the CPU route
    # launched nothing.
    plain = tmesh.window_verify_plain(
        torch.from_numpy(cap), torch.from_numpy(res),
        torch.from_numpy(usage),
        **{k: torch.from_numpy(v) for k, v in desc.items()})
    assert all(torch.equal(torch.from_numpy(g), p)
               for g, p in zip(got, plain))
    assert tmesh.window_verify.launches == 0


def test_fold_counts_only_earlier_same_component_entries_on_the_node():
    """A hand-built window: pair 0 (plan 1, component 0, node 5) sees
    only the entry of plan 0 in component 0 on node 5 — not the equal-
    order entry, not the other component's, not another node's, not
    a padded one; its own removals come off."""
    cap = np.zeros((16, 6), dtype=np.float32)
    cap[:, :4] = (1000, 1000, 1000, 1000)
    res = np.zeros((16, 6), dtype=np.float32)
    usage = np.zeros((16, 6), dtype=np.float32)
    usage[5, 0] = 100
    b = 8
    z = np.zeros(b, dtype=np.int32)
    desc = dict(
        pair_ni=z.copy(), row_pair=z.copy(),
        row_vec=np.zeros((b, 4), np.float32),
        seq_ni=np.full(b, -1, np.int32),
        seq_vec=np.zeros((b, 4), np.float32), seq_order=z.copy(),
        seq_comp=np.full(b, -1, np.int32), pair_order=z.copy(),
        pair_comp=z.copy(), pair_removed=np.zeros((b, 4), np.float32))
    desc["pair_ni"][0] = 5
    desc["pair_order"][0] = 1
    desc["row_vec"][0] = (300, 0, 0, 0)
    for s, (ni, order, comp, cpu) in enumerate(
            [(5, 0, 0, 400), (5, 1, 0, 5000), (5, 0, 1, 5000),
             (6, 0, 0, 5000)]):
        desc["seq_ni"][s] = ni
        desc["seq_order"][s] = order
        desc["seq_comp"][s] = comp
        desc["seq_vec"][s, 0] = cpu
    t = torch.from_numpy
    used, caps, fits = tmesh.window_verify(t(cap), t(res), t(usage), **desc)
    assert used[0].tolist() == [400.0, 0.0, 0.0, 0.0]
    assert caps[0].tolist() == [1000.0] * 4
    assert bool(fits[0])  # 400 + 400 <= 1000
    desc["seq_vec"][0, 0] = 700
    _u, _c, fits = tmesh.window_verify(t(cap), t(res), t(usage), **desc)
    assert not bool(fits[0])  # 400 + 700 > 1000
    desc["pair_removed"][0, 0] = 200
    _u, _c, fits = tmesh.window_verify(t(cap), t(res), t(usage), **desc)
    assert bool(fits[0])  # 400 + 700 - 200 <= 1000


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(7)
    cap, res, usage = fleet(rng)
    desc, _ = descriptors(rng, 8)
    t = torch.from_numpy
    with pytest.raises(TypeError):
        tmesh.window_verify(t(cap).double(), t(res), t(usage), **desc)
    with pytest.raises(ValueError):
        tmesh.window_verify(t(cap)[:, :3].contiguous(), t(res), t(usage),
                            **desc)
    with pytest.raises(TypeError):
        tmesh.window_verify(t(cap), t(res), t(usage),
                            **dict(desc, seq_vec=desc["seq_vec"].astype(
                                np.float64)))
    with pytest.raises(ValueError):
        tmesh.window_verify(t(cap), t(res), t(usage),
                            **dict(desc, row_vec=desc["row_vec"][:, :3]))
    short = {k: v[:6] for k, v in desc.items()}  # not a power of two
    with pytest.raises(ValueError):
        tmesh.window_verify(t(cap), t(res), t(usage), **short)
    bad = dict(desc, pair_ni=desc["pair_ni"].copy())
    bad["pair_ni"][3] = N  # pair_ni >= N
    with pytest.raises(IndexError):
        tmesh.window_verify(t(cap), t(res), t(usage), **bad)
    bad = dict(desc, seq_ni=desc["seq_ni"].copy())
    bad["seq_ni"][0] = -2
    with pytest.raises(IndexError):
        tmesh.window_verify(t(cap), t(res), t(usage), **bad)
    with pytest.raises(ValueError):
        tmesh.window_verify(t(cap), t(res), t(usage).t().contiguous().t(),
                            **desc)


def test_packed_buffer_layout_matches_the_kernel_offsets():
    """The wrapper packs the descriptors in DESCRIPTORS order; the
    kernel finds each array at ``desc + k * b``.  The two must agree
    (the kernel is not run here, so the source is read)."""
    with open(tmesh.__file__.replace("parallel/mesh.py",
                                     "csrc/window_verify.cu")) as fh:
        src = fh.read()
    offsets = {}
    for name, plus, k in re.findall(
            r"const \w+\* (\w+) =\s*(?:reinterpret_cast<const "
            r"float4\*>\()?desc( \+ (?:(\d+) \* )?b)?", src):
        offsets[name] = int(k) if k else (1 if plus else 0)
    at = 0
    for name, _dtype, width in tmesh.DESCRIPTORS:
        assert offsets[name] == at, name
        at += width or 1
    assert at == 19
    b = 8
    rng = np.random.default_rng(3)
    _cap, _res, _usage = fleet(rng)
    desc, _ = descriptors(rng, b)
    packed = tmesh.pack_descriptors(desc, b)
    assert packed.dtype == np.int32 and packed.shape == (19 * b,)
    at = 0
    for name, dtype, width in tmesh.DESCRIPTORS:
        size = b * (width or 1)
        got = packed[at:at + size].view(dtype).reshape(desc[name].shape)
        assert np.array_equal(got, desc[name]), name
        at += size
