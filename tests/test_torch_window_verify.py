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


# -- K6's walk on the card (csrc/window_verify.cu), modelled in numpy --------
#
# The kernel relies on the order the engine builds a window in: pairs,
# placement rows and fold entries plan by plan.  Each block of pairs puts
# its pairs' (node, component) keys in a table, streams the fold entries
# once up to its largest pair order, adds each entry whose key it holds
# into ONE bin (the first of that key's pairs with a later order), sums
# each key's bins in pair order, and takes its pairs' placement rows as
# one run of row_pair found by search.  The model runs the same walk and
# is held to the JAX function on windows built in that order.

KERNEL_BLOCK = 128  # kPairs in csrc/window_verify.cu
# A small window (kUnroll * kNarrow entries, kNarrow rows at most): one
# pass of a narrow block covers it, so the kernel searches nothing.
SMALL_WINDOW = (4 * 128, 128)
# The model's paths forced, whatever the window's size: unsearched, and
# searched.
EVERY_WINDOW, NO_WINDOW = (1 << 30, 1 << 30), (0, 0)


def ordered_window(rng, b, n_plans, per_plan, n_comps, nodes, removals,
                   stray_nodes=None):
    """A window in the engine's order (ops/plan_conflict.py
    _window_device_args): plan i in component i % n_comps claims
    ``per_plan`` draws from ``nodes`` (shared by all components, so one
    node can carry pairs of two components); a pair evicts an alloc on
    its node with chance ``removals`` and, given ``stray_nodes``, one on
    a node no pair claims with chance 1/4.  Padded to bucket ``b``."""
    pair_ni, pair_order, pair_comp, pair_removed = [], [], [], []
    row_pair, row_vec = [], []
    seq = []  # (node, order, comp, vec)
    for i in range(n_plans):
        c = i % n_comps
        picks = rng.choice(nodes, per_plan).tolist()
        for ni in dict.fromkeys(picks):
            p = len(pair_ni)
            pair_ni.append(ni)
            pair_order.append(i)
            pair_comp.append(c)
            removed = [0.0] * 4
            if stray_nodes is not None and rng.random() < 0.25:
                v = [float(rng.integers(50, 700)), 0.0, 0.0, 0.0]
                seq.append((int(rng.choice(stray_nodes)), i, c,
                            [-x for x in v]))
            if rng.random() < removals:
                removed = [float(rng.integers(50, 700)),
                           float(rng.integers(40, 900)), 0.0, 0.0]
                seq.append((ni, i, c, [-x for x in removed]))
            pair_removed.append(removed)
            for _ in range(picks.count(ni)):
                v = [float(rng.integers(50, 700)),
                     float(rng.integers(40, 900)), 0.0,
                     float(rng.integers(0, 5))]
                row_pair.append(p)
                row_vec.append(v)
                seq.append((ni, i, c, v))
    assert max(len(pair_ni), len(row_pair), len(seq)) <= b

    def pad(vals, fill, width=0):
        arr = np.full((b, width) if width else b, fill,
                      dtype=np.float32 if width else np.int32)
        if vals:
            arr[:len(vals)] = vals
        return arr
    return dict(
        pair_ni=pad(pair_ni, 0), row_pair=pad(row_pair, 0),
        row_vec=pad(row_vec, 0, 4), seq_ni=pad([s[0] for s in seq], -1),
        seq_vec=pad([s[3] for s in seq], 0, 4),
        seq_order=pad([s[1] for s in seq], 0),
        seq_comp=pad([s[2] for s in seq], -1),
        pair_order=pad(pair_order, 0), pair_comp=pad(pair_comp, 0),
        pair_removed=pad(pair_removed, 0, 4))


def k6_walk_model(cap, res, usage, desc, block=KERNEL_BLOCK, cut_shift=0,
                  small=SMALL_WINDOW):
    """csrc/window_verify.cu's walk, block by block, in fp32: returns
    (used, caps, fits) for every pair of the bucket.  ``cut_shift``
    moves the order cut of the entry stream (for the mutation test);
    ``small`` the (entries, rows) up to which a window takes the
    unsearched path (:data:`EVERY_WINDOW`, :data:`NO_WINDOW` force
    one)."""
    pairs, rows, entries = tmesh.kernel_counts(desc)
    searched = entries > small[0] or rows > small[1]
    b = desc["pair_ni"].shape[0]
    f32 = np.float32
    used = np.zeros((b, 4), f32)
    caps = np.zeros((b, 4), f32)
    fits = np.zeros(b, bool)
    order = desc["pair_order"]
    for p0 in range(0, b, block):
        p_end = min(p0 + block, b)
        live = max(0, min(block, pairs - p0))
        # 1. the table: a key's pairs in index order, so in pair order
        table: dict = {}
        for i in range(live):
            key = (int(desc["pair_ni"][p0 + i]),
                   int(desc["pair_comp"][p0 + i]))
            table.setdefault(key, []).append(i)
        bins = {key: np.zeros((len(lst), 4), f32)
                for key, lst in table.items()}
        # the block's run of rows, by search over the real rows; in a
        # small window every real row, masked to the block's pairs
        lo, hi = np.searchsorted(desc["row_pair"][:rows], [p0, p_end]) \
            if searched else (0, rows)
        delta = np.zeros((block, 4), f32)
        for r in range(lo, hi):
            if p0 <= desc["row_pair"][r] < p_end:
                delta[desc["row_pair"][r] - p0] += desc["row_vec"][r]
        # 2. one probe per entry, up to the block's largest pair order:
        # the stream ends there, or (a small window) masks past it
        cut = int(order[p0 + live - 1]) if live else 0
        for e in range(entries):
            o = int(desc["seq_order"][e])
            if o >= cut + cut_shift:
                if searched:
                    break
                continue
            lst = table.get((int(desc["seq_ni"][e]),
                             int(desc["seq_comp"][e])))
            if desc["seq_ni"][e] < 0 or lst is None:
                continue
            j = int(np.searchsorted(order[p0 + np.asarray(lst)], o,
                                    side="right"))
            if j < len(lst):
                bins[(int(desc["seq_ni"][e]), int(desc["seq_comp"][e]))][j] \
                    += desc["seq_vec"][e]
        # 3. each key's bins summed in pair order
        fold = np.zeros((block, 4), f32)
        for key, lst in table.items():
            fold[lst] = np.cumsum(bins[key], axis=0, dtype=f32)
        for i in range(p_end - p0):
            ni = desc["pair_ni"][p0 + i]
            used[p0 + i] = (usage[ni, :4] + res[ni, :4]) + delta[i]
            caps[p0 + i] = cap[ni, :4]
            fits[p0 + i] = bool(((used[p0 + i] + fold[i])
                                 - desc["pair_removed"][p0 + i]
                                 <= caps[p0 + i]).all())
    return used, caps, fits


def _jax_k6(cap, res, usage, desc):
    return [np.asarray(x) for x in
            _window_verify_jit(cap, res, usage, *(desc[k] for k in ORDER))]


def _same(got, want) -> bool:
    return all(np.array_equal(g, w) for g, w in zip(got, want))


# (bucket, plans, placements a plan, components, node pool, removals,
#  stray removals): buckets as the test above traces them.
WINDOWS = {
    "seeded": (512, 40, 8, 3, 40, 0.2, False),
    "small": (64, 8, 5, 2, 12, 0.3, False),
    "one node": (512, 120, 3, 1, 1, 0.2, False),
    "two components a node": (512, 60, 4, 2, 6, 0.2, False),
    "stray removals": (512, 40, 6, 3, 30, 0.2, True),
    "far under its bucket": (512, 3, 4, 2, 8, 0.5, False),
}


@pytest.mark.parametrize("path", ["small", "searched"])
@pytest.mark.parametrize("block", [KERNEL_BLOCK, 8])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_k6_walk_model_equals_jax(name, block, path):
    """Block 8 splits plans' pairs across blocks; the kernel's 128 keeps
    a small window in one block.  Both of the kernel's paths: a small
    window's (no search, masks) and the searched one's."""
    b, plans, per_plan, comps, pool, removals, stray = WINDOWS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    cap, res, usage = fleet(rng)
    nodes = rng.choice(N // 2, pool, replace=False)
    desc = ordered_window(rng, b, plans, per_plan, comps, nodes, removals,
                          stray_nodes=np.arange(N // 2, N) if stray
                          else None)
    want = _jax_k6(cap, res, usage, desc)
    got = k6_walk_model(cap, res, usage, desc, block=block,
                        small=EVERY_WINDOW if path == "small" else NO_WINDOW)
    assert _same(got, want)
    n_pairs = int((desc["pair_ni"] >= 0).sum())
    assert want[2][:n_pairs].any()


def test_k6_walk_model_hazards_are_in_the_windows():
    """The hazards the walk must survive are in the cases above: padded
    entries and rows behind the real counts, one node with pairs in two
    components, removals on nodes no pair claims, every pair on one
    node, and a block of 8 that splits a plan's pairs."""
    def build(name):
        b, plans, per_plan, comps, pool, removals, stray = WINDOWS[name]
        rng = np.random.default_rng(sum(map(ord, name)))
        fleet(rng)
        nodes = rng.choice(N // 2, pool, replace=False)
        return ordered_window(rng, b, plans, per_plan, comps, nodes,
                              removals, stray_nodes=np.arange(N // 2, N)
                              if stray else None)
    desc = build("seeded")
    pairs, rows, entries = tmesh.kernel_counts(desc)
    assert rows < desc["row_pair"].shape[0] and entries < 512
    assert (desc["seq_ni"][entries:] == -1).all()
    assert (desc["row_pair"][rows:] == 0).all()
    starts = np.flatnonzero(np.diff(desc["pair_order"][:pairs])) + 1
    assert any(s % 8 != 0 for s in starts)  # a plan straddles a block of 8
    desc = build("two components a node")
    pairs = tmesh.kernel_counts(desc)[0]
    keys = set(zip(desc["pair_ni"][:pairs].tolist(),
                   desc["pair_comp"][:pairs].tolist()))
    assert len({ni for ni, _c in keys}) < len(keys)
    desc = build("stray removals")
    _p, _r, entries = tmesh.kernel_counts(desc)
    claimed = set(desc["pair_ni"].tolist())
    assert any(ni not in claimed for ni in desc["seq_ni"][:entries])
    desc = build("one node")
    assert len(set(desc["pair_ni"][:120].tolist())) == 1


def test_k6_walk_model_fails_with_the_order_cut_off_by_one():
    """Every pair on node 0, one plan each, blocks of 8 pairs.  Node 0's
    capacity is set one MHz below what pair 7 (the first block's last)
    needs with its whole fold, so its verdict turns on the entries of
    plan 6, the last order before the block's cut.  A cut one order
    early drops them and the model disagrees with JAX; one order late it
    streams only entries no pair's search accepts, and agrees."""
    rng = np.random.default_rng(17)
    cap, res, usage = fleet(rng)
    desc = ordered_window(rng, 512, 120, 3, 1, np.array([0]), 0.0)
    cap[0, 1:4] = 1e6
    entries = desc["seq_order"] < 7
    fold = desc["seq_vec"][:, 0][entries & (desc["seq_ni"] == 0)].sum(
        dtype=np.float32)
    need = (usage[0, 0] + res[0, 0]) + desc["row_vec"][
        desc["row_pair"] == 7, 0].sum(dtype=np.float32) + fold
    cap[0, 0] = need - 1
    want = _jax_k6(cap, res, usage, desc)
    assert not want[2][7] and want[2][:7].all()
    for small in (EVERY_WINDOW, NO_WINDOW):  # both of the kernel's paths
        assert _same(k6_walk_model(cap, res, usage, desc, block=8,
                                   small=small), want)
        assert _same(k6_walk_model(cap, res, usage, desc, block=8,
                                   cut_shift=1, small=small), want)
        early = k6_walk_model(cap, res, usage, desc, block=8, cut_shift=-1,
                              small=small)
        assert not _same(early, want) and early[2][7]


def test_kernel_counts_and_the_order_the_kernel_takes():
    rng = np.random.default_rng(11)
    desc = ordered_window(rng, 64, 8, 5, 2, np.arange(12), 0.3)
    pairs, rows, entries = tmesh.kernel_counts(desc)
    assert pairs == int(np.flatnonzero(desc["pair_order"] > 0)[-1]) + 1
    assert rows == int((desc["row_vec"].any(axis=1)).sum())
    assert entries == int((desc["seq_ni"] >= 0).sum())
    for name in ("pair_order", "row_pair", "seq_order"):
        bad = {k: v.copy() for k, v in desc.items()}
        bad[name][[0, 2]] = bad[name][[2, 0]] + np.array([5, 0])
        with pytest.raises(ValueError, match=name):
            tmesh.kernel_counts(bad)
    bad = {k: v.copy() for k, v in desc.items()}
    bad["seq_order"][0] = -1
    with pytest.raises(ValueError, match="negative"):
        tmesh.kernel_counts(bad)
    # Every pair of plan 0 folds nothing: no pair needs the walk.
    empty = {k: v.copy() for k, v in desc.items()}
    empty["pair_order"][:] = 0
    assert tmesh.kernel_counts(empty)[0] == 0


def test_kernel_counts_takes_the_callers_counts():
    """The engine passes its real counts; they are checked, not
    derived: each within its bucket, each order nondecreasing over it."""
    rng = np.random.default_rng(11)
    desc = ordered_window(rng, 64, 8, 5, 2, np.arange(12), 0.3)
    derived = tmesh.kernel_counts(desc)
    assert tmesh.kernel_counts(desc, derived) == derived
    assert tmesh.kernel_counts(desc, (3, 2, 1)) == (3, 2, 1)
    with pytest.raises(ValueError, match="outside its bucket"):
        tmesh.kernel_counts(desc, (65, 0, 0))
    with pytest.raises(ValueError, match="outside its bucket"):
        tmesh.kernel_counts(desc, (0, -1, 0))
    # The padded rows carry pair 0: counted in, row_pair falls.
    with pytest.raises(ValueError, match="row_pair"):
        tmesh.kernel_counts(desc, (derived[0], derived[1] + 1, derived[2]))


def test_packed_results_round_trip():
    """K6's one output buffer (36 bytes a pair) holds used, caps and
    fits; the wrapper's views and the engine's fetched numpy copy read
    back what was packed."""
    rng = np.random.default_rng(4)
    cap, res, usage = fleet(rng)
    desc, _ = descriptors(rng, 64)
    t = torch.from_numpy
    out = tmesh.window_verify(t(cap), t(res), t(usage), **desc)
    buf = tmesh.window_verify(t(cap), t(res), t(usage), packed=True, **desc)
    assert buf.dtype == torch.uint8 and tuple(buf.shape) == (64, 36)
    assert (buf[:, 33:] == 0).all()
    for views in (tmesh.unpack_results(buf),
                  tmesh.unpack_results(buf.numpy())):
        for got, want in zip(views, out):
            assert np.array_equal(np.asarray(got), want.numpy())
