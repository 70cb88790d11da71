"""K1-K3 of the port (nomad_tpu_torch/ops/binpack.py) against the JAX
package's kernels (nomad_tpu/ops/binpack.py) on the same seeded inputs.

The port's wrappers run their plain PyTorch versions here (the tensors
lie on the CPU); the CUDA kernels are held against those plain versions
on the card by chip_smoke.py.  The JAX kernels run jit-compiled on the
CPU backend that tests/conftest.py pins, with a few power-of-two shapes
only (the suite's recompile sentinel budgets their traces).

Tolerances: chosen nodes exactly equal; scores rtol=1e-4, atol=1e-4
where placed (XLA and PyTorch evaluate 10**x with different fp32
approximations); usage rtol=1e-5, atol=1e-3 — the contract the repo
holds between its JAX and numpy executors.
"""
import numpy as np
import pytest
import torch

import nomad_tpu.mock as mock
from nomad_tpu.models.fleet import build_fleet, build_usage
from nomad_tpu.ops import binpack as jbp
from nomad_tpu.structs import Resources
from nomad_tpu_torch.ops import binpack as tbp

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)

PENALTY = 10.0


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _random_case(rng, n_nodes=23, n_groups=3, n_place=16, used=False):
    """The shape of tests/test_jax_binpack.py _random_case: random node
    sizes and asks, 80% feasible rows, some distinct_hosts groups, the
    last two placements invalid (padding).  ``used`` puts existing
    usage and same-job counts on some nodes."""
    nodes = [mock.node(i) for i in range(n_nodes)]
    for n in nodes:
        n.resources.cpu = int(rng.integers(800, 4000))
        n.resources.memory_mb = int(rng.integers(900, 8000))
    fleet = build_fleet(nodes)
    view = build_usage(fleet, [])
    usage, jc = view.usage, view.job_counts
    if used:
        usage = usage.copy()
        jc = jc.copy()
        busy = rng.random(fleet.n_real) > 0.6
        usage[:fleet.n_real, 0] = np.where(
            busy, rng.integers(0, 600, fleet.n_real), 0)
        usage[:fleet.n_real, 1] = np.where(
            busy, rng.integers(0, 700, fleet.n_real), 0)
        jc[:fleet.n_real] = np.where(busy, rng.integers(0, 3, fleet.n_real),
                                     0)
    g_pad = 4
    asks = np.zeros((g_pad, 6), dtype=np.float32)
    for g in range(n_groups):
        asks[g] = Resources(
            cpu=int(rng.integers(50, 700)),
            memory_mb=int(rng.integers(40, 900))).as_vector()
    feasible = np.zeros((g_pad, fleet.n_pad), dtype=bool)
    feasible[:n_groups, :fleet.n_real] = \
        rng.random((n_groups, fleet.n_real)) > 0.2
    distinct = rng.random(g_pad) > 0.7
    group_idx = rng.integers(0, n_groups, n_place).astype(np.int32)
    valid = np.ones(n_place, dtype=bool)
    valid[-2:] = False
    return fleet, usage.astype(np.float32), jc.astype(np.int32), asks, \
        feasible, distinct, group_idx, valid


def _assert_placements(j_chosen, j_scores, t_chosen, t_scores):
    j_chosen = np.asarray(j_chosen)
    t_chosen = t_chosen.numpy()
    assert np.array_equal(j_chosen, t_chosen)
    placed = j_chosen >= 0
    np.testing.assert_allclose(t_scores.numpy()[placed],
                               np.asarray(j_scores)[placed],
                               rtol=1e-4, atol=1e-4)


def _assert_usage(j_usage, t_usage):
    np.testing.assert_allclose(t_usage.numpy(), np.asarray(j_usage),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("used", [False, True])
def test_score_all_nodes_matches_jax(used):
    rng = np.random.default_rng(11)
    fleet, usage, jc, asks, feasible, distinct, _g, _v = \
        _random_case(rng, used=used)
    for g in range(3):
        for dist in (False, True):
            j = jbp.score_all_nodes(
                fleet.capacity, fleet.reserved, usage, jc, asks[g],
                feasible[g], dist, PENALTY)
            t = tbp.score_all_nodes(
                _t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
                _t(asks[g]), _t(feasible[g]), torch.tensor(dist), PENALTY)
            j = np.asarray(j)
            ok = j > tbp.NEG_INF / 2
            assert np.array_equal(ok, t.numpy() > tbp.NEG_INF / 2)
            np.testing.assert_allclose(t.numpy()[ok], j[ok],
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [7, 8, 9])
@pytest.mark.parametrize("used", [False, True])
def test_place_sequence_matches_jax(seed, used):
    """Random cases, distinct_hosts groups, infeasible rows and `valid`
    padding, from an empty and a partly used fleet."""
    rng = np.random.default_rng(seed)
    fleet, usage, jc, asks, feasible, distinct, group_idx, valid = \
        _random_case(rng, used=used)
    jc_, js_, ju_ = jbp.place_sequence(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, group_idx, valid, np.float32(PENALTY))
    tc, ts, tu = tbp.place_sequence(
        _t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
        _t(feasible), _t(asks), _t(distinct), _t(group_idx), _t(valid),
        PENALTY)
    _assert_placements(jc_, js_, tc, ts)
    assert (tc.numpy()[~valid] == -1).all()
    _assert_usage(ju_, tu)


def _rounds_case(rng, counts_g, used):
    fleet, usage, jc, asks, feasible, distinct, _g, _v = \
        _random_case(rng, used=used)
    counts = np.zeros(4, dtype=np.int32)
    counts[:len(counts_g)] = counts_g
    return fleet, usage, jc, asks, feasible, distinct, counts


@pytest.mark.parametrize("k_cap,rounds,counts_g", [
    (8, 1, (5, 3, 7)),      # one round places every copy
    (4, 3, (9, 2, 6)),      # k_cap below a slot's count: rounds cover it
    (8, 2, (20, 1, 30)),    # more copies than fitting nodes: leftovers -1
])
@pytest.mark.parametrize("used", [False, True])
def test_place_rounds_matches_jax(k_cap, rounds, counts_g, used):
    rng = np.random.default_rng(100 + k_cap + rounds)
    fleet, usage, jc, asks, feasible, distinct, counts = \
        _rounds_case(rng, counts_g, used)
    jc_, js_, ju_ = jbp.place_rounds(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, counts, np.float32(PENALTY), k_cap=k_cap, rounds=rounds)
    tc, ts, tu = tbp.place_rounds(
        _t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
        _t(feasible), _t(asks), _t(distinct), _t(counts), PENALTY,
        k_cap=k_cap, rounds=rounds)
    _assert_placements(jc_, js_, tc, ts)
    _assert_usage(ju_, tu)


def _tie_case():
    """33 identical nodes (tests/test_jax_binpack.py:581): every score
    ties, so the winners are decided by the tie order alone."""
    fleet = build_fleet([mock.node(i) for i in range(33)])
    view = build_usage(fleet, [])
    asks = np.zeros((4, 6), dtype=np.float32)
    asks[0] = Resources(cpu=100, memory_mb=64).as_vector()
    feasible = np.zeros((4, fleet.n_pad), dtype=bool)
    feasible[0, :fleet.n_real] = True
    distinct = np.zeros(4, dtype=bool)
    return fleet, view, asks, feasible, distinct


def test_place_rounds_tie_order_matches_jax():
    fleet, view, asks, feasible, distinct = _tie_case()
    counts = np.zeros(4, dtype=np.int32)
    counts[0] = 8
    jc_, js_, ju_ = jbp.place_rounds(
        fleet.capacity, fleet.reserved, view.usage, view.job_counts,
        feasible, asks, distinct, counts, 10.0, k_cap=4, rounds=3)
    tc, ts, tu = tbp.place_rounds(
        _t(fleet.capacity), _t(fleet.reserved), _t(view.usage),
        _t(view.job_counts), _t(feasible), _t(asks), _t(distinct),
        _t(counts), 10.0, k_cap=4, rounds=3)
    _assert_placements(jc_, js_, tc, ts)
    assert tc.numpy()[0, :8].tolist() == list(range(8))
    _assert_usage(ju_, tu)


def test_place_sequence_tie_order_matches_jax():
    fleet, view, asks, feasible, distinct = _tie_case()
    group_idx = np.zeros(16, dtype=np.int32)
    valid = np.ones(16, dtype=bool)
    jc_, js_, ju_ = jbp.place_sequence(
        fleet.capacity, fleet.reserved, view.usage, view.job_counts,
        feasible, asks, distinct, group_idx, valid, np.float32(10.0))
    tc, ts, tu = tbp.place_sequence(
        _t(fleet.capacity), _t(fleet.reserved), _t(view.usage),
        _t(view.job_counts), _t(feasible), _t(asks), _t(distinct),
        _t(group_idx), _t(valid), 10.0)
    _assert_placements(jc_, js_, tc, ts)
    assert tc.numpy().tolist() == list(range(16))
    _assert_usage(ju_, tu)


class TestTopkPlain:
    """The plain top-k (topk_plain) against a stable argsort of the
    negated values on the hazard cases of tests/test_jax_binpack.py
    TestTopkExact: k largest, ties to the LOWER index."""

    @staticmethod
    def _ref(vals, k):
        return np.argsort(-(vals + np.float32(0.0)), kind="stable")[:k]

    def _check(self, vals, k):
        got_vals, got_idx = tbp.topk_plain(torch.from_numpy(vals), k)
        assert got_idx.tolist() == self._ref(vals, k).tolist(), k
        assert np.array_equal(got_vals.numpy(), vals[self._ref(vals, k)])

    def test_ties_straddling_the_boundary(self):
        vals = np.array([5.0, 7.0, 5.0, 5.0, 7.0, 5.0, 3.0],
                        dtype=np.float32)
        for k in (1, 2, 3, 4, 5):
            self._check(vals, k)

    def test_negative_zero_and_neg_inf_rows(self):
        vals = np.array([0.0, -0.0, tbp.NEG_INF, -0.0, 0.0, -3.5],
                        dtype=np.float32)
        for k in range(1, 7):
            self._check(vals, k)

    def test_k_bounds(self):
        vals = np.array([1.0, 2.0], dtype=np.float32)
        for k in (1, 2):
            self._check(vals, k)

    def test_random_with_heavy_ties(self):
        rng = np.random.default_rng(5)
        vals = rng.integers(0, 4, 257).astype(np.float32)
        for k in (1, 16, 64, 257):
            self._check(vals, k)


# -- the select path of the K3/K4a kernel, modelled in numpy -------------
#
# csrc/binpack.cu select_topk step by step, on one lane's key region of
# 32-bit words (a chunk here is what the kernel's block handles between
# two barriers: 4,096 nodes in the gather, 1,024 keys when it writes the
# 64-bit keys; a chunk reads its words before it writes any): ordered
# score words and the histogram of their top digit; no digit pass where
# the largest key occurs k times or more, else digit passes of 8 bits
# that stop once the candidates are exactly the keys still needed; the
# ordered compaction of the taken indices into the same words; the
# 64-bit keys written over them top chunk first; a sort of those keys
# alone.  Held
# against topk_plain, so a design error in the select shows before the
# kernel runs on a card.


def _ordered_bits(vals):
    """csrc/binpack.cu ordered_bits: -0.0 folded into +0.0."""
    u = (np.asarray(vals, dtype=np.float32) + np.float32(0.0)).view(
        np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _from_ordered(o):
    return np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o).astype(
        np.uint32).view(np.float32)


def _pick_digit(hist, prefix, mask, need, shift):
    """pick_digit: the digit of the need-th largest candidate."""
    above = 0
    for d in range(255, -1, -1):
        if above + hist[d] >= need:
            need -= above
            return (prefix | (d << shift), mask | (0xFF << shift), need,
                    need == hist[d] or shift == 0)
        above += hist[d]
    raise AssertionError("fewer candidates than needed")


def _select_topk_model(vals, k, chunk, keys_chunk):
    """(values, indices, digit passes) of the kernel's select path."""
    n = len(vals)
    m = 1 << (k - 1).bit_length()
    words = np.zeros(max(n, 2 * m), dtype=np.uint32)
    words[:n] = _ordered_bits(vals)
    # 1-2. score words, then the threshold: the largest key where it
    # occurs k times or more, else a digit a pass
    prefix = mask = 0
    need = k
    hist = np.bincount(words[:n] >> 24, minlength=256)
    passes = 1
    kmax = words[:n].max()
    if (words[:n] == kmax).sum() >= k:
        prefix, mask, passes = int(kmax), 0xFFFFFFFF, 0
    for shift in (24, 16, 8, 0) if passes else ():
        prefix, mask, need, done = _pick_digit(hist, prefix, mask, need,
                                               shift)
        if done:
            break
        cand = words[:n][(words[:n] & mask) == prefix]
        hist = np.bincount((cand >> (shift - 8)) & 0xFF, minlength=256)
        passes += 1
    # 3. ordered compaction of the taken indices into words [0, k)
    taken = seen = 0
    for base in range(0, n, chunk):
        top = words[base:base + chunk] & mask  # read before the writes
        eq, gt = top == prefix, top > prefix
        rem = max(0, need - seen)
        eq_before = np.cumsum(eq) - eq
        gt_before = np.cumsum(gt) - gt
        take = gt | (eq & (eq_before < rem))
        pos = taken + gt_before + np.minimum(eq_before, rem)
        idx = np.arange(base, base + len(top))
        assert (pos[take] <= idx[take]).all()  # no unread word written
        words[pos[take]] = idx[take]
        taken += int(gt.sum()) + min(int(eq.sum()), rem)
        seen += int(eq.sum())
    assert taken == k
    # 4. 64-bit keys over the same words, top chunk first, then the sort
    score_words = _ordered_bits(vals)
    hi = m
    while hi > 0:
        lo = max(0, hi - keys_chunk)
        j = np.arange(lo, hi)
        idx = words[j[j < k]].astype(np.int64)  # read before the writes
        keys = np.zeros(hi - lo, dtype=np.uint64)
        keys[j < k] = (score_words[idx].astype(np.uint64) << np.uint64(32)) \
            | (~idx.astype(np.uint32)).astype(np.uint64)
        words[2 * lo:2 * hi] = keys.view(np.uint32)
        hi = lo
    keys = np.sort(words[:2 * m].view(np.uint64))[::-1][:k]
    idx = (~(keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(
        np.int64)
    vals_out = _from_ordered((keys >> np.uint64(32)).astype(np.uint32))
    return vals_out, idx, passes


def _select_hazards():
    """TestTopkPlain's hazard set, 16,384 equal scores and k equal to n."""
    rng = np.random.default_rng(5)
    straddle = np.array([5.0, 7.0, 5.0, 5.0, 7.0, 5.0, 3.0],
                        dtype=np.float32)
    zeros = np.array([0.0, -0.0, tbp.NEG_INF, -0.0, 0.0, -3.5],
                     dtype=np.float32)
    heavy = rng.integers(0, 4, 257).astype(np.float32)
    masked = rng.random(4096).astype(np.float32) * 18
    masked[rng.random(4096) > 0.1] = tbp.NEG_INF  # fewer feasible than k
    return [
        ("ties straddling", straddle, (1, 2, 3, 4, 5, 7)),
        ("-0.0, +0.0, -1e30", zeros, range(1, 7)),
        ("k bounds", np.array([1.0, 2.0], dtype=np.float32), (1, 2)),
        ("heavy ties", heavy, (1, 16, 64, 257)),
        ("16,384 equal", np.full(16384, 7.25, dtype=np.float32),
         (1, 1024, 16384)),
        ("fewer feasible than k", masked, (1024, 4096)),
        ("random scores", (rng.random(32768) * 18).astype(np.float32),
         (1024,)),
    ]


@pytest.mark.parametrize("chunks", [(4096, 1024), (32, 8)])
@pytest.mark.parametrize("case", range(7))
def test_select_model_matches_topk_plain(case, chunks):
    name, vals, ks = _select_hazards()[case]
    for k in ks:
        want_vals, want_idx = tbp.topk_plain(torch.from_numpy(vals), k)
        got_vals, got_idx, passes = _select_topk_model(vals, k, *chunks)
        assert got_idx.tolist() == want_idx.tolist(), (name, k)
        # equal as numbers (-0.0 == +0.0: the fold makes them one key)
        assert np.array_equal(got_vals, want_vals.numpy()), (name, k)
        assert 0 <= passes <= 4
        ties_at_max = (_ordered_bits(vals) == _ordered_bits(vals).max()
                       ).sum() >= k
        assert (passes == 0) == bool(ties_at_max), (name, k)
        if k == len(vals) and not ties_at_max:  # every key: one pass
            assert passes == 1, (name, k)


def test_wrappers_reject_mixed_devices_and_bad_k():
    fleet, view, asks, feasible, distinct = _tie_case()
    counts = np.zeros(4, dtype=np.int32)
    with pytest.raises(ValueError):
        tbp.place_rounds(
            _t(fleet.capacity), _t(fleet.reserved), _t(view.usage),
            _t(view.job_counts), _t(feasible), _t(asks), _t(distinct),
            _t(counts), 10.0, k_cap=fleet.n_pad + 1, rounds=1)
    with pytest.raises(ValueError):
        tbp.place_rounds(
            _t(fleet.capacity), _t(fleet.reserved), _t(view.usage),
            _t(view.job_counts), _t(feasible), _t(asks), _t(distinct),
            _t(counts), 10.0, k_cap=4, rounds=0)


# -- where nothing is placed: every step and round scored, +0.0 added --------
#
# The JAX scans score every step and round, also an invalid step, a
# group no node fits and a round entered with no copies left, return
# the best score there and add zero (ask * 0.0 in K2, 0.0 in K3) to the
# argmax row / the top-k rows: a -0.0 usage entry comes out +0.0.  The
# cases below start from a usage whose zero entries are all -0.0 and
# compare the final usage bit for bit (int32 views).

_ORDERS = {
    # runs of one group (as torch_binpack lays out a job's placements),
    # the all-infeasible slot 3 among them, invalid steps inside a run
    # and at the end
    "contiguous": [0] * 5 + [1] * 4 + [3] * 2 + [2] * 5,
    # a group change at every step
    "interleaved": [0, 1, 2, 3] * 4,
}
_INVALID = (3, 6, 10, 14, 15)


def _negative_zero(usage):
    """``usage`` with every zero entry made -0.0."""
    usage = usage.copy()
    usage[usage == 0] = np.float32(-0.0)
    return usage


def _neg_zeros(x) -> int:
    x = np.asarray(x)
    return int(((x == 0) & np.signbit(x)).sum())


def _assert_usage_bits(j_usage, t_usage):
    j = np.ascontiguousarray(np.asarray(j_usage, dtype=np.float32))
    t = np.ascontiguousarray(t_usage.numpy())
    assert np.array_equal(t.view(np.int32), j.view(np.int32))


def _assert_every_score(j_scores, t_scores):
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("used", [False, True])
def test_place_sequence_scores_every_step_like_jax(order, used):
    rng = np.random.default_rng(41)
    fleet, usage, jc, asks, feasible, distinct, _g, _v = \
        _random_case(rng, used=used)
    usage = _negative_zero(usage)
    group_idx = np.asarray(_ORDERS[order], dtype=np.int32)
    valid = np.ones(len(group_idx), dtype=bool)
    valid[list(_INVALID)] = False
    jc_, js_, ju_ = jbp.place_sequence(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, group_idx, valid, np.float32(PENALTY))
    tc, ts, tu = tbp.place_sequence(
        _t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
        _t(feasible), _t(asks), _t(distinct), _t(group_idx), _t(valid),
        PENALTY)
    assert np.array_equal(tc.numpy(), np.asarray(jc_))
    _assert_every_score(js_, ts)
    _assert_usage_bits(ju_, tu)
    # the cases reach what they are for: unplaced steps with a real best
    # score, steps where no node fits, and -0.0 rows turned +0.0
    unplaced = tc.numpy() < 0
    assert (ts.numpy()[unplaced] > tbp.NEG_INF / 2).any()
    assert (ts.numpy()[group_idx == 3] == np.float32(tbp.NEG_INF)).all()
    assert _neg_zeros(tu) < _neg_zeros(usage)


@pytest.mark.parametrize("k_cap,rounds,counts_g", [
    (8, 2, (5, 0, 3, 2)),     # slot 0 done in round 0, slot 1 empty, the
                              # infeasible slot 3 asks for copies
    (4, 3, (9, 2, 0, 0)),     # slot 1 exhausted after round 0
    (8, 1, (0, 0, 0, 0)),     # nothing to place anywhere
])
@pytest.mark.parametrize("used", [False, True])
def test_place_rounds_scores_every_round_like_jax(k_cap, rounds, counts_g,
                                                  used):
    rng = np.random.default_rng(43)
    fleet, usage, jc, asks, feasible, distinct, _c = \
        _rounds_case(rng, (), used)
    usage = _negative_zero(usage)
    counts = np.asarray(counts_g, dtype=np.int32)
    jc_, js_, ju_ = jbp.place_rounds(
        fleet.capacity, fleet.reserved, usage, jc, feasible, asks,
        distinct, counts, np.float32(PENALTY), k_cap=k_cap, rounds=rounds)
    tc, ts, tu = tbp.place_rounds(
        _t(fleet.capacity), _t(fleet.reserved), _t(usage), _t(jc),
        _t(feasible), _t(asks), _t(distinct), _t(counts), PENALTY,
        k_cap=k_cap, rounds=rounds)
    assert np.array_equal(tc.numpy(), np.asarray(jc_))
    _assert_every_score(js_, ts)
    _assert_usage_bits(ju_, tu)
    # exhausted rounds carry real top-k values and the -0.0 rows of
    # their winners come out +0.0
    assert (ts.numpy()[tc.numpy() < 0] > tbp.NEG_INF / 2).any()
    assert _neg_zeros(tu) < _neg_zeros(usage)


# -- all scores equal, and k_cap equal to the node axis ---------------------
#
# The kernel's select path on a uniform fleet puts every key into one
# histogram bin of every digit pass, and with k_cap equal to the node
# axis takes every key; the plain version must give what JAX gives there.


def _equal_case(n_nodes):
    """``n_nodes`` identical nodes (N padded to 32), every real node
    feasible for slots 0-1: every feasible score ties, the padding rows
    are masked at -1e30 and fill the tail of a top-32."""
    fleet = build_fleet([mock.node(i) for i in range(n_nodes)])
    view = build_usage(fleet, [])
    asks = np.zeros((4, 6), dtype=np.float32)
    asks[0] = Resources(cpu=100, memory_mb=64).as_vector()
    asks[1] = Resources(cpu=250, memory_mb=128).as_vector()
    feasible = np.zeros((4, fleet.n_pad), dtype=bool)
    feasible[:2, :fleet.n_real] = True
    distinct = np.zeros(4, dtype=bool)
    return fleet, view, asks, feasible, distinct


@pytest.mark.parametrize("k_cap,rounds,counts_g", [
    (8, 1, (5, 3, 0, 0)),     # ties straddle the k_cap-th key
    (4, 3, (9, 2, 0, 0)),     # rounds after ties were placed on
    (32, 1, (30, 40, 0, 0)),  # k_cap = N: every key, masked ones last
])
@pytest.mark.parametrize("n_nodes", [23, 32])
def test_place_rounds_equal_scores_like_jax(k_cap, rounds, counts_g,
                                            n_nodes):
    fleet, view, asks, feasible, distinct = _equal_case(n_nodes)
    assert fleet.n_pad == 32
    counts = np.asarray(counts_g, dtype=np.int32)
    jc_, js_, ju_ = jbp.place_rounds(
        fleet.capacity, fleet.reserved, view.usage, view.job_counts,
        feasible, asks, distinct, counts, np.float32(PENALTY), k_cap=k_cap,
        rounds=rounds)
    tc, ts, tu = tbp.place_rounds(
        _t(fleet.capacity), _t(fleet.reserved), _t(view.usage),
        _t(view.job_counts), _t(feasible), _t(asks), _t(distinct),
        _t(counts), PENALTY, k_cap=k_cap, rounds=rounds)
    assert np.array_equal(tc.numpy(), np.asarray(jc_))
    _assert_every_score(js_, ts)
    _assert_usage_bits(ju_, tu)
    # ties go to the lower index: slot 0's first round takes nodes 0..
    first = tc.numpy()[0, :k_cap]
    placed = first[first >= 0]
    assert placed.tolist() == list(range(len(placed)))
    if k_cap == fleet.n_pad:  # the masked padding rows close the stream
        pad = fleet.n_pad - fleet.n_real
        if pad:
            assert (ts.numpy()[0, k_cap - pad:k_cap]
                    == np.float32(tbp.NEG_INF)).all()
