"""Host (numpy) executor for the bin-pack walks.

Counterpart of ``nomad_tpu/ops/binpack_host.py``: the same math as the
placement kernels (ops/binpack.py ``place_sequence`` / ``place_rounds``,
K2/K3 with K1 inside), evaluated eagerly with numpy on the host.  It
exists because a dispatch to the card has a fixed floor (the launch,
the per-eval uploads and the result fetch) that dwarfs the work of a
small walk: a 100-node fleet scores in microseconds of vectorized
numpy.  The scheduler picks the executor per dispatch
(scheduler/torch_binpack.py ``choose_host_executor``).

These are the host executor's twins of K2/K3, not the kernels' plain
versions (those are the PyTorch functions in ops/binpack.py).  Chosen
nodes, scores and usage equal the JAX package's host twins bit for bit
(tests/test_torch_executor.py); reference math AllocsFit/ScoreFit
(nomad/structs/funcs.go:48-124), anti-affinity
(scheduler/rank.go:243-302).
"""
from __future__ import annotations

import numpy as np

from nomad_tpu_torch.structs.funcs import score_fit_vec

NEG_INF = -1.0e30
DIM_CPU = 0
DIM_MEM = 1


class _HostScorer:
    """Precomputes the node-static pieces so per-step work is minimal."""

    def __init__(self, capacity, reserved) -> None:
        self.capacity = capacity
        self.base = reserved.astype(np.float32)
        node_cpu = capacity[:, DIM_CPU] - reserved[:, DIM_CPU]
        node_mem = capacity[:, DIM_MEM] - reserved[:, DIM_MEM]
        self.valid_node = (node_cpu > 0) & (node_mem > 0)
        self.safe_cpu = np.where(node_cpu > 0, node_cpu, 1.0
                                 ).astype(np.float32)
        self.safe_mem = np.where(node_mem > 0, node_mem, 1.0
                                 ).astype(np.float32)

    def masked_scores(self, usage, job_counts, ask, feasible, distinct,
                      penalty):
        util = self.base + usage + ask
        fit = (util <= self.capacity).all(axis=-1)
        score = score_fit_vec(
            util[:, DIM_CPU], util[:, DIM_MEM], None, None,
            valid=self.valid_node, safe_cpu=self.safe_cpu,
            safe_mem=self.safe_mem)
        score -= penalty * job_counts
        ok = feasible & fit
        if distinct:
            ok = ok & (job_counts == 0)
        return np.where(ok, score, np.float32(NEG_INF))


def place_sequence_host(capacity, reserved, usage0, job_counts0, feasible,
                        asks, distinct, group_idx, valid, penalty,
                        n_real: int = 0):
    """numpy twin of ops/binpack.place_sequence (same arguments and
    outputs, as numpy arrays).

    ``n_real``: the number of real (non-padding) node rows.  The card
    takes the padded shape; the host scores only the real rows (padding
    rows are never feasible, so the results are the same).
    """
    capacity = np.asarray(capacity)
    n_pad = capacity.shape[0]
    n = n_real or n_pad
    scorer = _HostScorer(capacity[:n], np.asarray(reserved)[:n])
    usage_full = np.array(usage0, dtype=np.float32, copy=True)
    jc_full = np.array(job_counts0, dtype=np.float32, copy=True)
    usage, jc = usage_full[:n], jc_full[:n]
    P = len(group_idx)
    chosen = np.full(P, -1, dtype=np.int32)
    scores = np.zeros(P, dtype=np.float32)
    feasible = np.asarray(feasible)
    asks = np.asarray(asks, dtype=np.float32)
    for p in range(P):
        if not valid[p]:
            continue
        g = group_idx[p]
        ask = asks[g]
        masked = scorer.masked_scores(usage, jc, ask, feasible[g, :n],
                                      bool(distinct[g]), penalty)
        c = int(masked.argmax())
        best = masked[c]
        if best > NEG_INF / 2:
            usage[c] += ask
            jc[c] += 1
            chosen[p] = c
            scores[p] = best
    return chosen, scores, usage_full


def _topk_exact(masked: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest scores, ties broken by the LOWER index
    (the kernels' top-k contract), in O(n + k log k).

    A plain argpartition picks an arbitrary subset when ties straddle
    the k boundary (and uniform fleets tie everywhere).  Packing the
    score and the inverted index into one int64 key makes the order
    total, so argpartition selects the same SET and a small sort of
    that slice gives the same ORDER.  The float->int map is the
    standard monotone transform (IEEE-754 ordered as sign-flipped
    integers)."""
    n = len(masked)
    if k <= 0:
        return np.empty(0, dtype=np.intp)
    if k >= n:
        return np.argsort(-masked, kind="stable")
    # -0.0 == +0.0 as floats (a tie, so index order) but their bit
    # patterns differ; adding +0.0 gives both one key.
    masked = masked + np.float32(0.0)
    bits = masked.view(np.int32).astype(np.int64)
    u = np.where(bits >= 0, bits + np.int64(0x80000000), ~bits)
    # Center the 32-bit ordered value into the signed range BEFORE the
    # shift so the packed key cannot overflow int64.
    key = ((u - np.int64(0x80000000)) << np.int64(32)) \
        | np.arange(n - 1, -1, -1, dtype=np.int64)
    sel = np.argpartition(key, n - k)[n - k:]
    return sel[np.argsort(-key[sel])]


def place_rounds_host(capacity, reserved, usage0, jc0, feasible, asks,
                      distinct, counts, penalty, k_cap: int, rounds: int,
                      n_real: int = 0):
    """numpy twin of ops/binpack.place_rounds (same arguments and
    outputs): [G, rounds * k_cap] per-slot placement streams by top-k
    rounds.

    Host-only shortcuts (same results): node rows sliced to ``n_real``
    and padding slots (count 0; they place nothing on the card either)
    skipped outright.
    """
    capacity = np.asarray(capacity)
    n = n_real or capacity.shape[0]
    scorer = _HostScorer(capacity[:n], np.asarray(reserved)[:n])
    usage_full = np.array(usage0, dtype=np.float32, copy=True)
    jc_full = np.array(jc0, dtype=np.float32, copy=True)
    usage, jc = usage_full[:n], jc_full[:n]
    feasible = np.asarray(feasible)
    asks = np.asarray(asks, dtype=np.float32)
    G = feasible.shape[0]
    chosen = np.full((G, rounds * k_cap), -1, dtype=np.int32)
    scores = np.zeros((G, rounds * k_cap), dtype=np.float32)
    pos = np.arange(k_cap)
    for s in range(G):
        ask = asks[s]
        remaining = int(counts[s])
        if remaining <= 0:
            continue
        for r in range(rounds):
            if remaining <= 0:
                break
            masked = scorer.masked_scores(usage, jc, ask,
                                          feasible[s, :n],
                                          bool(distinct[s]), penalty)
            order = _topk_exact(masked, k_cap)
            vals = masked[order]
            take = (pos[:len(order)] < remaining) & (vals > NEG_INF / 2)
            idx = order[take]
            usage[idx] += ask
            jc[idx] += 1
            placed = int(take.sum())
            remaining -= placed
            lo = r * k_cap
            chosen[s, lo:lo + len(order)][take] = idx.astype(np.int32)
            scores[s, lo:lo + len(order)][take] = vals[take]
    return chosen, scores, usage_full
