"""Vectorized bin-packing: the placement kernels of the torch-binpack path.

Counterpart of ``nomad_tpu/ops/binpack.py``.  The per-candidate scoring
walk of the reference scheduler (reference scheduler/rank.go:161-234
BinPackIterator, nomad/structs/funcs.go:48-124 AllocsFit/ScoreFit,
scheduler/rank.go:243-302 JobAntiAffinityIterator, scheduler/select.go
MaxScoreIterator) becomes array work over the whole fleet:

  fit    = all(reserved + usage + ask <= capacity, dims)     # AllocsFit
  score  = clamp(20 - (10^freeCpu% + 10^freeMem%), 0, 18)    # ScoreFit v3
  score -= penalty * same_job_count                          # anti-affinity
  choice = argmax(where(feasible & fit, score, -inf))        # MaxScore

Each public kernel is a wrapper with two routes, chosen only by where
its tensors lie: on the CPU it runs the plain PyTorch version defined
here (the reference the tests and ``chip_smoke.py`` hold the kernel
against); on a CUDA device it launches the hand-written kernel in
``csrc/binpack.cu``, or raises.  Each wrapper counts its launches in
its ``launches`` attribute.

Every step of the sequence walks (K2, K4b) and every round of the
rounds walks (K3, K4a) is scored, as in the JAX scans, also where
nothing is placed (an invalid step, a group no node fits, a round
entered with no copies left): its best score or top-k values are
returned, and the rows the JAX scan adds zero to get +0.0 (a -0.0
usage entry comes out +0.0).  Chosen is -1 wherever nothing is placed.

Shapes (N nodes padded to a power of two, D = 6 dims, G slots, P
placements): capacity/reserved/usage f32[N, D], job_counts i32[N],
feasible bool[G, N], asks f32[G, D], distinct bool[G], group_idx
i32[P], valid bool[P], counts i32[G].  ``penalty`` is a Python number.

The batch kernels (K4: ``place_rounds_batch``, ``place_sequence_batch``)
plan B independent evaluations at once from ONE shared capacity,
reserved and base usage f32[N, D]; every other operand carries a
leading lane axis B, and ``penalty`` is a per-lane tensor f32[B].  Each
lane evolves its own copy of the base usage (optimistic concurrency:
conflicts between lanes are the plan applier's to resolve).
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels

NEG_INF = -1.0e30

# Resource dim layout (nomad_tpu_torch/structs ALL_FIT_DIMS).
DIM_CPU = 0
DIM_MEM = 1
NDIMS = 6


def score_all_nodes(capacity, reserved, usage, job_counts, ask, feasible,
                    distinct, penalty):
    """Score one ask against every node: masked scores f32[N].

    The plain version of K1 (ScoreFit funcs.go:92-124 + the AllocsFit
    dimension check funcs.go:48-87 + job anti-affinity rank.go:243-302).
    On the card K1 has no launch of its own: it runs fused inside the
    place_sequence and place_rounds kernels (``score_node`` in
    ``csrc/binpack.cu``)."""
    util = reserved + usage + ask  # == AllocsFit's `used` + this ask
    fit = torch.all(util <= capacity, dim=-1)
    node_cpu = capacity[:, DIM_CPU] - reserved[:, DIM_CPU]
    node_mem = capacity[:, DIM_MEM] - reserved[:, DIM_MEM]
    one = torch.ones((), dtype=capacity.dtype, device=capacity.device)
    safe_cpu = torch.where(node_cpu > 0, node_cpu, one)
    safe_mem = torch.where(node_mem > 0, node_mem, one)
    free_cpu = 1.0 - util[:, DIM_CPU] / safe_cpu
    free_mem = 1.0 - util[:, DIM_MEM] / safe_mem
    score = 20.0 - (torch.pow(10.0, free_cpu) + torch.pow(10.0, free_mem))
    score = torch.clamp(score, 0.0, 18.0)
    score = torch.where((node_cpu > 0) & (node_mem > 0), score,
                        torch.zeros_like(score))
    score = score - penalty * job_counts.to(score.dtype)
    ok = feasible & fit
    ok = torch.where(distinct, ok & (job_counts == 0), ok)
    return torch.where(ok, score, torch.full_like(score, NEG_INF))


def place_sequence_plain(capacity, reserved, usage0, job_counts0, feasible,
                         asks, distinct, group_idx, valid, penalty,
                         with_job_counts: bool = False):
    """Plain version of K2: one placement per step, in the JAX scan's
    order, each step scoring against the usage the step before left.
    Every step is scored, valid or not, as in the JAX scan: a step that
    places nothing (invalid, or no node fits) still returns its best
    score and adds ``ask * 0.0`` to its argmax row (row 0 when every
    node is masked), which turns a -0.0 usage entry into +0.0.

    Returns chosen i32[P] (-1 = unplaced), scores f32[P] (each step's
    best score) and the final usage f32[N, D]; with
    ``with_job_counts``, also the final job counts i32[N]."""
    usage = usage0.clone()
    job_counts = job_counts0.clone()
    n_place = group_idx.shape[0]
    chosen = torch.full((n_place,), -1, dtype=torch.int32,
                        device=usage.device)
    scores = torch.empty((n_place,), dtype=torch.float32,
                         device=usage.device)
    for p, (g, is_valid) in enumerate(zip(group_idx.tolist(),
                                          valid.tolist())):
        ask = asks[g]
        masked = score_all_nodes(capacity, reserved, usage, job_counts,
                                 ask, feasible[g], distinct[g], penalty)
        choice = torch.argmax(masked)  # the first maximum
        best = masked[choice]
        scores[p] = best
        if is_valid and best.item() > NEG_INF / 2:
            usage[choice] += ask
            job_counts[choice] += 1
            chosen[p] = choice.to(torch.int32)
        else:
            usage[choice] += ask * 0.0
    if with_job_counts:
        return chosen, scores, usage, job_counts
    return chosen, scores, usage


def topk_plain(masked, k: int):
    """The k largest scores with ties to the LOWER index, as
    ``lax.top_k``: a stable sort of the negated scores.  Returns
    (values, indices)."""
    # -0.0 and +0.0 tie (index order decides), as in lax.top_k.
    order = torch.sort(-(masked + 0.0), stable=True).indices[:k]
    return masked[order], order


def place_rounds_plain(capacity, reserved, usage0, jc0, feasible, asks,
                       distinct, counts, penalty, k_cap: int, rounds: int):
    """Plain version of K3: for each slot, ``rounds`` rounds of score ->
    top-``k_cap`` -> place one copy on each of up to
    ``min(remaining, k_cap)`` distinct winners.  Every round is scored,
    also one entered with no copies left, and every top-k winner not
    taken gets +0.0 added to its row, as in the JAX scan.

    Returns chosen i32[G, rounds * k_cap] (per-slot streams in placement
    order, -1 = unplaced), scores alike (the top-k values of every
    round) and the final usage f32[N, D]."""
    usage = usage0.clone()
    jc = jc0.clone()
    n_slots = feasible.shape[0]
    device = usage.device
    chosen = torch.full((n_slots, rounds * k_cap), -1, dtype=torch.int32,
                        device=device)
    scores = torch.empty((n_slots, rounds * k_cap), dtype=torch.float32,
                         device=device)
    pos = torch.arange(k_cap, device=device)
    for s, m in enumerate(counts.tolist()):
        ask = asks[s]
        for r in range(rounds):
            masked = score_all_nodes(capacity, reserved, usage, jc, ask,
                                     feasible[s], distinct[s], penalty)
            vals, idx = topk_plain(masked, k_cap)
            take = (pos < m) & (vals > NEG_INF / 2)
            usage.index_add_(0, idx, torch.where(
                take[:, None], ask[None, :], torch.zeros_like(ask)[None, :]))
            jc.index_add_(0, idx, take.to(jc.dtype))
            m -= int(take.sum().item())
            lo = r * k_cap
            chosen[s, lo:lo + k_cap] = torch.where(
                take, idx.to(torch.int32), -1)
            scores[s, lo:lo + k_cap] = vals
    return chosen, scores, usage


# -- wrappers -----------------------------------------------------------


def _node_axis(capacity) -> int:
    n = capacity.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"node axis {n} is not a power of two")
    return n


# Where a K2 CTA keeps its node state and score slots
# (``csrc/binpack.cu`` SEQ_*): in shared memory, or where they do not fit
# in device memory (the slots in a scratch of slots * N floats).
SEQ_MODES = ("shared", "scratch")

# K2's launch plan per (device index, N, G): see sequence_plan.
_SEQUENCE_PLANS: dict = {}


def sequence_plan(n: int, g: int, device) -> tuple:
    """K2's launch plan on the CUDA ``device`` for N nodes and G groups:
    (CTAs in the cluster, score slots each CTA keeps, index into
    :data:`SEQ_MODES`), from ``nomad_place_sequence_plan``: the largest
    power of two up to 16, and up to N / 1,024, CTAs that the card can
    co-schedule, with a score slot per group up to 32 groups.  Asked
    once per (device, N, G); raises when no cluster size can launch."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (index, n, g)
    plan = _SEQUENCE_PLANS.get(key)
    if plan is None:
        lib = kernels.library("binpack")
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(index):
            code = lib.nomad_place_sequence_plan(n, g, out)
        kernels.check(lib, "place_sequence plan", code)
        plan = _SEQUENCE_PLANS[key] = tuple(out)
    return plan


def place_sequence(capacity, reserved, usage0, job_counts0, feasible, asks,
                   distinct, group_idx, valid, penalty,
                   with_job_counts: bool = False):
    """K2 (``nomad_tpu/ops/binpack.py`` place_sequence): the plain
    version for CPU tensors, the ``place_sequence_kernel`` launch (one
    thread-block cluster, :func:`sequence_plan`) for CUDA tensors.  Same
    arguments and results as :func:`place_sequence_plain`; ``usage0`` is
    never written."""
    args = dict(capacity=capacity, reserved=reserved, usage0=usage0,
                job_counts0=job_counts0, feasible=feasible, asks=asks,
                distinct=distinct, group_idx=group_idx, valid=valid)
    device = kernels.route(args)
    if device.type == "cpu":
        return place_sequence_plain(capacity, reserved, usage0, job_counts0,
                                    feasible, asks, distinct, group_idx,
                                    valid, penalty, with_job_counts)
    n = _node_axis(capacity)
    g = feasible.shape[0]
    p = group_idx.shape[0]
    kernels.check_args(args, dict(
        capacity=(torch.float32, (n, NDIMS)),
        reserved=(torch.float32, (n, NDIMS)),
        usage0=(torch.float32, (n, NDIMS)),
        job_counts0=(torch.int32, (n,)),
        feasible=(torch.bool, (g, n)),
        asks=(torch.float32, (g, NDIMS)),
        distinct=(torch.bool, (g,)),
        group_idx=(torch.int32, (p,)),
        valid=(torch.bool, (p,))))
    csize, slots, mode = sequence_plan(n, g, device)
    chosen = torch.empty(p, dtype=torch.int32, device=device)
    scores = torch.empty(p, dtype=torch.float32, device=device)
    usage = torch.empty_like(usage0)
    jc = torch.empty_like(job_counts0)
    # Every CTA's score slots, when shared memory cannot hold them.
    scratch = torch.empty(slots * n, dtype=torch.float32, device=device) \
        if SEQ_MODES[mode] == "scratch" else None
    lib = kernels.library("binpack")
    code = lib.nomad_place_sequence(
        capacity.data_ptr(), reserved.data_ptr(), usage0.data_ptr(),
        job_counts0.data_ptr(), feasible.data_ptr(), asks.data_ptr(),
        distinct.data_ptr(), group_idx.data_ptr(), valid.data_ptr(),
        float(penalty), n, g, p, csize, slots, mode, chosen.data_ptr(),
        scores.data_ptr(), usage.data_ptr(), jc.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        kernels.stream_handle(device))
    kernels.check(lib, "place_sequence", code)
    place_sequence.launches += 1
    if with_job_counts:
        return chosen, scores, usage, jc
    return chosen, scores, usage


place_sequence.launches = 0

# How a K3/K4a round finds its top k_cap (``csrc/binpack.cu`` TOPK_*): a
# full sort of N 64-bit keys, or a radix select on N 32-bit keys and a
# sort of the k_cap it keeps.  ``nomad_place_rounds_plan`` picks the sort
# where k_cap >= N / 2, else the select; a lane's keys lie in
# shared memory up to 128 KB (N = 32,768 on the select path, 16,384 on
# the sort), else in a scratch of int32 words in device memory.
ROUNDS_PATHS = ("sort", "select")

# K3/K4a's plan per (N, k_cap): see rounds_plan.
_ROUNDS_PLANS: dict = {}


def rounds_plan(n: int, k_cap: int, path=None) -> tuple:
    """K3/K4a's plan for N nodes and ``k_cap``: (index into
    :data:`ROUNDS_PATHS`, int32 words of one lane's key region, whether
    that region lies in shared memory), from ``nomad_place_rounds_plan``.
    ``path`` (a name in :data:`ROUNDS_PATHS`) forces the path; without
    it the kernel source's rule decides, asked once per (N, k_cap)."""
    key = (n, k_cap)
    plan = _ROUNDS_PLANS.get(key) if path is None else None
    if plan is None:
        lib = kernels.library("binpack")
        out = (ctypes.c_int * 3)()
        code = lib.nomad_place_rounds_plan(
            n, k_cap, -1 if path is None else ROUNDS_PATHS.index(path), out)
        kernels.check(lib, "place_rounds plan", code)
        plan = tuple(out)
        if path is None:
            _ROUNDS_PLANS[key] = plan
    return plan


def _rounds_scratch(n, k_cap, lanes, device):
    """(path, scratch) of a K3/K4a launch: the key words of each lane in
    device memory where the plan puts them there, else None."""
    path, words, in_smem = rounds_plan(n, k_cap)
    shape = (words,) if lanes is None else (lanes, words)
    scratch = None if in_smem else \
        torch.empty(shape, dtype=torch.int32, device=device)
    return path, scratch


def place_rounds(capacity, reserved, usage0, jc0, feasible, asks, distinct,
                 counts, penalty, k_cap: int, rounds: int):
    """K3 (``nomad_tpu/ops/binpack.py`` place_rounds): the plain version
    for CPU tensors, the ``place_rounds_kernel`` launch (one block, the
    top-k path of :func:`rounds_plan`) for CUDA tensors.  Same arguments
    and results as :func:`place_rounds_plain`."""
    args = dict(capacity=capacity, reserved=reserved, usage0=usage0,
                jc0=jc0, feasible=feasible, asks=asks, distinct=distinct,
                counts=counts)
    device = kernels.route(args)
    n = capacity.shape[0]
    if not 1 <= k_cap <= n or rounds < 1:
        raise ValueError(f"k_cap {k_cap} must lie in [1, {n}] and rounds "
                         f"{rounds} be >= 1")
    if device.type == "cpu":
        return place_rounds_plain(capacity, reserved, usage0, jc0, feasible,
                                  asks, distinct, counts, penalty,
                                  k_cap=k_cap, rounds=rounds)
    n = _node_axis(capacity)
    g = feasible.shape[0]
    kernels.check_args(args, dict(
        capacity=(torch.float32, (n, NDIMS)),
        reserved=(torch.float32, (n, NDIMS)),
        usage0=(torch.float32, (n, NDIMS)),
        jc0=(torch.int32, (n,)),
        feasible=(torch.bool, (g, n)),
        asks=(torch.float32, (g, NDIMS)),
        distinct=(torch.bool, (g,)),
        counts=(torch.int32, (g,))))
    chosen = torch.empty((g, rounds * k_cap), dtype=torch.int32,
                         device=device)
    scores = torch.empty((g, rounds * k_cap), dtype=torch.float32,
                         device=device)
    usage = torch.empty_like(usage0)
    jc = torch.empty_like(jc0)
    path, scratch = _rounds_scratch(n, k_cap, None, device)
    lib = kernels.library("binpack")
    code = lib.nomad_place_rounds(
        capacity.data_ptr(), reserved.data_ptr(), usage0.data_ptr(),
        jc0.data_ptr(), feasible.data_ptr(), asks.data_ptr(),
        distinct.data_ptr(), counts.data_ptr(), float(penalty), n, g,
        k_cap, rounds, path, chosen.data_ptr(), scores.data_ptr(),
        usage.data_ptr(), jc.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        kernels.stream_handle(device))
    kernels.check(lib, "place_rounds", code)
    place_rounds.launches += 1
    return chosen, scores, usage


place_rounds.launches = 0


# -- K4: the batch kernels (a vmap of K3 / K2 over B lanes) ---------------


def place_rounds_batch_plain(capacity, reserved, usage0, job_counts,
                             feasible, asks, distinct, counts, penalty,
                             k_cap: int, rounds: int):
    """Plain version of K4a: :func:`place_rounds_plain` for each lane
    from the shared base usage, stacked.  Returns chosen
    i32[B, G, rounds * k_cap], scores alike and usage f32[B, N, D]."""
    outs = [place_rounds_plain(capacity, reserved, usage0, job_counts[b],
                               feasible[b], asks[b], distinct[b], counts[b],
                               float(penalty[b]), k_cap=k_cap, rounds=rounds)
            for b in range(feasible.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def place_sequence_batch_plain(capacity, reserved, usage0, job_counts,
                               feasible, asks, distinct, group_idx, valid,
                               penalty):
    """Plain version of K4b: :func:`place_sequence_plain` for each lane
    from the shared base usage, stacked.  Returns chosen i32[B, P],
    scores f32[B, P] and usage f32[B, N, D]."""
    outs = [place_sequence_plain(capacity, reserved, usage0, job_counts[b],
                                 feasible[b], asks[b], distinct[b],
                                 group_idx[b], valid[b], float(penalty[b]))
            for b in range(feasible.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _batch_specs(n, lanes, g, lane_specs: dict) -> dict:
    specs = dict(
        capacity=(torch.float32, (n, NDIMS)),
        reserved=(torch.float32, (n, NDIMS)),
        usage0=(torch.float32, (n, NDIMS)),
        job_counts=(torch.int32, (lanes, n)),
        feasible=(torch.bool, (lanes, g, n)),
        asks=(torch.float32, (lanes, g, NDIMS)),
        distinct=(torch.bool, (lanes, g)),
        penalty=(torch.float32, (lanes,)))
    specs.update(lane_specs)
    return specs


def place_rounds_batch(capacity, reserved, usage0, job_counts, feasible,
                       asks, distinct, counts, penalty, k_cap: int,
                       rounds: int):
    """K4a (``nomad_tpu/ops/binpack.py`` place_rounds_batch): the plain
    version for CPU tensors, the ``place_rounds_batch_kernel`` launch
    (one block per lane) for CUDA tensors.  Same arguments and results
    as :func:`place_rounds_batch_plain`; ``usage0`` is never written."""
    args = dict(capacity=capacity, reserved=reserved, usage0=usage0,
                job_counts=job_counts, feasible=feasible, asks=asks,
                distinct=distinct, counts=counts, penalty=penalty)
    device = kernels.route(args)
    n = capacity.shape[0]
    if not 1 <= k_cap <= n or rounds < 1:
        raise ValueError(f"k_cap {k_cap} must lie in [1, {n}] and rounds "
                         f"{rounds} be >= 1")
    if device.type == "cpu":
        return place_rounds_batch_plain(
            capacity, reserved, usage0, job_counts, feasible, asks,
            distinct, counts, penalty, k_cap=k_cap, rounds=rounds)
    n = _node_axis(capacity)
    lanes, g = feasible.shape[0], feasible.shape[1]
    kernels.check_args(args, _batch_specs(n, lanes, g, dict(
        counts=(torch.int32, (lanes, g)))))
    chosen = torch.empty((lanes, g, rounds * k_cap), dtype=torch.int32,
                         device=device)
    scores = torch.empty((lanes, g, rounds * k_cap), dtype=torch.float32,
                         device=device)
    usage = torch.empty((lanes, n, NDIMS), dtype=torch.float32,
                        device=device)
    jc = torch.empty((lanes, n), dtype=torch.int32, device=device)
    # One row of key words per lane when they do not fit in shared memory.
    path, scratch = _rounds_scratch(n, k_cap, lanes, device)
    lib = kernels.library("binpack")
    code = lib.nomad_place_rounds_batch(
        capacity.data_ptr(), reserved.data_ptr(), usage0.data_ptr(),
        job_counts.data_ptr(), feasible.data_ptr(), asks.data_ptr(),
        distinct.data_ptr(), counts.data_ptr(), penalty.data_ptr(), lanes,
        n, g, k_cap, rounds, path, chosen.data_ptr(), scores.data_ptr(),
        usage.data_ptr(), jc.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        kernels.stream_handle(device))
    kernels.check(lib, "place_rounds_batch", code)
    place_rounds_batch.launches += 1
    return chosen, scores, usage


place_rounds_batch.launches = 0


# K4b's launch plan per (device index, N, G, B): see sequence_batch_plan.
_SEQUENCE_BATCH_PLANS: dict = {}


def sequence_batch_plan(n: int, g: int, lanes: int, device) -> tuple:
    """K4b's launch plan on the CUDA ``device`` for B = ``lanes`` lanes of
    N nodes and G groups: (CTAs in each lane's cluster, score slots each
    CTA keeps, index into :data:`SEQ_MODES`), from
    ``nomad_place_sequence_batch_plan`` (K2's cluster, halved until the
    lanes fit one wave of the card), asked once per (device, N, G, B)."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (index, n, g, lanes)
    plan = _SEQUENCE_BATCH_PLANS.get(key)
    if plan is None:
        lib = kernels.library("binpack")
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(index):
            code = lib.nomad_place_sequence_batch_plan(n, g, lanes, out)
        kernels.check(lib, "place_sequence_batch plan", code)
        plan = _SEQUENCE_BATCH_PLANS[key] = tuple(out)
    return plan


def place_sequence_batch(capacity, reserved, usage0, job_counts, feasible,
                         asks, distinct, group_idx, valid, penalty):
    """K4b (``nomad_tpu/ops/binpack.py`` place_sequence_batch): the
    plain version for CPU tensors, the ``place_sequence_batch_kernel``
    launch (K2's body on one thread-block cluster per lane,
    :func:`sequence_batch_plan`) for CUDA tensors.  Same arguments and
    results as :func:`place_sequence_batch_plain`; ``usage0`` is never
    written."""
    args = dict(capacity=capacity, reserved=reserved, usage0=usage0,
                job_counts=job_counts, feasible=feasible, asks=asks,
                distinct=distinct, group_idx=group_idx, valid=valid,
                penalty=penalty)
    device = kernels.route(args)
    if device.type == "cpu":
        return place_sequence_batch_plain(
            capacity, reserved, usage0, job_counts, feasible, asks,
            distinct, group_idx, valid, penalty)
    n = _node_axis(capacity)
    lanes, g = feasible.shape[0], feasible.shape[1]
    p = group_idx.shape[-1]
    kernels.check_args(args, _batch_specs(n, lanes, g, dict(
        group_idx=(torch.int32, (lanes, p)),
        valid=(torch.bool, (lanes, p)))))
    chosen = torch.empty((lanes, p), dtype=torch.int32, device=device)
    scores = torch.empty((lanes, p), dtype=torch.float32, device=device)
    usage = torch.empty((lanes, n, NDIMS), dtype=torch.float32,
                        device=device)
    jc = torch.empty((lanes, n), dtype=torch.int32, device=device)
    csize, slots, mode = sequence_batch_plan(n, g, lanes, device)
    # Each lane's score slots, when shared memory cannot hold them.
    scratch = torch.empty(lanes * slots * n, dtype=torch.float32,
                          device=device) \
        if SEQ_MODES[mode] == "scratch" else None
    lib = kernels.library("binpack")
    code = lib.nomad_place_sequence_batch(
        capacity.data_ptr(), reserved.data_ptr(), usage0.data_ptr(),
        job_counts.data_ptr(), feasible.data_ptr(), asks.data_ptr(),
        distinct.data_ptr(), group_idx.data_ptr(), valid.data_ptr(),
        penalty.data_ptr(), lanes, n, g, p, csize, slots, mode,
        chosen.data_ptr(), scores.data_ptr(), usage.data_ptr(),
        jc.data_ptr(), None if scratch is None else scratch.data_ptr(),
        kernels.stream_handle(device))
    kernels.check(lib, "place_sequence_batch", code)
    place_sequence_batch.launches += 1
    return chosen, scores, usage


place_sequence_batch.launches = 0
