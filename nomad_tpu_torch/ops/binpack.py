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

from nomad_tpu_torch.obs import trace as obs_trace

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
    score = 20.0 - (_pow10(free_cpu) + _pow10(free_mem))
    score = torch.clamp(score, 0.0, 18.0)
    score = torch.where((node_cpu > 0) & (node_mem > 0), score,
                        torch.zeros_like(score))
    score = score - penalty * job_counts.to(score.dtype)
    ok = feasible & fit
    ok = torch.where(distinct, ok & (job_counts == 0), ok)
    return torch.where(ok, score, torch.full_like(score, NEG_INF))


# Elements of one CPU pow call in _pow10: a multiple of 32, under ATen's
# parallel grain.
_POW_CHUNK = 16384


def _pow10(x):
    """10 ** x elementwise (x 1-D).  On the CPU, PyTorch's vectorized pow
    and its loop's scalar tail can round one ulp apart, so a shard's
    slice would score otherwise than the same rows of the whole fleet.
    There the input is padded to whole blocks of 32 elements and raised
    in calls of at most ``_POW_CHUNK`` elements: each call stays under
    ATen's parallel grain (32,768), so it runs as one loop on one thread
    and every element takes the vectorized path, whatever the length and
    the thread count.  On the card pow is elementwise."""
    if x.device.type != "cpu":
        return torch.pow(10.0, x)
    n = x.shape[0]
    padded = torch.cat([x, x.new_zeros(-n % 32)])
    return torch.cat([torch.pow(10.0, c)
                      for c in padded.split(_POW_CHUNK)])[:n]


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


def _named(group_idx):
    """The device span tag of a sequence walk's launch: the distinct
    groups each lane's steps name, read from its group index when the
    span resolves (the tensor lies on the card at launch)."""
    def tags() -> dict:
        rows = group_idx.reshape(-1, group_idx.shape[-1]).tolist()
        return {"named": [len(set(row)) for row in rows]}
    return tags


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
                   distinct, group_idx, valid, penalty: float,
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
    started = obs_trace.device_span(device) if obs_trace.ENABLED else None
    code = lib.nomad_place_sequence(
        capacity.data_ptr(), reserved.data_ptr(), usage0.data_ptr(),
        job_counts0.data_ptr(), feasible.data_ptr(), asks.data_ptr(),
        distinct.data_ptr(), group_idx.data_ptr(), valid.data_ptr(),
        float(penalty), n, g, p, csize, slots, mode, chosen.data_ptr(),
        scores.data_ptr(), usage.data_ptr(), jc.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        kernels.stream_handle(device))
    if started is not None:
        started.end("device.K2", lazy=_named(group_idx), n=n, lanes=1, p=p)
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
                 counts, penalty: float, k_cap: int, rounds: int):
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
    started = obs_trace.device_span(device) if obs_trace.ENABLED else None
    code = lib.nomad_place_rounds(
        capacity.data_ptr(), reserved.data_ptr(), usage0.data_ptr(),
        jc0.data_ptr(), feasible.data_ptr(), asks.data_ptr(),
        distinct.data_ptr(), counts.data_ptr(), float(penalty), n, g,
        k_cap, rounds, path, chosen.data_ptr(), scores.data_ptr(),
        usage.data_ptr(), jc.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        kernels.stream_handle(device))
    if started is not None:
        started.end("device.K3", n=n, lanes=1, g=g, k_cap=k_cap,
                    rounds=rounds)
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
    started = obs_trace.device_span(device) if obs_trace.ENABLED else None
    code = lib.nomad_place_rounds_batch(
        capacity.data_ptr(), reserved.data_ptr(), usage0.data_ptr(),
        job_counts.data_ptr(), feasible.data_ptr(), asks.data_ptr(),
        distinct.data_ptr(), counts.data_ptr(), penalty.data_ptr(), lanes,
        n, g, k_cap, rounds, path, chosen.data_ptr(), scores.data_ptr(),
        usage.data_ptr(), jc.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        kernels.stream_handle(device))
    if started is not None:
        started.end("device.K4a", n=n, lanes=lanes, g=g, k_cap=k_cap,
                    rounds=rounds)
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
    started = obs_trace.device_span(device) if obs_trace.ENABLED else None
    code = lib.nomad_place_sequence_batch(
        capacity.data_ptr(), reserved.data_ptr(), usage0.data_ptr(),
        job_counts.data_ptr(), feasible.data_ptr(), asks.data_ptr(),
        distinct.data_ptr(), group_idx.data_ptr(), valid.data_ptr(),
        penalty.data_ptr(), lanes, n, g, p, csize, slots, mode,
        chosen.data_ptr(), scores.data_ptr(), usage.data_ptr(),
        jc.data_ptr(), None if scratch is None else scratch.data_ptr(),
        kernels.stream_handle(device))
    if started is not None:
        started.end("device.K4b", lazy=_named(group_idx), n=n, lanes=lanes,
                    p=p)
    kernels.check(lib, "place_sequence_batch", code)
    place_sequence_batch.launches += 1
    return chosen, scores, usage


place_sequence_batch.launches = 0


# -- K7: the kernels of the node-axis-sharded walks (parallel/mesh.py) ----
#
# A sharded walk splits the node axis into S shards of R = N / S rows,
# each its own tensors on its own device.  Where every shard of a mesh
# row sits on one card, the whole walk is one shard_walk launch (a
# thread-block cluster a lane, the merge in distributed shared memory).
# Where a row's shards span cards, each step of a walk (one placement of
# K2/K4b, one round of a slot of K3/K4a) is one shard_step launch
# (K7a+c) per card and mesh row, over that card's shards, and K7b on the
# lead device; after the last step one more shard_step a card applies
# the last winners (``csrc/binpack.cu``, the section "K7").  Per-lane
# operands keep K4's leading lane axis B (a single eval is one lane);
# every shard's tensors cover only its R rows.
#
# shard_select_plain (K7a's half), shard_apply_plain (K7c's half) and
# merge_select_plain (K7b) are the specification: shard_step_plain is
# the first two, shard by shard, and shard_walk_plain the loop of
# shard_step_plain and merge_select_plain.


def shard_select_plain(capacity, reserved, usage, job_counts, feasible,
                       asks, distinct, penalty, step: int, k: int,
                       row_lo: int, group_idx=None):
    """Plain version of K7a: per lane, the step's ask scored on the
    shard's rows (:func:`score_all_nodes` on the slice), and the best
    ``k`` as (values f32[B, k], global indices i32[B, k]) in K3's order:
    the argmax for k = 1, else a stable sort (:func:`topk_plain`).  The
    step's group is ``group_idx[b, step]`` (a sequence walk) or ``step``
    itself (a slot of the rounds)."""
    lanes = usage.shape[0]
    vals = torch.empty((lanes, k), dtype=torch.float32, device=usage.device)
    idx = torch.empty((lanes, k), dtype=torch.int32, device=usage.device)
    for b in range(lanes):
        g = step if group_idx is None else int(group_idx[b, step])
        masked = score_all_nodes(capacity, reserved, usage[b], job_counts[b],
                                 asks[b, g], feasible[b, g], distinct[b, g],
                                 float(penalty[b]))
        if k == 1:
            order = torch.argmax(masked).reshape(1)  # the first maximum
        else:
            order = topk_plain(masked, k)[1]
        vals[b] = masked[order]
        idx[b] = order.to(torch.int32) + row_lo
    return vals, idx


def merge_select_plain(cand_vals, cand_idx, rows: int, upd, chosen, scores,
                       *, slot: int, rnd: int = 0, m=None, counts=None,
                       valid=None):
    """Plain version of K7b: per lane, a sorted merge of the S lists of
    ``cand_vals``/``cand_idx`` f32/i32[S, B, k] (score descending, -0.0
    tied with 0.0, then global index ascending) down to ``kout =
    upd.shape[2]`` winners; writes in place what the walk keeps of them.
    A sequence walk passes ``valid`` bool[B, P] and its step as
    ``slot``: chosen/scores [B, P] at column ``slot``.  A rounds walk
    passes ``counts`` i32[B, G] and the copies left ``m`` i32[B] (read
    from counts at round 0, decreased by what the round places):
    chosen/scores [B, G, rounds * kout] at round ``rnd`` of ``slot``.
    ``upd`` i32[S, B, kout] gets, for each shard of ``rows`` rows, the
    local row and taken bit (row << 1 | taken) of each winner it owns,
    -1 elsewhere."""
    n_shards, lanes, k = cand_vals.shape
    kout = upd.shape[2]
    vals = cand_vals.permute(1, 0, 2).reshape(lanes, n_shards * k)
    idx = cand_idx.permute(1, 0, 2).reshape(lanes, n_shards * k)
    for b in range(lanes):
        order = torch.argsort(idx[b], stable=True)
        order = order[torch.sort(-(vals[b][order] + 0.0),
                                 stable=True).indices][:kout]
        wv, wi = vals[b][order], idx[b][order]
        if valid is None:
            left = int(counts[b, slot]) if rnd == 0 else int(m[b])
            take = (torch.arange(kout, device=wv.device) < left) \
                & (wv > NEG_INF / 2)
            m[b] = left - int(take.sum())
            lo = rnd * kout
            chosen[b, slot, lo:lo + kout] = torch.where(take, wi, -1)
            scores[b, slot, lo:lo + kout] = wv
        else:
            take = valid[b, slot] & (wv > NEG_INF / 2)
            chosen[b, slot] = torch.where(take, wi, -1)[0]
            scores[b, slot] = wv[0]
        owner = torch.div(wi, rows, rounding_mode="floor")
        for c in range(n_shards):
            upd[c, b] = torch.where(owner == c,
                                    (wi - c * rows) * 2 + take.to(wi.dtype),
                                    -1)


def shard_apply_plain(usage, job_counts, upd, asks, *, slot: int,
                      group_idx=None):
    """Plain version of K7c, in place: per lane, ``index_add_`` of the
    step's ask (and 1 to the job count) on the taken rows of the shard's
    ``upd`` i32[B, kout], and of 0.0 (a round) or ask * 0.0 (a sequence
    step, ``group_idx`` given) on its other winners."""
    for b in range(usage.shape[0]):
        e = upd[b]
        e = e[e >= 0]
        rows = (e >> 1).long()
        take = (e & 1).bool()
        g = slot if group_idx is None else int(group_idx[b, slot])
        ask = asks[b, g]
        miss = ask * 0.0 if group_idx is not None else torch.zeros_like(ask)
        usage[b].index_add_(0, rows, torch.where(take[:, None], ask[None, :],
                                                 miss[None, :]))
        job_counts[b].index_add_(0, rows, take.to(job_counts.dtype))


# One shard's operands of shard_step (a mapping with these keys, and
# ``row_lo``, its first row in the fleet).  The kernel's table holds
# their pointers in this order (``out`` as its two tensors), then the
# shard's key regions and row_lo (``csrc/binpack.cu`` StepShard).
# ``out`` is the pair (values f32[B, k], global indices i32[B, k]) the
# select writes, ``group_idx`` is None in a rounds walk, and ``out`` /
# ``upd`` may be None where no step selects / applies.
STEP_FIELDS = ("capacity", "reserved", "usage", "job_counts", "feasible",
               "asks", "distinct", "penalty", "group_idx", "out", "upd")
# Shards one shard_step launch takes (csrc/binpack.cu MAX_STEP_SHARDS).
STEP_SHARDS = 16


def shard_step_plain(shards, *, apply_step: int, select_step: int, k: int):
    """Plain version of K7a+c, in place, shard by shard: where
    ``apply_step`` >= 0, :func:`shard_apply_plain` of the shard's
    ``upd`` i32[B, kout] with that step's ask; then, where
    ``select_step`` >= 0, :func:`shard_select_plain` of that step's ask
    on the rows just updated, written into the shard's ``out``."""
    for sh in shards:
        gi = sh.get("group_idx")
        if apply_step >= 0:
            shard_apply_plain(sh["usage"], sh["job_counts"], sh["upd"],
                              sh["asks"], slot=apply_step, group_idx=gi)
        if select_step >= 0:
            vals, idx = shard_select_plain(
                sh["capacity"], sh["reserved"], sh["usage"],
                sh["job_counts"], sh["feasible"], sh["asks"],
                sh["distinct"], sh["penalty"], select_step, k,
                sh["row_lo"], gi)
            sh["out"][0].copy_(vals)
            sh["out"][1].copy_(idx)


def _step_tensors(shards) -> dict:
    """Every tensor of ``shards`` by a name with its shard's position
    (``usage2``, ``out_v0``), for the route and the checks."""
    out = {}
    for s, sh in enumerate(shards):
        for name in STEP_FIELDS:
            t = sh.get(name)
            if name == "out" and t is not None:
                out[f"out_v{s}"], out[f"out_i{s}"] = t
            elif t is not None:
                out[f"{name}{s}"] = t
    return out


def shard_step(shards, *, apply_step: int, select_step: int, k: int):
    """K7a+c (the per-shard half of a step of ``nomad_tpu/parallel/
    mesh.py``'s sharded argmax and top_k scans, and the owner's row
    update of the step before): the plain version for CPU tensors
    (:func:`shard_step_plain`; returns None), for CUDA tensors the
    ``shard_step_kernel`` launch, one block per (lane, shard), every
    shard in one launch.  ``shards`` are mappings of
    :data:`STEP_FIELDS` and ``row_lo``, all on one device, each shard's
    tensors covering its R rows: capacity/reserved f32[R, D] (R a power
    of two), usage f32[B, R, D] and job_counts i32[B, R] (updated in
    place), feasible bool[B, G, R], asks f32[B, G, D], distinct
    bool[B, G], penalty f32[B], group_idx i32[B, P] or None.  Selects
    the best ``k`` of step ``select_step`` (-1: none, the walk's tail)
    after applying the shard's ``upd`` of step ``apply_step`` (-1:
    none, the walk's first step).  On the card returns the checked
    :class:`StepPlan`, with which a walk launches its later steps
    (:func:`launch_shard_step`) without checking again."""
    # torchlint-ok(tensor-branch): ``shards`` is a list of shard
    # records; its truth is its length, no tensor is read.
    if not shards:
        raise ValueError("shard_step takes one shard or more")
    if apply_step < -1 or select_step < -1 or \
            (apply_step < 0 and select_step < 0):
        raise ValueError(f"shard_step: apply_step {apply_step} and "
                         f"select_step {select_step}: one of them >= 0, "
                         "neither below -1")
    device = kernels.route(_step_tensors(shards))
    rows = _node_axis(shards[0]["capacity"])
    if not 1 <= k <= rows:
        raise ValueError(f"k {k} must lie in [1, {rows}]")
    for sh in shards:
        if (apply_step >= 0 and sh.get("upd") is None) or \
                (select_step >= 0 and sh.get("out") is None):
            raise ValueError("shard_step: a shard lacks the upd it applies "
                             "or the out it selects into")
    if device.type == "cpu":
        shard_step_plain(shards, apply_step=apply_step,
                         select_step=select_step, k=k)
        return None
    plan = step_plan(shards, k)
    launch_shard_step(plan, apply_step, select_step)
    return plan


class StepPlan:
    """A checked shard_step over one group of shards on one card: the
    kernel's table of their pointers (host words, made once and reused
    every step while the tensors live), the launch's scalars, and the
    key regions of a select that shared memory cannot hold."""

    __slots__ = ("table", "scratch", "head", "tail", "shards")

    def __init__(self, table, scratch, head, tail, shards) -> None:
        self.table, self.scratch = table, scratch
        self.head, self.tail, self.shards = head, tail, shards


def step_plan(shards, k: int) -> StepPlan:
    """Check ``shards`` (CUDA tensors, as :func:`shard_step` takes them,
    at most :data:`STEP_SHARDS`) for a shard_step of ``k`` candidates and
    build its :class:`StepPlan`; raises on anything the kernel does not
    take."""
    if not 1 <= len(shards) <= STEP_SHARDS:
        raise ValueError(f"shard_step takes 1 to {STEP_SHARDS} shards a "
                         f"launch, not {len(shards)}")
    tensors = _step_tensors(shards)
    device = kernels.route(tensors)
    rows = _node_axis(shards[0]["capacity"])
    first = shards[0]
    lanes, g = first["feasible"].shape[0], first["feasible"].shape[1]
    seq = first.get("group_idx") is not None
    p = first["group_idx"].shape[-1] if seq else 1
    kout = first["upd"].shape[-1] if first.get("upd") is not None else 1
    specs = _batch_specs(rows, lanes, g, dict(
        usage=(torch.float32, (lanes, rows, NDIMS))))
    del specs["usage0"]
    specs.update(group_idx=(torch.int32, (lanes, p)),
                 out_v=(torch.float32, (lanes, k)),
                 out_i=(torch.int32, (lanes, k)),
                 upd=(torch.int32, (lanes, kout)))
    kernels.check_args(tensors, {f"{name}{s}": spec
                                 for s, sh in enumerate(shards)
                                 for name, spec in specs.items()
                                 if f"{name}{s}" in tensors})
    for sh in shards:
        if (sh.get("group_idx") is not None) != seq:
            raise ValueError("shard_step: every shard of a launch has a "
                             "group_idx (a sequence walk) or none does")
        if (sh.get("upd") is None) != (first.get("upd") is None) or \
                (sh.get("out") is None) != (first.get("out") is None):
            raise ValueError("shard_step: every shard of a launch has an "
                             "upd and an out, or none does")
    path = rounds_plan(rows, k)[0] if k > 1 else 0
    scratch = [select_scratch(rows, k, lanes, device) for _ in shards]
    words = []
    for sh, sc in zip(shards, scratch):
        for name in STEP_FIELDS:
            t = sh.get(name)
            parts = (t or (None, None)) if name == "out" else (t,)
            words += [0 if x is None else x.data_ptr() for x in parts]
        words += [0 if sc is None else sc.data_ptr(), int(sh["row_lo"])]
    table = (ctypes.c_uint64 * len(words))(*words)
    fn = kernels.library("binpack").nomad_shard_step
    head = (fn, table, len(shards), lanes, rows, g, p)
    tail = (k, kout, path, kernels.stream_handle(device))
    return StepPlan(table, scratch, head, tail, shards)


def launch_shard_step(plan: StepPlan, apply_step: int,
                      select_step: int) -> None:
    """shard_step's launch alone, on a :class:`StepPlan` that
    :func:`step_plan` checked (a walk checks once for all its steps);
    the launch goes to the stream current when the plan was made."""
    fn, *head = plan.head
    started = obs_trace.device_span(plan.shards[0]["capacity"].device) \
        if obs_trace.ENABLED else None
    code = fn(*head, apply_step, select_step, *plan.tail)
    if started is not None:
        started.end("device.shard_step")
    if code:
        kernels.check(kernels.library("binpack"), "shard_step", code)
    shard_step.launches += 1


shard_step.launches = 0


def select_scratch(rows: int, k: int, lanes: int, device):
    """The key regions of a shard's lanes in device memory where the
    plan of its top-k (:func:`rounds_plan`) does not keep them in shared
    memory, else None; a walk allocates them once for all its steps."""
    if k == 1:
        return None
    _path, words, in_smem = rounds_plan(rows, k)
    return None if in_smem else \
        torch.empty((lanes, words), dtype=torch.int32, device=device)


def merge_select(cand_vals, cand_idx, rows: int, upd, chosen, scores, *,
                 slot: int, rnd: int = 0, m=None, counts=None, valid=None):
    """K7b (the cross-shard merge of ``nomad_tpu/parallel/mesh.py``'s
    sharded argmax and top_k): the plain version for CPU tensors, the
    ``merge_select_kernel`` launch (one block a lane) for CUDA tensors;
    arguments and in-place results as :func:`merge_select_plain`."""
    args = dict(cand_vals=cand_vals, cand_idx=cand_idx, upd=upd,
                chosen=chosen, scores=scores)
    for name, t in (("m", m), ("counts", counts), ("valid", valid)):
        if t is not None:
            args[name] = t
    device = kernels.route(args)
    if (valid is None) == (counts is None or m is None):
        raise ValueError("merge_select takes valid (a sequence step) or "
                         "counts and m (a round)")
    if device.type == "cpu":
        return merge_select_plain(cand_vals, cand_idx, rows, upd, chosen,
                                  scores, slot=slot, rnd=rnd, m=m,
                                  counts=counts, valid=valid)
    n_shards, lanes, k = cand_vals.shape
    kout = upd.shape[2]
    specs = dict(cand_vals=(torch.float32, (n_shards, lanes, k)),
                 cand_idx=(torch.int32, (n_shards, lanes, k)),
                 upd=(torch.int32, (n_shards, lanes, kout)),
                 chosen=(torch.int32, tuple(chosen.shape)),
                 scores=(torch.float32, tuple(chosen.shape)))
    if valid is not None:
        specs["valid"] = (torch.bool, tuple(chosen.shape))
    else:
        specs["counts"] = (torch.int32, tuple(chosen.shape[:2]))
        specs["m"] = (torch.int32, (lanes,))
    kernels.check_args(args, specs)
    merge_launch(cand_vals, cand_idx, rows, upd, chosen, scores, m, counts,
                 valid)(slot, rnd)


def merge_launch(cand_vals, cand_idx, rows, upd, chosen, scores, m, counts,
                 valid):
    """K7b's launch alone, bound to arguments :func:`merge_select`
    checked: a function of (slot, rnd) that launches it, so a walk reads
    its pointers and stream once, not once a step."""
    n_shards, lanes, k = cand_vals.shape
    seq = valid is not None
    lib = kernels.library("binpack")
    fn = lib.nomad_merge_select
    head = (cand_vals.data_ptr(), cand_idx.data_ptr(), n_shards, lanes, k,
            upd.shape[2], rows, int(seq))
    tail = (1 if seq else chosen.shape[1], chosen.shape[-1],
            None if seq else counts.data_ptr(),
            valid.data_ptr() if seq else None,
            None if seq else m.data_ptr(), upd.data_ptr(), chosen.data_ptr(),
            scores.data_ptr(), kernels.stream_handle(cand_vals.device))

    def launch(slot: int, rnd: int) -> None:
        started = obs_trace.device_span(cand_vals.device) \
            if obs_trace.ENABLED else None
        code = fn(*head, slot, rnd, *tail)
        if started is not None:
            started.end("device.K7b")
        if code:
            kernels.check(lib, "merge_select", code)
        merge_select.launches += 1
    return launch


merge_select.launches = 0


# One shard's operands of shard_walk: STEP_FIELDS without the step's
# candidate and update buffers (``csrc/binpack.cu`` WalkShard: these
# pointers in this order, then the shard's key regions and row_lo).
WALK_FIELDS = STEP_FIELDS[:9]


def _walk_shape(shards, k_cap: int, rounds: int) -> tuple:
    """(rows, lanes, G, P, k, kout, steps) of a walk over ``shards``: a
    sequence walk (group_idx given) has k = kout = 1 and a step a
    placement, a rounds walk k = min(k_cap, R), kout = k_cap and a step
    a round of a slot."""
    first = shards[0]
    rows = _node_axis(first["capacity"])
    lanes, g = first["feasible"].shape[0], first["feasible"].shape[1]
    if first.get("group_idx") is not None:
        p = first["group_idx"].shape[-1]
        return rows, lanes, g, p, 1, 1, p
    return rows, lanes, g, 1, min(k_cap, rows), k_cap, g * rounds


def shard_walk_plain(shards, chosen, scores, *, k_cap: int = 1,
                     rounds: int = 1, valid=None, counts=None):
    """Plain version of shard_walk, in place: the walk that shard_step
    and K7b take a step at a time, as the loop of their plain versions.
    Step by step (a placement p of a sequence walk, a round ``rnd`` of a
    slot of the rounds), :func:`shard_step_plain` on every shard (the
    updates of the step before applied, then the shard's best k
    selected) and :func:`merge_select_plain` of the shards' candidates
    into ``chosen``/``scores`` and the next updates; after the last
    step, the apply alone."""
    rows, lanes, g, p, k, kout, steps = _walk_shape(shards, k_cap, rounds)
    seq = valid is not None
    dev = shards[0]["usage"].device
    n = len(shards)
    cand_v = torch.empty((n, lanes, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((n, lanes, k), dtype=torch.int32, device=dev)
    upd = torch.empty((n, lanes, kout), dtype=torch.int32, device=dev)
    m = None if seq else torch.zeros(lanes, dtype=torch.int32, device=dev)
    step = [dict(sh, out=(cand_v[s], cand_i[s]), upd=upd[s])
            for s, sh in enumerate(shards)]
    prev = -1
    for t in range(steps):
        slot, rnd = (t, 0) if seq else divmod(t, rounds)
        shard_step_plain(step, apply_step=prev, select_step=slot, k=k)
        merge_select_plain(cand_v, cand_i, rows, upd, chosen, scores,
                           slot=slot, rnd=rnd, m=m, counts=counts,
                           valid=valid)
        prev = slot
    if steps:
        shard_step_plain(step, apply_step=prev, select_step=-1, k=k)


def shard_walk(shards, chosen, scores, *, k_cap: int = 1, rounds: int = 1,
               valid=None, counts=None):
    """A whole sharded walk of one mesh row whose shards all lie on one
    device (the sharded forms of ``nomad_tpu/parallel/mesh.py``'s argmax
    and top_k scans: K7a, K7b and K7c of every step): the plain version
    for CPU tensors (:func:`shard_walk_plain`), for CUDA tensors ONE
    ``shard_walk_kernel`` launch, a thread-block cluster a lane whose
    CTAs are the shards.  ``shards`` are mappings of :data:`WALK_FIELDS`
    and ``row_lo`` (shard s's first row, s * R), each covering its R
    rows as :func:`shard_step` takes them (usage and job_counts updated
    in place); at most :data:`STEP_SHARDS` of them.  A sequence walk
    (group_idx given) passes ``valid`` bool[B, P] and fills chosen /
    scores [B, P]; a rounds walk passes ``counts`` i32[B, G] and fills
    chosen / scores [B, G, rounds * k_cap], as K4a/K4b shape them."""
    if not 1 <= len(shards) <= STEP_SHARDS:
        raise ValueError(f"shard_walk takes 1 to {STEP_SHARDS} shards, "
                         f"not {len(shards)}")
    seq = shards[0].get("group_idx") is not None
    if seq != (valid is not None) or seq == (counts is not None):
        raise ValueError("shard_walk takes valid (a sequence walk, shards "
                         "with a group_idx) or counts (rounds), not both")
    tensors = {f"{name}{s}": sh[name] for s, sh in enumerate(shards)
               for name in WALK_FIELDS if sh.get(name) is not None}
    tensors.update(chosen=chosen, scores=scores)
    tensors.update({"valid": valid} if seq else {"counts": counts})
    device = kernels.route(tensors)
    rows, lanes, g, p, k, kout, steps = _walk_shape(shards, k_cap, rounds)
    if not 1 <= k_cap <= rows * len(shards) or rounds < 1:
        raise ValueError(f"k_cap {k_cap} must lie in [1, "
                         f"{rows * len(shards)}] and rounds {rounds} >= 1")
    for s, sh in enumerate(shards):
        if int(sh["row_lo"]) != s * rows:
            raise ValueError(f"shard_walk: shard {s} starts at row "
                             f"{sh['row_lo']}, not {s * rows}")
        if (sh.get("group_idx") is not None) != seq:
            raise ValueError("shard_walk: every shard has a group_idx (a "
                             "sequence walk) or none does")
    if device.type == "cpu":
        shard_walk_plain(shards, chosen, scores, k_cap=k_cap, rounds=rounds,
                         valid=valid, counts=counts)
        return
    out_shape = (lanes, p) if seq else (lanes, g, rounds * kout)
    specs = _batch_specs(rows, lanes, g, dict(
        usage=(torch.float32, (lanes, rows, NDIMS))))
    del specs["usage0"]
    specs["group_idx"] = (torch.int32, (lanes, p))
    kernels.check_args(tensors, {f"{name}{s}": spec
                                 for s in range(len(shards))
                                 for name, spec in specs.items()
                                 if f"{name}{s}" in tensors})
    kernels.check_args(tensors, dict(
        chosen=(torch.int32, out_shape), scores=(torch.float32, out_shape),
        **({"valid": (torch.bool, (lanes, p))} if seq
           else {"counts": (torch.int32, (lanes, g))})))
    if not steps:
        return
    path = rounds_plan(rows, k)[0] if k > 1 else 0
    walk_plan(len(shards), rows, k, path, device)
    scratch = [select_scratch(rows, k, lanes, device) for _ in shards]
    table = walk_table(shards, scratch)
    lib = kernels.library("binpack")
    started = obs_trace.device_span(device) if obs_trace.ENABLED else None
    code = lib.nomad_shard_walk(
        table, len(shards), lanes, rows, g, p, k, kout, rounds, path,
        chosen.data_ptr(), scores.data_ptr(),
        valid.data_ptr() if seq else None,
        None if seq else counts.data_ptr(), kernels.stream_handle(device))
    if started is not None:
        if seq:
            started.end("device.shard_walk",
                        lazy=_named(shards[0]["group_idx"]),
                        n=rows * len(shards), lanes=lanes, p=p)
        else:
            started.end("device.shard_walk", n=rows * len(shards),
                        lanes=lanes, g=g, k_cap=k_cap, rounds=rounds)
    kernels.check(lib, "shard_walk", code)
    shard_walk.launches += 1


shard_walk.launches = 0


def walk_table(shards, scratch):
    """shard_walk's by-value table, as host words: per shard the
    pointers of :data:`WALK_FIELDS` (0 for a None group_idx), its key
    regions' (0: none) and row_lo, in the order of ``csrc/binpack.cu``
    WalkShard."""
    words = []
    for sh, sc in zip(shards, scratch):
        words += [0 if sh.get(name) is None else sh[name].data_ptr()
                  for name in WALK_FIELDS]
        words += [0 if sc is None else sc.data_ptr(), int(sh["row_lo"])]
    return (ctypes.c_uint64 * len(words))(*words)

# nomad_shard_walk_plan's answers: (device index, shards, rows, k, path)
# -> clusters the card runs at once.
_WALK_PLANS: dict = {}


def walk_plan(shards: int, rows: int, k: int, path: int, device) -> int:
    """shard_walk's plan on the CUDA ``device``: the clusters of
    ``shards`` CTAs the card runs at once (at least one, or this
    raises), from ``nomad_shard_walk_plan``, which also raises the
    kernel's attributes there; asked once per (device, shards, R, k,
    path)."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (index, shards, rows, k, path)
    plan = _WALK_PLANS.get(key)
    if plan is None:
        lib = kernels.library("binpack")
        out = (ctypes.c_int * 1)()
        with torch.cuda.device(index):
            code = lib.nomad_shard_walk_plan(shards, rows, k, path, out)
        kernels.check(lib, "shard_walk plan", code)
        plan = _WALK_PLANS[key] = out[0]
    return plan
