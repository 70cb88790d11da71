"""Chip smoke: build the port's CUDA kernels and drive its placement path on
one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase, the result line
    python3 chip_smoke.py --only NAME[,NAME]    # those kernels' checks alone
    python3 chip_smoke.py --profiler-events S   # does torch.profiler see
                                                # the card? (S seconds)

Phases, in order; any failure exits non-zero and prints no result line:

  1. card     the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every kernel from nomad_tpu_torch/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card,
              same inputs, bit for bit (chosen nodes, the scores of
              every step and round, usage, K2's job counts, the scatter
              and window-verify outputs under torch.equal), timed with
              CUDA events; K2 at eight shapes and under each launch plan
              it takes (cluster size, score caches); K3 and K4a on
              both top-k paths (the radix select and the full sort,
              each forced and timed beside the path the kernel's rule
              picks) at every edge of the select (a uniform fleet, ties
              straddling the k_cap-th key, 0.0 scores at it, k_cap = N,
              fewer feasible nodes than k_cap, N = 32,768 and 131,072),
              with ``torch.topk`` on the same scores as a yardstick for
              the selection alone; K5 beside ``usage.index_copy`` with
              both device times; K4b at K2's cases at B=8 and B=64 (ties,
              runs of 8 groups, a group change every step, 40 groups,
              131,072 nodes, invalid gaps and a long invalid tail, -0.0
              usage); the batch
              kernels (K4a/K4b) also lane by lane against the
              single-eval kernels (K3/K2), exactly; the window verify
              (K6) at the fleet-scaling window (B=64 on a 1,048,576-row
              fleet), a contended config-5b-sized window (B=8,192), its
              worst case (every pair on one node), a window far under
              its bucket and removals on nodes no pair claims, with its
              device time and the host time of a call;
  4. slice    the torch-binpack path through Harness.process on cuda:
              10,000 mock nodes with a 1,000-task-group job (bench.py
              config 4 shape), then 1,000 nodes with config-2 batch jobs
              committed one after another (the mirror sync scatters) and
              a job that is not rounds-eligible (place_sequence); every
              kernel's launch count must move, and the config-2
              placements must equal a rerun through the plain versions
              on the card; the main path's K2 launch is replayed from
              that rerun's inputs, bit for bit, and timed beside K4b at
              B=1 on the same inputs; K3's launches are recorded as they
              happen and the first at each shape (N=16,384 and 1,024)
              replayed on both top-k paths, bit for bit, and timed;
              then config 4's second 1,000-group job on the cluster the
              first left, with a record-only planner, finished by the
              native prefix (csrc/port_alloc.cpp, built with g++ at
              first use) and by the Python tail alone in turns, 5 times
              each, host clock: equal plans (nodes and ports), every
              placement finished in C; then the same job profiled;
  5. storm    the fused eval storm through BatchEvalRunner on cuda:
              (a) bench.py config 5, 64 jobs x 1,000 groups on 10,000
              nodes with a record-only planner: ONE place_rounds_batch
              launch, 64 plans of 1,000 placements, host phases and the
              card's busy time; (b) bench.py config 5b, 64 jobs x 100
              groups on 160 nodes through VerifyingPlanner: contended,
              no node oversubscribed, placements equal to a rerun
              through the plain versions on the card; (c) 8 jobs that
              are not rounds-eligible on 1,000 nodes, and 8 of another
              such shape on config 5's 10,000 nodes: place_sequence_batch;
              (d) config 5b again under the ``device`` verify policy:
              K6 runs every window's base fit, one upload and one fetch
              a window, and the storm must commit what (b) committed;
              (c)'s K4b launches are replayed from a plain rerun's
              inputs, bit for bit, and timed; K3's and K4a's launches in
              (a)-(c) are recorded and replayed as in the slice
              (N=16,384 and 256); config 5's storm is run once more
              under ``device_timeline`` (CUDA events around every
              kernel launch and transfer: the card's busy time, which
              must be measured) and its
              ``_finish_lanes`` timed with the native prefix (one
              bulk_finish_many for the 64 lanes) and with the 64 Python
              tails, in turns, 5 times each: equal plans lane by lane,
              every lane finished in C;
  6. system   bench.py config 3: mock.system_job() on 1,000 nodes
              through ``system`` (vectorized, native finish) and
              ``system-seq``: equal plans, every node placed, eval ms;
  7. verify   bench.py's 5f fleet-scaling sub-table on the port: NodeSlab
              fleets of 10,000, 131,072 and 1,000,000 nodes, 64
              single-placement plans a window, 8 measured windows under
              the host engine and under the device engine (K6); every
              device window must dispatch, make one upload and one
              fetch, and give the host's verdicts;
  8. report   one ``{"kernels": [...]}`` line, then the card's name and
              power limit exactly as nvidia-smi prints them, then the
              result line ``{"ok": true, "device": {...}}`` last.

Inputs come from fixed seeds.  Only the port is imported (no JAX, no
nomad_tpu).
"""
from __future__ import annotations

import contextlib
import inspect
import json
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): the least time a
# kernel could take is max(bytes / HBM rate, fp32 ops / fp32 rate).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations to score one node for one ask (score_node in
# csrc/binpack.cu: 12 adds + 6 compares for AllocsFit, 4 subtracts, 2
# divides, 2 powers, 2 adds/subtracts, 2 clamps, 1 multiply + 1
# subtract for the penalty), and 1 more to take it into a top-k
# selection.
SCORE_OPS = 32
OPS_PER_NODE = SCORE_OPS + 1
# Score slots K2 keeps per CTA, one per group up to this many groups
# (csrc/binpack.cu MAX_SLOTS); above it, one slot.
SEQ_SLOTS = 32

DEV = "cuda"  # where the checks put their tensors and run the port

# Uploads and fetches of one device verify window: one each on the card,
# none when a rehearsal runs the plain version on the CPU.
WINDOW_TRANSFERS = {"cuda": (1, 1), "cpu": (0, 0)}

# What config 5b commits on the port (its placements are also held
# against a rerun through the plain versions).
CONFIG5B_COUNTS = dict(placed=6240, conflicts=36, commits=11,
                       conflict_fallbacks=87)


class SmokeError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Bytes a placement kernel must move, for its bound: the shared fleet
# tensors (capacity, reserved, usage0) once, and per lane what that
# lane reads and writes.  Only rows the kernel reads are counted: a
# sequence group no step names leaves its feasibility row unread.
def shared_fleet_bytes(n) -> int:
    return 3 * n * 6 * 4


def rounds_lane_bytes(n, counts, out_len) -> int:
    """One lane of K3/K4a: job counts; every slot's ask, distinct flag,
    count and feasibility row (a slot of count 0 is scored too, or its
    row read to find no feasible node); chosen and scores (``out_len``
    each); the lane's usage."""
    g = len(counts)
    return 4 * n + g * (6 * 4 + 1 + 4 + n) + 8 * out_len + n * 6 * 4


def sequence_lane_bytes(n, group_idx, valid) -> int:
    """One lane of K2/K4b: job counts; the valid flags; the group index
    of each step; the feasibility row, ask and distinct flag of each
    group a step names (every step is scored, valid or not); chosen and
    scores; the lane's usage."""
    p = len(valid)
    named = len(set(np.asarray(group_idx).tolist()))
    return (4 * n + p + 4 * p + named * (n + 6 * 4 + 1) + 8 * p
            + n * 6 * 4)


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_call_ms(torch, fn, reps: int) -> float:
    """Mean host-clock ms of one call of ``fn`` on an idle card (a
    synchronize before each, untimed), after one warm-up call: the host
    time of a call the way a caller that waits for each result sees it."""
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total * 1e3 / reps


# -- phase 3: kernels against their plain versions -------------------------


def fleet_case(torch, n, rng, *, uniform=False, g=8, hazard=None):
    """Random fleet tensors on the card: f32[N, 6] capacity/reserved/usage,
    i32[N] job counts, bool[G, N] feasibility, asks f32[G, 6].

    ``hazard`` shapes the scores for an edge of K3/K4a's select:
    ``straddle`` three node sizes (4%, 30%, 66% of the fleet) on an
    empty fleet, so a slot's scores take three values and the k_cap-th
    key (1,024 of 16,384) lies inside the second, tied run; ``zeros``
    asks of 0 MHz and 0 MB on nodes with no reserve, so every idle node
    scores exactly 0.0 (20 - (10^1 + 10^1)) and 500 busy ones above it:
    the k_cap-th key is 0.0, and the idle nodes' usage is -0.0 (the
    score function gives +0.0 there: a -0.0 score cannot arise from
    x - x, from its clamps or from the fallback 0.0, so the fold of -0.0
    into +0.0 is held by the CPU tests' model of the select); ``sparse``
    ~5% of nodes feasible, fewer than k_cap, so -1e30 keys fill the top
    k_cap's tail."""
    cap = np.zeros((n, 6), dtype=np.float32)
    res = np.zeros((n, 6), dtype=np.float32)
    if hazard == "straddle":
        size = rng.choice(3, n, p=[0.04, 0.30, 0.66])
        cap[:, 0] = np.array([2000, 4000, 6000])[size]
        cap[:, 1] = np.array([4096, 8192, 12288])[size]
        cap[:, 2:5] = (102400, 150, 1000)
        res[:, 0:2] = (100, 256)
        usage = np.zeros((n, 6), dtype=np.float32)
        jc = np.zeros(n, dtype=np.int32)
        feas = np.ones((g, n), dtype=bool)
    elif hazard == "zeros":
        cap[:, :5] = (4000, 8192, 102400, 150, 1000)
        usage = np.full((n, 6), -0.0, dtype=np.float32)
        busy = rng.choice(n, 500, replace=False)
        usage[busy, 0] = rng.integers(100, 1500, 500)
        usage[busy, 1] = rng.integers(100, 3000, 500)
        jc = np.zeros(n, dtype=np.int32)
        feas = np.ones((g, n), dtype=bool)
    elif uniform:
        cap[:, :5] = (4000, 8192, 102400, 150, 1000)
        res[:, :5] = (100, 256, 4096, 0, 1)
        usage = np.zeros((n, 6), dtype=np.float32)
        jc = np.zeros(n, dtype=np.int32)
        feas = np.ones((g, n), dtype=bool)
    else:
        cap[:, 0] = rng.integers(2000, 6000, n)
        cap[:, 1] = rng.integers(4096, 12288, n)
        cap[:, 2:5] = (102400, 150, 1000)
        res[:, 0:2] = (100, 256)
        usage = np.zeros((n, 6), dtype=np.float32)
        busy = rng.random(n) > 0.5
        usage[:, 0] = np.where(busy, rng.integers(0, 1500, n), 0)
        usage[:, 1] = np.where(busy, rng.integers(0, 3000, n), 0)
        jc = np.where(busy, rng.integers(0, 3, n), 0).astype(np.int32)
        feas = rng.random((g, n)) > (0.95 if hazard == "sparse" else 0.2)
    cap[:, 5] = 40000.0
    asks = np.zeros((g, 6), dtype=np.float32)
    asks[:, 0] = rng.integers(50, 700, g)
    asks[:, 1] = rng.integers(40, 900, g)
    asks[:, 4] = 5
    asks[:, 5] = 1
    if hazard == "zeros":
        asks[:, :2] = 0.0
    distinct = rng.random(g) > 0.7 if not (uniform or hazard) \
        else np.zeros(g, bool)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
    return dict(capacity=t(cap), reserved=t(res), usage0=t(usage),
                jc0=t(jc), feasible=t(feas), asks=t(asks),
                distinct=t(distinct))


def compare(torch, what, got, want) -> float:
    """Hold a kernel's (chosen, scores, usage) against the plain
    version's, bit for bit: chosen nodes, the scores of every step or
    round (placed or not) and the final usage, sign of zero included.
    Returns the largest
    absolute score/usage difference (0.0 when they agree)."""
    for name, x, y in zip(("chosen", "scores", "usage"), got, want):
        # int32 views: -0.0 and +0.0 differ too
        require(torch.equal(x.view(torch.int32), y.view(torch.int32)),
                f"{what}: {name} differ from the plain version at "
                f"{int((x.view(torch.int32) != y.view(torch.int32)).sum())}"
                " entries")
    return max(float((x.float() - y.float()).abs().max()) if x.numel()
               else 0.0 for x, y in zip(got[1:], want[1:]))


def sequence_ops(n, g, group_idx, chosen) -> int:
    """fp32 operations one K2/K4b lane's function needs, for G groups.
    With a score slot per group (G up to SEQ_SLOTS, as K2 keeps them): a
    scoring of all N nodes the first time a group is named, and after
    each placed step one node's rescoring in every group scored so far
    (only the chosen node's inputs changed).  With more groups than
    slots, one slot: a scoring of all N nodes at every group change and
    one node after each placed step.  Plus log2 N compares a step for
    the argmax."""
    per_group = g <= SEQ_SLOTS
    ops, scored, last = 0, set(), None
    for grp, c in zip(np.asarray(group_idx).tolist(),
                      np.asarray(chosen).tolist()):
        if (grp not in scored) if per_group else (grp != last):
            ops += n * SCORE_OPS
        scored.add(grp)
        last = grp
        if c >= 0:
            ops += SCORE_OPS * (len(scored) if per_group else 1)
        ops += int(np.log2(n))
    return ops


def sequence_groups(rng, p, groups, order):
    """Group of each step: ``random`` (drawn), ``runs`` (contiguous runs
    of each group, as torch_binpack lays out a job's placements) or
    ``cycle`` (a group change at every step)."""
    if order == "random":
        return rng.integers(0, groups, p).astype(np.int32)
    if order == "runs":
        return np.repeat(np.arange(groups, dtype=np.int32),
                         -(-p // groups))[:p]
    return (np.arange(p) % groups).astype(np.int32)


def check_sequence(torch, binpack, n, p, rng, *, uniform=False, groups=3,
                   order="random", tail=8, gaps=0, neg_zero=False, reps=10,
                   other_plans=False):
    """K2 against its plain version on the card, bit for bit (chosen,
    scores, usage and job counts under torch.equal).  ``tail`` invalid
    steps at the end, an invalid step every ``gaps`` steps before them,
    ``neg_zero`` makes every zero usage entry -0.0.  ``other_plans``
    forces, on the same inputs, the launch plans (cluster, slots, mode)
    the kernel takes at other sizes: one score slot, the state and
    slots in device memory, a half and a quarter of the cluster; each
    must agree too, and is timed."""
    c = fleet_case(torch, n, rng, uniform=uniform, g=max(groups, 8))
    if neg_zero:
        c["usage0"] = torch.where(c["usage0"] == 0, -0.0, c["usage0"])
    gi_h = sequence_groups(rng, p, groups, order)
    valid_h = np.ones(p, dtype=bool)
    if gaps:
        valid_h[gaps - 1::gaps] = False
    if tail:
        valid_h[-tail:] = False
    group_idx = torch.from_numpy(gi_h).to(DEV)
    valid = torch.from_numpy(valid_h).to(DEV)
    args = (c["capacity"], c["reserved"], c["usage0"], c["jc0"],
            c["feasible"], c["asks"], c["distinct"], group_idx, valid, 10.0)
    what = f"place_sequence N={n} P={p} {order}"
    usage_before = c["usage0"].clone()
    got = binpack.place_sequence(*args, with_job_counts=True)
    torch.cuda.synchronize()
    want = binpack.place_sequence_plain(*args, with_job_counts=True)
    require(torch.equal(c["usage0"], usage_before),
            "place_sequence wrote to its input usage")
    err = compare(torch, what, got[:3], want[:3])
    require(torch.equal(got[3], want[3]),
            f"{what}: job counts differ from the plain version")
    if neg_zero:  # the +0.0 adds reached the card: -0.0 rows went +0.0
        before = int(torch.signbit(usage_before[usage_before == 0]).sum())
        after = int(torch.signbit(got[2][got[2] == 0]).sum())
        require(after < before, f"{what}: no -0.0 usage entry turned +0.0")
    ms = time_ms(torch, lambda: binpack.place_sequence(*args), reps)
    plain_ms = time_ms(torch, lambda: binpack.place_sequence_plain(*args), 1)
    g = c["feasible"].shape[0]
    plan = binpack.sequence_plan(n, g, DEV)
    key = (torch.cuda.current_device(), n, g)
    forced = {}
    cl = plan[0]
    alternates = [(cl, 1, 0), (cl, g, 1), (cl, 1, 1),
                  (max(1, cl // 2), 1, 0), (max(1, cl // 4), 1, 1)]
    for alt in alternates if other_plans else ():
        binpack._SEQUENCE_PLANS[key] = alt
        try:
            try:
                alt_out = binpack.place_sequence(*args, with_job_counts=True)
            except RuntimeError as e:  # shared memory too small for it
                require("invalid argument" in str(e), str(e))
                forced[str(list(alt))] = "refused"
                continue
            torch.cuda.synchronize()
            require(all(torch.equal(x, y) for x, y in zip(alt_out, want)),
                    f"{what}: plan {alt} differs from the plain version")
            forced[str(list(alt))] = time_ms(
                torch, lambda: binpack.place_sequence(*args), reps)
        finally:
            binpack._SEQUENCE_PLANS[key] = plan
    chosen_h = want[0].cpu().numpy()
    nbytes = shared_fleet_bytes(n) + sequence_lane_bytes(n, gi_h, valid_h)
    b_ms, b_by = bound(nbytes, sequence_ops(n, g, gi_h, chosen_h))
    out = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, placed=int((chosen_h >= 0).sum()),
               group_changes=int(1 + (np.diff(gi_h) != 0).sum()),
               cluster=plan[0], slots=plan[1],
               mode=binpack.SEQ_MODES[plan[2]])
    if forced:
        out["forced_plans_ms"] = forced
    return out


def rounds_run(counts, chosen, rounds, k_cap) -> int:
    """Rounds whose scoring the function needs: each slot's first round
    and every round after one that placed something (a round after one
    that placed nothing has the same top-k: the state changed only by
    +0.0 adds)."""
    ran = 0
    for s in range(len(counts)):
        fresh = True
        for r in range(rounds):
            ran += fresh
            fresh = bool((chosen[s, r * k_cap:(r + 1) * k_cap] >= 0).any())
    return ran


def pad_slots(c, first, axis):
    """Slots ``first``.. of the case made padding, as the scheduler pads
    a job's slots to a power of two: no feasible node, a zero ask."""
    idx = (slice(None),) * axis + (slice(first, None),)
    c["feasible"][idx] = False
    c["asks"][idx] = 0.0
    c["distinct"][idx] = False


@contextlib.contextmanager
def rounds_path(binpack, n, k_cap, path):
    """K3/K4a launched on top-k ``path`` (a name in
    ``binpack.ROUNDS_PATHS``) for N nodes and ``k_cap`` inside the
    block: the cached plan is overridden, then restored."""
    key = (n, k_cap)
    saved = binpack._ROUNDS_PLANS.get(key)
    binpack._ROUNDS_PLANS[key] = binpack.rounds_plan(n, k_cap, path)
    try:
        yield
    finally:
        if saved is None:
            binpack._ROUNDS_PLANS.pop(key, None)
        else:
            binpack._ROUNDS_PLANS[key] = saved


def rounds_paths(torch, binpack, what, run, want, n, k_cap, reps):
    """K3/K4a on both top-k paths, same inputs: each held to the plain
    result ``want`` bit for bit, then timed in turns (sort, select,
    select, sort).  Returns the path the kernel's rule picks and the mean
    ms of each path."""
    for path in binpack.ROUNDS_PATHS:
        with rounds_path(binpack, n, k_cap, path):
            got = run()
            torch.cuda.synchronize()
            compare(torch, f"{what} path={path}", got, want)
    runs: dict = {path: [] for path in binpack.ROUNDS_PATHS}
    for path in ("sort", "select", "select", "sort"):
        with rounds_path(binpack, n, k_cap, path):
            runs[path].append(time_ms(torch, run, reps))
    auto = binpack.ROUNDS_PATHS[binpack.rounds_plan(n, k_cap)[0]]
    return auto, {path: sum(v) / len(v) for path, v in runs.items()}


def select_library_ms(torch, binpack, args, k_cap, reps):
    """``torch.topk(masked, k_cap)`` on slot 0's masked scores of the
    inputs' state, [N] for K3's arguments, [B, N] for K4a's: a yardstick
    for the selection step alone.  It is not the kernel's library time
    (no PyTorch call computes K3's function) and the port never calls
    it."""
    cap, res, usage0, jc0, feas, asks, dist, _counts, penalty = args
    if feas.dim() == 3:
        masked = torch.stack([binpack.score_all_nodes(
            cap, res, usage0, jc0[b], asks[b, 0], feas[b, 0], dist[b, 0],
            float(penalty[b])) for b in range(feas.shape[0])])
    else:
        masked = binpack.score_all_nodes(cap, res, usage0, jc0, asks[0],
                                         feas[0], dist[0], float(penalty))
    return time_ms(torch, lambda: torch.topk(masked, k_cap), reps)


def check_rounds(torch, binpack, n, count, k_cap, rounds, rng, uniform,
                 reps, padded=False, hazard=None):
    """K3 against its plain version, on the path the kernel's rule picks
    and on each top-k path forced (``rounds_paths``); ``padded`` makes
    slots 2.. padding (count 0, no feasible node), as on the main path;
    ``hazard`` shapes the scores (``fleet_case``)."""
    c = fleet_case(torch, n, rng, uniform=uniform, hazard=hazard)
    if padded:
        pad_slots(c, 2, 0)
    g = c["feasible"].shape[0]
    counts_h = np.zeros(g, dtype=np.int32)
    counts_h[0] = count
    counts_h[1] = count // 7
    counts = torch.from_numpy(counts_h).to(DEV)
    args = (c["capacity"], c["reserved"], c["usage0"], c["jc0"],
            c["feasible"], c["asks"], c["distinct"], counts, 10.0)
    kw = dict(k_cap=k_cap, rounds=rounds)
    usage_before = c["usage0"].clone()
    got = binpack.place_rounds(*args, **kw)
    torch.cuda.synchronize()
    want = binpack.place_rounds_plain(*args, **kw)
    require(torch.equal(c["usage0"], usage_before),
            "place_rounds wrote to its input usage")
    what = f"place_rounds N={n} count={count} k={k_cap} {hazard or ''}"
    err = compare(torch, what, got, want)
    ms = time_ms(torch, lambda: binpack.place_rounds(*args, **kw), reps)
    path, paths_ms = rounds_paths(
        torch, binpack, what, lambda: binpack.place_rounds(*args, **kw),
        want, n, k_cap, reps)
    plain_ms = time_ms(torch, lambda: binpack.place_rounds_plain(*args, **kw),
                       1)
    ran = rounds_run(counts_h, want[0].cpu().numpy(), rounds, k_cap)
    nbytes = shared_fleet_bytes(n) + rounds_lane_bytes(
        n, counts_h, g * rounds * k_cap)
    b_ms, b_by = bound(nbytes, ran * n * OPS_PER_NODE)
    placed = int((got[0] >= 0).sum())
    require(placed == int(counts_h.sum()) or not uniform,
            "place_rounds left copies unplaced on an empty uniform fleet")
    return dict(err=err, ms=ms, path=path, paths_ms=paths_ms,
                plain_ms=plain_ms,
                select_library_ms=select_library_ms(torch, binpack, args,
                                                    k_cap, reps),
                bound_ms=b_ms, bound_by=b_by, placed=placed, rounds_run=ran)


def window_case(rng, n_real, n_plans, per_plan, n_comps, removals, *,
                bucket=None, stray=0.0, stray_nodes=None):
    """Host descriptors of one verify window as the device engine builds
    them (ops/plan_conflict._window_device_args): plan i lies in
    component i % n_comps, whose nodes are its own slice of the fleet;
    each placement is a placement row of its (plan, node) pair and a
    fold entry; a pair evicts an alloc with probability ``removals`` (a
    negative fold entry and the pair's removed sum).  ``per_plan`` 1
    puts every plan on its own node (the fleet-scaling window);
    ``n_real`` 1 puts every pair on node 0.  ``stray`` is the chance a
    pair also evicts an alloc on a node in ``stray_nodes`` (lo, hi),
    which no pair claims: a removal entry that matches nothing.
    ``bucket`` pads past the real counts' own bucket.  Returns
    (descriptors padded to one bucket, real counts)."""
    from nomad_tpu_torch.models.fleet import _pad_to

    span = n_real // n_comps
    single = rng.choice(n_real, n_plans, replace=False) \
        if per_plan == 1 else None
    pair_ni, pair_order, pair_comp, pair_removed = [], [], [], []
    row_pair, row_vec = [], []
    seq_ni, seq_vec, seq_order, seq_comp = [], [], [], []

    def removal(ni, i, c):
        v = [float(rng.integers(50, 700)), float(rng.integers(40, 900)),
             0.0, 0.0]
        seq_ni.append(ni)
        seq_vec.append([-x for x in v])
        seq_order.append(i)
        seq_comp.append(c)
        return v

    for i in range(n_plans):
        c = i % n_comps
        picks = [int(single[i])] if per_plan == 1 else \
            rng.integers(c * span, (c + 1) * span, per_plan).tolist()
        for ni in dict.fromkeys(picks):
            p = len(pair_ni)
            pair_ni.append(ni)
            pair_order.append(i)
            pair_comp.append(c)
            if stray and rng.random() < stray:
                removal(int(rng.integers(*stray_nodes)), i, c)
            removed = [0.0] * 4
            if rng.random() < removals:
                removed = removal(ni, i, c)
            pair_removed.append(removed)
            for _ in range(picks.count(ni)):
                v = [float(rng.integers(50, 700)),
                     float(rng.integers(40, 900)), 0.0,
                     float(rng.integers(0, 5))]
                row_pair.append(p)
                row_vec.append(v)
                seq_ni.append(ni)
                seq_vec.append(v)
                seq_order.append(i)
                seq_comp.append(c)
    counts = dict(pairs=len(pair_ni), rows=len(row_pair), seq=len(seq_ni))
    b = max(_pad_to(max(counts.values())), bucket or 0)

    def pad_i(vals, fill):
        out = np.full(b, fill, dtype=np.int32)
        out[:len(vals)] = vals
        return out

    def pad_v(vals):
        out = np.zeros((b, 4), dtype=np.float32)
        out[:len(vals)] = vals
        return out
    desc = dict(pair_ni=pad_i(pair_ni, 0), row_pair=pad_i(row_pair, 0),
                row_vec=pad_v(row_vec), seq_ni=pad_i(seq_ni, -1),
                seq_vec=pad_v(seq_vec), seq_order=pad_i(seq_order, 0),
                seq_comp=pad_i(seq_comp, -1),
                pair_order=pad_i(pair_order, 0),
                pair_comp=pad_i(pair_comp, 0),
                pair_removed=pad_v(pair_removed))
    return desc, counts


def fold_matches(desc, counts) -> int:
    """The (pair, fold entry) matches of one window: entries on the
    pair's node, in its component and strictly earlier in the window,
    the adds the fold must make.  Counted by sorting the real entries
    on (node, component, order) and searching each pair's key."""
    s, p = counts["seq"], counts["pairs"]
    span = int(max(desc["seq_order"][:s].max(initial=0),
                   desc["pair_order"][:p].max(initial=0))) + 1
    comps = int(max(desc["seq_comp"][:s].max(initial=0),
                    desc["pair_comp"][:p].max(initial=0))) + 2

    def key(ni, comp):
        return (ni.astype(np.int64) * comps + comp + 1) * span

    entries = np.sort(key(desc["seq_ni"][:s], desc["seq_comp"][:s])
                      + desc["seq_order"][:s])
    pair = key(desc["pair_ni"][:p], desc["pair_comp"][:p])
    return int((np.searchsorted(entries, pair + desc["pair_order"][:p])
                - np.searchsorted(entries, pair)).sum())


def window_bound(desc, counts) -> tuple:
    """K6's bound from a window's real counts.  Bytes, each read or
    written once: per pair the three gathered rows (4 values each), its
    node/order/component and removed sum, and its used, caps and fits;
    per placement row its pair and vector; per fold entry its node,
    order, component and vector.  Operations, only those the function
    needs: 4 adds per placement row, 4 per fold match
    (``fold_matches``), a sort of the fold entries by node
    (log2 compares each), and 16 per pair (the base sum, the fold, the
    removal and the compare on 4 dims).  The kernel's walk of every
    (pair, fold entry) is its own cost, not the function's."""
    pairs, rows, seq = counts["pairs"], counts["rows"], counts["seq"]
    nbytes = pairs * (3 * 16 + 12 + 16 + 16 + 16 + 1) + rows * (4 + 16) \
        + seq * (12 + 16)
    ops = 4 * rows + 4 * fold_matches(desc, counts) \
        + seq * max(1, int(np.ceil(np.log2(max(seq, 2))))) + 16 * pairs
    return bound(nbytes, ops)


def window_fleet(torch, rng, n_real, n_pad) -> list:
    """Capacity, reserved and usage f32[n_pad, 6] on the card for K6's
    windows: ``n_real`` mock-sized nodes with random usage."""
    cap = np.zeros((n_pad, 6), dtype=np.float32)
    cap[:n_real, :5] = (4000, 8192, 102400, 150, 1000)
    cap[:n_real, 5] = 40000.0
    res = np.zeros((n_pad, 6), dtype=np.float32)
    res[:n_real, :5] = (100, 256, 4096, 0, 1)
    usage = np.zeros((n_pad, 6), dtype=np.float32)
    usage[:n_real, 0] = rng.integers(0, 3000, n_real)
    usage[:n_real, 1] = rng.integers(0, 6000, n_real)
    usage[:n_real, 3] = rng.integers(0, 100, n_real)
    return [torch.from_numpy(x).to(DEV) for x in (cap, res, usage)]


def check_window_verify(torch, mesh, n_real, n_pad, n_plans, per_plan,
                        n_comps, removals, rng, reps, **case):
    """K6 against its plain version on the card: used and caps bit for
    bit, fits equal.  ``ms`` times the kernel launch alone on
    descriptors already on the card (CUDA events), ``device_ms`` the
    kernel's own device time (torch.profiler); on the host clock, with
    the card idle before each call, ``host_ms`` the wrapper as the
    engine calls it (checks, the packed upload, the launch) and
    ``dispatch_ms`` the engine's whole K6 step (``dispatch_timing``)."""
    from nomad_tpu_torch.parallel.devices import put_counted

    t = window_fleet(torch, rng, n_real, n_pad)
    desc, counts = window_case(rng, n_real, n_plans, per_plan, n_comps,
                               removals, **case)
    b = desc["pair_ni"].shape[0]
    usage_before = t[2].clone()
    got = mesh.window_verify(*t, **desc)
    torch.cuda.synchronize()
    dd = {k: torch.from_numpy(v).to(DEV) for k, v in desc.items()}
    want = mesh.window_verify_plain(*t, **dd)
    require(torch.equal(t[2], usage_before), "window_verify wrote to usage")
    what = f"window_verify N={n_pad} B={b}"
    for name, g, w in zip(("used", "caps", "fits"), got, want):
        require(g.dtype == w.dtype and torch.equal(g, w),
                f"{what}: {name} differs from the plain version")
    fits = got[2][:counts["pairs"]]
    packed = put_counted(mesh.pack_descriptors(desc, b), DEV)
    walk = mesh.kernel_counts(desc)
    ms = time_ms(torch, lambda: mesh.launch_window_verify(
        *t, packed, b, walk), reps)
    device_ms = kernel_device_ms(
        torch, lambda: mesh.launch_window_verify(*t, packed, b, walk), reps,
        "window_verify_kernel")
    host_ms = host_call_ms(torch, lambda: mesh.window_verify(
        *t, packed=True, **desc), reps)
    dispatch = dispatch_timing(torch, t, desc, counts, reps)
    plain_ms = time_ms(torch, lambda: mesh.window_verify_plain(*t, **dd),
                       max(1, reps // 10))
    b_ms, b_by = window_bound(desc, counts)
    return dict(err=float(max((g.float() - w.float()).abs().max()
                              for g, w in zip(got, want))),
                ms=ms, device_ms=device_ms, host_ms=host_ms, **dispatch,
                plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, bucket=b, **counts,
                fits=int(fits.sum()))


def dispatch_timing(torch, fleet, desc, counts, reps) -> dict:
    """The device engine's K6 step for one window, as
    ``ops/plan_conflict._dispatch_window_fit`` runs it (pad the host
    descriptors to their bucket, upload, launch, fetch the verdicts):
    ``dispatch_ms``, its host-clock ms on an idle card
    (``host_call_ms``), the kernel's device time in it, and the uploads
    and fetches it counted.  The
    descriptors are the unpadded lists the engine builds."""
    from nomad_tpu_torch.ops.plan_conflict import _dispatch_window_fit

    p, r, q = counts["pairs"], counts["rows"], counts["seq"]
    dargs = dict(
        pair_ni=desc["pair_ni"][:p].tolist(),
        pair_order=desc["pair_order"][:p].tolist(),
        pair_comp=desc["pair_comp"][:p].tolist(),
        pair_removed=desc["pair_removed"][:p].tolist(),
        seq_ni=desc["seq_ni"][:q].tolist(),
        seq_vec=desc["seq_vec"][:q].tolist(),
        seq_order=desc["seq_order"][:q].tolist(),
        seq_comp=desc["seq_comp"][:q].tolist(), seq_ok=True)
    vec_pair = desc["row_pair"][:r].tolist()
    vec_rows = desc["row_vec"][:r].tolist()

    def step():
        return _dispatch_window_fit(fleet[:2], fleet[2], dargs, vec_pair,
                                    vec_rows, p)
    info = step()[3]
    return dict(dispatch_ms=host_call_ms(torch, step, reps),
                dispatch_device_ms=kernel_device_ms(
                    torch, step, max(1, reps // 4), "window_verify_kernel"),
                dispatch_h2d=info["h2d"], dispatch_d2h=info["d2h"])


def device_per_call(torch, fn, reps):
    """torch.profiler over ``reps`` calls of ``fn`` (after one warm-up):
    the device time per call, ms, summed over every kernel it ran
    (None when the profiler saw no device time), and the kernels it
    launched per call."""
    fn()
    torch.cuda.synchronize()
    with profiled(torch) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_events(torch, prof)
    total = sum(e.time_range.elapsed_us() for e in events)
    if total <= 0:
        return None, None
    return total / 1e3 / reps, len(events) / reps


def check_scatter(torch, fleet, n, r, rng, reps):
    """K5 against its plain version, bit for bit, with and without
    padded duplicates and with -0.0 entries; timed with CUDA events
    beside ``usage.index_copy`` in the same loop, and each one's device
    time and kernels per call from torch.profiler."""
    usage_h = rng.random((n, 6)).astype(np.float32)
    usage_h[rng.random((n, 6)) > 0.9] = np.float32(-0.0)
    usage = torch.from_numpy(usage_h).to(DEV)
    idx = torch.from_numpy(rng.choice(n, r, replace=False).astype(
        np.int32)).to(DEV)
    rows = torch.from_numpy(rng.random((r, 6)).astype(np.float32)).to(DEV)
    rows[:, 0] = -0.0
    before = usage.clone()
    got = fleet.scatter_rows(usage, idx, rows)
    torch.cuda.synchronize()
    want = fleet.scatter_rows_plain(usage, idx, rows)
    require(torch.equal(usage.view(torch.int32), before.view(torch.int32)),
            "scatter_rows modified the old buffer")
    require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
            "scatter_rows differs from plain")
    # padded duplicates (idx[0] repeated with its own row)
    pad_idx = torch.cat([idx, idx[:1].repeat(7)])
    pad_rows = torch.cat([rows, rows[:1].repeat(7, 1)])
    require(torch.equal(fleet.scatter_rows(usage, pad_idx, pad_rows).view(
        torch.int32), want.view(torch.int32)),
        "scatter_rows with padded duplicates differs")
    idx64 = idx.long()

    def kernel():
        return fleet.scatter_rows(usage, idx, rows)

    def library():
        return usage.index_copy(0, idx64, rows)

    # kernel, library, library, kernel: the two share one loop's state.
    ms_a = time_ms(torch, kernel, reps)
    library_a = time_ms(torch, library, reps)
    library_b = time_ms(torch, library, reps)
    ms_b = time_ms(torch, kernel, reps)
    plain_ms = time_ms(
        torch, lambda: fleet.scatter_rows_plain(usage, idx, rows), reps)
    device_ms, kernels_per_call = device_per_call(torch, kernel, reps)
    library_device_ms, library_kernels = device_per_call(torch, library,
                                                         reps)
    require(kernels_per_call in (None, 1.0),
            f"scatter_rows ran {kernels_per_call} kernels a call, not one")
    nbytes = 2 * n * 6 * 4 + 4 * r + r * 6 * 4
    b_ms, b_by = bound(nbytes, 0)
    return dict(err=float((got - want).abs().max()), ms=(ms_a + ms_b) / 2,
                ms_runs=[ms_a, ms_b], plain_ms=plain_ms,
                library_ms=(library_a + library_b) / 2,
                library_runs=[library_a, library_b], device_ms=device_ms,
                kernels_per_call=kernels_per_call,
                library_device_ms=library_device_ms,
                library_kernels_per_call=library_kernels, bound_ms=b_ms,
                bound_by=b_by)


def lanes_case(torch, n, lanes, rng, *, uniform, g=8, hazard=None):
    """Per-lane operands over one shared fleet: the shared capacity,
    reserved and usage0 of ``fleet_case``, and for each lane its own job
    counts, feasibility, asks and distinct flags."""
    shared = fleet_case(torch, n, rng, uniform=uniform, g=g, hazard=hazard)
    per = [fleet_case(torch, n, rng, uniform=uniform, g=g, hazard=hazard)
           for _ in range(lanes)]
    out = {k: shared[k] for k in ("capacity", "reserved", "usage0")}
    for k in ("jc0", "feasible", "asks", "distinct"):
        out[k] = torch.stack([c[k] for c in per]).contiguous()
    return out


def batch_compare(torch, what, got, want, lanes_alone) -> float:
    """compare() for a batch kernel, plus lane b of the batch equal, bit
    for bit, to the single-eval kernel's result on lane b alone."""
    err = compare(torch, what, got, want)
    for b, alone in enumerate(lanes_alone):
        for x, y in zip(got, alone):
            require(torch.equal(x[b], y),
                    f"{what}: lane {b} differs from the single-eval kernel")
    return err


def check_rounds_batch(torch, binpack, n, lanes, counts0, k_cap, rounds, rng,
                       uniform, reps, padded=False, hazard=None):
    """K4a against its plain version and, lane by lane, against K3, on
    the path the kernel's rule picks and on each top-k path forced.
    ``counts0`` is slot 0's copies in every lane; random cases add a
    second slot of a seventh of it; ``padded`` makes slots 2.. padding
    (count 0, no feasible node), as on the main path; ``hazard`` shapes
    every lane's scores (``fleet_case``)."""
    c = lanes_case(torch, n, lanes, rng, uniform=uniform, hazard=hazard)
    if padded:
        pad_slots(c, 2, 1)
    g = c["feasible"].shape[1]
    counts_h = np.zeros((lanes, g), dtype=np.int32)
    counts_h[:, 0] = counts0
    if not uniform:
        counts_h[:, 1] = counts0 // 7
    counts = torch.from_numpy(counts_h).to(DEV)
    penalty = torch.full((lanes,), 10.0, device=DEV)
    args = (c["capacity"], c["reserved"], c["usage0"], c["jc0"],
            c["feasible"], c["asks"], c["distinct"], counts, penalty)
    kw = dict(k_cap=k_cap, rounds=rounds)
    usage_before = c["usage0"].clone()
    got = binpack.place_rounds_batch(*args, **kw)
    torch.cuda.synchronize()
    require(torch.equal(c["usage0"], usage_before),
            "place_rounds_batch wrote to its input usage")
    want = binpack.place_rounds_batch_plain(*args, **kw)
    alone = [binpack.place_rounds(
        c["capacity"], c["reserved"], c["usage0"], c["jc0"][b],
        c["feasible"][b], c["asks"][b], c["distinct"][b], counts[b], 10.0,
        **kw) for b in range(lanes)]
    torch.cuda.synchronize()
    what = f"place_rounds_batch N={n} B={lanes} k={k_cap} {hazard or ''}"
    err = batch_compare(torch, what, got, want, alone)
    ms = time_ms(torch, lambda: binpack.place_rounds_batch(*args, **kw), reps)
    path, paths_ms = rounds_paths(
        torch, binpack, what, lambda: binpack.place_rounds_batch(*args, **kw),
        want, n, k_cap, reps)
    plain_ms = time_ms(
        torch, lambda: binpack.place_rounds_batch_plain(*args, **kw), 1)
    chosen = want[0].cpu().numpy()
    ran = sum(rounds_run(counts_h[b], chosen[b], rounds, k_cap)
              for b in range(lanes))
    nbytes = shared_fleet_bytes(n) + sum(
        4 + rounds_lane_bytes(n, counts_h[b], g * rounds * k_cap)
        for b in range(lanes))  # 4: the lane's penalty
    b_ms, b_by = bound(nbytes, ran * n * OPS_PER_NODE)
    placed = int((got[0] >= 0).sum())
    require(placed == int(counts_h.sum()) or not uniform,
            "place_rounds_batch left copies unplaced on an empty fleet")
    # The same lanes as one single-eval K3 launch each: what the fused
    # launch saves.
    alone_ms = time_ms(torch, lambda: [binpack.place_rounds(
        c["capacity"], c["reserved"], c["usage0"], c["jc0"][b],
        c["feasible"][b], c["asks"][b], c["distinct"][b], counts[b], 10.0,
        **kw) for b in range(lanes)], 2)
    return dict(err=err, ms=ms, path=path, paths_ms=paths_ms,
                plain_ms=plain_ms,
                select_library_ms=select_library_ms(torch, binpack, args,
                                                    k_cap, reps),
                bound_ms=b_ms, bound_by=b_by, placed=placed, rounds_run=ran,
                lanes_as_single_launches_ms=alone_ms)


def check_sequence_batch(torch, binpack, n, lanes, p, rng, reps, *,
                         uniform=False, groups=3, order="random", tail=8,
                         gaps=0, neg_zero=False):
    """K4b against its plain version, bit for bit, and lane by lane
    against K2 launched alone on the lane.  Each lane draws its own
    group order (``sequence_groups``); ``tail``, ``gaps`` and
    ``neg_zero`` as in ``check_sequence``; the last lane is a pad lane
    (every step invalid, as ``pad_lanes`` adds them)."""
    g = max(groups, 8)
    c = lanes_case(torch, n, lanes, rng, uniform=uniform, g=g)
    if neg_zero:
        c["usage0"] = torch.where(c["usage0"] == 0, -0.0, c["usage0"])
    gi_h = np.stack([sequence_groups(rng, p, groups, order)
                     for _ in range(lanes)])
    valid_h = np.ones((lanes, p), dtype=bool)
    if gaps:
        valid_h[:, gaps - 1::gaps] = False
    if tail:
        valid_h[:, -tail:] = False
    valid_h[-1] = False  # a pad lane
    group_idx = torch.from_numpy(gi_h).to(DEV)
    valid = torch.from_numpy(valid_h).to(DEV)
    penalty = torch.from_numpy(
        np.where(np.arange(lanes) % 2 == 0, 10.0, 5.0).astype(
            np.float32)).to(DEV)
    args = (c["capacity"], c["reserved"], c["usage0"], c["jc0"],
            c["feasible"], c["asks"], c["distinct"], group_idx, valid,
            penalty)
    what = f"place_sequence_batch N={n} B={lanes} P={p} {order} G={groups}"
    usage_before = c["usage0"].clone()
    got = binpack.place_sequence_batch(*args)
    torch.cuda.synchronize()
    require(torch.equal(c["usage0"], usage_before),
            "place_sequence_batch wrote to its input usage")
    want = binpack.place_sequence_batch_plain(*args)
    alone = [binpack.place_sequence(
        c["capacity"], c["reserved"], c["usage0"], c["jc0"][b],
        c["feasible"][b], c["asks"][b], c["distinct"][b], group_idx[b],
        valid[b], float(penalty[b])) for b in range(lanes)]
    torch.cuda.synchronize()
    err = batch_compare(torch, what, got, want, alone)
    require(bool((got[0][-1] == -1).all()), f"{what}: the pad lane placed")
    if neg_zero:  # the +0.0 adds reached the card: -0.0 rows went +0.0
        before = int(torch.signbit(usage_before[usage_before == 0]).sum())
        after = int(torch.signbit(got[2][0][got[2][0] == 0]).sum())
        require(after < before, f"{what}: no -0.0 usage entry turned +0.0")
    ms = time_ms(torch, lambda: binpack.place_sequence_batch(*args), reps)
    plain_ms = time_ms(torch,
                       lambda: binpack.place_sequence_batch_plain(*args), 1)
    chosen_h = want[0].cpu().numpy()
    nbytes = shared_fleet_bytes(n) + sum(
        4 + sequence_lane_bytes(n, gi_h[b], valid_h[b])
        for b in range(lanes))  # 4: the lane's penalty
    b_ms, b_by = bound(nbytes, sum(sequence_ops(n, g, gi_h[b], chosen_h[b])
                                   for b in range(lanes)))
    out = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, placed=int((chosen_h >= 0).sum()))
    plan = binpack.sequence_batch_plan(n, g, lanes, DEV)
    out.update(cluster=plan[0], slots=plan[1],
               mode=binpack.SEQ_MODES[plan[2]])
    return out


# -- phase 4: the slice -----------------------------------------------------


def bench_task_group(structs, name):
    """bench.py _bench_task_group: the config 4/5 workload shape."""
    return structs.TaskGroup(name=name, count=1, tasks=[structs.Task(
        name="web", driver="exec", resources=structs.Resources(
            cpu=100, memory_mb=64, networks=[structs.NetworkResource(
                mbits=5, dynamic_ports=["http"])]))])


def config2_job(mock, structs, seed):
    """bench.py _config2_jobs: batch, 10 TGs x 4, constraint + distinct."""
    j = mock.job()
    j.id = f"config2-{seed}"
    j.type = "batch"
    groups = []
    for g in range(10):
        tg = bench_task_group(structs, f"tg-{g}")
        tg.count = 4
        tg.constraints = [
            structs.Constraint(hard=True, l_target="$attr.kernel.name",
                               r_target="linux", operand="="),
            structs.Constraint(hard=True,
                               operand=structs.CONSTRAINT_DISTINCT_HOSTS)]
        groups.append(tg)
    j.task_groups = groups
    return j


def sequence_job(mock, structs):
    """Asks large next to a node: not rounds-eligible (place_sequence)."""
    j = mock.job()
    j.id = "sequence-job"
    tg = j.task_groups[0]
    tg.count = 24
    tg.tasks[0].resources = structs.Resources(
        cpu=1500, memory_mb=3000,
        networks=[structs.NetworkResource(mbits=10, dynamic_ports=["http"])])
    return j


def run_eval(structs, h, job, times):
    h.state.upsert_job(h.next_index(), job)
    ev = structs.Evaluation(
        id=structs.generate_uuid(), priority=job.priority, type=job.type,
        triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id)
    name = "torch-binpack-batch" if job.type == "batch" else "torch-binpack"
    start = time.perf_counter()
    h.process(name, ev)
    times.append(time.perf_counter() - start)
    plan = h.plans[-1]
    placed = {a.name: node_id for node_id, allocs in
              plan.node_allocation.items() for a in allocs}
    require(h.evals[-1].status == structs.EVAL_STATUS_COMPLETE,
            f"eval for {job.id} ended {h.evals[-1].status}")
    return placed, sorted(a.name for a in plan.failed_allocs)


def small_cluster(mock, structs, Harness, nodes, times):
    """1,000 nodes: three config-2 batch jobs, each committed before the
    next eval, then the rounds-ineligible job."""
    h = Harness(device="cuda")
    for node in nodes:
        h.state.upsert_node(h.next_index(), node.copy())
    out = []
    for seed in range(3):
        out.append(run_eval(structs, h, config2_job(mock, structs, seed),
                            times))
    out.append(run_eval(structs, h, sequence_job(mock, structs), times))
    return out


def timed_phases(targets):
    """Wrap each ``(cls, method name)`` in ``targets`` with a host-clock
    timer; returns (spent: name -> seconds, restore function)."""
    spent: dict = {}
    # (cls, name, the class's own attribute or None when inherited)
    saved = [(cls, name, cls.__dict__.get(name)) for cls, name in targets]
    for cls, name, _own in saved:
        orig = getattr(cls, name)

        def timed(*a, _orig=orig, _name=name, **kw):
            t = time.perf_counter()
            try:
                return _orig(*a, **kw)
            finally:
                spent[_name] = spent.get(_name, 0.0) + \
                    time.perf_counter() - t
        static = isinstance(inspect.getattr_static(cls, name), staticmethod)
        setattr(cls, name, staticmethod(timed) if static else timed)

    def restore():
        for cls, name, own in saved:
            if own is None:
                delattr(cls, name)
            else:
                setattr(cls, name, own)
    return spent, restore


# What torch.profiler lists on the device side that is its own work.
PROFILER_OVERHEAD = ("Activity Buffer Request",)


def profiled(torch):
    """A torch.profiler session over the host and the card."""
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def device_events(torch, prof) -> list:
    """The device-side events of a profiler session (kernels, copies,
    memsets), each once: ``key_averages`` also charges a host op the
    device time of the kernels it launched, so summing its entries
    counts a copy twice; the profiler's own entries are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events()
            if e.device_type == cuda and e.name not in PROFILER_OVERHEAD]


# The port's device seams: every transfer of the main paths goes
# through one of these (parallel/devices.py).
DEVICE_SEAMS = ("put_counted", "ensure_on_default", "copy_to_host_async")


@contextlib.contextmanager
def device_timeline(torch):
    """CUDA events on the current stream around each kernel launch of
    the port's libraries (every ``nomad_*`` entry point of
    ``kernels.PROTOTYPES`` but the plan queries) and each call of its
    device seams (``DEVICE_SEAMS``) made inside the block.  Yields a
    list of (name, start event, end event).  The stream time between a
    call's two events is the card's work for it plus any stretch where
    the card waited on the host inside the call (a pageable upload's
    staging), so their sum bounds the card's busy time from above.

    torch.profiler cannot give this number on the chip machine: there
    sessions long and short lose every device event at random, and
    the events that come back sit tens of ms off the host's clock
    (``profiler_events``), which is why config 5's busy time read
    None."""
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.parallel import devices

    pairs: list = []
    depth = [0]

    def timed(fn, name):
        def call(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                return fn(*a, **kw)
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                pairs.append((name, start, end))
                depth[0] -= 1
        return call

    saved = []
    for lib_name, protos in kernels.PROTOTYPES.items():
        lib = kernels.library(lib_name)
        for fn in protos:
            if fn.endswith(("_plan", "_setup")):
                continue
            saved.append((lib, fn, getattr(lib, fn)))
    seams = {id(getattr(devices, n)) for n in DEVICE_SEAMS}
    for name, module in list(sys.modules.items()):
        if module is None or not name.startswith("nomad_tpu_torch"):
            continue
        for attr, value in list(vars(module).items()):
            if id(value) in seams:
                saved.append((module, attr, value))
    for owner, attr, value in saved:
        setattr(owner, attr, timed(value, attr))
    try:
        yield pairs
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


def profiler_session(torch, x, pad: float) -> tuple:
    """One torch.profiler session over one small kernel, with ``pad``
    seconds of sleep on each side: (device events it kept, the first
    one's start minus its ``cudaLaunchKernel``'s, µs, or None)."""
    with profiled(torch) as prof:
        time.sleep(pad)
        (x * 2).sum()
        torch.cuda.synchronize()
        time.sleep(pad)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    launch = [e.time_range.start for e in events
              if e.name == "cudaLaunchKernel"]
    device = [e.time_range.start for e in events if e.device_type == cuda]
    return len(device), (device[0] - launch[0] if device and launch
                         else None)


def profiler_events(torch, seconds: float) -> dict:
    """``--profiler-events SECONDS``: does torch.profiler see the card's
    work?  About every 8.6 s, a short session and one padded with 0.3 s
    of sleep on each side (``profiler_session``), the card and the host
    kept busy in between; one line a pair, then the sums."""
    x = torch.ones(1 << 20, device=DEV)
    (x * 2).sum()
    torch.cuda.synchronize()
    rows = []
    t0 = time.time()
    while time.time() - t0 < seconds:
        row = dict(t=round(time.time() - t0, 1),
                   short=profiler_session(torch, x, 0.0),
                   padded=profiler_session(torch, x, 0.3))
        print("profiler session: " + json.dumps(row), flush=True)
        rows.append(row)
        end = time.time() + 8
        while time.time() < end:
            (x * 2).sum()
            torch.cuda.synchronize()
    offsets = [r[k][1] for r in rows for k in ("short", "padded")
               if r[k][1] is not None]
    return dict(
        sessions=2 * len(rows),
        short_without_device_events=sum(r["short"][0] == 0 for r in rows),
        padded_without_device_events=sum(r["padded"][0] == 0
                                         for r in rows),
        offset_us_min=min(offsets, default=None),
        offset_us_max=max(offsets, default=None))


def device_busy_ms(torch, fn):
    """Run ``fn`` inside ``device_timeline``.  Returns the card's busy
    ms (None when nothing ran on it), the top entries by time, and what
    ``fn`` returned."""
    with device_timeline(torch) as pairs:
        result = fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for name, start, end in pairs:
        by_name[name] = by_name.get(name, 0.0) + start.elapsed_time(end)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (busy_ms if busy_ms > 0 else None), top, result


def kernel_device_ms(torch, fn, reps, name):
    """Mean device time, per call of ``fn``, of the kernels whose name
    holds ``name``, from torch.profiler (None when it saw none): the
    kernel's own time where CUDA events over back-to-back calls measure
    the host's launch rate instead."""
    fn()
    torch.cuda.synchronize()
    with profiled(torch) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in device_events(torch, prof)
                if name in e.name)
    return total / 1e3 / reps if total > 0 else None


def phase_breakdown(torch, structs, h, job):
    """One more eval on ``h`` (after the main path's counts were read),
    with host-clock time per scheduler phase and the card's busy time
    (``device_busy_ms``).  Returns ms per phase, the eval's wall ms, the
    device busy ms and the top device entries by time."""
    from nomad_tpu_torch.scheduler import Harness, TorchBinPackScheduler

    spent, restore = timed_phases([(TorchBinPackScheduler, name) for name in (
        "_compute_job_allocs", "_prepare_device", "dispatch_device",
        "collect_device", "finish_deferred")] + [(Harness, "submit_plan")])
    times: list = []
    try:
        busy_ms, top, _ = device_busy_ms(
            torch, lambda: run_eval(structs, h, job, times))
    finally:
        restore()
    # _compute_job_allocs encloses the device phases; report its own part.
    inner = sum(spent.get(k, 0.0) for k in (
        "_prepare_device", "dispatch_device", "collect_device",
        "finish_deferred"))
    spent["_compute_job_allocs"] = spent.get("_compute_job_allocs",
                                             0.0) - inner
    return dict(phases_ms={k: v * 1e3 for k, v in spent.items()},
                eval_ms=times[0] * 1e3, device_busy_ms=busy_ms,
                device_top_ms=top)


def alloc_ports(a) -> tuple:
    """An alloc's reserved ports in task order: a lazy slab row's from
    its slab's port column (what it would materialize, without building
    the objects), any other alloc's from its task resources."""
    d = a.__dict__
    slab = d.get("_slab")
    if slab is not None and "task_resources" not in d:
        r = d["_srow"]
        return tuple(slab.ports[slab.port_off[r]:slab.port_off[r + 1]]
                     .tolist())
    return tuple(p for tr in a.task_resources.values() for n in tr.networks
                 for p in n.reserved_ports)


def plan_placements(plan) -> dict:
    """alloc name -> (node id, reserved ports) of a plan's placements."""
    return {a.name: (node_id, alloc_ports(a))
            for node_id, allocs in plan.node_allocation.items()
            for a in allocs}


def spread(times_s) -> dict:
    """Median, least, most and spread (most - least) of host-clock
    times, ms, and the runs themselves."""
    ms = [t * 1e3 for t in times_s]
    return dict(median_ms=statistics.median(ms), min_ms=min(ms),
                max_ms=max(ms), spread_ms=max(ms) - min(ms), runs_ms=ms)


@contextlib.contextmanager
def finish_variant(native_on: bool, seed: int, uuids: list, starts: list):
    """Evals finished inside run the native prefix (``native_on``) or the
    Python tail alone, switched through ``torch_binpack._native_bulk``,
    the seam the parity tests use; Python's ``random`` (each plan's port
    LCG seed) is seeded with ``seed`` and the uuids come from ``uuids``,
    so both variants draw the same streams; each finish's (native resume
    index, placements) goes into ``starts``."""
    from nomad_tpu_torch.scheduler import batch, torch_binpack

    cls = torch_binpack.TorchBinPackScheduler
    saved = (torch_binpack._native_bulk, torch_binpack.generate_uuids,
             batch.generate_uuids, cls.__dict__["_finish_python_tail"])
    tail = saved[3]

    def recorded_tail(self, fs):
        starts.append((fs.start_p, len(fs.place)))
        return tail(self, fs)

    def fixed_uuids(n):
        require(n <= len(uuids), f"{n} uuids asked, {len(uuids)} made")
        return list(uuids[:n])

    if not native_on:
        torch_binpack._native_bulk = lambda: None
    torch_binpack.generate_uuids = batch.generate_uuids = fixed_uuids
    cls._finish_python_tail = recorded_tail
    state = random.getstate()
    random.seed(seed)
    try:
        yield
    finally:
        random.setstate(state)
        (torch_binpack._native_bulk, torch_binpack.generate_uuids,
         batch.generate_uuids) = saved[:3]
        cls._finish_python_tail = tail


def alternating(reps: int):
    """Variant order (native first?) for ``reps`` rounds: native, tail;
    tail, native; ... so neither variant always runs first."""
    for i in range(reps):
        yield (True, False) if i % 2 == 0 else (False, True)


def native_finish_eval(torch, structs, h, job, reps=5):
    """Config 4's second 1,000-group job on ``h`` (which holds the first
    job's allocs), finished with the native prefix and with the Python
    tail alone, in turns, ``reps`` times each after one warm eval each.
    Every eval runs on the same snapshot with a record-only planner, so
    the store is in the same state for each; the finish
    (``finish_deferred``) and the eval are timed on the host clock,
    outside torch.profiler.  The plans must be equal (nodes and ports)
    and the native variant must finish every placement in C."""
    from nomad_tpu_torch.scheduler import TorchBinPackScheduler

    h.state.upsert_job(h.next_index(), job)
    snap = h.snapshot()
    n_place = sum(tg.count for tg in job.task_groups)
    uuids = structs.generate_uuids(n_place)

    def one(native_on):
        starts: list = []
        planner = RecordOnlyPlanner(structs)
        sched = TorchBinPackScheduler(snap, planner, batch=False,
                                      device=DEV)
        finish = sched.finish_deferred
        spent: list = []

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return finish(*a, **kw)
            finally:
                spent.append(time.perf_counter() - t)
        sched.finish_deferred = timed
        with finish_variant(native_on, 4, uuids, starts):
            t = time.perf_counter()
            sched.process(make_eval(structs, job))
            wall = time.perf_counter() - t
        require(len(planner.plans) == 1 and len(spent) == 1,
                "native finish: the eval did not finish one plan")
        want_start = n_place if native_on else 0
        require(starts == [(want_start, n_place)],
                f"native finish ({'native' if native_on else 'tail'}): "
                f"resumed at {starts}, want {want_start} of {n_place}")
        return spent[0], wall, plan_placements(planner.plans[0])

    want = {v: one(v)[2] for v in (True, False)}  # warm, both variants
    require(want[True] == want[False],
            "native finish: native and Python-tail plans differ")
    require(len(want[True]) == n_place,
            f"native finish: {len(want[True])} of {n_place} placed")
    finish_s = {True: [], False: []}
    eval_s = {True: [], False: []}
    for order in alternating(reps):
        for v in order:
            f, wall, placed = one(v)
            require(placed == want[True],
                    "native finish: a rerun placed differently")
            finish_s[v].append(f)
            eval_s[v].append(wall)
    native, tail = spread(finish_s[True]), spread(finish_s[False])
    return dict(placements=n_place, native_start_p=n_place, reps=reps,
                native_finish=native, python_finish=tail,
                python_over_native=tail["median_ms"] / native["median_ms"],
                native_eval=spread(eval_s[True]),
                python_eval=spread(eval_s[False]))


def run_slice(torch):
    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.models import fleet
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.scheduler import Harness

    counters = (binpack.place_sequence, binpack.place_rounds,
                fleet.scatter_rows)
    for fn in counters:
        fn.launches = 0
    times: list = []

    # 10,000 nodes x one 1,000-task-group job (config 4).
    t0 = time.perf_counter()
    big = Harness(device="cuda")
    for i in range(10_000):
        big.state.upsert_node(big.next_index(), mock.node(i))
    setup_s = time.perf_counter() - t0
    job4 = mock.job()
    job4.task_groups = [bench_task_group(structs, f"tg-{g}")
                        for g in range(1000)]
    nodes = [mock.node(i) for i in range(1000)]
    # K3's launches are recorded as they happen (a copy of the first
    # launch's inputs at each shape) for the replay below.
    rounds_calls: dict = {}
    binpack.place_rounds = RoundsRecording(counters[1], rounds_calls)
    try:
        placed4, failed4 = run_eval(structs, big, job4, times)
        small = small_cluster(mock, structs, Harness, nodes, times)
    finally:
        binpack.place_rounds = counters[1]
    require(len(placed4) == 1000 and not failed4,
            f"config 4: {len(placed4)} placed, {len(failed4)} failed")
    for placed, failed in small[:3]:
        require(len(placed) == 40 and not failed,
                f"config 2: {len(placed)} placed, {len(failed)} failed")
        require(len(set(placed.values())) == 40,
                "config 2: distinct_hosts broken")
    require(len(small[3][0]) == 24 and not small[3][1],
            "sequence job not fully placed")
    launches = {fn.__name__: fn.launches for fn in counters}
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the main path")

    # A second 1,000-group job on the 10,000-node cluster: first the
    # native prefix against the Python tail on the cluster as the first
    # job left it (record-only), then profiled and committed.
    job4b = mock.job()
    job4b.id = "config4-second"
    job4b.task_groups = [bench_task_group(structs, f"tg-{g}")
                         for g in range(1000)]
    native4 = native_finish_eval(torch, structs, big, job4b)
    print("native finish config 4: " + json.dumps(native4), flush=True)
    profile = phase_breakdown(torch, structs, big, job4b)
    require(len(big.plans[-1].failed_allocs) == 0,
            "second config-4 job left allocs unplaced")

    # The same 1,000-node run through the plain versions on the card,
    # keeping the inputs of its sequence walks: the placements are the
    # same, so they are those of the main path's K2 launch.
    seq_calls: list = []
    saved = (binpack.place_sequence, binpack.place_rounds,
             fleet.scatter_rows)
    binpack.place_sequence = recording(binpack.place_sequence_plain,
                                       seq_calls)
    binpack.place_rounds = binpack.place_rounds_plain
    fleet.scatter_rows = fleet.scatter_rows_plain
    try:
        plain = small_cluster(mock, structs, Harness, nodes, [])
    finally:
        (binpack.place_sequence, binpack.place_rounds,
         fleet.scatter_rows) = saved
    require([p for p, _f in small] == [p for p, _f in plain],
            "slice placements differ from the plain versions' run")
    require(len(seq_calls) == launches["place_sequence"],
            f"the plain rerun walked {len(seq_calls)} sequences, the "
            f"main path {launches['place_sequence']}")
    main_seq = main_path_sequence(torch, binpack, seq_calls[0])
    require(sum(c[2] for c in rounds_calls.values())
            == launches["place_rounds"],
            "the recorded K3 launches are not the main path's")
    main_rounds = main_path_rounds(torch, binpack, rounds_calls)
    return dict(launches=launches, evals=len(times),
                placements=len(placed4) + sum(len(p) for p, _f in small),
                eval_ms_median=statistics.median(times) * 1e3,
                eval_ms_max=max(times) * 1e3,
                config4_eval_ms=times[0] * 1e3, node_setup_s=setup_s,
                native_finish=native4, profiled_config4_eval=profile,
                main_path_sequence=main_seq, main_path_rounds=main_rounds)


def recording(fn, calls):
    """``fn``, keeping a copy of each call's positional inputs in
    ``calls``."""
    def recorded(*a, **kw):
        calls.append(tuple(x.clone() if hasattr(x, "clone") else x
                           for x in a))
        return fn(*a, **kw)
    return recorded


class RoundsRecording:
    """K3 or K4a (``fn``), counting each launch by its shape in
    ``calls`` (shape -> [positional inputs, keywords, launches]) and
    keeping a copy of the first launch's inputs at each shape; its
    ``launches`` are ``fn``'s own."""

    def __init__(self, fn, calls) -> None:
        self.fn = fn
        self.calls = calls

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int) -> None:
        # the wrapper counts through its module name, which is this now
        self.fn.launches = value

    def __call__(self, *a, **kw):
        key = (self.fn.__name__, a[0].shape[0], tuple(a[4].shape[:-1]),
               kw["k_cap"], kw["rounds"])
        if key not in self.calls:
            self.calls[key] = [tuple(x.clone() if hasattr(x, "clone")
                                     else x for x in a), dict(kw), 0]
        self.calls[key][2] += 1
        return self.fn(*a, **kw)


def main_path_rounds(torch, binpack, calls, reps=20):
    """K3/K4a at each shape the main path launched them (``calls`` from
    RoundsRecording): the first launch at each shape replayed on its
    inputs, held to the plain version bit for bit on the rule's path and
    on each top-k path forced, timed with CUDA events beside the plain
    version, the ``torch.topk`` yardstick and the bound."""
    out = []
    for (name, n, lead, k_cap, rounds), (args, kw, count) in calls.items():
        kernel = getattr(binpack, name)
        plain = getattr(binpack, name + "_plain")
        what = f"{name} main path N={n} {list(lead)} k={k_cap}"
        want = plain(*args, **kw)
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        err = compare(torch, what, got, want)
        path, paths_ms = rounds_paths(torch, binpack, what,
                                      lambda: kernel(*args, **kw), want, n,
                                      k_cap, reps)
        counts_h = args[7].cpu().numpy().reshape(-1, lead[-1])
        chosen = want[0].cpu().numpy().reshape(counts_h.shape[0], lead[-1],
                                               -1)
        g = lead[-1]
        ran = sum(rounds_run(counts_h[b], chosen[b], rounds, k_cap)
                  for b in range(counts_h.shape[0]))
        lane_extra = 4 if len(lead) == 2 else 0  # K4a: the lane's penalty
        nbytes = shared_fleet_bytes(n) + sum(
            lane_extra + rounds_lane_bytes(n, counts_h[b], g * rounds * k_cap)
            for b in range(counts_h.shape[0]))
        b_ms, b_by = bound(nbytes, ran * n * OPS_PER_NODE)
        row = dict(kernel=name, n=n, lanes=lead[0] if len(lead) == 2 else 1,
                   groups=g, k_cap=k_cap, rounds=rounds, launches=count,
                   placed=int((chosen >= 0).sum()), rounds_run=ran,
                   path=path, ms=paths_ms[path], paths_ms=paths_ms,
                   plain_ms=time_ms(torch, lambda: plain(*args, **kw), 1),
                   select_library_ms=select_library_ms(torch, binpack, args,
                                                       k_cap, reps),
                   bound_ms=b_ms, bound_by=b_by, err=err)
        print("main path " + json.dumps(row), flush=True)
        out.append(row)
    return out


def main_path_sequence(torch, binpack, args, reps=50):
    """K2 at the main path's own launch (``args``, recorded from the
    slice's sequence job) beside K4b at B=1 on the same inputs: one
    cluster body, launched as K2 and as a one-lane batch.  Both are held
    to the plain version bit for bit and timed with CUDA events in one
    loop order (K2, K4b, K4b, K2)."""
    (cap, res, usage0, jc0, feas, asks, dist, group_idx, valid,
     penalty) = args
    n, g, p = cap.shape[0], feas.shape[0], group_idx.shape[0]
    want = binpack.place_sequence_plain(*args, with_job_counts=True)
    got = binpack.place_sequence(*args, with_job_counts=True)
    pen = torch.tensor([float(penalty)], dtype=torch.float32, device=DEV)
    lane = (cap, res, usage0, jc0[None], feas[None], asks[None], dist[None],
            group_idx[None], valid[None], pen)
    one = binpack.place_sequence_batch(*lane)
    torch.cuda.synchronize()
    what = f"place_sequence main path N={n} G={g} P={p}"
    err = compare(torch, what, got[:3], want[:3])
    require(torch.equal(got[3], want[3]), f"{what}: job counts differ")
    err = max(err, compare(torch, what + " as K4b B=1",
                           [x[0] for x in one], want[:3]))
    k2_a = time_ms(torch, lambda: binpack.place_sequence(*args), reps)
    b1_a = time_ms(torch, lambda: binpack.place_sequence_batch(*lane),
                   reps)
    b1_b = time_ms(torch, lambda: binpack.place_sequence_batch(*lane),
                   reps)
    k2_b = time_ms(torch, lambda: binpack.place_sequence(*args), reps)
    gi_h = group_idx.cpu().numpy()
    chosen_h = want[0].cpu().numpy()
    nbytes = shared_fleet_bytes(n) + sequence_lane_bytes(
        n, gi_h, valid.cpu().numpy())
    b_ms, b_by = bound(nbytes, sequence_ops(n, g, gi_h, chosen_h))
    plan = binpack.sequence_plan(n, g, DEV)
    return dict(n=n, groups=g, steps=p, placed=int((chosen_h >= 0).sum()),
                cluster=plan[0], slots=plan[1],
                mode=binpack.SEQ_MODES[plan[2]], ms=(k2_a + k2_b) / 2,
                ms_runs=[k2_a, k2_b], k4b_b1_ms=(b1_a + b1_b) / 2,
                k4b_b1_runs=[b1_a, b1_b], bound_ms=b_ms, bound_by=b_by,
                err=err)


# -- phase 5: the fused storm ----------------------------------------------


class RecordOnlyPlanner:
    """bench.py _RecordOnlyPlanner: accepts every plan as fully committed
    WITHOUT applying it to state, so repeated storms all see the
    identical snapshot."""

    def __init__(self, structs) -> None:
        self.structs = structs
        self.plans = []

    def submit_plan(self, plan):
        self.plans.append(plan)
        return self.structs.PlanResult(
            node_update=plan.node_update,
            node_allocation=plan.node_allocation,
            failed_allocs=plan.failed_allocs), None

    def update_eval(self, ev) -> None:
        pass

    def create_eval(self, ev) -> None:
        pass


def make_eval(structs, job):
    return structs.Evaluation(
        id=structs.generate_uuid(), priority=job.priority, type=job.type,
        triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER, job_id=job.id)


def storm_jobs(mock, structs, prefix, n_jobs, n_groups):
    """bench.py _bench_job, ``n_jobs`` times: one service job of
    ``n_groups`` config-4 task groups, its id fixed by ``prefix``."""
    jobs = []
    for k in range(n_jobs):
        j = mock.job()
        j.id = f"{prefix}-{k}"
        j.task_groups = [bench_task_group(structs, f"tg-{g}")
                         for g in range(n_groups)]
        jobs.append(j)
    return jobs


def storm_config5(torch, mock, structs, binpack, Harness, BatchEvalRunner,
                  n_nodes=10_000, n_jobs=64, n_groups=1000):
    """bench.py config 5: 64 evals x 1,000 groups on 10,000 nodes, with
    the record-only planner.  Three storms on one snapshot: the first
    cold (fleet tensors, masks, prep caches), the second timed by host
    phase, the third inside ``device_timeline`` for the card's busy
    time.  Returns the results and (snapshot, jobs) for
    ``native_finish_storm``."""
    h = Harness(device=DEV)
    for i in range(n_nodes):
        h.state.upsert_node(h.next_index(), mock.node(i))
    jobs = storm_jobs(mock, structs, "config5", n_jobs, n_groups)
    for j in jobs:
        h.state.upsert_job(h.next_index(), j)
    snap = h.snapshot()

    def storm():
        planner = RecordOnlyPlanner(structs)
        before = binpack.place_rounds_batch.launches
        t = time.perf_counter()
        BatchEvalRunner(snap, planner, device=DEV).process(
            [make_eval(structs, j) for j in jobs])
        wall = time.perf_counter() - t
        require(binpack.place_rounds_batch.launches - before == 1,
                "config 5: the storm was not ONE place_rounds_batch launch")
        require(len(planner.plans) == n_jobs,
                f"config 5: {len(planner.plans)} plans, want {n_jobs}")
        for plan in planner.plans:
            placed = sum(len(v) for v in plan.node_allocation.values())
            require(placed == n_groups and not plan.failed_allocs,
                    f"config 5: a plan placed {placed}, failed "
                    f"{len(plan.failed_allocs)}")
        return wall
    cold_s = storm()
    spent, restore = timed_phases([(BatchEvalRunner, name) for name in (
        "_begin_eval", "_dispatch_fused", "_finish_lanes",
        "_submit_window")])
    try:
        warm_s = storm()
    finally:
        restore()
    busy_ms, top, profiled_s = device_busy_ms(torch, storm)
    require(busy_ms is not None,
            "config 5: no device time measured in the storm")
    phases_ms = {"begin": spent["_begin_eval"] * 1e3,
                 "dispatch": spent["_dispatch_fused"] * 1e3,
                 "finish": spent["_finish_lanes"] * 1e3,
                 "submit": spent["_submit_window"] * 1e3}
    phases_ms["other"] = warm_s * 1e3 - sum(phases_ms.values())
    return dict(evals=n_jobs, placements=n_jobs * n_groups,
                cold_wall_s=cold_s, wall_s=warm_s,
                evals_per_s=n_jobs / warm_s,
                phases_ms=phases_ms,
                profiled_storm_s=profiled_s,
                profiled_storm_device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / (profiled_s * 1e3),
                device_top_ms=top), (snap, jobs)


def native_finish_storm(structs, BatchEvalRunner, snap, jobs, n_groups,
                        reps=5):
    """The config-5 storm's ``_finish_lanes`` with the native prefix (ONE
    bulk_finish_many call for the 64 lanes) and with the 64 Python tails
    alone, in turns, ``reps`` times each, on one snapshot with the
    record-only planner (the storms before warmed every cache); host
    clock, outside torch.profiler.  The plans of each variant's first
    storm must be equal lane by lane (nodes and ports) and every native
    lane must finish all its placements in C."""
    n_place = len(jobs) * n_groups
    uuids = structs.generate_uuids(n_place)

    def one(native_on, compare=False):
        starts: list = []
        planner = RecordOnlyPlanner(structs)
        spent, restore = timed_phases([(BatchEvalRunner, "_finish_lanes")])
        try:
            with finish_variant(native_on, 5, uuids, starts):
                BatchEvalRunner(snap, planner, device=DEV).process(
                    [make_eval(structs, j) for j in jobs])
        finally:
            restore()
        want_start = n_groups if native_on else 0
        require(len(starts) == len(jobs) and all(
            st == (want_start, n_groups) for st in starts),
            f"native finish config 5 "
            f"({'native' if native_on else 'tail'}): lanes resumed at "
            f"{sorted(set(starts))}, want {want_start} of {n_groups}")
        lanes = [plan_placements(p) for p in planner.plans] \
            if compare else None
        return spent["_finish_lanes"], lanes

    finish_s = {True: [], False: []}
    lanes: dict = {}
    for order in alternating(reps):
        for v in order:
            spent, placed = one(v, compare=v not in lanes)
            finish_s[v].append(spent)
            if placed is not None:
                lanes[v] = placed
    require(len(lanes[True]) == len(jobs) and all(
        len(lane) == n_groups for lane in lanes[True]),
        "native finish config 5: a lane left placements unplaced")
    require(lanes[True] == lanes[False],
            "native finish config 5: native and Python-tail plans differ")
    native, tail = spread(finish_s[True]), spread(finish_s[False])
    return dict(lanes=len(jobs), placements=n_place,
                native_start_p=n_groups, reps=reps, native_finish=native,
                python_finish=tail,
                python_over_native=tail["median_ms"] / native["median_ms"])


def storm_config5b(mock, structs, Harness, VerifyingPlanner,
                   BatchEvalRunner, n_nodes=160, n_jobs=64, n_groups=100):
    """bench.py config 5b: 64 evals x 100 groups on 160 nodes through
    the verifying applier with state_refresh.  Returns the committed
    placements ((job, alloc name) -> (node name, ports)) and the
    applier's counts; fails if any node ends oversubscribed.  Python's
    ``random``, which seeds each plan's dynamic ports (and so the port
    collisions between lanes), is seeded first, so two runs of equal
    kernels commit equal placements."""
    random.seed(5)
    h = Harness(device=DEV)
    for i in range(n_nodes):
        h.state.upsert_node(h.next_index(), mock.node(i))
    jobs = storm_jobs(mock, structs, "config5b", n_jobs, n_groups)
    for j in jobs:
        h.state.upsert_job(h.next_index(), j)
    h.planner = VerifyingPlanner(h)
    t = time.perf_counter()
    BatchEvalRunner(h.snapshot(), h.planner, state_refresh=h.snapshot,
                    device=DEV).process(
        [make_eval(structs, j) for j in jobs])
    wall = time.perf_counter() - t
    names = {n.id: n.name for n in h.state.nodes()}
    placed = {(a.job_id, a.name): (names[a.node_id], tuple(
        p for tr in a.task_resources.values() for n in tr.networks
        for p in n.reserved_ports))
        for a in h.state.allocs() if a.node_id and not a.terminal_status()}
    for node in h.state.nodes():
        live = [a for a in h.state.allocs_by_node(node.id)
                if not a.terminal_status()]
        fit, dim, _ = structs.allocs_fit(node, live)
        require(fit, f"config 5b: node {node.name} oversubscribed on {dim}")
    vp = h.planner
    return placed, dict(evals=n_jobs, wall_s=wall,
                        evals_per_s=n_jobs / wall,
                        placed=len(placed), conflicts=vp.conflicts,
                        commits=vp.commits,
                        plans_per_commit=vp.committed_plans /
                        max(1, vp.commits),
                        conflict_fallbacks=vp.conflict_fallbacks)


def fleet_sequence_job(mock, structs):
    """Small asks that only the ten nodes named node-0 .. node-9 may
    take, 200 copies: a slot that needs 20 rounds (200 copies over 10
    fitting nodes) where the rounds kernels take at most 16, so
    ``_fit_rounds`` finds the job not rounds-eligible and the sequence
    kernel takes it, on the whole fleet's node axis."""
    j = mock.job()
    j.id = "fleet-sequence-job"
    tg = j.task_groups[0]
    tg.count = 200
    tg.constraints = [structs.Constraint(
        hard=True, l_target="$node.name", r_target="^node-[0-9]$",
        operand="regexp")]
    tg.tasks[0].resources = structs.Resources(
        cpu=100, memory_mb=64,
        networks=[structs.NetworkResource(mbits=5, dynamic_ports=["http"])])
    return j


def storm_sequence(mock, structs, Harness, BatchEvalRunner, nodes,
                   make_job=None, prefix="sequence-storm"):
    """8 jobs that are not rounds-eligible (the slice's ``sequence_job``
    shape by default) on ``nodes``, fused, committed through the
    harness's direct apply; every copy must be placed."""
    make_job = make_job or sequence_job
    h = Harness(device=DEV)
    for node in nodes:
        h.state.upsert_node(h.next_index(), node.copy())
    jobs = []
    for k in range(8):
        j = make_job(mock, structs)
        j.id = f"{prefix}-{k}"
        h.state.upsert_job(h.next_index(), j)
        jobs.append(j)
    copies = sum(tg.count for tg in jobs[0].task_groups)
    t = time.perf_counter()
    BatchEvalRunner(h.snapshot(), h, device=DEV).process(
        [make_eval(structs, j) for j in jobs])
    wall = time.perf_counter() - t
    placed = sum(len(v) for p in h.plans for v in p.node_allocation.values())
    require(placed == 8 * copies,
            f"{prefix} placed {placed} of {8 * copies}")
    return dict(evals=8, nodes=len(nodes), wall_s=wall, placed=placed)


def window_records():
    """Wrap the port's evaluate_window to record each window's
    ``info["device"]``; returns (records, restore function)."""
    from nomad_tpu_torch.ops import plan_conflict

    records: list = []
    orig = plan_conflict.evaluate_window

    def recorded(*a, **kw):
        out = orig(*a, **kw)
        records.append(out.info.get("device") if out.info else None)
        return out
    plan_conflict.evaluate_window = recorded

    def restore():
        plan_conflict.evaluate_window = orig
    return records, restore


def run_storm(torch, sizes5=(), sizes5b=(), n_seq_nodes=1000,
              n_fleet_nodes=10_000):
    """The storm phase.  The sizes default to the configurations'; a
    rehearsal passes smaller ones."""
    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.models import fleet
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.ops.verify_policy import verify_override
    from nomad_tpu_torch.parallel import mesh
    from nomad_tpu_torch.scheduler import (BatchEvalRunner, Harness,
                                           VerifyingPlanner)

    counters = (binpack.place_sequence, binpack.place_rounds,
                fleet.scatter_rows, binpack.place_rounds_batch,
                binpack.place_sequence_batch)
    for fn in counters:
        fn.launches = 0
    nodes = [mock.node(i) for i in range(n_seq_nodes)]
    fleet_nodes = [mock.node(i) for i in range(n_fleet_nodes)]
    # K3's and K4a's launches are recorded as they happen (a copy of the
    # first launch's inputs at each shape) for the replay below.
    rounds_calls: dict = {}
    binpack.place_rounds = RoundsRecording(counters[1], rounds_calls)
    binpack.place_rounds_batch = RoundsRecording(counters[3], rounds_calls)
    try:
        c5, world5 = storm_config5(torch, mock, structs, binpack, Harness,
                                   BatchEvalRunner, *sizes5)
        placed5b, c5b = storm_config5b(mock, structs, Harness,
                                       VerifyingPlanner, BatchEvalRunner,
                                       *sizes5b)
        seq = storm_sequence(mock, structs, Harness, BatchEvalRunner, nodes)
        seq_fleet = storm_sequence(mock, structs, Harness, BatchEvalRunner,
                                   fleet_nodes, fleet_sequence_job,
                                   "fleet-sequence-storm")
    finally:
        binpack.place_rounds = counters[1]
        binpack.place_rounds_batch = counters[3]
    require(c5b["conflicts"] > 0, "config 5b was not contended")
    if not sizes5b:
        for k, v in CONFIG5B_COUNTS.items():
            require(c5b[k] == v, f"config 5b: {k} {c5b[k]}, expected {v}")
    launches = {fn.__name__: fn.launches for fn in counters}
    require(sum(c[2] for c in rounds_calls.values())
            == launches["place_rounds"] + launches["place_rounds_batch"],
            "the recorded K3/K4a launches are not the storm's")
    for name in ("place_rounds_batch", "place_sequence_batch"):
        require(launches[name] > 0, f"{name} was not launched by the storm")
    # The finish comparison's storms run after the counts were read.
    c5["native_finish"] = native_finish_storm(
        structs, BatchEvalRunner, *world5, c5["placements"] // c5["evals"])
    print("native finish config 5: " + json.dumps(c5["native_finish"]),
          flush=True)

    # Config 5b again, through the plain versions on the card.
    saved = (binpack.place_sequence, binpack.place_rounds,
             fleet.scatter_rows, binpack.place_rounds_batch,
             binpack.place_sequence_batch)
    binpack.place_sequence = binpack.place_sequence_plain
    binpack.place_rounds = binpack.place_rounds_plain
    fleet.scatter_rows = fleet.scatter_rows_plain
    binpack.place_rounds_batch = binpack.place_rounds_batch_plain
    binpack.place_sequence_batch = binpack.place_sequence_batch_plain
    try:
        plain5b, _ = storm_config5b(mock, structs, Harness,
                                    VerifyingPlanner, BatchEvalRunner,
                                    *sizes5b)
    finally:
        (binpack.place_sequence, binpack.place_rounds, fleet.scatter_rows,
         binpack.place_rounds_batch, binpack.place_sequence_batch) = saved
    require(placed5b == plain5b,
            "config 5b placements differ from the plain versions' run")

    # Config 5b under the device verify policy: every window's base fit
    # and overlay fold in K6 on the card; the same commits as (b).
    mesh.window_verify.launches = 0
    records, restore = window_records()
    try:
        with verify_override("device"):
            dev5b_placed, dev5b = storm_config5b(
                mock, structs, Harness, VerifyingPlanner, BatchEvalRunner,
                *sizes5b)
    finally:
        restore()
    launches["window_verify"] = mesh.window_verify.launches
    require(launches["window_verify"] > 0,
            "config 5b under device: window_verify was not launched")
    require(dev5b_placed == placed5b,
            "config 5b under device commits other placements than host")
    for k in ("placed", "conflicts", "commits", "conflict_fallbacks"):
        require(dev5b[k] == c5b[k], f"config 5b under device: {k} "
                f"{dev5b[k]}, host {c5b[k]}")
    dev5b["windows"] = len(records)
    dev5b["dispatched"] = sum(1 for r in records if r and r["dispatched"])
    for r in records:
        require(not (r and r["dispatched"])
                or (r["h2d"], r["d2h"]) == WINDOW_TRANSFERS[DEV],
                f"config 5b under device: a window made {r and r['h2d']} "
                f"uploads and {r and r['d2h']} fetches, want one each")
    fallbacks: dict = {}
    for r in records:
        if r and not r["dispatched"]:
            fallbacks[r["fallback"]] = fallbacks.get(r["fallback"], 0) + 1
    dev5b["fallbacks"] = fallbacks
    dev5b["buckets"] = sorted({r["bucket"] for r in records
                               if r and r["dispatched"]})
    # The sequence storms' K4b launches, their inputs kept from a rerun
    # of (c) through the plain version (the same fresh snapshot, so the
    # same inputs), replayed and timed.
    batch_calls: list = []
    binpack.place_sequence_batch = recording(
        binpack.place_sequence_batch_plain, batch_calls)
    try:
        storm_sequence(mock, structs, Harness, BatchEvalRunner, nodes)
        storm_sequence(mock, structs, Harness, BatchEvalRunner, fleet_nodes,
                       fleet_sequence_job, "fleet-sequence-storm")
    finally:
        binpack.place_sequence_batch = saved[4]
    require(len(batch_calls) == launches["place_sequence_batch"] == 2,
            f"the plain reruns made {len(batch_calls)} K4b calls, the main "
            f"path {launches['place_sequence_batch']}, want one a storm")
    seq["main_path_sequence_batch"] = main_path_sequence_batch(
        torch, binpack, batch_calls[0])
    seq_fleet["main_path_sequence_batch"] = main_path_sequence_batch(
        torch, binpack, batch_calls[1], reps=10)
    return dict(launches=launches, config5=c5, config5b=c5b,
                config5b_device=dev5b, sequence_storm=seq,
                fleet_sequence_storm=seq_fleet,
                main_path_rounds=main_path_rounds(torch, binpack,
                                                  rounds_calls))


def main_path_sequence_batch(torch, binpack, args, reps=50):
    """K4b at the main path's own launch (``args``, recorded from the
    sequence storm), held to its plain version bit for bit and timed
    with CUDA events."""
    n, (b, g), p = args[0].shape[0], args[4].shape[:2], args[7].shape[1]
    want = binpack.place_sequence_batch_plain(*args)
    got = binpack.place_sequence_batch(*args)
    torch.cuda.synchronize()
    err = compare(torch, f"place_sequence_batch main path N={n} B={b} "
                  f"G={g} P={p}", got, want)
    ms = time_ms(torch, lambda: binpack.place_sequence_batch(*args), reps)
    gi_h, valid_h = args[7].cpu().numpy(), args[8].cpu().numpy()
    chosen_h = want[0].cpu().numpy()
    nbytes = shared_fleet_bytes(n) + sum(
        4 + sequence_lane_bytes(n, gi_h[k], valid_h[k]) for k in range(b))
    b_ms, b_by = bound(nbytes, sum(sequence_ops(n, g, gi_h[k], chosen_h[k])
                                   for k in range(b)))
    plan = binpack.sequence_batch_plan(n, g, b, DEV)
    return dict(n=n, lanes=b, groups=g, steps=p,
                placed=int((chosen_h >= 0).sum()), cluster=plan[0],
                slots=plan[1], mode=binpack.SEQ_MODES[plan[2]], ms=ms,
                bound_ms=b_ms, bound_by=b_by, err=err)


# -- phase 6: the system schedulers (config 3) -----------------------------


def run_system(n_nodes=1000, reps=3):
    """bench.py config 3: ``mock.system_job()`` on 1,000 nodes through the
    vectorized ``system`` scheduler and the sequential ``system-seq``,
    in turns, one warm eval each and then ``reps`` timed ones, with the
    record-only planner (every eval sees one store).  Their plans must
    place the same task groups on the same nodes, every node must take
    the job, and ``system`` must finish every placement in the native
    prefix."""
    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.scheduler import Harness, system_vec

    h = Harness(device=DEV)
    for i in range(n_nodes):
        h.state.upsert_node(h.next_index(), mock.node(i))
    job = mock.system_job()
    job.id = "config3-system"
    h.state.upsert_job(h.next_index(), job)
    planner = RecordOnlyPlanner(structs)
    h.planner = planner
    starts: list = []
    real = system_vec.run_bulk_finish

    def recorded(*a, **kw):
        out = real(*a, **kw)
        starts.append(out[0])
        return out
    system_vec.run_bulk_finish = recorded
    names = ("system", "system-seq")
    times: dict = {name: [] for name in names}
    plans: dict = {}
    try:
        for i in range(reps + 1):
            for name in names if i % 2 == 0 else names[::-1]:
                t = time.perf_counter()
                h.process(name, make_eval(structs, job))
                wall = time.perf_counter() - t
                require(h.evals[-1].status == structs.EVAL_STATUS_COMPLETE,
                        f"config 3 {name}: eval ended {h.evals[-1].status}")
                plan = planner.plans[-1]
                got = ({node_id: sorted(a.task_group for a in allocs)
                        for node_id, allocs in plan.node_allocation.items()},
                       len(plan.failed_allocs))
                if i == 0:
                    plans[name] = got
                else:
                    require(got == plans[name],
                            f"config 3 {name}: a rerun planned otherwise")
                    times[name].append(wall)
    finally:
        system_vec.run_bulk_finish = real
    require(plans["system"] == plans["system-seq"],
            "config 3: system and system-seq plan differently")
    placed, failed = plans["system"]
    require(len(placed) == n_nodes and not failed,
            f"config 3: {len(placed)} nodes placed, {failed} failed")
    require(len(starts) == reps + 1 and all(st == n_nodes for st in starts),
            f"config 3: the native prefix resumed at {starts}, want "
            f"{n_nodes}")
    vec, seq = spread(times["system"]), spread(times["system-seq"])
    return dict(nodes=n_nodes, placed=len(placed), native_start_p=n_nodes,
                system_eval=vec, system_seq_eval=seq,
                seq_over_system=seq["median_ms"] / vec["median_ms"])


# -- phase 7: the verify engines over a growing fleet ----------------------


def result_key(result) -> tuple:
    return (
        {n: [a.id for a in v] for n, v in result.node_update.items()},
        {n: [a.id for a in v] for n, v in result.node_allocation.items()},
        [a.id for a in result.failed_allocs],
        result.refresh_index > 0)


def verify_fleet_size(n_nodes, windows, window_plans, seed, warm=2):
    """bench.py _verify_fleet_phase on the port, both engines on ONE
    store: a NodeSlab fleet of ``n_nodes`` with standing usage on
    min(2048, n/4) rng-sampled nodes, and ``warm + windows`` windows of
    ``window_plans`` single-placement plans on rng-sampled distinct
    nodes, made once.  Each engine verifies every window (nothing is
    committed, so both see the same state): the warm ones untimed, the
    rest timed with the heap frozen (gc.freeze, as bench.py does).
    Every timed device window must dispatch K6, and both engines must
    give the same verdicts and accepted alloc ids."""
    import gc

    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.ops.plan_conflict import evaluate_window
    from nomad_tpu_torch.ops.verify_policy import verify_override
    from nomad_tpu_torch.parallel import mesh
    from nomad_tpu_torch.state import StateStore

    t0 = time.perf_counter()
    store = StateStore()
    slab = mock.node_slab(n_nodes)
    store.upsert_node_slab(1, slab)
    node_ids = list(slab.ids)

    def alloc_on(nid):
        return structs.Allocation(
            id=structs.generate_uuid(), node_id=nid,
            job_id="bench-5f-fleet", task_group="web",
            resources=structs.Resources(cpu=100, memory_mb=64),
            desired_status=structs.ALLOC_DESIRED_STATUS_RUN,
            client_status=structs.ALLOC_CLIENT_STATUS_PENDING)

    rng = random.Random(seed)
    store.upsert_allocs(2, [alloc_on(nid) for nid in rng.sample(
        node_ids, min(2048, n_nodes // 4))])

    def window():
        plans = []
        for nid in rng.sample(node_ids, window_plans):
            plan = structs.Plan(eval_id=structs.generate_uuid())
            plan.append_alloc(alloc_on(nid))
            plans.append(plan)
        return plans
    wins = [window() for _ in range(warm + windows)]
    setup_s = time.perf_counter() - t0

    out: dict = {"fleet_nodes": n_nodes, "setup_s": setup_s}
    verdicts: dict = {}
    for policy in ("host", "device"):
        keys: list = []
        h2d = d2h = dispatched = 0
        with verify_override(policy):
            for w in wins[:warm]:
                evaluate_window(store, w, device=DEV)
            launches0 = mesh.window_verify.launches
            gc.collect()
            gc.freeze()
            try:
                t = time.perf_counter()
                for w in wins[warm:]:
                    res = evaluate_window(store, w, device=DEV)
                    dev = res.info.get("device") if res.info else None
                    if policy == "device":
                        require(dev is not None and dev["dispatched"],
                                f"verify fleet {n_nodes}: a device window "
                                f"did not dispatch: {dev}")
                        dispatched += 1
                        h2d += dev["h2d"]
                        d2h += dev["d2h"]
                    keys.append([result_key(o.result) for o in res])
                wall = time.perf_counter() - t
            finally:
                gc.unfreeze()
        verdicts[policy] = keys
        out[policy] = dict(
            serial_ms_per_plan=wall * 1e3 / (windows * window_plans),
            verify_ms=wall * 1e3 / windows, device_dispatches=dispatched,
            h2d_per_window=h2d / windows, d2h_per_window=d2h / windows,
            k6_launches=mesh.window_verify.launches - launches0)
    require(verdicts["host"] == verdicts["device"],
            f"verify fleet {n_nodes}: device verdicts differ from host")
    dev = out["device"]
    require((dev["h2d_per_window"], dev["d2h_per_window"])
            == WINDOW_TRANSFERS[DEV],
            f"verify fleet {n_nodes}: a device window made "
            f"{dev['h2d_per_window']} uploads and {dev['d2h_per_window']} "
            "fetches, want one each")
    accepted = sum(1 for w in verdicts["host"] for k in w if k[1])
    require(accepted == windows * window_plans,
            f"verify fleet {n_nodes}: {accepted} plans accepted of "
            f"{windows * window_plans}")
    return out


def run_verify_fleet(sizes=(10_000, 131_072, 1_000_000), windows=8,
                     window_plans=64):
    """The fleet-scaling phase (bench.py 5f sub-table sizes).  Reports
    the JAX bench's flatness ratio — device ms per plan at the largest
    fleet over the smallest (its bar was 1.5) — as a number only."""
    from nomad_tpu_torch.parallel import mesh

    mesh.window_verify.launches = 0
    table = {}
    for k, n in enumerate(sizes):
        table[str(n)] = row = verify_fleet_size(n, windows, window_plans,
                                                seed=9000 + k)
        print(f"verify fleet {n}: " + json.dumps(row), flush=True)
    launches = mesh.window_verify.launches
    require(launches > 0, "the verify-fleet phase launched no window_verify")
    first = table[str(sizes[0])]["device"]["serial_ms_per_plan"]
    last = table[str(sizes[-1])]["device"]["serial_ms_per_plan"]
    return dict(sizes=list(sizes), windows=windows,
                window_plans=window_plans, launches=launches,
                device_flatness=last / first, table=table)


# The kernels of the kernels phase, in the order it checks them.
KERNEL_NAMES = ("place_sequence", "place_rounds", "scatter_rows",
                "window_verify", "place_rounds_batch", "place_sequence_batch")


def kernel_checks(torch, binpack, fleet, mesh, seed=1234) -> dict:
    """Phase 3, one entry per kernel: name -> a function that runs that
    kernel's checks (printing each case) and returns them by case.  Each
    draws its inputs from its own generator, so a kernel's cases are the
    same whichever others run."""
    def gen(name):
        return np.random.default_rng([seed, KERNEL_NAMES.index(name)])

    def report(kernel, results):
        for name, r in results.items():
            print(f"kernel {kernel} {name}: " + json.dumps(r), flush=True)
        return results

    def sequence():
        rng = gen("place_sequence")
        # K2, bit for bit, at: its timed shape (three groups drawn at
        # random, the last 8 steps invalid) and its tie case; contiguous
        # group runs, as the main path lays a job out; a group change
        # every step over 8 groups (also under the one-cache and the
        # scratch plans the kernel takes at other sizes); the config-2
        # size the slice launches; 131,072 nodes; invalid steps inside
        # the walk and a long invalid tail; -0.0 usage entries.
        cases = {
            "N=16384 P=1024": dict(n=16384, p=1024),
            "N=16384 P=1024 ties": dict(n=16384, p=1024, uniform=True,
                                        groups=1),
            "N=16384 P=1024 runs G=8": dict(n=16384, p=1024, groups=8,
                                            order="runs"),
            "N=16384 P=1024 cycle G=8": dict(n=16384, p=1024, groups=8,
                                             order="cycle",
                                             other_plans=True),
            "N=1024 P=40 runs G=10": dict(n=1024, p=40, groups=10,
                                          order="runs", tail=0),
            "N=131072 P=256": dict(n=131072, p=256),
            "N=16384 P=1024 runs G=8 gaps": dict(n=16384, p=1024, groups=8,
                                                 order="runs", gaps=50,
                                                 tail=100),
            "N=16384 P=1024 -0.0": dict(n=16384, p=1024, neg_zero=True),
        }
        return report("place_sequence", {
            name: check_sequence(torch, binpack, kw.pop("n"), kw.pop("p"),
                                 rng, **kw)
            for name, kw in ((k, dict(v)) for k, v in cases.items())})

    # K3 and K4a (8 lanes) at each edge of the top-k select, both top-k
    # paths held too: k_cap equal to N, ties straddling the k_cap-th
    # key, 0.0 scores at it, fewer feasible nodes than k_cap, and N =
    # 32,768 (the keys at the shared-memory limit).  The uniform fleet
    # (every key in one histogram bin) and N = 131,072 (keys in device
    # memory) are the cases before them.
    hazards = {
        "k=N": dict(n=16384, k_cap=16384, uniform=True),
        "ties straddling": dict(n=16384, k_cap=1024, hazard="straddle"),
        "zeros at the k-th": dict(n=16384, k_cap=1024, hazard="zeros"),
        "fewer feasible than k": dict(n=16384, k_cap=1024,
                                      hazard="sparse"),
        "N=32768": dict(n=32768, k_cap=1024, uniform=True),
    }

    def rounds():
        rng = gen("place_rounds")
        out = {
            "N=16384 count=1000 k=1024": check_rounds(
                torch, binpack, 16384, 1000, 1024, 1, rng, True, 10),
            "N=16384 random rounds=2": check_rounds(
                torch, binpack, 16384, 1000, 1024, 2, rng, False, 10),
            "N=131072 count=1000 k=1024": check_rounds(
                torch, binpack, 131072, 1000, 1024, 1, rng, True, 3),
            # the slots past the job's padded, as config 4 launches it
            "N=16384 count=1000 k=1024 padded": check_rounds(
                torch, binpack, 16384, 1000, 1024, 1, rng, True, 10,
                padded=True),
        }
        for name, kw in hazards.items():
            kw = dict(kw)
            out[name] = check_rounds(
                torch, binpack, kw.pop("n"), 1000, kw.pop("k_cap"), 1, rng,
                kw.pop("uniform", False), 5, **kw)
        return report("place_rounds", out)

    def rounds_batch():
        rng = gen("place_rounds_batch")
        out = {
            "N=16384 B=64 count=1000 k=1024": check_rounds_batch(
                torch, binpack, 16384, 64, 1000, 1024, 1, rng, True, 10),
            "N=16384 B=16 random rounds=2": check_rounds_batch(
                torch, binpack, 16384, 16, 1000, 1024, 2, rng, False, 10),
            # slots 2.. padded, as config 5's lanes are launched
            "N=16384 B=64 count=1000 padded": check_rounds_batch(
                torch, binpack, 16384, 64, 1000, 1024, 1, rng, True, 10,
                padded=True),
        }
        for name, kw in hazards.items():
            kw = dict(kw)
            out[name] = check_rounds_batch(
                torch, binpack, kw.pop("n"), 8, 1000, kw.pop("k_cap"), 1,
                rng, kw.pop("uniform", False), 5, **kw)
        return report("place_rounds_batch", out)

    def scatter():
        rng = gen("scatter_rows")
        return report("scatter_rows", {
            "N=16384 R=1024": check_scatter(torch, fleet, 16384, 1024, rng,
                                            50)})

    def window():
        rng = gen("window_verify")
        # K6: the fleet-scaling window (64 single-placement plans, each
        # its own component, on the 1,000,000-node fleet's 1,048,576
        # rows); a contended window at config-5b scale (64 plans of 100
        # placements on 160 nodes in 4 components, evictions on a tenth
        # of the pairs); the worst case of the fold walk (2,048 plans of
        # 3 placements, every pair on node 0 in one component); a
        # window far smaller than its bucket (8 plans of 10 placements
        # padded to B=8,192); and removal entries on nodes no pair
        # claims (a fifth of the pairs evict on nodes 160-255).
        cases = {
            "N=1048576 B=64 (5f window)": (
                (1_000_000, 1_048_576, 64, 1, 64, 0.0), {}),
            "N=256 B=8192 (config-5b scale)": (
                (160, 256, 64, 100, 4, 0.1), {}),
            "N=256 B=8192 one node (worst case)": (
                (1, 256, 2048, 3, 1, 0.1), {}),
            "N=256 B=8192 sparse (80 rows)": (
                (160, 256, 8, 10, 4, 0.1), dict(bucket=8192)),
            "N=256 stray removals": (
                (160, 256, 64, 40, 4, 0.1),
                dict(stray=0.2, stray_nodes=(160, 256))),
        }
        return report("window_verify", {
            name: check_window_verify(torch, mesh, *a, rng,
                                      200 if a[0] > 10_000 else 50, **kw)
            for name, (a, kw) in cases.items()})

    def sequence_batch():
        rng = gen("place_sequence_batch")
        # K4b at K2's cases, at B=8 (P=256) and B=64 (P=64): ties on a
        # uniform fleet, runs of 8 groups, a group change every step,
        # more groups than score slots (G=40), 131,072 nodes (scratch
        # mode), invalid gaps and a long invalid tail, -0.0 usage
        # entries; the last lane of each is a pad lane.  The timed shape
        # of earlier PRs first, then the cases.
        out = {"N=16384 B=8 P=256": check_sequence_batch(
            torch, binpack, 16384, 8, 256, rng, 3)}
        cases = {
            "ties": dict(uniform=True, groups=1),
            "runs G=8": dict(groups=8, order="runs"),
            "cycle G=8": dict(groups=8, order="cycle"),
            "cycle G=40": dict(groups=40, order="cycle"),
            "scratch mode": dict(n=131072),
            "runs G=8 gaps": dict(groups=8, order="runs", gaps=10,
                                  tail=None),
            "-0.0": dict(neg_zero=True),
        }
        for lanes, p in ((8, 256), (64, 64)):
            for name, kw in cases.items():
                kw = dict(kw)
                n = kw.pop("n", 16384)
                if kw.get("tail", 8) is None:
                    kw["tail"] = p // 4
                out[f"N={n} B={lanes} P={p} {name}"] = check_sequence_batch(
                    torch, binpack, n, lanes, p, rng, 3, **kw)
        return report("place_sequence_batch", out)

    checks = (sequence, rounds, scatter, window, rounds_batch,
              sequence_batch)
    return dict(zip(KERNEL_NAMES, checks))


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    argv = list(argv)
    from nomad_tpu_torch.models import fleet
    from nomad_tpu_torch.ops import binpack, kernels
    from nomad_tpu_torch.parallel import mesh

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch: {torch.__version__} (CUDA {torch.version.cuda})",
          flush=True)
    if argv[:1] == ["--profiler-events"]:
        # The profiler check alone: no kernels, no result line.
        seconds = float(argv[1]) if len(argv) > 1 else 120.0
        print("profiler events: " + json.dumps(
            profiler_events(torch, seconds)), flush=True)
        return 0

    t0 = time.perf_counter()
    built = kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(built)) or 'up to date'})", flush=True)

    checks = kernel_checks(torch, binpack, fleet, mesh)
    if argv:
        # --only NAME[,NAME]: those kernels' checks alone; no main paths
        # and no result line.
        if len(argv) != 2 or argv[0] != "--only" or \
                not set(argv[1].split(",")) <= set(checks):
            print(f"usage: chip_smoke.py [--only {','.join(checks)}] "
                  f"[--profiler-events SECONDS]", file=sys.stderr)
            return 2
        for name in argv[1].split(","):
            checks[name]()
        print("chip_smoke: --only run, no result line", flush=True)
        return 0
    k = {}
    for name, fn in checks.items():
        t = time.perf_counter()
        k[name] = fn()
        print(f"phase kernels {name}: {time.perf_counter() - t:.1f} s",
              flush=True)
    seq = k["place_sequence"]["N=16384 P=1024"]
    rnd = k["place_rounds"]["N=16384 count=1000 k=1024"]
    sct = k["scatter_rows"]["N=16384 R=1024"]
    wv5f = k["window_verify"]["N=1048576 B=64 (5f window)"]
    rb = k["place_rounds_batch"]["N=16384 B=64 count=1000 k=1024"]
    sb = k["place_sequence_batch"]["N=16384 B=8 P=256"]

    def phase(name, fn):
        t = time.perf_counter()
        out = fn()
        print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
        return out
    sl = phase("slice", lambda: run_slice(torch))
    print("slice: " + json.dumps(sl), flush=True)
    st = phase("storm", lambda: run_storm(torch))
    print("storm: " + json.dumps(st), flush=True)
    sy = phase("system", run_system)
    print("system: " + json.dumps(sy), flush=True)
    vf = phase("verify fleet", run_verify_fleet)
    print("verify fleet: " + json.dumps(
        {k: v for k, v in vf.items() if k != "table"}), flush=True)
    # Launches on the main paths, each path counted from 0: the slice,
    # the storm (K6 in config 5b under the device policy) and the
    # verify-fleet phase.
    launches = {k: sl["launches"].get(k, 0) + st["launches"][k]
                for k in st["launches"]}
    launches["window_verify"] += vf["launches"]
    replay_err = {name: max([r["err"] for r in sl["main_path_rounds"]
                             + st["main_path_rounds"]
                             if r["kernel"] == name], default=0.0)
                  for name in ("place_rounds", "place_rounds_batch")}
    replay_err["place_sequence"] = sl["main_path_sequence"]["err"]
    replay_err["place_sequence_batch"] = max(
        st[storm]["main_path_sequence_batch"]["err"]
        for storm in ("sequence_storm", "fleet_sequence_storm"))
    timed = {"place_sequence": seq, "place_rounds": rnd,
             "scatter_rows": sct, "place_rounds_batch": rb,
             "place_sequence_batch": sb, "window_verify": wv5f}
    sources = {"scatter_rows": "scatter_rows.cu",
               "window_verify": "window_verify.cu"}
    replaces = {"place_sequence": "nomad_tpu/ops/binpack.py:78",
                "place_rounds": "nomad_tpu/ops/binpack.py:123",
                "scatter_rows": "nomad_tpu/models/fleet.py:1108",
                "place_rounds_batch": "nomad_tpu/ops/binpack.py:185",
                "place_sequence_batch": "nomad_tpu/ops/binpack.py:203",
                "window_verify": "nomad_tpu/parallel/mesh.py:357"}
    kernels_line = {"kernels": []}
    for name, r in timed.items():
        row = dict(
            name=name, route="cuda",
            source="nomad_tpu_torch/csrc/" + sources.get(name, "binpack.cu"),
            replaces=replaces[name], launches=launches[name],
            max_abs_err=max([c["err"] for c in k[name].values()]
                            + [replay_err.get(name, 0.0)]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"))
        if "device_ms" in r:
            row["device_ms"] = r["device_ms"]
        if "library_device_ms" in r:
            row["library_device_ms"] = r["library_device_ms"]
        kernels_line["kernels"].append(row)
    print(json.dumps(kernels_line), flush=True)
    print(card_line(), flush=True)  # as nvidia-smi prints it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        code = main(sys.argv[1:])
    except (SmokeError, AssertionError, RuntimeError, ImportError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        code = 1
    sys.exit(code)
