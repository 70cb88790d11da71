"""Chip smoke: build the port's CUDA kernels and drive its placement path on
one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase, the result line
    python3 chip_smoke.py --only NAME[,NAME]    # those kernels' checks alone
    python3 chip_smoke.py --profiler-events S   # does torch.profiler see
                                                # the card? (S seconds)
    python3 chip_smoke.py --executor            # the executor phase alone
    python3 chip_smoke.py --wire                # the wire phase alone
    python3 chip_smoke.py --wire-groups N       # ... at N groups a job
    python3 chip_smoke.py --client              # the client phase alone
    python3 chip_smoke.py --agent               # the agent phase alone
    python3 chip_smoke.py --failover            # the failover phase alone
    python3 chip_smoke.py --control             # the control phase alone
    python3 chip_smoke.py --mesh                # the mesh phase alone
    python3 chip_smoke.py --sanitizers          # the sanitizers phase alone

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
  6. server   the port's own Server (``Server(ServerConfig(device=
              "cuda"))``: raft, FSM, broker, one batch worker and a
              plain worker started just after leadership, the
              group-commit applier) with its nodes and jobs registered
              through raft before leadership, so the broker restore
              hands the batch worker every eval at once: (a) config 5b
              (64 jobs x 100 groups, 160 nodes) under the ``host`` and
              the ``device`` verify policy: 6,240 placements committed,
              K6 launched on every window of more than one plan under
              device; (b) config 5 at full width
              (64 jobs x 1,000 groups on 10,000 nodes: 64,000
              placements through InmemRaft and the slab wire), then a
              rounds-ineligible job (K4b) and ``mock.system_job()``
              (a plain worker, ``system``) on the live server; (c) the
              applier at bench 5f's shape (512 nodes, 256 submitter
              threads of 4 one-alloc plans with 10 s deadlines) under
              host and device verify.  Every eval complete, acked once,
              never nacked; no worker failure; every alloc placed once;
              no node over capacity.  Per shape: wall from the first
              job_register to the last eval complete, evals/s and
              placements/s, the applier's counts, raft applies, the
              card's busy ms and idle share (``device_timeline``), the
              host-clock breakdown (broker wait, worker batch, applier
              verify, commit, FSM apply) and every kernel's launches;
              the first launch at each shape of K2-K6 recorded and
              replayed against the plain version, bit for bit;
  7. wire     the port's Server with ``enable_rpc`` on the card, tracing
              on (``obs.trace``, a ring of 2^18 spans), driven over the
              wire: an ``AgentSwarm`` of 10,000 agents (bench.py 5d's
              fleet, or the fleet the measured registration rate
              sustains, printed beside it) registers mock nodes through
              ``Node.Register`` on shared mux sessions, heartbeats on its
              own sessions and parks one ``Node.GetAllocs`` long-poll per
              agent; a client thread sends config 5's 64 jobs through
              ``Job.Register``, at the widest of ``WIRE_WIDTHS`` groups
              whose full read of every node's allocations, measured on
              the wire before the fleet registers, fits
              ``WIRE_READ_BUDGET_S`` (each alloc of a reply embeds its
              job), printed beside 1,000.  Every eval complete;
              ``Node.GetAllocs`` for every node equal to the store; every
              node that received allocations saw them in its long-poll;
              no node left ``ready``; the serving threads are the
              dispatch workers + 1; every eval carries the span chain
              ``WIRE_CHAIN``; the registries carry their providers; one
              more job under ``utils/profiling.device_trace`` writes a
              non-empty trace; teardown leaves no waiter, connection or
              thread; the rates, the heartbeat p50/p99, the ``sched.*``
              stage rows and each span name's count, total and p50 from
              the spans, the card's busy ms and idle share, every
              kernel's launches, and the first launch at each kernel
              shape replayed against the plain version, bit for bit;
  8. client   32 real port Clients (``nomad_tpu_torch.client``: the
              whole fingerprint chain, so ``accel`` reads the card;
              ``raw_exec`` on; their own state and alloc dirs) register
              over the wire with the port's Server on the card, heartbeat
              and park one ``Node.GetAllocs`` long-poll each; through
              ``Job.Register``: a batch job of 256 raw_exec tasks that
              print their alloc's id, a job parsed from HCL by the port's
              ``jobspec`` (32 copies, ``distinct_hosts``, constrained to
              ``$attr.accel.platform = "gpu"``), and a service job of 64
              ``/bin/sleep 300`` tasks; one Client is shut down without
              touching its tasks and a new one on its state dir
              re-attaches to them (same PIDs, no second sleeper), then
              ``Job.Deregister`` kills every sleeper.  Every alloc of the
              first two jobs ``dead`` with its own id in its stdout log;
              every eval complete and acked once, each alloc placed once,
              no node over capacity; teardown leaves no thread, child
              process or connection; K3/K4a and K5 launched and each
              recorded launch replayed against its plain version, bit
              for bit; the registration wall, each job's wall to its
              last alloc dead, placements/s and allocs/s, the
              ``Node.UpdateAlloc`` calls, commit-to-client p50/p99, the
              re-attach wall, the launches and the card's busy ms;
  9. agent    SURVEY.md's canonical path (``run`` -> HTTP ``PUT
              /v1/jobs`` -> the agent's ``Job.Register`` -> the server ->
              placement on the card -> the client runs the task ->
              ``eval-monitor`` / ``alloc-status``): (a) in this process,
              ``Agent(AgentConfig.dev())`` on the card (the server with
              gossip, the HTTP API, its own client with ``raw_exec`` on
              ``dc2``); an ``AgentSwarm`` registers config 4's 10,000
              mock nodes (``dc1``) and heartbeats them, no long-poll;
              ``nomad_tpu_torch.cli`` ``run -detach`` submits config 4's
              1,000-group job written as HCL (K3/K4a at N=16,384, K5);
              ``alloc-status`` on one alloc; ``run`` of a raw_exec job of
              8 tasks on the agent's own node (``$attr.accel.platform``),
              each printing its alloc's id, then ``status``,
              ``eval-monitor``, ``alloc-status``, ``server-members``,
              ``/v1/agent/self`` and ``/v1/agent/metrics``, ``stop`` of
              both jobs.  Every eval complete, acked once, each alloc
              placed once, no node over capacity; every task ``dead``
              with its own id; no TTL expiry; one gossip member; K3/K4a
              and K5 launched and each recorded launch replayed against
              its plain version, bit for bit; teardown leaves no thread,
              child process or connection.  (b) ``python3 -m
              nomad_tpu_torch.cli agent -dev -http-port 0`` as a process
              of its own, on the card: ``cli run`` of a raw_exec job in a
              second process exits 0, ``status`` and ``alloc-status``
              read it back, nvidia-smi's count of contexts on the card
              is one higher while its tasks run, SIGHUP reloads
              ``log_level``, SIGTERM exits 0, leaves no task running
              and the count goes back down;
  10. failover bench.py config 5e's leader-kill failover at config 4's
              width on the card: three durable ``raft_mode="net"``
              servers in this process (``device`` cuda, their own
              data_dirs, the JAX package's raft timings) under the
              ``device`` verify policy; an ``AgentSwarm`` registers
              10,000 mock nodes through the cluster's RPC plane and
              heartbeats them; a probe writer on its own pool writes
              every few ms; config 4's 1,000-group job completes, then
              three rounds each send two more from two submitters and
              hard-kill the leader (``CrashHarness.kill``) once both are
              acked, while their evals are placed;
              the victim reboots from its data_dir and catches up, once
              by InstallSnapshot and at least once by log replay.  Per
              kill: election latency, recovery and unavailability (the
              probe), the new leader's first committed plan from the
              kill split into its fleet build, uploads, fetches and
              kernels (CUDA events on its own threads), the rejoin.
              Checks: every eval complete, identical store digests,
              each group of each job placed once, no node over
              capacity, ``committed_plan_loss`` 0, K3/K4a launched by an
              elected leader, K6 dispatched by an elected leader with no
              window falling back to the host (no lease miss), the
              first job's placements equal to a single server's on the
              same fleet, recorded launches replayed bit for bit; prints
              the elections no kill caused and the snapshot sizes;
  11. control the runner's depth knob (``control.runner_controller``)
              over config 2's evals on 1,000 nodes through
              PipelinedEvalRunner on the card, with a ``device.dispatch``
              delay injected for a bounded window: the depth retreats
              below its start and climbs back after, the plans equal an
              uncontrolled run's; prints the knob's trajectory and
              reversals;
  12. system  bench.py config 3: mock.system_job() on 1,000 nodes
              through ``system`` (vectorized, native finish) and
              ``system-seq``: equal plans, every node placed, eval ms;
              phases 4-12 (and 14) run under ``executor_override("device")``,
              so the cost policy cannot move their walks to the numpy
              twins and their launch checks keep their meaning;
  13. executor the host executor's crossover and the pipelined runner:
              (a) on real evals' DeviceArgs (configs 1, 2, 4, a config-5b
              lane, config 2's sequence job, and jobs of 8, 64 and 512
              distinct groups on config 4's fleet), ``dispatch_host``,
              ``dispatch_device`` alone and a single shot, 20 times each
              in rotating turns, host clock, and the executor constants
              the table gives beside the configured ones, which must not
              send any shape the wrong way by more than 2x; (b) the
              bench's streams through PipelinedEvalRunner on cuda (config
              1: 64 mock jobs on 100 nodes; config 2: 64 config-2 jobs
              and the sequence job on 1,000 nodes in two streams,
              committed through the Harness, so the second stream's first
              prep scatters the mirror, K5; config 4: 16 1,000-group jobs
              on 10,000 nodes at bench.py's derived depth) under host,
              device and auto: plans equal to each other and to the
              evals one at a time, nodes and ports; K2+K3 launches equal
              the device dispatches (every eval under device, none under
              host); no breaker re-run, no probe; evals/s, p50/p99,
              stage times, windows and counted uploads an eval; (c)
              config 5b's storm under host and auto, with the placements
              and counts of the storm phase's device run; the default
              breaker ends closed with every count at 0;
  14. verify  bench.py's 5f fleet-scaling sub-table on the port: NodeSlab
              fleets of 10,000, 131,072 and 1,000,000 nodes, 64
              single-placement plans a window, 8 measured windows under
              the host engine and under the device engine (K6); every
              device window must dispatch, make one upload and one
              fetch, and give the host's verdicts;
  15. mesh    K7, the node-axis-sharded forms, on a mesh of four shards
              that all name cuda:0 (``mesh_override``): (1) K7a+c
              (shard_step, all 4 shards in one launch) at N=16,384 for
              k=1 (a sequence step) and k_cap 1,024 and at B=64, in its
              three modes (a walk's first step, a middle step on a real
              K7b merge's updates, the tail), K7b (merge_select) on the
              4 lists of B=64 lanes and K7d (shard_gather) on the 5f
              window's 1,048,576 rows, each against its plain version
              bit for bit and timed with CUDA events beside
              ``index_add_`` + ``torch.topk`` / ``torch.topk``, and
              csrc/binpack.cu without the earlier per-shard
              shard_select_kernel and shard_apply_kernel; (2) each
              sharded wrapper against its unsharded kernel, bit for bit,
              both timed on the host clock: place_rounds_sharded against
              K3 at config 4, place_sequence_sharded against K2 at
              N=16,384, P=1,024, place_rounds_batch_sharded against K4a
              at config 5's B=64 on a 2x2 storm mesh,
              place_sequence_batch_sharded against K4b at B=8, P=256,
              window_verify_sharded against K6 at the 5f window; (3) the
              system path: config 4 through Harness.process (the
              dispatch sharded, the plan equal to an unsharded run's,
              nodes and ports), config 2 as a PipelinedEvalRunner stream
              with commits between evals (every device dispatch sharded,
              equal plans, the mirror's sharded usage equal to the host
              mirror), config 5's storm through BatchEvalRunner on the
              2x2 storm mesh (placements equal lane for lane), config 5b
              under the ``device`` verify policy (every window of more
              than one plan verified through window_verify_sharded, the
              commits equal the host engine's); shard_step, K7b and
              K7d launched there and K2-K4 not, and every walk's
              launches by the formula (a step: one shard_step a card
              and mesh row and one K7b a row; one tail shard_step a
              card and row a walk; on one card two launches a step);
              (4) steps 2 and 3 again on distinct cards
              where there are two or more, else a line saying the
              cross-card exchange went untested;
  16. sanitizers  config 4 through Harness.process (K3, K5) and config
              5b through the port's server under the device verify
              policy (K4a, K6, K5, with RPC reads on its serving plane),
              once as they are and once under the port's four runtime
              sanitizers (nomad_tpu_torch/analysis/sanitizers.py: the
              lock-order witness, the transfer guard, the replica
              divergence twin and the budget witness) installed at
              once, the launch counts set to 0 just before and read
              after: no lock-order cycle, no implicit upload, no
              divergence, no unbounded wait, the same plans; an
              implicit upload planted in a guarded seam must be refused
              by the guard; prints the locks and edges witnessed, the
              FSM pairs compared and the counted uploads per eval;
  17. report  one ``{"kernels": [...]}`` line, then the card's name and
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
import threading
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
# against a rerun through the plain versions).  Its six stragglers after
# the fused rounds plan as one chained window.
CONFIG5B_COUNTS = dict(placed=6240, conflicts=33, commits=5,
                       conflict_fallbacks=92)


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


def time_ms(torch, fn, reps: int, warm: bool = False) -> float:
    """Mean ms of ``fn`` over ``reps`` calls, CUDA events, after one
    warm-up call (``warm``: the caller has just made that call, as a
    plain version's reference result is one)."""
    if not warm:
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
    # torch.profiler on the chip machine drops device events at random
    # (PERF.md §7): it can count fewer kernels than ran, never more, so
    # more than one a call (a copy beside the scatter) is the fault.
    require(kernels_per_call is None or kernels_per_call <= 1.0,
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
                       lambda: binpack.place_sequence_batch_plain(*args), 1,
                       warm=True)
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
    list of (name, start event, end event, thread ident, host instant
    the call began).  The stream time between a
    call's two events is the card's work for it plus any stretch where
    the card waited on the host inside the call (a pageable upload's
    staging), so their sum bounds the card's busy time from above
    (the server's worker and applier threads launch at once: their
    calls' spans may overlap on the stream, and the sum counts the
    overlap twice).

    torch.profiler cannot give this number on the chip machine: there
    sessions long and short lose every device event at random, and
    the events that come back sit tens of ms off the host's clock
    (``profiler_events``), which is why config 5's busy time read
    None.  The failover phase splits one server's work out of the
    others' by thread and instant."""
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.parallel import devices

    pairs: list = []
    # per thread: the server's worker and applier threads launch at once
    nesting = threading.local()

    def timed(fn, name):
        def call(*a, **kw):
            if getattr(nesting, "depth", 0):
                return fn(*a, **kw)
            nesting.depth = 1
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                return fn(*a, **kw)
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                pairs.append((name, start, end, threading.get_ident(), t0))
                nesting.depth = 0
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
    for name, start, end, *_ in pairs:
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


class Recording:
    """A kernel's wrapper ``fn``, counting each launch by its shape in
    ``calls`` (key -> [positional inputs, keywords, launches]) and
    keeping a copy of the first launch's inputs at each shape; its
    ``launches`` are ``fn``'s own."""

    def __init__(self, fn, calls) -> None:
        self.fn = fn
        self.calls = calls

    @property
    def __name__(self) -> str:
        return self.fn.__name__

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int) -> None:
        # the wrapper counts through its module name, which is this now
        self.fn.launches = value

    def key(self, a, kw) -> tuple:
        return (self.fn.__name__,) + tuple(
            tuple(x.shape) for x in a if hasattr(x, "shape"))

    def __call__(self, *a, **kw):
        key = self.key(a, kw)
        if key not in self.calls:
            self.calls[key] = [tuple(x.clone() if hasattr(x, "clone")
                                     else x for x in a), dict(kw), 0]
        self.calls[key][2] += 1
        return self.fn(*a, **kw)


class RoundsRecording(Recording):
    """K3 or K4a, keyed as ``main_path_rounds`` reads the key: (name, N,
    the lane and slot axes, k_cap, rounds)."""

    def key(self, a, kw) -> tuple:
        return (self.fn.__name__, a[0].shape[0], tuple(a[4].shape[:-1]),
                kw["k_cap"], kw["rounds"])


def main_path_replay(torch, modules, calls) -> list:
    """K2, K4b or K5 at each shape the main path launched it (``calls``
    from Recording): the first launch at each shape replayed on its
    inputs and held to the plain version (``<name>_plain`` in
    ``modules[name]``) bit for bit; K4b also timed there, with its
    plain version's time and its bound (``main_path_sequence_batch``)."""
    out = []
    for key, (args, kw, count) in calls.items():
        name = key[0]
        module = modules[name]
        want = getattr(module, name + "_plain")(*args, **kw)
        got = getattr(module, name)(*args, **kw)
        torch.cuda.synchronize()
        what = f"{name} main path {list(key[1:])}"
        if isinstance(want, torch.Tensor):  # K5: the new usage buffer
            require(torch.equal(got.view(torch.int32),
                                want.view(torch.int32)),
                    f"{what}: usage differs from the plain version")
            err = float((got - want).abs().max()) if got.numel() else 0.0
        else:
            err = compare(torch, what, got[:3], want[:3])
        row = dict(kernel=name, shapes=[list(x) for x in key[1:]],
                   launches=count, err=err)
        if name == "place_sequence_batch" and not kw:
            # K4b on the server's and the wire's sequence job: timed on
            # its recorded inputs beside its plain version and bound.
            timed = main_path_sequence_batch(torch, module, args, reps=20)
            row.update({k: timed[k] for k in (
                "n", "lanes", "groups", "steps", "placed", "cluster",
                "mode", "ms", "bound_ms", "bound_by")},
                err=max(err, timed["err"]),
                plain_ms=time_ms(torch, lambda: module.
                                 place_sequence_batch_plain(*args), 2))
        print("main path " + json.dumps(row), flush=True)
        out.append(row)
    return out


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
                placed5b=placed5b,
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


# -- phase 6: the server ---------------------------------------------------


class ServerProbe:
    """The server phase's host-clock breakdown, over every thread the
    server runs: each eval's broker wait (from its entry into a ready
    queue to its dequeue), the batch worker's fused runs
    (``BatchEvalRunner.process``), the applier's window verifies
    (``evaluate_window``), the committer's commit jobs (encode, raft
    apply, responds) and, inside them, ``fsm``'s plan applies (slab
    decode and batched upsert); the broker's acks and nacks, the first
    dequeue's instant, and the windows the applier verified by their
    plan count (a one-plan window always takes the host's
    ``evaluate_plan``, whatever the verify policy)."""

    def __init__(self, fsm) -> None:
        from nomad_tpu_torch.ops import plan_conflict
        from nomad_tpu_torch.scheduler import batch
        from nomad_tpu_torch.server import eval_broker, plan_apply
        from nomad_tpu_torch.structs import codec

        self.enq: dict = {}
        self.waits: list = []
        self.nacks = 0
        self.acks = 0
        self.first_dequeue = None
        self.windows = dict(one_plan=0, many_plans=0)
        self._lock = threading.Lock()
        self.spent, self._restore = timed_phases([
            (batch.BatchEvalRunner, "process"),
            (plan_conflict, "evaluate_window"),
            (plan_apply.PlanApplier, "_commit_job")])
        # The FSM dispatches through a table of bound handlers built at
        # its construction: time the plan applies there.
        self._handlers = fsm._handlers
        self._saved_handlers = dict(fsm._handlers)
        for msg in (codec.ALLOC_UPDATE_REQUEST,
                    codec.PLAN_BATCH_APPLY_REQUEST):
            def handler(index, payload, _fn=fsm._handlers[msg]):
                t = time.perf_counter()
                try:
                    return _fn(index, payload)
                finally:
                    with self._lock:
                        self.fsm_s += time.perf_counter() - t
            fsm._handlers[msg] = handler
        self.fsm_s = 0.0
        broker = eval_broker.EvalBroker
        self._saved = [(broker, n, broker.__dict__[n]) for n in (
            "_enqueue_locked", "dequeue", "dequeue_batch", "ack", "nack")]
        probe = self
        enqueue_locked, dequeue, dequeue_batch, ack, nack = (
            s[2] for s in self._saved)

        def _enqueue_locked(self, ev, queue):
            if self._enabled and queue != eval_broker.FAILED_QUEUE:
                probe.enq.setdefault(ev.id, time.perf_counter())
            return enqueue_locked(self, ev, queue)

        def taken(evs):
            now = time.perf_counter()
            with probe._lock:
                if evs and probe.first_dequeue is None:
                    probe.first_dequeue = now
                for ev in evs:
                    t0 = probe.enq.pop(ev.id, None)
                    if t0 is not None:
                        probe.waits.append(now - t0)

        def _dequeue(self, *a, **kw):
            out = dequeue(self, *a, **kw)
            if out[0] is not None:
                taken([out[0]])
            return out

        def _dequeue_batch(self, *a, **kw):
            out = dequeue_batch(self, *a, **kw)
            taken([ev for ev, _token in out])
            return out

        def _ack(self, *a, **kw):
            with probe._lock:
                probe.acks += 1
            return ack(self, *a, **kw)

        def _nack(self, *a, **kw):
            with probe._lock:
                probe.nacks += 1
            return nack(self, *a, **kw)

        for name, fn in (("_enqueue_locked", _enqueue_locked),
                         ("dequeue", _dequeue),
                         ("dequeue_batch", _dequeue_batch),
                         ("ack", _ack), ("nack", _nack)):
            setattr(broker, name, fn)
        timed_verify = plan_conflict.evaluate_window

        def counted_verify(snap, plans, *a, **kw):
            with probe._lock:
                probe.windows["one_plan" if len(plans) == 1
                              else "many_plans"] += 1
            return timed_verify(snap, plans, *a, **kw)
        plan_conflict.evaluate_window = counted_verify
        self._saved.append((plan_conflict, "evaluate_window", timed_verify))

    def restore(self) -> None:
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        self._handlers.update(self._saved_handlers)
        self._restore()

    def breakdown_ms(self) -> dict:
        s = self.spent
        waits = sorted(self.waits)
        return dict(
            broker_wait_mean_ms=(sum(waits) / len(waits) * 1e3
                                 if waits else 0.0),
            broker_wait_max_ms=waits[-1] * 1e3 if waits else 0.0,
            worker_batch_ms=s.get("process", 0.0) * 1e3,
            applier_verify_ms=s.get("evaluate_window", 0.0) * 1e3,
            commit_ms=s.get("_commit_job", 0.0) * 1e3,
            fsm_apply_ms=self.fsm_s * 1e3)


class WindowRecording:
    """K6's wrapper, keeping a copy of the first launch's inputs at each
    bucket (key -> [fleet tensors, descriptors, counts, launches]); its
    ``launches`` are the wrapper's own."""

    def __init__(self, fn, calls) -> None:
        self.fn = fn
        self.calls = calls

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.launches = value

    def __call__(self, capacity, reserved, usage, packed=False,
                 counts=None, **desc):
        b = desc["pair_ni"].shape[0]
        key = ("window_verify", tuple(usage.shape), b)
        if key not in self.calls:
            self.calls[key] = [(capacity.clone(), reserved.clone(),
                                usage.clone()),
                               {k: v.copy() for k, v in desc.items()},
                               counts, 0]
        self.calls[key][3] += 1
        return self.fn(capacity, reserved, usage, packed=packed,
                       counts=counts, **desc)


def main_path_window(torch, mesh, calls) -> list:
    """K6 at each window bucket the server path launched it: the first
    launch at each bucket replayed on its inputs, with the padding's
    counts (every row) and with the engine's counts (the real pairs),
    held to the plain version bit for bit."""
    out = []
    for key, (fleet_t, desc, counts, launches) in calls.items():
        dd = {k: torch.from_numpy(v).to(DEV) for k, v in desc.items()}
        want = mesh.window_verify_plain(*fleet_t, **dd)
        got = mesh.window_verify(*fleet_t, **desc)
        real = mesh.window_verify(*fleet_t, counts=counts, **desc)
        torch.cuda.synchronize()
        n_pairs = counts[0] if counts else want[0].shape[0]
        what = f"window_verify main path N={key[1][0]} B={key[2]}"
        err = 0.0
        for name, g, r, w in zip(("used", "caps", "fits"), got, real,
                                 want):
            require(g.dtype == w.dtype and torch.equal(g, w),
                    f"{what}: {name} differs from the plain version")
            require(torch.equal(r[:n_pairs], w[:n_pairs]),
                    f"{what}: {name} with the engine's counts differs")
            err = max(err, float((g.float() - w.float()).abs().max()))
        row = dict(kernel="window_verify", n=key[1][0], bucket=key[2],
                   pairs=n_pairs, launches=launches, err=err)
        print("main path " + json.dumps(row), flush=True)
        out.append(row)
    return out


def check_server_state(structs, srv, name, eval_ids, probe, system_ids=()):
    """Every eval complete, acked once and never nacked; no worker
    failure; every live alloc placed once (one per alloc name, one per
    node for a system job); no node over capacity under the exact fit
    check.  Returns the live allocs' count."""
    state = srv.fsm.state
    statuses = {e.id: e.status for e in state.evals()}
    require(sorted(statuses) == sorted(eval_ids),
            f"server {name}: {len(statuses)} evals in the store, "
            f"{len(eval_ids)} registered")
    bad = {s for s in statuses.values() if s != structs.EVAL_STATUS_COMPLETE}
    require(not bad, f"server {name}: evals ended {sorted(bad)}")
    # A worker acks after its status update commits, which is what
    # wait_for_evals saw: give the last ack its moment.
    deadline = time.monotonic() + 10.0
    while probe.acks < len(eval_ids) and time.monotonic() < deadline:
        time.sleep(0.005)
    require(probe.nacks == 0 and probe.acks == len(eval_ids),
            f"server {name}: {probe.acks} acks and {probe.nacks} nacks "
            f"for {len(eval_ids)} evals")
    stats = srv._worker_stats()
    require(stats["failures"] == 0 and stats["expired_drops"] == 0,
            f"server {name}: worker failures {stats}")
    broker = srv.eval_broker.stats()
    require(broker["total_unacked"] == 0 and broker["total_ready"] == 0,
            f"server {name}: broker left {broker}")
    live = [a for a in state.allocs() if not a.terminal_status()]
    keys = {(a.job_id, a.name, a.node_id if a.job_id in system_ids
             else "") for a in live}
    require(len(keys) == len(live),
            f"server {name}: {len(live) - len(keys)} placements twice")
    for node in state.nodes():
        fit, dim, _ = structs.allocs_fit(
            node, [a for a in state.allocs_by_node(node.id)
                   if not a.terminal_status()])
        require(fit, f"server {name}: node {node.name} oversubscribed on "
                f"{dim}")
    return len(live)


def server_shape(torch, name, nodes, jobs, *, counters, verify=None,
                 later=(), rpc=False, inspect_server=None):
    """One shape through the port's server on the card: a fresh
    ``Server(ServerConfig(device=DEV, num_schedulers=0))``; ``nodes``
    through ``node_register``; ``jobs`` through ``job_register`` before
    leadership, so leadership's broker restore hands every eval to the
    batch worker at once; its two workers (the batch worker and a plain
    one) start just after leadership, so none sits in a dequeue backoff
    when the evals arrive; ``wait_for_evals``; then each job of
    ``later`` alone on the live server.  The server keeps its default
    ``tune_gc`` (as a user's does): the process's GC thresholds are
    saved before it and restored, and the heap unfrozen and collected,
    after it, so the later phases run under the GC settings they ran
    under before.  ``rpc`` starts the server's RPC listener;
    ``inspect_server(srv, eval_ids)`` runs on the live server after the
    checks, its result kept as the row's ``inspect`` (not printed).
    The launch counts are set to 0 just before the first
    ``job_register`` and read after the last eval completes.  Under the
    ``device`` verify policy every window of more than one plan must
    launch K6 (no ``device_verify_fallbacks``).  Returns the shape's
    numbers."""
    import gc

    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.ops.verify_policy import verify_override
    from nomad_tpu_torch.server import Server, ServerConfig

    thresholds = gc.get_threshold()
    srv = Server(ServerConfig(device=DEV, num_schedulers=0,
                              enable_rpc=rpc))
    probe = None
    try:
        for node in nodes:
            srv.node_register(node)
        base_index = srv.raft.applied_index()
        probe = ServerProbe(srv.fsm)
        scope = verify_override(verify) if verify else \
            contextlib.nullcontext()
        for fn in counters.values():
            fn.launches = 0
        with scope:
            t0 = time.perf_counter()
            ids = [srv.job_register(j)[1] for j in jobs]
            t_lead = time.perf_counter()

            def schedule():
                srv.establish_leadership()
                srv.config.num_schedulers = 2
                srv._setup_workers()
                srv.wait_for_evals(ids, timeout=900)
            busy_ms, top, _ = device_busy_ms(torch, schedule)
            t_done = time.perf_counter()
            later_rows = []
            for job in later:
                t = time.perf_counter()
                _, eid = srv.job_register(job)
                srv.wait_for_evals([eid], timeout=600)
                later_rows.append(dict(job=job.id, type=job.type,
                                       wall_s=time.perf_counter() - t))
                ids.append(eid)
        launches = {k: fn.launches for k, fn in counters.items()}
        system_ids = {j.id for j in list(jobs) + list(later)
                      if j.type == "system"}
        placed = check_server_state(structs, srv, name, ids, probe,
                                    system_ids)
        stats = srv.plan_applier.stats()
        wall = t_done - t0
        n_first = len(jobs)
        live_by_job: dict = {}
        for a in srv.fsm.state.allocs():
            if not a.terminal_status():
                live_by_job[a.job_id] = live_by_job.get(a.job_id, 0) + 1
        first_placed = sum(live_by_job.get(j.id, 0) for j in jobs)
        from_dequeue = t_done - probe.first_dequeue
        row = dict(
            nodes=len(nodes), evals=len(ids), placed=placed,
            storm_placed=first_placed,
            wall_s=wall, register_s=t_lead - t0,
            schedule_s=t_done - t_lead, from_first_dequeue_s=from_dequeue,
            evals_per_s=n_first / wall, placements_per_s=first_placed / wall,
            evals_per_s_from_dequeue=n_first / from_dequeue,
            placements_per_s_from_dequeue=first_placed / from_dequeue,
            later=later_rows,
            later_placed={j.id: live_by_job.get(j.id, 0) for j in later},
            commits=stats["commits"],
            plans_committed=stats["plans_committed"],
            batch_occupancy=stats["batch_occupancy"],
            conflict_fallbacks=stats["conflict_fallbacks"],
            serial_ms_per_plan=stats["serial_ms_per_plan"],
            device_verify_dispatches=stats["device_verify_dispatches"],
            device_verify_fallbacks=stats["device_verify_fallbacks"],
            windows_one_plan=probe.windows["one_plan"],
            windows_many_plans=probe.windows["many_plans"],
            raft_applies=srv.raft.applied_index() - base_index,
            device_busy_ms=busy_ms, device_top_ms=top,
            device_idle_share=(1.0 - busy_ms / ((t_done - t_lead) * 1e3)
                               if busy_ms is not None else None),
            breakdown_ms=probe.breakdown_ms(), launches=launches,
            verify=verify or "auto")
        print(f"server {name}: " + json.dumps(row), flush=True)
        check_verify_windows(f"server {name}", row)
        if inspect_server is not None:
            row["inspect"] = inspect_server(srv, ids)
        return row
    finally:
        if probe is not None:
            probe.restore()
        srv.shutdown()
        # Collect the server's garbage and the heap unfrozen here,
        # outside every timed region: left to the interpreter's
        # thresholds, that full collection lands inside a later
        # phase's timing (3.9 s of one 5f run).
        gc.unfreeze()
        gc.set_threshold(*thresholds)
        gc.collect()


def check_verify_windows(what, row) -> None:
    """Under the ``device`` verify policy every window of more than one
    plan launched K6 and none fell back to the host engine; under
    ``host`` none launched it.  One-plan windows take the host's
    ``evaluate_plan`` under both."""
    if row["verify"] == "device":
        require(row["device_verify_fallbacks"] == 0
                and row["device_verify_dispatches"]
                == row["windows_many_plans"],
                f"{what}: {row['device_verify_dispatches']} of "
                f"{row['windows_many_plans']} windows of more than one "
                f"plan launched K6, {row['device_verify_fallbacks']} fell "
                f"back to the host")
    elif row["verify"] == "host":
        require(row["device_verify_dispatches"] == 0,
                f"{what}: K6 launched under the host verify policy")


def applier_5f(torch, verify, n_nodes, n_submitters, submits_per, *,
               counters):
    """bench.py config 5f's applier shape (``_applier_saturation_phase``,
    the partitioned applier): the port's EvalBroker, PlanQueue,
    PlanApplier (on the card), InmemRaft and NomadFSM over 512
    registered nodes; 256 submitter threads, each submitting 4
    one-alloc plans (a 1-row AllocSlab, as the schedulers emit) with a
    real 10 s deadline, under ``verify``.  Every plan must commit
    exactly once (each eval acked once, never nacked), none may
    expire.  The breakdown is ``ServerProbe``'s (no batch worker
    here: the submitters stand in for the workers)."""
    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.ops.verify_policy import verify_override
    from nomad_tpu_torch.server.eval_broker import EvalBroker
    from nomad_tpu_torch.server.fsm import NomadFSM
    from nomad_tpu_torch.server.plan_apply import PlanApplier
    from nomad_tpu_torch.server.plan_queue import PlanQueue
    from nomad_tpu_torch.server.raft import InmemRaft
    from nomad_tpu_torch.structs import codec
    from nomad_tpu_torch.structs.alloc_slab import AllocSlab
    from nomad_tpu_torch.structs.model import proto_of

    broker = EvalBroker(nack_timeout=120.0)
    fsm = NomadFSM(eval_broker=broker)
    raft = InmemRaft(fsm)
    queue = PlanQueue()
    applier = PlanApplier(queue, broker, raft, state_fn=lambda: fsm.state,
                          device=DEV)
    broker.set_enabled(True)
    queue.set_enabled(True)
    for i in range(n_nodes):
        raft.apply(codec.encode(codec.NODE_REGISTER_REQUEST,
                                {"node": mock.node(i).to_dict()})).wait()
    node_ids = [n.id for n in fsm.state.nodes()]
    metric_static, _ = proto_of(structs.AllocMetric)
    jobs = []
    for _k in range(n_submitters):
        job = mock.job()
        job.constraints = []
        job.task_groups = [structs.TaskGroup(
            name="tg", count=1, tasks=[structs.Task(
                name="web", driver="exec",
                resources=structs.Resources(cpu=1, memory_mb=1))])]
        jobs.append(job)

    def mk_plan(ev, token, job, node_id):
        size = structs.Resources(cpu=1, memory_mb=1)
        slots = [(size, [("web", {"cpu": 1, "memory_mb": 1, "disk_mb": 0,
                                  "iops": 0}, None)])]
        slab = AllocSlab(
            eval_id=ev.id, job=job, slots=slots,
            metric_proto=dict(metric_static, nodes_evaluated=n_nodes),
            groups=[0], ids=[structs.generate_uuid()],
            names=[f"{job.id}.tg[0]"], tgs=["tg"], scores=[1.0],
            port_off=np.zeros(2, dtype=np.int64), n_rows=1)
        slab.node_ids[0] = node_id
        slab.ips[0] = ""
        slab.devs[0] = ""
        slab.seal(1)
        plan = structs.Plan(eval_id=ev.id, eval_token=token,
                            priority=ev.priority)
        plan.deadline = time.monotonic() + 10.0
        plan.node_allocation[node_id] = [slab.alloc(0)]
        return plan

    total = n_submitters * submits_per
    lats: list = [None] * total
    errors: list = []
    gate = threading.Event()

    def submitter(k):
        rng = random.Random(7000 + k)
        gate.wait()
        for i in range(submits_per):
            try:
                ev = structs.Evaluation(
                    id=structs.generate_uuid(), priority=50, type="service",
                    triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER,
                    job_id=structs.generate_uuid())
                broker.enqueue(ev, force=True)
                got, token = broker.dequeue(["service"], timeout=60)
                plan = mk_plan(got, token, jobs[k],
                               node_ids[rng.randrange(n_nodes)])
                t = time.perf_counter()
                result = queue.enqueue(plan).wait(120)
                lats[k * submits_per + i] = time.perf_counter() - t
                if result is None or sum(
                        len(v) for v in result.node_allocation.values()) != 1:
                    raise RuntimeError(f"plan not committed: {result}")
                broker.ack(got.id, token)
            except Exception as e:
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=submitter, args=(k,), daemon=True,
                                name=f"smoke-5f-{k}")
               for k in range(n_submitters)]
    for fn in counters.values():
        fn.launches = 0
    probe = ServerProbe(fsm)
    try:
        with verify_override(verify):
            applier.start()
            for t in threads:
                t.start()

            def run():
                gate.set()
                for t in threads:
                    t.join(600.0)
            t0 = time.perf_counter()
            busy_ms, top, _ = device_busy_ms(torch, run)
            wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        require(not errors, f"5f under {verify}: {errors[:3]}")
        require(all(not t.is_alive() for t in threads),
                f"5f under {verify}: a submitter is stuck")
        require(probe.acks == total and probe.nacks == 0,
                f"5f under {verify}: {probe.acks} acks and {probe.nacks} "
                f"nacks for {total} plans")
        stats = applier.stats()
    finally:
        probe.restore()
        queue.set_enabled(False)
        broker.set_enabled(False)
        applier.shutdown(10.0)
        broker.shutdown()
        fsm.state.watch.shutdown()
    placed = sum(1 for a in fsm.state.allocs() if a.node_id
                 and not a.terminal_status())
    require(placed == total == stats["plans_committed"],
            f"5f under {verify}: {placed} placed, "
            f"{stats['plans_committed']} committed of {total}")
    require(stats["expired_drops"] == 0,
            f"5f under {verify}: {stats['expired_drops']} plans expired")
    done = sorted(v for v in lats if v is not None)
    row = dict(nodes=n_nodes, submitters=n_submitters, plans=total,
               placed=placed, wall_s=wall, plans_per_s=total / wall,
               commits=stats["commits"],
               batch_occupancy=stats["batch_occupancy"],
               conflict_fallbacks=stats["conflict_fallbacks"],
               serial_ms_per_plan=stats["serial_ms_per_plan"],
               components=stats["components"],
               device_verify_dispatches=stats["device_verify_dispatches"],
               device_verify_fallbacks=stats["device_verify_fallbacks"],
               windows_one_plan=probe.windows["one_plan"],
               windows_many_plans=probe.windows["many_plans"],
               p50_submit_ms=percentile(done, 50),
               p99_submit_ms=percentile(done, 99),
               raft_applies=raft.applied_index() - n_nodes,
               device_busy_ms=busy_ms, device_top_ms=top,
               device_idle_share=(1.0 - busy_ms / (wall * 1e3)
                                  if busy_ms is not None else None),
               breakdown_ms=probe.breakdown_ms(), launches=launches,
               verify=verify)
    print(f"server 5f {verify}: " + json.dumps(row), flush=True)
    check_verify_windows(f"server 5f {verify}", row)
    return row


def run_server(torch, placed5b, sizes5b=(160, 64, 100),
               sizes5=(10_000, 64, 1000), sizes5f=(512, 256, 4)):
    """The server phase: the port's ``Server`` on the card, under the
    device executor, at config 5b (host and device verify), config 5
    at full width with a rounds-ineligible sequence job and a system
    job after it, and the applier at bench 5f's shape (host and device
    verify).  Every kernel launch is counted (each count set to 0 just
    before its shape and read after it), the first launch at each shape
    recorded and, after the shapes, replayed against the plain version
    on the card.  The sizes default to the configurations'; a
    rehearsal passes smaller ones."""
    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs

    shapes: dict = {}
    with recorded_kernels() as rec:
        counters = rec.counters
        n5b, j5b, g5b = sizes5b
        for verify in ("host", "device"):
            random.seed(5)
            row = server_shape(
                torch, f"config 5b {verify}",
                [mock.node(i) for i in range(n5b)],
                storm_jobs(mock, structs, "config5b", j5b, g5b),
                verify=verify, counters=counters)
            require(row["storm_placed"] == placed5b,
                    f"server config 5b {verify}: {row['storm_placed']} "
                    f"placed, the storm phase {placed5b}")
            shapes[f"config5b_{verify}"] = row
        require(shapes["config5b_device"]["launches"]["window_verify"] > 0,
                "server config 5b under device: window_verify was not "
                "launched")
        n5, j5, g5 = sizes5
        # The slice's rounds-ineligible job (asks large next to a node,
        # whatever the fleet's fill): K4b, one lane.  The storm's bin
        # packing fills whole nodes, so the system job takes only the
        # nodes left with room.
        seq = sequence_job(mock, structs)
        seq.id = "server-sequence-job"
        system = mock.system_job()
        system.id = "server-system-job"
        row = server_shape(
            torch, "config 5", [mock.node(i) for i in range(n5)],
            storm_jobs(mock, structs, "config5", j5, g5),
            later=(seq, system), counters=counters)
        require(row["storm_placed"] == j5 * g5,
                f"server config 5: {row['storm_placed']} placed of "
                f"{j5 * g5}")
        require(row["later_placed"][seq.id] == seq.task_groups[0].count
                and row["later_placed"][system.id] > 0,
                f"server config 5: the later jobs placed "
                f"{row['later_placed']}")
        require(row["launches"]["place_sequence_batch"] > 0,
                "server config 5: the sequence job did not launch K4b")
        shapes["config5"] = row
        n5f, s5f, per5f = sizes5f
        for verify in ("host", "device"):
            shapes[f"applier5f_{verify}"] = applier_5f(
                torch, verify, n5f, s5f, per5f, counters=counters)
        require(shapes["applier5f_device"]["launches"]["window_verify"]
                > 0, "server 5f under device: window_verify was not "
                "launched")
    launches = {k: sum(s["launches"][k] for s in shapes.values())
                for k in rec.counters}
    return dict(launches=launches, shapes=shapes,
                main_path_replay=rec.replay(torch, launches, "server"))


class KernelRecord:
    """The kernel wrappers of a phase, each a Recording: the first
    launch at each shape is kept for ``replay``."""

    def __init__(self, counters, rounds_calls, calls, window_calls) -> None:
        self.counters = counters
        self.rounds_calls = rounds_calls
        self.calls = calls
        self.window_calls = window_calls

    def replay(self, torch, launches, path) -> list:
        """Check that the recordings hold every launch of ``launches``,
        then replay the first launch at each shape against the plain
        version on the card, bit for bit."""
        from nomad_tpu_torch.models import fleet
        from nomad_tpu_torch.ops import binpack
        from nomad_tpu_torch.parallel import mesh

        require(sum(c[2] for c in self.rounds_calls.values())
                == launches["place_rounds"]
                + launches["place_rounds_batch"],
                f"the recorded K3/K4a launches are not the {path} path's")
        require(sum(c[3] for c in self.window_calls.values())
                == launches["window_verify"],
                f"the recorded K6 launches are not the {path} path's")
        return (main_path_rounds(torch, binpack, self.rounds_calls, reps=5)
                + main_path_replay(torch, dict(
                    place_sequence=binpack, scatter_rows=fleet,
                    place_sequence_batch=binpack), self.calls)
                + main_path_window(torch, mesh, self.window_calls))


@contextlib.contextmanager
def recorded_kernels():
    """Wrap every kernel wrapper of K2-K6 in a Recording for the block
    (their counts stay the wrappers' own); yields a KernelRecord."""
    from nomad_tpu_torch.models import fleet
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.parallel import mesh

    saved = dict(place_sequence=binpack.place_sequence,
                 place_rounds=binpack.place_rounds,
                 scatter_rows=fleet.scatter_rows,
                 window_verify=mesh.window_verify,
                 place_rounds_batch=binpack.place_rounds_batch,
                 place_sequence_batch=binpack.place_sequence_batch)
    rounds_calls: dict = {}
    calls: dict = {}
    window_calls: dict = {}
    counters = dict(
        place_sequence=Recording(saved["place_sequence"], calls),
        place_rounds=RoundsRecording(saved["place_rounds"], rounds_calls),
        scatter_rows=Recording(saved["scatter_rows"], calls),
        window_verify=WindowRecording(saved["window_verify"], window_calls),
        place_rounds_batch=RoundsRecording(saved["place_rounds_batch"],
                                           rounds_calls),
        place_sequence_batch=Recording(saved["place_sequence_batch"],
                                       calls))
    (binpack.place_sequence, binpack.place_rounds, fleet.scatter_rows,
     mesh.window_verify, binpack.place_rounds_batch,
     binpack.place_sequence_batch) = (counters[k] for k in saved)
    try:
        yield KernelRecord(counters, rounds_calls, calls, window_calls)
    finally:
        (binpack.place_sequence, binpack.place_rounds, fleet.scatter_rows,
         mesh.window_verify, binpack.place_rounds_batch,
         binpack.place_sequence_batch) = (saved[k] for k in saved)


# -- phase 7: the wire (the RPC plane, a 10,000-agent swarm) ---------------

# The span chain every eval of the wire phase carries: its serving RPC
# (the eval's anchor hangs off it), then the anchor and the spans of
# each plane under it.
WIRE_CHAIN = ("rpc.serve.Job.Register", "eval.created", "broker.wait",
              "worker.invoke", "sched.begin", "sched.dispatch",
              "sched.finish", "sched.submit", "plan.queued",
              "applier.window", "applier.verify", "raft.apply",
              "fsm.decode", "store.upsert")
WIRE_SERVER_PROVIDERS = ("broker", "plan_queue", "applier",
                         "applier_components", "overload", "heartbeat",
                         "store", "workers", "rpc")
WIRE_PROCESS_PROVIDERS = ("breaker", "swarm")
# Config 5's width on the wire.  Every alloc of a Node.GetAllocs reply
# embeds its whole job (the JAX package's wire shape), so what one read
# costs the host grows with the job's groups; each commit wakes every
# parked poll into a read of its node's allocations, and the check reads
# every node once more.  The phase measures one node's read on the wire
# at each of WIRE_WIDTHS before the fleet registers (``read_costs``) and
# runs the widest whose read of every node's allocations fits
# WIRE_READ_BUDGET_S, printed beside config 5's 1,000 groups.  The
# server phase runs config 5 at full width in process.
CONFIG5_GROUPS = 1000
WIRE_WIDTHS = (1000, 500, 200, 100, 50, 20, 10)
WIRE_READ_BUDGET_S = 20.0


def wire_node(mock):
    """The swarm's ``node_factory``: a mock node (the default node has
    no resources) carrying the swarm's id."""
    def make(i):
        node = mock.node(i)
        node.id = f"swarm-{i:06d}"
        node.name = f"swarm-{i}"
        return node
    return make


def serving_threads(port) -> list:
    """This server's serving threads: its loop and its dispatch pool
    (bench.py 5d's rule, port-qualified names)."""
    return [t.name for t in threading.enumerate()
            if t.name == f"rpc-loop:{port}"
            or t.name.startswith(f"rpc-dispatch:{port}-")]


def wait_for(cond, timeout, what, phase="wire") -> None:
    """Wait for ``cond``; past ``timeout`` fail with ``what`` (a string,
    or a callable giving it then), naming ``phase``."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            require(False, f"{phase}: {what() if callable(what) else what}")
        time.sleep(0.02)


def registration_rate(mock, n, workers) -> float:
    """bench.py 5d's host probe: agents registered per second by a
    throwaway swarm of ``n`` against a throwaway server."""
    from nomad_tpu_torch.agent import AgentSwarm
    from nomad_tpu_torch.server import Server, ServerConfig

    srv = Server(ServerConfig(device=DEV, num_schedulers=0,
                              use_device_scheduler=False, enable_rpc=True,
                              rpc_dispatch_workers=workers,
                              heartbeat_seed=13, tune_gc=False))
    srv.establish_leadership()
    swarm = AgentSwarm(srv.rpc_address(), n, conns=4, hb_conns=2,
                       beat_interval=30.0, poll_wait=5.0, seed=13,
                       node_factory=wire_node(mock))
    try:
        t = time.perf_counter()
        swarm.start(register_timeout=120.0)
        return n / (time.perf_counter() - t)
    finally:
        swarm.stop()
        srv.shutdown()


def read_costs(mock, structs, n_jobs, fleet, widths=WIRE_WIDTHS, reps=3):
    """One node's non-blocking ``Node.GetAllocs`` over the wire at each
    width: the node holds its share of config 5's allocations at that
    width (``n_jobs`` x groups / ``fleet``, rounded up), each embedding a
    job of that many groups, on a throwaway server.  Returns {groups:
    (allocs, median seconds of ``reps`` reads, the fleet's full read in
    seconds: an upper bound, as every node is read at the rounded-up
    share)}."""
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.rpc import ConnPool

    srv = Server(ServerConfig(device=DEV, num_schedulers=0,
                              use_device_scheduler=False, enable_rpc=True,
                              tune_gc=False))
    pool = ConnPool()
    out: dict = {}
    try:
        srv.establish_leadership()
        state = srv.fsm.state
        for k, groups in enumerate(widths):
            node = mock.node(k)
            job = storm_jobs(mock, structs, f"read-{groups}", 1, groups)[0]
            share = -(-n_jobs * groups // fleet)
            allocs = []
            for g in range(share):
                a = mock.alloc()
                a.node_id = node.id
                a.job, a.job_id, a.task_group = job, job.id, f"tg-{g}"
                allocs.append(a)
            state.upsert_node(2 * k + 1, node)
            state.upsert_allocs(2 * k + 2, allocs)
            times = []
            for _ in range(reps):
                t = time.perf_counter()
                got = pool.call(srv.rpc_address(), "Node.GetAllocs",
                                {"node_id": node.id}, timeout=600)
                times.append(time.perf_counter() - t)
                require(len(got["allocs"]) == share,
                        f"wire: the read probe got {len(got['allocs'])} "
                        f"of {share} allocs")
            t = statistics.median(times)
            out[groups] = (share, t, fleet * t)
    finally:
        pool.shutdown()
        srv.shutdown()
    return out


def wire_width(costs, budget=WIRE_READ_BUDGET_S) -> int:
    """The widest measured width whose full read fits ``budget``, else
    the narrowest."""
    fits = [g for g, (_, _, full) in costs.items() if full <= budget]
    return max(fits) if fits else min(costs)


def storm_progress(srv, swarm, ids, stop, every=30.0) -> None:
    """Print the storm's progress every ``every`` seconds until ``stop``
    is set: evals complete, commits and the swarm's poll wakeups."""
    t0 = time.perf_counter()
    while not stop.wait(every):
        state = srv.fsm.state
        done = sum(1 for eid in list(ids)
                   if (ev := state.eval_by_id(eid)) is not None
                   and ev.terminal_status())
        print(f"wire progress {time.perf_counter() - t0:.0f} s: {done} of "
              f"{len(ids)} evals complete, "
              f"{srv.plan_applier.stats()['commits']} commits, "
              f"{swarm.stats()['poll_wakeups']} poll wakeups", flush=True)


def span_rows(spans) -> tuple:
    """(each span name's count, total ms and p50 ms; the ``sched.*``
    stage rows by bench.py's ``_span_stage_profile`` rule: mean ms per
    stage)."""
    durs: dict = {}
    for s in spans:
        durs.setdefault(s["name"], []).append(s["dur"] * 1e3)
    names = {name: dict(count=len(d), total_ms=sum(d),
                        p50_ms=statistics.median(d))
             for name, d in sorted(durs.items())}
    stages = {name.split(".", 1)[1]: sum(d) / len(d)
              for name, d in durs.items() if name.startswith("sched.")}
    return names, stages


def check_span_chains(spans, eval_ids, chain=WIRE_CHAIN) -> None:
    """Every eval's spans hold the whole ``chain``, every span of it in
    the eval's trace, and the anchor's parent is its Job.Register serve
    span."""
    by_id = {s["span_id"]: s for s in spans}
    mine: dict = {}
    for s in spans:
        eid = (s.get("tags") or {}).get("eval_id")
        if eid is not None:
            mine.setdefault(eid, []).append(s)
    for eid in eval_ids:
        got = mine.get(eid, [])
        anchors = [s for s in got if s["name"] == "eval.created"]
        require(len(anchors) == 1, f"wire: eval {eid} has "
                f"{len(anchors)} eval.created spans")
        serve = by_id.get(anchors[0]["parent_id"])
        require(serve is not None
                and serve["name"] == "rpc.serve.Job.Register",
                f"wire: eval {eid}'s anchor hangs off "
                f"{serve and serve['name']}")
        names = {s["name"] for s in got} | {serve["name"]}
        missing = [n for n in chain if n not in names]
        require(not missing, f"wire: eval {eid} lacks spans {missing}")
        require(len({s["trace_id"] for s in got + [serve]}) == 1,
                f"wire: eval {eid}'s spans are in more than one trace")


def check_node_allocs(addr, state, node_ids, threads=8) -> int:
    """A non-blocking ``Node.GetAllocs`` over the wire for every node
    returns exactly the store's allocations for it; returns the allocs
    counted."""
    from nomad_tpu_torch.server.rpc import ConnPool

    pool = ConnPool()
    bad: list = []
    seen = [0] * threads

    def check(k):
        for nid in node_ids[k::threads]:
            got = pool.call(addr, "Node.GetAllocs", {"node_id": nid},
                            timeout=60)["allocs"]
            want = sorted(a.id for a in state.allocs_by_node(nid))
            if sorted(a["id"] for a in got) != want:
                bad.append(nid)
            seen[k] += len(got)
    workers = [threading.Thread(target=check, args=(k,))
               for k in range(threads)]
    try:
        for t in workers:
            t.start()
        for t in workers:
            t.join()
    finally:
        pool.shutdown()
    require(not bad, f"wire: Node.GetAllocs differs from the store on "
            f"{len(bad)} nodes (first {bad[:3]})")
    return sum(seen)


def run_wire(torch, n_agents=10_000, n_jobs=64, n_groups=None,
             workers=8, probe_agents=500):
    """The wire phase: the port's ``Server(ServerConfig(enable_rpc=
    True))`` on the card, tracing on, driven over the wire.  A swarm of
    ``n_agents`` agents (bench.py 5d's fleet, or the fleet the measured
    registration rate sustains inside the earliest nodes' 10 s TTL,
    printed beside it) registers mock nodes through ``Node.Register``
    on shared mux sessions, heartbeats on its own sessions and parks one
    ``Node.GetAllocs`` long-poll per agent; a client thread then sends
    bench.py config 5's 64 jobs through ``Job.Register`` on a
    ``ConnPool``, at ``n_groups`` groups each, or where it is None at
    the widest width whose measured full read of every node's
    allocations fits the budget (``read_costs``, ``wire_width``),
    printed beside 1,000.  The launch counts are set to 0
    just before the first ``Job.Register`` and read after the last eval
    completes.  Checks: every eval complete (``check_server_state``);
    ``Node.GetAllocs`` for every node equal to the store; every node
    that received allocations saw them in its long-poll; no node left
    ``ready``; the serving threads are ``workers`` + 1 with the fleet
    connected; every eval carries ``WIRE_CHAIN``; the registries carry
    their providers; one more job under ``utils/profiling.device_trace``
    writes a non-empty trace; teardown leaves no waiter, connection or
    thread; the first launch at each kernel shape replayed against the
    plain version, bit for bit."""
    import gc

    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.agent import AgentSwarm
    from nomad_tpu_torch.obs import REGISTRY, trace
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.rpc import ConnPool
    from nomad_tpu_torch.utils import profiling

    before = set(threading.enumerate())
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        print(f"wire step {name}: {now - t_step[0]:.2f} s", flush=True)
        t_step[0] = now
    probe_n = min(probe_agents, n_agents)
    probe_rate = registration_rate(mock, probe_n, workers)
    fleet = min(n_agents, max(probe_n, int(probe_rate * 10.0)))
    print(f"wire fleet: {fleet} agents of {n_agents} requested (probe: "
          f"{probe_rate:.1f} registrations/s)", flush=True)
    step("probe")
    costs = read_costs(mock, structs, n_jobs, fleet)
    if n_groups is None:
        n_groups = wire_width(costs)
    print(f"wire groups: {n_groups} of {CONFIG5_GROUPS} requested (one "
          f"node's Node.GetAllocs at its share of {n_jobs} jobs, and the "
          f"fleet's full read: " + ", ".join(
              f"{g} groups {k} allocs {t * 1e3:.2f} ms {full:.1f} s"
              for g, (k, t, full) in costs.items())
          + f"; budget {WIRE_READ_BUDGET_S} s)", flush=True)
    step("read probe")
    thresholds = gc.get_threshold()
    row: dict = dict(agents=fleet, agents_requested=n_agents,
                     probe_registrations_per_s=probe_rate,
                     groups_requested=CONFIG5_GROUPS,
                     read_costs={g: dict(allocs=k, ms=t * 1e3, full_s=full)
                                 for g, (k, t, full) in costs.items()})
    with recorded_kernels() as rec, \
            trace.tracing(seed=10, ring=1 << 18) as tracer:
        # No workers until the jobs are in: the batch worker then finds
        # config 5's 64 evals ready at once and fuses them, as the
        # server phase's does after leadership.
        srv = Server(ServerConfig(device=DEV, enable_rpc=True,
                                  num_schedulers=0,
                                  rpc_dispatch_workers=workers,
                                  heartbeat_seed=9))
        probe = swarm = pool = None
        ok = False
        try:
            srv.establish_leadership()
            addr = srv.rpc_address()
            state = srv.fsm.state
            probe = ServerProbe(srv.fsm)
            swarm = AgentSwarm(
                addr, fleet, conns=16, hb_conns=4,
                beat_interval=min(20.0, max(2.0, fleet / 600.0)),
                poll_wait=60.0, seed=9, node_factory=wire_node(mock))
            t = time.perf_counter()
            swarm.start(register_timeout=600.0)
            row["register_s"] = time.perf_counter() - t
            row["registered_per_s"] = fleet / row["register_s"]
            # A table no write has touched answers at once (index 0):
            # seed the allocs table at the applied index, as bench.py's
            # swarm row does, so every poll parks.
            state.upsert_allocs(srv.raft.applied_index(), [])
            wait_for(lambda: state.watch.live_waiters() >= fleet, 120,
                     "the long-polls did not all park")
            row["parked"] = state.watch.live_waiters()
            step("register and park")
            threads_mid = serving_threads(addr[1])
            delivered0 = state.watch.stats()["delivered"]
            jobs = storm_jobs(mock, structs, "wire", n_jobs, n_groups)
            ids: list = []
            marks: dict = {}
            pool = ConnPool()

            def submit():
                marks["first"] = time.perf_counter()
                for job in jobs:
                    ids.append(pool.call(addr, "Job.Register",
                                         {"job": job.to_dict()},
                                         timeout=300)["eval_id"])
                marks["last"] = time.perf_counter()

            def storm():
                client = threading.Thread(target=submit,
                                          name="wire-client")
                client.start()
                client.join()
                require(len(ids) == n_jobs, "wire: Job.Register failed")
                srv.config.num_schedulers = 2
                srv._setup_workers()
                srv.wait_for_evals(ids, timeout=900)
                marks["done"] = time.perf_counter()

            for fn in rec.counters.values():
                fn.launches = 0
            stop = threading.Event()
            watcher = threading.Thread(
                target=storm_progress, args=(srv, swarm, ids, stop),
                name="wire-progress")
            watcher.start()
            try:
                busy_ms, top, _ = device_busy_ms(torch, storm)
            finally:
                stop.set()
                watcher.join()
            storm_launches = {k: fn.launches
                              for k, fn in rec.counters.items()}
            # The storm goes through the fused launch (K4a).  K3 only
            # for a lane of the batch worker's chained tail after its
            # fused rounds, and for an eval it handed to the per-eval
            # retry, at most its scheduler's attempts.
            from nomad_tpu_torch.scheduler.generic import (
                MAX_SERVICE_SCHEDULE_ATTEMPTS)
            solo = sum(getattr(w, "solo_evals", 0) for w in srv.workers)
            chained = sum(getattr(w, "chained_evals", 0)
                          for w in srv.workers)
            row["storm_solo_evals"] = solo
            row["storm_chained_evals"] = chained
            require(storm_launches["place_rounds_batch"] > 0
                    and storm_launches["place_rounds"]
                    <= chained + solo * MAX_SERVICE_SCHEDULE_ATTEMPTS,
                    f"wire: the storm launched K4a "
                    f"{storm_launches['place_rounds_batch']} and K3 "
                    f"{storm_launches['place_rounds']} times, with "
                    f"{chained} lanes chained and {solo} evals on the "
                    f"per-eval retry")
            step("jobs")
            wall = marks["done"] - marks["first"]
            placed = check_server_state(structs, srv, "wire", ids, probe)
            require(placed == n_jobs * n_groups,
                    f"wire: {placed} placed of {n_jobs * n_groups}")
            print(f"wire storm: {placed} placed through Job.Register in "
                  f"{wall:.2f} s, "
                  f"{srv.plan_applier.stats()['commits']} commits",
                  flush=True)
            # Every node that received allocations sees them in its
            # long-poll: its last answer's index reaches their commit.
            owner = {n.id: i for i, n in enumerate(swarm._nodes)}
            need: dict = {}
            for a in state.allocs():
                need[a.node_id] = max(need.get(a.node_id, 0),
                                      a.modify_index)
            def saw() -> int:
                return sum(swarm._poll_index[owner[nid]] >= ix
                           for nid, ix in need.items())
            wait_for(lambda: saw() == len(need), 120,
                     lambda: f"a node's long-poll never saw its "
                     f"allocations ({saw()} of {len(need)} nodes saw "
                     f"theirs in 120 s)")
            step("state and long-polls")
            # Then, on the live server: an update of one storm job (its
            # in-place update makes a plan delta: its own launch, K3),
            # and the slice's rounds-ineligible job (K4b) under a device
            # trace, whose file must hold events (no device event is
            # required of it).
            update = structs.Job.from_dict(jobs[0].to_dict())
            update.task_groups[0].count = 2
            seq = sequence_job(mock, structs)
            seq.id = "wire-sequence-job"
            trace_dir = os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "nomad_tpu_torch", "_build",
                "wire_trace")
            later = [pool.call(addr, "Job.Register",
                               {"job": update.to_dict()},
                               timeout=300)["eval_id"]]
            srv.wait_for_evals(later, timeout=300)
            update_k3 = (rec.counters["place_rounds"].launches
                         - storm_launches["place_rounds"])
            with profiling.device_trace(trace_dir, device=DEV):
                later.append(pool.call(addr, "Job.Register",
                                       {"job": seq.to_dict()},
                                       timeout=300)["eval_id"])
                srv.wait_for_evals(later, timeout=300)
            trace_file = os.path.join(trace_dir, profiling.TRACE_FILE)
            with open(trace_file) as fh:
                trace_events = len(json.load(fh).get("traceEvents", []))
            require(trace_events > 0, "wire: the device trace is empty")
            live = {}
            for a in state.allocs():
                if not a.terminal_status():
                    live[a.job_id] = live.get(a.job_id, 0) + 1
            require(live.get(update.id) == n_groups + 1
                    and live.get(seq.id) == seq.task_groups[0].count,
                    f"wire: the later jobs placed {live.get(update.id)} "
                    f"and {live.get(seq.id)}")
            # Counted across each job (a storm retry that the batch
            # worker takes alone launches K3 too).
            require(update_k3 > 0
                    and rec.counters["place_sequence_batch"].launches
                    > storm_launches["place_sequence_batch"],
                    "wire: the update did not launch K3 or the sequence "
                    "job K4b")
            # The phase's main path ends with the later jobs.
            launches = {k: fn.launches for k, fn in rec.counters.items()}
            step("later jobs")
            spans = tracer.snapshot()
            span_stats = tracer.stats()
            check_span_chains(spans, ids + later[1:])
            # An eval with a plan delta takes its own launch and submits
            # its plan alone: no sched.submit span (as in the JAX
            # package's batch runner).
            check_span_chains(spans, later[:1], tuple(
                n for n in WIRE_CHAIN if n != "sched.submit"))
            names, stages = span_rows(spans)
            swarm_stats = swarm.stats()
            hb = srv.heartbeats.stats()
            not_ready = [n.id for n in state.nodes() if n.status != "ready"]
            require(not not_ready and hb["expiries"] == 0
                    and swarm_stats["beat_errors"] == 0,
                    f"wire: {len(not_ready)} nodes not ready, "
                    f"{hb['expiries']} TTL expiries, "
                    f"{swarm_stats['beat_errors']} beat errors (the "
                    f"swarm: {json.dumps(swarm_stats)})")
            step("spans")
            checked = check_node_allocs(addr, state,
                                        [n.id for n in swarm._nodes])
            step("Node.GetAllocs for every node")
            threads_end = serving_threads(addr[1])
            require(len(threads_mid) == len(threads_end) == workers + 1,
                    f"wire: serving threads {len(threads_mid)} / "
                    f"{len(threads_end)}, want {workers + 1}")
            snap = srv.obs_registry.snapshot()
            have = {k.split(".")[1] for k in snap}
            require(set(WIRE_SERVER_PROVIDERS) <= have,
                    f"wire: the server's registry lacks "
                    f"{set(WIRE_SERVER_PROVIDERS) - have}")
            require(set(WIRE_PROCESS_PROVIDERS) <= set(REGISTRY.providers()),
                    f"wire: REGISTRY has {REGISTRY.providers()}")
            wakeups = state.watch.stats()["delivered"] - delivered0
            stats = srv.plan_applier.stats()
            row.update(
                jobs=n_jobs, groups=n_groups, placed=placed,
                wall_s=wall, job_register_s=marks["last"] - marks["first"],
                evals_per_s=n_jobs / wall, placements_per_s=placed / wall,
                commits=stats["commits"],
                plans_committed=stats["plans_committed"],
                conflict_fallbacks=stats["conflict_fallbacks"],
                cross_component_speedup=stats["cross_component_speedup"],
                p50_heartbeat_ms=swarm_stats["p50_beat_ms"],
                p99_heartbeat_ms=swarm_stats["p99_beat_ms"],
                beats_ok=swarm_stats["beats_ok"],
                poll_wakeups=swarm_stats["poll_wakeups"],
                poll_errors=swarm_stats["poll_errors"],
                fanout_wakeups=wakeups,
                get_allocs_checked=checked,
                serving_threads=len(threads_mid),
                spans=span_stats["recorded"],
                spans_dropped=span_stats["dropped"],
                trace_file_events=trace_events,
                device_busy_ms=busy_ms, device_top_ms=top,
                device_idle_share=(1.0 - busy_ms / (wall * 1e3)
                                   if busy_ms is not None else None),
                breakdown_ms=probe.breakdown_ms(),
                storm_launches=storm_launches, launches=launches)
            ok = True
        finally:
            try:
                if pool is not None:
                    pool.shutdown()
                if swarm is not None:
                    swarm.stop()
                if probe is not None:
                    probe.restore()
                if ok:
                    # The swarm's sessions are closed: the server must
                    # have let go of every parked poll and connection.
                    wait_for(lambda: srv.fsm.state.watch.live_waiters()
                             == 0, 60, "parked polls outlived the swarm")
                    wait_for(lambda: srv.rpc_server.stats()["loop"][
                        "open_conns"] == 0, 60,
                        "connections outlived the swarm")
            finally:
                srv.shutdown()
                gc.unfreeze()
                gc.set_threshold(*thresholds)
                gc.collect()
    step("teardown")
    require("swarm" not in REGISTRY.providers(),
            "wire: the swarm's provider outlived it")
    wait_for(lambda: not [t for t in threading.enumerate()
                          if t not in before and t.is_alive()], 30,
             "threads outlived the phase")
    print("wire: " + json.dumps(row), flush=True)
    print("wire stages: " + json.dumps(stages), flush=True)
    print("wire spans: " + json.dumps(names), flush=True)
    row["main_path_replay"] = rec.replay(torch, launches, "wire")
    return row


# -- phase 8: the client (real port Clients running what the card placed) --

CLIENT_NODES = 32
CLIENT_BATCH = 256     # job 1's raw_exec tasks
CLIENT_SLEEPERS = 64   # job 3's /bin/sleep tasks
# The task of jobs 1 and 2: print the alloc's id, the name of the
# directory that holds the alloc dir the client hands it.
CLIENT_ECHO = ("-c 'basename \"$(dirname \"$NOMAD_ALLOC_DIR\")\"'")
CLIENT_HCL = """
job "client-hcl" {
    type = "batch"
    datacenters = ["dc1"]
    constraint {
        attribute = "$attr.accel.platform"
        value = "%(platform)s"
    }
    group "echo" {
        count = %(count)d
        constraint {
            distinct_hosts = true
        }
        task "echo" {
            driver = "raw_exec"
            config {
                command = "/bin/sh"
                args = "%(args)s"
            }
            resources {
                cpu = 20
                memory = 16
            }
        }
    }
}
"""


def accel_expected(torch) -> tuple:
    """The ``accel.platform`` and ``accel.kind.*`` key a Client's
    fingerprint must report on DEV: JAX's names (``gpu`` and the card's
    name; ``cpu`` on a CPU rehearsal)."""
    if DEV == "cpu":
        return "cpu", "accel.kind.cpu"
    name = torch.cuda.get_device_name(0).lower().replace(" ", "-")
    return "gpu", f"accel.kind.{name}"


def proc_stat(pid):
    """(state, parent pid) of ``pid`` from /proc, or None once it is
    gone; a zombie has state ``Z``."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            stat = fh.read()
    except OSError:
        return None
    fields = stat[stat.rindex(")") + 2:].split()
    return fields[0], int(fields[1])


def alive(pid) -> bool:
    """``pid`` exists and is not a zombie."""
    st = proc_stat(pid)
    return st is not None and st[0] != "Z"


def child_processes(parent=None) -> dict:
    """The children of ``parent`` (this process by default) from /proc:
    {pid: (state, argv)}."""
    me = parent or os.getpid()
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        st = proc_stat(name)
        if st is None or st[1] != me:
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as fh:
                argv = fh.read().split(b"\0")
        except OSError:
            continue
        out[int(name)] = (st[0], [a.decode() for a in argv if a])
    return out


def sleepers(parent=None) -> set:
    """The live ``/bin/sleep`` children of ``parent`` (this process by
    default)."""
    return {pid for pid, (st, argv) in child_processes(parent).items()
            if st != "Z" and argv[:1] == ["/bin/sleep"]}


class ClientProbe:
    """The client phase's clocks: the instant each alloc's runner was
    made on a client (first time only), the instant each raft index's
    plan commit returned on the FSM, and the calls every client made
    through ``NetRPCHandler`` by method."""

    def __init__(self, fsm) -> None:
        from nomad_tpu_torch.client import client as client_mod
        from nomad_tpu_torch.structs import codec

        self.seen: dict = {}
        self.committed: dict = {}
        self.calls: dict = {}
        self._lock = threading.Lock()
        self._client_mod = client_mod
        self._runner = client_mod.AllocRunner
        self._call = client_mod.NetRPCHandler.call
        self._handlers = fsm._handlers
        self._saved_handlers = dict(fsm._handlers)
        probe = self

        class SeenRunner(self._runner):
            def __init__(self, alloc, *a, **kw):
                with probe._lock:
                    probe.seen.setdefault(alloc.id, time.perf_counter())
                super().__init__(alloc, *a, **kw)

        def call(handler, method, args, timeout=None):
            with probe._lock:
                probe.calls[method] = probe.calls.get(method, 0) + 1
            return probe._call(handler, method, args, timeout=timeout)

        for msg in (codec.ALLOC_UPDATE_REQUEST,
                    codec.PLAN_BATCH_APPLY_REQUEST):
            def handler(index, payload, _fn=fsm._handlers[msg]):
                try:
                    return _fn(index, payload)
                finally:
                    with probe._lock:
                        probe.committed[index] = time.perf_counter()
            fsm._handlers[msg] = handler
        client_mod.AllocRunner = SeenRunner
        client_mod.NetRPCHandler.call = call

    def restore(self) -> None:
        self._client_mod.AllocRunner = self._runner
        self._client_mod.NetRPCHandler.call = self._call
        self._handlers.update(self._saved_handlers)

    def seen_s(self, allocs) -> list:
        """Commit to client, seconds, for each of ``allocs`` (by its
        create index); every one must have been seen after a recorded
        commit."""
        out = []
        for a in allocs:
            t0 = self.committed.get(a.create_index)
            t1 = self.seen.get(a.id)
            require(t0 is not None and t1 is not None,
                    f"client: alloc {a.id} has no commit ({t0}) or no "
                    f"runner ({t1})")
            out.append(t1 - t0)
        return out


def orphan(client) -> None:
    """After ``client.shutdown()``: what a client process that exits
    leaves behind is its tasks, still running, and its state dir.  In
    one process its runners' threads live on; cut them off from the
    state dir and the server, so that they only reap their processes
    (as init would) and the client that re-attaches owns both."""
    for runner in list(client.alloc_runners.values()):
        runner.state_dir = ""
        runner.on_status = lambda alloc: None
        for tr in list(runner.task_runners.values()):
            tr.state_dir = ""


def client_config(base, i, addr):
    from nomad_tpu_torch.client import ClientConfig

    return ClientConfig(
        state_dir=os.path.join(base, f"c{i:02d}", "state"),
        alloc_dir=os.path.join(base, f"c{i:02d}", "alloc"),
        servers=[addr], options={"driver.raw_exec.enable": "1"})


def client_job(structs, job_id, job_type, count, command, args):
    return structs.Job(
        id=job_id, name=job_id, type=job_type, priority=50,
        region="global", datacenters=["dc1"],
        task_groups=[structs.TaskGroup(name="tasks", count=count, tasks=[
            structs.Task(name="task", driver="raw_exec",
                         config={"command": command, "args": args},
                         resources=structs.Resources(cpu=20,
                                                     memory_mb=16))])])


def run_client(torch, n_clients=CLIENT_NODES, n_batch=CLIENT_BATCH,
               n_sleepers=CLIENT_SLEEPERS):
    """The client phase: the port's ``Server(ServerConfig(enable_rpc=
    True))`` on the card serves ``n_clients`` real port ``Client``s in
    this process, each with its own state and alloc dirs, ``raw_exec``
    on and the whole fingerprint chain (``accel`` reads the card).
    They register over the wire through ``NetRPCHandler``, heartbeat
    and park one ``Node.GetAllocs`` long-poll each; the workers start
    once leadership is established.  Then, through ``Job.Register``:
    (1) a batch job of ``n_batch`` raw_exec tasks, each printing its
    alloc's id; (2) the same task parsed from HCL by the port's
    ``jobspec.parse``, one a node (``distinct_hosts``), on nodes whose
    ``accel.platform`` is the card's; (3) a service job of
    ``n_sleepers`` ``/bin/sleep 300`` tasks, then one Client (the one
    with most of them) shut down without touching its tasks and a new
    Client on its state dir re-attaching to them, then
    ``Job.Deregister``.  The launch counts are set to 0 just before the
    first ``Job.Register`` and read after the deregister.  Checks: every
    alloc of jobs 1-2 ``dead`` on the server and its stdout its own id;
    every eval complete, acked once, each alloc placed once, no node
    over capacity (``check_server_state``); job 2 once on each node,
    every node's accel attributes the card's; the re-attached runners
    hold the same PIDs and no second sleeper started; after the
    deregister no sleeper lives and job 3 is terminal; teardown leaves
    no client, runner or serving thread, no child process and no
    connection; K3 or K4a and K5 launched, each recorded launch
    replayed against its plain version, bit for bit."""
    import gc
    import shutil

    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.client import Client
    from nomad_tpu_torch.jobspec import parse
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.rpc import ConnPool

    def until(cond, timeout, what):
        wait_for(cond, timeout, what, phase="client")
    before = set(threading.enumerate())
    children0 = set(child_processes())
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "nomad_tpu_torch", "_build", "client_phase")
    shutil.rmtree(base, ignore_errors=True)
    platform, kind_key = accel_expected(torch)
    thresholds = gc.get_threshold()
    row: dict = dict(clients=n_clients)
    clients: list = []
    with recorded_kernels() as rec:
        srv = Server(ServerConfig(device=DEV, enable_rpc=True,
                                  num_schedulers=0, heartbeat_seed=11))
        probe = cprobe = pool = None
        ok = False
        try:
            srv.establish_leadership()
            srv.config.num_schedulers = 2
            srv._setup_workers()
            addr = srv.rpc_address()
            state = srv.fsm.state
            probe = ServerProbe(srv.fsm)
            cprobe = ClientProbe(srv.fsm)
            t = time.perf_counter()
            for i in range(n_clients):
                cfg = client_config(base, i, addr)
                os.makedirs(cfg.alloc_dir)  # the storage detector reads it
                c = Client(cfg)
                c.start()
                clients.append(c)
            until(lambda: sum(
                1 for n in state.nodes() if n.status == "ready")
                == n_clients, 60, "the clients did not all register")
            # As the wire phase does: an allocs table no write has
            # touched answers at once (index 0) and a client then polls
            # every 0.2 s, so seed it at the applied index (the nodes'
            # registrations) and every client's next poll parks.
            state.upsert_allocs(srv.raft.applied_index(), [])
            until(lambda: state.watch.live_waiters() >= n_clients, 60,
                  "the clients' long-polls did not all park")
            row["register_s"] = time.perf_counter() - t
            nodes = {n.id: n for n in state.nodes()}
            require(sorted(nodes) == sorted(c.node.id for c in clients),
                    "client: the store's nodes are not the clients'")
            for n in nodes.values():
                require(n.attributes.get("accel.platform") == platform
                        and n.attributes.get(kind_key) is not None
                        and n.attributes.get("driver.raw_exec") == "1",
                        f"client: node {n.id} reports accel "
                        f"{n.attributes.get('accel.platform')} and "
                        f"{sorted(k for k in n.attributes if k.startswith('accel.kind'))}")
            print(f"client: {n_clients} clients registered and parked in "
                  f"{row['register_s']:.2f} s", flush=True)
            by_node = {c.node.id: c for c in clients}
            pool = ConnPool()
            ids: list = []

            def register(job) -> float:
                t = time.perf_counter()
                ids.append(pool.call(addr, "Job.Register",
                                     {"job": job.to_dict()},
                                     timeout=120)["eval_id"])
                return t

            def allocs_of(job_id):
                return state.allocs_by_job(job_id)

            def run_to_dead(job, count) -> dict:
                t0 = register(job)
                srv.wait_for_evals(ids[-1:], timeout=120)
                t_placed = time.perf_counter()
                until(lambda: len(allocs_of(job.id)) == count and all(
                    a.client_status == "dead" for a in allocs_of(job.id)),
                    120, lambda: f"{job.id}: "
                    f"{[a.client_status for a in allocs_of(job.id)]}")
                wall = time.perf_counter() - t0
                for a in allocs_of(job.id):
                    log = os.path.join(by_node[a.node_id]._alloc_root(a.id),
                                       "alloc", "logs",
                                       a.job.task_groups[0].tasks[0].name
                                       + ".stdout")
                    with open(log) as fh:
                        got = fh.read()
                    require(got == a.id + "\n",
                            f"client: {job.id} alloc {a.id} wrote {got!r}")
                return dict(placed=count, wall_s=wall,
                            placed_s=t_placed - t0,
                            placements_per_s=count / (t_placed - t0),
                            allocs_per_s=count / wall,
                            nodes=len({a.node_id for a in allocs_of(job.id)}))

            job1 = client_job(structs, "client-batch", "batch", n_batch,
                              "/bin/sh", CLIENT_ECHO)
            job2 = parse(CLIENT_HCL % dict(platform=platform,
                                           count=n_clients,
                                           args=CLIENT_ECHO.replace(
                                               '"', '\\"')))
            job3 = client_job(structs, "client-sleep", "service",
                              n_sleepers, "/bin/sleep", "300")
            reattach: dict = {}

            def jobs():
                row["job1"] = run_to_dead(job1, n_batch)
                row["job2"] = run_to_dead(job2, n_clients)
                require(sorted(a.node_id for a in allocs_of(job2.id))
                        == sorted(nodes),
                        "client: job 2 is not once on every node")
                register(job3)
                srv.wait_for_evals(ids[-1:], timeout=120)
                until(lambda: len(allocs_of(job3.id)) == n_sleepers
                      and all(a.client_status == "running"
                              for a in allocs_of(job3.id)), 120,
                      "the sleepers did not all run")
                running = sleepers()
                require(len(running) == n_sleepers,
                        f"client: {len(running)} sleepers for "
                        f"{n_sleepers} allocs")
                # The client holding most sleepers goes down without
                # touching its tasks; a new one on its state dir
                # re-attaches.
                counts: dict = {}
                for a in allocs_of(job3.id):
                    counts[a.node_id] = counts.get(a.node_id, 0) + 1
                node_id = max(counts, key=lambda k: (counts[k], k))
                k = clients.index(by_node[node_id])
                old = clients[k]
                pids = {aid: r.task_runners["task"].handle.pid
                        for aid, r in old.alloc_runners.items()
                        if r.alloc.job_id == job3.id}
                require(len(pids) == counts[node_id],
                        "client: the chosen client's runners are not its "
                        "allocs")
                old.shutdown()
                orphan(old)
                t = time.perf_counter()
                new = Client(client_config(base, k, addr))
                got = {aid: r.task_runners["task"].handle.pid
                       for aid, r in new.alloc_runners.items()
                       if r.alloc.job_id == job3.id
                       and r.task_runners.get("task") is not None
                       and r.task_runners["task"].handle is not None}
                reattach.update(wall_s=time.perf_counter() - t,
                                allocs=len(pids))
                clients.append(old)  # its threads are joined at teardown
                clients[k] = new
                by_node[node_id] = new
                new.start()
                require(new.node.id == node_id and got == pids,
                        f"client: the restarted client re-attached "
                        f"{len(got)} of {len(pids)} tasks "
                        f"({sum(got.get(a) == p for a, p in pids.items())} "
                        f"with the same PID)")
                until(lambda: all(
                    r.task_runners["task"].state == "running"
                    for aid, r in new.alloc_runners.items()
                    if aid in pids), 30, "the re-attached tasks did not run")
                # Its registration makes one node-update eval for each
                # job with allocs on the node (create_node_evals).
                node_jobs = {a.job_id for a in state.allocs_by_node(node_id)}
                def node_evals():
                    return [e.id for e in state.evals()
                            if e.triggered_by == "node-update"
                            and e.node_id == node_id]
                until(lambda: len(node_evals()) == len(node_jobs), 30,
                      lambda: f"the restarted client's registration made "
                      f"{len(node_evals())} node evals for "
                      f"{len(node_jobs)} jobs")
                ids.extend(node_evals())
                srv.wait_for_evals(ids[-len(node_jobs):], timeout=120)
                until(lambda: state.watch.live_waiters() >= n_clients,
                      60, "the restarted client's poll did not park")
                require(sleepers() == running,
                        f"client: sleepers {len(sleepers())} after the "
                        f"restart, {len(running)} before")
                print(f"client re-attach: {len(pids)} tasks on node "
                      f"{node_id} in {reattach['wall_s'] * 1e3:.1f} ms",
                      flush=True)
                t = time.perf_counter()
                ids.append(pool.call(addr, "Job.Deregister",
                                     {"job_id": job3.id},
                                     timeout=120)["eval_id"])
                srv.wait_for_evals(ids[-1:], timeout=120)
                until(lambda: not sleepers() and all(
                    a.terminal_status() for a in allocs_of(job3.id)), 60,
                    lambda: f"{len(sleepers())} sleepers outlived the "
                    f"deregister")
                # and every client has told the server so
                until(lambda: all(a.client_status == "dead"
                                  for a in allocs_of(job3.id)), 60,
                      lambda: "the sleepers' kills did not all reach the "
                      "server: "
                      f"{[a.client_status for a in allocs_of(job3.id)]}")
                row["deregister_s"] = time.perf_counter() - t

            for fn in rec.counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            busy_ms, top, _ = device_busy_ms(torch, jobs)
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in rec.counters.items()}
            placed = check_server_state(structs, srv, "client", ids, probe)
            require(placed == n_batch + n_clients,
                    f"client: {placed} live allocs, want "
                    f"{n_batch + n_clients}")
            require(launches["place_rounds"]
                    + launches["place_rounds_batch"] > 0
                    and launches["scatter_rows"] > 0,
                    f"client: the jobs launched {launches}")
            seen = {j.id: cprobe.seen_s(allocs_of(j.id))
                    for j in (job1, job2, job3)}
            every = [t for ts in seen.values() for t in ts]
            row.update(
                reattach=reattach, wall_s=wall,
                update_alloc_calls=cprobe.calls.get("Node.UpdateAlloc", 0),
                rpc_calls=dict(sorted(cprobe.calls.items())),
                seen_p50_ms=percentile(every, 50),
                seen_p99_ms=percentile(every, 99),
                seen_ms_by_job={k: dict(p50=percentile(ts, 50),
                                        p99=percentile(ts, 99),
                                        max=max(ts) * 1e3)
                                for k, ts in seen.items()},
                commits=srv.plan_applier.stats()["commits"],
                device_busy_ms=busy_ms, device_top_ms=top,
                device_idle_share=(1.0 - busy_ms / (wall * 1e3)
                                   if busy_ms is not None else None),
                breakdown_ms=probe.breakdown_ms(), launches=launches)
            ok = True
        finally:
            try:
                for c in clients:
                    c.shutdown()
                    c.destroy_all()
                if pool is not None:
                    pool.shutdown()
                if cprobe is not None:
                    cprobe.restore()
                if probe is not None:
                    probe.restore()
                if ok:
                    until(lambda: srv.fsm.state.watch.live_waiters()
                          == 0, 60, "parked polls outlived the clients")
                    until(lambda: srv.rpc_server.stats()["loop"][
                        "open_conns"] == 0, 60,
                        lambda: f"connections outlived the clients: "
                        f"{srv.rpc_server.stats()['loop']}; clients with "
                        f"a session: " + str([
                            i for i, c in enumerate(clients)
                            if c.rpc.pool._sessions or c.rpc.pool._pools]))
            finally:
                srv.shutdown()
                gc.unfreeze()
                gc.set_threshold(*thresholds)
                gc.collect()
    until(lambda: not [t for t in threading.enumerate()
                       if t not in before and t.is_alive()], 30,
          lambda: "threads outlived the phase: " + ", ".join(sorted(
              t.name for t in threading.enumerate()
              if t not in before and t.is_alive())))
    until(lambda: set(child_processes()) <= children0, 30,
          lambda: f"child processes outlived the phase: "
          f"{sorted(set(child_processes()) - children0)}")
    shutil.rmtree(base, ignore_errors=True)
    for j in ("job1", "job2"):
        r = row[j]
        print(f"client {j}: {r['placed']} allocs on {r['nodes']} nodes, "
              f"placed in {r['placed_s']:.3f} s "
              f"({r['placements_per_s']:.1f} placements/s), all dead in "
              f"{r['wall_s']:.3f} s ({r['allocs_per_s']:.1f} allocs/s)",
              flush=True)
    print(f"client sync: {row['update_alloc_calls']} Node.UpdateAlloc "
          f"calls; commit to client p50 {row['seen_p50_ms']:.1f} ms, p99 "
          f"{row['seen_p99_ms']:.1f} ms (" + ", ".join(
              f"{k} {v['p50']:.1f} / {v['p99']:.1f}"
              for k, v in row["seen_ms_by_job"].items()) + ")", flush=True)
    print("client launches: " + json.dumps(launches), flush=True)
    print("client card: busy "
          + (f"{busy_ms:.2f} ms of {wall:.2f} s, idle "
             f"{row['device_idle_share'] * 100:.2f}%"
             if busy_ms is not None else "not measured"), flush=True)
    print("client: " + json.dumps(row), flush=True)
    row["main_path_replay"] = rec.replay(torch, launches, "client")
    return row


# -- phase 9: the agent (the HTTP API, the CLI, gossip) --------------------

AGENT_NODES = 10_000   # config 4's fleet, registered by an AgentSwarm
AGENT_GROUPS = 1000    # config 4's job
AGENT_TASKS = 8        # the raw_exec job on the agent's own node
AGENT_GROUP_HCL = """\
    group "tg-%d" {
        task "web" {
            driver = "exec"
            resources {
                cpu = 100
                memory = 64
                network {
                    mbits = 5
                    dynamic_ports = ["http"]
                }
            }
        }
    }
"""
AGENT_ECHO_HCL = """
job "agent-echo" {
    type = "batch"
    datacenters = ["dc2"]
    constraint {
        attribute = "$attr.accel.platform"
        value = "%(platform)s"
    }
    group "echo" {
        count = %(count)d
        task "echo" {
            driver = "raw_exec"
            config {
                command = "/bin/sh"
                args = "%(args)s"
            }
            resources {
                cpu = 20
                memory = 16
            }
        }
    }
}
"""
AGENT_SLEEP_HCL = """
job "agent-sleep" {
    datacenters = ["dc1"]
    group "sleep" {
        count = 2
        task "sleep" {
            driver = "raw_exec"
            config {
                command = "/bin/sleep"
                args = "300"
            }
            resources {
                cpu = 20
                memory = 16
            }
        }
    }
}
"""


def config4_hcl(n_groups) -> str:
    """Config 4's job (``mock.job()`` with ``n_groups`` groups of
    ``bench_task_group``'s shape) as a jobspec, on ``dc1``."""
    return ('job "agent-config4" {\n    datacenters = ["dc1"]\n'
            '    constraint {\n        attribute = "$attr.kernel.name"\n'
            '        value = "linux"\n    }\n'
            + "".join(AGENT_GROUP_HCL % g for g in range(n_groups)) + "}\n")


def cli(argv) -> tuple:
    """``nomad_tpu_torch.cli.main(argv)`` in this process: (exit code,
    what it printed, host seconds)."""
    import io

    from nomad_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(list(argv))
    return rc, out.getvalue(), time.perf_counter() - t


def compute_apps() -> list:
    """What nvidia-smi lists as holding a context on the card: one
    (pid, used memory) row per process.  In a PID namespace the PIDs
    are the host's (the chip machine's sandbox shows every one as 1),
    so a caller counts the rows."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return [tuple(x.strip() for x in ln.split(","))
            for ln in out.splitlines() if ln.strip()]


def run_agent(torch, n_nodes=AGENT_NODES, n_groups=AGENT_GROUPS,
              n_tasks=AGENT_TASKS):
    """The agent phase, SURVEY.md's canonical path on the card.  (a) In
    this process, counted: ``Agent(AgentConfig.dev())`` on DEV (the
    server with gossip, the HTTP API and its own client with
    ``raw_exec``, its node in ``dc2``); an ``AgentSwarm`` registers
    config 4's fleet of ``n_nodes`` mock nodes (``dc1``) on its RPC port
    and heartbeats them, with no long-poll; ``cli run -detach`` submits
    config 4's job of ``n_groups`` groups, written as HCL, over HTTP;
    ``GET /v1/evaluation/<id>`` reads it complete; ``alloc-status``
    reads one of its allocs; ``cli run`` submits a raw_exec job of
    ``n_tasks`` tasks parsed from HCL, constrained to ``dc2`` and the
    card's ``accel.platform`` (the agent's own node), each printing its
    alloc's id, and monitors its eval; ``status``, ``eval-monitor`` and
    ``alloc-status`` read it back; ``server-members``,
    ``/v1/agent/self`` and ``/v1/agent/metrics``; ``stop`` both jobs.
    The launch counts are set to 0 just before the first ``cli run``
    and read after the last deregister.  Checks: every eval complete,
    acked once, each alloc placed once, no node over capacity
    (``check_server_state``) with ``n_groups`` placed on ``dc1`` and the
    ``n_tasks`` on the agent's node, each ``dead`` with its own id in
    its stdout; every swarm node still ready, no TTL expiry, no beat
    error; one alive gossip member with the agent's region and RPC
    address; K3 or K4a at N=16,384 and K5 launched, each recorded
    launch replayed against its plain version, bit for bit; teardown
    leaves no thread, child process or connection.  (b) Across the
    process boundary: ``python3 -m nomad_tpu_torch.cli agent -dev
    -http-port 0`` (no ``-device``: the card) with a ``-config`` file;
    ``python3 -m nomad_tpu_torch.cli run`` of a raw_exec job exits 0
    with its eval complete, ``status`` and ``alloc-status`` read it
    back; while its tasks run, nvidia-smi lists one context on the card
    more than before the agent started (this process holds the other),
    and after SIGTERM one fewer again; SIGHUP after a ``log_level``
    change is reported as reloaded; SIGTERM: exit 0, no task left."""
    import logging
    import shutil

    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.agent import Agent, AgentConfig, AgentSwarm
    from nomad_tpu_torch.api import APIClient
    from nomad_tpu_torch.models import fleet as fleet_mod

    def until(cond, timeout, what):
        wait_for(cond, timeout, what, phase="agent")
    before = set(threading.enumerate())
    children0 = set(child_processes())
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "nomad_tpu_torch", "_build", "agent_phase")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    platform, _kind = accel_expected(torch)
    row: dict = dict(nodes=n_nodes, groups=n_groups, tasks=n_tasks)
    agent = swarm = probe = None
    ok = False
    with recorded_kernels() as rec:
        try:
            t = time.perf_counter()
            cfg = AgentConfig.dev()
            cfg.datacenter = "dc2"
            cfg.data_dir = os.path.join(base, "agent")
            cfg.log_level = "INFO"
            if DEV == "cpu":
                cfg.device = "cpu"
            agent = Agent(cfg)
            row["boot_s"] = time.perf_counter() - t
            srv = agent.server
            state = srv.fsm.state
            probe = ServerProbe(srv.fsm)
            url = f"http://127.0.0.1:{agent.http.address[1]}"
            api = APIClient(url)
            until(lambda: len(state.nodes()) == 1, 60,
                  "the agent's own client did not register")
            own = agent.client.node.id
            require(state.node_by_id(own).attributes.get(
                "accel.platform") == platform,
                f"agent: its node reports accel "
                f"{state.node_by_id(own).attributes.get('accel.platform')}")
            t = time.perf_counter()
            swarm = AgentSwarm(srv.rpc_address(), n_nodes, conns=16,
                               hb_conns=4, beat_interval=20.0, seed=12,
                               node_factory=wire_node(mock),
                               long_polls=False)
            swarm.start(register_timeout=300.0)
            row["register_s"] = time.perf_counter() - t
            row["registered_per_s"] = n_nodes / row["register_s"]
            until(lambda: sum(1 for n in state.nodes()
                              if n.status == "ready") == n_nodes + 1,
                  60, "the fleet is not all ready")
            print(f"agent: booted in {row['boot_s']:.2f} s; {n_nodes} "
                  f"nodes registered in {row['register_s']:.2f} s "
                  f"({row['registered_per_s']:.1f}/s)", flush=True)
            ids: list = []
            job1 = os.path.join(base, "config4.hcl")
            with open(job1, "w") as fh:
                fh.write(config4_hcl(n_groups))
            job2 = os.path.join(base, "echo.hcl")
            with open(job2, "w") as fh:
                fh.write(AGENT_ECHO_HCL % dict(
                    platform=platform, count=n_tasks,
                    args=CLIENT_ECHO.replace('"', '\\"')))
            walls: dict = {}

            def run_cli(*argv):
                rc, out, s = cli(["-address", url] + list(argv))
                walls.setdefault(argv[0], []).append(s)
                require(rc == 0, f"agent: cli {' '.join(argv)} exited {rc}:"
                        f" {out}")
                return out

            def eval_of(out):
                ev = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
                      if ln.startswith("Evaluation ID:")]
                require(len(ev) == 1 and ev[0], f"agent: no eval id in {out!r}")
                return ev[0]

            def allocs_of(job_id):
                return sorted(state.allocs_by_job(job_id),
                              key=lambda a: a.name)

            def jobs():
                # (1) config 4 through cli run -detach, over HTTP.
                t = time.perf_counter()
                ids.append(eval_of(run_cli("run", "-detach", job1)))
                until(lambda: api.eval_info(ids[0])[0].status
                      == structs.EVAL_STATUS_COMPLETE, 300,
                      "config 4's eval did not complete")
                row["job1_s"] = time.perf_counter() - t
                placed = allocs_of("agent-config4")
                require(len(placed) == n_groups and all(
                    state.node_by_id(a.node_id).datacenter == "dc1"
                    for a in placed),
                    f"agent: config 4 placed {len(placed)} allocs")
                out = run_cli("alloc-status", placed[0].id)
                require(placed[0].id in out and "Placement metrics" in out,
                        f"agent: alloc-status printed {out!r}")
                # (2) the raw_exec job on the agent's own node.
                t = time.perf_counter()
                out = run_cli("run", job2)
                require("Evaluation status: complete" in out,
                        f"agent: cli run printed {out!r}")
                ids.append([e.id for e in state.evals()
                            if e.job_id == "agent-echo"][0])
                until(lambda: len(allocs_of("agent-echo")) == n_tasks
                      and all(a.client_status == "dead"
                              for a in allocs_of("agent-echo")), 120,
                      lambda: "the echo tasks did not all end: " + str(
                          [a.client_status for a in allocs_of("agent-echo")]))
                row["job2_s"] = time.perf_counter() - t
                for a in allocs_of("agent-echo"):
                    require(a.node_id == own, f"agent: {a.id} on {a.node_id}")
                    log = os.path.join(agent.client._alloc_root(a.id),
                                       "alloc", "logs", "echo.stdout")
                    with open(log) as fh:
                        got = fh.read()
                    require(got == a.id + "\n",
                            f"agent: alloc {a.id} wrote {got!r}")
                out = run_cli("status", "agent-echo")
                require(all(a.id in out for a in allocs_of("agent-echo")),
                        f"agent: status printed {out!r}")
                out = run_cli("eval-monitor", ids[1])
                require("Evaluation status: complete" in out,
                        f"agent: eval-monitor printed {out!r}")
                out = run_cli("alloc-status", allocs_of("agent-echo")[0].id)
                require("Client     = dead" in out,
                        f"agent: alloc-status printed {out!r}")
                row["placed"] = check_server_state(structs, srv, "agent",
                                                   ids, probe)
                require(row["placed"] == n_groups + n_tasks,
                        f"agent: {row['placed']} live allocs")
                out = run_cli("server-members")
                members = api.agent_members()
                require(len(members) == 1 and members[0]["status"] == "alive"
                        and members[0]["tags"]["region"] == cfg.region
                        and tuple(members[0]["tags"]["rpc"])
                        == srv.rpc_address() and "nomad-server" in out,
                        f"agent: members {members}")
                me = api.agent_self()
                require(me["stats"]["nomad"]["leader"] == "true"
                        and me["stats"]["client"]["node_id"] == own
                        and me["config"]["datacenter"] == "dc2",
                        f"agent: /v1/agent/self {me['stats']}")
                metrics = api.agent_metrics()["providers"]
                for key in ("nomad.http.accepts", "nomad.broker.total_ready",
                            "nomad.applier.commits",
                            "nomad.heartbeat.expiries", "nomad.client.allocs"):
                    require(key in metrics, f"agent: no {key} in the metrics")
                # (3) stop both jobs.
                for job_id in ("agent-config4", "agent-echo"):
                    ids.append(eval_of(run_cli("stop", job_id)))
                srv.wait_for_evals(ids[-2:], timeout=120)

            for fn in rec.counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            busy_ms, top, _ = device_busy_ms(torch, jobs)
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in rec.counters.items()}
            require(check_server_state(structs, srv, "agent", ids, probe)
                    == 0, "agent: allocs live after the deregisters")
            require(launches["place_rounds"]
                    + launches["place_rounds_batch"] > 0
                    and launches["scatter_rows"] > 0,
                    f"agent: the jobs launched {launches}")
            # The fleet and the agent's own node, padded: 16,384.
            n_pad = fleet_mod._pad_to(n_nodes + 1)
            shapes = sorted({k[1] for k in rec.rounds_calls})
            require(n_pad in shapes,
                    f"agent: K3/K4a ran at N={shapes}, not {n_pad}")
            hb = srv.heartbeats.stats()
            sw = swarm.stats()
            ready = sum(1 for n in state.nodes() if n.status == "ready")
            require(hb["expiries"] == 0 and ready == n_nodes + 1
                    and sw["beat_errors"] == 0 and sw["polls_issued"] == 0,
                    f"agent: heartbeats {hb}, {ready} ready, swarm {sw}")
            row.update(wall_s=wall, launches=launches, rounds_shapes=shapes,
                       cli_s={k: sum(v) for k, v in walls.items()},
                       beats_ok=sw["beats_ok"], heartbeats=hb,
                       commits=srv.plan_applier.stats()["commits"],
                       device_busy_ms=busy_ms, device_top_ms=top,
                       device_idle_share=(1.0 - busy_ms / (wall * 1e3)
                                          if busy_ms is not None else None),
                       breakdown_ms=probe.breakdown_ms())
            swarm.stop()
            until(lambda: srv.rpc_server.stats()["loop"]["open_conns"] == 0,
                  60, lambda: "connections outlived the swarm: "
                  f"{srv.rpc_server.stats()['loop']}")
            until(lambda: agent.http.stats()["open_conns"] == 0, 60,
                  lambda: f"HTTP connections left: {agent.http.stats()}")
            ok = True
        finally:
            try:
                if swarm is not None and not ok:
                    swarm.stop()
                if probe is not None:
                    probe.restore()
            finally:
                if agent is not None:
                    agent.shutdown()
                logging.getLogger("nomad_tpu_torch").setLevel(logging.NOTSET)
    until(lambda: not [t for t in threading.enumerate()
                       if t not in before and t.is_alive()], 30,
          lambda: "threads outlived the agent: " + ", ".join(sorted(
              t.name for t in threading.enumerate()
              if t not in before and t.is_alive())))
    until(lambda: set(child_processes()) <= children0, 30,
          lambda: f"child processes outlived the agent: "
          f"{sorted(set(child_processes()) - children0)}")
    print(f"agent config 4: {n_groups} groups on {n_nodes} nodes through "
          f"cli run, eval complete in {row['job1_s']:.3f} s; echo job: "
          f"{n_tasks} tasks dead in {row['job2_s']:.3f} s; cli "
          + ", ".join(f"{k} {v:.3f} s" for k, v in row["cli_s"].items()),
          flush=True)
    print("agent launches: " + json.dumps(launches), flush=True)
    print("agent card: busy "
          + (f"{busy_ms:.2f} ms of {wall:.2f} s, idle "
             f"{row['device_idle_share'] * 100:.2f}%"
             if busy_ms is not None else "not measured"), flush=True)
    row["process"] = agent_process(base)
    print("agent: " + json.dumps(row), flush=True)
    shutil.rmtree(base, ignore_errors=True)
    row["main_path_replay"] = rec.replay(torch, launches, "agent")
    return row


def agent_process(base) -> dict:
    """Phase 9 (b): the agent as an operator runs it, in processes of
    its own (see ``run_agent``)."""
    import signal

    from nomad_tpu_torch.api import APIClient

    def until(cond, timeout, what):
        wait_for(cond, timeout, what, phase="agent process")
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(base, "tmp")
    os.makedirs(tmp, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=repo, PYTHONUNBUFFERED="1",
               TMPDIR=tmp)
    conf = os.path.join(base, "agent.hcl")
    with open(conf, "w") as fh:
        fh.write('log_level = "INFO"\n')
    job = os.path.join(base, "sleep.hcl")
    with open(job, "w") as fh:
        fh.write(AGENT_SLEEP_HCL)
    argv = [sys.executable, "-m", "nomad_tpu_torch.cli", "agent", "-dev",
            "-http-port", "0", "-rpc-port", "0", "-config", conf]
    if DEV == "cpu":
        argv += ["-device", "cpu"]
    row: dict = {}
    lines: list = []
    tasks: set = set()
    # The card's contexts before the agent: this process's own.
    apps0 = compute_apps() if DEV != "cpu" else []
    err = open(os.path.join(base, "agent.stderr"), "w")
    t = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              name="agent-stdout")
    reader.start()
    try:
        until(lambda: any("HTTP: " in ln for ln in lines)
              or proc.poll() is not None, 120, "the agent never served")
        require(proc.poll() is None, f"agent process: exited "
                f"{proc.returncode}: {''.join(lines)}")
        url = next(ln for ln in lines if "HTTP: " in ln).split(
            "HTTP: ", 1)[1].strip()
        row["boot_s"] = time.perf_counter() - t
        api = APIClient(url)

        def run_cli(*args):
            t = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "nomad_tpu_torch.cli", "-address",
                 url] + list(args), cwd=repo, env=env, capture_output=True,
                text=True, timeout=120)
            row.setdefault("cli_s", {})[args[0]] = time.perf_counter() - t
            require(out.returncode == 0, f"agent process: cli "
                    f"{' '.join(args)} exited {out.returncode}: "
                    f"{out.stdout} {out.stderr}")
            return out.stdout
        until(lambda: len(api.nodes_list()[0]) == 1, 60,
              "the agent's client did not register")
        out = run_cli("run", job)
        require("Evaluation status: complete" in out,
                f"agent process: cli run printed {out!r}")

        def running():
            return [a for a in api.job_allocations("agent-sleep")[0]
                    if a.client_status == "running"]
        until(lambda: len(running()) == 2, 60, "the sleepers did not run")
        out = run_cli("status", "agent-sleep")
        require(all(a.id in out for a in running()),
                f"agent process: status printed {out!r}")
        out = run_cli("alloc-status", running()[0].id)
        require("Client     = running" in out,
                f"agent process: alloc-status printed {out!r}")
        tasks = sleepers(proc.pid)
        require(len(tasks) == 2, f"agent process: sleepers {tasks}")
        if DEV != "cpu":
            apps = compute_apps()
            row["card_contexts"] = dict(before=apps0, running=apps)
            require(len(apps) == len(apps0) + 1,
                    f"agent process: nvidia-smi lists {apps} with the "
                    f"agent running, {apps0} before it")
        with open(conf, "w") as fh:
            fh.write('log_level = "WARN"\n')
        proc.send_signal(signal.SIGHUP)
        until(lambda: any("reloaded: log_level" in ln for ln in lines), 30,
              lambda: f"SIGHUP not reported: {''.join(lines)}")
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
        row["sigterm_s"] = time.perf_counter() - t
        require(rc == 0, f"agent process: SIGTERM exit {rc}")
        until(lambda: not [p for p in tasks if alive(p)], 30,
              lambda: f"tasks outlived the agent: {tasks}")
        if DEV != "cpu":
            until(lambda: len(compute_apps()) == len(apps0), 30,
                  lambda: f"the agent's context outlived it: "
                  f"{compute_apps()}")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
        for pid in tasks:
            if alive(pid):
                os.kill(pid, signal.SIGKILL)
        reader.join(30)
        err.close()
    require(any("shutting down" in ln for ln in lines),
            f"agent process: {''.join(lines)}")
    print("agent process: " + json.dumps(row), flush=True)
    return row


# -- phase 10: failover (networked raft, hard leader kills, the card) -------

FAILOVER_NODES = 10_000    # config 4's fleet
FAILOVER_GROUPS = 1000     # config 4's job
FAILOVER_KILLS = 3
# Entries between raft compactions: the fleet's registration compacts
# twice, and a kill round's downtime stays well under one threshold, so
# a victim rebooted at once rejoins by log replay while the round that
# keeps its victim down until the leader compacted past the victim's
# last entry rejoins by InstallSnapshot.
FAILOVER_SNAPSHOT = 4096
FAILOVER_REJOINS = ("replay", "snapshot", "replay")
# Raft's election timeout range and heartbeat interval (s).  The JAX
# package's defaults, (0.15, 0.30) and 0.05, starve in one interpreter
# that holds three servers, the fleet's swarm and config 4's commits
# (PERF.md §6): those servers held no leader for a minute.
FAILOVER_ELECTION = (1.0, 2.0)
FAILOVER_HEARTBEAT = 0.1
# After the last round the probe writes on until it has written once
# since the last kill, for at most this long (s): a round can end
# before the cluster takes a write again (the probe's first ack after
# a kill has come 50.6 s after it in a passing run), and every earlier
# kill has the later rounds to show its recovery in.
FAILOVER_PROBE_WAIT = 120.0


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class FailoverWatch:
    """The failover phase's class-level hooks over every server of the
    process: each leadership gain (``NetRaft._become_leader``), each
    leadership bring-up done (``Server.establish_leadership``), each
    InstallSnapshot a follower installed, each snapshot persisted (its
    size), each commit job that committed plans (its applier and end
    instant) and each fleet build (``build_fleet``: thread and host
    span).  ``restore`` puts the originals back."""

    def __init__(self) -> None:
        from nomad_tpu_torch.models import fleet
        from nomad_tpu_torch.server.plan_apply import PlanApplier
        from nomad_tpu_torch.server.raft import SnapshotStore
        from nomad_tpu_torch.server.raft_net import NetRaft
        from nomad_tpu_torch.server.server import Server

        self.gains: list = []     # (t, raft)
        self.established: list = []  # (t, server) leadership bring-up done
        self.installs: list = []  # (t, raft, index, bytes)
        self.snapshots: list = []  # bytes of each persisted snapshot
        self.commits: list = []   # (t_end, applier)
        self.builds: list = []    # (t0, t1, thread ident)
        self._lock = threading.Lock()
        watch = self
        become = NetRaft.__dict__["_become_leader"]
        install = NetRaft.__dict__["_handle_install_snapshot"]
        save = SnapshotStore.__dict__["save"]
        commit = PlanApplier.__dict__["_commit_job"]
        establish = Server.__dict__["establish_leadership"]
        build = fleet.build_fleet

        def _become_leader(self):
            with watch._lock:
                watch.gains.append((time.perf_counter(), self))
            return become(self)

        def _handle_install_snapshot(self, args):
            before = self._last_applied
            out = install(self, args)
            if self._last_applied > before and \
                    self._snap_index == args["last_included_index"]:
                with watch._lock:
                    watch.installs.append((time.perf_counter(), self,
                                           self._snap_index,
                                           len(args["data"])))
            return out

        def _save(self, index, blob):
            out = save(self, index, blob)
            with watch._lock:
                watch.snapshots.append(len(blob))
            return out

        def _commit_job(self, *a, **kw):
            before = self.plans_committed
            try:
                return commit(self, *a, **kw)
            finally:
                if self.plans_committed > before:
                    with watch._lock:
                        watch.commits.append((time.perf_counter(), self))

        def establish_leadership(self):
            out = establish(self)
            if self.is_leader():
                with watch._lock:
                    watch.established.append((time.perf_counter(), self))
            return out

        def build_fleet(nodes):
            t = time.perf_counter()
            try:
                return build(nodes)
            finally:
                with watch._lock:
                    watch.builds.append((t, time.perf_counter(),
                                         threading.get_ident()))

        self._saved = [(NetRaft, "_become_leader", become),
                       (NetRaft, "_handle_install_snapshot", install),
                       (SnapshotStore, "save", save),
                       (PlanApplier, "_commit_job", commit),
                       (Server, "establish_leadership", establish),
                       (fleet, "build_fleet", build)]
        for owner, name, fn in zip(
                [s[0] for s in self._saved], [s[1] for s in self._saved],
                (_become_leader, _handle_install_snapshot, _save,
                 _commit_job, establish_leadership, build_fleet)):
            setattr(owner, name, fn)

    def restore(self) -> None:
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


class ThreadLaunches:
    """A kernel wrapper (a Recording), counting its launches by the
    thread that made them; ``launches`` stays the wrapper's own."""

    def __init__(self, fn) -> None:
        self.fn = fn
        self.by_thread: dict = {}
        self._lock = threading.Lock()

    @property
    def __name__(self) -> str:
        return self.fn.__name__

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.launches = value

    def __call__(self, *a, **kw):
        before = self.fn.launches
        try:
            return self.fn(*a, **kw)
        finally:
            n = self.fn.launches - before
            if n:
                ident = threading.get_ident()
                with self._lock:
                    self.by_thread[ident] = self.by_thread.get(ident, 0) + n


def register_until(swarm, deadline_s) -> int:
    """Register the swarm's fleet (``AgentSwarm.register_all``), then
    register again each agent whose registration failed (a leader
    change under the registration's load: "no cluster leader", a reset
    forward) until every one landed or ``deadline_s`` passed; each
    landed agent starts heartbeating at once.  Returns the failed
    registrations retried."""
    retried = 0
    deadline = time.monotonic() + deadline_s
    pending = list(range(swarm.n_agents))
    while pending:
        require(time.monotonic() < deadline,
                f"failover: {len(pending)} nodes never registered")
        failed: list = []
        cond = threading.Condition()
        state = {"inflight": 0, "done": 0}

        def finish(i, exc):
            with cond:
                state["inflight"] -= 1
                state["done"] += 1
                if exc is not None:
                    failed.append(i)
                cond.notify_all()
            if exc is None:
                swarm._wheel.arm(f"hb:{i}", swarm._rng.uniform(0.05, 5.0))
        for i in pending:
            with cond:
                while state["inflight"] >= 128:
                    cond.wait(5.0)
                state["inflight"] += 1
            swarm._call_async(
                swarm._chans[i % len(swarm._chans)], "Node.Register",
                {"node": swarm._nodes[i].to_dict()},
                lambda _r, e, i=i: finish(i, e), timeout=swarm.rpc_timeout)
        with cond:
            while state["done"] < len(pending):
                cond.wait(5.0)
        retried += len(failed)
        pending = sorted(failed)
        if pending:
            time.sleep(0.5)
    return retried


def store_payload(state) -> tuple:
    """The store as ``store_digest`` serializes it: (the per-table raft
    indexes, and per table its objects by key as plain dicts), each
    alloc's embedded job replaced by the digest of that job's dict,
    computed once a job object."""
    import dataclasses
    import hashlib

    import msgpack

    from nomad_tpu_torch.state.store import TABLES
    from nomad_tpu_torch.structs.model import _to_plain

    t = state.snapshot()._t
    jobs: dict = {}

    def job_digest(job):
        if job is None:
            return None
        if id(job) not in jobs:
            jobs[id(job)] = (job, hashlib.sha256(msgpack.packb(
                job.to_dict(), use_bin_type=True)).hexdigest())
        return jobs[id(job)][1]

    def plain(obj, table):
        if table != "allocs":
            return obj.to_dict()
        return {f.name: job_digest(obj.job) if f.name == "job"
                else _to_plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    indexes = {name: t.indexes.get(name, 0) for name in TABLES}
    tables = {name: {key: plain(o, name) for key, o in t.tables[name].items()}
              for name in TABLES}
    return indexes, tables


def store_digest(state) -> str:
    """The store's fingerprint (``StateStore.fingerprint``: every
    table's objects sorted by id, and the per-table raft indexes; the
    alloc changelog left out, as a restored store's starts empty) with
    each alloc's embedded job replaced by the digest of that job's
    dict (``store_payload``).  The fingerprint itself serializes the
    whole job again for each alloc: 56 s for one 1,000-group job's
    allocs on a CPU, minutes for the failover phase's stores."""
    import hashlib

    import msgpack

    indexes, tables = store_payload(state)
    payload = {
        "indexes": indexes,
        "tables": {name: sorted(objs.values(), key=lambda d: d.get("id", ""))
                   for name, objs in tables.items()}}
    return hashlib.sha256(msgpack.packb(payload,
                                        use_bin_type=True)).hexdigest()


def store_differences(stores, first_ids: int = 5) -> str:
    """Where the stores ``{server: state}`` differ, for a failure
    message: per server, each table's digest (its raft index and its
    objects by key, as ``store_digest`` serializes them); then the first
    table whose digests differ, its indexes, and the first
    ``first_ids`` keys whose objects differ or that only some stores
    hold."""
    import hashlib

    import msgpack

    def digest(x) -> str:
        return hashlib.sha256(msgpack.packb(
            x, use_bin_type=True)).hexdigest()[:16]

    per = {}
    for i, st in stores.items():
        indexes, tables = store_payload(st)
        per[i] = {name: (indexes[name],
                         {key: digest(obj) for key, obj in objs.items()})
                  for name, objs in tables.items()}
    tables = {i: {name: digest([index, sorted(objs.items())])
                  for name, (index, objs) in t.items()}
              for i, t in per.items()}
    lines = [f"server {i}: " + json.dumps(d) for i, d in tables.items()]
    for name in next(iter(tables.values())):
        if len({d[name] for d in tables.values()}) == 1:
            continue
        keys = sorted(set().union(*(per[i][name][1] for i in per)), key=str)
        differ = [k for k in keys
                  if len({per[i][name][1].get(k) for i in per}) > 1]
        lines.append(
            f"first table that differs: {name}, indexes "
            + json.dumps({str(i): per[i][name][0] for i in per})
            + f", {len(differ)} keys differ, the first {first_ids}: "
            + json.dumps([str(k) for k in differ[:first_ids]])
            + ", held by servers " + json.dumps(
                {str(k): [str(i) for i in per if k in per[i][name][1]]
                 for k in differ[:first_ids]}))
        break
    return "\n".join(lines)


def settle_applied(servers, quiet_s=1.0, timeout=120.0) -> dict:
    """Wait until every server of ``servers`` ({key: server}) has
    applied the same raft index and no applied index has moved for
    ``quiet_s``; returns those indexes.  Fails after ``timeout``."""
    deadline = time.monotonic() + timeout
    last, since = None, time.monotonic()
    while True:
        now = {i: s.raft.applied_index() for i, s in servers.items()}
        if now != last or len(set(now.values())) != 1:
            last, since = now, time.monotonic()
        elif time.monotonic() - since >= quiet_s:
            return now
        require(time.monotonic() < deadline,
                f"failover: the servers' applied indexes did not settle "
                f"in {timeout:.0f} s: {now}")
        time.sleep(0.05)


def server_threads(srv) -> set:
    """The idents of a server's scheduling workers and its applier."""
    idents = {w._thread.ident for w in srv.workers
              if w._thread is not None}
    if srv.plan_applier._thread is not None:
        idents.add(srv.plan_applier._thread.ident)
    return idents


def failover_split(torch, watch, stamps, srv, t0, t1) -> dict:
    """What ``srv``'s own threads did on the card between ``t0`` and
    ``t1`` (host clock): the fleet builds' host ms, and from the stamped
    device timeline the device ms of its uploads (``put_counted``,
    ``ensure_on_default``), its fetches (``copy_to_host_async``) and its
    kernel launches, each by name."""
    idents = server_threads(srv)
    out = dict(build_host_ms=sum(
        (b1 - b0) * 1e3 for b0, b1, ident in watch.builds
        if ident in idents and t0 <= b0 <= t1))
    torch.cuda.synchronize()
    upload = fetch = 0.0
    kernels_ms: dict = {}
    for name, start, end, ident, t in stamps:
        if ident not in idents or not t0 <= t <= t1:
            continue
        ms = start.elapsed_time(end)
        if name in ("put_counted", "ensure_on_default"):
            upload += ms
        elif name == "copy_to_host_async":
            fetch += ms
        else:
            kernels_ms[name] = kernels_ms.get(name, 0.0) + ms
    out.update(upload_device_ms=upload, fetch_device_ms=fetch,
               kernel_device_ms=sum(kernels_ms.values()),
               kernels=kernels_ms)
    return out


def failover_timeline(torch):
    """The stamped device timeline the failover phase splits per kill
    (a CPU rehearsal stubs it)."""
    return device_timeline(torch)


def first_job_reference(nodes, job) -> dict:
    """Config 4's job on one server on DEV (in-memory raft), over
    ``nodes`` registered in the order the cluster's store holds them:
    alloc name -> node id."""
    from nomad_tpu_torch.server import Server, ServerConfig

    srv = Server(ServerConfig(device=DEV, num_schedulers=0,
                              tune_gc=False))
    try:
        for node in nodes:
            srv.node_register(node)
        srv.establish_leadership()
        srv.config.num_schedulers = 2
        srv._setup_workers()
        _, eid = srv.job_register(job)
        srv.wait_for_evals([eid], timeout=600)
        return {a.name: a.node_id for a in srv.fsm.state.allocs_by_job(
            job.id) if not a.terminal_status()}
    finally:
        srv.shutdown()


def run_failover(torch, n_nodes=FAILOVER_NODES, n_groups=FAILOVER_GROUPS,
                 kills=FAILOVER_KILLS, snapshot_threshold=FAILOVER_SNAPSHOT,
                 rejoins=FAILOVER_REJOINS, election=FAILOVER_ELECTION,
                 heartbeat=FAILOVER_HEARTBEAT):
    """The failover phase, bench 5e's failover at config 4's width on
    the card.  Three durable ``raft_mode="net"`` servers in this process
    (``device=DEV``, their own data_dirs and RPC ports, the JAX
    package's raft timings, ``snapshot_threshold`` entries a
    compaction), under the ``device`` verify policy.  An
    ``AgentSwarm`` registers ``n_nodes`` mock nodes through the leader's
    RPC port and heartbeats them; a probe writer on its own pool
    re-upserts one terminal eval (``Eval.Update``, no nodes-table
    write, so no fleet generation moves) every few ms on every server
    in turn.  The launch counts are set to 0 once the fleet is ready
    and read at the end.  The first job (config 4's: ``n_groups``
    groups) goes through ``Job.Register`` and completes.  Then
    ``kills`` rounds: two submitters each send one more config 4 job;
    the leader is hard-killed
    (``CrashHarness.kill``: storage frozen, ``abandon``) once both
    are acked, while their evals are being placed; the survivors
    elect; the victim reboots from its data_dir (``rejoins[k]``:
    "replay" at once, "snapshot" once the leader compacted past the
    victim's last entry, writing filler ``Eval.Update``s until then)
    and must reach the leader's commit index; the burst is placed
    before the next round.  Per kill: election
    latency, recovery (kill -> the probe's first ack after it) and
    unavailability (its last ack before -> first after), the new
    leader's first committed plan from the kill, split into its fleet
    build (host), uploads, fetches and kernels (device, CUDA events on
    its own threads), the rejoin's catch-up and whether it rode
    InstallSnapshot or log replay.  Checks: every eval complete,
    identical store digests on the three servers, each group of each
    job placed once, no node over capacity, ``committed_plan_loss`` 0
    (every acked job, every alloc a dead leader had applied, the probe
    eval), K3 or K4a launched by an elected leader's worker, K6
    dispatched by an elected leader with no applier falling back to the
    host (no lease miss), one rejoin of each kind; the first job's
    placements equal a single server's on the same fleet.  Prints the
    elections no kill caused and the snapshot sizes.  Teardown leaves
    no thread."""
    import gc
    import shutil

    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.agent import AgentSwarm
    from nomad_tpu_torch.faultinject.crash import CrashHarness
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.ops.verify_policy import verify_override
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.rpc import ConnPool

    def until(cond, timeout, what):
        wait_for(cond, timeout, what, phase="failover")
    require(len(rejoins) == kills, "failover: one rejoin policy a kill")
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "nomad_tpu_torch", "_build", "failover_phase")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    thresholds = gc.get_threshold()
    before = set(threading.enumerate())
    ports = [free_port() for _ in range(3)]
    peers = [("127.0.0.1", p) for p in ports]

    def cfg(i):
        return ServerConfig(
            device=DEV, data_dir=os.path.join(base, f"s{i}"),
            raft_mode="net", rpc_port=ports[i], raft_peers=list(peers),
            num_schedulers=2, raft_snapshot_threshold=snapshot_threshold,
            raft_election_timeout=tuple(election),
            raft_heartbeat_interval=heartbeat)

    first_job, = storm_jobs(mock, structs, "failover-first", 1, n_groups)
    rounds = [storm_jobs(mock, structs, f"failover-{k}", 2, n_groups)
              for k in range(kills)]
    probe_ev = structs.Evaluation(
        id=structs.generate_uuid(), priority=50, type="service",
        triggered_by="failover-probe", job_id="failover-probe",
        status=structs.EVAL_STATUS_COMPLETE)
    row: dict = dict(nodes=n_nodes, groups=n_groups, kills=kills,
                     snapshot_threshold=snapshot_threshold,
                     election_timeout=list(election),
                     heartbeat_interval=heartbeat)
    watch = FailoverWatch()
    harness = CrashHarness()
    pool, probe_pool, fill_pool = ConnPool(), ConnPool(), ConnPool()
    stop = threading.Event()
    alive: dict = {}
    swarm = None
    threads: list = []
    probe_log: list = []     # (t_start, t_end, error or None)
    acked: dict = {}
    errors: list = []
    husk_allocs: set = set()
    elected: list = []       # servers that won a post-kill election
    kill_rows: list = []
    rr = [0]

    def addr_fn():
        targets = list(alive.values())
        rr[0] += 1
        return targets[rr[0] % len(targets)].rpc_address()

    def leader_of(timeout=60.0):
        found = []

        def one():
            leaders = [s for s in list(alive.values())
                       if s.raft.is_leader() and s.is_leader()]
            if len(leaders) == 1:
                found[:] = leaders
                return True
            return False
        until(one, timeout, "no single leader")
        return found[0]

    def probe():
        while not stop.is_set():
            t = time.perf_counter()
            try:
                probe_pool.call(addr_fn(), "Eval.Update",
                                {"evals": [probe_ev.to_dict()]},
                                timeout=0.25)
                probe_log.append((t, time.perf_counter(), None))
            except Exception as e:
                probe_log.append((t, time.perf_counter(),
                                  f"{type(e).__name__}: {e}"[:120]))
            time.sleep(0.004)

    def submit(job):
        end = time.monotonic() + 300.0
        while not stop.is_set():
            try:
                resp = pool.call(addr_fn(), "Job.Register",
                                 {"job": job.to_dict()}, timeout=30.0)
                acked[job.id] = resp["index"]
                return
            except Exception as e:
                if time.monotonic() >= end:
                    errors.append(f"{job.id}: {e}")
                    return
                time.sleep(0.05)

    with recorded_kernels() as rec, verify_override("device"), \
            failover_timeline(torch) as stamps:
        rounds_k = {name: ThreadLaunches(rec.counters[name])
                    for name in ("place_rounds", "place_rounds_batch")}
        saved_k = (binpack.place_rounds, binpack.place_rounds_batch)
        binpack.place_rounds = rounds_k["place_rounds"]
        binpack.place_rounds_batch = rounds_k["place_rounds_batch"]
        try:
            t = time.perf_counter()
            for i in range(3):
                alive[i] = Server(cfg(i))
            leader = leader_of()
            row["boot_s"] = time.perf_counter() - t
            t = time.perf_counter()
            swarm = AgentSwarm(leader.rpc_address(), n_nodes, conns=16,
                               hb_conns=4, beat_interval=20.0, seed=13,
                               node_factory=wire_node(mock),
                               long_polls=False)
            row["register_retries"] = register_until(swarm, 600.0)
            row["elections_while_registering"] = len(watch.gains) - 1
            until(lambda: all(len(s.fsm.state.nodes()) == n_nodes
                              for s in alive.values()), 300,
                  "the fleet did not reach every server")
            row["register_s"] = time.perf_counter() - t
            row["registered_per_s"] = n_nodes / row["register_s"]
            print(f"failover: 3 servers up in {row['boot_s']:.2f} s; "
                  f"{n_nodes} nodes registered through the cluster in "
                  f"{row['register_s']:.2f} s "
                  f"({row['registered_per_s']:.1f}/s), "
                  f"{row['register_retries']} registrations retried, "
                  f"{row['elections_while_registering']} elections",
                  flush=True)
            gains0 = len(watch.gains)
            for fn in rec.counters.values():
                fn.launches = 0
            prober = threading.Thread(target=probe, daemon=True,
                                      name="failover-probe")
            prober.start()
            threads.append(prober)

            # The first job, on the fleet as the cluster holds it.
            leader = leader_of()
            order = [n.copy() for n in leader.fsm.state.nodes()]
            t = time.perf_counter()
            submit(first_job)
            require(first_job.id in acked, f"failover: {errors}")
            until(lambda: [e.status for e in leader_of().fsm.state
                           .evals_by_job(first_job.id)] == ["complete"],
                  300, "the first job did not complete")
            row["first_job_s"] = time.perf_counter() - t
            first = {a.name: a.node_id for a in leader_of().fsm.state
                     .allocs_by_job(first_job.id)
                     if not a.terminal_status()}

            t_rounds = time.perf_counter()
            for k in range(kills):
                lanes = [threading.Thread(target=submit, args=(job,),
                                          daemon=True,
                                          name=f"failover-submit-{k}-{i}")
                         for i, job in enumerate(rounds[k])]
                threads.extend(lanes)
                n_acked = len(acked)
                for lane in lanes:
                    lane.start()
                # The kill lands once the burst's registrations are
                # acked, while their evals are being placed: a
                # registration retried across a kill would register the
                # job again, and that version's in-place update embeds
                # the 214 KB job in each of its 1,000 allocs, a raft
                # entry past the RPC plane's 128 MB frame (ROADMAP
                # Queue 3).
                until(lambda: len(acked) >= n_acked + len(lanes)
                      or errors, 120,
                      f"kill {k}: the burst's jobs were not acked")
                require(not errors, f"failover: {errors}")
                leader = leader_of()
                victim = next(i for i, s in alive.items() if s is leader)
                t_kill = time.perf_counter()
                harness.kill(leader)
                del alive[victim]
                # Frozen storage: nothing more enters the husk's log,
                # in memory or on disk.
                with leader.raft._lock:
                    husk_last = leader.raft._last_index()
                husk_allocs.update(a.id for a in leader.fsm.state.allocs())
                new = leader_of()
                t_elected = time.perf_counter()
                elected.append(new)
                kr = dict(kill=k, victim=victim,
                          leader=next(i for i, s in alive.items()
                                      if s is new),
                          election_ms=(t_elected - t_kill) * 1e3)
                firsts = []

                def placed():
                    return all(e.terminal_status() for j in rounds[k]
                               for e in new.fsm.state.evals_by_job(j.id))

                def first_plan():
                    firsts[:] = [t for t, applier in list(watch.commits)
                                 if applier is new.plan_applier
                                 and t > t_kill]
                    return bool(firsts) or placed()
                until(first_plan, 300,
                      f"kill {k}: the new leader committed no plan")
                # None: the dead leader had committed the whole burst.
                kr["first_plan_ms"] = (firsts[0] - t_kill) * 1e3 \
                    if firsts else None
                # Leadership's bring-up (barrier, broker restore) done.
                ready = [t for t, srv in list(watch.established)
                         if srv is new and t > t_kill]
                kr["established_ms"] = (ready[0] - t_kill) * 1e3 \
                    if ready else None
                if firsts:
                    kr.update(failover_split(torch, watch, stamps, new,
                                             t_kill, firsts[0]))
                fillers = [0]
                if rejoins[k] == "snapshot":
                    # The victim stays down, four writers filling the
                    # log, until the leader compacted past its last
                    # entry.
                    def compacted():
                        with new.raft._lock:
                            return new.raft._log_base_index > husk_last
                    deadline = time.monotonic() + 300.0

                    def fill():
                        while not compacted() and \
                                time.monotonic() < deadline:
                            try:
                                fill_pool.call(
                                    addr_fn(), "Eval.Update",
                                    {"evals": [probe_ev.to_dict()]},
                                    timeout=30.0)
                                fillers[0] += 1
                            except Exception:
                                time.sleep(0.01)  # a leader change
                    writers = [threading.Thread(
                        target=fill, daemon=True,
                        name=f"failover-fill-{i}") for i in range(4)]
                    for w in writers:
                        w.start()
                    for w in writers:
                        w.join(310)
                    require(compacted(), f"failover kill {k}: the leader "
                            "never compacted past the victim's log")
                t_boot = time.perf_counter()
                reborn = harness.reboot(cfg(victim))
                alive[victim] = reborn
                kr["reboot_ms"] = (time.perf_counter() - t_boot) * 1e3
                target = leader_of().raft.applied_index()
                until(lambda: reborn.raft.applied_index() >= target, 300,
                      f"kill {k}: the rebooted server did not catch up")
                kr["rejoin_ms"] = (time.perf_counter() - t_boot) * 1e3
                rode = [i for i in watch.installs if i[1] is reborn.raft]
                kr["rejoin"] = "InstallSnapshot" if rode else "log replay"
                kr["install_bytes"] = rode[0][3] if rode else 0
                kr["filler_writes"] = fillers[0]
                kr["policy"] = rejoins[k]
                for lane in lanes:
                    lane.join(300)
                require(not errors and all(j.id in acked
                                           for j in rounds[k]),
                        f"failover kill {k}: submissions {errors}")
                # The burst is placed before the next round kills.
                until(lambda: all(e.terminal_status() for j in rounds[k]
                                  for e in leader_of().fsm.state
                                  .evals_by_job(j.id)), 300,
                      f"kill {k}: the burst was not placed")
                kr["round_ms"] = (time.perf_counter() - t_kill) * 1e3
                print(f"failover kill {k}: " + json.dumps(kr), flush=True)
                kill_rows.append((t_kill, kr))

            row["rounds_s"] = time.perf_counter() - t_rounds
            t_last = kill_rows[-1][0] if kill_rows else t_rounds
            deadline = time.monotonic() + FAILOVER_PROBE_WAIT
            while time.monotonic() < deadline and not any(
                    err is None and t1 > t_last
                    for _t0, t1, err in list(probe_log)):
                time.sleep(0.05)
            row["probe_wait_s"] = time.perf_counter() - t_rounds \
                - row["rounds_s"]
            t_checks = time.perf_counter()
            stop.set()
            for t in threads:
                t.join(60)
            leader = leader_of()
            state = leader.fsm.state
            jobs = [first_job] + [j for r in rounds for j in r]

            def terminal():
                evs = [e for j in jobs for e in state.evals_by_job(j.id)]
                return evs and all(e.terminal_status() for e in evs)
            until(terminal, 300, "evals did not finish")
            until(lambda: len({s.raft.applied_index()
                               for s in alive.values()}) == 1, 120,
                  "the servers did not apply the same log")
            # What only the live cluster can say, read before it goes.
            elected_idents = set()
            for srv in elected:
                elected_idents |= {w._thread.ident for w in srv.workers
                                   if w._thread is not None}
            by_elected = {name: sum(n for ident, n in k.by_thread.items()
                                    if ident in elected_idents)
                          for name, k in rounds_k.items()}
            row["elected_launches"] = by_elected
            fallbacks = sum(s.plan_applier.stats()["device_verify_fallbacks"]
                            for s in list(alive.values()) + harness.dead)
            k6 = sum(s.plan_applier.stats()["device_verify_dispatches"]
                     for s in {id(s): s for s in elected}.values())
            row.update(device_verify_dispatches_elected=k6,
                       device_verify_fallbacks=fallbacks)
            row["elections_not_caused_by_a_kill"] = \
                len(watch.gains) - gains0 - kills
            t_start = watch.gains[0][0]
            row["leadership_gains_s"] = [round(t - t_start, 3)
                                         for t, _raft in watch.gains]
            row["kills_s"] = [round(t - t_start, 3) for t, _kr in kill_rows]
            row["snapshot_bytes_max"] = max(watch.snapshots, default=0)
            row["snapshots_persisted"] = len(watch.snapshots)
            row["swarm"] = swarm.stats()
            launches = {k: fn.launches for k, fn in rec.counters.items()}
            row["launches"] = launches
            # The stores are read with the cluster stopped: a digest of
            # 10,000 nodes holds the interpreter long enough to starve
            # raft's heartbeats.
            swarm.stop()
            swarm = None
            # A follower applies what the leader committed a heartbeat
            # later, and an entry can commit after the wait above: the
            # stores are read once every live server has applied one
            # index and none has moved for a second, and with raft
            # stopped on every server, the leader first (servers shut
            # down one by one would let the last two elect a leader
            # whose broker restore writes evals the first no longer
            # applies).
            settle_applied(alive)
            for srv in sorted(alive.values(),
                              key=lambda s: not s.raft.is_leader()):
                srv.raft.shutdown()
            applied = {i: s.raft.applied_index() for i, s in alive.items()}
            stores = {i: s.fsm.state for i, s in alive.items()}
            t_reap = time.perf_counter()
            harness.reap(also=list(alive.values()))
            reaped = {i: s.raft.applied_index() for i, s in alive.items()}
            alive.clear()
            row["reap_s"] = time.perf_counter() - t_reap
            bad = sorted({e.status for j in jobs
                          for e in state.evals_by_job(j.id)} - {"complete"})
            require(not bad, f"failover: evals ended {bad}")
            for job in jobs:
                live = [a for a in state.allocs_by_job(job.id)
                        if not a.terminal_status()]
                names = [a.name for a in live]
                require(len(names) == len(set(names)) == n_groups,
                        f"failover: job {job.id} has {len(names)} live "
                        f"allocs, {len(set(names))} names, want {n_groups}")
            final_ids = {a.id for a in state.allocs()}
            lost = [j.id for j in jobs if state.job_by_id(j.id) is None]
            lost += sorted(husk_allocs - final_ids)
            if state.eval_by_id(probe_ev.id) is None:
                lost.append(probe_ev.id)
            row["committed_plan_loss"] = len(lost)
            require(not lost, f"failover: committed writes lost: {lost[:5]}")
            for node in state.nodes():
                fit, dim, _ = structs.allocs_fit(
                    node, [a for a in state.allocs_by_node(node.id)
                           if not a.terminal_status()])
                require(fit, f"failover: node {node.name} oversubscribed "
                        f"on {dim}")
            t_digest = time.perf_counter()
            digests = {i: store_digest(st) for i, st in stores.items()}
            row["digest_s"] = time.perf_counter() - t_digest
            if len(set(digests.values())) != 1:
                raise SmokeError(
                    f"failover: the stores differ: {digests}; applied "
                    f"indexes {applied} with raft stopped, {reaped} after "
                    "the reap\n"
                    + store_differences(stores))
            row["digest"] = next(iter(digests.values()))
            row["applied_index"] = next(iter(applied.values()))
            if DEV != "cpu":
                require(sum(by_elected.values()) > 0,
                        "failover: no elected leader launched K3 or K4a")
            require(fallbacks == 0, f"failover: {fallbacks} windows fell "
                    "back to the host engine (a lease miss)")
            require(k6 > 0, "failover: no elected leader launched K6")
            kinds = {kr["rejoin"] for _t, kr in kill_rows}
            require(kinds == {"InstallSnapshot", "log replay"},
                    f"failover: rejoins rode {sorted(kinds)}")
            ok_acks = [t1 for _t0, t1, err in probe_log if err is None]
            for t_kill, kr in kill_rows:
                after = [t1 for t1 in ok_acks if t1 > t_kill]
                before_k = [t1 for t1 in ok_acks if t1 <= t_kill]
                if not after:
                    tried = [err for t0, _t1, err in probe_log
                             if t0 > t_kill]
                    seen: dict = {}
                    for err in tried:
                        seen[err] = seen.get(err, 0) + 1
                    span = max((t1 for _t0, t1, _e in probe_log),
                               default=t_kill) - t_kill
                    raise SmokeError(
                        f"failover kill {kr['kill']}: the probe never "
                        f"wrote again in {len(tried)} attempts over "
                        f"{span:.1f} s from the kill (the probe ran "
                        f"{row['probe_wait_s']:.1f} s past the last "
                        f"round); their commonest errors: "
                        + json.dumps(dict(sorted(
                            seen.items(), key=lambda kv: -kv[1])[:5])))
                kr["recovery_ms"] = (after[0] - t_kill) * 1e3
                kr["unavailability_ms"] = (after[0] - (
                    before_k[-1] if before_k else t_kill)) * 1e3
            row["checks_s"] = time.perf_counter() - t_checks
            row["kills_detail"] = [kr for _t, kr in kill_rows]
            row["probe_writes_ok"] = len(ok_acks)
            row["probe_writes_failed"] = len(probe_log) - len(ok_acks)
            errs: dict = {}
            for _t0, _t1, err in probe_log:
                if err is not None:
                    kind = err.split(":", 1)[0]
                    errs[kind] = errs.get(kind, 0) + 1
            row["probe_errors"] = errs
        finally:
            stop.set()
            binpack.place_rounds, binpack.place_rounds_batch = saved_k
            if swarm is not None:
                swarm.stop()
            for t in threads:
                t.join(60)
            for p in (pool, probe_pool, fill_pool):
                p.shutdown()
            harness.reap(also=list(alive.values()))
            watch.restore()
            gc.unfreeze()
            gc.set_threshold(*thresholds)
            gc.collect()
        replay = rec.replay(torch, launches, "failover")
    t = time.perf_counter()
    ref = first_job_reference(order, first_job)
    row["reference_s"] = time.perf_counter() - t
    require(ref == first, f"failover: the first job's placements differ "
            f"from a single server's on {sum(ref.get(n) != v for n, v in first.items())} "
            f"of {len(first)} groups")
    until(lambda: not [t for t in threading.enumerate()
                       if t not in before and t.is_alive()], 60,
          lambda: "threads outlived the phase: " + ", ".join(
              t.name for t in threading.enumerate()
              if t not in before and t.is_alive()))
    shutil.rmtree(base, ignore_errors=True)
    row["main_path_replay"] = replay
    print("failover: " + json.dumps(
        {k: v for k, v in row.items() if k != "main_path_replay"}),
        flush=True)
    return row


# -- phase 11: control (the runner's depth under an injected delay) --------

CONTROL_NODES = 1000       # config 2's fleet
CONTROL_ROUNDS = (("warm", 1), ("healthy", 2), ("delayed", 2),
                  ("recovery", 10))
CONTROL_BATCH = 4          # evals a round trip
CONTROL_DELAY_S = 0.05


def control_stream(torch, structs, Harness, PipelinedEvalRunner, nodes, jobs,
                   controlled, seed=23):
    """Config 2's jobs through one PipelinedEvalRunner on DEV at depth 8,
    ``CONTROL_BATCH`` evals a round trip, the Harness committing every
    plan; the round trips of ``CONTROL_ROUNDS``' "delayed" rounds under
    a ``device.dispatch`` delay of ``CONTROL_DELAY_S`` on every
    dispatch.  ``controlled``: ``runner_controller`` ticked by hand
    after each round trip (warm-up samples dropped first).  Returns the
    plans, the depth each round trip ran at with its round's name, the
    RTT gauge after each and the controller's knob stats."""
    from nomad_tpu_torch import faultinject
    from nomad_tpu_torch.control import runner_controller
    from nomad_tpu_torch.faultinject import FaultPlan

    h = stream_cluster(structs, Harness, nodes, jobs)
    random.seed(seed)
    runner = PipelinedEvalRunner(h.snapshot(), h, depth=8,
                                 state_refresh=h.snapshot, device=DEV)
    ctl = None
    trace: list = []
    it = iter(jobs)
    for name, trips in CONTROL_ROUNDS:
        for _ in range(trips):
            batch = [make_eval(structs, next(it))
                     for _ in range(CONTROL_BATCH)]
            depth = runner.depth
            if name == "delayed":
                plan = FaultPlan(seed=5).add(
                    "device.dispatch", "delay", secs=CONTROL_DELAY_S,
                    count=CONTROL_BATCH)
                with faultinject.injected(plan):
                    runner.process(batch)
                require(plan.fire_count("device.dispatch")
                        == CONTROL_BATCH, "control: the delay fired "
                        f"{plan.fire_count('device.dispatch')} times")
            else:
                runner.process(batch)
            rtt = runner.stats()["rtt_ms_ewma"]
            if name == "warm":
                with runner._count_lock:
                    runner._rtt_ewma = 0.0
                if controlled:
                    ctl = runner_controller(runner, seed=7, lo=1, hi=8)
            elif ctl is not None:
                ctl.tick()
            trace.append((name, depth, rtt))
    torch.cuda.synchronize()
    require(runner.device_dispatches == len(jobs)
            and runner.breaker_reruns == 0,
            f"control: {runner.device_dispatches} device dispatches, "
            f"{runner.breaker_reruns} re-runs for {len(jobs)} evals")
    names = {n.id: n.name for n in h.state.nodes()}
    plans = [plan_summary(p, names) for p in h.plans]
    knob = ctl.stats()["knobs"]["pipeline.depth"] if ctl else None
    return plans, trace, knob


def run_control(torch, n_nodes=CONTROL_NODES):
    """The control phase, the card half of the JAX package's
    TestChaosDepthRetreat: config 2's stream (``CONTROL_ROUNDS``) under
    ``runner_controller``, once uncontrolled (the reference), then
    controlled with the launch counts set to 0 just before it and read
    after.  Checks: during the delayed round trips the depth retreats
    below its start, afterwards it climbs back above its lowest; the
    controlled run's plans equal the uncontrolled run's, eval for eval
    (nodes and ports); every eval dispatched to the card, no re-run.
    Prints the knob's trajectory, its reversals and each round trip's
    depth and RTT gauge; the recorded K2/K3 launches are replayed
    against the plain versions."""
    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.scheduler.pipeline import PipelinedEvalRunner

    n_jobs = sum(t for _n, t in CONTROL_ROUNDS) * CONTROL_BATCH
    nodes = [mock.node(i) for i in range(n_nodes)]
    jobs = [config2_job(mock, structs, 1000 + k) for k in range(n_jobs)]
    want, plain_trace, _ = control_stream(
        torch, structs, Harness, PipelinedEvalRunner, nodes, jobs,
        controlled=False)
    require(all(d == 8 for _n, d, _r in plain_trace),
            "control: the uncontrolled runner's depth moved")
    with recorded_kernels() as rec:
        for fn in rec.counters.values():
            fn.launches = 0
        t = time.perf_counter()
        got, trace, knob = control_stream(
            torch, structs, Harness, PipelinedEvalRunner, nodes, jobs,
            controlled=True)
        wall = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in rec.counters.items()}
        replay = rec.replay(torch, launches, "control")
    require(got == want, "control: the controlled run's plans differ "
            "from the uncontrolled run's")
    depths = [d for _n, d, _r in trace]
    delayed_end = max(i for i, (n, _d, _r) in enumerate(trace)
                      if n == "delayed")
    low = min(depths[:delayed_end + 2])
    require(low < 8, f"control: the depth never retreated: {trace}")
    require(max(depths[depths.index(low):]) > low,
            f"control: the depth never climbed back: {trace}")
    row = dict(nodes=n_nodes, evals=n_jobs, wall_s=wall,
               delay_s=CONTROL_DELAY_S, lowest_depth=low,
               final_depth=depths[-1], trajectory=knob["trajectory"],
               reversals=knob["reversals"], rail_hits=knob["rail_hits"],
               trips=[dict(round=n, depth=d, rtt_ms_ewma=r)
                      for n, d, r in trace],
               launches=launches, main_path_replay=replay)
    print("control: " + json.dumps(
        {k: v for k, v in row.items() if k != "main_path_replay"}),
        flush=True)
    return row


# -- phase 12: the system schedulers (config 3) -----------------------------


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


# -- phase 14: the verify engines over a growing fleet ---------------------


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


# -- phase 13: the executor policy and the pipelined eval runner -----------


EXECUTORS = ("host", "device", "auto")


def eval_args(structs, BatchEvalRunner, h, job):
    """One real eval's scheduler and DeviceArgs: ``job`` reconciled and
    prepared on the cluster of ``h``, stopped before its dispatch."""
    h.state.upsert_job(h.next_index(), job)
    runner = BatchEvalRunner(h.snapshot(), RecordOnlyPlanner(structs),
                             device=DEV)
    sched = runner._begin_eval(make_eval(structs, job))
    require(sched is not None and sched.deferred is not None,
            f"executor: {job.id} prepared no dispatch")
    return sched, sched.deferred[1]


def brief(times_s) -> dict:
    """``spread`` without the runs themselves."""
    out = spread(times_s)
    del out["runs_ms"]
    return out


def crossover(torch, shapes, reps=20) -> list:
    """Host-clock time of the three ways an eval's walk can run, on each
    shape's DeviceArgs, ``reps`` times each after one warm call of each,
    in turns whose order rotates: ``dispatch_host`` (the whole numpy
    walk), ``dispatch_device`` alone (what the pipelined front stage
    pays: the uploads, the launch and the start of the result copies;
    the copies' own share, a pinned buffer each, as ``copy_start``) and
    ``dispatch_device`` + ``collect_device`` (a single shot).  The host
    and device walks must agree (chosen nodes exactly, scores where
    placed)."""
    from nomad_tpu_torch.scheduler import torch_binpack
    from nomad_tpu_torch.scheduler.torch_binpack import executor_cost

    copy_async = torch_binpack.copy_to_host_async
    copy_s = [0.0]

    def timed_copy(x):
        s = time.perf_counter()
        try:
            return copy_async(x)
        finally:
            copy_s[0] += time.perf_counter() - s

    rows = []
    for name, sched, args in shapes:
        host = sched.collect_device(args, sched.dispatch_host(args))
        dev = sched.collect_device(
            args, sched.dispatch_device(args, pipelined=True, force=True))
        torch.cuda.synchronize()
        placed = host[0] >= 0
        require(np.array_equal(host[0], dev[0]) and np.allclose(
            host[1][placed], dev[1][placed], rtol=1e-4, atol=1e-4),
            f"executor crossover {name}: host and device walks differ")
        t: dict = {"host": [], "dispatch": [], "copy_start": [],
                   "single_shot": []}

        def run_host():
            s = time.perf_counter()
            sched.dispatch_host(args)
            t["host"].append(time.perf_counter() - s)

        def run_dispatch():
            copy_s[0] = 0.0
            torch_binpack.copy_to_host_async = timed_copy
            try:
                s = time.perf_counter()
                handles = sched.dispatch_device(args, pipelined=True,
                                                force=True)
                t["dispatch"].append(time.perf_counter() - s)
            finally:
                torch_binpack.copy_to_host_async = copy_async
            t["copy_start"].append(copy_s[0])
            sched.collect_device(args, handles)

        def run_single():
            s = time.perf_counter()
            sched.collect_device(args, sched.dispatch_device(
                args, pipelined=False, force=True))
            t["single_shot"].append(time.perf_counter() - s)
        order = [run_host, run_dispatch, run_single]
        for i in range(reps):
            for fn in order[i % 3:] + order[:i % 3]:
                fn()
        steps = args.rounds * args.n_groups if args.rounds_eligible \
            else args.n_place
        rows.append(dict(
            shape=name, n_real=args.statics.n_real,
            n_pad=args.statics.n_pad, rounds_eligible=args.rounds_eligible,
            steps=steps, cost=executor_cost(args),
            **{k: brief(v) for k, v in t.items()}))
    return rows


def storm_crossover(torch, runner, pending, lanes=(1, 4, 16, 64),
                    reps=20) -> list:
    """Host-clock time of a fused storm of the first ``b`` lanes of
    ``pending`` for each ``b`` in ``lanes``, ``reps`` times each side
    after one warm call of each, in turns whose order alternates:
    ``_dispatch_fused_host`` (the numpy twins, lane by lane) and
    ``_dispatch_fused`` (the stacked uploads, one K4a launch and the
    fetch: a single shot).  Both must place alike (chosen nodes exactly,
    scores where placed)."""
    from nomad_tpu_torch.scheduler.batch import fused_cost

    rows = []
    for b in lanes:
        sub = pending[:b]
        host = runner._dispatch_fused_host(sub)
        dev = runner._dispatch_fused(sub)
        torch.cuda.synchronize()
        for h_lane, d_lane in zip(host, dev):
            hc, dc = np.asarray(h_lane[3]), np.asarray(d_lane[3])
            placed = hc >= 0
            require(np.array_equal(hc, dc) and np.allclose(
                np.asarray(h_lane[4])[placed], np.asarray(d_lane[4])[placed],
                rtol=1e-4, atol=1e-4),
                f"executor storm crossover {b} lanes: host and device "
                f"storms differ")
        t: dict = {"host": [], "fused": []}

        def run_host():
            s = time.perf_counter()
            runner._dispatch_fused_host(sub)
            t["host"].append(time.perf_counter() - s)

        def run_fused():
            s = time.perf_counter()
            runner._dispatch_fused(sub)
            t["fused"].append(time.perf_counter() - s)
        order = [run_host, run_fused]
        for i in range(reps):
            for fn in order[i % 2:] + order[:i % 2]:
                fn()
        args = sub[0][2]
        rows.append(dict(
            shape=f"config 5b storm, {b} lanes", lanes=b,
            n_real=args.statics.n_real, n_pad=args.statics.n_pad,
            cost=fused_cost(sub), **{k: brief(v) for k, v in t.items()}))
    return rows


def against_host(rows, storm_rows) -> dict:
    """The crossover rows by the constant they bound: the front stage's
    dispatch (HOST_ALWAYS_COST), and every single shot, an eval's or a
    fused storm's (HOST_SINGLE_SHOT_COST: the storm policy prices a
    storm as one single shot).  Each row: shape, cost, and the host's
    and the card's medians in ms."""
    def pick(table, key):
        return [dict(shape=r["shape"], cost=r["cost"],
                     host=r["host"]["median_ms"], card=r[key]["median_ms"])
                for r in table]
    return {"HOST_ALWAYS_COST": pick(rows, "dispatch"),
            "HOST_SINGLE_SHOT_COST": pick(rows, "single_shot")
            + pick(storm_rows, "fused")}


def consistent(rows, storm_rows, configured) -> list:
    """Shapes the configured constants send the wrong way by a wide
    margin: kept on the host though the card is more than twice as
    fast, or sent to the card though the host is.  Near-ties, where
    either choice costs little, are not counted.  A single shot and a
    fused storm stay on the host up to either constant
    (``host_for_cost``)."""
    limits = {"HOST_ALWAYS_COST": configured["HOST_ALWAYS_COST"],
              "HOST_SINGLE_SHOT_COST": max(configured.values())}
    wrong = []
    for const, table in against_host(rows, storm_rows).items():
        for r in table:
            on_host = r["cost"] <= limits[const]
            if (on_host and r["host"] > 2 * r["card"]) or \
                    (not on_host and r["card"] > 2 * r["host"]):
                wrong.append((const, r["shape"]))
    return wrong


def derive_constants(rows, storm_rows) -> dict:
    """The executor constants the table gives: the largest cost up to
    which the host's median beats the card's at every measured shape,
    walking the shapes by cost up to the first the host loses (0 when
    it loses at the smallest): against the pipelined dispatch for
    HOST_ALWAYS_COST, against every single shot (evals' and fused
    storms') for HOST_SINGLE_SHOT_COST."""
    out = {}
    for const, table in against_host(rows, storm_rows).items():
        value, first_loss = 0, None
        for r in sorted(table, key=lambda r: r["cost"]):
            if r["host"] < r["card"]:
                value = r["cost"]
            else:
                first_loss = r["shape"]
                break
        out[const] = dict(value=value, first_host_loss=first_loss)
    return out


def plan_summary(plan, names) -> tuple:
    """A plan's placements ((alloc name, node name, ports), sorted) and
    its failed allocs' names."""
    return (sorted((name, names[node_id], ports) for name, (node_id, ports)
                   in plan_placements(plan).items()),
            sorted(a.name for a in plan.failed_allocs))


def percentile(values, q) -> float:
    return float(np.percentile(np.asarray(values) * 1e3, q))


def stream_cluster(structs, Harness, nodes, jobs):
    h = Harness(device=DEV)
    for node in nodes:
        h.state.upsert_node(h.next_index(), node.copy())
    for j in jobs:
        h.state.upsert_job(h.next_index(), j)
    return h


class StreamRun:
    """One executor's run of a stream: its plans in submit order (eval
    order) and the runners' counts."""

    def __init__(self) -> None:
        self.plans: list = []
        self.runners: list = []
        self.wall = 0.0
        self.h2d = 0
        self.launches: dict = {}


def pipelined(torch, structs, Harness, PipelinedEvalRunner, nodes,
              streams, *, depth, commit, seed, h=None) -> "StreamRun":
    """``streams`` (lists of jobs) through PipelinedEvalRunner on DEV,
    one runner a stream, each from a snapshot taken when it starts.
    ``commit``: the Harness itself is the planner (every plan is applied
    to its store, so a later stream's first prep syncs the mirror,
    K5); otherwise a record-only planner (every eval sees one store).
    Python's ``random`` (each plan's port generator) is seeded first."""
    from nomad_tpu_torch.models import fleet
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.parallel import devices

    if h is None:
        h = stream_cluster(structs, Harness, nodes,
                           [j for s in streams for j in s])
    planner = h if commit else RecordOnlyPlanner(structs)
    first = len(h.plans)
    run = StreamRun()
    counters = (binpack.place_sequence, binpack.place_rounds,
                fleet.scatter_rows)
    before = [fn.launches for fn in counters]
    t0 = devices.transfer_counts()["h2d"]
    random.seed(seed)
    for jobs in streams:
        runner = PipelinedEvalRunner(h.snapshot(), planner, depth=depth,
                                     device=DEV)
        t = time.perf_counter()
        runner.process([make_eval(structs, j) for j in jobs])
        run.wall += time.perf_counter() - t
        run.runners.append(runner)
    torch.cuda.synchronize()
    run.h2d = devices.transfer_counts()["h2d"] - t0
    run.launches = {fn.__name__: fn.launches - b
                    for fn, b in zip(counters, before)}
    names = {n.id: n.name for n in h.state.nodes()}
    plans = h.plans[first:] if commit else planner.plans
    run.plans = [plan_summary(p, names) for p in plans]
    return run


def sequential(structs, Harness, nodes, streams, *, commit, seed) -> list:
    """The same streams one eval at a time through ``torch-binpack``
    (``Harness.process`` with the snapshot each stream starts from), on
    the device executor."""
    from nomad_tpu_torch.scheduler import TorchBinPackScheduler
    from nomad_tpu_torch.scheduler.executor import executor_override

    h = stream_cluster(structs, Harness, nodes,
                       [j for s in streams for j in s])
    recorder = RecordOnlyPlanner(structs)
    planner = h if commit else recorder
    random.seed(seed)
    with executor_override("device"):
        for jobs in streams:
            snap = h.snapshot()
            for j in jobs:
                TorchBinPackScheduler(
                    snap, planner, batch=j.type == "batch",
                    device=DEV).process(make_eval(structs, j))
    names = {n.id: n.name for n in h.state.nodes()}
    return [plan_summary(p, names)
            for p in (h.plans if commit else recorder.plans)]


def stream_report(run: "StreamRun", n_evals: int) -> dict:
    lats = [x for r in run.runners for x in r.latencies]
    stages: dict = {}
    for r in run.runners:
        for k, v in r.stage_times.items():
            stages[k] = stages.get(k, 0.0) + v * 1e3
    windows = [w for r in run.runners for w in r.windows]
    return dict(
        evals=n_evals, wall_s=run.wall, evals_per_s=n_evals / run.wall,
        p50_ms=percentile(lats, 50), p99_ms=percentile(lats, 99),
        stage_ms=stages, windows=len(windows),
        window_mean=sum(windows) / len(windows), window_max=max(windows),
        host_dispatches=sum(r.host_dispatches for r in run.runners),
        device_dispatches=sum(r.device_dispatches for r in run.runners),
        breaker_reruns=sum(r.breaker_reruns for r in run.runners),
        parity_checks=sum(r.parity_checks for r in run.runners),
        h2d_per_eval=run.h2d / n_evals, launches=run.launches)


def run_streams(torch, structs, Harness, PipelinedEvalRunner, name, nodes,
                streams, *, depth, commit, seed, rounds_calls, calls,
                warm=False, shared=None) -> dict:
    """One configuration's stream under each executor, twice, in the
    order host, device, auto, auto, device, host (so neither end of
    the order favours one executor); plans held against each other and
    against the sequential run, eval by eval.  The six timed runs are
    the main path: their K3 launches are recorded in ``rounds_calls``
    (RoundsRecording), their K2 and K5 launches in ``calls``
    (Recording), and ``launches`` sums their counts alone (not the
    sequential or warm runs')."""
    from nomad_tpu_torch.models import fleet
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.scheduler.executor import executor_override

    n_evals = sum(len(s) for s in streams)
    want = sequential(structs, Harness, nodes, streams, commit=commit,
                      seed=seed)
    require(len(want) == n_evals, f"{name}: {len(want)} sequential plans")
    if shared is None and not commit:
        shared = stream_cluster(structs, Harness, nodes,
                                [j for s in streams for j in s])
    if warm:
        with executor_override("device"):
            pipelined(torch, structs, Harness, PipelinedEvalRunner, nodes,
                      streams, depth=depth, commit=commit, seed=seed,
                      h=shared)
    out: dict = {ex: [] for ex in EXECUTORS}
    launches: dict = {}
    for ex in EXECUTORS + EXECUTORS[::-1]:
        saved = (binpack.place_rounds, binpack.place_sequence,
                 fleet.scatter_rows)
        binpack.place_rounds = RoundsRecording(saved[0], rounds_calls)
        binpack.place_sequence = Recording(saved[1], calls)
        fleet.scatter_rows = Recording(saved[2], calls)
        try:
            with executor_override(ex):
                run = pipelined(torch, structs, Harness,
                                PipelinedEvalRunner, nodes, streams,
                                depth=depth, commit=commit, seed=seed,
                                h=shared)
        finally:
            (binpack.place_rounds, binpack.place_sequence,
             fleet.scatter_rows) = saved
        for k, v in run.launches.items():
            launches[k] = launches.get(k, 0) + v
        rep = stream_report(run, n_evals)
        out[ex].append(rep)
        require(run.plans == want,
                f"{name} under {ex}: plans differ from the sequential run")
        require(rep["breaker_reruns"] == 0 and rep["parity_checks"] == 0,
                f"{name} under {ex}: {rep['breaker_reruns']} breaker "
                f"reruns, {rep['parity_checks']} parity checks")
        require(rep["host_dispatches"] + rep["device_dispatches"]
                == n_evals, f"{name} under {ex}: dispatches do not "
                f"cover the {n_evals} evals")
        k23 = run.launches["place_sequence"] + run.launches["place_rounds"]
        require(k23 == rep["device_dispatches"],
                f"{name} under {ex}: {k23} K2/K3 launches for "
                f"{rep['device_dispatches']} device dispatches")
        if ex == "device":
            require(rep["device_dispatches"] == n_evals,
                    f"{name} under device: {rep['device_dispatches']} "
                    f"device dispatches for {n_evals} evals")
        if ex == "host":
            require(rep["device_dispatches"] == 0,
                    f"{name} under host: a dispatch went to the device")
        print(f"executor stream {name} {ex} run {len(out[ex])}: "
              + json.dumps(rep), flush=True)
    return dict(depth=depth, evals=n_evals, commit=commit,
                launches=launches, **out)


def run_executor(torch, n1=100, n2=1000, n4=10_000, n5b=160, evals1=64,
                 evals2=64, evals4=16, groups4=1000, distinct=(8, 64, 512),
                 lanes5b=(1, 4, 16, 64), groups5b=100, sizes5b=(),
                 placed5b=None, reps=20) -> dict:
    """The executor phase: the crossover table (single evals and fused
    config-5b storms) and the constants it gives, the bench's pipelined
    streams (configs 1, 2 and 4) under each executor, their K2/K3/K5
    launches replayed against the plain versions, and config 5b's storm
    under each executor in turns against the storm phase's ``device``
    run.  The default breaker must end closed and untouched."""
    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.models import fleet
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.scheduler import (BatchEvalRunner, Harness,
                                           VerifyingPlanner)
    from nomad_tpu_torch.scheduler.breaker import GLOBAL_BREAKER
    from nomad_tpu_torch.scheduler.executor import executor_override
    from nomad_tpu_torch.scheduler.pipeline import PipelinedEvalRunner
    from nomad_tpu_torch.scheduler.torch_binpack import \
        TorchBinPackScheduler

    GLOBAL_BREAKER.reset()
    nodes1 = [mock.node(i) for i in range(n1)]
    nodes2 = [mock.node(i) for i in range(n2)]
    nodes4 = [mock.node(i) for i in range(n4)]
    nodes5b = [mock.node(i) for i in range(n5b)]

    def job1(k):
        j = mock.job()
        j.id = f"config1-{k}"
        return j

    def job4(k, groups, prefix="config4"):
        (j,) = storm_jobs(mock, structs, f"{prefix}-{groups}g-{k}", 1,
                          groups)
        return j

    def distinct_groups(groups):
        """A job of ``groups`` task groups that each ask for another CPU
        share, so every group is a slot of its own (the bench's groups
        are alike and fold into one slot)."""
        j = job4(0, groups, "distinct")
        for g, tg in enumerate(j.task_groups):
            tg.tasks[0].resources.cpu = 100 + g
        return j

    # (a) the crossover, on real evals' DeviceArgs; config 4's fleet
    # also serves its stream below.
    jobs4 = [job4(k, groups4) for k in range(evals4)]
    h4 = stream_cluster(structs, Harness, nodes4, jobs4)
    shapes = []
    for name, h, job in (
            ("config 1", stream_cluster(structs, Harness, nodes1, []),
             job1(0)),
            ("config 2", stream_cluster(structs, Harness, nodes2, []),
             config2_job(mock, structs, 0)),
            ("config 5b lane", stream_cluster(structs, Harness, nodes5b,
                                              []),
             job4(0, groups5b, "config5b")),
            ("config 2's sequence job", stream_cluster(
                structs, Harness, nodes2, []), sequence_job(mock, structs)),
            ("config 4", h4, job4(0, groups4, "config4-alone")),
            *((f"config 4 fleet, {g} distinct groups", h4,
               distinct_groups(g)) for g in distinct)):
        shapes.append((name,) + eval_args(structs, BatchEvalRunner, h,
                                          job))
    table = crossover(torch, shapes, reps)
    for row in table:
        print("executor crossover: " + json.dumps(row), flush=True)
    h5b = stream_cluster(structs, Harness, nodes5b, storm_jobs(
        mock, structs, "config5b-crossover", max(lanes5b), groups5b))
    runner5b = BatchEvalRunner(h5b.snapshot(), RecordOnlyPlanner(structs),
                               device=DEV)
    pending5b = []
    for j in h5b.state.jobs():
        sched = runner5b._begin_eval(make_eval(structs, j))
        pending5b.append((sched,) + sched.deferred)
    storm_table = storm_crossover(torch, runner5b, pending5b, lanes5b,
                                  reps)
    for row in storm_table:
        print("executor storm crossover: " + json.dumps(row), flush=True)
    derived = derive_constants(table, storm_table)
    configured = {k: getattr(TorchBinPackScheduler, k)
                  for k in ("HOST_ALWAYS_COST", "HOST_SINGLE_SHOT_COST")}
    print("executor constants: " + json.dumps(
        dict(derived=derived, configured=configured)), flush=True)
    wrong = consistent(table, storm_table, configured)
    require(not wrong, f"executor: the configured constants send these "
            f"shapes the wrong way by more than 2x: {wrong}")

    # (b) the bench's streams through PipelinedEvalRunner: this main
    # path's launches are the timed runs' own (run_streams), their K3
    # launches recorded by shape and K2/K5's alike, for the replay.
    rounds_calls: dict = {}
    calls: dict = {}
    rec = dict(rounds_calls=rounds_calls, calls=calls)
    streams = {}
    streams["config 1"] = run_streams(
        torch, structs, Harness, PipelinedEvalRunner, "config 1", nodes1,
        [[job1(k) for k in range(evals1)]], depth=6, commit=False, seed=81,
        warm=True, **rec)
    jobs2 = [config2_job(mock, structs, k) for k in range(evals2)]
    seq_job = sequence_job(mock, structs)
    half = evals2 // 2
    streams["config 2"] = run_streams(
        torch, structs, Harness, PipelinedEvalRunner, "config 2", nodes2,
        [jobs2[:half], jobs2[half:] + [seq_job]], depth=6, commit=True,
        seed=82, **rec)
    # Config 4's depth as bench.py derives it: the single shot's wall
    # over one eval's host stages, +2, at least 6, at most 64.
    with executor_override("device"):
        warm = pipelined(torch, structs, Harness, PipelinedEvalRunner,
                         nodes4, [jobs4], depth=6, commit=False, seed=84,
                         h=h4)
    host_stage_s = max(sum(warm.runners[0].stage_times.values())
                       / evals4, 1e-4)
    kernel_s = next(r for r in table if r["shape"] == "config 4"
                    )["single_shot"]["median_ms"] / 1e3
    depth4 = max(6, min(64, int(kernel_s / host_stage_s) + 2))
    streams["config 4"] = run_streams(
        torch, structs, Harness, PipelinedEvalRunner, "config 4", nodes4,
        [jobs4], depth=depth4, commit=False, seed=84, shared=h4, **rec)
    launches = {name: sum(st["launches"].get(name, 0)
                          for st in streams.values())
                for name in ("place_sequence", "place_rounds",
                             "scatter_rows")}
    for name in ("place_sequence", "place_rounds"):
        require(launches[name] > 0,
                f"executor: {name} was not launched by the streams")
    recorded = {name: sum(c[2] for key, c in {**rounds_calls,
                                              **calls}.items()
                          if key[0] == name) for name in launches}
    require(recorded == launches, f"executor: recorded launches "
            f"{recorded}, the streams' {launches}")
    replay_rounds = main_path_rounds(torch, binpack, rounds_calls)
    replay = main_path_replay(torch, {"place_sequence": binpack,
                                      "scatter_rows": fleet}, calls)

    # (c) config 5b's storm under each executor, in turns whose order
    # reverses, against the storm phase's device run (comparison runs:
    # their launches are not the main path's).
    storm5b: dict = {ex: [] for ex in EXECUTORS}
    for ex in EXECUTORS + EXECUTORS[::-1]:
        with executor_override(ex):
            placed, counts = storm_config5b(
                mock, structs, Harness, VerifyingPlanner, BatchEvalRunner,
                *sizes5b)
        if placed5b is None:
            placed5b = placed
        require(placed == placed5b, f"config 5b under {ex}: other "
                f"placements than under device")
        if not sizes5b:
            for k, v in CONFIG5B_COUNTS.items():
                require(counts[k] == v, f"config 5b under {ex}: {k} "
                        f"{counts[k]}, expected {v}")
        storm5b[ex].append(counts)
        print(f"executor config 5b storm {ex}: " + json.dumps(counts),
              flush=True)
    stats = GLOBAL_BREAKER.stats()
    require(stats == {"opens": 0, "closes": 0, "probes": 0,
                      "host_holds": 0, "failures": 0, "state": "closed"},
            f"executor: the breaker did not stay closed and clean: {stats}")
    return dict(crossover=table, storm_crossover=storm_table,
                constants=dict(derived=derived, configured=configured),
                streams=streams, config5b_storm=storm5b, breaker=stats,
                launches=launches, config4_depth=depth4,
                main_path_rounds=replay_rounds, main_path_replay=replay)


# The kernels of the kernels phase, in the order it checks them.
# -- phase 15: the mesh (K7) -------------------------------------------------

MESH_SHARDS = 4
# A row of more shards than one launch takes (binpack.STEP_SHARDS, 16):
# on one card it steps with shard_step + K7b and gathers the shards past
# the sharded K6's 16 with K7d, the routes of shards that span cards.
MESH_WIDE = 32
MESH_LAUNCH_NAMES = ("shard_walk", "window_verify_sharded", "shard_step",
                     "merge_select", "shard_gather")
# The kernels of rows whose shards span cards (or outnumber a launch):
# none of them runs where every row is at most 16 shards of one card.
MESH_ACROSS_NAMES = ("shard_step", "merge_select", "shard_gather")


def mesh_counters():
    """The K7 kernels' wrappers (their launch counts) and those of K5
    and K6, which the mesh's mirror maintenance and verify launch."""
    from nomad_tpu_torch.models import fleet
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.parallel import mesh

    return {"shard_walk": binpack.shard_walk,
            "window_verify_sharded": mesh.launch_window_verify_shards,
            "shard_step": binpack.shard_step,
            "merge_select": binpack.merge_select,
            "shard_gather": mesh.shard_gather,
            "scatter_rows": fleet.scatter_rows,
            "window_verify": mesh.window_verify,
            "place_sequence": binpack.place_sequence,
            "place_rounds": binpack.place_rounds,
            "place_rounds_batch": binpack.place_rounds_batch,
            "place_sequence_batch": binpack.place_sequence_batch}


@contextlib.contextmanager
def walk_records():
    """Each sharded walk run inside, as it ends: its steps, the route of
    each of its mesh rows (``mesh.walk_route``) and their shard_step
    launch groups (cards, cut at the kernel's shards a launch), and the
    shard_walk, K7b and shard_step launches it made, counted around the
    call."""
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.parallel import mesh

    walks = []
    orig = mesh._walk
    wrappers = {"walk": binpack.shard_walk, "merge": binpack.merge_select,
                "step": binpack.shard_step}

    def recorded(m, lane_rows, ops, **kw):
        lane_rows = list(lane_rows)
        before = {k: f.launches for k, f in wrappers.items()}
        out = orig(m, lane_rows, ops, **kw)
        steps = ops["group_idx"][0].shape[-1] if kw["seq"] else \
            ops["asks"][0].shape[-2] * kw.get("rounds", 1)
        walks.append(dict(
            rows=len(lane_rows), steps=steps,
            routes=[mesh.walk_route(m.grid[r]) for r in lane_rows],
            groups=[len(mesh.device_groups(m.grid[r])) for r in lane_rows],
            **{k: f.launches - before[k] for k, f in wrappers.items()}))
        return out
    mesh._walk = recorded
    try:
        yield walks
    finally:
        mesh._walk = orig


def walk_launch_check(walks, total, route=None) -> dict:
    """The walks' launches against the formula of each row's route: a
    row on the shard_walk route (every shard on one card, at most 16) is
    ONE shard_walk launch a walk; a row on the shard_step route is one
    K7b a step and one shard_step a launch group and step, plus one tail
    shard_step a group.  ``route``: the route every row must take (None:
    either).  Returns the split."""
    n_walk = n_step = n_merge = stepped_rows = 0
    for w in walks:
        s = w["steps"]
        require(route is None or set(w["routes"]) == {route},
                f"mesh: a walk's rows took the routes {w['routes']}, not "
                f"{route}")
        stepped = [g for r, g in zip(w["routes"], w["groups"])
                   if r == "shard_step"]
        want = dict(walk=(len(w["routes"]) - len(stepped)) if s else 0,
                    step=sum(g * (s + 1) for g in stepped) if s else 0,
                    merge=len(stepped) * s)
        require(all(w[k] == v for k, v in want.items()),
                f"mesh: a walk of {s} steps on rows {w['routes']} "
                f"({w['groups']} launch groups) made {w['walk']} "
                f"shard_walk, {w['step']} shard_step and {w['merge']} K7b "
                f"launches, the formula {want}")
        n_walk += want["walk"]
        n_step += want["step"]
        n_merge += want["merge"]
        stepped_rows += len(stepped)
    require((n_walk, n_step, n_merge) == (
        total.get("shard_walk", 0), total.get("shard_step", 0),
        total.get("merge_select", 0)),
            f"mesh: shard_walk {total.get('shard_walk')}, shard_step "
            f"{total.get('shard_step')} and K7b {total.get('merge_select')} "
            f"launches, the walks' {n_walk}, {n_step} and {n_merge}")
    return dict(walks=len(walks), shard_walk=n_walk, shard_step=n_step,
                merge_select=n_merge, stepped_rows=stepped_rows)


def launches_of(fn, total=None, walks=None) -> tuple:
    """Launch counts of every wrapper in ``mesh_counters`` moved by
    ``fn()``, each set to 0 just before it and read just after; returns
    (what fn returned, counts), and adds the counts into ``total`` when
    given, and the records of its sharded walks (``walk_records``) to
    ``walks``."""
    counters = mesh_counters()
    saved = {k: c.launches for k, c in counters.items()}
    for c in counters.values():
        c.launches = 0
    try:
        with walk_records() as ran:
            out = fn()
    finally:
        counts = {k: c.launches for k, c in counters.items()}
        for k, c in counters.items():
            c.launches = saved[k] + counts[k]
    if total is not None:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    if walks is not None:
        walks.extend(ran)
    return out, counts


def shard_case(c, s, rows, lanes=None):
    """Shard ``s`` (``rows`` rows) of a fleet_case / lanes_case, in the
    batch layout shard_step takes (a lane axis; ``lanes`` None: one
    lane)."""
    lo, hi = s * rows, (s + 1) * rows

    def one(x):
        return x.unsqueeze(0) if lanes is None else x
    return dict(
        capacity=c["capacity"][lo:hi].contiguous(),
        reserved=c["reserved"][lo:hi].contiguous(),
        usage=c["usage0"][lo:hi].unsqueeze(0).repeat(
            1 if lanes is None else lanes, 1, 1),
        job_counts=one(c["jc0"])[:, lo:hi].contiguous(),
        feasible=one(c["feasible"])[:, :, lo:hi].contiguous(),
        asks=one(c["asks"]).contiguous(),
        distinct=one(c["distinct"]).contiguous())


def step_shards(torch, c, rows, lanes, k, kout, group_idx):
    """MESH_SHARDS shards of a fleet_case / lanes_case as shard_step
    takes them, on the card, with the lead's candidate buffers
    [S, B, k] and update buffer [S, B, kout] (all -1) they write and
    read."""
    b = 1 if lanes is None else lanes
    pen = torch.full((b,), 10.0, dtype=torch.float32, device=DEV)
    cand_v = torch.zeros((MESH_SHARDS, b, k), dtype=torch.float32,
                         device=DEV)
    cand_i = torch.zeros((MESH_SHARDS, b, k), dtype=torch.int32, device=DEV)
    upd = torch.full((MESH_SHARDS, b, kout), -1, dtype=torch.int32,
                     device=DEV)
    shards = [dict(shard_case(c, s, rows, lanes), penalty=pen,
                   group_idx=group_idx, out=(cand_v[s], cand_i[s]),
                   upd=upd[s], row_lo=s * rows) for s in range(MESH_SHARDS)]
    return shards, (cand_v, cand_i, upd)


def step_twin(torch, shards, bufs):
    """A copy of ``step_shards``' state (usage, job counts and the
    buffers), for the plain version to run on beside the kernel."""
    cand_v, cand_i, upd = (x.clone() for x in bufs)
    twin = [dict(sh, usage=sh["usage"].clone(),
                 job_counts=sh["job_counts"].clone(),
                 out=(cand_v[s], cand_i[s]), upd=upd[s])
            for s, sh in enumerate(shards)]
    return twin, (cand_v, cand_i, upd)


def step_equal(torch, what, got, want) -> None:
    """Bit for bit: each shard's usage and job counts, the candidates
    and the updates."""
    for s, (g, w) in enumerate(zip(got[0], want[0])):
        require(torch.equal(g["usage"].view(torch.int32),
                            w["usage"].view(torch.int32))
                and torch.equal(g["job_counts"], w["job_counts"]),
                f"{what}: shard {s}'s usage or job counts differ from the "
                "plain version")
    for name, x, y in zip(("candidate values", "candidate indices",
                           "updates"), got[1], want[1]):
        require(torch.equal(x.view(torch.int32), y.view(torch.int32)),
                f"{what}: {name} differ from the plain version")


def check_shard_step(torch, binpack, n, k, rng, reps, lanes=None):
    """K7a+c on MESH_SHARDS shards of an N-row fleet, one launch, against
    its plain version on the same inputs, bit for bit, in each mode: the
    walk's first step (select step 0), a middle step (apply step 0's
    updates from a real K7b merge of those candidates, then select step
    1) and the tail (apply step 1's updates from K7b, select nothing).
    k = 1 is a sequence walk (B = 1; step 1 invalid, so its winner gets
    ask * 0.0), k > 1 a rounds walk (slot 0 keeps 1,000 copies a lane,
    slot 1 500).  The middle step is timed (CUDA events, and its device
    time from torch.profiler) beside the library's same step on each
    shard: ``index_add_`` of the winners' rows, then ``torch.topk`` of the
    shard's masked scores.  Returns the row and the first step's
    candidates."""
    rows = n // MESH_SHARDS
    b = 1 if lanes is None else lanes
    c = fleet_case(torch, n, rng) if lanes is None else \
        lanes_case(torch, n, lanes, rng, uniform=False)
    seq = k == 1
    p = 8
    gi = valid = counts = None
    if seq:
        gi = torch.from_numpy(sequence_groups(rng, p, 8, "random")).to(
            DEV).reshape(1, p)
        valid = torch.ones((1, p), dtype=torch.bool, device=DEV)
        valid[0, 1] = False
    else:
        counts = torch.zeros((b, 8), dtype=torch.int32, device=DEV)
        counts[:, 0], counts[:, 1] = 1000, 500
    kout = 1 if seq else k
    got = step_shards(torch, c, rows, lanes, k, kout, gi)
    want = step_twin(torch, *got)
    what = f"shard_step N={n} k={k} B={b}"

    def merge(step):
        """K7b (the kernel) on the candidates of ``step``; its updates
        go to both sides."""
        cand_v, cand_i, upd = got[1]
        shape = (b, p) if seq else (b, 8, k)
        chosen = torch.full(shape, -1, dtype=torch.int32, device=DEV)
        scores = torch.zeros(shape, dtype=torch.float32, device=DEV)
        binpack.merge_select(
            cand_v, cand_i, rows, upd, chosen, scores, slot=step,
            valid=valid, counts=counts,
            m=None if seq else torch.zeros(b, dtype=torch.int32,
                                           device=DEV))
        want[1][2].copy_(upd)
        return int((chosen >= 0).sum())

    modes = {}
    for mode, apply_step, select_step in (("first", -1, 0),
                                          ("middle", 0, 1), ("tail", 1, -1)):
        if apply_step >= 0:
            modes[f"placed_step{apply_step}"] = merge(apply_step)
        plan = binpack.shard_step(got[0], apply_step=apply_step,
                                  select_step=select_step, k=k)
        torch.cuda.synchronize()
        binpack.shard_step_plain(want[0], apply_step=apply_step,
                                 select_step=select_step, k=k)
        step_equal(torch, f"{what} {mode}", got, want)
        if mode == "first":
            cands = [(got[1][0][s].clone(), got[1][1][s].clone())
                     for s in range(MESH_SHARDS)]
    # The middle step timed on the state the tail left: each call
    # applies the tail's updates (step 1's winners) with step 0's ask and
    # selects step 1, the work of a step.
    owned = got[1][2] >= 0
    ms = time_ms(torch, lambda: binpack.launch_shard_step(plan, 0, 1), reps)
    device_ms = kernel_device_ms(
        torch, lambda: binpack.launch_shard_step(plan, 0, 1), reps,
        "shard_step_kernel")
    plain_ms = time_ms(torch, lambda: binpack.shard_step_plain(
        want[0], apply_step=0, select_step=1, k=k), 1)
    # The library's step: per shard, index_add_ of each owned winner's
    # ask into the flattened usage, then torch.topk of the masked scores
    # at step 1's group.
    lib = []
    for s, sh in enumerate(got[0]):
        e = got[1][2][s]
        lane = torch.arange(b, device=DEV)[:, None].expand_as(e)
        mine = e >= 0
        g0 = gi[:, 0] if seq else torch.zeros(b, dtype=torch.long,
                                              device=DEV)
        g1 = int(gi[0, 1]) if seq else 1
        add = sh["asks"][torch.arange(b, device=DEV), g0.long()]
        lib.append(dict(
            flat=sh["usage"].clone().view(-1, 6),
            rows_=(lane * rows + (e >> 1))[mine].long(),
            vals=add[lane[mine]],
            masked=torch.stack([binpack.score_all_nodes(
                sh["capacity"], sh["reserved"], sh["usage"][i],
                sh["job_counts"][i], sh["asks"][i, g1],
                sh["feasible"][i, g1], sh["distinct"][i, g1], 10.0)
                for i in range(b)])))

    def library():
        for x in lib:
            x["flat"].index_add_(0, x["rows_"], x["vals"])
            torch.topk(x["masked"], k)
    library_ms = time_ms(torch, library, reps)
    n_owned = int(owned.sum())
    # Bytes: each shard's capacity and reserved rows once (every lane
    # reads the same ones), each lane's usage and job counts on the
    # shard's rows and its step's feasibility row once, its updates and
    # asks read once; the winners' usage and job-count rows written
    # once, the candidates written once.  Operations: every row scored
    # and taken into the selection, 7 adds a winner.
    nbytes = (MESH_SHARDS * (2 * rows * 24 + b * rows * (24 + 4 + 1)
                             + b * (kout * 4 + 2 * 24))
              + n_owned * (24 + 4) + MESH_SHARDS * b * k * 8)
    b_ms, b_by = bound(nbytes, MESH_SHARDS * b * rows * OPS_PER_NODE
                       + n_owned * 7)
    return dict(err=0.0, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                lanes=b, rows=rows, shards=MESH_SHARDS, k=k,
                rows_updated=n_owned, **modes), cands


def check_merge_select(torch, binpack, cands, rows, k_cap, reps):
    """K7b on MESH_SHARDS lists of real K7a candidates (the first round
    of slot 0, 1,000 copies a lane) against its plain version, bit for
    bit (chosen, scores, the shards' updates, the copies left), timed
    beside ``torch.topk`` over the lists' values."""
    cand_v = torch.stack([c[0] for c in cands]).contiguous()
    cand_i = torch.stack([c[1] for c in cands]).contiguous()
    s, b, k = cand_v.shape
    g = 8
    counts = torch.zeros((b, g), dtype=torch.int32, device=DEV)
    counts[:, 0] = 1000

    def outs():
        return (torch.empty((s, b, k_cap), dtype=torch.int32, device=DEV),
                torch.full((b, g, k_cap), -7, dtype=torch.int32, device=DEV),
                torch.zeros((b, g, k_cap), dtype=torch.float32, device=DEV),
                torch.zeros(b, dtype=torch.int32, device=DEV))
    got, want = outs(), outs()
    binpack.merge_select(cand_v, cand_i, rows, *got[:3], slot=0, m=got[3],
                         counts=counts)
    torch.cuda.synchronize()
    binpack.merge_select_plain(cand_v, cand_i, rows, *want[:3], slot=0,
                               m=want[3], counts=counts)
    for name, x, y in zip(("upd", "chosen", "scores", "m"), got, want):
        require(torch.equal(x, y),
                f"merge_select S={s} B={b}: {name} differs from the plain "
                "version")
    # Launched as a walk launches it: bound to its buffers once.
    launch = binpack.merge_launch(cand_v, cand_i, rows, *got[:3], got[3],
                                  counts, None)
    ms = time_ms(torch, lambda: launch(0, 0), reps)
    plain_ms = time_ms(torch, lambda: binpack.merge_select_plain(
        cand_v, cand_i, rows, *want[:3], slot=0, m=want[3], counts=counts),
        1)
    flat = cand_v.permute(1, 0, 2).reshape(b, s * k)
    library_ms = time_ms(torch, lambda: torch.topk(flat, k_cap), reps)
    # Bytes: the candidates read once, the chosen, scores and updates
    # written once; operations: a binary search of each other list for
    # every candidate.
    nbytes = s * b * k * 8 + b * k_cap * (8 + 4 * s) + b * 8
    ops = s * b * k * (s - 1) * max(1, int(np.log2(k)))
    b_ms, b_by = bound(nbytes, ops)
    return dict(err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, shards=s, lanes=b,
                placed=int((got[1] >= 0).sum())), got[0]


def check_shard_gather(torch, mesh_mod, rng, reps):
    """K7d on each of MESH_SHARDS shards of the 5f window's 1,048,576-row
    fleet against its plain version, bit for bit; the first shard's
    launch timed."""
    n_real, n_pad = 1_000_000, 1_048_576
    t = window_fleet(torch, rng, n_real, n_pad)
    desc, _counts = window_case(rng, n_real, 64, 1, 64, 0.0)
    rows = n_pad // MESH_SHARDS
    ni = torch.from_numpy(desc["pair_ni"]).to(DEV)
    for s in range(MESH_SHARDS):
        part = [x[s * rows:(s + 1) * rows].contiguous() for x in t]
        got = mesh_mod.shard_gather(*part, s * rows, ni)
        torch.cuda.synchronize()
        want = mesh_mod.shard_gather_plain(*part, s * rows, ni)
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"shard_gather shard {s}: differs from the plain version")
        if s == 0:
            out = torch.empty_like(got)
            ms = time_ms(torch, lambda: mesh_mod.shard_gather(
                *part, 0, ni, out=out), reps)
            plain_ms = time_ms(torch, lambda: mesh_mod.shard_gather_plain(
                *part, 0, ni), reps)
    b = ni.shape[0]
    owned = int(((ni >= 0) & (ni < rows)).sum())
    b_ms, b_by = bound(b * (4 + 48) + owned * 48, 0)
    return dict(err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, pairs=b, owned=owned)


def check_shard_walk(torch, binpack, c, shards, lanes, reps, *, gi=None,
                     valid=None, counts=None, k_cap=1, rounds=1):
    """shard_walk (one launch: a cluster a lane, a CTA a shard) on
    ``shards`` shards of a fleet_case / lanes_case against its plain
    version (the loop of shard_step's and K7b's) on the same inputs, bit
    for bit: chosen, every score, each shard's usage and job counts.
    Timed with CUDA events (each call walks again from the state the
    last left) and its device time from torch.profiler; the plain
    version's time is its one reference run.  No single PyTorch call
    computes a walk: library_ms is None."""
    n = c["capacity"].shape[0]
    rows = n // shards
    b = 1 if lanes is None else lanes
    pen = torch.full((b,), 10.0, dtype=torch.float32, device=DEV)
    got = [dict(shard_case(c, s, rows, lanes), penalty=pen, group_idx=gi,
                row_lo=s * rows) for s in range(shards)]
    want = [dict(sh, usage=sh["usage"].clone(),
                 job_counts=sh["job_counts"].clone()) for sh in got]
    seq = gi is not None
    shape = (b, gi.shape[1]) if seq else (b, counts.shape[1],
                                          rounds * k_cap)
    outs = [(torch.full(shape, -7, dtype=torch.int32, device=DEV),
             torch.zeros(shape, dtype=torch.float32, device=DEV))
            for _ in range(2)]
    kw = dict(k_cap=k_cap, rounds=rounds, valid=valid, counts=counts)
    before = binpack.shard_walk.launches
    binpack.shard_walk(got, *outs[0], **kw)
    torch.cuda.synchronize()
    require(binpack.shard_walk.launches == before + 1,
            "shard_walk: not one launch")
    t = time.perf_counter()
    binpack.shard_walk_plain(want, *outs[1], **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    what = f"shard_walk S={shards} N={n} B={b} k_cap={k_cap}"
    for s, (g, w) in enumerate(zip(got, want)):
        require(torch.equal(g["usage"].view(torch.int32),
                            w["usage"].view(torch.int32))
                and torch.equal(g["job_counts"], w["job_counts"]),
                f"{what}: shard {s}'s usage or job counts differ from the "
                "plain version")
    require(torch.equal(outs[0][0], outs[1][0])
            and torch.equal(outs[0][1].view(torch.int32),
                            outs[1][1].view(torch.int32)),
            f"{what}: chosen or scores differ from the plain version")
    chosen = outs[0][0].cpu().numpy()
    ms = time_ms(torch, lambda: binpack.shard_walk(got, *outs[0], **kw),
                 reps)
    device_ms = kernel_device_ms(
        torch, lambda: binpack.shard_walk(got, *outs[0], **kw), reps,
        "shard_walk_kernel")
    # The function is the unsharded walk's: its bytes and operations
    # (each lane's scorings and rescorings, or its rounds' scorings).
    if seq:
        gi_h, valid_h = gi.cpu().numpy(), valid.cpu().numpy()
        g = c["asks"].shape[-2]
        nbytes = shared_fleet_bytes(n) + sum(
            sequence_lane_bytes(n, gi_h[i], valid_h[i]) for i in range(b))
        ops = sum(sequence_ops(n, g, gi_h[i], chosen[i]) for i in range(b))
    else:
        counts_h = counts.cpu().numpy()
        nbytes = shared_fleet_bytes(n) + sum(
            rounds_lane_bytes(n, counts_h[i], shape[1] * shape[2])
            for i in range(b))
        ops = n * OPS_PER_NODE * sum(
            rounds_run(counts_h[i], chosen[i], rounds, k_cap)
            for i in range(b))
    b_ms, b_by = bound(nbytes, ops)
    return dict(err=0.0, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shards=shards, lanes=b, rows=rows,
                k=1 if seq else min(k_cap, rows),
                placed=int((chosen >= 0).sum()))


def shard_walk_checks(torch, binpack, rng, reps) -> dict:
    """shard_walk at the four walk shapes ``mesh_wrapper_checks`` times:
    config 4's rounds walk, the sequence walk of N = 16,384 and P =
    1,024, a row of config 5's 2x2 storm (32 lanes, two shards) and the
    K4b-shaped storm (B = 8, P = 256)."""
    out = {}
    c = fleet_case(torch, 16384, rng, uniform=True)
    for k in ("capacity", "feasible"):
        c[k][10_000:] = 0 if k == "capacity" else False
    pad_slots(c, 1, 0)
    counts = torch.zeros((1, 8), dtype=torch.int32, device=DEV)
    counts[0, 0] = 1000
    out["config 4"] = check_shard_walk(
        torch, binpack, c, MESH_SHARDS, None, reps, counts=counts,
        k_cap=1024)
    c = fleet_case(torch, 16384, rng)
    gi = torch.from_numpy(sequence_groups(rng, 1024, 3, "random")).to(
        DEV).reshape(1, 1024)
    valid = torch.ones((1, 1024), dtype=torch.bool, device=DEV)
    valid[0, -8:] = False
    out["sequence N=16384 P=1024"] = check_shard_walk(
        torch, binpack, c, MESH_SHARDS, None, reps, gi=gi, valid=valid)
    c = lanes_case(torch, 16384, 32, rng, uniform=True)
    pad_slots(c, 1, 1)
    counts = torch.zeros((32, 8), dtype=torch.int32, device=DEV)
    counts[:, 0] = 1000
    out["config 5 row"] = check_shard_walk(
        torch, binpack, c, 2, 32, reps, counts=counts, k_cap=1024)
    c = lanes_case(torch, 16384, 8, rng, uniform=False)
    gi = torch.from_numpy(np.stack([sequence_groups(rng, 256, 3, "random")
                                    for _ in range(8)])).to(DEV)
    valid = torch.ones((8, 256), dtype=torch.bool, device=DEV)
    valid[:, -8:] = False
    out["sequence B=8 P=256"] = check_shard_walk(
        torch, binpack, c, MESH_SHARDS, 8, reps, gi=gi, valid=valid)
    return out


def check_window_verify_sharded(torch, mesh_mod, rng, reps, n_real, n_pad,
                                n_plans, per_plan, n_comps, removals):
    """K6's sharded form on MESH_SHARDS shards of one card (each read in
    place, one launch, no K7d) against K6 on the whole fleet and its
    plain version, used and caps bit for bit, fits equal.  ``ms`` times
    the launch alone on descriptors already on the card (CUDA events),
    ``host_ms`` window_verify_sharded as the engine calls it."""
    from nomad_tpu_torch.parallel.devices import put_counted

    t = window_fleet(torch, rng, n_real, n_pad)
    desc, counts = window_case(rng, n_real, n_plans, per_plan, n_comps,
                               removals)
    b = desc["pair_ni"].shape[0]
    fm = mesh_mod.fleet_mesh([f"{DEV}:0"] * MESH_SHARDS)
    twins = [mesh_mod._put(x, fm, mesh_mod.NODE) for x in t]
    rows = n_pad // MESH_SHARDS
    counters = {k: f for k, f in mesh_counters().items() if k in (
        "window_verify", "window_verify_sharded", "shard_gather")}
    before = {k: f.launches for k, f in counters.items()}
    got = mesh_mod.window_verify_sharded(fm, *twins, **desc)
    torch.cuda.synchronize()
    moved = {k: f.launches - before[k] for k, f in counters.items()}
    require(moved == {"window_verify": 0, "window_verify_sharded": 1,
                      "shard_gather": 0},
            f"window_verify_sharded on one card: launches {moved}, want "
            "one of K6's sharded form and no K7d")
    want = mesh_mod.window_verify(*t, **desc)
    shards = [dict(capacity=twins[0][c], reserved=twins[1][c],
                   usage=twins[2][c], row_lo=c * rows)
              for c in range(MESH_SHARDS)]
    dd = {k: torch.from_numpy(v).to(DEV) for k, v in desc.items()}
    plain = mesh_mod.window_verify_shards_plain(shards, rows, None, **dd)
    torch.cuda.synchronize()
    what = f"window_verify_sharded N={n_pad} B={b}"
    for name, g, w, p in zip(("used", "caps", "fits"), got, want, plain):
        same = (lambda x, y: torch.equal(x.view(torch.int32),
                                         y.view(torch.int32))) \
            if name != "fits" else torch.equal
        require(same(g, w) and same(g, p),
                f"{what}: {name} differs from K6 or the plain version")
    packed = put_counted(mesh_mod.pack_descriptors(desc, b), DEV)
    walk = mesh_mod.kernel_counts(desc)

    def launch():
        return mesh_mod.launch_window_verify_shards(
            shards, rows, MESH_SHARDS, None, packed, b, walk)
    ms = time_ms(torch, launch, reps)
    device_ms = kernel_device_ms(torch, launch, reps, "window_verify_kernel")
    host_ms = host_call_ms(torch, lambda: mesh_mod.window_verify_sharded(
        fm, *twins, packed=True, **desc), reps)
    unsharded_host_ms = host_call_ms(torch, lambda: mesh_mod.window_verify(
        *t, packed=True, **desc), reps)
    plain_ms = time_ms(torch, lambda: mesh_mod.window_verify_shards_plain(
        shards, rows, None, **dd), max(1, reps // 10))
    b_ms, b_by = window_bound(desc, counts)
    return dict(err=0.0, ms=ms, device_ms=device_ms, host_ms=host_ms,
                unsharded_host_ms=unsharded_host_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by, bucket=b,
                shards=MESH_SHARDS, **counts)


def mesh_kernel_checks(torch, rng, reps=20) -> dict:
    """Step 1 of the mesh phase: each K7 kernel against its plain
    version on the card, bit for bit, timed with CUDA events."""
    from nomad_tpu_torch.ops import binpack, kernels
    from nomad_tpu_torch.parallel import mesh as mesh_mod

    n = 16384
    rows = n // MESH_SHARDS
    # The first port's K7a (shard_select_kernel) and K7c
    # (shard_apply_kernel) are gone: shard_step took both.
    lib = kernels.library("binpack")
    source = (kernels.CSRC / "binpack.cu").read_text()
    for gone in ("shard_select", "shard_apply"):
        require(not hasattr(lib, f"nomad_{gone}")
                and f"{gone}_kernel" not in source,
                f"mesh: {gone}_kernel is still in csrc/binpack.cu")
    step1, _ = check_shard_step(torch, binpack, n, 1, rng, reps)
    stepk, _ = check_shard_step(torch, binpack, n, 1024, rng, reps)
    # The storm's width (B = 64): shard_step's first candidates feed
    # K7b's check.
    step64, cands = check_shard_step(torch, binpack, n, 1024, rng, 5,
                                     lanes=64)
    merge, _upd = check_merge_select(torch, binpack, cands, rows, 1024,
                                     reps)
    gather = check_shard_gather(torch, mesh_mod, rng, reps)
    out = {"shard_step k=1": step1, "shard_step k=1024": stepk,
           "shard_step B=64 k=1024": step64,
           "merge_select S=4 B=64": merge,
           "shard_gather 5f window": gather}
    for name, r in shard_walk_checks(torch, binpack, rng, 3).items():
        out[f"shard_walk {name}"] = r
    out["window_verify_sharded 5f window"] = check_window_verify_sharded(
        torch, mesh_mod, rng, 200, 1_000_000, 1_048_576, 64, 1, 64, 0.0)
    out["window_verify_sharded config-5b scale"] = \
        check_window_verify_sharded(torch, mesh_mod, rng, 50, 160, 256, 64,
                                    100, 4, 0.1)
    return out


def wall_ms(torch, fn, reps) -> float:
    """Mean ms of ``fn`` on the host clock, the card synchronized after
    each call (a sharded walk's host loop is part of its time)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def walk_split(torch, mesh_mod, fn, reps) -> dict:
    """Where a sharded walk's host-clock time goes, over ``reps`` calls of
    ``fn`` with the card synchronized around each piece: ``setup_ms``
    the mesh rows' set-up (each lane's copies of the base usage and job
    counts, the result buffers; ``_WalkRow`` or ``_Row``),
    ``launch_wait_ms`` the walk's launches and the wait for them, and
    ``other_ms`` the rest (the operands' placement on the mesh, the
    results gathered on the lead); per call."""
    spent = {"setup": 0.0, "walk": 0.0}
    saved = []
    depth = [0]  # a _Row's set-up calls _WalkRow's: time the outer one

    def timed(cls, name, key):
        orig = getattr(cls, name)

        def wrapped(self, *a, **kw):
            depth[0] += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return orig(self, *a, **kw)
            finally:
                torch.cuda.synchronize()
                depth[0] -= 1
                if depth[0] == 0:
                    spent[key] += time.perf_counter() - t
        saved.append((cls, name, orig))
        setattr(cls, name, wrapped)
    timed(mesh_mod._WalkRow, "__init__", "setup")
    timed(mesh_mod._Row, "__init__", "setup")
    timed(mesh_mod._WalkRow, "walk", "walk")
    timed(mesh_mod._Row, "step", "walk")
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        total = time.perf_counter() - t
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)
    return dict(setup_ms=spent["setup"] / reps * 1e3,
                launch_wait_ms=spent["walk"] / reps * 1e3,
                other_ms=(total - spent["setup"] - spent["walk"]) / reps
                * 1e3)


def mesh_wrapper_checks(torch, devices, rng, reps=3) -> dict:
    """Step 2 of the mesh phase: each sharded wrapper on ``devices``
    against its unsharded kernel on the same inputs, bit for bit
    (chosen everywhere, every score, the final usage), each timed on
    the host clock beside that kernel."""
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.parallel import mesh as mesh_mod

    fmesh = mesh_mod.fleet_mesh(devices)
    smesh = mesh_mod.storm_mesh(2, devices)
    out = {}

    def held(name, sharded, single):
        got = sharded()
        want = single()
        torch.cuda.synchronize()
        compare(torch, f"{name} against its unsharded kernel",
                [x.to(DEV) for x in got], want)
        out[name] = dict(ms=wall_ms(torch, sharded, reps),
                         unsharded_ms=wall_ms(torch, single, reps),
                         placed=int((want[0] >= 0).sum()),
                         **walk_split(torch, mesh_mod, sharded, reps))

    # Config 4's K3 launch: 10,000 nodes on N = 16,384, one slot of
    # 1,000 copies, the job's other slots padding, k_cap 1,024.
    c = fleet_case(torch, 16384, rng, uniform=True)
    for k in ("capacity", "feasible"):
        c[k][10_000:] = 0 if k == "capacity" else False
    pad_slots(c, 1, 0)
    counts = torch.zeros(8, dtype=torch.int32, device=DEV)
    counts[0] = 1000
    args = (c["capacity"], c["reserved"], c["usage0"], c["jc0"],
            c["feasible"], c["asks"], c["distinct"], counts)
    held("place_rounds_sharded config 4",
         lambda: mesh_mod.place_rounds_sharded(fmesh, *args, 10.0,
                                               k_cap=1024, rounds=1),
         lambda: binpack.place_rounds(*args, 10.0, k_cap=1024, rounds=1))
    # K2 at N = 16,384, P = 1,024 (three groups drawn, the last 8 steps
    # invalid).
    c = fleet_case(torch, 16384, rng)
    gi = torch.from_numpy(sequence_groups(rng, 1024, 3, "random")).to(DEV)
    valid = torch.ones(1024, dtype=torch.bool, device=DEV)
    valid[-8:] = False
    args = (c["capacity"], c["reserved"], c["usage0"], c["jc0"],
            c["feasible"], c["asks"], c["distinct"], gi, valid, 10.0)
    held("place_sequence_sharded N=16384 P=1024",
         lambda: mesh_mod.place_sequence_sharded(fmesh, *args),
         lambda: binpack.place_sequence(*args))
    # Config 5's storm on the 2x2 storm mesh: B = 64, one slot of 1,000
    # copies a lane on a uniform fleet, k_cap 1,024.
    c = lanes_case(torch, 16384, 64, rng, uniform=True)
    pad_slots(c, 1, 1)
    counts = torch.zeros((64, 8), dtype=torch.int32, device=DEV)
    counts[:, 0] = 1000
    pen = torch.full((64,), 10.0, dtype=torch.float32, device=DEV)
    args = (c["capacity"], c["reserved"], c["usage0"], c["jc0"],
            c["feasible"], c["asks"], c["distinct"], counts, pen)
    held("place_rounds_batch_sharded config 5 2x2",
         lambda: mesh_mod.place_rounds_batch_sharded(
             smesh, *args, k_cap=1024, rounds=1),
         lambda: binpack.place_rounds_batch(*args, k_cap=1024, rounds=1))
    # K4b at B = 8, N = 16,384, P = 256.
    c = lanes_case(torch, 16384, 8, rng, uniform=False)
    gi = torch.from_numpy(np.stack([sequence_groups(rng, 256, 3, "random")
                                    for _ in range(8)])).to(DEV)
    valid = torch.ones((8, 256), dtype=torch.bool, device=DEV)
    valid[:, -8:] = False
    pen = torch.full((8,), 10.0, dtype=torch.float32, device=DEV)
    args = (c["capacity"], c["reserved"], c["usage0"], c["jc0"],
            c["feasible"], c["asks"], c["distinct"], gi, valid, pen)
    held("place_sequence_batch_sharded B=8 P=256",
         lambda: mesh_mod.place_sequence_batch_sharded(fmesh, *args),
         lambda: binpack.place_sequence_batch(*args))
    # K6 at the 5f window on 1,048,576 rows, the fleet resident on the
    # mesh as the applier's twins are.
    t = window_fleet(torch, rng, 1_000_000, 1_048_576)
    desc, _counts = window_case(rng, 1_000_000, 64, 1, 64, 0.0)
    twins = [mesh_mod._put(x, fmesh, mesh_mod.NODE) for x in t]
    got = mesh_mod.window_verify_sharded(fmesh, *twins, **desc)
    want = mesh_mod.window_verify(*t, **desc)
    torch.cuda.synchronize()
    for name, g, w in zip(("used", "caps", "fits"), got, want):
        require(torch.equal(g.to(DEV), w),
                f"window_verify_sharded: {name} differs from K6")
    out["window_verify_sharded 5f window"] = dict(
        ms=wall_ms(torch, lambda: mesh_mod.window_verify_sharded(
            fmesh, *twins, **desc), 20),
        unsharded_ms=wall_ms(torch, lambda: mesh_mod.window_verify(
            *t, **desc), 20), fits=int(want[2].sum()))
    return out


def mesh_plans(plans, names) -> list:
    """Each plan's placements as (alloc name -> (node name, ports))."""
    return [{k: (names[v[0]], v[1]) for k, v in plan_placements(p).items()}
            for p in plans]


def mesh_config4(torch, mock, structs, Harness, devices, mesh_mod, total,
                 walks):
    """Config 4 through Harness.process, unsharded and on ``devices``:
    the sharded eval dispatched on the mesh, equal plans (nodes and
    ports, the port draws seeded alike)."""
    from nomad_tpu_torch.scheduler.torch_binpack import \
        TorchBinPackScheduler

    sharded_flags = []
    orig = TorchBinPackScheduler.dispatch_device

    def recorded(self, *a, **kw):
        out = orig(self, *a, **kw)
        sharded_flags.append(self.dispatched_sharded)
        return out

    def run(policy):
        h = Harness(device=DEV)
        for i in range(10_000):
            h.state.upsert_node(h.next_index(), mock.node(i))
        job = mock.job()
        job.id = "config4-mesh"
        job.task_groups = [bench_task_group(structs, f"tg-{g}")
                           for g in range(1000)]
        random.seed(41)
        with mesh_mod.mesh_override(policy):
            t = time.perf_counter()
            placed, failed = run_eval(structs, h, job, [])
            wall = time.perf_counter() - t
        require(len(placed) == 1000 and not failed,
                f"config 4 on {policy}: {len(placed)} placed")
        names = {n.id: n.name for n in h.state.nodes()}
        return mesh_plans(h.plans, names), wall

    # In turns (unsharded, sharded, sharded, unsharded): the first run
    # of each also loads its kernels and plans.
    TorchBinPackScheduler.dispatch_device = recorded
    try:
        single, single_s = run("off")
        (sharded, sharded_s), _ = launches_of(lambda: run(devices), total,
                                              walks)
        sharded2, sharded2_s = run(devices)
        single2, single2_s = run("off")
    finally:
        TorchBinPackScheduler.dispatch_device = orig
    require(sharded_flags == [False, True, True, False],
            f"config 4: dispatched_sharded {sharded_flags}, want the mesh "
            "runs and only they sharded")
    require(sharded == single == sharded2 == single2,
            "config 4: the plan on the mesh differs from the unsharded "
            "run's (nodes or ports)")
    return dict(eval_s=[sharded_s, sharded2_s],
                unsharded_eval_s=[single_s, single2_s], placements=1000)


def mesh_config2_stream(torch, mock, structs, Harness, devices, mesh_mod,
                        total, walks):
    """Config 2's batch jobs as a PipelinedEvalRunner stream on 1,000
    nodes, each eval's plan committed before the next (the mirror's
    sharded twin scatters between evals), unsharded and on ``devices``:
    every device dispatch sharded, equal plans, and the mirror's
    sharded usage equal to the host mirror byte for byte."""
    from nomad_tpu_torch.models.fleet import fleet_cache, mirror_for
    from nomad_tpu_torch.scheduler.pipeline import PipelinedEvalRunner

    def run(policy):
        h = Harness(device=DEV)
        for i in range(1000):
            h.state.upsert_node(h.next_index(), mock.node(i))
        jobs = [config2_job(mock, structs, seed) for seed in range(6)]
        for j in jobs:
            h.state.upsert_job(h.next_index(), j)
        runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=3,
                                     state_refresh=h.snapshot, device=DEV)
        random.seed(42)
        with mesh_mod.mesh_override(policy):
            for job in jobs:
                runner.state = h.snapshot()
                runner.process([make_eval(structs, job)])
        names = {n.id: n.name for n in h.state.nodes()}
        return mesh_plans(h.plans, names), runner, h

    single, r_single, _h = run("off")
    (sharded, r_mesh, h), _ = launches_of(lambda: run(devices), total,
                                          walks)
    require(r_single.sharded_dispatches == 0,
            "config 2 unsharded: a dispatch ran on a mesh")
    require(r_mesh.device_dispatches > 0 and r_mesh.sharded_dispatches
            == r_mesh.device_dispatches,
            f"config 2 on the mesh: {r_mesh.sharded_dispatches} of "
            f"{r_mesh.device_dispatches} device dispatches sharded")
    require(sharded == single,
            "config 2: the stream's plans on the mesh differ")
    require(sum(len(p) for p in sharded) == 6 * 40,
            "config 2: not every copy placed")
    statics = fleet_cache.statics_for(h.state)
    mirror = mirror_for(statics)
    mirror.sync(h.state)
    with mesh_mod.mesh_override(devices):
        mesh = mesh_mod.dispatch_mesh(1, statics.n_pad, device=DEV)
    buf = mirror.device_usage_sharded(mesh, mirror.usage)
    require(buf is not None, "config 2: no sharded usage twin")
    require(np.array_equal(mesh_mod.gather(buf).cpu().numpy().view(np.int32),
                           mirror.usage.view(np.int32)),
            "config 2: the sharded usage twin differs from the host mirror")
    return dict(evals=6, device_dispatches=r_mesh.device_dispatches,
                sharded_dispatches=r_mesh.sharded_dispatches)


def mesh_config5(torch, mock, structs, Harness, BatchEvalRunner, devices,
                 mesh_mod, total, walks):
    """Config 5's storm (64 jobs x 1,000 groups on 10,000 nodes) through
    BatchEvalRunner with the record-only planner, unsharded and on
    ``devices``' 2x2 storm mesh: placements equal lane for lane."""
    h = Harness(device=DEV)
    for i in range(10_000):
        h.state.upsert_node(h.next_index(), mock.node(i))
    jobs = storm_jobs(mock, structs, "config5-mesh", 64, 1000)
    for j in jobs:
        h.state.upsert_job(h.next_index(), j)
    snap = h.snapshot()
    names = {n.id: n.name for n in h.state.nodes()}

    def run(policy):
        planner = RecordOnlyPlanner(structs)
        random.seed(43)
        with mesh_mod.mesh_override(policy):
            t = time.perf_counter()
            BatchEvalRunner(snap, planner, device=DEV).process(
                [make_eval(structs, j) for j in jobs])
            wall = time.perf_counter() - t
        return mesh_plans(planner.plans, names), wall

    single, single_s = run("off")
    with mesh_mod.mesh_override(devices):
        storm = mesh_mod.dispatch_mesh(64, 16384, device=DEV)
    require(storm is not None and storm.lane_ways == 2
            and storm.fleet_ways == 2,
            f"config 5: the storm resolved {storm}, not a 2x2 mesh")
    (sharded, sharded_s), _ = launches_of(lambda: run(devices), total,
                                          walks)
    require(len(sharded) == 64 and all(len(p) == 1000 for p in sharded),
            "config 5 on the mesh: not every lane placed 1,000")
    require(sharded == single,
            "config 5: the storm's placements on the mesh differ")
    return dict(evals=64, placements=64_000, wall_s=sharded_s,
                unsharded_wall_s=single_s)


def mesh_verify(torch, mock, structs, Harness, VerifyingPlanner,
                BatchEvalRunner, devices, mesh_mod, total, walks):
    """Config 5b through the verifying applier: under the ``host``
    verify policy unsharded, and under ``device`` on ``devices``, where
    every window of more than one plan must verify through
    window_verify_sharded (K7d on each shard, then K6) with no fallback:
    equal commits, so equal verdicts."""
    from nomad_tpu_torch.ops.verify_policy import verify_override

    with verify_override("host"), mesh_mod.mesh_override("off"):
        want, want_counts = storm_config5b(mock, structs, Harness,
                                           VerifyingPlanner, BatchEvalRunner)
    records, restore = window_records()
    try:
        with verify_override("device"), mesh_mod.mesh_override(devices):
            (got, got_counts), counts = launches_of(
                lambda: storm_config5b(mock, structs, Harness,
                                       VerifyingPlanner, BatchEvalRunner),
                total, walks)
    finally:
        restore()
    windows = [r for r in records if r is not None]
    require(windows and all(r["dispatched"] and r["fallback"] is None
                            for r in windows),
            f"config 5b on the mesh: windows {windows[:3]} did not all "
            "verify on the device")
    # One launch of K6's sharded form a window; K7d only for the shards
    # it does not read in place (none where the row is at most 16
    # shards of one card).
    with mesh_mod.mesh_override(devices):
        vmesh = mesh_mod.dispatch_mesh(1, 256, device=DEV)
    others = len(mesh_mod.verify_layout(vmesh.grid[0])[1])
    launches = {"window_verify_sharded": len(windows), "window_verify": 0,
                "shard_gather": others * len(windows)}
    require(all(counts[k] == v for k, v in launches.items()),
            f"config 5b on the mesh: {counts['shard_gather']} K7d, "
            f"{counts['window_verify_sharded']} sharded K6 and "
            f"{counts['window_verify']} K6 launches for {len(windows)} "
            f"windows, want {launches}")
    require(got == want, "config 5b: the commits under the sharded device "
            "verify differ from the host engine's")
    for k in ("placed", "conflicts", "commits", "conflict_fallbacks"):
        require(got_counts[k] == want_counts[k],
                f"config 5b: {k} {got_counts[k]} on the mesh, "
                f"{want_counts[k]} on the host engine")
    return dict(windows=len(windows), placed=got_counts["placed"],
                k7d_shards=others, wall_s=got_counts["wall_s"],
                host_wall_s=want_counts["wall_s"])


def mesh_system(torch, devices, wide=False) -> tuple:
    """Step 3 of the mesh phase: the system path on ``devices``, each
    configuration also run unsharded to compare with; ``wide`` (a row of
    more shards than one launch takes) runs config 4 (its single evals
    step on shard_step + K7b) and config 5b's verifying storm (its
    windows gather the shards past 16 with K7d) alone.  Returns the
    results and the launches of the sharded runs alone, each run's
    counted from 0."""
    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.parallel import mesh as mesh_mod
    from nomad_tpu_torch.scheduler import Harness, VerifyingPlanner
    from nomad_tpu_torch.scheduler.batch import BatchEvalRunner

    out, total, walks = {}, {}, []
    out["config4"] = mesh_config4(torch, mock, structs, Harness, devices,
                                  mesh_mod, total, walks)
    if not wide:
        out["config2_stream"] = mesh_config2_stream(
            torch, mock, structs, Harness, devices, mesh_mod, total, walks)
        out["config5_storm"] = mesh_config5(torch, mock, structs, Harness,
                                            BatchEvalRunner, devices,
                                            mesh_mod, total, walks)
    out["config5b_device_verify"] = mesh_verify(
        torch, mock, structs, Harness, VerifyingPlanner, BatchEvalRunner,
        devices, mesh_mod, total, walks)
    from nomad_tpu_torch.ops.binpack import STEP_SHARDS

    one_card = len({torch.device(d) for d in devices}) == 1
    one_launch = one_card and len(devices) <= STEP_SHARDS
    out["walks"] = walk_launch_check(
        walks, total, "shard_walk" if one_launch else None)
    need = ("shard_walk", "window_verify_sharded") + (
        () if one_launch else MESH_ACROSS_NAMES)
    for name in need:
        require(total[name] > 0,
                f"mesh: {name} was not launched on the system path")
    absent = ("window_verify", "place_sequence", "place_rounds",
              "place_rounds_batch", "place_sequence_batch") + (
        MESH_ACROSS_NAMES if one_launch else ())
    for name in absent:
        require(total[name] == 0,
                f"mesh: {name} launched {total[name]} times on the mesh's "
                "system path")
    return out, total


def run_mesh(torch) -> dict:
    """The mesh phase: K7's kernels against their plain versions, the
    sharded wrappers against the unsharded kernels and the system path,
    on a mesh of MESH_SHARDS entries naming cuda:0 (every row one launch
    group: shard_walk and K6's sharded form alone), then on MESH_WIDE
    entries (rows of more shards than a launch takes: shard_step, K7b
    and K7d, the routes of shards that span cards); again on distinct
    cards where the machine has two or more.  The system paths'
    launches are counted from 0."""
    rng = np.random.default_rng([1234, 15])
    t = time.perf_counter()
    kernels_ = mesh_kernel_checks(torch, rng)
    for name, r in kernels_.items():
        print(f"mesh kernel {name}: " + json.dumps(r), flush=True)
    one_card = [f"{DEV}:0"] * MESH_SHARDS
    wrappers = mesh_wrapper_checks(torch, one_card, rng)
    print("mesh wrappers: " + json.dumps(wrappers), flush=True)
    system, launches = mesh_system(torch, one_card)
    print("mesh system: " + json.dumps(system), flush=True)
    print("mesh launches: " + json.dumps(launches), flush=True)
    wide, wide_launches = mesh_system(torch, [f"{DEV}:0"] * MESH_WIDE,
                                      wide=True)
    print(f"mesh system {MESH_WIDE} shards: " + json.dumps(wide), flush=True)
    print(f"mesh launches {MESH_WIDE} shards: " + json.dumps(wide_launches),
          flush=True)
    n_cards = torch.cuda.device_count()
    cross = None
    if n_cards >= 2:
        cards = [f"{DEV}:{i}" for i in range(min(n_cards, MESH_SHARDS))]
        cards = cards[:1 << (len(cards).bit_length() - 1)]
        if len(cards) < MESH_SHARDS:
            cards = (cards * MESH_SHARDS)[:MESH_SHARDS]
        cross = dict(cards=cards,
                     wrappers=mesh_wrapper_checks(torch, cards, rng),
                     system=mesh_system(torch, cards)[0])
        print("mesh cross-card: " + json.dumps(cross), flush=True)
    else:
        print(f"mesh: cross-card exchange untested ({n_cards} card)",
              flush=True)
    total = {k: launches.get(k, 0) + wide_launches.get(k, 0)
             for k in set(launches) | set(wide_launches)}
    return dict(kernels=kernels_, wrappers=wrappers, system=system,
                wide=wide, launches=total, cross_card=cross,
                seconds=time.perf_counter() - t)


# -- phase 16: the runtime sanitizers on the main path -----------------------

# Config 4 (one eval of 1,000 groups on 10,000 nodes) and config 5b (a
# 64-job x 100-group storm on 160 nodes, through the server).
SANITIZER_SIZES4 = (10_000, 1000)
SANITIZER_SIZES5B = (160, 64, 100)
# The serving plane's reads the budget witness watches on config 5b's
# live server: so many jobs' and evals' RPC reads.
SANITIZER_READS = 16
# The kernels those two paths launch: K3 (config 4), K4a and K6 (config
# 5b), K5 (the usage mirror's syncs).
SANITIZER_KERNELS = ("place_rounds", "place_rounds_batch", "window_verify",
                     "scatter_rows")


def sanitizer_config4(mock, structs, Harness, n_nodes, n_groups) -> list:
    """Config 4 through ``Harness.process`` on DEV (K3, K5): the plan's
    placements by node name, with ports (seeded draws)."""
    h = Harness(device=DEV)
    for i in range(n_nodes):
        h.state.upsert_node(h.next_index(), mock.node(i))
    job = mock.job()
    job.id = "sanitizers-config4"
    job.task_groups = [bench_task_group(structs, f"tg-{g}")
                       for g in range(n_groups)]
    random.seed(43)
    placed, failed = run_eval(structs, h, job, [])
    require(len(placed) == n_groups and not failed,
            f"sanitizers config 4: {len(placed)} placed, {len(failed)} "
            "failed")
    names = {n.id: n.name for n in h.state.nodes()}
    return mesh_plans(h.plans, names)


def serve_reads(srv, eval_ids, n=SANITIZER_READS) -> int:
    """Read back through the live server's RPC plane (the admitted
    bodies the budget witness watches): jobs, their allocations and
    evals, and the lists.  Returns the calls made."""
    from nomad_tpu_torch.server.rpc import ConnPool

    state = srv.fsm.state
    evals = [state.eval_by_id(e) for e in eval_ids[:n]]
    pool = ConnPool()
    addr = srv.rpc_address()
    calls = 0
    try:
        for ev in evals:
            for method, args in (("Eval.GetEval", {"eval_id": ev.id}),
                                 ("Job.GetJob", {"job_id": ev.job_id}),
                                 ("Job.Allocations", {"job_id": ev.job_id})):
                pool.call(addr, method, args, timeout=30)
                calls += 1
        for method in ("Job.List", "Node.List", "Eval.List"):
            pool.call(addr, method, {}, timeout=30)
            calls += 1
    finally:
        pool.shutdown()
    return calls


def server_placements(srv) -> list:
    """Every live alloc of the server's store as (job, name, node name,
    ports), sorted."""
    state = srv.fsm.state
    names = {n.id: n.name for n in state.nodes()}
    return sorted((a.job_id, a.name, names[a.node_id], alloc_ports(a))
                  for a in state.allocs() if not a.terminal_status())


def sanitizer_config5b(torch, mock, structs, sizes, counters, name):
    """Config 5b through the port's server under the device verify
    policy (K4a, K6, K5), its RPC listener up for ``serve_reads``.
    Returns the shape's row, its placements and the reads made."""
    n, j, g = sizes
    random.seed(5)
    row = server_shape(torch, name, [mock.node(i) for i in range(n)],
                       storm_jobs(mock, structs, "config5b", j, g),
                       verify="device", counters=counters, rpc=True,
                       inspect_server=lambda srv, ids: (
                           server_placements(srv), serve_reads(srv, ids)))
    placements, reads = row.pop("inspect")
    return row, placements, reads


def planted_upload(torch, mock, structs, Harness, guard) -> str:
    """Plant an implicit upload inside a guarded seam (K3's wrapper,
    called from ``TorchBinPackScheduler.dispatch_device``, first moves a
    host tensor to the card with ``.to``) and require the guard's own
    refusal; the refusal is then taken off the guard's record."""
    from nomad_tpu_torch.analysis.sanitizers import ImplicitTransferError
    from nomad_tpu_torch.ops import binpack

    real = binpack.place_rounds

    def planted(*args, **kw):
        torch.ones(4).to("cuda")
        return real(*args, **kw)

    h = Harness(device=DEV)
    for i in range(64):
        h.state.upsert_node(h.next_index(), mock.node(i))
    job = mock.job()
    job.id = "sanitizers-planted"
    job.task_groups = [bench_task_group(structs, "tg-0")]
    before = len(guard.refused)
    binpack.place_rounds = planted
    raised = None
    try:
        run_eval(structs, h, job, [])
    except ImplicitTransferError as e:
        raised = e
    except SmokeError:
        pass  # the eval failed: the refusal is on the guard's record
    finally:
        binpack.place_rounds = real
    refused = guard.refused[before:]
    require(len(refused) == 1 and "Tensor.to" in refused[0],
            f"sanitizers: the planted upload was not refused by the "
            f"guard ({refused}, raised {raised!r})")
    del guard.refused[before:]
    return refused[0]


def replica_digest(state) -> str:
    """What the divergence twin compares on the card: ``store_digest``
    (the store's fingerprint with each alloc's embedded job digested
    once a job) and the alloc changelog the fingerprint also holds.
    The fingerprint itself serializes config 5b's job again for each
    of its 6,240 allocs: about 30 s a store on a CPU."""
    import hashlib

    t = state.snapshot()._t
    upto = t.indexes.get("allocs", 0)
    log = [(index, sorted(ids)) for index, ids in t.alloc_log
           if index <= upto]
    return hashlib.sha256((store_digest(state) + repr(log)).encode()
                          ).hexdigest()


def run_sanitizers(torch, sizes4=SANITIZER_SIZES4,
                   sizes5b=SANITIZER_SIZES5B) -> dict:
    """The sanitizers phase: config 4 through ``Harness.process`` (K3,
    K5) and config 5b through the port's server under the device verify
    policy (K4a, K6, K5), first as they are, then under the port's four
    runtime sanitizers installed at once (lock-order witness, transfer
    guard, replica divergence, budget witness; a failure to install
    one fails the phase), with the launch counts set to 0 just before
    and read after.  Requires: no lock-order cycle, no implicit upload,
    no divergence, no unbounded wait on a serving thread, plans equal
    to the runs without sanitizers, and a planted implicit upload
    refused by the guard.  Prints the locks and edges witnessed, the
    FSM pairs compared and the counted uploads per eval; the recorded
    launches are replayed against the plain versions."""
    import nomad_tpu_torch.mock as mock
    import nomad_tpu_torch.structs as structs
    from nomad_tpu_torch.analysis.sanitizers import (
        BudgetWitnessSanitizer, LockOrderWitness,
        ReplicaDivergenceSanitizer, TransferGuardSanitizer)
    from nomad_tpu_torch.parallel import devices
    from nomad_tpu_torch.scheduler import Harness

    t0 = time.perf_counter()
    split = {}
    # The runs without sanitizers: the plans to hold the others against.
    with recorded_kernels() as ref:
        want4 = sanitizer_config4(mock, structs, Harness, *sizes4)
        _row, want5b, _reads = sanitizer_config5b(
            torch, mock, structs, sizes5b, ref.counters,
            "sanitizers reference 5b")
    split["reference_s"] = time.perf_counter() - t0
    with recorded_kernels() as rec:
        witness = LockOrderWitness()
        guard = TransferGuardSanitizer()
        divergence = ReplicaDivergenceSanitizer(digest=replica_digest)
        budget = BudgetWitnessSanitizer()
        installed = []
        try:
            for san in (witness, guard, divergence, budget):
                installed.append(san.install())
            for fn in rec.counters.values():
                fn.launches = 0
            h2d0 = devices.transfer_counts()["h2d"]
            t = time.perf_counter()
            got4 = sanitizer_config4(mock, structs, Harness, *sizes4)
            launches = {k: fn.launches for k, fn in rec.counters.items()}
            h2d4 = devices.transfer_counts()["h2d"]
            split["config4_s"] = time.perf_counter() - t
            row5b, got5b, reads = sanitizer_config5b(
                torch, mock, structs, sizes5b, rec.counters,
                "sanitizers 5b")
            wall = time.perf_counter() - t
            h2d5b = devices.transfer_counts()["h2d"]
            # server_shape set the counts to 0 before config 5b
            for k, n in row5b["launches"].items():
                launches[k] += n
            t = time.perf_counter()
            divergence.compare_all()
            split["compare_all_s"] = time.perf_counter() - t
        finally:
            for san in reversed(installed):
                san.uninstall()
        t = time.perf_counter()
        replay = rec.replay(torch, launches, "sanitizers")
        split["replay_s"] = time.perf_counter() - t
    # The planted upload, after the counted run: its eval's K3 launch
    # (if the guard let it through) is not the main path's.
    t = time.perf_counter()
    guard.install()
    try:
        planted = planted_upload(torch, mock, structs, Harness, guard)
    finally:
        guard.uninstall()
    split["planted_s"] = time.perf_counter() - t
    require(got4 == want4, "sanitizers: config 4's plan differs from the "
            "run without sanitizers")
    require(got5b == want5b, "sanitizers: config 5b's placements differ "
            "from the run without sanitizers")
    for name in SANITIZER_KERNELS:
        require(launches[name] > 0,
                f"sanitizers: {name} was not launched on the main path")
    require(guard.entries > 0, "sanitizers: no guarded seam was entered")
    require(divergence.compared > 0,
            "sanitizers: no FSM pair was compared")
    require(len(witness.sites) > 0 and len(witness.edges) > 0,
            "sanitizers: the witness saw no locks or no lock order")
    errors = []
    for check in (witness.check, guard.check, divergence.check,
                  budget.check):
        try:
            check()
        except AssertionError as e:
            errors.append(str(e))
    require(not errors, "sanitizers: " + "\n".join(errors))
    evals5b = sizes5b[1]
    row = dict(
        lock_sites=len(witness.sites), lock_edges=len(witness.edges),
        lock_self_edges=len(witness.self_edges), cycles=0,
        guard_entries=guard.entries, implicit_uploads=0,
        planted_refused=planted,
        fsm_pairs_compared=divergence.compared,
        fsm_pairs_desynced=divergence.desynced,
        serving_reads=reads, unbounded_waits=0,
        uploads_per_eval=dict(config4=h2d4 - h2d0,
                              config5b=(h2d5b - h2d4) / evals5b),
        sanitized_wall_s=wall, config5b_wall_s=row5b["wall_s"],
        split_s=split,
        launches=launches, seconds=time.perf_counter() - t0)
    print("sanitizers: " + json.dumps(row), flush=True)
    row["main_path_replay"] = replay
    return row


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
    from nomad_tpu_torch.scheduler.executor import executor_override

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

    def phase(name, fn):
        t = time.perf_counter()
        out = fn()
        print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    t0 = time.perf_counter()
    built = kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(built)) or 'up to date'})", flush=True)

    if argv[:1] in (["--wire"], ["--wire-groups"]):
        # The wire phase alone: no kernel checks, no result line;
        # --wire-groups N forces config 5's width to N groups.
        groups = int(argv[1]) if argv[0] == "--wire-groups" else None
        with executor_override("device"):
            wr = run_wire(torch, n_groups=groups)
        print("wire launches: " + json.dumps(wr["launches"]), flush=True)
        print("chip_smoke: --wire run, no result line", flush=True)
        return 0
    if argv[:1] == ["--client"]:
        # The client phase alone: no kernel checks, no result line.
        with executor_override("device"):
            run_client(torch)
        print("chip_smoke: --client run, no result line", flush=True)
        return 0
    if argv[:1] == ["--agent"]:
        # The agent phase alone: no kernel checks, no result line.
        with executor_override("device"):
            run_agent(torch)
        print("chip_smoke: --agent run, no result line", flush=True)
        return 0
    if argv[:1] == ["--failover"]:
        # The failover phase alone: no kernel checks, no result line.
        with executor_override("device"):
            fo = run_failover(torch)
        print("failover launches: " + json.dumps(fo["launches"]),
              flush=True)
        print("chip_smoke: --failover run, no result line", flush=True)
        return 0
    if argv[:1] == ["--mesh"]:
        # The mesh phase alone: no other checks, no result line.
        with executor_override("device"):
            ms = run_mesh(torch)
        print(f"phase mesh: {ms['seconds']:.1f} s", flush=True)
        print("chip_smoke: --mesh run, no result line", flush=True)
        return 0
    if argv[:1] == ["--sanitizers"]:
        # The sanitizers phase alone: no kernel checks, no result line.
        with executor_override("device"):
            sz = phase("sanitizers", lambda: run_sanitizers(torch))
        print("sanitizers launches: " + json.dumps(sz["launches"]),
              flush=True)
        print("chip_smoke: --sanitizers run, no result line", flush=True)
        return 0
    if argv[:1] == ["--control"]:
        # The control phase alone: no kernel checks, no result line.
        with executor_override("device"):
            run_control(torch)
        print("chip_smoke: --control run, no result line", flush=True)
        return 0
    if argv[:1] == ["--executor"]:
        # The executor phase alone (its config-5b storms are not held
        # against a device storm): no kernel checks, no result line.
        ex = run_executor(torch)
        print("executor: " + json.dumps(
            {k: v for k, v in ex.items() if k not in (
                "crossover", "storm_crossover", "streams",
                "main_path_rounds", "main_path_replay")}), flush=True)
        print("chip_smoke: --executor run, no result line", flush=True)
        return 0
    checks = kernel_checks(torch, binpack, fleet, mesh)
    if argv:
        # --only NAME[,NAME]: those kernels' checks alone; no main paths
        # and no result line.
        if len(argv) != 2 or argv[0] != "--only" or \
                not set(argv[1].split(",")) <= set(checks):
            print(f"usage: chip_smoke.py [--only {','.join(checks)}] "
                  f"[--executor] [--wire] [--wire-groups N] [--client] "
                  f"[--agent] [--failover] [--control] [--mesh] "
                  f"[--sanitizers] "
                  f"[--profiler-events SECONDS]",
                  file=sys.stderr)
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
    # The phases that hold the kernels on their main paths run under
    # the device executor, as bench.py's device rows do: under auto the
    # cost policy could keep a config-2 eval or the config-5b storm on
    # the numpy twins, and their launch checks would prove nothing.
    with executor_override("device"):
        sl = phase("slice", lambda: run_slice(torch))
        print("slice: " + json.dumps(sl), flush=True)
        st = phase("storm", lambda: run_storm(torch))
        placed5b = st.pop("placed5b")
        print("storm: " + json.dumps(st), flush=True)
        sv = phase("server", lambda: run_server(torch, len(placed5b)))
        print("server: " + json.dumps(
            {k: v for k, v in sv.items() if k != "main_path_replay"}),
            flush=True)
        wr = phase("wire", lambda: run_wire(torch))
        cl = phase("client", lambda: run_client(torch))
        ag = phase("agent", lambda: run_agent(torch))
        fo = phase("failover", lambda: run_failover(torch))
        co = phase("control", lambda: run_control(torch))
        sy = phase("system", run_system)
        print("system: " + json.dumps(sy), flush=True)
    ex = phase("executor", lambda: run_executor(torch, placed5b=placed5b))
    print("executor: " + json.dumps(
        {k: v for k, v in ex.items() if k not in (
            "crossover", "storm_crossover", "streams", "main_path_rounds",
            "main_path_replay")}), flush=True)
    with executor_override("device"):
        vf = phase("verify fleet", run_verify_fleet)
    print("verify fleet: " + json.dumps(
        {k: v for k, v in vf.items() if k != "table"}), flush=True)
    with executor_override("device"):
        ms = phase("mesh", lambda: run_mesh(torch))
    with executor_override("device"):
        sz = phase("sanitizers", lambda: run_sanitizers(torch))
    # Launches on the main paths, each path counted from 0: the slice,
    # the storm (K6 in config 5b under the device policy), the server
    # phase's shapes, the wire, client, agent, failover and control
    # phases, the executor phase's timed pipelined streams, the
    # verify-fleet phase and the sanitizers phase.
    launches = {k: sl["launches"].get(k, 0) + st["launches"][k]
                + sv["launches"][k] + wr["launches"][k]
                + cl["launches"][k] + ag["launches"][k]
                + fo["launches"][k] + co["launches"][k]
                + ex["launches"].get(k, 0) + sz["launches"][k]
                for k in st["launches"]}
    launches["window_verify"] += vf["launches"]
    for name in ("scatter_rows", "window_verify") + MESH_LAUNCH_NAMES:
        launches[name] = launches.get(name, 0) + ms["launches"][name]
    replay_err = {name: max([r["err"] for r in sl["main_path_rounds"]
                             + st["main_path_rounds"]
                             + ex["main_path_rounds"]
                             + ex["main_path_replay"]
                             + sv["main_path_replay"]
                             + wr["main_path_replay"]
                             + cl["main_path_replay"]
                             + ag["main_path_replay"]
                             + fo["main_path_replay"]
                             + co["main_path_replay"]
                             + sz["main_path_replay"]
                             if r["kernel"] == name], default=0.0)
                  for name in ("place_rounds", "place_rounds_batch",
                               "scatter_rows", "window_verify")}
    replay_err["place_sequence"] = max(
        [sl["main_path_sequence"]["err"]]
        + [r["err"] for r in ex["main_path_replay"] + sv["main_path_replay"]
           + wr["main_path_replay"] + cl["main_path_replay"]
           + ag["main_path_replay"] + fo["main_path_replay"]
           + co["main_path_replay"] + sz["main_path_replay"]
           if r["kernel"] == "place_sequence"])
    replay_err["place_sequence_batch"] = max(
        [st[storm]["main_path_sequence_batch"]["err"]
         for storm in ("sequence_storm", "fleet_sequence_storm")]
        + [r["err"] for r in sv["main_path_replay"] + wr["main_path_replay"]
           + cl["main_path_replay"] + ag["main_path_replay"]
           + fo["main_path_replay"] + co["main_path_replay"]
           + sz["main_path_replay"]
           if r["kernel"] == "place_sequence_batch"])
    mk = ms["kernels"]
    timed = {"place_sequence": seq, "place_rounds": rnd,
             "scatter_rows": sct, "place_rounds_batch": rb,
             "place_sequence_batch": sb, "window_verify": wv5f,
             # K7a+c at k_cap, B=1 (its k = 1 and B = 64 times beside
             # it as k1_* and b64_*)
             "shard_step": dict(mk["shard_step k=1024"], **{
                 f"{tag}_{key}": mk[case][key]
                 for tag, case in (("k1", "shard_step k=1"),
                                   ("b64", "shard_step B=64 k=1024"))
                 for key in ("ms", "device_ms", "plain_ms", "library_ms",
                             "bound_ms")}),
             "merge_select": mk["merge_select S=4 B=64"],
             "shard_gather": mk["shard_gather 5f window"],
             # the sequence walk of N = 16,384, P = 1,024 (config 4's,
             # config 5's row and the K4b-shaped storm's walks beside it
             # as c4_*, c5_* and b8_*)
             "shard_walk": dict(mk["shard_walk sequence N=16384 P=1024"], **{
                 f"{tag}_{key}": mk[case][key]
                 for tag, case in (("c4", "shard_walk config 4"),
                                   ("c5", "shard_walk config 5 row"),
                                   ("b8", "shard_walk sequence B=8 P=256"))
                 for key in ("ms", "device_ms", "plain_ms", "bound_ms")}),
             # the 5f window (config-5b scale beside it as c5b_*)
             "window_verify_sharded": dict(
                 mk["window_verify_sharded 5f window"], **{
                     f"c5b_{key}": mk[
                         "window_verify_sharded config-5b scale"][key]
                     for key in ("ms", "device_ms", "host_ms", "plain_ms",
                                 "bound_ms")})}
    sources = {"scatter_rows": "scatter_rows.cu",
               "window_verify": "window_verify.cu",
               "shard_gather": "window_verify.cu",
               "window_verify_sharded": "window_verify.cu"}
    replaces = {"place_sequence": "nomad_tpu/ops/binpack.py:78",
                "place_rounds": "nomad_tpu/ops/binpack.py:123",
                "scatter_rows": "nomad_tpu/models/fleet.py:1108",
                "place_rounds_batch": "nomad_tpu/ops/binpack.py:185",
                "place_sequence_batch": "nomad_tpu/ops/binpack.py:203",
                "window_verify": "nomad_tpu/parallel/mesh.py:357",
                # K7: the per-shard selection, the cross-shard merge and
                # the owner's update of the sharded jits at :210, :252,
                # :279 and :314; the row gather of :408.
                "shard_step": "nomad_tpu/parallel/mesh.py:210",
                "merge_select": "nomad_tpu/parallel/mesh.py:252",
                "shard_gather": "nomad_tpu/parallel/mesh.py:408",
                # the whole walk of a one-card row (select, merge and
                # update of :210, :252, :279, :314), and the sharded
                # window verify of :408
                "shard_walk": "nomad_tpu/parallel/mesh.py:210",
                "window_verify_sharded": "nomad_tpu/parallel/mesh.py:408"}
    k.update({name: mk for name in MESH_LAUNCH_NAMES})
    kernels_line = {"kernels": []}
    for name, r in timed.items():
        if name in MESH_LAUNCH_NAMES:
            require(launches[name] > 0,
                    f"{name} was not launched on the mesh's main path")
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
        row.update({key: v for key, v in r.items()
                    if key.startswith(("k1_", "b64_", "c4_", "c5_", "b8_",
                                       "c5b_"))})
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
