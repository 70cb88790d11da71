"""Plan verification: the serialization point of optimistic concurrency.

Counterpart of the verify half of ``nomad_tpu/server/plan_apply.py``
(reference nomad/plan_apply.go:171-284): every node a plan touches is
checked against a state snapshot (node ready + AllocsFit + exact ports
and bandwidth); the plan is partially accepted (or wholly rejected for
AllAtOnce plans) with a RefreshIndex that makes the scheduler refresh
its stale view.  ``OptimisticSnapshot`` overlays not-yet-committed
allocs on a snapshot so plan N+1 can be verified while plan N commits.

The leader's group-commit applier (``PlanApplier``) drains the plan
queue in windows, verifies each window with
``ops/plan_conflict.evaluate_window`` (claim-graph components on the
``ComponentExecutor``), and commits the accepted portions as one raft
apply from the ``_Committer`` thread.  The batch runner and the
harness's ``VerifyingPlanner`` also drive verification directly.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

from nomad_tpu_torch.structs import (
    NODE_STATUS_READY,
    Plan,
    PlanResult,
    allocs_fit,
    codec,
    filter_terminal_allocs,
    remove_allocs,
)
from nomad_tpu_torch.utils.metrics import metrics

from nomad_tpu_torch.obs import flight as flight_mod
from nomad_tpu_torch.obs import trace as trace_mod

logger = logging.getLogger("nomad_tpu_torch.server.plan_apply")


class OptimisticSnapshot:
    """Read view = base snapshot + not-yet-committed alloc upserts.

    Lets the applier verify plan N+1 while plan N's raft apply is still in
    flight (the reference mutates its state snapshot in place; our MVCC
    snapshots are immutable, so this overlay provides the same effect)."""

    def __init__(self, base) -> None:
        self.base = base
        self._overlay: dict = {}        # alloc id -> Allocation
        self._by_node: dict = {}        # node id -> [alloc ids]

    def upsert_allocs(self, allocs: list) -> None:
        for a in allocs:
            if a.id not in self._overlay:
                self._by_node.setdefault(a.node_id, []).append(a.id)
            self._overlay[a.id] = a

    # -- read API used by plan evaluation ---------------------------------
    def node_by_id(self, node_id: str):
        return self.base.node_by_id(node_id)

    def allocs_by_node(self, node_id: str) -> list:
        base = self.base.allocs_by_node(node_id)
        if not self._overlay:
            return base
        merged = {a.id: a for a in base}
        for aid in self._by_node.get(node_id, ()):
            merged[aid] = self._overlay[aid]
        return list(merged.values())

    def get_index(self, table: str) -> int:
        return self.base.get_index(table)


def evaluate_plan(snap, plan: Plan) -> PlanResult:
    """Determine the committable portion of a plan
    (plan_apply.go:171-233).

    The per-node verdicts come from a vectorized pass over the fleet
    mirror when the snapshot supports it (one numpy fit row + O(plan)
    port/bandwidth bookkeeping per node, see _evaluate_plan_vec);
    nodes the vector pass cannot serve — and any snapshot without a
    mirror — fall back to the scalar allocs_fit/NetworkIndex walk,
    which stays the semantic truth."""
    _start = time.perf_counter()
    result = PlanResult(failed_allocs=list(plan.failed_allocs))

    node_ids = set(plan.node_update) | set(plan.node_allocation)
    # Evict-only plans are trivially acceptable per node; don't spin up
    # (or permanently enable) the mirror's net tracking for them.
    verdicts = _evaluate_plan_vec(snap, plan, node_ids) \
        if any(plan.node_allocation.values()) else None
    for node_id in node_ids:
        ok = verdicts.get(node_id) if verdicts is not None else None
        if ok is None:
            ok = _evaluate_node_plan(snap, plan, node_id)
        if ok:
            if plan.node_update.get(node_id):
                result.node_update[node_id] = plan.node_update[node_id]
            if plan.node_allocation.get(node_id):
                result.node_allocation[node_id] = \
                    plan.node_allocation[node_id]
            continue

        # Scheduler had stale data: RefreshIndex forces a fresh view.
        result.refresh_index = max(snap.get_index("nodes"),
                                   snap.get_index("allocs"))
        if plan.all_at_once:
            result.node_update = {}
            result.node_allocation = {}
            return result
        # Partial acceptance: skip this node only.
    metrics.measure_since("nomad.plan.evaluate", _start)
    return result


def _evaluate_plan_vec(snap, plan: Plan, node_ids) -> Optional[dict]:
    """Vectorized node verdicts: {node_id: True/False/None} or None when
    the snapshot cannot take the vector path at all.  ``None`` verdicts
    punt single nodes to the exact scalar walk.

    Capability parity with the per-node loop of
    reference nomad/plan_apply.go:238-284, restructured for
    throughput: instead of rebuilding a Resources sum and a NetworkIndex
    per node per plan, the fleet UsageMirror keeps per-node usage rows,
    port counts and bandwidth sums synced incrementally from the store
    changelog, so one plan's verification costs O(plan size), not
    O(allocs on touched nodes).  Dimension sums ride float32 like every
    other fleet tensor (exact for values < 2^24, i.e. any realistic
    node).  Nodes with multi-network topologies, mixed-ip/device alloc
    offers, or overlay (in-flight apply) deltas keep the scalar truth.
    """
    base = snap
    overlay = None
    if isinstance(snap, OptimisticSnapshot):
        overlay = snap
        base = snap.base
    if getattr(base, "_t", None) is None:
        return None
    from nomad_tpu_torch.models.fleet import (alloc_vec, fleet_cache,
                                              mirror_for)

    statics = fleet_cache.statics_for(base)
    mirror = mirror_for(statics)
    capacity = statics.capacity
    reserved = statics.reserved
    index_of = statics.index_of
    overlay_nodes = overlay._by_node if overlay is not None else {}

    # The net dicts are mutated in place by concurrent worker syncs;
    # hold the mirror for the whole composite read (the usage array is
    # copy-on-write, but alloc_rows/node_ports/net_rows are not).
    with mirror.lock:
        if not mirror.sync_net(base):
            return None  # snapshot older than the mirror: scalar truth
        usage = mirror.usage

        verdicts: dict = {}
        for nid in node_ids:
            placements = plan.node_allocation.get(nid)
            if not placements:
                verdicts[nid] = True  # evict-only plans always fit
                continue
            node = snap.node_by_id(nid)
            if node is None or node.status != NODE_STATUS_READY \
                    or node.drain:
                verdicts[nid] = False
                continue
            ni = index_of.get(nid, -1)
            if ni < 0 or overlay_nodes.get(nid):
                verdicts[nid] = None  # not in fleet / in-flight overlay
                continue

            # --- resource fit: mirror row + plan deltas (the 4 dims
            # Resources.superset checks) -----------------------------
            removed_ids = {a.id for a in plan.node_update.get(nid, ())}
            removed_ids.update(a.id for a in placements)  # in-place upd
            used = reserved[ni] + usage[ni]
            for a in placements:
                used = used + alloc_vec(a)
            for aid in removed_ids:
                row = mirror.alloc_rows.get(aid)
                if row is not None and row[0] == ni:
                    used = used - row[1]
            cap = capacity[ni]
            if not (used[0] <= cap[0] and used[1] <= cap[1]
                    and used[2] <= cap[2] and used[3] <= cap[3]):
                verdicts[nid] = False
                continue

            # --- port collisions + bandwidth (exact, incremental) ----
            verdicts[nid] = _verify_node_net(
                mirror, statics, node, ni, placements, removed_ids)
    return verdicts


def _verify_node_net(mirror, statics, node, ni: int, placements,
                     removed_ids) -> Optional[bool]:
    """Exact port/bandwidth verdict for one node from the mirror's
    incremental per-node state: True fit, False reject, None = topology
    needs the scalar NetworkIndex walk.  Caller holds the mirror lock."""
    from nomad_tpu_torch.models.fleet import _net_row, net_base_for

    base = net_base_for(statics, ni, node)
    if base is None:
        return None  # multi-network node: exact path
    frozen_used, bw_reserved, bw_avail, ip, device = base
    node_key = (ip, device)

    # Existing offers must all live on the node's (ip, device) for the
    # merged per-node counting to be sound; odd rows force the exact walk.
    keys = mirror.node_net_keys.get(ni)
    if keys and (len(keys) > 1 or next(iter(keys)) != node_key):
        return None
    # The node's own reserved networks must ride the same (ip, device)
    # too: the scalar walk accounts reserved ports per-ip and reserved
    # bandwidth per-device, so an off-network reservation (or one with
    # no device — whose bandwidth the scalar path books against a
    # zero-capacity device) needs the exact walk.
    if node.reserved is not None and node.reserved.networks:
        total_reserved_ports = 0
        for rn in node.reserved.networks:
            if rn.ip != ip or rn.device != device:
                return None
            total_reserved_ports += len(rn.reserved_ports)
        if total_reserved_ports > len(frozen_used):
            return False  # reserved ports self-collide: never fits

    removed_ports: dict = {}
    removed_mbits = 0
    for aid in removed_ids:
        nr = mirror.net_rows.get(aid)
        if nr is not None and nr[0] == ni:
            for p in nr[1]:
                removed_ports[p] = removed_ports.get(p, 0) + 1
            removed_mbits += nr[2]

    pc = mirror.node_ports.get(ni, {})
    # Collisions among the POST-removal live set (or between a live
    # alloc and the node's reserved ports) reject the plan the same way
    # the scalar walk's collide flag does: an eviction in this plan may
    # free the colliding port, so counts are checked net of removals.
    if mirror.node_dup.get(ni):
        for p, c in pc.items():
            if c - removed_ports.get(p, 0) > 1:
                return False
    if frozen_used and pc:
        it = (p for p in frozen_used if p in pc) \
            if len(frozen_used) <= len(pc) \
            else (p for p in pc if p in frozen_used)
        for p in it:
            if pc.get(p, 0) - removed_ports.get(p, 0) > 0:
                return False

    placed_mbits = 0
    staged: set = set()
    for a in placements:
        row = _net_row(a)
        if row is None:
            continue
        ports, mbits, key = row
        if key != node_key:
            return None  # offer off the node's network: exact path
        placed_mbits += mbits
        for p in ports:
            if p in staged:
                return False  # duplicate within the plan itself
            staged.add(p)
            live = pc.get(p, 0) - removed_ports.get(p, 0)
            if live > 0 or p in frozen_used:
                return False  # collides with a live alloc / reserved port

    bw = bw_reserved + mirror.node_bw.get(ni, 0) \
        - removed_mbits + placed_mbits
    if bw > bw_avail:
        return False  # bandwidth exceeded
    return True


def _evaluate_node_plan(snap, plan: Plan, node_id: str) -> bool:
    """Is the plan valid for one node? (plan_apply.go:238-284)."""
    placements = plan.node_allocation.get(node_id, [])
    if not placements:
        return True  # evict-only plans always fit

    node = snap.node_by_id(node_id)
    if node is None or node.status != NODE_STATUS_READY or node.drain:
        return False

    existing = filter_terminal_allocs(snap.allocs_by_node(node_id))
    remove = list(plan.node_update.get(node_id, ())) + list(placements)
    proposed = remove_allocs(existing, remove) + list(placements)

    fit, _dim, _util = allocs_fit(node, proposed)
    return fit


class _ComponentBatch:
    """One window's worth of component-walk tasks, consumed
    front-to-back by the executor's workers plus the coordinator."""

    __slots__ = ("tasks", "descs", "results", "next", "completed",
                 "error", "done")

    def __init__(self, tasks: list, descs: list) -> None:
        self.tasks = tasks
        self.descs = descs
        self.results = [None] * len(tasks)
        self.next = 0
        self.completed = 0
        self.error: Optional[Exception] = None
        self.done = threading.Event()


class ComponentExecutor:
    """Small worker pool verifying a window's claim-graph components
    concurrently (ops/plan_conflict.evaluate_window passes its
    deadline-ordered component tasks here).

    Tasks are consumed strictly front-to-back, so the deadline order
    the scheduler chose IS the start order; the coordinator (the
    applier thread) participates, so ``workers=0`` degrades to inline
    execution.  ``active()`` snapshots what every thread is verifying
    right now — the flight recorder's ``applier.window`` stall guard
    attaches it to incident dumps, so a wedged window names the slow
    component instead of just the window."""

    def __init__(self, workers: int = 2,
                 name: str = "plan-components") -> None:
        self.workers = max(0, int(workers))
        self.name = name
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._batch: Optional[_ComponentBatch] = None
        self._threads: list = []
        self._stopped = False
        self._active: dict = {}   # thread name -> (desc, started)
        self.batches = 0          # windows dispatched; guarded
        self.components_run = 0   # component walks executed; guarded

    def run_components(self, tasks: list, descs=None) -> list:
        """Run every task, concurrently when workers exist; returns
        results in task order.  The first task exception (components
        must not raise in normal operation) re-raises here, after every
        task has been consumed.

        Tasks are dispatched as ``workers + 1`` CONTIGUOUS chunks of
        the deadline-ordered list — one condition wake per worker per
        window, not per component (a saturated window is dozens of
        single-plan components, and per-task handoff cost more than the
        walks).  The coordinator takes the first chunk, so the
        nearest-deadline components start immediately on the applier
        thread even if every worker is cold."""
        descs = descs if descs is not None else [None] * len(tasks)
        inline = False
        chunks: list = []
        with self._cond:
            self.components_run += len(tasks)
            if self._stopped or self.workers == 0 or len(tasks) <= 2 \
                    or self._batch is not None:
                inline = True
            else:
                n_chunks = min(len(tasks), self.workers + 1)
                step = -(-len(tasks) // n_chunks)  # ceil division
                for lo in range(0, len(tasks), step):
                    sl = slice(lo, min(lo + step, len(tasks)))
                    chunks.append((sl, tasks[sl], descs[sl]))
                batch = _ComponentBatch(
                    [self._chunk_task(ts) for _sl, ts, _d in chunks],
                    [{"components": [d for d in ds if d]}
                     for _sl, _ts, ds in chunks])
                self._batch = batch
                self.batches += 1
                self._ensure_threads_locked()
                self._cond.notify_all()
        if inline:
            return [self._run_one(task, desc)
                    for task, desc in zip(tasks, descs)]
        self._drain(batch)
        batch.done.wait()
        with self._cond:
            self._batch = None
        if batch.error is not None:
            raise batch.error
        out: list = [None] * len(tasks)
        for (sl, _ts, _ds), chunk_results in zip(chunks, batch.results):
            out[sl] = chunk_results
        return out

    @staticmethod
    def _chunk_task(chunk_tasks: list):
        return lambda: [t() for t in chunk_tasks]

    def _run_one(self, task, desc):
        me = threading.current_thread().name
        with self._lock:
            self._active[me] = (desc, time.monotonic())
        try:
            return task()
        finally:
            with self._lock:
                self._active.pop(me, None)

    def _drain(self, batch: _ComponentBatch) -> None:
        while True:
            with self._cond:
                i = batch.next
                if i >= len(batch.tasks):
                    return
                batch.next = i + 1
            try:
                result = self._run_one(batch.tasks[i], batch.descs[i])
                batch.results[i] = result
            except Exception as e:
                if batch.error is None:
                    batch.error = e
            finally:
                with self._cond:
                    batch.completed += 1
                    if batch.completed == len(batch.tasks):
                        batch.done.set()

    def _ensure_threads_locked(self) -> None:
        while len(self._threads) < self.workers:
            t = threading.Thread(
                target=self._worker, daemon=True,
                name=f"{self.name}-{len(self._threads)}")
            self._threads.append(t)
            t.start()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._stopped and (
                        self._batch is None
                        or self._batch.next >= len(self._batch.tasks)):
                    self._cond.wait()
                if self._stopped:
                    return
                batch = self._batch
            self._drain(batch)

    def active(self) -> dict:
        """What every executor thread is verifying right now."""
        now = time.monotonic()
        with self._lock:
            return {"verifying": [
                dict(desc or {}, thread=name,
                     age_s=round(now - started, 3))
                for name, (desc, started) in self._active.items()]}

    def stats(self) -> dict:
        with self._lock:
            return {"workers": self.workers,
                    "batches": self.batches,
                    "components_run": self.components_run,
                    "active": len(self._active)}

    def stop(self, timeout: float = 2.0) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
            threads = list(self._threads)
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout)


class _Committer:
    """ONE long-lived FIFO thread executing the commit tail of each
    window — wire encode, raft dispatch, commit wait, future responds —
    in window order, off the applier thread.

    This deepens the reference's verify/apply overlap (plan_apply.go:
    68-85): the applier thread's serialized section shrinks to token
    fence + partitioned verify + overlay fold, while the encode, the
    raft apply and (with InmemRaft) the synchronous FSM decode +
    batched store upsert — the priciest per-plan stages of the whole
    pipeline — ride here.  FIFO preserves the dispatch order and the
    one-apply-in-flight discipline (each job awaits its commit before
    the next job starts); ``wait_depth_below`` is the applier's
    backpressure so the optimistic overlay stays bounded.  It also
    replaces the per-window respond thread (a waived deliberate leak
    in LINT_ALLOWLIST until this round): at partitioned commit rates —
    hundreds of windows per second — thread creation itself was a top
    pipeline cost."""

    def __init__(self, name: str = "plan-committer") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._inflight = 0   # queued + executing jobs
        self._stopped = False
        self._thread: Optional[threading.Thread] = None

    def submit(self, fn) -> None:
        with self._cond:
            if self._stopped:
                raise RuntimeError("committer stopped")
            self._queue.append(fn)
            self._inflight += 1
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name=self.name)
                self._thread.start()
            self._cond.notify_all()

    def drained(self) -> bool:
        """True when every submitted commit has fully resolved — the
        applier's signal that its optimistic overlay can be dropped
        for a fresh post-commit snapshot."""
        with self._lock:
            return self._inflight == 0

    def inflight(self) -> int:
        """Queued + executing commit jobs — the control plane's
        commit-pipeline occupancy gauge."""
        with self._lock:
            return self._inflight

    def wait_depth_below(self, n: int,
                         timeout: Optional[float] = None) -> None:
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._inflight >= n and not self._stopped:
                if end is not None:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        return
                    self._cond.wait(remaining)
                else:
                    # faultlint-ok(unbounded-wait): timeout=None branch
                    # kept for teardown; every request-path caller
                    # passes a budget (60s depth gate, 30s drain) and
                    # stop() flips _stopped under notify_all.
                    self._cond.wait()

    def wait_drained(self, timeout: Optional[float] = None) -> None:
        self.wait_depth_below(1, timeout)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    # faultlint-ok(unbounded-wait): idle committer
                    # parking — submit() and stop() both notify; the
                    # per-commit waits are the budgeted ones.
                    self._cond.wait()
                if not self._queue:
                    return  # stopped AND drained: futures never drop
                fn = self._queue.popleft()
            try:
                fn()
            except Exception:
                logger.exception("plan committer: commit job failed")
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def stop(self, timeout: float = 2.0) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
            _thread = self._thread
        if _thread is not None and \
                _thread is not threading.current_thread():
            _thread.join(timeout)


class PlanApplier:
    """Single leader thread draining the plan queue in group-commit
    windows.

    Each iteration pops every pending plan (up to ``max_window``,
    gathering briefly under saturation so windows drain full), fences
    the whole window's tokens in ONE broker call, verifies it with the
    partitioned cross-plan conflict pass
    (ops/plan_conflict.evaluate_window — claim-graph components
    verified concurrently on the ComponentExecutor, nearest-deadline
    component first, byte-exact eval order within each component), and
    commits ALL accepted portions as ONE raft apply carrying a
    multi-plan FSM message — amortizing the Raft/FSM/native overhead
    that made the serialized commit the contended storm's floor.
    Per-plan futures are responded with results identical to sequential
    application in eval order; the overlapped verify/apply
    snapshot-overlay semantics extend to batches (the next window
    verifies against the in-flight window's overlay).

    The JAX applier's ``sequential=True`` baseline (per-plan token
    fence, one flat verify walk, one apply in flight on this thread) is
    not ported: nothing in the port runs it.

    ``device`` is where the ``device`` verify policy
    (``ops/verify_policy.py``) launches the window-verify kernel K6;
    under ``auto`` and ``host`` the host engine verifies.  The default,
    ``None``, is the JAX package's applier without a mesh: the device
    policy reports its ``no-mesh`` fallback.  The server passes its
    device.

    Two threads, one card: K6 launches from this thread while the batch
    worker's thread launches K4 and scatters committed usage rows into
    the usage mirror's device copy (K5).  Every launch goes on the
    device's default stream in the order the host issues it, and K5
    never writes in place: it writes a fresh buffer that the mirror
    swaps in under its lock, and K6 takes its lease on the usage tensor
    under that same lock.  So a K6 launch reads the buffer it leased
    whole — the old one or the new one, never one a scatter is still
    writing — and a K5 launch issued after it is queued behind it on
    the stream.  K6's descriptor staging is thread-local
    (``parallel/devices.PinnedStaging``), so this thread's pinned
    buffer is its own."""

    # A verify+commit window past this wall is a wedged leader, not a
    # big window: trip the flight recorder (when one is installed).
    WINDOW_STALL_S = 30.0

    def __init__(self, plan_queue, eval_broker, raft, state_fn,
                 max_window: int = 64, component_workers: int = 2,
                 gather_s: float = 0.02,
                 deadline_horizon: float = 0.25,
                 device=None) -> None:
        self.plan_queue = plan_queue
        self.eval_broker = eval_broker
        self.raft = raft
        self.state_fn = state_fn  # () -> StateStore (the FSM's live store)
        self.max_window = max(1, max_window)
        # Window gather budget: when the previous drain left a backlog
        # (saturation), wait up to this long for the queue to refill a
        # full window before draining — group-commit pacing.  An idle
        # leader (no backlog) never pays it.
        self.gather_s = gather_s
        # Plans whose deadline falls inside this horizon are promoted
        # to the front of the drained window (plan_queue.drain_pending)
        # and their components verify first.
        self.deadline_horizon = deadline_horizon
        self.device = device
        self.components = ComponentExecutor(workers=component_workers)
        self._committer = _Committer()
        # Commit-pipeline depth bound: at most this many windows may be
        # queued/executing in the committer before the applier blocks —
        # bounds the optimistic overlay (and how far a verify can run
        # ahead of committed state).
        self.max_inflight_commits = 2
        self._thread: Optional[threading.Thread] = None
        # Group-commit observability (bench 5b/5f fields ride on these).
        self._stats_lock = threading.Lock()
        self.commits = 0            # raft applies dispatched
        self.plans_committed = 0    # plans carried by those applies
        self.conflict_fallbacks = 0  # window plans that needed the
        #                              exact per-plan walk (prefix
        #                              conflict with an earlier plan)
        self.expired_drops = 0      # plans whose propagated deadline
        #                             passed before verification — the
        #                             leader never burns a verify+commit
        #                             on a result nobody is waiting for
        self.components_verified = 0  # claim-graph components walked
        self.component_plans = 0      # plans those components carried
        self._speedup_sum = 0.0       # per-window cross-component
        self._speedup_n = 0           # concurrency (sum walls / wall)
        # The serialized commit section's wall cost (token fence
        # + window verify + overlay fold — everything the applier
        # thread itself must finish before the next window), and the
        # plans that rode it: serial_ms_per_plan is the direct measure
        # of "the commit point is no longer one ordered stream".
        self.serial_seconds = 0.0
        self.serial_plans = 0
        # Control-plane gauges: wall the applier spent blocked on a
        # full commit pipeline (the max_inflight_commits AIMD's grow
        # signal — sustained backpressure means more run-ahead would
        # overlap more), and raft DISPATCH failures (its cut signal).
        self.commit_backpressure_s = 0.0
        self.dispatch_failures = 0
        self.gather_wall_s = 0.0  # wall spent in the window gather
        # Device-verify engine (ops/verify_policy.py lever): windows
        # whose base fit and overlay fold ran as one K6 launch against
        # the resident capacity/reserved/usage, windows where a
        # device-policy verify fell back to the host engine (cold
        # lease, no device), and the counted explicit transfers those
        # launches cost — off the parallel/devices odometer, so "zero
        # implicit transfers" stays checkable per window.
        self.device_verify_dispatches = 0
        self.device_verify_fallbacks = 0
        self.device_verify_h2d = 0
        self.device_verify_d2h = 0
        self.device_verify_wall_s = 0.0
        # Set by a committer job whose raft DISPATCH failed (nothing
        # entered the log): the overlay folded that window's allocs
        # before hand-off, so the applier must serialize the pipeline
        # out and take a fresh snapshot before trusting it again.
        self._dispatch_failed = False
        # Recent drained window sizes, BOUNDED: a leader drains windows
        # for its whole tenure, so an unbounded list is a slow leak.
        self.windows = deque(maxlen=256)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="plan-applier")
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def shutdown(self, timeout: float = 2.0) -> None:
        """Terminal teardown: reap the component executor's workers and
        the committer (the applier thread itself exits when the queue
        is disabled)."""
        self.components.stop(timeout)
        self._committer.stop(timeout)
        self.join(timeout)

    def run(self) -> None:
        snap: Optional[OptimisticSnapshot] = None
        while True:
            t_deq = time.monotonic()
            pending = self.plan_queue.dequeue(0)
            deq_wait = time.monotonic() - t_deq
            if pending is None:
                return  # queue disabled: leadership lost
            gather_s = self.gather_s  # re-read: a live control knob
            if gather_s > 0.0 and deq_wait < 0.002 and \
                    (self.plan_queue.depth() > 0
                     or self.plan_queue.await_depth(1, 0.002) > 0):
                # Two-phase adaptive gather.  This dequeue returned
                # without blocking, so a stream MAY be in flight; if a
                # backlog remains behind the popped plan — or anything
                # arrives within a 2 ms probe — gather toward a full
                # window instead of burning a whole commit cycle
                # (snapshot, verify, raft entry, FSM decode, respond)
                # on a sliver.  A lone submitter in a submit->wait->
                # resubmit loop pays at most the 2 ms probe (its plan
                # is the one in flight, so nothing else can arrive),
                # and an idle leader (blocking dequeues) pays nothing.
                # The gather wall is booked: the control plane's gather
                # driver shrinks a horizon that burns wall without
                # buying occupancy (the JAX package's control/wiring.py).
                t_gather = time.monotonic()
                self.plan_queue.await_depth(self.max_window - 1,
                                            gather_s)
                with self._stats_lock:
                    self.gather_wall_s += time.monotonic() - t_gather
            window = [pending]
            window += self.plan_queue.drain_pending(
                self.max_window - 1, horizon=self.deadline_horizon)
            try:
                # Stall watchdog (obs/flight.py): a window that
                # overstays WINDOW_STALL_S trips an incident dump with
                # the applier's stack in it — the leader's serialized
                # commit point wedging is exactly the failure that is
                # undebuggable after the fact.  No-op when no flight
                # recorder is installed.
                # extra_fn: the incident dump names WHAT was being
                # verified when the window wedged — the executor's
                # per-component attribution, not just "the window".
                with flight_mod.guard("applier.window",
                                      self.WINDOW_STALL_S,
                                      extra_fn=self.components.active):
                    snap = self._apply_window(window, snap)
            except Exception as e:
                # Popped futures must ALWAYS be responded: an applier
                # dying with them in hand would park their workers
                # forever (workers probe queue liveness, and the queue
                # is still alive — only this thread died).  Members the
                # window already answered keep their result (done()
                # guard: a second respond racing a waiter's read could
                # hand back torn fields); the rest get the error, which
                # is truthful — _apply_window answers every committed
                # member itself before anything else can raise.
                # In-flight applies live in the committer pipeline:
                # drain it before dropping the overlay, or the fresh
                # snapshot could miss a commit and re-admit its
                # conflicts.
                logger.exception("plan applier: unexpected failure")
                for pend in window:
                    if not pend.done():
                        pend.respond(None, e)
                self._committer.wait_drained(timeout=30.0)
                snap = None

    def _fence_window(self, window) -> list:
        """The whole window's token fence in ONE broker call
        (``outstanding_many`` reads the token mirror behind its leaf
        lock): per-plan ``outstanding`` queued the applier behind the
        submitter herd's enqueue/dequeue/ack convoy once per plan, and
        under bench 5f's 256 submitters those waits were over half the
        applier's wall.

        Deadline drop first (overload control plane): a plan whose
        propagated deadline passed gets an ``ErrDeadlineExceeded``
        response without any verification — by then the submitter's
        wait has expired and the broker's nack timer has (or is about
        to) redeliver the eval, so a commit here would only race the
        retry toward double placement while burning the leader.  Then
        the token fence: the eval must be outstanding and the token
        must match (guards split-brain schedulers, plan_apply.go:53)."""
        from .overload import ErrDeadlineExceeded

        tokens = self.eval_broker.outstanding_many(
            [p.plan.eval_id for p in window])
        now = time.monotonic()
        pendings = []
        expired = 0
        for pending in window:
            plan = pending.plan
            if plan.deadline and now > plan.deadline:
                expired += 1
                pending.respond(None, ErrDeadlineExceeded(
                    f"plan for eval {plan.eval_id} expired in queue"))
                continue
            token = tokens.get(plan.eval_id)
            if token is None:
                pending.respond(None, RuntimeError(
                    "evaluation is not outstanding"))
                continue
            if plan.eval_token != token:
                pending.respond(None, RuntimeError(
                    "evaluation token does not match"))
                continue
            pendings.append(pending)
        if expired:
            with self._stats_lock:
                self.expired_drops += expired
        return pendings

    def _apply_window(self, window, snap):
        """Verify + group-commit one drained window; returns the
        optimistic overlay carried to the next iteration (the
        verify/apply overlap)."""
        from nomad_tpu_torch.ops.plan_conflict import evaluate_window

        # Serialized-section accounting: everything this method does
        # except waiting on the commit pipeline's depth bound (that
        # wait is the verify/apply overlap — by design not serialized
        # against this window's verify).  Wall clock deliberately: the
        # applier thread's wall between windows — GIL waits included —
        # is what actually bounds its commit cadence.  (Thread-CPU time
        # would be cleaner noise-wise, but CLOCK_THREAD_CPUTIME_ID ticks
        # at ~10 ms on this class of kernel, which zeroes sub-ms
        # sections.)
        t_mark = time.perf_counter()
        serial = 0.0
        n_window = len(window)

        def _book() -> None:
            with self._stats_lock:
                self.serial_seconds += \
                    serial + (time.perf_counter() - t_mark)
                self.serial_plans += n_window

        pendings = self._fence_window(window)
        if not pendings:
            _book()
            return snap
        tracer = trace_mod.tracer() if trace_mod.ENABLED else None
        if tracer is not None:
            # Queue-wait spans: enqueue (PlanFuture.trace_t0) -> window
            # pop, one per plan, parented to the plan's eval anchor.
            now = tracer.now()
            for pend in pendings:
                if pend.plan.trace and pend.trace_t0 is not None:
                    tracer.record("plan.queued", pend.trace_t0,
                                  now - pend.trace_t0,
                                  parent_ctx=pend.plan.trace,
                                  eval_id=pend.plan.eval_id)
        # Keep verifying against the optimistic overlay while commits
        # are in flight (the verify/apply overlap, plan_apply.go:68-85,
        # extended to whole windows and to the committer pipeline's
        # bounded queue of windows); once every commit resolved, take a
        # fresh snapshot.
        with self._stats_lock:
            dispatch_failed = self._dispatch_failed
        if dispatch_failed:
            # A hand-off's dispatch failed AFTER its allocs folded
            # into the overlay: those folds are phantoms (nothing
            # entered the log).  Serialize the pipeline out — other
            # in-flight windows' folds are real and must land before a
            # fresh snapshot can replace them — and clear the flag only
            # once DRAINED: windows already queued behind the failure
            # were verified against the phantoms, and their commit jobs
            # must still see the flag to refuse them.
            self._committer.wait_drained(timeout=60.0)
            with self._stats_lock:
                self._dispatch_failed = False
            snap = None
        elif snap is not None and self._committer.drained():
            snap = None
        if snap is None:
            snap = OptimisticSnapshot(self.state_fn().snapshot())

        t_verify = tracer.now() if tracer is not None else 0.0
        outcomes = evaluate_window(
            snap, [p.plan for p in pendings],
            executor=self.components, device=self.device)
        info = getattr(outcomes, "info", None)
        if tracer is not None:
            self._verify_spans(tracer, pendings, outcomes, info,
                               t_verify)
        committers = []  # (pending, result) with state to commit
        fallbacks = 0
        for pending, outcome in zip(pendings, outcomes):
            if outcome.fallback:
                fallbacks += 1
            if outcome.result.is_noop():
                pending.respond(outcome.result, None)
            else:
                committers.append((pending, outcome.result))
        with self._stats_lock:
            self.windows.append(len(pendings))
            self.conflict_fallbacks += fallbacks
            if info is not None:
                self.components_verified += info["components"]
                self.component_plans += len(pendings)
                self._speedup_sum += info["speedup"]
                self._speedup_n += 1
                dev = info.get("device")
                if dev is not None:
                    if dev.get("dispatched"):
                        self.device_verify_dispatches += 1
                        self.device_verify_h2d += dev.get("h2d", 0)
                        self.device_verify_d2h += dev.get("d2h", 0)
                        self.device_verify_wall_s += \
                            dev.get("wall", 0.0)
                    else:
                        self.device_verify_fallbacks += 1
        if not committers:
            _book()
            return snap

        from nomad_tpu_torch.ops.plan_conflict import _accepted_allocs

        alloc_lists = [_accepted_allocs(result)
                       for _pending, result in committers]

        # The commit tail — wire encode, raft dispatch, commit wait,
        # responds — rides the FIFO committer pipeline, off this
        # thread.  The accepted portions are ALREADY folded into
        # ``snap`` (evaluate_window mutates the caller-owned overlay in
        # eval order — its documented contract), so the next window's
        # verify sees them without any re-fold here.  Bound the
        # pipeline depth (backpressure excluded from the
        # serialized-section accounting: it IS the verify/apply
        # overlap), then hand off.
        t_bp = time.perf_counter()
        serial += t_bp - t_mark
        self._committer.wait_depth_below(self.max_inflight_commits,
                                         timeout=60.0)
        t_mark = time.perf_counter()
        with self._stats_lock:
            # Backpressure wall (the wait above): the controller's grow
            # signal for max_inflight_commits.
            self.commit_backpressure_s += t_mark - t_bp
        try:
            self._committer.submit(
                lambda: self._commit_job(committers, alloc_lists, tracer))
        except Exception:
            # Committer gone (teardown): commit inline — futures must
            # always resolve.
            self._commit_job(committers, alloc_lists, tracer)
        _book()
        return snap

    @staticmethod
    def _verify_spans(tracer, pendings, outcomes, info,
                      t_verify: float) -> None:
        """Span taxonomy: one applier.window span per member plan
        (shared t0/dur, tagged window size + component count), and under
        it one applier.verify span carrying the member's COMPONENT
        timing — so a trace shows both the group-commit amortization
        (shared window walls) and which component each eval's verify
        actually rode."""
        dur_verify = tracer.now() - t_verify
        # perf_counter epoch -> tracer epoch for component t0s.
        perf_off = time.perf_counter() - tracer.now()
        dev_span = info.get("device") if info is not None else None
        dev_recorded = False
        for pending, outcome in zip(pendings, outcomes):
            if not pending.plan.trace:
                continue
            wctx = tracer.record(
                "applier.window", t_verify, dur_verify,
                parent_ctx=pending.plan.trace,
                eval_id=pending.plan.eval_id,
                window=len(pendings),
                components=info["components"] if info else 1)
            if info is not None:
                k = outcome.component
                tracer.record(
                    "applier.verify",
                    info["comp_t0s"][k] - perf_off,
                    info["comp_walls"][k],
                    parent_ctx=wctx,
                    eval_id=pending.plan.eval_id,
                    component=k,
                    size=info["sizes"][info["order"][k]],
                    fallback=outcome.fallback)
            else:
                tracer.record(
                    "applier.verify", t_verify, dur_verify,
                    parent_ctx=wctx,
                    eval_id=pending.plan.eval_id,
                    component=0, fallback=outcome.fallback)
            if dev_span is not None and dev_span.get("dispatched") \
                    and not dev_recorded:
                # ONE per-window device-dispatch span, beside the
                # per-component applier.verify spans, anchored to the
                # first traced member's window span.
                dev_recorded = True
                tracer.record(
                    "applier.verify.device", t_verify,
                    dev_span.get("wall", 0.0), parent_ctx=wctx,
                    window=len(pendings),
                    pairs=dev_span.get("pairs", 0),
                    bucket=dev_span.get("bucket", 0),
                    h2d=dev_span.get("h2d", 0),
                    d2h=dev_span.get("d2h", 0))

    def _dispatch_window(self, committers, alloc_lists, tracer):
        """Encode one window's accepted portions and dispatch ONE raft
        apply; returns (the apply future, its tracer-epoch dispatch
        time), or (None, 0.0) after answering every member future with
        the dispatch error.

        ONE raft apply for the whole window, sub-plans in eval order
        (the FSM's batched upsert preserves last-writer-wins order, so
        final state is byte-identical to per-plan applies in eval
        order).  A single committer keeps the legacy single-plan wire
        format.  Columnar contract: slab-backed allocs ride the log as
        [slab, row, delta] references against one shared column record
        per slab (the job dict crosses the wire ONCE per slab, not once
        per alloc) — structs/alloc_slab.SlabWireEncoder; plain allocs
        keep the per-alloc dict encoding."""
        from nomad_tpu_torch.structs.alloc_slab import (
            encode_alloc_update,
            encode_plan_batch,
        )

        if len(committers) == 1:
            msg_type, payload = (codec.ALLOC_UPDATE_REQUEST,
                                 encode_alloc_update(alloc_lists[0]))
        else:
            msg_type, payload = (codec.PLAN_BATCH_APPLY_REQUEST,
                                 encode_plan_batch(alloc_lists))
        t_apply = 0.0
        if tracer is not None:
            # Ship each sub-plan's context INSIDE the log entry (the
            # `_trace` payload key, ignored by decode): the FSM decode
            # and the batched store upsert run on the raft thread with
            # no ambient context, and this is how their spans join each
            # eval's tree.
            env = [dict(pend.plan.trace, eval_id=pend.plan.eval_id)
                   if pend.plan.trace else None
                   for pend, _result in committers]
            if any(e is not None for e in env):
                payload["_trace"] = env
            t_apply = tracer.now()
        entry = codec.encode(msg_type, payload)
        try:
            future = self.raft.apply(entry)
        except Exception as e:
            # Flag BEFORE responding: a submitter that observes the
            # error and retries must find the next window already
            # committed to dropping this window's phantom overlay
            # folds (the applier folds before hand-off).
            with self._stats_lock:
                self._dispatch_failed = True
                self.dispatch_failures += 1
            for pending, _result in committers:
                pending.respond(None, e)
            return None, 0.0
        with self._stats_lock:
            self.commits += 1
            self.plans_committed += len(committers)
        return future, t_apply

    # Commit-wait poll slice: the raft-commit wait is re-armed in
    # bounded slices so the waiter can probe queue liveness between
    # them instead of parking forever on an orphaned future.
    COMMIT_WAIT_POLL = 5.0

    def _wait_commit(self, future):
        """Bounded raft-commit wait.  A commit can legitimately outlast
        any fixed budget, so the wait is supervised rather than capped:
        poll in COMMIT_WAIT_POLL slices and give up only when the plan
        queue has been disabled (leadership revoked or teardown) with
        the future still unresolved — raft_net responds its outstanding
        futures on step-down, so nothing will ever set that one."""
        while True:
            try:
                return future.wait(self.COMMIT_WAIT_POLL)
            except TimeoutError:
                if future.done():
                    raise     # the future RESPONDED with a timeout error
                if not self.plan_queue.enabled():
                    raise TimeoutError(
                        "plan queue disabled while awaiting raft commit")

    def _await_and_respond(self, future, committers, t_apply,
                           tracer) -> None:
        """The respond tail: wait out one window's commit and answer
        every member future.  From dispatch on, the entry is committed
        (or committing): failures here must not surface as plan errors
        beyond the commit wait itself — a worker retrying an
        already-applied plan would double-place."""
        try:
            index, _ = self._wait_commit(future)
        except Exception as e:
            for pend, _res in committers:
                pend.respond(None, e)
            return
        if tracer is not None:
            # raft.apply dispatch -> committed, one span per member
            # plan (shared t0/dur, like the verify spans).
            dur = tracer.now() - t_apply
            for pend, _res in committers:
                if pend.plan.trace:
                    tracer.record("raft.apply", t_apply, dur,
                                  parent_ctx=pend.plan.trace,
                                  eval_id=pend.plan.eval_id,
                                  window=len(committers), index=index)
        for pend, res in committers:
            res.alloc_index = index
            pend.respond(res, None)

    def _commit_job(self, committers, alloc_lists, tracer) -> None:
        """One committer-pipeline job: encode, dispatch, await, respond
        — the whole commit tail of one window, in FIFO window order.

        Poison check first: FIFO means every PRIOR window's dispatch
        outcome is known when this job runs, so if one failed, this
        window's verdicts were computed against overlay folds that
        never entered the log — committing them could durably
        over-commit (e.g. a placement that fit only because a phantom
        eviction freed the node).  Refuse with a retryable error
        instead; the applier drains the pipeline and re-verifies
        retries against a fresh snapshot (the ``_dispatch_failed``
        handling at the top of ``_apply_window``)."""
        with self._stats_lock:
            poisoned = self._dispatch_failed
        if poisoned:
            err = RuntimeError(
                "plan verified against a commit window whose dispatch "
                "failed; state refreshed — retry")
            for pend, _res in committers:
                pend.respond(None, err)
            return
        future, t_apply = self._dispatch_window(committers, alloc_lists,
                                                tracer)
        if future is None:
            return  # dispatch failed: futures answered, flag raised
        self._await_and_respond(future, committers, t_apply, tracer)

    def stats(self) -> dict:
        """Group-commit counters: commits, plans carried, mean window
        occupancy, conflict fallbacks, and the partitioned-verify
        fields (components walked, mean plans per component)."""
        with self._stats_lock:
            commits = self.commits
            plans = self.plans_committed
            windows = list(self.windows)
            fallbacks = self.conflict_fallbacks
            expired = self.expired_drops
            components = self.components_verified
            comp_plans = self.component_plans
            speedup_sum = self._speedup_sum
            speedup_n = self._speedup_n
            serial_s = self.serial_seconds
            serial_plans = self.serial_plans
            backpressure_s = self.commit_backpressure_s
            dispatch_failures = self.dispatch_failures
            gather_wall_s = self.gather_wall_s
            dev_dispatches = self.device_verify_dispatches
            dev_fallbacks = self.device_verify_fallbacks
            dev_h2d = self.device_verify_h2d
            dev_d2h = self.device_verify_d2h
            dev_wall_s = self.device_verify_wall_s
        return {
            "gather_wall_s": gather_wall_s,
            # The live knob positions (the control plane's actuators
            # move them; their gauges ride beside the counters so a
            # trajectory is readable straight off the registry).
            "max_window": self.max_window,
            "max_inflight_commits": self.max_inflight_commits,
            "gather_s": self.gather_s,
            "deadline_horizon": self.deadline_horizon,
            "commit_backpressure_s": backpressure_s,
            "dispatch_failures": dispatch_failures,
            "commit_inflight": self._committer.inflight(),
            "commits": commits,
            "plans_committed": plans,
            "batch_occupancy": plans / commits if commits else 0.0,
            "conflict_fallbacks": fallbacks,
            "expired_drops": expired,
            "components": components,
            "component_occupancy":
                comp_plans / components if components else 0.0,
            "cross_component_speedup":
                speedup_sum / speedup_n if speedup_n else 1.0,
            "serial_seconds": serial_s,
            "serial_ms_per_plan":
                serial_s / serial_plans * 1000.0 if serial_plans
                else 0.0,
            # Device-verify engine counters (NOMAD_TPU_VERIFY): K6
            # window launches, device-policy windows that fell back to
            # the host engine, and the per-window explicit-transfer
            # odometer deltas those launches cost (descriptor h2d + the
            # one fetched result buffer d2h; never a fleet tensor).
            "device_verify_dispatches": dev_dispatches,
            "device_verify_fallbacks": dev_fallbacks,
            "device_verify_h2d": dev_h2d,
            "device_verify_d2h": dev_d2h,
            "device_verify_wall_s": dev_wall_s,
            "windows": windows,
        }
