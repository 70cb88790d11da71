"""Plan queue: leader-side priority queue of pending plans.

Capability parity with reference nomad/plan_queue.go:29-258: workers
submit plans and block on a future; the leader's single plan-applier
goroutine pops plans in priority order (priority desc, enqueue order asc)
and responds through the future.  This is the serialization point of the
optimistic-concurrency design.

Partitioned window verify: the queue is deadline-aware.  A
plan's propagated deadline (server/overload.py: the worker's nack-window
stamp) is indexed in a second heap at enqueue, and ``drain_pending``
PROMOTES near-deadline plans into the window ahead of the plain priority
order — a low-priority plan one gather away from expiry would otherwise
sit behind an endless high-priority stream until ``PlanApplier._fence``
answers it with ErrDeadlineExceeded.  The window the applier drains is
therefore (near-deadline plans by deadline asc) + (the rest by priority
desc, enqueue asc), and that SAME ordering is the component scheduler's
eval order downstream.  ``await_depth`` is the applier's window-gather
wait: block until the queue holds a full window (or the gather budget
expires) instead of committing a near-empty window under saturation.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import Optional

from nomad_tpu_torch.obs import trace as trace_mod
from nomad_tpu_torch.structs import Plan, PlanResult

from .overload import ErrOverloaded


class PlanFuture:
    """Result slot a submitting worker blocks on."""

    def __init__(self, plan: Plan) -> None:
        self.plan = plan
        self._event = threading.Event()
        self._result: Optional[PlanResult] = None
        self._error: Optional[Exception] = None
        # obs/trace.py: tracer-epoch enqueue time; the applier times
        # the plan.queued span (enqueue -> window pop) from it.
        self.trace_t0: Optional[float] = None
        # True once popped from EITHER heap (priority or deadline);
        # the other heap's entry dies lazily.  Guarded by the queue
        # lock — only pop paths read or write it.
        self._taken = False

    def respond(self, result: Optional[PlanResult],
                error: Optional[Exception] = None) -> None:
        self._result = result
        self._error = error
        self._event.set()

    def done(self) -> bool:
        """True once responded — lets pollers distinguish their own
        wait timeout from a RESPONDED error that happens to be a
        TimeoutError (worker._wait_plan would otherwise spin on it)."""
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> PlanResult:
        if not self._event.wait(timeout):
            raise TimeoutError("timed out waiting for plan result")
        if self._error is not None:
            raise self._error
        return self._result


class PlanQueue:
    def __init__(self, max_depth: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._enabled = False
        self._heap: list = []       # (-priority, seq, future)
        self._dheap: list = []      # (deadline, seq, future); lazy entries
        self._n = 0                 # live (untaken) pending plans
        self._count = itertools.count()
        # Overload control plane: a bounded queue sheds instead of
        # letting the serialized commit point grow an unbounded backlog
        # (the applier drains windows, so a standing backlog means the
        # leader is past saturation — more queue only adds latency).
        self.max_depth = max_depth
        self._depth_sheds = 0
        self._promotions = 0        # near-deadline plans pulled forward
        self._enqueues = 0          # plans accepted (control-plane rate
        #   gauge beside the broker's ack counter)

    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
        if not enabled:
            self.flush()

    def depth(self) -> int:
        """Pending plans — the admission controller's pressure source."""
        with self._lock:
            return self._n

    def enqueue(self, plan: Plan) -> PlanFuture:
        with self._lock:
            if not self._enabled:
                raise RuntimeError("plan queue is disabled")
            if self.max_depth is not None and self._n >= self.max_depth:
                self._depth_sheds += 1
                raise ErrOverloaded(
                    f"plan queue at depth bound {self.max_depth}")
            future = PlanFuture(plan)
            tracer = trace_mod.tracer() if trace_mod.ENABLED else None
            if tracer is not None and plan.trace:
                future.trace_t0 = tracer.now()
            seq = next(self._count)
            heapq.heappush(self._heap, (-plan.priority, seq, future))
            if plan.deadline:
                heapq.heappush(self._dheap,
                               (plan.deadline, seq, future))
            self._n += 1
            self._enqueues += 1
            self._cond.notify_all()
            return future

    def dequeue(self, timeout: Optional[float] = None
                ) -> Optional[PlanFuture]:
        """Block until a pending plan is available (the plan applier loop)."""
        import time as _time
        end = None if timeout in (None, 0) else _time.monotonic() + timeout
        with self._lock:
            while True:
                if not self._enabled:
                    return None
                future = self._pop_priority_locked()
                if future is not None:
                    return future
                if end is not None:
                    remaining = end - _time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)
                else:
                    self._cond.wait()

    def await_depth(self, n: int, timeout: float) -> int:
        """Window gather: block until ``n`` plans are pending, the
        queue is disabled, or ``timeout`` elapses; returns the depth
        seen last.  The applier calls this only when the previous drain
        left a backlog (saturation), so an idle leader never trades
        submit latency for window occupancy."""
        import time as _time
        end = _time.monotonic() + timeout
        with self._lock:
            while self._enabled and self._n < n:
                remaining = end - _time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            return self._n

    def _pop_priority_locked(self) -> Optional[PlanFuture]:
        while self._heap:
            _p, _seq, future = heapq.heappop(self._heap)
            if future._taken:
                continue  # promoted out of the deadline heap already
            future._taken = True
            self._n -= 1
            return future
        return None

    def _pop_due_locked(self, horizon_end: float) -> Optional[PlanFuture]:
        while self._dheap and self._dheap[0][0] <= horizon_end:
            _d, _seq, future = heapq.heappop(self._dheap)
            if future._taken:
                continue  # already popped via the priority heap
            future._taken = True
            self._n -= 1
            return future
        return None

    def drain_pending(self, max_n: int,
                      horizon: Optional[float] = None) -> list:
        """Pop up to ``max_n`` already-queued plans WITHOUT blocking —
        the group-commit applier's window gather: after ``dequeue``
        returns the window's first plan, everything else that piled up
        behind the serialized commit drains with it.

        With a ``horizon`` (seconds), plans whose propagated deadline
        falls within ``now + horizon`` are PROMOTED to the front of the
        drained window in deadline order; the remainder follows in
        priority order.  The applier's component scheduler inherits
        this ordering, so a near-deadline plan's component verifies
        first and ``expired_drops`` stays 0 under saturation."""
        import time as _time
        out: list = []
        if max_n <= 0:
            return out
        with self._lock:
            if horizon is not None and self._dheap:
                horizon_end = _time.monotonic() + horizon
                while len(out) < max_n:
                    future = self._pop_due_locked(horizon_end)
                    if future is None:
                        break
                    out.append(future)
                self._promotions += len(out)
            while len(out) < max_n:
                future = self._pop_priority_locked()
                if future is None:
                    break
                out.append(future)
            if len(self._dheap) > 4 * self._n + 64:
                # Lazy deadline entries for already-popped plans decay
                # here, bounding the heap by the live queue.
                self._dheap = [e for e in self._dheap
                               if not e[2]._taken]
                heapq.heapify(self._dheap)
        return out

    def flush(self) -> None:
        with self._lock:
            for _, _, future in self._heap:
                if not future._taken:
                    future.respond(None,
                                   RuntimeError("plan queue flushed"))
            self._heap.clear()
            self._dheap.clear()
            self._n = 0
            self._cond.notify_all()

    def stats(self) -> dict:
        with self._lock:
            return {"depth": self._n,
                    "depth_sheds": self._depth_sheds,
                    "deadline_promotions": self._promotions,
                    "enqueues": self._enqueues,
                    "max_depth": self.max_depth or 0}
