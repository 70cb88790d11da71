"""TTL wheel: one thread serving many TTL timers.

The heartbeat manager (and anything else armed per-entity) previously
spawned one ``threading.Timer`` — a whole thread — per node.  At the
fleet sizes the ROADMAP targets (10k-100k heartbeating agents) that is
a thread army; at any size it is a teardown hazard (stray timers firing
into a torn-down server).  The wheel replaces the army with ONE thread:

  - ``arm(key, ttl)`` / ``cancel(key)`` are O(log n) / O(1);
  - re-arming a key (every heartbeat) supersedes the previous deadline
    without touching the old heap entry (lazy invalidation by seq);
  - the service thread sleeps exactly until the earliest live deadline
    (condition-timed wait, woken early by any nearer arm), so expiry
    latency is bounded by scheduling jitter, not a coarse tick;
  - expiry callbacks run on the wheel thread and MUST be quick — the
    heartbeat manager only enqueues the node for paced reconciliation
    there, never does raft writes;
  - the heap is compacted when dead entries dominate, so a long
    leadership's worth of re-arms is not a slow leak.

Thread lifecycle is explicit (``start``/``stop`` with a joinable
handle) so the interprocedural thread-lifecycle lint passes without
waivers.
"""
from __future__ import annotations

import heapq
import logging
import threading
import time
from typing import Callable, Optional

from nomad_tpu_torch.utils.sync import Immutable

logger = logging.getLogger("nomad_tpu_torch.server.ttlwheel")

# Compact when the heap carries this many times more entries than are
# live (re-arms leave dead entries behind; bounded, then rebuilt).
_COMPACT_FACTOR = 4
_COMPACT_MIN = 256


class TTLWheel:
    """One service thread multiplexing many (key, deadline) timers."""

    def __init__(self, on_expire: Callable[[str], None],
                 name: str = "ttl-wheel",
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.on_expire = on_expire
        self.name = name
        self._clock: Immutable = clock  # ctor-set, never rebound
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._heap: list = []      # (deadline, seq, key); lazy-invalidated
        self._armed: dict = {}     # key -> (deadline, seq)
        self._seq = 0
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self.expired = 0           # callbacks delivered; guarded by _lock

    # -- arming ------------------------------------------------------------
    def arm(self, key: str, ttl: float) -> None:
        """(Re-)arm ``key`` to expire in ``ttl`` seconds.  Starts the
        service thread on first use."""
        deadline = self._clock() + max(ttl, 0.0)
        with self._cond:
            if self._stopped:
                raise RuntimeError("TTL wheel is stopped")
            self._seq += 1
            self._armed[key] = (deadline, self._seq)
            heapq.heappush(self._heap, (deadline, self._seq, key))
            if len(self._heap) > _COMPACT_MIN and \
                    len(self._heap) > _COMPACT_FACTOR * len(self._armed):
                self._compact_locked()
            self._ensure_thread_locked()
            self._cond.notify_all()

    def cancel(self, key: str) -> bool:
        """Disarm ``key``; True when it was armed.  The heap entry dies
        lazily."""
        with self._cond:
            return self._armed.pop(key, None) is not None

    def armed(self, key: str) -> bool:
        with self._lock:
            return key in self._armed

    def deadline(self, key: str) -> Optional[float]:
        with self._lock:
            entry = self._armed.get(key)
            return entry[0] if entry else None

    def active(self) -> int:
        with self._lock:
            return len(self._armed)

    def clear(self) -> None:
        """Disarm everything (leadership revoked); the thread stays for
        re-use — ``stop`` tears it down."""
        with self._cond:
            self._armed.clear()
            self._heap.clear()
            self._cond.notify_all()

    # -- lifecycle ---------------------------------------------------------
    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=self.name)
            self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        with self._cond:
            self._stopped = True
            self._armed.clear()
            self._heap.clear()
            self._cond.notify_all()
            _thread = self._thread
        if _thread is not None and \
                _thread is not threading.current_thread():
            _thread.join(timeout)

    # -- service thread ----------------------------------------------------
    def _compact_locked(self) -> None:
        live = {(dl, seq, key) for key, (dl, seq) in self._armed.items()}
        self._heap = sorted(live)

    def _pop_due_locked(self) -> list:
        """Every key whose live deadline has passed, removed from the
        table (caller fires callbacks outside the lock)."""
        now = self._clock()
        due: list = []
        while self._heap and self._heap[0][0] <= now:
            deadline, seq, key = heapq.heappop(self._heap)
            current = self._armed.get(key)
            if current is None or current[1] != seq:
                continue  # cancelled or re-armed since: dead entry
            del self._armed[key]
            due.append(key)
        return due

    def _next_wait_locked(self) -> Optional[float]:
        """Seconds until the earliest live deadline; None = idle."""
        while self._heap:
            deadline, seq, key = self._heap[0]
            current = self._armed.get(key)
            if current is None or current[1] != seq:
                heapq.heappop(self._heap)  # skim dead entries
                continue
            return max(deadline - self._clock(), 0.0)
        return None

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._stopped:
                    return
                due = self._pop_due_locked()
                if not due:
                    wait = self._next_wait_locked()
                    # Timed wait either way: a lost notify must not
                    # park the wheel forever (idle re-check at 1s).
                    self._cond.wait(1.0 if wait is None
                                    else min(wait, 1.0) or 0.0005)
                    continue
                self.expired += len(due)
            for key in due:
                try:
                    self.on_expire(key)
                except Exception:
                    # The wheel serves the WHOLE table; one entry's
                    # callback failure must not kill everyone's timers.
                    logger.exception("ttl expiry callback failed for %s",
                                     key)
