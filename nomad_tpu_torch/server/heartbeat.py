"""Leader-side node heartbeat TTLs.

Capability parity with reference nomad/heartbeat.go:13-148: each node
gets a TTL; heartbeats reset it; expiry forces the node's status to
``down``, which emits node-update evaluations so every affected job is
rescheduled.  The TTL is rate-scaled so heartbeats stay under a target
aggregate rate (50/s), with a floor, jitter, and a long failover TTL
re-armed for every node when leadership moves (a new leader can't know
when the last heartbeats happened).

Beyond the reference (the overload control plane, server/overload.py):

  - **One TTL-wheel thread** (server/ttlwheel.py) replaces the
    per-node ``threading.Timer`` army: O(log n) re-arm per heartbeat,
    one thread at any fleet size, and nothing left to fire into a
    torn-down server.
  - **Brownout deferral**: when the overload controller reports the
    server itself is in brownout, expiry is deferred (the node is
    re-armed at a defer TTL, counted in ``deferred_expiries``) — the
    server's own slowness can never mass-expire its fleet, which is the
    trigger of the metastable overload spiral.
  - **Paced reconciliation**: expired nodes drain through a token
    bucket before invalidation, so a REAL mass expiry (rack power-off)
    floods the broker with reschedule evals at a bounded rate instead
    of as one storm.  A heartbeat arriving while a node waits in the
    pacing queue rescues it — zero false expiries by construction.
  - **Seedable jitter**: TTL jitter draws from a per-manager RNG so
    seeded chaos runs replay bit-stable.

The ``timer_factory`` seam is kept for the heartbeat_test.go port:
when a factory is supplied, per-node factory timers (inert fakes in
tests) replace the wheel and expiry is immediate on fire — the fake
clock drives everything by hand.
"""
from __future__ import annotations

import logging
import random
import threading
from collections import deque
from typing import Callable, Optional

from nomad_tpu_torch import faultinject
from nomad_tpu_torch.structs import NODE_STATUS_DOWN
from nomad_tpu_torch.utils.sync import Immutable

from .overload import TokenBucket
from .ttlwheel import TTLWheel

logger = logging.getLogger("nomad_tpu_torch.server.heartbeat")

MIN_HEARTBEAT_TTL = 10.0
MAX_HEARTBEATS_PER_SECOND = 50.0
HEARTBEAT_GRACE = 10.0
FAILOVER_HEARTBEAT_TTL = 300.0

# Brownout deferral: an expiry observed while the server is browning
# out re-arms at this TTL instead of invalidating (see _on_ttl_expire).
BROWNOUT_DEFER_TTL = 5.0

# Dead-node reconciliation pacing: invalidations per second / burst.
RECONCILE_RATE = 32.0
RECONCILE_BURST = 8.0


class HeartbeatManager:
    def __init__(self, server,
                 min_ttl: float = MIN_HEARTBEAT_TTL,
                 max_rate: float = MAX_HEARTBEATS_PER_SECOND,
                 grace: float = HEARTBEAT_GRACE,
                 failover_ttl: float = FAILOVER_HEARTBEAT_TTL,
                 timer_factory: Optional[Callable] = None,
                 rng: Optional[random.Random] = None,
                 overload=None,
                 brownout_defer: float = BROWNOUT_DEFER_TTL,
                 reconcile_rate: float = RECONCILE_RATE,
                 reconcile_burst: float = RECONCILE_BURST) -> None:
        self.server = server
        self.min_ttl = min_ttl
        self.max_rate = max_rate
        self.grace = grace
        self.failover_ttl = failover_ttl
        self.overload = overload
        self.brownout_defer = brownout_defer
        # Seedable per-manager jitter: module-global random would make
        # seeded chaos runs replay differently per interleaving.
        self._rng = rng or random.Random()
        # Seam for fake clocks: tests pass a factory returning inert
        # timer objects (.start()/.cancel()) and fire expiries by hand
        # instead of waiting out real TTLs; the production path is the
        # wheel.  Ctor-set, never rebound (Immutable).
        self._timer_factory: Immutable = timer_factory
        self._lock = threading.Lock()
        self._timers: dict = {}  # factory seam only: node id -> timer
        # Never rebound after construction (Immutable); the wheel has
        # its own internal lock.
        self._wheel: Immutable = TTLWheel(self._on_ttl_expire,
                                          name="heartbeat-ttl-wheel")
        # Paced invalidation: expired nodes queue here; the reconciler
        # drains them through the token bucket.  _pending_set mirrors
        # the deque for O(1) membership (heartbeat rescue).
        self._bucket: Immutable = TokenBucket(reconcile_rate,
                                              reconcile_burst)
        self._pending: deque = deque()
        self._pending_set: set = set()
        self._pending_cond = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._reconciler: Optional[threading.Thread] = None
        # Counters (guarded by _lock).
        self.expiries = 0            # nodes actually invalidated
        self.deferred_expiries = 0   # brownout deferrals
        self.rescued = 0             # heartbeat arrived while pending

    # -- lifecycle ---------------------------------------------------------
    def initialize(self) -> None:
        """On leadership gain: re-arm every known node at the failover TTL
        (heartbeat.go:21-35)."""
        for node in self.server.fsm.state.nodes():
            if node.terminal_status():
                continue
            self._arm(node.id, self.failover_ttl)

    def clear(self) -> None:
        """Leadership revoked: disarm everything.  A follower must never
        invalidate nodes — including nodes already queued for paced
        invalidation."""
        with self._pending_cond:
            for timer in self._timers.values():
                timer.cancel()
            self._timers.clear()
            self._pending.clear()
            self._pending_set.clear()
        self._wheel.clear()

    def shutdown(self) -> None:
        """Server teardown: clear + stop both service threads, joined —
        no timer thread may fire into a torn-down server."""
        self.clear()
        self._stop.set()
        with self._pending_cond:
            self._pending_cond.notify_all()
        self._wheel.stop()
        with self._lock:
            _reconciler = self._reconciler
        if _reconciler is not None and \
                _reconciler is not threading.current_thread():
            _reconciler.join(2.0)

    def active(self) -> int:
        with self._lock:
            return self.active_locked()

    # -- heartbeats --------------------------------------------------------
    def reset_heartbeat_timer(self, node_id: str) -> float:
        """Reset a node's TTL; returns the TTL the client should wait
        (heartbeat.go:37-72)."""
        if faultinject.ACTIVE:
            # A dropped delivery = the heartbeat never reached the
            # leader: the TTL timer keeps running toward expiry and the
            # client sees a transport error on its call.
            faultinject.fire("heartbeat.deliver", node=node_id)
        with self._lock:
            n = max(self.active_locked(), 1)
            ttl = max(n / self.max_rate, self.min_ttl)
            ttl += self._rng.random() * ttl / 16  # seeded jitter
            # Rescue: a heartbeat proves the node alive — if it expired
            # into the pacing queue but wasn't invalidated yet, pull it
            # back out.  This is what makes paced reconciliation unable
            # to produce false expiries.
            if node_id in self._pending_set:
                self._pending_set.discard(node_id)
                try:
                    self._pending.remove(node_id)
                except ValueError:
                    pass
                self.rescued += 1
        self._arm(node_id, ttl + self.grace)
        return ttl

    def active_locked(self) -> int:
        """Armed-node count for TTL rate scaling; caller holds _lock.
        The factory table and the wheel are summed: only one is ever
        populated (factory seam vs production wheel), and rate-scaling
        tests seed either directly.  (The wheel has its own lock; lock
        order wheel-after-manager is consistent everywhere.)"""
        return len(self._timers) + self._wheel.active()

    def _arm(self, node_id: str, ttl: float) -> None:
        if self._timer_factory is None:
            self._wheel.arm(node_id, ttl)
            return
        with self._lock:
            old = self._timers.get(node_id)
            if old is not None:
                old.cancel()
            timer = self._timer_factory(ttl, self._invalidate, [node_id])
            self._timers[node_id] = timer
            timer.start()

    # -- expiry ------------------------------------------------------------
    def _on_ttl_expire(self, node_id: str) -> None:
        """Wheel callback (wheel thread — must stay quick, no raft).

        Brownout deferral first: while the server itself is slow, a
        missed TTL is at least as likely to be the SERVER's fault as
        the node's, and invalidating would convert server slowness into
        a reschedule storm.  Defer and let a (still flowing) heartbeat
        re-arm normally.  Otherwise queue for paced invalidation."""
        ctrl = self.overload
        if ctrl is not None:
            try:
                browned = ctrl.in_brownout()
            except Exception:
                browned = False
            if browned:
                with self._lock:
                    self.deferred_expiries += 1
                self._arm(node_id, self.brownout_defer)
                return
        with self._pending_cond:
            if node_id not in self._pending_set:
                self._pending_set.add(node_id)
                self._pending.append(node_id)
            self._ensure_reconciler_locked()
            self._pending_cond.notify_all()

    def _ensure_reconciler_locked(self) -> None:
        if self._reconciler is None or not self._reconciler.is_alive():
            self._reconciler = threading.Thread(
                target=self._reconcile_loop, daemon=True,
                name="heartbeat-reconciler")
            self._reconciler.start()

    def _reconcile_loop(self) -> None:
        """Drain the pending-expiry queue through the token bucket: a
        mass expiry becomes a bounded-rate trickle of invalidations
        (each spawns reschedule evals) instead of one broker storm."""
        while not self._stop.is_set():
            with self._pending_cond:
                while not self._pending and not self._stop.is_set():
                    self._pending_cond.wait(1.0)
                if self._stop.is_set():
                    return
                node_id = None
                if self._bucket.try_take():
                    node_id = self._pending.popleft()
                    self._pending_set.discard(node_id)
            if node_id is None:
                # Out of tokens: sleep outside the lock (heartbeat
                # rescues keep working meanwhile), bounded refill wait.
                self._stop.wait(min(max(self._bucket.wait_time(), 0.01),
                                    1.0))
                continue
            if self._wheel.armed(node_id):
                # A heartbeat re-armed the node between the pop above
                # and here: it is provably alive — rescue it on this
                # side of the pacing queue too.  (The residual window
                # past this check is the reference's own inherent
                # heartbeat-vs-invalidation race, microseconds wide.)
                with self._lock:
                    self.rescued += 1
                continue
            self._invalidate(node_id)

    def _leading(self) -> bool:
        """Only a leader may invalidate.  Guards the revoke race: a
        wheel callback in flight during clear() can re-queue a node
        after the pending table was emptied — the reconciler must not
        write node-down into a demoted server's log.  Servers without
        an is_leader seam (test stubs) are treated as leading."""
        is_leader = getattr(self.server, "is_leader", None)
        return is_leader() if callable(is_leader) else True

    def _invalidate(self, node_id: str) -> None:
        """TTL expired (or a test/operator forces it): mark the node
        down, spawning node-update evals (heartbeat.go:84-104).
        Unconditional apart from the leadership guard — rescue
        decisions happen in the reconciler, which owns the pacing
        queue."""
        if not self._leading():
            return
        with self._lock:
            self._timers.pop(node_id, None)
            self.expiries += 1
        logger.warning("heartbeat missed for node %s, marking down", node_id)
        try:
            self.server.node_update_status(node_id, NODE_STATUS_DOWN)
        except Exception:
            logger.exception("failed to invalidate heartbeat for %s",
                             node_id)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "armed": self.active_locked(),
                "pending_expiries": len(self._pending),
                "expiries": self.expiries,
                "deferred_expiries": self.deferred_expiries,
                "rescued": self.rescued,
            }
