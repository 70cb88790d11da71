"""Overload control plane: admission, deadlines, and metastable damping.

A production scheduler's canonical death spiral is *metastable*: offered
load exceeds capacity -> queues grow -> the leader slows -> heartbeats
miss their TTLs -> nodes mass-expire -> every expiry floods the broker
with reschedule evaluations -> the overload deepens and the system stays
collapsed even after the original load subsides.  The reference
(Nomad v0.1.2) has no defense; this module engineers the spiral out.

Three cooperating mechanisms (README "Failure model" documents the
operator view):

**Admission control** (:class:`OverloadController`).  Queue depths are
pressure sources; pressure drives a three-state machine::

    normal --(pressure >= brownout_ratio)--> brownout
    brownout --(pressure >= overload_ratio)--> overload
    (exit thresholds sit below entry thresholds: hysteresis, so the
     state cannot flap at a threshold boundary)

Work is classed ``system > service > batch`` and shed lowest-class
first: brownout sheds batch, overload sheds batch+service; system work
(node liveness, eval acks, plan submission — the machinery that *digs
out* of overload) is never shed, and heartbeats bypass admission
entirely on a dedicated lane.  A shed request gets
:class:`ErrOverloaded` — an ``OSError`` subclass carrying the
``overloaded:`` marker, so in-proc callers retry it under
``utils/retry.DEFAULT_RETRYABLE`` and wire callers can classify the
RPC error string (``utils/retry.is_overloaded``) — with full-jitter
backoff, never a synchronized stampede.

**Deadline propagation**.  RPC envelopes carry the caller's remaining
budget (``_deadline``, relative seconds, stamped by ``ConnPool.call``
from the transport timeout ``RetryPolicy.attempt_timeout`` already
feeds each attempt).  The receiving server converts it once to an
absolute monotonic deadline (:func:`stamp_arrival`); downstream stages
— broker dequeue, ``Worker``, ``PlanApplier`` — drop work whose
deadline passed (``expired_drops`` in their stats) instead of burning
the leader computing responses nobody is waiting for.

**Damping primitives**.  :class:`TokenBucket` paces dead-node
reconciliation (a real mass expiry drains into the broker at a bounded
rate instead of as one storm); the heartbeat TTL wheel consults
``in_brownout()`` to defer expiry while the server itself is slow, so
the server's own slowness can never mass-expire its fleet.

Counterpart of ``nomad_tpu/server/overload.py``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from nomad_tpu_torch.obs import flight
from nomad_tpu_torch.utils.retry import OVERLOADED_MARKER

# -- states -----------------------------------------------------------------
NORMAL = "normal"
BROWNOUT = "brownout"
OVERLOAD = "overload"

# Priority classes, highest retention first: system work digs the
# server OUT of overload (liveness, acks, commits) and is never shed.
CLASS_SYSTEM = "system"
CLASS_SERVICE = "service"
CLASS_BATCH = "batch"
PRIORITY_CLASSES = (CLASS_SYSTEM, CLASS_SERVICE, CLASS_BATCH)

# RPC methods that bypass admission entirely: the liveness lane.  A
# heartbeat shed during overload *causes* the TTL-expiry storm that
# admission exists to prevent — it must always get through.  Networked
# raft's RPCs are the servers' own liveness: an AppendEntries or a vote
# queued behind a fleet's registrations or heartbeats past the election
# timeout deposes a healthy leader, and every request then waits on the
# election that follows.  (The JAX package's lane holds the heartbeat
# alone; raft's handlers take no admission in either package, so the
# difference is the dispatch queue's order.)
HEARTBEAT_LANE = frozenset({"Node.Heartbeat", "Raft.RequestVote",
                            "Raft.AppendEntries", "Raft.InstallSnapshot"})

# Deadline envelope keys.  ``_deadline`` is RELATIVE seconds remaining,
# stamped by the sender (monotonic clocks don't transfer between
# hosts); ``_abs_deadline`` is this server's local absolute monotonic
# deadline, stamped once at arrival.
DEADLINE_KEY = "_deadline"
ABS_DEADLINE_KEY = "_abs_deadline"


class ErrOverloaded(OSError):
    """Admission-control NACK: the server shed this request.

    Deliberately transport-shaped (``OSError``): retry policies already
    classify transports as retryable, and shedding is semantically a
    "try again later" — the request was never processed.  The
    ``overloaded:`` marker survives the RPC error-string round trip so
    wire clients can classify it too (``utils/retry.is_overloaded``).
    """

    def __init__(self, detail: str = "") -> None:
        super().__init__(f"{OVERLOADED_MARKER} server shed the request"
                         + (f" ({detail})" if detail else ""))


class ErrDeadlineExceeded(TimeoutError):
    """The work item's propagated deadline passed before it ran."""

    def __init__(self, detail: str = "") -> None:
        super().__init__("deadline exceeded before the server processed "
                         "the request" + (f" ({detail})" if detail else ""))


# -- deadline plumbing ------------------------------------------------------

def stamp_arrival(args: dict, clock: Callable[[], float] = time.monotonic
                  ) -> float:
    """Convert a relative wire deadline to this host's absolute
    monotonic deadline, once, at RPC arrival.  Returns the absolute
    deadline (0.0 = unbounded).  Idempotent: an already-stamped args
    dict (in-proc call chains) keeps its original arrival stamp."""
    abs_dl = args.get(ABS_DEADLINE_KEY)
    if abs_dl:
        return float(abs_dl)
    rel = args.pop(DEADLINE_KEY, None)
    if not rel:
        return 0.0
    abs_dl = clock() + float(rel)
    args[ABS_DEADLINE_KEY] = abs_dl
    return abs_dl


def absolute_deadline(args: dict) -> float:
    """The arrival-stamped absolute deadline (0.0 = unbounded)."""
    return float(args.get(ABS_DEADLINE_KEY) or 0.0)


def restamp_forward(args: dict,
                    clock: Callable[[], float] = time.monotonic) -> dict:
    """Prepare args for forwarding to another server: the local
    absolute deadline becomes a fresh RELATIVE budget (the remote's
    clock is unrelated), already-expired budgets clamp to a minimal
    positive value so the remote rejects them cheaply."""
    abs_dl = args.pop(ABS_DEADLINE_KEY, None)
    if abs_dl:
        args[DEADLINE_KEY] = max(float(abs_dl) - clock(), 0.001)
    return args


def remaining(deadline: float, default: float,
              clock: Callable[[], float] = time.monotonic) -> float:
    """Budget left until ``deadline`` (capped at ``default``);
    ``default`` when unbounded.  Never negative — expired deadlines
    return a minimal budget so waits fail fast instead of blocking."""
    if not deadline:
        return default
    return min(default, max(deadline - clock(), 0.001))


def expired(deadline: float,
            clock: Callable[[], float] = time.monotonic) -> bool:
    return bool(deadline) and clock() > deadline


# -- damping primitives -----------------------------------------------------

class TokenBucket:
    """Classic token bucket; thread-safe; injectable clock for tests.

    Used to pace dead-node reconciliation: each expiring node costs one
    token, so a mass expiry drains into the broker at ``rate``/s (burst
    ``burst``) instead of as one eval storm."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if rate <= 0 or burst <= 0:
            raise ValueError("token bucket rate/burst must be > 0")
        self.rate = rate
        self.burst = burst
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = burst
        self._last = clock()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def wait_time(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0.0 = now)."""
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                return 0.0
            return (n - self._tokens) / self.rate


# -- the controller ---------------------------------------------------------

class OverloadController:
    """Pressure-driven admission with priority shedding + hysteresis.

    ``sources`` are named callables returning ``(depth, limit)``; the
    controller's pressure is the max depth/limit ratio across sources.
    State transitions use distinct enter/exit thresholds so one eval
    enqueued or drained at the boundary cannot flap the plane between
    shedding and admitting (the flap itself is a metastable amplifier:
    synchronized client retries re-arrive in lockstep)."""

    def __init__(self, brownout_ratio: float = 0.75,
                 overload_ratio: float = 1.0,
                 hysteresis: float = 0.9,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if not 0.0 < brownout_ratio <= overload_ratio:
            raise ValueError("want 0 < brownout_ratio <= overload_ratio")
        self.brownout_ratio = brownout_ratio
        self.overload_ratio = overload_ratio
        self.hysteresis = min(max(hysteresis, 0.1), 1.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._sources: dict = {}      # name -> fn() -> (depth, limit)
        self._state = NORMAL
        self._forced: Optional[str] = None   # test/bench override
        self._shed: dict = {c: 0 for c in PRIORITY_CLASSES}
        self._admitted: dict = {c: 0 for c in PRIORITY_CLASSES}
        self._heartbeat_lane = 0
        self._transitions = 0
        self._trip_pending = False   # *->OVERLOAD edge awaiting a
        #   flight-recorder dump (fired outside the lock; guarded)

    # -- wiring ------------------------------------------------------------
    def add_source(self, name: str, fn: Callable) -> None:
        with self._lock:
            self._sources[name] = fn

    def ratios(self) -> tuple:
        """The live (brownout_ratio, overload_ratio) pair, read under
        the lock (the control plane's actuators write them there)."""
        with self._lock:
            return self.brownout_ratio, self.overload_ratio

    def set_ratios(self, brownout: Optional[float] = None,
                   overload: Optional[float] = None) -> tuple:
        """Adjust the entry thresholds LIVE (the feedback control
        plane's actuator seam).  The constructor's invariant
        ``0 < brownout_ratio <= overload_ratio`` is preserved by
        clamping the untouched side, and the exit-edge hysteresis
        scaling is untouched — the controller moves the thresholds,
        never the enter/exit asymmetry.  Returns the applied pair."""
        with self._lock:
            new_over = self.overload_ratio if overload is None \
                else float(overload)
            new_brown = self.brownout_ratio if brownout is None \
                else float(brownout)
            new_over = max(new_over, 1e-6)
            new_brown = min(max(new_brown, 1e-6), new_over)
            self.brownout_ratio = new_brown
            self.overload_ratio = new_over
            return new_brown, new_over

    def force_state(self, state: Optional[str]) -> None:
        """Pin the state (tests, operator brownout drills); ``None``
        returns control to the pressure loop."""
        if state is not None and state not in (NORMAL, BROWNOUT, OVERLOAD):
            raise ValueError(f"unknown overload state {state!r}")
        with self._lock:
            self._forced = state

    # -- pressure + state --------------------------------------------------
    def pressure(self) -> float:
        with self._lock:
            sources = list(self._sources.items())
        worst = 0.0
        for _name, fn in sources:
            try:
                depth, limit = fn()
            except Exception:
                continue  # a torn-down source must not wedge admission
            if limit and limit > 0:
                worst = max(worst, depth / limit)
        return worst

    def _refresh_locked(self, pressure: float) -> str:
        prev = self._state
        if self._forced is not None:
            self._state = self._forced
        else:
            # Entry thresholds going up, hysteresis-scaled exit
            # thresholds coming down: one enqueue/drain at a boundary
            # cannot flap the plane between shedding and admitting.
            overload_exit = self.overload_ratio * self.hysteresis
            brownout_exit = self.brownout_ratio * self.hysteresis
            if prev == OVERLOAD:
                if pressure >= overload_exit:
                    self._state = OVERLOAD
                elif pressure >= brownout_exit:
                    self._state = BROWNOUT
                else:
                    self._state = NORMAL
            elif prev == BROWNOUT:
                if pressure >= self.overload_ratio:
                    self._state = OVERLOAD
                elif pressure >= brownout_exit:
                    self._state = BROWNOUT
                else:
                    self._state = NORMAL
            else:
                if pressure >= self.overload_ratio:
                    self._state = OVERLOAD
                elif pressure >= self.brownout_ratio:
                    self._state = BROWNOUT
                else:
                    self._state = NORMAL
        if self._state != prev:
            self._transitions += 1
            if self._state == OVERLOAD and flight.INSTALLED:
                # Flight-recorder trigger: entering the shedding state
                # is exactly when the evidence (queue depths, span
                # ring, stacks) is worth freezing.  The dump itself
                # runs OUTSIDE this lock (file I/O) — see _maybe_trip.
                self._trip_pending = True
        return self._state

    def _maybe_trip(self) -> None:
        """Fire a pending overload-entry flight dump outside the lock.
        Gated on the module bool FIRST: with no recorder installed the
        flag can never be set, and state() sits on the hottest
        admission path — it must not pay a second lock acquire for a
        feature that is off (the breaker's trip-site discipline)."""
        if not flight.INSTALLED:
            return
        with self._lock:
            fire, self._trip_pending = self._trip_pending, False
        if fire:
            flight.trip("overload.enter", self.stats())

    def state(self) -> str:
        p = self.pressure()
        with self._lock:
            st = self._refresh_locked(p)
        self._maybe_trip()
        return st

    def in_brownout(self) -> bool:
        """True in brownout OR overload: the TTL wheel defers expiry in
        either (the server's own slowness must never expire its fleet)."""
        return self.state() != NORMAL

    def shed_classes(self) -> tuple:
        """The priority classes currently being shed."""
        state = self.state()
        if state == OVERLOAD:
            return (CLASS_BATCH, CLASS_SERVICE)
        if state == BROWNOUT:
            return (CLASS_BATCH,)
        return ()

    # -- admission ---------------------------------------------------------
    def admit(self, cls: str, what: str = "") -> None:
        """Admit or shed one unit of ``cls`` work; raises
        :class:`ErrOverloaded` on shed.  System class always admits."""
        if cls not in PRIORITY_CLASSES:
            cls = CLASS_SERVICE
        if cls != CLASS_SYSTEM and cls in self.shed_classes():
            with self._lock:
                self._shed[cls] += 1
            raise ErrOverloaded(what or cls)
        with self._lock:
            self._admitted[cls] += 1

    def admit_rpc(self, method: str, args: dict) -> None:
        """RPC-plane admission: heartbeats bypass on their lane; other
        methods are classed by :func:`classify_rpc`."""
        if method in HEARTBEAT_LANE:
            with self._lock:
                self._heartbeat_lane += 1
            return
        self.admit(classify_rpc(method, args), method)

    def admit_eval(self, ev) -> None:
        """Broker-enqueue admission, classed by scheduler type."""
        self.admit(classify_eval(ev), f"eval {ev.type}")

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        pressure = self.pressure()
        with self._lock:
            state = self._refresh_locked(pressure)
            out = {
                "state": state,
                "pressure": round(pressure, 4),
                "shed": dict(self._shed),
                "admitted": dict(self._admitted),
                "heartbeat_lane": self._heartbeat_lane,
                "transitions": self._transitions,
                # The live entry thresholds: control-plane actuators
                # move them (set_ratios), and the convergence benches
                # read the trajectory from here.
                "brownout_ratio": round(self.brownout_ratio, 4),
                "overload_ratio": round(self.overload_ratio, 4),
            }
        return out

    def shed_count(self) -> int:
        with self._lock:
            return sum(self._shed.values())


# -- classification ---------------------------------------------------------

def classify_eval(ev) -> str:
    """An evaluation's priority class from its scheduler type.  Core
    evals (GC and friends) are leader housekeeping — sheddable batch
    work under pressure, NOT system class: deferring GC is exactly the
    load-shedding a browning-out leader wants."""
    if ev.type == "system":
        return CLASS_SYSTEM
    if ev.type == "batch" or ev.type == "_core":
        return CLASS_BATCH
    return CLASS_SERVICE


def classify_rpc(method: str, args: dict) -> str:
    """An RPC's priority class.

    The scheduling machinery itself (node lifecycle, eval ack/nack,
    plan submission, status) is system class: shedding it would stall
    in-flight work and *amplify* the overload.  Job submissions take
    the class of the job they carry (batch sheds first); reads are
    service class (a browned-out server still answers them; overload
    sheds them to protect writes)."""
    service, _, name = method.partition(".")
    if service in ("Node", "Eval", "Plan", "Status"):
        return CLASS_SYSTEM
    if service == "Job":
        if name in ("Register", "Evaluate"):
            job = args.get("job")
            jtype = (job or {}).get("type") if isinstance(job, dict) \
                else None
            if jtype == "system":
                return CLASS_SYSTEM
            if jtype == "batch":
                return CLASS_BATCH
            return CLASS_SERVICE
        if name == "Deregister":
            # Tearing work DOWN frees capacity: never shed it below
            # system — it is part of digging out.
            return CLASS_SYSTEM
    return CLASS_SERVICE
