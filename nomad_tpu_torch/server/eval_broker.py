"""Evaluation broker: leader-side priority queue with at-least-once delivery.

Capability parity with reference nomad/eval_broker.go:31-604:
  - per-scheduler-type ready heaps, highest priority first (FIFO by create
    index within a priority);
  - per-JobID serialization: one in-flight eval per job, later ones blocked
    until Ack promotes the next;
  - Wait-delayed evals armed on timers;
  - explicit Ack/Nack with per-delivery tokens and Nack timers;
  - delivery limit: past it the eval is routed to the ``_failed`` queue for
    the leader's reaper.

Device extension: ``dequeue_batch`` drains up to ``max_batch`` ready
evals in one call (still one per job) so the device worker can fuse them
into a single kernel launch (nomad_tpu_torch/scheduler/batch.py).  The
reference dequeues one eval per worker goroutine; batching is what turns
the device's throughput into scheduler throughput.

Overload control plane (server/overload.py):

  - **Bounded, priority-aware admission**: ``enqueue`` consults the
    admission controller (system > service > batch shedding) and a hard
    depth bound, raising ``ErrOverloaded`` — a retryable NACK — instead
    of queueing without limit.  ``force=True`` bypasses both for evals
    already committed to replicated state (the FSM apply path and the
    leadership-restore scan must NEVER diverge broker from state).
  - **Deadline drops**: an enqueue may carry an absolute monotonic
    deadline; a deadline-expired eval found at dequeue time is never
    delivered to a worker — it routes to the ``_failed`` queue (the
    reaper marks it failed, a terminal state) and counts in
    ``stats()["expired_drops"]``.
  - **Timer lifecycle**: nothing is armed while the broker is disabled,
    nack timers fire through a tolerant wrapper, and ``flush`` cancels
    every timer — no stray timer can fire into a torn-down server.

Commit-pipeline scaling (the partitioned window verify):

  - **Nack timers ride ONE TTL wheel** (server/ttlwheel.py) instead of a
    ``threading.Timer`` thread per delivery: a saturated leader dequeues
    hundreds of evals per second, and the per-dequeue thread create +
    cancel was the single most expensive step of the whole commit
    pipeline (~0.5 ms of a 0.9 ms/plan budget).  The wheel key is the
    eval id; a redelivery re-arms the key, so a stale deadline can
    never fire with a stale token.
  - **Targeted dequeue wakeups**: a blocked ``dequeue`` parks on its own
    event keyed by its scheduler set, and an enqueue wakes exactly ONE
    matching waiter — under a 256-worker storm the old
    ``Condition.notify_all`` woke every parked worker per enqueue, and
    the thundering herd's wake/lock/scan/re-park cycles dominated
    process CPU.
  - **Token fence off the big lock**: delivery tokens are mirrored into
    a dict behind a dedicated leaf lock, so the plan applier's
    window-batched token fence (``outstanding_many``) never queues
    behind the enqueue/dequeue/ack convoy.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Optional

from nomad_tpu_torch import faultinject
from nomad_tpu_torch.obs import trace as trace_mod
from nomad_tpu_torch.structs import Evaluation, generate_uuid

from .overload import ErrOverloaded

FAILED_QUEUE = "_failed"


class _PendingHeap:
    """Priority heap: priority desc, create index asc (eval_broker.go:570)."""

    def __init__(self) -> None:
        self._heap: list = []
        self._count = itertools.count()

    def push(self, ev: Evaluation) -> None:
        heapq.heappush(self._heap,
                       (-ev.priority, ev.create_index, next(self._count), ev))

    def pop(self) -> Optional[Evaluation]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[3]

    def peek(self) -> Optional[Evaluation]:
        if not self._heap:
            return None
        return self._heap[0][3]

    def __len__(self) -> int:
        return len(self._heap)


class _Unack:
    __slots__ = ("eval", "token")

    def __init__(self, ev: Evaluation, token: str) -> None:
        self.eval = ev
        self.token = token


class _Waiter:
    """One parked ``dequeue`` call: its scheduler set and a private
    event an enqueue targets — exactly one waiter wakes per enqueue."""

    __slots__ = ("scheds", "event")

    def __init__(self, scheds: frozenset) -> None:
        self.scheds = scheds
        self.event = threading.Event()


class EvalBroker:
    def __init__(self, nack_timeout: float = 60.0,
                 delivery_limit: int = 3,
                 admission=None,
                 max_depth: Optional[int] = None) -> None:
        if nack_timeout < 0:
            raise ValueError("timeout cannot be negative")
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit
        self.admission = admission   # OverloadController (or None)
        self.max_depth = max_depth   # hard enqueue bound (None = unbounded)
        self._lock = threading.Lock()
        self._enabled = False
        self._evals: dict = {}       # eval id -> delivery attempts
        self._job_evals: dict = {}   # job id -> in-flight eval id
        self._blocked: dict = {}     # job id -> _PendingHeap
        self._ready: dict = {}       # scheduler type -> _PendingHeap
        self._unack: dict = {}       # eval id -> _Unack
        self._waiters: dict = {}     # seq -> _Waiter (insertion-ordered)
        self._waiter_seq = itertools.count()
        self._time_wait: dict = {}   # eval id -> threading.Timer
        self._deadlines: dict = {}   # eval id -> absolute monotonic deadline
        self._expired_drops = 0      # deadline-expired evals never delivered
        self._depth_sheds = 0        # enqueues refused by the hard bound
        self._acks = 0               # deliveries acked (the control
        #   plane's throughput gauge: depth / ack rate estimates queue
        #   residence, the portable congestion signal)
        self._trace_enq: dict = {}   # eval id -> tracer-epoch ready time
        #   (obs/trace.py: the broker.wait span's t0; stamped per
        #    _enqueue_locked so nack redeliveries re-time their wait)
        # Delivery-token mirror behind a LEAF lock: the applier's
        # window fence reads here instead of queueing on the big lock.
        # Order is big -> leaf everywhere; nothing acquires the big
        # lock while holding the leaf.
        self._token_lock = threading.Lock()
        self._tokens: dict = {}      # eval id -> outstanding token
        # One wheel thread multiplexes every nack deadline (keyed by
        # eval id; redelivery re-arms, ack/nack/flush disarm).
        from .ttlwheel import TTLWheel
        self._nack_wheel = TTLWheel(self._nack_expired,
                                    name="broker-nack-wheel")

    # -- lifecycle --------------------------------------------------------
    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
        if not enabled:
            self.flush()

    def flush(self) -> None:
        with self._lock:
            self._nack_wheel.clear()
            for timer in self._time_wait.values():
                timer.cancel()
            self._evals.clear()
            self._job_evals.clear()
            self._blocked.clear()
            self._ready.clear()
            self._unack.clear()
            self._time_wait.clear()
            self._deadlines.clear()
            self._trace_enq.clear()
            waiters, self._waiters = self._waiters, {}
            # Token mirror cleared INSIDE the big-lock section (the
            # big->leaf order permits it): clearing it after release
            # opened a window where the applier's token fence could
            # still validate a delivery this flush just revoked.
            with self._token_lock:
                self._tokens.clear()
        for waiter in waiters.values():
            waiter.event.set()  # re-scan: disabled brokers raise

    def shutdown(self) -> None:
        """Terminal teardown: flush and reap the nack wheel's service
        thread.  A shut-down broker cannot be re-enabled."""
        self.set_enabled(False)
        self._nack_wheel.stop()

    # -- enqueue ----------------------------------------------------------
    def depth(self) -> int:
        """Total evals the broker is tracking (ready + blocked + waiting
        + unacked) — the admission controller's pressure source."""
        with self._lock:
            return len(self._evals)

    def enqueue(self, ev: Evaluation, deadline: Optional[float] = None,
                force: bool = False) -> None:
        """Queue an eval for delivery.

        ``deadline`` (absolute monotonic) bounds USEFULNESS, not
        queueing: a deadline-expired eval is dropped at dequeue time
        (``expired_drops``) and routed to the failed queue instead of
        being delivered to a worker.  ``force`` bypasses admission and
        the depth bound — mandatory for evals already committed to
        replicated state (FSM apply, leadership restore), where a shed
        would silently diverge the broker from state."""
        if faultinject.ACTIVE:
            faultinject.fire("broker.enqueue", method=ev.type,
                             node=ev.node_id or None)
        if not force and self.admission is not None:
            # Controller consultation OUTSIDE the broker lock (it reads
            # other queues' depths, each behind its own lock).
            self.admission.admit_eval(ev)  # may raise ErrOverloaded
        with self._lock:
            if ev.id in self._evals:
                return
            if not self._enabled:
                # A disabled broker accepts nothing — and must not arm
                # wait timers that would fire into a torn-down server.
                return
            # Depth bound checked in the SAME critical section as the
            # insert: concurrent enqueues cannot overshoot it.  The
            # bound is re-read per enqueue — it is a LIVE control-plane
            # knob (the JAX package's control/wiring.py moves it through
            # a railed actuator).
            limit = self.max_depth
            if not force and limit is not None and \
                    len(self._evals) >= limit:
                self._depth_sheds += 1
                shed = True
            else:
                shed = False
                self._evals[ev.id] = 0
                if deadline:
                    self._deadlines[ev.id] = deadline
                if ev.wait > 0:
                    timer = threading.Timer(ev.wait,
                                            self._enqueue_waiting, [ev])
                    timer.daemon = True
                    self._time_wait[ev.id] = timer
                    timer.start()
                else:
                    self._enqueue_locked(ev, ev.type)
        if shed:
            raise ErrOverloaded(f"eval broker at depth bound {limit}")

    def _enqueue_waiting(self, ev: Evaluation) -> None:
        with self._lock:
            self._time_wait.pop(ev.id, None)
            self._enqueue_locked(ev, ev.type)

    def _enqueue_locked(self, ev: Evaluation, queue: str) -> None:
        if not self._enabled:
            return
        tracer = trace_mod.tracer() if trace_mod.ENABLED else None
        if tracer is not None and ev.trace:
            # broker.wait t0: (re-)stamped per (re-)enqueue so a nack
            # redelivery's wait span times ITS wait, not the first's.
            self._trace_enq[ev.id] = tracer.now()
        pending = self._job_evals.get(ev.job_id)
        if pending is None:
            self._job_evals[ev.job_id] = ev.id
        elif pending != ev.id:
            self._blocked.setdefault(ev.job_id, _PendingHeap()).push(ev)
            return
        self._ready.setdefault(queue, _PendingHeap()).push(ev)
        # Wake exactly ONE waiter whose scheduler set covers this queue
        # (removed from the registry: a woken waiter that loses the
        # re-scan race re-registers itself).  One ready eval can only
        # satisfy one dequeue, so waking everyone — the old
        # notify_all — only bought a thundering herd of wake/lock/
        # scan/re-park cycles per enqueue under a saturated leader.
        for seq, waiter in self._waiters.items():
            if queue in waiter.scheds:
                del self._waiters[seq]
                waiter.event.set()
                break

    # -- dequeue ----------------------------------------------------------
    def dequeue(self, schedulers: list,
                timeout: Optional[float] = None
                ) -> tuple[Optional[Evaluation], str]:
        """Blocking dequeue of the highest-priority ready eval.  A timeout
        of None or 0 blocks indefinitely (0 matches the reference's
        "no timer" behavior, worker.go dequeues with timeout 0)."""
        import time as _time
        end = None if timeout in (None, 0) else _time.monotonic() + timeout
        scheds = frozenset(schedulers)
        seq = None
        waiter = None
        try:
            while True:
                remaining = None
                with self._lock:
                    if seq is not None:
                        self._waiters.pop(seq, None)
                        seq = None
                    if not self._enabled:
                        raise RuntimeError("eval broker disabled")
                    ev, token = self._scan_locked(schedulers)
                    if ev is not None:
                        return ev, token
                    # Timeout decided UNDER the lock, before
                    # registering: a waiter that registered and then
                    # returned on its deadline could consume an
                    # enqueue's single targeted wakeup without
                    # scanning, stranding a ready eval while other
                    # matching waiters stay parked.
                    if end is not None:
                        remaining = end - _time.monotonic()
                        if remaining <= 0:
                            return None, ""
                    # Park OUTSIDE the lock on a private event an
                    # enqueue targets; registered before release, so a
                    # racing enqueue always sees this waiter.
                    waiter = _Waiter(scheds)
                    seq = next(self._waiter_seq)
                    self._waiters[seq] = waiter
                waiter.event.wait(remaining)
        finally:
            if seq is not None:
                with self._lock:
                    self._waiters.pop(seq, None)

    def dequeue_batch(self, schedulers: list, max_batch: int,
                      timeout: Optional[float] = None) -> list:
        """Drain up to max_batch ready evals (one per job) in one call;
        blocks for the first one like ``dequeue``.  Returns
        [(eval, token), ...]."""
        first = self.dequeue(schedulers, timeout)
        if first[0] is None:
            return []
        out = [first]
        with self._lock:
            while len(out) < max_batch:
                ev, token = self._scan_locked(schedulers)
                if ev is None:
                    break
                out.append((ev, token))
        return out

    def _scan_locked(self, schedulers: list
                     ) -> tuple[Optional[Evaluation], str]:
        while True:
            best_sched = None
            best_priority = None
            for sched in schedulers:
                heapq_ = self._ready.get(sched)
                if not heapq_:
                    continue
                ready = heapq_.peek()
                if ready is None:
                    continue
                if best_priority is None or ready.priority > best_priority:
                    best_sched, best_priority = sched, ready.priority
            if best_sched is None:
                return None, ""
            ev = self._ready[best_sched].pop()
            # Deadline drop: nobody is waiting for this eval's outcome
            # anymore — never burn a worker on it.  One-shot (the
            # deadline entry is consumed) so the failed-queue reaper
            # can still dequeue it to mark it terminal.
            deadline = self._deadlines.pop(ev.id, None)
            if deadline is not None and time.monotonic() > deadline and \
                    best_sched != FAILED_QUEUE:
                self._expired_drops += 1
                # Route to the failed queue exactly like the
                # delivery-limit path: the eval keeps its job's
                # in-flight slot until the reaper acks it, so a blocked
                # sibling can never double-deliver for the job.
                self._enqueue_locked(ev, FAILED_QUEUE)
                continue  # rescan: later evals may still be live
            token = generate_uuid()
            # Nack deadline on the shared wheel, keyed by eval id: a
            # redelivery re-arms the key, so no stale deadline can fire
            # with a stale token (the wheel's callback reads the token
            # CURRENT at expiry).  No thread is created per delivery —
            # the per-dequeue threading.Timer this replaces cost more
            # than the rest of the commit pipeline combined.
            self._nack_wheel.arm(ev.id, self.nack_timeout)
            self._unack[ev.id] = _Unack(ev, token)
            with self._token_lock:
                self._tokens[ev.id] = token
            self._evals[ev.id] = self._evals.get(ev.id, 0) + 1
            tracer = trace_mod.tracer() if trace_mod.ENABLED else None
            if tracer is not None and ev.trace:
                t0 = self._trace_enq.pop(ev.id, None)
                if t0 is not None:
                    tracer.record("broker.wait", t0, tracer.now() - t0,
                                  parent_ctx=ev.trace, eval_id=ev.id,
                                  queue=best_sched)
            return ev, token

    def _nack_expired(self, eval_id: str) -> None:
        """Nack-deadline expiry (wheel thread): tolerant of the
        delivery having been acked/flushed in the firing window — a
        stray expiry must log nothing and touch nothing on a torn-down
        server.  The token is read at expiry time; the armed re-check
        closes the pop->callback gap: a redelivery re-ARMS the key
        before publishing its token (both under the big lock the scan
        holds), so a fresh deadline being armed here means the token
        just read belongs to a NEW delivery whose window has not
        expired — nacking it would be premature."""
        with self._token_lock:
            token = self._tokens.get(eval_id)
        if token is None or self._nack_wheel.armed(eval_id):
            return
        try:
            self.nack(eval_id, token)
        except ValueError:
            pass

    # -- acknowledgement --------------------------------------------------
    def outstanding(self, eval_id: str) -> tuple[str, bool]:
        with self._token_lock:
            token = self._tokens.get(eval_id)
        if token is None:
            return "", False
        return token, True

    def outstanding_many(self, eval_ids: list) -> dict:
        """Outstanding tokens for a whole commit window in ONE leaf-lock
        hold — the plan applier's batched token fence.  Absent ids are
        simply missing from the result (not outstanding)."""
        with self._token_lock:
            tokens = self._tokens
            return {eid: tokens[eid] for eid in eval_ids
                    if eid in tokens}

    def ack(self, eval_id: str, token: str) -> None:
        with self._lock:
            unack = self._unack.get(eval_id)
            if unack is None:
                raise ValueError("Evaluation ID not found")
            if unack.token != token:
                raise ValueError("Token does not match for Evaluation ID")
            job_id = unack.eval.job_id
            self._nack_wheel.cancel(eval_id)
            with self._token_lock:
                self._tokens.pop(eval_id, None)

            del self._unack[eval_id]
            self._evals.pop(eval_id, None)
            self._job_evals.pop(job_id, None)
            self._trace_enq.pop(eval_id, None)
            self._acks += 1

            blocked = self._blocked.get(job_id)
            if blocked and len(blocked):
                ev = blocked.pop()
                if not len(blocked):
                    self._blocked.pop(job_id, None)
                self._enqueue_locked(ev, ev.type)

    def nack(self, eval_id: str, token: str) -> None:
        with self._lock:
            unack = self._unack.get(eval_id)
            if unack is None:
                raise ValueError("Evaluation ID not found")
            if unack.token != token:
                raise ValueError("Token does not match for Evaluation ID")
            self._nack_wheel.cancel(eval_id)
            with self._token_lock:
                self._tokens.pop(eval_id, None)
            del self._unack[eval_id]

            if self._evals.get(eval_id, 0) >= self.delivery_limit:
                self._enqueue_locked(unack.eval, FAILED_QUEUE)
            else:
                self._enqueue_locked(unack.eval, unack.eval.type)

    # -- introspection ----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            by_sched = {q: len(h) for q, h in self._ready.items() if len(h)}
            return {
                "total_ready": sum(by_sched.values()),
                "total_unacked": len(self._unack),
                "total_blocked": sum(len(h) for h in self._blocked.values()),
                "total_waiting": len(self._time_wait),
                "by_scheduler": by_sched,
                "expired_drops": self._expired_drops,
                "depth_sheds": self._depth_sheds,
                "acks": self._acks,
                # The admission pressure source's inputs, exported so
                # the control plane reads them as gauges.
                "depth": len(self._evals),
                "max_depth": self.max_depth or 0,
            }
