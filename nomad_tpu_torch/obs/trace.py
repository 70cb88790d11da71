"""Distributed tracing: per-eval span trees across every plane.

The reference instruments with flat go-metrics timers; flat timers
cannot answer "where did eval X spend its 123 ms submit->respond"
— only a *causal* trace can.  This recorder threads one
context — ``{"trace_id", "span_id"}``, carried exactly like the
``_deadline`` envelope (server/overload.py) — from the client edge
(``ConnPool.call`` / the agent's ``InprocRPC``) through broker
enqueue->dequeue, the scheduler stages, ``Plan.Submit``, the group-
commit window verify, the raft batch apply, the FSM decode, and the
batched store upsert, so one eval's span tree covers agent edge ->
scheduler kernel -> leader commit -> state store.

Design constraints, in order:

- **Disabled = one module-bool check.**  Every instrumentation site in
  the runtime guards on ``trace.ENABLED`` (the same pattern as
  ``faultinject.ACTIVE``); with tracing off the hot path pays a single
  global read and no CUDA event is created.  Tracing on costs evals:
  on an H100 the benchmark's ``fleet10k.mock-job`` and
  ``fleet1k.batch-10x4`` cells complete 12-20% fewer a second traced
  than untraced in paired runs, ``fleet10k.deploy-1000g`` moves within
  its spread; the benchmark's own CUDA-event timeline with only the
  per-eval spans costs about as much (PERF.md §6).
- **Lock-cheap recording.**  Finished spans append to a per-thread
  buffer (plain ``list.append`` — owner-thread only, no lock) and drain
  into one bounded global ring under a single leaf lock every
  ``FLUSH_AT`` spans.  The ring lock acquires nothing else, so it can
  never participate in a lock-order cycle.
- **Bounded.**  The ring holds at most ``ring`` spans; overflow drops
  the OLDEST and counts (``stats()["dropped"]``) — an always-on tracer
  must never be a leak.
- **Monotonic only.**  Span times are ``perf_counter`` deltas against
  the tracer's epoch; no wall clock enters span math, so seeded chaos
  runs replay bit-stable modulo durations.
- **Seedable ids.**  Ids are ``<base><counter>`` hex; ``seed`` pins the
  base so a seeded run's ids are deterministic.

Spans cross threads (an eval is enqueued on one thread, scheduled on a
second, committed on a third), so alongside the ambient
``span()``/``attach()`` stack there is a low-level :meth:`Tracer.record`
that synthesizes a finished span from explicit (t0, dur, ctx) — the
broker's queue-wait span, the applier's per-plan window spans, and the
pipelined runner's cross-thread stage spans all use it.

Applier span taxonomy (the partitioned window verify): each
member plan's tree carries ``plan.queued`` (enqueue -> window pop),
then ``applier.window`` (shared t0/dur across the window, tagged
``window`` size and ``components`` count), and under it one
``applier.verify`` span carrying the timing of the claim-graph
COMPONENT that plan verified in (tagged ``component`` scheduling
ordinal, ``size``, ``fallback``) — component walks run concurrently on
the applier's ComponentExecutor, so sibling verify spans under the same
window overlap in time, which is the concurrency made visible.
``raft.apply`` follows as before (shared per window, one per member).

Control-plane taxonomy: the feedback controller records one
``control.tick`` span per evaluation (tags ``tick``, ``adjusted``)
with a ``control.adjust`` child per moved knob (``knob``, ``old``,
``new``, ``gauge``, ``direction``, ``reversal``, ``rail``) — the
decision trail that makes a tuning loop auditable after the fact.

Batch-worker taxonomy: one ``worker.batch`` span per dequeued batch
(dequeue to the last ack; tags ``lanes``, ``rounds`` fused rounds run,
``solo`` evals retried alone) parents the worker thread's phase spans,
recorded with :func:`phase` and carrying no ``eval_id``; each starts
where the thread's last one ended (:func:`phase_start`), so they tile
the batch: ``worker.sync`` (raft catch-up and snapshot), ``sched.lanes``
(a round's lanes begun, each eval's ``sched.begin`` inside),
``dispatch.stack``,
``dispatch.upload``, ``dispatch.launch``, ``dispatch.fetch`` (the host
waiting on the card) and ``dispatch.unstack`` (results mapped back per
lane), ``finish.prepare``, ``finish.native``, ``finish.tail``,
``submit.wait`` (the plan futures), ``submit.status`` (the eval-status
raft applies), ``sched.refresh`` (the snapshot between fused rounds),
one ``sched.solo`` per eval retried alone, ``sched.gc`` (the
collections the batch deferred, run as it re-enables the collector)
and ``worker.ack`` (the acks).  A phase nested in another (the
finish of an eval retried alone) starts at its own start.  Every
``sched.*`` span but ``sched.gc`` carries ``round`` (0 for the first
fused round).

Raft, commit and watch taxonomy: the in-memory raft records
``raft.wait`` (call to lock held) and ``raft.entry`` (lock held: log
append and ``fsm.apply``) for every entry, tagged ``msg_type`` and
``bytes``; the applier's committer records ``commit.encode`` (the
window's slab-wire and msgpack encode) and ``commit.respond``; the
store's ``StateWatch.notify`` records ``watch.notify`` when it wakes
waiters (``woken``, ``table``).

Device taxonomy: every kernel wrapper and device seam calls
:func:`device_span`, which records a start and an end CUDA event on the
device's current stream around the launch or copy and keeps them
pending; :meth:`Tracer.snapshot` synchronizes the cards and resolves
them into finished spans, so the hot path never waits on the card.
``enable()`` pairs one CUDA event per card with :meth:`Tracer.now`, so
a device span's ``t0`` and ``dur`` lie on the host spans' clock.  Names
are ``device.<kernel>`` (``K2``-``K6``, ``K6_sharded``, ``shard_walk``,
``shard_step``, ``K7b``, ``K7d``), tagged with the launch's logical
shapes, and ``device.<seam>`` (``put_counted``, ``ensure_on_default``,
``copy_to_host_async``, ``PinnedStaging.upload``), tagged ``bytes`` and
``kind`` (``h2d``, ``d2h``, ``d2d``).  Pending device spans sit in the
ring like finished ones: the ring bound and ``stats()["dropped"]``
count them.

Export is Chrome-trace JSON (``chrome://tracing`` / Perfetto "X"
complete events), span tags riding in ``args``.

Counterpart of ``nomad_tpu/obs/trace.py``: the same recorder, the same
ids for a seed and the same per-eval span taxonomy.  The port's batch
worker also records one ``worker.invoke`` span per eval of a fused
batch, which the JAX package's records only on its plain worker; the
batch-worker, raft, commit, watch and device spans above are the
port's own and carry no ``eval_id``.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager
from typing import Optional

# Hot-path gate: every runtime instrumentation site checks this single
# module bool before touching the tracer (mirrors faultinject.ACTIVE).
ENABLED = False
_TRACER: Optional["Tracer"] = None

# Envelope key in RPC args, beside overload's ``_deadline``: the wire
# form is {"trace_id": str, "span_id": str}.
TRACE_KEY = "_trace"

# Per-thread buffer drains into the global ring at this many spans.
FLUSH_AT = 64

DEFAULT_RING = 65536


class _ThreadBuf:
    """One thread's span buffer: appended by the owner thread only
    (no lock — list.append is atomic under the GIL), drained into the
    ring by the owner at FLUSH_AT, or by snapshot() for threads that
    have died."""

    __slots__ = ("spans", "thread")

    def __init__(self) -> None:
        self.spans: list = []
        self.thread = threading.current_thread()


class _Ambient(threading.local):
    """Per-thread ambient context stack for the span()/attach() API."""

    def __init__(self) -> None:
        self.stack: list = []


class Tracer:
    def __init__(self, seed: Optional[int] = None,
                 ring: int = DEFAULT_RING) -> None:
        if ring < 1:
            raise ValueError("ring must hold at least one span")
        if seed is None:
            import os
            base = int.from_bytes(os.urandom(4), "big")
        else:
            base = seed & 0xFFFFFFFF
        self._base = f"{base:08x}"
        self._ids = itertools.count(1)
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()   # leaf lock: ring + buffer registry
        self._ring: list = []           # finished spans (dicts), bounded
        self._ring_max = ring
        self._dropped = 0
        self._recorded = 0
        self._bufs: dict = {}           # id(buf) -> _ThreadBuf
        self._local = threading.local()
        self._ambient = _Ambient()
        # The open phase parent (``worker.batch``) of each thread: not
        # ambient, so the spans other code records on the thread keep
        # their parents.
        self._windows = threading.local()
        # card index -> (CUDA event, tracer-epoch seconds it completed
        # at): the pairing that puts device spans on this clock.
        self._bases: dict = {}
        self._resolve_lock = threading.Lock()

    # -- ids / context -----------------------------------------------------
    def new_id(self) -> str:
        """A fresh span/trace id: deterministic under a seed."""
        return f"{self._base}{next(self._ids):08x}"

    def now(self) -> float:
        """Monotonic seconds since the tracer's epoch."""
        return time.perf_counter() - self._epoch

    def ctx(self) -> Optional[dict]:
        """The ambient context ({"trace_id", "span_id"}) or None."""
        stack = self._ambient.stack
        return stack[-1] if stack else None

    @contextmanager
    def attach(self, ctx: Optional[dict]):
        """Make ``ctx`` ambient for the calling thread (a worker
        adopting a dequeued eval's context)."""
        if not ctx:
            yield
            return
        self._ambient.stack.append(ctx)
        try:
            yield
        finally:
            self._ambient.stack.pop()

    # -- recording ---------------------------------------------------------
    def record(self, name: str, t0: float, dur: float,
               ctx: Optional[dict] = None,
               parent_ctx: Optional[dict] = None,
               span_id: Optional[str] = None, **tags) -> dict:
        """Record one finished span and return its context.

        ``parent_ctx`` sets the parent explicitly (cross-thread spans);
        ``ctx`` continues an existing trace; absent both, the span
        roots a new trace.  ``t0`` is tracer-epoch seconds (see
        :meth:`now`)."""
        if parent_ctx:
            trace_id = parent_ctx.get("trace_id") or self.new_id()
            parent_id = parent_ctx.get("span_id")
        elif ctx:
            trace_id = ctx.get("trace_id") or self.new_id()
            parent_id = ctx.get("parent_id")
        else:
            trace_id = self.new_id()
            parent_id = None
        sid = span_id or (ctx.get("span_id") if ctx else None) \
            or self.new_id()
        span = {
            "name": name,
            "trace_id": trace_id,
            "span_id": sid,
            "parent_id": parent_id,
            "t0": t0,
            "dur": dur,
            "thread": threading.current_thread().name,
        }
        if tags:
            span["tags"] = tags
        self._append(span)
        return {"trace_id": trace_id, "span_id": sid}

    def anchor(self, name: str, parent_ctx: Optional[dict] = None,
               **tags) -> dict:
        """Record an instant anchor span and return its context — the
        single root every later span for one logical entity (an eval)
        descends from, however many threads and retries touch it."""
        now = self.now()
        return self.record(name, now, 0.0, parent_ctx=parent_ctx,
                           span_id=self.new_id(), **tags)

    @contextmanager
    def span(self, name: str, ctx: Optional[dict] = None, **tags):
        """Ambient nested span: parent is ``ctx`` (when given) or the
        current ambient context; the new span becomes ambient for the
        body.  Yields the span's context dict."""
        parent = ctx if ctx is not None else self.ctx()
        mine = {"trace_id": (parent or {}).get("trace_id")
                or self.new_id(),
                "span_id": self.new_id()}
        t0 = self.now()
        self._ambient.stack.append(mine)
        try:
            yield mine
        finally:
            self._ambient.stack.pop()
            # ctx (not parent_ctx): the recorded span must carry the
            # EXACT ids `mine` advertised while it was ambient — a
            # rootless span otherwise minted a second trace id.
            self.record(name, t0, self.now() - t0,
                        ctx={"trace_id": mine["trace_id"],
                             "parent_id": parent["span_id"]
                             if parent else None},
                        span_id=mine["span_id"], **tags)

    # -- phase spans ------------------------------------------------------
    def open_window(self) -> dict:
        """Open the calling thread's phase parent: a context whose span
        :meth:`close_window` records, and under which :meth:`phase`
        spans on this thread hang.  Not ambient."""
        now = self.now()
        ctx = {"trace_id": self.new_id(), "span_id": self.new_id(),
               "t0": now, "cursor": now}
        self._windows.ctx = ctx
        return ctx

    def close_window(self, ctx: dict, name: str, **tags) -> None:
        """Record the window span ``ctx`` opened, [its open, now]."""
        if getattr(self._windows, "ctx", None) is ctx:
            self._windows.ctx = None
        self.record(name, ctx["t0"], self.now() - ctx["t0"],
                    ctx={"trace_id": ctx["trace_id"], "parent_id": None},
                    span_id=ctx["span_id"], **tags)

    def phase_start(self) -> float:
        """Where the calling thread's next phase starts: the end of its
        last phase in the open window (its open, before the first), so
        the phases that start here tile the window; now when none is
        open."""
        window = getattr(self._windows, "ctx", None)
        return window["cursor"] if window is not None else self.now()

    def phase(self, name: str, t0: float, **tags) -> float:
        """Record a phase span [t0, now] under the calling thread's open
        window (a root span when none is open); returns now, where the
        window's next phase starts."""
        now = self.now()
        parent = getattr(self._windows, "ctx", None)
        self.record(name, t0, now - t0, parent_ctx=parent, **tags)
        if parent is not None:
            parent["cursor"] = now
        return now

    # -- device spans -----------------------------------------------------
    def clock_devices(self) -> None:
        """Pair one CUDA event per visible card with :meth:`now`, after
        synchronizing it: the base that resolves device spans onto this
        clock.  No card, no base, and no device span is recorded."""
        import torch

        if not torch.cuda.is_available():
            return
        bases = {}
        for index in range(torch.cuda.device_count()):
            torch.cuda.synchronize(index)
            base = torch.cuda.Event(enable_timing=True)
            base.record(torch.cuda.current_stream(index))
            base.synchronize()
            bases[index] = (base, self.now())
        with self._resolve_lock:
            self._bases = bases

    def device_start(self, device) -> Optional["DeviceSpan"]:
        """Record a start event on ``device``'s current stream; None
        for a device with no base (the CPU, or no card at enable)."""
        if getattr(device, "type", None) != "cuda":
            return None
        import torch

        index = device.index if device.index is not None else \
            torch.cuda.current_device()
        if index not in self._bases:
            return None
        stream = torch.cuda.current_stream(index)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        return DeviceSpan(self, index, stream, start, end)

    def _resolve(self, spans: list) -> None:
        """Resolve pending device spans in place: synchronize their
        cards, then set ``t0``/``dur`` from the events.  A span whose end
        event was recorded after the synchronize stays pending."""
        import torch

        pending = [s for s in spans if "_device" in s]
        for index in {dev[0] for dev in (s.get("_device") for s in pending)
                      if dev is not None}:
            torch.cuda.synchronize(index)
        with self._resolve_lock:
            for s in pending:
                dev = s.get("_device")
                if dev is None or not dev[2].query():
                    continue  # resolved by another snapshot, or later
                index, start, end, lazy = dev
                base, t_base = self._bases[index]
                s["t0"] = t_base + base.elapsed_time(start) / 1e3
                s["dur"] = start.elapsed_time(end) / 1e3
                if lazy is not None:
                    s["tags"].update(lazy())
                del s["_device"]

    def _append(self, span: dict) -> None:
        buf = getattr(self._local, "buf", None)
        if buf is None or buf.thread is not threading.current_thread():
            buf = _ThreadBuf()
            self._local.buf = buf
            with self._lock:
                # Fold dead threads' buffers here, not just in
                # snapshot(): short-lived recording threads (the
                # applier's per-window respond thread) would otherwise
                # grow the registry without bound on an always-on
                # tracer that nobody snapshots.  Amortized: one sweep
                # per NEW thread, over a registry bounded by live
                # threads + the dead ones since the last sweep.
                for key, old in list(self._bufs.items()):
                    if not old.thread.is_alive():
                        if old.spans:
                            spans, old.spans = old.spans, []
                            self._push_locked(spans)
                        del self._bufs[key]
                self._bufs[id(buf)] = buf
        buf.spans.append(span)
        if len(buf.spans) >= FLUSH_AT:
            spans, buf.spans = buf.spans, []
            with self._lock:
                self._push_locked(spans)

    def _push_locked(self, spans: list) -> None:
        self._recorded += len(spans)
        self._ring.extend(spans)
        over = len(self._ring) - self._ring_max
        if over > 0:
            del self._ring[:over]
            self._dropped += over

    # -- export ------------------------------------------------------------
    def snapshot(self) -> list:
        """Every retained span (ring + still-buffered), oldest-first by
        arrival.  Non-destructive; buffers of dead threads are folded
        into the ring so they cannot linger unbounded.  Pending device
        spans are resolved here, the one call that synchronizes the
        cards."""
        with self._lock:
            for key, buf in list(self._bufs.items()):
                if not buf.thread.is_alive() and buf.spans:
                    spans, buf.spans = buf.spans, []
                    self._push_locked(spans)
                if not buf.thread.is_alive():
                    del self._bufs[key]
            out = list(self._ring)
            for buf in self._bufs.values():
                out.extend(list(buf.spans))
        if any("_device" in s for s in out):
            self._resolve(out)
            out = [s for s in out if "_device" not in s]
        return out

    def stats(self) -> dict:
        with self._lock:
            buffered = sum(len(b.spans) for b in self._bufs.values())
            return {"ring": len(self._ring), "buffered": buffered,
                    "recorded": self._recorded + buffered,
                    "dropped": self._dropped,
                    "ring_max": self._ring_max}

    def chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON: one complete ("X") event per
        span, timestamps in microseconds since the tracer epoch, tags
        under ``args`` beside the span/parent ids."""
        events = []
        tids: dict = {}
        for s in self.snapshot():
            tid = tids.setdefault(s["thread"], len(tids) + 1)
            args = {"trace_id": s["trace_id"], "span_id": s["span_id"],
                    "parent_id": s["parent_id"]}
            args.update(s.get("tags") or {})
            events.append({
                "name": s["name"], "cat": s["name"].split(".")[0],
                "ph": "X",
                "ts": round(s["t0"] * 1e6, 1),
                "dur": round(s["dur"] * 1e6, 1),
                "pid": 1, "tid": tid,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"tracer": "nomad-tpu obs",
                              "threads": {str(v): k
                                          for k, v in tids.items()}}}

    def export_chrome(self, path: str) -> int:
        """Write the Chrome-trace JSON; returns the event count."""
        doc = self.chrome_trace()
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return len(doc["traceEvents"])


class DeviceSpan:
    """A device span begun by :meth:`Tracer.device_start`: its card,
    stream and events, the start one recorded.  :meth:`end` records the
    end event and leaves the span pending until
    :meth:`Tracer.snapshot`."""

    __slots__ = ("tracer", "index", "stream", "start", "end_event")

    def __init__(self, tracer: Tracer, index: int, stream, start,
                 end) -> None:
        self.tracer = tracer
        self.index = index
        self.stream = stream
        self.start = start
        self.end_event = end

    def end(self, name: str, lazy=None, **tags) -> None:
        """Record the end event and keep the span pending, tagged
        ``tags``; ``lazy``, a zero-argument function, adds the tags that
        need the launch's device data, once the span resolves."""
        end = self.end_event
        end.record(self.stream)
        t = self.tracer
        t._append({"name": name, "trace_id": t.new_id(),
                   "span_id": t.new_id(), "parent_id": None,
                   "t0": None, "dur": None,
                   "thread": threading.current_thread().name,
                   "tags": tags,
                   "_device": (self.index, self.start, end, lazy)})


# ---------------------------------------------------------------------------
# module-level convenience API (no-ops unless enabled)
# ---------------------------------------------------------------------------

def enable(seed: Optional[int] = None,
           ring: int = DEFAULT_RING) -> Tracer:
    """Install a fresh process-global tracer, pair its clock with each
    card's (:meth:`Tracer.clock_devices`) and flip the hot-path gate.
    Returns the tracer."""
    global _TRACER, ENABLED
    tracer = Tracer(seed=seed, ring=ring)
    tracer.clock_devices()
    _TRACER = tracer
    ENABLED = True
    return _TRACER


def disable() -> None:
    global _TRACER, ENABLED
    ENABLED = False
    _TRACER = None


def tracer() -> Optional[Tracer]:
    return _TRACER


@contextmanager
def tracing(seed: Optional[int] = None, ring: int = DEFAULT_RING):
    """Scoped enable/disable for tests and benches; yields the tracer."""
    t = enable(seed=seed, ring=ring)
    try:
        yield t
    finally:
        disable()


def now() -> float:
    """Tracer-epoch now, 0.0 when tracing is off."""
    t = _TRACER
    return t.now() if t is not None else 0.0


def phase_start() -> float:
    """Where the calling thread's next phase starts
    (:meth:`Tracer.phase_start`), 0.0 when tracing is off."""
    t = _TRACER
    return t.phase_start() if t is not None else 0.0


def phase(name: str, t0: float, **tags) -> float:
    """Record a phase span [t0, now] under the calling thread's open
    window (:meth:`Tracer.phase`); returns now.  With tracing off it
    reads the gate and returns 0.0."""
    if not ENABLED:
        return 0.0
    t = _TRACER
    return t.phase(name, t0, **tags) if t is not None else 0.0


def device_span(device) -> Optional[DeviceSpan]:
    """Begin a device span on ``device`` (a ``torch.device``): the one
    helper every kernel wrapper and device seam calls, behind
    ``ENABLED``, around its launch or copy.  None when tracing is off
    or the device is not a card the tracer clocked; else end it with
    :meth:`DeviceSpan.end`."""
    t = _TRACER
    return t.device_start(device) if t is not None else None


def ctx() -> Optional[dict]:
    t = _TRACER
    return t.ctx() if t is not None else None


def inject(args: dict) -> dict:
    """Stamp the ambient context into an RPC args dict (the `_deadline`
    discipline: copy, never mutate the caller's dict — retry loops
    re-send the same args)."""
    t = _TRACER
    if t is None:
        return args
    current = t.ctx()
    if current is None or TRACE_KEY in args:
        return args
    return dict(args, **{TRACE_KEY: {"trace_id": current["trace_id"],
                                     "span_id": current["span_id"]}})


@contextmanager
def client_call(method: str, args: dict):
    """The client-edge instrumentation shared by ``ConnPool.call`` and
    the agent's ``InprocRPC``: stamp the trace envelope (copying args —
    retry loops re-send the same dict) and record one
    ``rpc.client.<method>`` span per attempt.  When no ambient context
    exists the client span roots the trace and the envelope carries its
    id, so the server-side tree hangs off the agent edge."""
    t = _TRACER
    if t is None:
        yield args
        return
    parent = t.ctx()
    sid = t.new_id()
    tid = parent["trace_id"] if parent else t.new_id()
    if TRACE_KEY not in args:
        args = dict(args, **{TRACE_KEY: {"trace_id": tid,
                                         "span_id": sid}})
    t0 = t.now()
    try:
        yield args
    finally:
        t.record("rpc.client." + method, t0, t.now() - t0,
                 ctx={"trace_id": tid,
                      "parent_id": parent["span_id"] if parent
                      else None},
                 span_id=sid, method=method)


def extract(args: dict) -> Optional[dict]:
    """The envelope context from arriving RPC args (left in place so
    leader/region forwards keep propagating it)."""
    got = args.get(TRACE_KEY)
    if isinstance(got, dict) and got.get("trace_id"):
        return {"trace_id": got.get("trace_id"),
                "span_id": got.get("span_id")}
    return None
