"""Flight recorder: turn a bad moment into a post-hoc debuggable file.

Chaos and soak failures die with their evidence: by the time a human
looks, the span ring has wrapped, the stacks have moved on, and the
queue depths are back to normal.  The flight recorder dumps the black
box AT the moment something trips:

- **breaker-open** — the device executor just went unhealthy
  (scheduler/breaker.py calls :func:`trip` on CLOSED->OPEN);
- **overload entry** — the admission plane entered the shedding state
  (server/overload.py calls :func:`trip` on *->OVERLOAD);
- **stall watchdog** — a guarded section (a plan-apply window, a drain
  window) overstayed its deadline (:class:`StallWatchdog` /
  :func:`guard`).

Each trip writes ONE bounded JSON incident file —
``incident-<seq>-<reason>.json`` under the installed directory —
carrying the last-N spans from the trace ring, every live thread's
stack (utils/profiling.thread_stacks — the pprof-goroutine analogue),
and a metrics snapshot (the caller-supplied registries plus the in-mem
telemetry sink).  Bounds, so the recorder can never become the
incident: at most ``max_files`` newest incidents on disk (oldest
pruned), at most ``max_spans`` spans per file, and a per-reason
``min_interval`` rate limit (a flapping breaker must not write a
thousand files).

Everything is a no-op until :func:`install` runs — the trip sites in
breaker/overload pay one module-bool read when no recorder is
installed (the same gate discipline as ``trace.ENABLED`` and
``faultinject.ACTIVE``).

Counterpart of ``nomad_tpu/obs/flight.py``: the same incident file;
its thread stacks and in-memory telemetry come from the port's
``utils/profiling`` and ``utils/metrics``.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

logger = logging.getLogger("nomad_tpu_torch.obs.flight")

# Hot-path gate, mirrored from trace.ENABLED / faultinject.ACTIVE.
INSTALLED = False
_RECORDER: Optional["FlightRecorder"] = None


class FlightRecorder:
    def __init__(self, directory: str, max_files: int = 8,
                 max_spans: int = 2048,
                 min_interval: float = 5.0,
                 registries: Optional[list] = None,
                 extra_fn=None,
                 clock=time.monotonic) -> None:
        self.directory = directory
        self.max_files = max(1, max_files)
        self.max_spans = max(1, max_spans)
        self.min_interval = min_interval
        self.registries = list(registries or [])
        # Process-context hook, the recorder-level twin of the stall
        # guard's per-section extra_fn: a zero-arg -> dict called at
        # dump time and merged into EVERY incident's extra under
        # "context" (the feedback controller passes its per-knob
        # positions, so any incident names where every knob sat).
        # Best-effort: a failing hook must not eat the incident.
        self.extra_fn = extra_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self._last_by_reason: dict = {}   # reason -> last trip time
        self.trips = 0          # incidents written; guarded
        self.suppressed = 0     # rate-limited trips; guarded
        os.makedirs(directory, exist_ok=True)

    def add_registry(self, registry) -> None:
        with self._lock:
            self.registries.append(registry)

    # -- the trip path -----------------------------------------------------
    def record(self, reason: str, extra: Optional[dict] = None
               ) -> Optional[str]:
        """Dump one incident; returns the file path (None when rate-
        limited).  Never raises — a failing dump logs and returns None;
        the triggering subsystem must not inherit recorder errors."""
        now = self._clock()
        with self._lock:
            last = self._last_by_reason.get(reason)
            if last is not None and now - last < self.min_interval:
                self.suppressed += 1
                return None
            self._last_by_reason[reason] = now
            self._seq += 1
            seq = self._seq
            self.trips += 1
        try:
            return self._write(seq, reason, extra)
        except Exception:
            logger.exception("flight recorder: dump for %r failed",
                             reason)
            return None

    def _write(self, seq: int, reason: str,
               extra: Optional[dict]) -> str:
        from nomad_tpu_torch.utils import profiling
        from nomad_tpu_torch.utils.metrics import metrics

        from . import trace as trace_mod

        spans: list = []
        tracer = trace_mod.tracer()
        if tracer is not None:
            spans = tracer.snapshot()[-self.max_spans:]
        providers: dict = {}
        with self._lock:
            registries = list(self.registries)
        for reg in registries:
            try:
                providers.update(reg.snapshot())
            except Exception as e:
                providers["nomad.flight.registry_error"] = str(e)
        extra = dict(extra or {})
        if self.extra_fn is not None:
            try:
                extra["context"] = self.extra_fn()
            except Exception:
                logger.exception("flight recorder: extra_fn failed")
        doc = {
            "reason": reason,
            "seq": seq,
            "monotonic": self._clock(),
            "extra": extra,
            "spans": spans,
            "thread_stacks": profiling.thread_stacks(),
            "metrics": {
                "providers": providers,
                "inmem": metrics.inmem.snapshot(),
            },
        }
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in reason)
        path = os.path.join(self.directory,
                            f"incident-{seq:04d}-{safe}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, default=str)
        # faultlint-ok(uninjectable-io): observability plane — incident
        # snapshots never feed replicated or serving state.
        os.replace(tmp, path)
        self._prune()
        return path

    def _prune(self) -> None:
        """Keep only the newest ``max_files`` incidents on disk."""
        try:
            names = sorted(n for n in os.listdir(self.directory)
                           if n.startswith("incident-")
                           and n.endswith(".json"))
        except OSError:
            return
        for name in names[:-self.max_files]:
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:
                pass

    def incidents(self) -> list:
        """Incident file names on disk, oldest first."""
        try:
            return sorted(n for n in os.listdir(self.directory)
                          if n.startswith("incident-")
                          and n.endswith(".json"))
        except OSError:
            return []

    def stats(self) -> dict:
        with self._lock:
            return {"trips": self.trips, "suppressed": self.suppressed,
                    "on_disk": len(self.incidents())}


class StallWatchdog:
    """One checker thread watching armed sections for overstays.

    ``guard(name, timeout)`` arms a deadline around a section that
    should complete promptly (a plan-apply window, a drain window); a
    section still armed past its deadline trips the flight recorder
    ONCE (per arm) with the stalled section's name.  The thread wakes
    on arm/disarm/stop and otherwise sleeps to the earliest untripped
    deadline (indefinitely when nothing is armed), so an idle — or
    merely guarded — watchdog costs nothing.  ``stop()`` joins the
    thread — the lifecycle lint requires every thread reaped."""

    def __init__(self, on_stall) -> None:
        self.on_stall = on_stall     # fn(name, age_seconds, extra)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._armed: dict = {}   # token -> (name, armed_at, deadline,
        #                                    extra_fn)
        self._tripped: set = set()   # tokens already reported
        self._seq = 0
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="flight-stall-watchdog")
        self._thread.start()

    def arm(self, name: str, timeout: float, extra_fn=None) -> str:
        """``extra_fn`` (optional, zero-arg -> dict) is called AT trip
        time on the watchdog thread and merged into the incident's
        extra — the guarded section's own attribution of what it is
        stuck on (the plan applier passes its component executor's
        ``active()``, so a wedged window names the slow component)."""
        with self._cond:
            self._seq += 1
            token = f"g{self._seq}"
            now = time.monotonic()
            self._armed[token] = (name, now, now + timeout, extra_fn)
            self._cond.notify_all()
            return token

    def disarm(self, token: str) -> None:
        with self._cond:
            self._armed.pop(token, None)
            self._tripped.discard(token)

    @contextmanager
    def guard(self, name: str, timeout: float, extra_fn=None):
        token = self.arm(name, timeout, extra_fn)
        try:
            yield
        finally:
            self.disarm(token)

    def _run(self) -> None:
        while True:
            fire: list = []
            with self._cond:
                if self._stopped:
                    return
                now = time.monotonic()
                next_deadline = None
                for token, (name, armed_at, deadline, extra_fn) in \
                        self._armed.items():
                    if token in self._tripped:
                        continue
                    if now >= deadline:
                        self._tripped.add(token)
                        fire.append((name, now - armed_at, extra_fn))
                    elif next_deadline is None or \
                            deadline < next_deadline:
                        next_deadline = deadline
                if not fire:
                    # Earliest untripped deadline, or indefinitely
                    # (arm/disarm/stop all notify the condition).
                    self._cond.wait(None if next_deadline is None
                                    else next_deadline - now)
                    continue
            for name, age, extra_fn in fire:
                extra = None
                if extra_fn is not None:
                    # The section's own attribution, best-effort: a
                    # failing extra_fn must not eat the incident.
                    try:
                        extra = extra_fn()
                    except Exception:
                        logger.exception(
                            "stall attribution for %r failed", name)
                try:
                    self.on_stall(name, age, extra)
                except Exception:
                    logger.exception("stall watchdog callback failed")

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(2.0)


# ---------------------------------------------------------------------------
# module-level gate (trip sites in breaker/overload use these)
# ---------------------------------------------------------------------------

_WATCHDOG: Optional[StallWatchdog] = None


def install(directory: str, registries: Optional[list] = None,
            **kw) -> FlightRecorder:
    """Install the process flight recorder (and its stall watchdog)."""
    global _RECORDER, _WATCHDOG, INSTALLED
    uninstall()
    rec = FlightRecorder(directory, registries=registries, **kw)
    _RECORDER = rec
    _WATCHDOG = StallWatchdog(
        lambda name, age, extra: trip(
            "stall." + name,
            dict(extra or {}, stalled_for_s=round(age, 3))))
    INSTALLED = True
    return rec


def uninstall() -> None:
    global _RECORDER, _WATCHDOG, INSTALLED
    INSTALLED = False
    watchdog, _WATCHDOG = _WATCHDOG, None
    _RECORDER = None
    if watchdog is not None:
        watchdog.stop()


def recorder() -> Optional[FlightRecorder]:
    return _RECORDER


@contextmanager
def installed(directory: str, **kw):
    """Scoped install/uninstall for tests and benches."""
    rec = install(directory, **kw)
    try:
        yield rec
    finally:
        uninstall()


def trip(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Dump an incident if a recorder is installed; no-op otherwise.
    Callers gate on ``flight.INSTALLED`` first so the common path is
    one module-bool read."""
    rec = _RECORDER
    if rec is None:
        return None
    return rec.record(reason, extra)


@contextmanager
def guard(name: str, timeout: float, extra_fn=None):
    """Stall-guard a section: if it overstays ``timeout`` the watchdog
    trips ``stall.<name>``, merging ``extra_fn()`` (the section's own
    attribution — e.g. which window component is still verifying) into
    the incident extra.  No-op when no recorder is installed."""
    watchdog = _WATCHDOG
    if watchdog is None:
        yield
        return
    with watchdog.guard(name, timeout, extra_fn=extra_fn):
        yield
