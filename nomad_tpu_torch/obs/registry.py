"""Unified metrics registry: every ``stats()`` dict, one namespace.

The runtime grew 14 per-component ``stats()`` providers (applier,
broker, overload, heartbeat, edge loop, dispatch pool, plan queue,
breaker, runner, store watch, swarm, ...) that were never exported —
each bench and test hand-collected the ones it knew about.  The
registry turns them into one tree:

- ``register(name, fn)`` parks a zero-argument provider returning a
  (possibly nested) dict; ``snapshot()`` calls every provider and
  flattens the result into dotted gauges — key grammar
  ``nomad.<provider>.<path...>`` with nested dicts joined by dots and
  non-numeric leaves stringified (they publish as labels, not gauges).
- ``publish(metrics)`` pushes the numeric leaves as gauges into a
  ``utils/metrics.Metrics`` fanout (in-memory sink + optional statsd),
  so the existing telemetry plumbing (SIGUSR1 dump, statsd) sees the
  same numbers with no second producer.
- A provider that raises is reported under ``nomad.<name>.error``
  instead of wedging the snapshot — a torn-down component must never
  take the metrics plane with it (same discipline as
  ``OverloadController.pressure``).

Instances are cheap and owned: each ``Server`` builds its own (its
providers close over live components and die with it); the module-
global :data:`REGISTRY` carries process-wide singletons only (the
device circuit breaker, a live agent swarm).  ``snapshot(extra=...)``
merges other registries so the agent's ``/v1/agent/metrics`` endpoint
serves server + process registries as one document.

Counterpart of ``nomad_tpu/obs/registry.py``, unchanged.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

PREFIX = "nomad"


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {"a.b.c": leaf}.  Lists/tuples are summarized by
    length (a gauge), everything non-numeric is stringified."""
    out: dict = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(flatten(val, path))
        elif isinstance(val, (list, tuple)):
            out[f"{path}.len"] = len(val)
        elif isinstance(val, bool):
            out[path] = int(val)
        elif isinstance(val, (int, float)):
            out[path] = val
        else:
            out[path] = str(val)
    return out


class _Sampler:
    """Long-lived worker running providers under a deadline for
    :meth:`MetricsRegistry.collect` — the ``_CollectWorker`` pattern
    from scheduler/pipeline.py: one callable at a time via ``inq``,
    result on ``outq``; on a timeout the registry abandons this worker
    (its queues go with it, so a late result can never be mistaken for
    a later provider's) and tells it to exit via the ``None`` sentinel
    once the hung call finally returns."""

    def __init__(self) -> None:
        self.inq: queue.Queue = queue.Queue()
        self.outq: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="metrics-sampler")
        self.thread.start()

    def _run(self) -> None:
        while True:
            fn = self.inq.get()
            if fn is None:
                return
            try:
                self.outq.put((True, fn()))
            except BaseException as e:
                self.outq.put((False, e))

    def join(self, timeout: "float | None" = None) -> None:
        """Reap after the exit sentinel (clean-shutdown path only; an
        abandoned sampler dies on its own when the hung call returns)."""
        self.thread.join(timeout)


class MetricsRegistry:
    def __init__(self, clock: Callable[[], float] = time.monotonic
                 ) -> None:
        self._lock = threading.Lock()
        self._providers: dict = {}   # token -> (name, fn)
        self._seq = 0
        self._clock = clock
        # Staleness tracking for collect(): provider name ->
        # (value fingerprint, clock() when it last changed).
        self._ages: dict = {}
        # Lazy deadline-bounded sampler (collect(timeout=...) only).
        # ``_sampler_gen`` bumps on clear(): a collect() mid-flight
        # when the registry is torn down must not park its claimed
        # sampler back into the cleared registry (nobody would ever
        # send that thread its exit sentinel again).
        self._sampler: Optional[_Sampler] = None
        self._sampler_gen = 0

    # -- wiring ------------------------------------------------------------
    def register(self, name: str, fn: Callable[[], dict]) -> str:
        """Park a provider; returns a deregistration token.  Names are
        unique — re-registering a live name replaces it (a restarted
        component supersedes its predecessor)."""
        with self._lock:
            self._seq += 1
            token = f"p{self._seq}"
            for tok, (got, _fn) in list(self._providers.items()):
                if got == name:
                    del self._providers[tok]
            self._providers[token] = (name, fn)
            # A replaced name is a NEW provider: its staleness clock
            # restarts (collect() must not blame the successor for the
            # predecessor's frozen values).
            self._ages.pop(name, None)
            return token

    def deregister(self, token: str) -> bool:
        with self._lock:
            got = self._providers.pop(token, None)
            if got is not None:
                self._ages.pop(got[0], None)
            return got is not None

    def clear(self) -> None:
        with self._lock:
            self._providers.clear()
            self._ages.clear()
            sampler, self._sampler = self._sampler, None
            self._sampler_gen += 1
        if sampler is not None:
            sampler.inq.put(None)
            sampler.join(2.0)

    def providers(self) -> list:
        with self._lock:
            return sorted(name for name, _fn in self._providers.values())

    # -- reading -----------------------------------------------------------
    def snapshot(self, extra: Optional[list] = None) -> dict:
        """One flattened ``{dotted_key: value}`` document over every
        provider (plus the providers of any ``extra`` registries).
        Providers run OUTSIDE the registry lock — they read other
        components' locks and must not nest under ours."""
        with self._lock:
            providers = list(self._providers.values())
        if extra:
            for reg in extra:
                with reg._lock:
                    providers.extend(reg._providers.values())
        out: dict = {}
        for name, fn in providers:
            base = f"{PREFIX}.{name}"
            try:
                stats = fn()
            except Exception as e:
                out[f"{base}.error"] = f"{type(e).__name__}: {e}"
                continue
            if not isinstance(stats, dict):
                out[f"{base}.error"] = "provider returned non-dict"
                continue
            out.update(flatten(stats, base))
        return out

    def collect(self, timeout: Optional[float] = None,
                extra: Optional[list] = None) -> dict:
        """:meth:`snapshot` hardened for a serving surface: stamps a
        per-provider ``nomad.<name>.age_s`` gauge (seconds since the
        provider's flattened value last CHANGED — a component that
        keeps returning the same frozen numbers is stale even though
        its call succeeds), and with a ``timeout`` runs each provider
        under a deadline on a long-lived sampler worker so one hung
        provider (wedged on a dead component's lock) isolates as
        ``.error = "sample timeout"`` instead of blocking the whole
        collection.  Staleness is tracked on THIS registry for its own
        providers and for ``extra`` registries' providers alike (keyed
        by provider name)."""
        with self._lock:
            providers = list(self._providers.values())
        if extra:
            for reg in extra:
                with reg._lock:
                    providers.extend(reg._providers.values())
        out: dict = {}
        now = self._clock()
        for name, fn in providers:
            base = f"{PREFIX}.{name}"
            ok, got = self._sample(fn, timeout)
            if ok and not isinstance(got, dict):
                ok, got = False, TypeError("provider returned non-dict")
            if not ok:
                out[f"{base}.error"] = got if isinstance(got, str) \
                    else f"{type(got).__name__}: {got}"
                with self._lock:
                    aged = self._ages.get(name)
                if aged is not None:
                    out[f"{base}.age_s"] = round(now - aged[1], 3)
                continue
            flat = flatten(got, base)
            out.update(flat)
            fp = hash(tuple(sorted(
                (k, str(v)) for k, v in flat.items())))
            with self._lock:
                aged = self._ages.get(name)
                if aged is None or aged[0] != fp:
                    self._ages[name] = (fp, now)
                    aged = self._ages[name]
            out[f"{base}.age_s"] = round(now - aged[1], 3)
        return out

    def _sample(self, fn, timeout: Optional[float]) -> tuple:
        """(ok, value-or-error) for one provider, under the optional
        deadline.  The sampler worker is reused across samples; a
        timed-out worker is abandoned mid-call and replaced (see
        :class:`_Sampler`)."""
        if timeout is None:
            try:
                return True, fn()
            except Exception as e:
                return False, e
        # CLAIM the parked sampler (slot set to None) so two concurrent
        # collect() calls can never interleave one worker's queues;
        # a healthy sampler parks back afterwards — unless clear()
        # bumped the generation meanwhile (teardown), in which case it
        # is reaped here instead of outliving its registry.  A second
        # sampler born from a claim race is reaped the same way.
        with self._lock:
            sampler, self._sampler = self._sampler, None
            gen = self._sampler_gen
        if sampler is None:
            sampler = _Sampler()
        sampler.inq.put(fn)
        try:
            ok, val = sampler.outq.get(timeout=timeout)
        except queue.Empty:
            sampler.inq.put(None)  # abandoned: exits after the hung call
            return False, f"sample timeout after {timeout}s"
        with self._lock:
            if self._sampler is None and self._sampler_gen == gen:
                self._sampler = sampler
                sampler = None
        if sampler is not None:
            sampler.inq.put(None)
            sampler.join(1.0)
        if not ok and isinstance(val, BaseException) \
                and not isinstance(val, Exception):
            raise val  # KeyboardInterrupt and friends propagate
        return ok, val

    def publish(self, metrics, extra: Optional[list] = None) -> int:
        """Push every numeric leaf as a gauge into a utils/metrics
        fanout; returns the number of gauges set."""
        snap = self.snapshot(extra=extra)
        n = 0
        for key, val in snap.items():
            if isinstance(val, (int, float)):
                metrics.set_gauge(key, float(val))
                n += 1
        return n


# Process-wide singletons only (device breaker, live swarms); component
# registries are per-owner and die with their owner.
REGISTRY = MetricsRegistry()
