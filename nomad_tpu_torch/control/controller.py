"""The controller service: typed actuators, control laws, one tick loop.

Design constraints, in order:

- **Deterministic.**  A tick's decisions are a pure function of the
  gauge stream and the controller's own state; the seed pins the only
  randomness (the tick-phase offset that desynchronizes a fleet of
  controllers — synchronized control actions across servers are a
  metastable amplifier, the same reason ``utils/retry`` uses full
  jitter) so seeded chaos runs replay bit-stable.
- **Railed.**  Every knob moves through an :class:`Actuator` with hard
  ``lo``/``hi`` rails; the controller can *never* push a tunable
  outside the envelope the operator declared safe.  Rail saturation is
  an event (counted, flight-dumped), not a silent clamp.
- **Self-indicting.**  A reversal (the controller changing direction on
  a knob) and a rail saturation each trip the flight recorder (when one
  is installed): an oscillating or pegged loop freezes its own
  evidence.  Every adjustment records a ``control.adjust`` span under
  the tick's ``control.tick`` span (old/new value, driving gauge,
  direction) and surfaces in ``stats()`` — the registry provider
  mirrors it into ``/v1/agent/metrics``.
- **Isolated.**  A driver or gauge provider that raises is counted and
  skipped, never propagated: the control plane must not become the
  incident (the ``OverloadController.pressure`` discipline).

Control laws: :class:`AIMD` (additive increase, multiplicative
decrease — TCP's stability argument applies to any shared-resource
depth knob) and :class:`GradientStep` (multiplicative hill steps for
set-point knobs like window sizes and thresholds).  Drivers translate
gauges into a signed signal: ``+1`` grow, ``-1`` shrink, ``0`` hold;
hysteresis lives in the drivers (hold bands), so a gauge hovering at a
boundary cannot flap a knob.

Operator drills: :meth:`Controller.pin` pins a knob at a value and
takes it out of the loop — the same mechanism as
``OverloadController.force_state`` (pin ``None`` returns control to
the loop).
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional

from nomad_tpu_torch.obs import flight as flight_mod
from nomad_tpu_torch.obs import trace as trace_mod

logger = logging.getLogger("nomad_tpu_torch.control")

# Bounded per-knob position history (initial -> ... -> current): the
# bench's convergence rows record it as the knob's trajectory.
TRAJECTORY_MAX = 128


class Actuator:
    """Typed handle on one live tunable with hard min/max rails.

    ``get``/``set`` close over the owning component's attribute (the
    applier's ``max_window``, the runner's ``depth``, ...); ``apply``
    clamps every target into ``[lo, hi]`` and books the movement:
    adjustments, direction reversals, rail saturations (counted on the
    False->True transition only, so a knob parked at a rail books ONE
    hit, not one per tick), and a bounded position trajectory.
    ``gauge`` names the driving gauge for spans/stats/incidents."""

    def __init__(self, name: str, get: Callable[[], float],
                 set: Callable[[float], None], lo: float, hi: float,
                 integer: bool = False, gauge: str = "") -> None:
        if not lo < hi:
            raise ValueError(f"actuator {name!r}: want lo < hi")
        self.name = name
        self._get = get
        self._set = set
        self.lo = lo
        self.hi = hi
        self.integer = integer
        self.gauge = gauge
        self.initial = self.read()
        # Counters + trajectory behind a leaf lock: the tick thread
        # writes, stats()/registry readers read.  The foreign setter is
        # always called OUTSIDE it.
        self._lock = threading.Lock()
        self.adjustments = 0
        self.reversals = 0
        self.rail_hits = 0
        self._last_dir = 0
        self._railed = False
        self._pinned: Optional[float] = None
        self._trajectory: list = [self.initial]

    def read(self) -> float:
        return self._get()

    def clamp(self, value: float) -> float:
        value = min(max(value, self.lo), self.hi)
        if self.integer:
            value = int(round(value))
        return value

    def is_pinned(self) -> bool:
        with self._lock:
            return self._pinned is not None

    def pin(self, value: Optional[float]) -> None:
        """Pin the knob at ``value`` (clamped to the rails) and take it
        out of the control loop; ``None`` returns it to the loop —
        the ``OverloadController.force_state`` mechanism, knob-shaped.
        Operator drills pin a knob, observe, unpin."""
        if value is None:
            with self._lock:
                self._pinned = None
            return
        clamped = self.clamp(value)
        # Set OUTSIDE the lock (foreign component), then book.
        self._set(clamped)
        with self._lock:
            self._pinned = clamped
            self._trajectory.append(clamped)
            del self._trajectory[:-TRAJECTORY_MAX]

    def apply(self, target: float) -> tuple:
        """Drive the knob toward ``target`` (clamped); returns
        ``(old, new, events)`` where events carries ``direction``,
        ``reversal`` and ``rail`` booleans for the controller's
        span/flight bookkeeping.  ``new == old`` with a ``rail`` event
        means the decision saturated an already-pegged knob."""
        old = self.read()
        new = self.clamp(target)
        desired_out = target < self.lo or target > self.hi
        events = {"direction": 0, "reversal": False, "rail": False}
        if new != old:
            self._set(new)  # outside the lock: foreign component
        with self._lock:
            if desired_out:
                if not self._railed:
                    self._railed = True
                    self.rail_hits += 1
                    events["rail"] = True
            else:
                self._railed = False
            if new == old:
                return old, old, events
            direction = 1 if new > old else -1
            events["direction"] = direction
            if self._last_dir * direction < 0:
                self.reversals += 1
                events["reversal"] = True
            self._last_dir = direction
            self.adjustments += 1
            self._trajectory.append(new)
            del self._trajectory[:-TRAJECTORY_MAX]
        return old, new, events

    def stats(self) -> dict:
        # The immutable fields (rails, gauge, initial) and the foreign
        # getter stay OUTSIDE the counter lock.
        out = {
            "value": self.read(),
            "initial": self.initial,
            "lo": self.lo,
            "hi": self.hi,
            "gauge": self.gauge,
        }
        with self._lock:
            out.update({
                "adjustments": self.adjustments,
                "reversals": self.reversals,
                "rail_hits": self.rail_hits,
                "pinned": self._pinned is not None,
                "trajectory": list(self._trajectory),
            })
        return out


class AIMD:
    """Additive increase, multiplicative decrease: grow linearly while
    healthy, back off geometrically under pressure — the stable probe
    for shared-resource depth knobs (pipeline depth, commit-pipeline
    depth), exactly TCP's congestion-window argument."""

    def __init__(self, add: float = 1.0, mult: float = 0.5) -> None:
        if add <= 0 or not 0.0 < mult < 1.0:
            raise ValueError("AIMD wants add > 0 and 0 < mult < 1")
        self.add = add
        self.mult = mult

    def step(self, value: float, signal: int) -> float:
        if signal > 0:
            return value + self.add
        if signal < 0:
            return value * self.mult
        return value


class GradientStep:
    """Multiplicative hill steps for set-point knobs (window sizes,
    gather horizons, admission thresholds): geometric in both
    directions, so a 4x-mis-set constant converges in O(log) adjusts
    instead of O(distance) additive ones."""

    def __init__(self, up: float = 1.5, down: float = 0.67) -> None:
        if up <= 1.0 or not 0.0 < down < 1.0:
            raise ValueError("GradientStep wants up > 1 and 0 < down < 1")
        self.up = up
        self.down = down

    def step(self, value: float, signal: int) -> float:
        base = max(value, 1e-9)
        if signal > 0:
            return base * self.up
        if signal < 0:
            return base * self.down
        return value


class TickView:
    """One tick's read view over the gauge stream: the current flat
    gauge dict, the previous tick's, and the wall delta between them —
    drivers compute levels (``get``), per-tick deltas (``delta``) and
    rates (``rate``) from it.  Non-numeric gauges (labels) coerce to
    the default so a driver never trips on a stringified leaf."""

    __slots__ = ("gauges", "prev", "dt", "rng")

    def __init__(self, gauges: dict, prev: dict, dt: float, rng) -> None:
        self.gauges = gauges
        self.prev = prev
        self.dt = dt
        self.rng = rng

    @staticmethod
    def _num(value, default: float) -> float:
        if isinstance(value, bool):
            return float(value)
        if isinstance(value, (int, float)):
            return float(value)
        return default

    def get(self, key: str, default: float = 0.0) -> float:
        return self._num(self.gauges.get(key), default)

    def delta(self, key: str) -> float:
        return self._num(self.gauges.get(key), 0.0) \
            - self._num(self.prev.get(key), 0.0)

    def rate(self, key: str) -> float:
        return self.delta(key) / self.dt


class _Knob:
    """One wired knob.  ``prev``/``prev_t`` is the gauge snapshot at
    this knob's LAST evaluation — a slow-lane knob (``every=N``) sees
    N-tick deltas, not one noisy tick's: per-tick gauge deltas are
    lumpy (a 50 ms tick may contain zero commit cycles), and a driver
    fed lumpy deltas oscillates."""

    __slots__ = ("actuator", "law", "driver", "every", "prev",
                 "prev_t")

    def __init__(self, actuator: Actuator, law, driver,
                 every: int) -> None:
        self.actuator = actuator
        self.law = law
        self.driver = driver
        self.every = max(1, int(every))
        self.prev: Optional[dict] = None
        self.prev_t = 0.0


class Controller:
    """The tick loop: read gauges, consult each knob's driver, step its
    law, apply through its actuator — one joinable thread per
    server/agent (``start``/``stop``), or driven by hand (``tick``)
    from tests and benches.

    ``gauges_fn`` returns the flat ``{dotted_key: value}`` gauge dict
    (``MetricsRegistry.snapshot()`` shape); drivers read it through a
    :class:`TickView`.  ``every=N`` on a knob adjusts it on every Nth
    tick only — the slow-moving lane for admission thresholds."""

    def __init__(self, gauges_fn: Callable[[], dict],
                 interval: float = 0.25, seed: int = 0,
                 name: str = "controller",
                 clock: Callable[[], float] = time.monotonic) -> None:
        if interval <= 0:
            raise ValueError("controller interval must be > 0")
        self.gauges_fn = gauges_fn
        self.interval = interval
        self.seed = seed
        self.name = name
        self._clock = clock
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._knobs: dict = {}
        self._ticks = 0
        self._adjustments = 0
        self._tick_errors = 0
        self._driver_errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wiring ------------------------------------------------------------
    def add_knob(self, actuator: Actuator, law, driver,
                 every: int = 1) -> Actuator:
        with self._lock:
            if actuator.name in self._knobs:
                raise ValueError(f"duplicate knob {actuator.name!r}")
            self._knobs[actuator.name] = _Knob(actuator, law, driver,
                                               every)
        return actuator

    def knob(self, name: str) -> Actuator:
        with self._lock:
            return self._knobs[name].actuator

    def pin(self, name: str, value: Optional[float]) -> None:
        """Pin one knob for an operator drill (``None`` unpins) — see
        :meth:`Actuator.pin`."""
        self.knob(name).pin(value)

    # -- the tick ----------------------------------------------------------
    def tick(self) -> list:
        """One deterministic control evaluation; returns the decision
        list (one dict per adjusted knob).  A knob's first evaluation
        only seeds its previous-gauges baseline — deltas need two
        samples — and a slow-lane knob's deltas span its whole
        ``every``-tick cadence."""
        now = self._clock()
        try:
            gauges = self.gauges_fn() or {}
        except Exception:
            with self._lock:
                self._tick_errors += 1
            return []
        with self._lock:
            self._ticks += 1
            n_tick = self._ticks
            knobs = list(self._knobs.values())
        tracer = trace_mod.tracer() if trace_mod.ENABLED else None
        t0 = tracer.now() if tracer is not None else 0.0
        decisions: list = []
        for knob in knobs:
            if n_tick % knob.every:
                continue
            act = knob.actuator
            prev, prev_t = knob.prev, knob.prev_t
            knob.prev, knob.prev_t = gauges, now
            if act.is_pinned() or prev is None:
                continue
            view = TickView(gauges, prev, max(now - prev_t, 1e-9),
                            self._rng)
            try:
                signal = int(knob.driver(view) or 0)
            except Exception:
                # A broken driver must not take the plane (or the other
                # knobs) with it.
                with self._lock:
                    self._driver_errors += 1
                logger.exception("control driver for %r failed",
                                 act.name)
                continue
            if signal == 0:
                continue
            old, new, events = act.apply(knob.law.step(act.read(),
                                                       signal))
            if new == old and not events["rail"]:
                continue
            decisions.append({
                "knob": act.name, "old": old, "new": new,
                "signal": signal, "gauge": act.gauge,
                "direction": events["direction"],
                "reversal": events["reversal"],
                "rail": events["rail"],
            })
            # Self-indictment: a reversal or a rail saturation freezes
            # the evidence (queue depths, spans, stacks) at the moment
            # the loop misbehaved.  Gated on the module bool first —
            # the tick must not pay for a feature that is off.
            if flight_mod.INSTALLED:
                if events["reversal"]:
                    flight_mod.trip("control.reversal", dict(
                        decisions[-1], controller=self.name))
                if events["rail"]:
                    flight_mod.trip("control.rail", dict(
                        decisions[-1], controller=self.name))
        if decisions:
            with self._lock:
                self._adjustments += len(decisions)
        if tracer is not None:
            # Decision tracing: one control.tick span per evaluation,
            # one control.adjust child per moved knob (old/new value,
            # driving gauge, direction) — the span taxonomy's control
            # plane rows.
            dur = tracer.now() - t0
            tick_ctx = tracer.record(
                "control.tick", t0, dur, parent_ctx=tracer.ctx(),
                controller=self.name, tick=n_tick,
                adjusted=len(decisions))
            for d in decisions:
                tracer.record(
                    "control.adjust", t0, dur, parent_ctx=tick_ctx,
                    knob=d["knob"], old=d["old"], new=d["new"],
                    gauge=d["gauge"], direction=d["direction"],
                    reversal=d["reversal"], rail=d["rail"])
        return decisions

    # -- the service thread ------------------------------------------------
    def start(self) -> None:
        name = self.name  # immutable: read outside the counter lock
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=name)
            self._thread.start()

    def _run(self) -> None:
        # Seeded phase offset: a fleet of controllers booted together
        # must not tick (and adjust, and dump incidents) in lockstep.
        if self._stop.wait(self.interval * self._rng.random()):
            return
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                with self._lock:
                    self._tick_errors += 1
                logger.exception("controller %s: tick failed", self.name)
            if self._stop.wait(self.interval):
                return

    def stop(self, timeout: float = 2.0) -> None:
        """Stop and JOIN the tick thread (the thread-lifecycle lint's
        contract: every service thread is reaped)."""
        self._stop.set()
        with self._lock:
            _thread = self._thread
        if _thread is not None and \
                _thread is not threading.current_thread():
            _thread.join(timeout)

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    # -- introspection -----------------------------------------------------
    def positions(self) -> dict:
        """{knob: current value} — the flight recorder's ``extra_fn``
        payload, so every incident names where every knob sat."""
        with self._lock:
            acts = [k.actuator for k in self._knobs.values()]
        return {a.name: a.read() for a in acts}

    def stats(self) -> dict:
        """Registry provider: per-knob position/reversals/rail-hits +
        tick counters, mirrored into /v1/agent/metrics."""
        out = {"interval_s": self.interval, "seed": self.seed}
        with self._lock:
            out.update({
                "ticks": self._ticks,
                "adjustments": self._adjustments,
                "tick_errors": self._tick_errors,
                "driver_errors": self._driver_errors,
            })
            acts = [k.actuator for k in self._knobs.values()]
        out["knobs"] = {a.name: a.stats() for a in acts}
        return out
