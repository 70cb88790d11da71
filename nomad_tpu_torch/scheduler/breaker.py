"""Device-executor circuit breaker.

Counterpart of ``nomad_tpu/scheduler/breaker.py``.  A card can fail in
ways the cost model never sees: a launch starts erroring, a result
fetch hangs past any useful deadline.  Retrying the device per eval
would stall the whole pipeline window each time; the host twins
(ops/binpack_host.py) produce identical plans, so the degradation is to
*hold the executor on the host* and re-probe the device periodically.

This covers RUN-TIME failures only.  A kernel that fails to build
raises from the pipelined runner's constructor, before any dispatch,
and never reaches the breaker.  On a CUDA device nothing is held on
the host: the runner records each failure here (``failures``/``opens``
in ``stats()``) and raises, and an open breaker makes its next
dispatch raise.  The hold and the re-run on the host twin apply where
the "device" walks are the kernels' plain versions (a runner on the
CPU); every such re-run is logged at warning and counted (the runner's
``breaker_reruns``).

Classic three-state breaker, specialized for the eval pipeline:

  closed     device dispatches flow normally; ``failure_threshold``
             consecutive failures trip it open.
  open       every would-be device dispatch is held on the host twin.
             After ``cooldown`` seconds the next admission becomes a
             half-open probe.
  half-open  exactly one in-flight probe eval runs on the device AND
             the host twin; the pipeline checks that their results are
             equal.  Probe success closes the breaker; failure re-opens
             it and restarts the cooldown.

``admit()`` is called by the pipeline's front stage per would-be device
dispatch and returns one of ``"device" | "probe" | "host"``; outcomes
come back through ``record_success`` / ``record_failure``.  Every
transition is counted (``stats()``).
"""
from __future__ import annotations

import logging
import threading
import time

from nomad_tpu_torch.obs import flight, registry

logger = logging.getLogger("nomad_tpu_torch.scheduler.breaker")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

ADMIT_DEVICE = "device"
ADMIT_PROBE = "probe"
ADMIT_HOST = "host"


class DeviceCircuitBreaker:
    def __init__(self, failure_threshold: int = 2,
                 cooldown: float = 15.0,
                 probe_timeout: float = 60.0,
                 clock=time.monotonic) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        # A probe whose outcome is never recorded (its window was
        # discarded by an unrelated drain error) must not pin the
        # breaker half-open-on-host forever: past this age it is
        # presumed lost and a fresh probe is issued.
        self.probe_timeout = probe_timeout
        self._clock = clock
        self._lock = threading.Lock()
        # All below guarded by _lock.
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        self._counts = {"opens": 0, "closes": 0, "probes": 0,
                        "host_holds": 0, "failures": 0}

    # -- admission (pipeline front stage) ----------------------------------
    def admit(self) -> str:
        """Route one would-be device dispatch: ``device`` (closed),
        ``probe`` (first admission after the cooldown: the caller runs
        the host twin too and checks parity), or ``host`` (held)."""
        with self._lock:
            if self._state == CLOSED:
                return ADMIT_DEVICE
            if self._state == OPEN and not self._probe_inflight and \
                    self._clock() - self._opened_at >= self.cooldown:
                self._state = HALF_OPEN
                self._start_probe()
                logger.info("device breaker: half-open, probing device")
                return ADMIT_PROBE
            if self._state == HALF_OPEN:
                if not self._probe_inflight:
                    # A previous probe resolved before this admission;
                    # a lingering half-open is probe-able.
                    self._start_probe()
                    return ADMIT_PROBE
                if self._clock() - self._probe_started >= \
                        self.probe_timeout:
                    # The in-flight probe's outcome was lost (window
                    # discarded): re-probe rather than hold on the host
                    # forever.
                    self._start_probe()
                    logger.warning("device breaker: probe outcome never "
                                   "recorded; issuing a fresh probe")
                    return ADMIT_PROBE
            self._counts["host_holds"] += 1
            return ADMIT_HOST

    def _start_probe(self) -> None:
        # Caller holds the lock.
        self._probe_inflight = True
        self._probe_started = self._clock()
        self._counts["probes"] += 1

    # -- outcomes (pipeline stages) ----------------------------------------
    def record_success(self, probe: bool = False) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if probe:
                self._probe_inflight = False
                if self._state != CLOSED:
                    self._state = CLOSED
                    self._counts["closes"] += 1
                    logger.info("device breaker: probe succeeded; closed")

    def record_failure(self, probe: bool = False) -> None:
        opened = False
        with self._lock:
            self._counts["failures"] += 1
            if probe:
                self._probe_inflight = False
                self._state = OPEN
                self._opened_at = self._clock()
                self._counts["opens"] += 1
                opened = True
                logger.warning("device breaker: probe failed; re-opened")
            else:
                self._consecutive_failures += 1
                if self._state == CLOSED and \
                        self._consecutive_failures >= \
                        self.failure_threshold:
                    self._state = OPEN
                    self._opened_at = self._clock()
                    self._counts["opens"] += 1
                    opened = True
                    logger.warning(
                        "device breaker: open after %d consecutive "
                        "device failures; holding executor on host "
                        "(re-probe in %.1fs)",
                        self._consecutive_failures, self.cooldown)
        if opened and flight.INSTALLED:
            # Flight-recorder trigger (obs/flight.py), OUTSIDE the
            # breaker lock: the device executor just went unhealthy —
            # dump spans + stacks + metrics while the evidence is warm.
            flight.trip("breaker.open", self.stats())

    # -- introspection -----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counts)
            out["state"] = self._state
            return out

    def reset(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._consecutive_failures = 0
            self._probe_inflight = False
            self._probe_started = 0.0
            self._opened_at = 0.0
            for k in self._counts:
                self._counts[k] = 0


# Process-default breaker: the device's health is a property of the
# machine, not of any single runner, so successive PipelinedEvalRunner
# instances share trip state by default.  Tests wanting isolation pass
# their own instance.
GLOBAL_BREAKER = DeviceCircuitBreaker()

# The breaker is exactly the kind of process-wide singleton the global
# metrics registry exists for: one producer, visible as nomad.breaker.*
# in the process REGISTRY.
registry.REGISTRY.register("breaker", GLOBAL_BREAKER.stats)
