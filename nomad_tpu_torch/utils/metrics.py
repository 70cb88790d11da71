"""Timers: a count and a sum of seconds per key.

Counterpart of the part of ``nomad_tpu/utils/metrics.py`` that the plan
verifier calls: ``metrics.measure_since(key, start)`` adds the seconds
since ``start`` (a ``time.perf_counter()`` reading) to ``key``'s total
(armon/go-metrics MeasureSince, as the reference uses it).  The
reference's windowed in-memory sink feeds its agent's metrics endpoint,
which is not ported; here a plain accumulator is enough.
"""
from __future__ import annotations

import threading
import time


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        # key -> [count, total seconds]
        self.timers: dict = {}

    def measure_since(self, key: str, start: float) -> None:
        elapsed = time.perf_counter() - start
        with self._lock:
            entry = self.timers.setdefault(key, [0, 0.0])
            entry[0] += 1
            entry[1] += elapsed


# Global registry, mirroring go-metrics' package-level default.
metrics = Metrics()
