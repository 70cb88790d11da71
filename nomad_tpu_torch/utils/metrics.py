"""Timers, counters and gauges.

Counterpart of the part of ``nomad_tpu/utils/metrics.py`` that the plan
verifier, the workers and the retry policy call:
``metrics.measure_since(key, start)`` adds the seconds since ``start``
(a ``time.perf_counter()`` reading) to ``key``'s total (armon/go-metrics
MeasureSince, as the reference uses it); ``incr_counter`` and
``set_gauge`` keep go-metrics' cumulative / last-write semantics.  The
reference's windowed in-memory sink feeds its agent's metrics endpoint,
which is not ported; here plain accumulators are enough.
"""
from __future__ import annotations

import threading
import time


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        # key -> [count, total seconds]
        self.timers: dict = {}
        self.counters: dict = {}
        self.gauges: dict = {}

    def incr_counter(self, key: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + value

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            self.gauges[key] = value

    def measure_since(self, key: str, start: float) -> None:
        elapsed = time.perf_counter() - start
        with self._lock:
            entry = self.timers.setdefault(key, [0, 0.0])
            entry[0] += 1
            entry[1] += elapsed


# Global registry, mirroring go-metrics' package-level default.
metrics = Metrics()
