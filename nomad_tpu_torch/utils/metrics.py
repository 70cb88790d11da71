"""Telemetry: counters, gauges and timers.

Counterpart of ``nomad_tpu/utils/metrics.py`` (armon/go-metrics as the
reference uses it: MeasureSince on every RPC/FSM/worker/plan step,
SetGauge for queue depths, an in-memory sink dumpable on demand).
``metrics.measure_since(key, start)`` adds the seconds since ``start``
(a ``time.perf_counter()`` reading) to ``key``'s running total in
``metrics.timers`` and a sample to the windowed in-memory sink
(``metrics.inmem``, which the flight recorder snapshots);
``incr_counter`` and ``set_gauge`` keep go-metrics' cumulative /
last-write semantics.  ``add_statsd`` adds a statsd UDP fanout (the
agent's ``telemetry`` block, reference command/agent/command.go:487-533).
"""
from __future__ import annotations

import socket
import threading
import time
from collections import defaultdict


class InmemSink:
    """Aggregating in-memory sink with interval-windowed samples.

    Counters and gauges are cumulative/last-write (go-metrics
    semantics).  Samples are bucketed into ``interval``-second windows
    and only the newest ``retain`` windows feed the percentile summary:
    a latency spike from an hour ago must age OUT of the reported p99.
    Per-window sample count is bounded (``max_per_interval``, newest
    kept) so a storm cannot grow the sink without bound.  ``clock`` is
    injectable for deterministic tests."""

    def __init__(self, interval: float = 10.0, retain: int = 6,
                 max_per_interval: int = 4096,
                 clock=time.monotonic) -> None:
        if interval <= 0 or retain < 1:
            raise ValueError("want interval > 0 and retain >= 1")
        self.interval = interval
        self.retain = retain
        self.max_per_interval = max_per_interval
        self._clock = clock
        self._lock = threading.Lock()
        self.counters: dict = defaultdict(float)
        self.gauges: dict = {}
        # key -> [[interval_index, [values...]], ...] newest last.
        self.samples: dict = defaultdict(list)

    def incr_counter(self, key: str, value: float) -> None:
        with self._lock:
            self.counters[key] += value

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            self.gauges[key] = value

    def _interval_index(self) -> int:
        return int(self._clock() / self.interval)

    def add_sample(self, key: str, value: float) -> None:
        now_idx = self._interval_index()
        with self._lock:
            windows = self.samples[key]
            if not windows or windows[-1][0] != now_idx:
                windows.append([now_idx, []])
                # Age out everything beyond the retained window count.
                if len(windows) > self.retain:
                    del windows[: len(windows) - self.retain]
            bucket = windows[-1][1]
            bucket.append(value)
            if len(bucket) > self.max_per_interval:
                del bucket[: len(bucket) - self.max_per_interval]

    def snapshot(self) -> dict:
        now_idx = self._interval_index()
        with self._lock:
            oldest_live = now_idx - self.retain + 1
            out = {"counters": dict(self.counters),
                   "gauges": dict(self.gauges), "samples": {}}
            for key, windows in self.samples.items():
                values: list = []
                for idx, bucket in windows:
                    # Windows are pruned on WRITE; a key nobody has
                    # sampled recently still ages out on read.
                    if idx >= oldest_live:
                        values.extend(bucket)
                if not values:
                    continue
                ordered = sorted(values)
                out["samples"][key] = {
                    "count": len(values),
                    "mean": sum(values) / len(values),
                    "max": ordered[-1],
                    "p99": ordered[min(len(ordered) - 1,
                                       int(len(ordered) * 0.99))],
                }
            return out


class StatsdSink:
    """Fire-and-forget statsd UDP fanout."""

    def __init__(self, address: tuple) -> None:
        self.address = tuple(address)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def _send(self, payload: str) -> None:
        try:
            self.sock.sendto(payload.encode(), self.address)
        except OSError:
            pass

    def incr_counter(self, key: str, value: float) -> None:
        self._send(f"{key}:{value}|c")

    def set_gauge(self, key: str, value: float) -> None:
        self._send(f"{key}:{value}|g")

    def add_sample(self, key: str, value: float) -> None:
        self._send(f"{key}:{value * 1000:.3f}|ms")


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.inmem = InmemSink()
        # Every sink a value goes to: the in-memory one, then each
        # statsd fanout ``add_statsd`` added.
        self.sinks: list = [self.inmem]
        # key -> [count, total seconds]
        self.timers: dict = {}
        self.counters: dict = {}
        self.gauges: dict = {}

    def incr_counter(self, key: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + value
        for sink in self.sinks:
            sink.incr_counter(key, value)

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            self.gauges[key] = value
        for sink in self.sinks:
            sink.set_gauge(key, value)

    def measure_since(self, key: str, start: float) -> None:
        elapsed = time.perf_counter() - start
        with self._lock:
            entry = self.timers.setdefault(key, [0, 0.0])
            entry[0] += 1
            entry[1] += elapsed
        for sink in self.sinks:
            sink.add_sample(key, elapsed)

    def add_statsd(self, host: str, port: int) -> None:
        self.sinks.append(StatsdSink((host, port)))


# Global registry, mirroring go-metrics' package-level default.
metrics = Metrics()
