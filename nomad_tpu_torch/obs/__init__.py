"""Trace & telemetry plane.

Counterpart of ``nomad_tpu/obs``, in three cooperating pieces:

- :mod:`nomad_tpu_torch.obs.trace` — per-eval distributed tracing: a
  span recorder (lock-cheap per-thread buffers, bounded global ring,
  seedable ids, monotonic-only timestamps) plus the ``_trace`` RPC
  envelope, exportable as Chrome-trace/Perfetto JSON.
- :mod:`nomad_tpu_torch.obs.registry` — the unified metrics registry
  turning every component ``stats()`` into ``nomad.<provider>.*``
  gauges.
- :mod:`nomad_tpu_torch.obs.flight` — the flight recorder: on
  breaker-open, overload entry, or a stall-watchdog trip, dump span
  ring + thread stacks + metrics snapshot to a bounded on-disk incident
  file.

Layering: obs imports nothing from nomad_tpu_torch outside ``utils`` —
every other subsystem may import obs without cycles.
"""
from . import flight, registry, trace  # noqa: F401
from .registry import REGISTRY, MetricsRegistry, flatten  # noqa: F401
from .trace import TRACE_KEY, Tracer, tracing  # noqa: F401
from .flight import FlightRecorder, StallWatchdog  # noqa: F401
