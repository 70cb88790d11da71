"""What the traced run gives the per-layer metric readers
(``metrics/<name>.py``), and the arithmetic they share.

A reader's ``read(ctx)`` returns a number, or None where the run gave it
nothing to read.  ``ctx`` holds:

- ``spans``: the port's spans (``obs/trace.py``) that began inside the
  window, each with ``t0`` on the host's clock; ``dropped``: spans the
  tracer's ring dropped (span metrics are then not reported);
- ``evals``: evals completed inside the window; ``window_s``;
- ``device``: (name, kind, start s, end s, shapes) for each kernel
  launch and device seam call inside the window (``timeline.py``);
- ``counters``: program counters read across the window: ``applier``
  (``PlanApplier.stats()`` deltas), ``h2d`` (the transfer odometer's
  uploads), ``batches`` and ``batch_evals`` (fused
  ``BatchEvalRunner.process`` calls and the evals they carried);
- ``n_real``: the fleet's real nodes; ``kernel_bytes``: the formula of
  each kernel that has one; ``hbm_bytes_per_s``: the card's peak.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3.
HBM_BYTES_PER_S = 3.35e12


def named(ctx, *names) -> list:
    return [s for s in ctx["spans"] if s["name"] in names]


def usable(ctx) -> bool:
    return ctx["dropped"] == 0 and bool(ctx["spans"])


def mean_ms(ctx, name):
    """Mean duration of one span name, ms."""
    if not usable(ctx):
        return None
    xs = [s["dur"] for s in named(ctx, name)]
    return 1e3 * sum(xs) / len(xs) if xs else None


def distinct_s(spans) -> float:
    """Seconds of spans counted once per distinct interval: a fused
    stage or a group commit records one span per member eval with the
    shared start and length."""
    return sum(dur for _n, _t, dur in
               {(s["name"], s["t0"], s["dur"]) for s in spans})


def per_eval(ctx, value):
    return None if value is None or not ctx["evals"] else \
        value / ctx["evals"]


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def kernels(ctx) -> list:
    return [d for d in ctx["device"] if d[1] == "kernel"]
