"""What the readers of the port's own spans share (``metrics/`` of
``worker_busy_pct``, ``device_idle_pct.spans``, ``kernel_ms_per_eval.spans``,
``kernel_roofline_pct.spans`` and ``h2d_mb_per_eval``).

The port records its device work as spans (``obs/trace.py``): each
kernel launch as ``device.<kernel>`` tagged with its logical shapes, each
device seam call as ``device.<seam>`` tagged ``bytes`` and ``kind``,
both from CUDA events on the host spans' clock.  The harness keeps the
spans that began inside the window and gives no bounds, so the window
is taken to open at the first of them, ``window_s`` long.
"""
from __future__ import annotations

SEAMS = ("device.put_counted", "device.ensure_on_default",
         "device.copy_to_host_async", "device.PinnedStaging.upload")


def window(ctx) -> tuple:
    """(open, close) of the window on the host's clock."""
    lo = min(s["t0"] for s in ctx["spans"])
    return lo, lo + ctx["window_s"]


def clipped(spans, lo: float, hi: float) -> list:
    """(start, end) of each span, cut at the window's close."""
    return [(max(s["t0"], lo), min(s["t0"] + s["dur"], hi)) for s in spans
            if s["t0"] < hi]


def device(ctx) -> list:
    return [s for s in ctx["spans"] if s["name"].startswith("device.")]


def launches(ctx) -> list:
    """The kernel launches: every device span but the seams'."""
    return [s for s in device(ctx) if s["name"] not in SEAMS]


def call(span, n_real: int) -> dict:
    """A launch's shapes as ``kernels/<name>.py`` reads them.  A
    sequence walk's span carries ``named`` (distinct groups a lane);
    the formulas read them off a group index, so one is made whose rows
    name that many groups each."""
    tags = dict(span.get("tags") or {}, n_real=n_real)
    named = tags.pop("named", None)
    if named is not None:
        import torch

        p = int(tags["p"])
        tags["group_idx"] = torch.tensor(
            [[min(j, max(k, 1) - 1) for j in range(p)] for k in named],
            dtype=torch.int32).reshape(len(named), p)
    return tags
