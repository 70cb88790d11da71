"""Kernels: time of every ``device.<kernel>`` span (a launch, from CUDA
events) over the window's completed evals, ms an eval: the twin of
``kernel_ms_per_eval``."""
import readout
import spanread


def read(ctx):
    if not readout.usable(ctx):
        return None
    spans = spanread.launches(ctx)
    if not spans:
        return None
    lo, hi = spanread.window(ctx)
    return readout.per_eval(ctx, 1e3 * sum(
        b - a for a, b in spanread.clipped(spans, lo, hi)))
