"""Device: 100 x (1 - busy / window), busy the union of the port's own
device spans (every kernel launch and device seam call, from CUDA events
on the tracer's clock): the twin of ``device_idle_pct``."""
import readout
import spanread


def read(ctx):
    if not readout.usable(ctx):
        return None
    spans = spanread.device(ctx)
    if not spans:
        return None
    lo, hi = spanread.window(ctx)
    busy = readout.union_s(spanread.clipped(spans, lo, hi))
    return 100.0 * (1.0 - busy / ctx["window_s"])
