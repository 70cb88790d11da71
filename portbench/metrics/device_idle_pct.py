"""Device: 100 x (1 - busy / window), busy the union of the CUDA-event
intervals of every kernel launch and device seam call (an upper bound:
a pageable upload's staging counts as busy)."""
import readout


def read(ctx):
    if not ctx["device"]:
        return None
    busy = readout.union_s([(a, b) for _n, _k, a, b, _s in ctx["device"]])
    return 100.0 * (1.0 - busy / ctx["window_s"])
