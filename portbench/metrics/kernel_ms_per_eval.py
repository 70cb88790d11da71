"""Kernels: CUDA-event time of every kernel launch over the window's
completed evals, ms an eval."""
import readout


def read(ctx):
    launches = readout.kernels(ctx)
    if not launches:
        return None
    return readout.per_eval(ctx, 1e3 * sum(b - a for _n, _k, a, b, _s
                                             in launches))
