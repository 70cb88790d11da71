"""Kernels: the bytes each launch's inputs and outputs need
(``kernels/<name>.py``, real nodes) at the card's HBM rate, summed, over
the launches' summed CUDA-event time, in percent.  Launches without a
formula or shapes are left out of both sums."""
import readout


def read(ctx):
    need = spent = 0.0
    for name, _kind, a, b, shapes in readout.kernels(ctx):
        formula = ctx["kernel_bytes"].get(name)
        if formula is None or shapes is None or b <= a:
            continue
        need += formula(dict(shapes, n_real=ctx["n_real"])) \
            / ctx["hbm_bytes_per_s"]
        spent += b - a
    return 100.0 * need / spent if spent and need else None
