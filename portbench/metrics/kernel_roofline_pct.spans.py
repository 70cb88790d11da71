"""Kernels: the bytes each launch needs (``kernels/<name>.py`` on the
shapes its ``device.<kernel>`` span carries, real nodes) at the card's
HBM rate, summed, over the launches' summed span time, in percent: the
twin of ``kernel_roofline_pct``.  Launches without a formula are left
out of both sums."""
import readout
import spanread


def read(ctx):
    if not readout.usable(ctx):
        return None
    lo, hi = spanread.window(ctx)
    need = spent = 0.0
    for s in spanread.launches(ctx):
        formula = ctx["kernel_bytes"].get(s["name"][len("device."):])
        if formula is None:
            continue
        for a, b in spanread.clipped([s], lo, hi):
            if b > a:
                need += formula(spanread.call(s, ctx["n_real"])) \
                    / ctx["hbm_bytes_per_s"]
                spent += b - a
    return 100.0 * need / spent if spent and need else None
