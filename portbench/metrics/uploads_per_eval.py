"""Device: host-to-device transfers on the port's counted upload seams
(the transfer odometer, ``parallel/devices.py``) over the window's
completed evals."""
import readout


def read(ctx):
    return readout.per_eval(ctx, ctx["counters"].get("h2d"))
