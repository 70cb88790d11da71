"""Applier: ``applier.verify`` time (each component counted once) over
the plans verified, ms a plan."""
import readout


def read(ctx):
    if not readout.usable(ctx):
        return None
    spans = readout.named(ctx, "applier.verify")
    if not spans:
        return None
    return 1e3 * readout.distinct_s(spans) / len(spans)
