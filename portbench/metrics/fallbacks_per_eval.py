"""Applier: conflict fallbacks (``PlanApplier.stats()``) over the
window's completed evals."""
import readout


def read(ctx):
    return readout.per_eval(ctx, ctx["counters"]["applier"].get(
        "conflict_fallbacks"))
