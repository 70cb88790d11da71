"""Scheduler: ``sched.begin`` + ``sched.dispatch`` + ``sched.finish``
time over the window's completed evals, ms an eval.  A fused stage is
counted once, not once a lane; ``sched.submit`` is left out: it waits
on the commit."""
import readout


def read(ctx):
    if not readout.usable(ctx):
        return None
    spans = readout.named(ctx, "sched.begin", "sched.dispatch",
                          "sched.finish")
    if not spans:
        return None
    return readout.per_eval(ctx, 1e3 * readout.distinct_s(spans))
