"""Scheduler: the lanes the batch worker planned in a chained tail (the
stragglers after its fused rounds, each lane's walk on the usage the
lane before it left), the sum of the ``chained`` tags of its
``worker.batch`` spans, over the window's completed evals.  A program
whose ``worker.batch`` carries no ``chained`` tag reads nothing."""
import readout


def read(ctx):
    if not readout.usable(ctx):
        return None
    chained = [s["tags"]["chained"]
               for s in readout.named(ctx, "worker.batch")
               if "chained" in (s.get("tags") or {})]
    return readout.per_eval(ctx, sum(chained)) if chained else None
