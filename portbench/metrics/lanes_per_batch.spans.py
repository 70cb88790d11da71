"""Scheduler: mean ``lanes`` of the batch worker's ``worker.batch``
spans, evals a batch (the port's own count of ``lanes_per_batch``)."""
import readout


def read(ctx):
    if not readout.usable(ctx):
        return None
    lanes = [s["tags"]["lanes"] for s in readout.named(ctx, "worker.batch")]
    return sum(lanes) / len(lanes) if lanes else None
