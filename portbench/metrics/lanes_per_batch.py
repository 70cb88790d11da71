"""Scheduler: evals over fused ``BatchEvalRunner.process`` calls."""


def read(ctx):
    c = ctx["counters"]
    return c["batch_evals"] / c["batches"] if c["batches"] else None
