"""Scheduler: the time the batch worker spends on retries, over the
window's completed evals, ms an eval: the union of every ``sched.*``
span tagged ``round`` >= 1 (the stages of a fused retry round, a fused
stage counted once; the snapshot between rounds, ``sched.refresh``;
each eval retried alone, ``sched.solo``)."""
import readout


def read(ctx):
    if not readout.usable(ctx):
        return None
    rounds = [s for s in ctx["spans"] if s["name"].startswith("sched.")
              and "round" in (s.get("tags") or {})]
    if not rounds:
        return None
    retries = [(s["t0"], s["t0"] + s["dur"]) for s in rounds
               if s["tags"]["round"] >= 1]
    return readout.per_eval(ctx, 1e3 * readout.union_s(retries))
