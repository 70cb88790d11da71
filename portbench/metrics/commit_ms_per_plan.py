"""Raft and FSM: ``raft.apply`` time (a group commit counted once) over
the plans committed, ms a plan."""
import readout


def read(ctx):
    if not readout.usable(ctx):
        return None
    spans = readout.named(ctx, "raft.apply")
    if not spans:
        return None
    return 1e3 * readout.distinct_s(spans) / len(spans)
