"""RPC edge: waiters the store's watch woke (``woken`` of every
``watch.notify`` span) over the window's completed evals.  A window in
which no notify woke a waiter reads 0 where the program records the
watch's spans, as it records raft's (``raft.wait`` marks it)."""
import readout


def read(ctx):
    if not readout.usable(ctx):
        return None
    spans = readout.named(ctx, "watch.notify")
    if not spans and not readout.named(ctx, "raft.wait"):
        return None
    return readout.per_eval(ctx, sum(s["tags"]["woken"] for s in spans))
