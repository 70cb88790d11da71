"""Scheduler: 100 x the union of the batch worker's ``worker.batch``
spans and their phase spans over the window, in percent.  A batch
begun before the window shows from its first phase inside it."""
import readout
import spanread

PHASES = ("worker.batch", "worker.sync", "sched.lanes", "dispatch.stack",
          "dispatch.upload", "dispatch.launch", "dispatch.fetch",
          "dispatch.unstack", "finish.prepare", "finish.native",
          "finish.tail", "submit.wait", "submit.status", "sched.refresh",
          "sched.solo", "sched.gc", "worker.ack")


def read(ctx):
    if not readout.usable(ctx):
        return None
    spans = readout.named(ctx, *PHASES)
    if not any(s["name"] == "worker.batch" for s in spans):
        return None
    lo, hi = spanread.window(ctx)
    busy = readout.union_s(spanread.clipped(spans, lo, hi))
    return 100.0 * busy / ctx["window_s"]
