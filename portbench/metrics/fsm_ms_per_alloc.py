"""Raft and FSM: ``fsm.decode`` + ``store.upsert`` time (an entry's
shared spans counted once) over the allocations written, placed or
stopped, ms an allocation."""
import readout


def read(ctx):
    if not readout.usable(ctx):
        return None
    spans = readout.named(ctx, "fsm.decode", "store.upsert")
    allocs = sum(s.get("tags", {}).get("n_allocs", 0)
                 for s in spans if s["name"] == "store.upsert")
    if not allocs:
        return None
    return 1e3 * readout.distinct_s(spans) / allocs
