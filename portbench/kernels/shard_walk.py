"""``shard_walk``: a whole sharded walk of one mesh row in one launch;
the bytes of the unsharded walk it stands for (K2's lanes for a sequence
walk, K3's for rounds) over the row's real nodes."""
from _fleet import rounds_bytes, sequence_bytes


def nbytes(call) -> int:
    if call.get("group_idx") is not None:
        return sequence_bytes(call, 0)
    return rounds_bytes(call, 0)
