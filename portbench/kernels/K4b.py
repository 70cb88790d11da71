"""K4b, ``place_sequence_batch``: K2's lanes, each with its penalty."""
from _fleet import sequence_bytes


def nbytes(call) -> int:
    return sequence_bytes(call, 4)
