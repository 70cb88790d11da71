"""K2, ``place_sequence``: one lane of a sequence walk."""
from _fleet import sequence_bytes


def nbytes(call) -> int:
    return sequence_bytes(call, 0)
