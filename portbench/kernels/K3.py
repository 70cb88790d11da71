"""K3, ``place_rounds``: one lane of rounds over its slots."""
from _fleet import rounds_bytes


def nbytes(call) -> int:
    return rounds_bytes(call, 0)
