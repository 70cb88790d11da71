"""K4a, ``place_rounds_batch``: K3's lanes, each with its penalty."""
from _fleet import rounds_bytes


def nbytes(call) -> int:
    return rounds_bytes(call, 4)
