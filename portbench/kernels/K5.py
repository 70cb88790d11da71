"""K5, ``scatter_rows``: the usage buffer copied to a fresh one (read and
written once, real rows), the replaced rows' indices and values read."""
from _fleet import real_nodes


def nbytes(call) -> int:
    n, d, r = real_nodes(call), call["d"], call["r"]
    return 2 * n * d * 4 + 4 * r + r * d * 4
