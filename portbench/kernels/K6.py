"""K6, ``window_verify``: per real pair its three gathered rows (4
values each), its node, order and component, its removed sum, and its
used, caps and fits; per placement row its pair and vector; per fold
entry its node, order, component and vector."""


def nbytes(call) -> int:
    pairs, rows, seq = call["pairs"], call["rows"], call["seq"]
    return pairs * (3 * 16 + 12 + 16 + 16 + 16 + 1) + rows * (4 + 16) \
        + seq * (12 + 16)
