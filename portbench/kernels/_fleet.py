"""Byte counts shared by the placement kernels' formulas (the roofline
arithmetic of ``chip_smoke.py``'s ``shared_fleet_bytes``,
``rounds_lane_bytes`` and ``sequence_lane_bytes``), counting the
fleet's real nodes, not the padding: a roofline counts what the inputs
need.  Each input byte read once, each output byte written once."""
from __future__ import annotations

NDIMS = 6  # a fleet row: cpu, memory, disk, iops, mbits, and one spare


def real_nodes(call) -> int:
    return min(int(call["n_real"]), int(call["n"]))


def shared_fleet_bytes(n: int) -> int:
    """capacity, reserved and usage0, f32[N, 6] each, read once."""
    return 3 * n * NDIMS * 4


def rounds_lane_bytes(n: int, g: int, out_len: int) -> int:
    """One lane of K3/K4a: job counts; every slot's ask, distinct flag,
    count and feasibility row (a slot of count 0 is scored too, or its
    row read to find no feasible node); chosen and scores (``out_len``
    each); the lane's usage."""
    return 4 * n + g * (NDIMS * 4 + 1 + 4 + n) + 8 * out_len + n * NDIMS * 4


def sequence_lane_bytes(n: int, p: int, named: int) -> int:
    """One lane of K2/K4b: job counts; the valid flags; the group index
    of each step; the feasibility row, ask and distinct flag of each
    group a step names (every step is scored, valid or not); chosen and
    scores; the lane's usage."""
    return (4 * n + p + 4 * p + named * (n + NDIMS * 4 + 1) + 8 * p
            + n * NDIMS * 4)


def named_groups(group_idx) -> list:
    """Distinct groups each lane's steps name, from the launch's group
    index (read after the window)."""
    gi = group_idx.detach().cpu().reshape(-1, group_idx.shape[-1])
    return [len(set(row.tolist())) for row in gi]


def rounds_bytes(call, lane_extra: int) -> int:
    n = real_nodes(call)
    out_len = call["g"] * call["rounds"] * call["k_cap"]
    return shared_fleet_bytes(n) + call["lanes"] * (
        lane_extra + rounds_lane_bytes(n, call["g"], out_len))


def sequence_bytes(call, lane_extra: int) -> int:
    n = real_nodes(call)
    return shared_fleet_bytes(n) + sum(
        lane_extra + sequence_lane_bytes(n, call["p"], k)
        for k in named_groups(call["group_idx"]))
