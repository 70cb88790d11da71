"""Placement scoring + fitting math.

Capability parity with reference nomad/structs/funcs.go.  `score_fit`
(Google BestFit-v3: 20 - (10^freeCpuFrac + 10^freeMemFrac), clamped [0, 18])
is the exact function the device-side scheduler vectorizes over the fleet
tensor in nomad_tpu_torch/ops/binpack.py — this scalar version is the golden
reference for parity tests.
"""
from __future__ import annotations

from typing import Optional

from .model import Allocation, Node, Resources
from .network import NetworkIndex


def remove_allocs(allocs: list[Allocation],
                  remove: list[Allocation]) -> list[Allocation]:
    remove_ids = {a.id for a in remove}
    return [a for a in allocs if a.id not in remove_ids]


def filter_terminal_allocs(allocs: list[Allocation]) -> list[Allocation]:
    return [a for a in allocs if not a.terminal_status()]


def allocs_fit(
    node: Node,
    allocs: list[Allocation],
    net_idx: Optional[NetworkIndex] = None,
) -> tuple[bool, str, Resources]:
    """Check whether the allocation set fits on the node.

    Returns (fit, exhausted-dimension, total-utilization).  If net_idx is
    given the caller has already checked port collisions.
    """
    used = Resources()
    if node.reserved is not None:
        used.add(node.reserved)
    for alloc in allocs:
        used.add(alloc.resources)

    ok, dim = node.resources.superset(used)
    if not ok:
        return False, dim, used

    if net_idx is None:
        net_idx = NetworkIndex()
        collide = net_idx.set_node(node)
        collide = net_idx.add_allocs(allocs) or collide
        if collide:
            return False, "reserved port collision", used

    if net_idx.overcommitted():
        return False, "bandwidth exceeded", used

    return True, "", used


def score_fit(node: Node, util: Resources) -> float:
    """BestFit-v3 packing score; 18 is a perfect fit, 0 is empty/overfit."""
    node_cpu = float(node.resources.cpu)
    node_mem = float(node.resources.memory_mb)
    if node.reserved is not None:
        node_cpu -= node.reserved.cpu
        node_mem -= node.reserved.memory_mb

    # Zero-capacity nodes score 0 (Go float division yields Inf -> clamped).
    if node_cpu <= 0 or node_mem <= 0:
        return 0.0

    free_pct_cpu = 1.0 - (util.cpu / node_cpu)
    free_pct_mem = 1.0 - (util.memory_mb / node_mem)

    total = 10.0 ** free_pct_cpu + 10.0 ** free_pct_mem
    score = 20.0 - total
    return max(0.0, min(18.0, score))


def score_fit_vec(util_cpu, util_mem, node_cpu, node_mem, *,
                  valid=None, safe_cpu=None, safe_mem=None):
    """Vectorized BestFit-v3 twin of score_fit (numpy arrays in, array
    out): the ONE producer of the scoring curve for the vector paths
    (ops/binpack_host._HostScorer, scheduler/system_vec stage 2) —
    tuning the curve or the [0, 18] clamp happens here and in the
    scalar above only.  Zero-capacity rows score 0 like the scalar's
    early return.  Callers on a hot path may pass the node-static
    pieces precomputed (``valid``/``safe_cpu``/``safe_mem``)."""
    import numpy as np

    given = (valid is not None, safe_cpu is not None, safe_mem is not None)
    if not any(given):
        valid = (node_cpu > 0) & (node_mem > 0)
        safe_cpu = np.where(valid, node_cpu, 1.0)
        safe_mem = np.where(valid, node_mem, 1.0)
    elif not all(given):
        raise TypeError("score_fit_vec: the precomputed kwargs are "
                        "all-or-nothing (valid + safe_cpu + safe_mem)")
    score = 20.0 - (
        np.power(np.float32(10.0), 1.0 - util_cpu / safe_cpu)
        + np.power(np.float32(10.0), 1.0 - util_mem / safe_mem))
    score = np.asarray(score)
    # dtype-preserving zero: float32 pipelines must stay float32 (the
    # host top-k packs the raw float32 bits into its selection key).
    return np.where(valid, np.clip(score, 0.0, 18.0),
                    score.dtype.type(0.0))
