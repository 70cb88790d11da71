"""Constraint compilation: host predicates -> per-node boolean masks.

Nomad constraints are stringly-typed (=, !=, lexical order, semver,
regexp over arbitrary attrs — reference scheduler/feasible.go:259-376), so
they are not device work.  The design compiles each constraint ONCE per
fleet generation into a boolean mask over the node axis, evaluated host-side
with the exact same predicate functions the sequential scheduler uses (golden
parity by construction), then ships masks to the card where the kernels
just AND them in (SURVEY.md section 7, "Constraint vectorization").

Masks are cached in ``FleetStatics.mask_cache`` keyed by the constraint's
value tuple, so a 10k-node fleet pays the Python predicate walk once per
(constraint, fleet-generation), not once per placement.

``distinct_hosts`` is NOT compiled here — it depends on the in-flight plan,
so it is evaluated on device from the per-node same-job alloc count tensor.
"""
from __future__ import annotations

import numpy as np

from nomad_tpu_torch.structs import CONSTRAINT_DISTINCT_HOSTS, Constraint
from nomad_tpu_torch.utils.predicates import (
    check_constraint_values,
    resolve_constraint_target,
)

from .fleet import FleetStatics


class _MaskCtx:
    """Minimal EvalContext stand-in carrying the predicate caches."""

    __slots__ = ("regexp_cache", "constraint_cache")

    def __init__(self) -> None:
        self.regexp_cache: dict = {}
        self.constraint_cache: dict = {}


_mask_ctx = _MaskCtx()


def _constraint_key(c: Constraint) -> tuple:
    return ("c", c.l_target, c.operand, c.r_target)


def compile_constraint_mask(fleet: FleetStatics, c: Constraint) -> np.ndarray:
    """bool[n_pad] mask of nodes meeting one hard constraint."""
    key = _constraint_key(c)
    mask = fleet.mask_cache.get(key)
    if mask is not None:
        return mask

    mask = np.zeros(fleet.n_pad, dtype=bool)
    if fleet.uniform and fleet.n_real and _targets_uniform(c):
        # Uniform fleet (NodeSlab-backed, shared attributes/meta/class/
        # dc): the predicate's verdict on ONE representative row holds
        # for every row — O(1) instead of a 100k-1M-node Python walk.
        mask[:fleet.n_real] = _constraint_verdict(fleet.nodes[0], c)
    else:
        for i in range(fleet.n_real):
            mask[i] = _constraint_verdict(fleet.nodes[i], c)

    fleet.mask_cache[key] = mask
    return mask


# Interpolation targets that resolve PER ROW even on a uniform fleet:
# ids and names are dense slab columns, never template-shared.
# ($node.datacenter IS covered by the uniform flag — it is only set
# when the slab's rows share one datacenter string; $attr.*/$meta.*
# read the shared template; literals and unknown $-targets are
# row-independent by construction.)
_PER_ROW_TARGETS = ("$node.id", "$node.name")


def _targets_uniform(c: Constraint) -> bool:
    return c.l_target not in _PER_ROW_TARGETS and \
        c.r_target not in _PER_ROW_TARGETS


def _constraint_verdict(node, c: Constraint) -> bool:
    l_val, ok = resolve_constraint_target(c.l_target, node)
    if not ok:
        return False
    r_val, ok = resolve_constraint_target(c.r_target, node)
    if not ok:
        return False
    return check_constraint_values(_mask_ctx, c.operand, l_val, r_val)


def compile_driver_mask(fleet: FleetStatics, driver: str) -> np.ndarray:
    """bool[n_pad] mask of nodes whose 'driver.<name>' attr parses true."""
    key = ("d", driver)
    mask = fleet.mask_cache.get(key)
    if mask is not None:
        return mask

    attr = f"driver.{driver}"
    mask = np.zeros(fleet.n_pad, dtype=bool)
    rows = range(1) if fleet.uniform and fleet.n_real \
        else range(fleet.n_real)
    for i in rows:
        value = fleet.attr_rows[i].get(attr)
        if value is not None and \
                str(value).strip().lower() in ("1", "t", "true"):
            mask[i] = True
    if fleet.uniform and fleet.n_real:
        mask[:fleet.n_real] = mask[0]

    fleet.mask_cache[key] = mask
    return mask


def compile_dc_mask(fleet: FleetStatics, datacenters: list) -> np.ndarray:
    """bool[n_pad] mask of nodes in one of the job's datacenters."""
    key = ("dc", tuple(sorted(datacenters)))
    mask = fleet.mask_cache.get(key)
    if mask is not None:
        return mask

    dc_set = set(datacenters)
    mask = np.zeros(fleet.n_pad, dtype=bool)
    if fleet.uniform and fleet.n_real:
        mask[:fleet.n_real] = fleet.datacenters[0] in dc_set
    else:
        for i in range(fleet.n_real):
            mask[i] = fleet.datacenters[i] in dc_set

    fleet.mask_cache[key] = mask
    return mask


def group_mask_key(datacenters: list, job_constraints: list,
                   tg_constraints: list, drivers) -> tuple:
    """Value-semantic cache key for a composed group mask: two task groups
    with identical constraints/drivers/datacenters share one mask row (count
    expansion makes this the common case)."""
    cons = tuple(sorted(
        (c.l_target, c.operand, c.r_target)
        for c in job_constraints + tg_constraints
        if c.hard and c.operand != CONSTRAINT_DISTINCT_HOSTS))
    return (tuple(sorted(datacenters)), cons, tuple(sorted(drivers)))


def compile_group_mask(
    fleet: FleetStatics,
    datacenters: list,
    job_constraints: list,
    tg_constraints: list,
    drivers,
) -> tuple[np.ndarray, bool]:
    """Full static feasibility mask for one task group.

    AND of: ready, datacenter, job constraints, task-group+task constraints,
    driver presence — i.e. the entire feasibility half of the iterator chain
    (reference scheduler/stack.go:126-143) as one boolean vector.

    Returns (mask, distinct_hosts?) — distinct_hosts is resolved on device.
    """
    distinct = any(
        c.hard and c.operand == CONSTRAINT_DISTINCT_HOSTS
        for c in job_constraints + tg_constraints)
    key = ("g",) + group_mask_key(datacenters, job_constraints,
                                  tg_constraints, drivers)
    hit = fleet.mask_cache.get(key)
    if hit is not None:
        return hit, distinct

    mask = fleet.ready.copy()
    mask &= compile_dc_mask(fleet, datacenters)
    for c in job_constraints + tg_constraints:
        if not c.hard or c.operand == CONSTRAINT_DISTINCT_HOSTS:
            continue
        mask &= compile_constraint_mask(fleet, c)
    for driver in sorted(drivers):
        mask &= compile_driver_mask(fleet, driver)
    fleet.mask_cache[key] = mask
    return mask, distinct
