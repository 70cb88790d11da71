"""Constraint predicate primitives shared by the sequential scheduler and the
constraint-mask compiler.

Capability parity with reference scheduler/feasible.go:226-376
(resolveConstraintTarget + checkConstraint).  Both execution paths — the lazy
ConstraintIterator and the vectorized mask compiler — call these exact
functions, so parity between them holds by construction.

The ``ctx`` argument only needs ``regexp_cache`` / ``constraint_cache`` dict
attributes (EvalContext provides them; the mask compiler passes its own).
"""
from __future__ import annotations

import re

from .versions import check_constraint as check_version_constraint


def resolve_constraint_target(target: str, node):
    """Interpolate $node.*, $attr.*, $meta.*; literals pass through.

    Returns (value, ok) (reference: feasible.go:226-256).
    """
    if not target.startswith("$"):
        return target, True
    if target == "$node.id":
        return node.id, True
    if target == "$node.datacenter":
        return node.datacenter, True
    if target == "$node.name":
        return node.name, True
    if target.startswith("$attr."):
        key = target[len("$attr."):]
        if key in node.attributes:
            return node.attributes[key], True
        return None, False
    if target.startswith("$meta."):
        key = target[len("$meta."):]
        if key in node.meta:
            return node.meta[key], True
        return None, False
    return None, False


def check_constraint_values(ctx, operand: str, l_val, r_val) -> bool:
    """Evaluate one operand against resolved values (feasible.go:259-376)."""
    if operand in ("=", "==", "is"):
        return l_val == r_val
    if operand in ("!=", "not"):
        return l_val != r_val
    if operand in ("<", "<=", ">", ">="):
        return _check_lexical_order(operand, l_val, r_val)
    if operand == "version":
        return _check_version(ctx, l_val, r_val)
    if operand == "regexp":
        return _check_regexp(ctx, l_val, r_val)
    return False


def _check_lexical_order(op: str, l_val, r_val) -> bool:
    if not isinstance(l_val, str) or not isinstance(r_val, str):
        return False
    return {
        "<": l_val < r_val,
        "<=": l_val <= r_val,
        ">": l_val > r_val,
        ">=": l_val >= r_val,
    }[op]


def _check_version(ctx, l_val, r_val) -> bool:
    if isinstance(l_val, int):
        l_val = str(l_val)
    if not isinstance(l_val, str) or not isinstance(r_val, str):
        return False
    cache = ctx.constraint_cache
    result = cache.get((l_val, r_val))
    if result is None:
        result = check_version_constraint(l_val, r_val)
        cache[(l_val, r_val)] = result
    return result


def _check_regexp(ctx, l_val, r_val) -> bool:
    if not isinstance(l_val, str) or not isinstance(r_val, str):
        return False
    cache = ctx.regexp_cache
    pattern = cache.get(r_val)
    if pattern is None:
        try:
            pattern = re.compile(r_val)
        except re.error:
            return False
        cache[r_val] = pattern
    return pattern.search(l_val) is not None
