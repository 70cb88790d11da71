"""Semantic-version parsing + constraint checking.

Capability parity with hashicorp/go-version as used by
reference scheduler/feasible.go:303-347 ("version" constraint operand).
Also provides the int64 encoding the constraint compiler uses to make
version comparisons device-executable (nomad_tpu_torch/models/constraints.py).
"""
from __future__ import annotations

import re
from typing import Optional

_VERSION_RE = re.compile(
    r"^v?(\d+(?:\.\d+)*)([-.]?(?:[a-zA-Z][0-9A-Za-z.-]*))?$")

# Segment width for the int64 packing: supports versions up to .99999 per
# segment, 3 segments.  Pre-release versions subtract 1 so "1.0.0-beta" <
# "1.0.0", matching semver ordering.
_SEG = 100000


def parse_version(s: str) -> Optional[tuple]:
    """Parse to ((major, minor, patch), prerelease) or None if invalid."""
    m = _VERSION_RE.match(s.strip())
    if not m:
        return None
    nums = [int(x) for x in m.group(1).split(".")][:3]
    while len(nums) < 3:
        nums.append(0)
    pre = (m.group(2) or "").lstrip("-.")
    return tuple(nums), pre


def encode_version(s: str) -> Optional[int]:
    """Pack a version into a comparable int64 (device-side representation)."""
    parsed = parse_version(s)
    if parsed is None:
        return None
    (major, minor, patch), pre = parsed
    if major >= _SEG or minor >= _SEG or patch >= _SEG:
        return None
    packed = (major * _SEG + minor) * _SEG + patch
    packed *= 2
    if pre:
        packed -= 1  # prerelease sorts just below the release
    return packed


def _sort_key(parsed: tuple) -> tuple:
    """Total order matching semver closely enough for constraints: release
    sorts above any prerelease of the same base; prereleases compare
    lexically."""
    nums, pre = parsed
    return (nums, 1, "") if not pre else (nums, 0, pre)


def _cmp(a: str, b: str) -> Optional[int]:
    pa, pb = parse_version(a), parse_version(b)
    if pa is None or pb is None:
        return None
    ka, kb = _sort_key(pa), _sort_key(pb)
    return (ka > kb) - (ka < kb)


_CONSTRAINT_RE = re.compile(r"^\s*(>=|<=|!=|~>|=|>|<)?\s*([\w.+-]+)\s*$")


def parse_constraint(spec: str) -> Optional[list]:
    """Parse "">= 1.0, < 1.4"" into [(op, version), ...].  Each rhs must
    itself parse as a version (go-version's NewConstraint rejects
    unparseable versions at parse time — without this, ">= banana"
    would validate clean and then silently never match any node)."""
    out = []
    for clause in spec.split(","):
        m = _CONSTRAINT_RE.match(clause)
        if not m:
            return None
        if parse_version(m.group(2)) is None:
            return None
        out.append((m.group(1) or "=", m.group(2)))
    return out


def check_constraint(version_str: str, spec: str) -> bool:
    """Does version_str satisfy the constraint set?  Invalid input -> False."""
    clauses = parse_constraint(spec)
    if clauses is None:
        return False
    for op, rhs in clauses:
        if op == "~>":
            # Pessimistic: >= rhs and < next increment of rhs's second-to-
            # last specified segment ("~> 1.2.3" -> >=1.2.3 <1.3.0).
            parsed = parse_version(rhs)
            if parsed is None:
                return False
            segs = rhs.split("-")[0].lstrip("v").split(".")
            try:
                nums = [int(x) for x in segs]
            except ValueError:
                return False  # e.g. "~> 1.2beta": not a valid pessimistic spec
            if len(nums) == 1:
                upper_nums = [nums[0] + 1]
            else:
                upper_nums = nums[:-2] + [nums[-2] + 1, 0]
            upper = ".".join(str(x) for x in upper_nums)
            c1, c2 = _cmp(version_str, rhs), _cmp(version_str, upper)
            if c1 is None or c2 is None or c1 < 0 or c2 >= 0:
                return False
            continue
        c = _cmp(version_str, rhs)
        if c is None:
            return False
        ok = {
            "=": c == 0,
            "!=": c != 0,
            ">": c > 0,
            ">=": c >= 0,
            "<": c < 0,
            "<=": c <= 0,
        }[op]
        if not ok:
            return False
    return True
