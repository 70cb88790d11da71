"""Feasibility filtering: lazy node iterators.

Capability parity with reference scheduler/feasible.go.  These stay the
sequential truth; the device backend compiles the same predicates into per-node
boolean mask tensors (nomad_tpu_torch/models/constraints.py) and golden-parity
tests assert both agree node-for-node.
"""
from __future__ import annotations

from typing import Iterable, Optional

from nomad_tpu_torch.structs import CONSTRAINT_DISTINCT_HOSTS, Constraint, Node
from nomad_tpu_torch.utils.predicates import (  # noqa: F401 - re-exported API
    check_constraint_values,
    resolve_constraint_target,
)

from .context import EvalContext


class StaticIterator:
    """Yields nodes in fixed order; base of the System stack."""

    def __init__(self, ctx: EvalContext, nodes: Optional[list]) -> None:
        self.ctx = ctx
        self.nodes = nodes or []
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[Node]:
        n = len(self.nodes)
        if self.offset == n or self.seen == n:
            if self.seen != n:
                self.offset = 0
            else:
                return None
        option = self.nodes[self.offset]
        self.offset += 1
        self.seen += 1
        self.ctx.metrics().evaluate_node()
        return option

    def reset(self) -> None:
        self.seen = 0

    def set_nodes(self, nodes: list) -> None:
        self.nodes = nodes
        self.offset = 0
        self.seen = 0


def new_random_iterator(ctx: EvalContext, nodes: Optional[list],
                        rng=None) -> StaticIterator:
    """Fisher-Yates shuffle then static iteration; base of Generic stack."""
    from .util import shuffle_nodes

    nodes = nodes or []
    shuffle_nodes(nodes, rng)
    return StaticIterator(ctx, nodes)


class DriverIterator:
    """Filters nodes missing the task group's drivers ("driver.<name>"
    node attribute parse-bools to true)."""

    def __init__(self, ctx: EvalContext, source,
                 drivers: Optional[Iterable[str]] = None) -> None:
        self.ctx = ctx
        self.source = source
        self.drivers = set(drivers or ())

    def set_drivers(self, drivers: Iterable[str]) -> None:
        self.drivers = set(drivers)

    def next(self) -> Optional[Node]:
        while True:
            option = self.source.next()
            if option is None:
                return None
            if self._has_drivers(option):
                return option
            self.ctx.metrics().filter_node(option, "missing drivers")

    def reset(self) -> None:
        self.source.reset()

    def _has_drivers(self, node: Node) -> bool:
        for driver in self.drivers:
            value = node.attributes.get(f"driver.{driver}")
            if value is None:
                return False
            if str(value).strip().lower() not in ("1", "t", "true"):
                return False
        return True


class ConstraintIterator:
    """Filters nodes violating hard constraints."""

    def __init__(self, ctx: EvalContext, source,
                 constraints: Optional[list] = None) -> None:
        self.ctx = ctx
        self.source = source
        self.constraints = constraints or []

    def set_constraints(self, constraints: list) -> None:
        self.constraints = constraints

    def next(self) -> Optional[Node]:
        while True:
            option = self.source.next()
            if option is None:
                return None
            if self._meets_constraints(option):
                return option

    def reset(self) -> None:
        self.source.reset()

    def _meets_constraints(self, node: Node) -> bool:
        for c in self.constraints:
            if not self._meets_constraint(c, node):
                self.ctx.metrics().filter_node(
                    node, f"{c.l_target} {c.operand} {c.r_target}")
                return False
        return True

    def _meets_constraint(self, c: Constraint, node: Node) -> bool:
        if not c.hard:
            return True  # soft constraints only affect ranking
        return check_single_constraint(self.ctx, c, node)


def check_single_constraint(ctx, c: Constraint, node: Node) -> bool:
    """Evaluate one hard constraint against a node (reference:
    feasible.go:197-223,259-376)."""
    if c.operand == CONSTRAINT_DISTINCT_HOSTS:
        # Feasible iff no proposed alloc of this job is on the node.  The
        # job id is carried via r_target by the stack (forward-port of
        # Nomad's ProposedAllocConstraintIterator).
        job_id = c.r_target
        if not job_id:
            return True
        return all(a.job_id != job_id
                   for a in ctx.proposed_allocs(node.id))

    l_val, ok = resolve_constraint_target(c.l_target, node)
    if not ok:
        return False
    r_val, ok = resolve_constraint_target(c.r_target, node)
    if not ok:
        return False
    return check_constraint_values(ctx, c.operand, l_val, r_val)
