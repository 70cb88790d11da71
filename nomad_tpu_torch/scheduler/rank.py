"""Ranking iterators: bin-packing + job anti-affinity.

Capability parity with reference scheduler/rank.go.  `score_fit` here
is the scalar path; nomad_tpu_torch/ops/binpack.py is the vectorized device path.
"""
from __future__ import annotations

from typing import Optional

from nomad_tpu_torch.structs import (
    Allocation,
    NetworkIndex,
    Node,
    Resources,
    Task,
    allocs_fit,
    score_fit,
)

from .context import EvalContext


class RankedNode:
    __slots__ = ("node", "score", "task_resources", "proposed")

    def __init__(self, node: Node) -> None:
        self.node = node
        self.score = 0.0
        self.task_resources: dict = {}
        self.proposed: Optional[list] = None

    def proposed_allocs(self, ctx: EvalContext) -> list:
        if self.proposed is None:
            self.proposed = ctx.proposed_allocs(self.node.id)
        return self.proposed

    def set_task_resources(self, task: Task, resources: Resources) -> None:
        self.task_resources[task.name] = resources


class FeasibleRankIterator:
    """Upgrades a feasibility iterator into the ranking chain."""

    def __init__(self, ctx: EvalContext, source) -> None:
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        return RankedNode(option)

    def reset(self) -> None:
        self.source.reset()


class StaticRankIterator:
    """Fixed list of ranked nodes; used in tests."""

    def __init__(self, ctx: EvalContext, nodes: list) -> None:
        self.ctx = ctx
        self.nodes = nodes
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[RankedNode]:
        n = len(self.nodes)
        if self.offset == n or self.seen == n:
            if self.seen != n:
                self.offset = 0
            else:
                return None
        option = self.nodes[self.offset]
        self.offset += 1
        self.seen += 1
        return option

    def reset(self) -> None:
        self.seen = 0


class BinPackIterator:
    """Scores nodes by BestFit-v3 after assigning network offers per task."""

    def __init__(self, ctx: EvalContext, source, evict: bool = False,
                 priority: int = 0) -> None:
        self.ctx = ctx
        self.source = source
        self.evict = evict
        self.priority = priority
        self.tasks: list = []

    def set_priority(self, p: int) -> None:
        self.priority = p

    def set_tasks(self, tasks: list) -> None:
        self.tasks = tasks

    def next(self) -> Optional[RankedNode]:
        while True:
            option = self.source.next()
            if option is None:
                return None

            proposed = option.proposed_allocs(self.ctx)

            # Index existing network usage
            net_idx = NetworkIndex()
            net_idx.set_node(option.node)
            net_idx.add_allocs(proposed)

            # Assign resources (and network offers) per task
            total = Resources()
            exhausted = False
            for task in self.tasks:
                task_resources = task.resources.copy()
                if task_resources.networks:
                    ask = task_resources.networks[0]
                    offer, err = net_idx.assign_network(ask)
                    if offer is None:
                        self.ctx.metrics().exhausted_node(
                            option.node, f"network: {err}")
                        exhausted = True
                        break
                    net_idx.add_reserved(offer)
                    task_resources.networks = [offer]
                option.set_task_resources(task, task_resources)
                total.add(task_resources)
            if exhausted:
                continue

            proposed = proposed + [Allocation(resources=total)]
            fit, dim, util = allocs_fit(option.node, proposed, net_idx)
            if not fit:
                self.ctx.metrics().exhausted_node(option.node, dim)
                continue

            fitness = score_fit(option.node, util)
            option.score += fitness
            self.ctx.metrics().score_node(option.node, "binpack", fitness)
            return option

    def reset(self) -> None:
        self.source.reset()


class JobAntiAffinityIterator:
    """Penalizes co-placement with allocs of the same job to spread load."""

    def __init__(self, ctx: EvalContext, source, penalty: float,
                 job_id: str = "") -> None:
        self.ctx = ctx
        self.source = source
        self.penalty = penalty
        self.job_id = job_id

    def set_job(self, job_id: str) -> None:
        self.job_id = job_id

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        proposed = option.proposed_allocs(self.ctx)
        collisions = sum(1 for a in proposed if a.job_id == self.job_id)
        if collisions > 0:
            penalty = -1.0 * collisions * self.penalty
            option.score += penalty
            self.ctx.metrics().score_node(
                option.node, "job-anti-affinity", penalty)
        return option

    def reset(self) -> None:
        self.source.reset()
