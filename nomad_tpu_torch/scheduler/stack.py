"""Placement stacks: composed iterator chains.

Capability parity with reference scheduler/stack.go.  Generic =
random source -> job constraints -> drivers -> task-group constraints ->
bin-pack -> job anti-affinity -> limit(max(2, ceil(log2 N))) -> max-score;
System = static source -> constraints -> bin-pack, first fit.

The torch-binpack scheduler replaces `select` with a device dispatch but
keeps this exact pipeline semantics (see nomad_tpu_torch/scheduler/torch_binpack.py).
"""
from __future__ import annotations

import math
import time
from typing import Optional

from nomad_tpu_torch.structs import (
    CONSTRAINT_DISTINCT_HOSTS,
    Constraint,
    Job,
    Resources,
    TaskGroup,
)

from .context import EvalContext
from .feasible import ConstraintIterator, DriverIterator, StaticIterator, \
    new_random_iterator
from .rank import BinPackIterator, FeasibleRankIterator, \
    JobAntiAffinityIterator, RankedNode
from .select import LimitIterator, MaxScoreIterator
from .util import task_group_constraints

SERVICE_JOB_ANTI_AFFINITY_PENALTY = 10.0
BATCH_JOB_ANTI_AFFINITY_PENALTY = 5.0


def _bind_distinct_hosts(constraints: list, job_id: str) -> list:
    """Attach the job id to distinct_hosts constraints so the feasibility
    check can count proposed same-job allocs per node."""
    out = []
    for c in constraints:
        if c.operand == CONSTRAINT_DISTINCT_HOSTS and not c.r_target:
            c = c.copy()
            c.r_target = job_id
        out.append(c)
    return out


class GenericStack:
    """Stack for service/batch placements (quality over speed)."""

    def __init__(self, batch: bool, ctx: EvalContext, rng=None) -> None:
        self.batch = batch
        self.ctx = ctx
        self.rng = rng
        self.job_id = ""

        self.source = StaticIterator(ctx, [])
        self.job_constraint = ConstraintIterator(ctx, self.source)
        self.task_group_drivers = DriverIterator(ctx, self.job_constraint)
        self.task_group_constraint = ConstraintIterator(
            ctx, self.task_group_drivers)
        rank_source = FeasibleRankIterator(ctx, self.task_group_constraint)
        self.bin_pack = BinPackIterator(ctx, rank_source, evict=not batch,
                                        priority=0)
        penalty = BATCH_JOB_ANTI_AFFINITY_PENALTY if batch else \
            SERVICE_JOB_ANTI_AFFINITY_PENALTY
        self.job_anti_aff = JobAntiAffinityIterator(ctx, self.bin_pack,
                                                    penalty, "")
        self.limit = LimitIterator(ctx, self.job_anti_aff, 2)
        self.max_score = MaxScoreIterator(ctx, self.limit)

    def set_nodes(self, base_nodes: list) -> None:
        from .util import shuffle_nodes

        shuffle_nodes(base_nodes, self.rng)
        self.source.set_nodes(base_nodes)

        # Visit "enough": log2(N) candidates for service, 2 for batch
        # (power-of-two-choices).
        limit = 2
        n = len(base_nodes)
        if not self.batch and n > 0:
            limit = max(limit, math.ceil(math.log2(n)))
        self.limit.set_limit(limit)

    def set_job(self, job: Job) -> None:
        self.job_id = job.id
        self.job_constraint.set_constraints(
            _bind_distinct_hosts(job.constraints, job.id))
        self.bin_pack.set_priority(job.priority)
        self.job_anti_aff.set_job(job.id)

    def select(self, tg: TaskGroup) -> tuple[Optional[RankedNode], Resources]:
        self.max_score.reset()
        self.ctx.reset()
        start = time.perf_counter()

        tg_constr = task_group_constraints(tg)
        self.task_group_drivers.set_drivers(tg_constr.drivers)
        self.task_group_constraint.set_constraints(
            _bind_distinct_hosts(tg_constr.constraints, self.job_id))
        self.bin_pack.set_tasks(tg.tasks)

        option = self.max_score.next()

        if option is not None and \
                len(option.task_resources) != len(tg.tasks):
            for task in tg.tasks:
                option.set_task_resources(task, task.resources)

        self.ctx.metrics().allocation_time = time.perf_counter() - start
        return option, tg_constr.size


class SystemStack:
    """Stack for system placements: all nodes, first fit."""

    def __init__(self, ctx: EvalContext) -> None:
        self.ctx = ctx
        self.job_id = ""
        self.source = StaticIterator(ctx, [])
        self.job_constraint = ConstraintIterator(ctx, self.source)
        self.task_group_drivers = DriverIterator(ctx, self.job_constraint)
        self.task_group_constraint = ConstraintIterator(
            ctx, self.task_group_drivers)
        rank_source = FeasibleRankIterator(ctx, self.task_group_constraint)
        self.bin_pack = BinPackIterator(ctx, rank_source, evict=True,
                                        priority=0)

    def set_nodes(self, base_nodes: list) -> None:
        self.source.set_nodes(base_nodes)

    def set_job(self, job: Job) -> None:
        self.job_id = job.id
        self.job_constraint.set_constraints(
            _bind_distinct_hosts(job.constraints, job.id))
        self.bin_pack.set_priority(job.priority)

    def select(self, tg: TaskGroup) -> tuple[Optional[RankedNode], Resources]:
        self.bin_pack.reset()
        self.ctx.reset()
        start = time.perf_counter()

        tg_constr = task_group_constraints(tg)
        self.task_group_drivers.set_drivers(tg_constr.drivers)
        self.task_group_constraint.set_constraints(
            _bind_distinct_hosts(tg_constr.constraints, self.job_id))
        self.bin_pack.set_tasks(tg.tasks)

        option = self.bin_pack.next()

        if option is not None and \
                len(option.task_resources) != len(tg.tasks):
            for task in tg.tasks:
                option.set_task_resources(task, task.resources)

        self.ctx.metrics().allocation_time = time.perf_counter() - start
        return option, tg_constr.size
