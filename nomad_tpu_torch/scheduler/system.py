"""System scheduler: run a job on every feasible node.

Capability parity with reference scheduler/system_sched.go.  The port's
copy of nomad_tpu/scheduler/system.py: the sequential iterator-chain
scheduler, registered as ``system-seq`` (``system`` is the vectorized
one, system_vec.py).
"""
from __future__ import annotations

import logging
from typing import Optional

from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_FAILED,
    ALLOC_DESIRED_STATUS_RUN,
    ALLOC_DESIRED_STATUS_STOP,
    EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_NODE_UPDATE,
    Allocation,
    Evaluation,
    filter_terminal_allocs,
    generate_uuid,
)

from .context import EvalContext
from .interfaces import SetStatusError
from .stack import SystemStack
from .util import (
    ALLOC_NOT_NEEDED,
    ALLOC_UPDATING,
    diff_system_allocs,
    evict_and_place,
    inplace_update,
    ready_nodes_in_dcs,
    retry_max,
    set_status,
    tainted_nodes,
)

MAX_SYSTEM_SCHEDULE_ATTEMPTS = 5

logger = logging.getLogger("nomad_tpu_torch.scheduler.system")


class SystemScheduler:
    def __init__(self, state, planner) -> None:
        self.state = state
        self.planner = planner

        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[SystemStack] = None
        self.nodes: list = []
        self.limit_reached = False
        self.next_eval: Optional[Evaluation] = None

    def process(self, ev: Evaluation) -> None:
        self.eval = ev

        if ev.triggered_by not in (EVAL_TRIGGER_JOB_REGISTER,
                                   EVAL_TRIGGER_NODE_UPDATE,
                                   EVAL_TRIGGER_JOB_DEREGISTER):
            set_status(self.planner, ev, self.next_eval, EVAL_STATUS_FAILED,
                       f"scheduler cannot handle '{ev.triggered_by}' "
                       "evaluation reason")
            return

        try:
            retry_max(MAX_SYSTEM_SCHEDULE_ATTEMPTS, self._process)
        except SetStatusError as e:
            set_status(self.planner, ev, self.next_eval, e.eval_status,
                       str(e))
            return

        set_status(self.planner, ev, self.next_eval, EVAL_STATUS_COMPLETE)

    def _process(self) -> bool:
        self.job = self.state.job_by_id(self.eval.job_id)
        self.nodes = ready_nodes_in_dcs(self.state, self.job.datacenters) \
            if self.job is not None else []

        self.plan = self.eval.make_plan(self.job)
        self.ctx = EvalContext(self.state, self.plan, logger)
        self.stack = SystemStack(self.ctx)
        if self.job is not None:
            self.stack.set_job(self.job)

        self._compute_job_allocs()

        if self.plan.is_noop():
            return True

        if self.limit_reached and self.next_eval is None:
            self.next_eval = self.eval.next_rolling_eval(
                self.job.update.stagger)
            self.planner.create_eval(self.next_eval)

        result, new_state = self.planner.submit_plan(self.plan)
        if new_state is not None:
            self.state = new_state
            return False

        full_commit, expected, actual = result.full_commit(self.plan)
        if not full_commit:
            logger.debug("eval %s: attempted %d placements, %d placed",
                         self.eval.id, expected, actual)
            return False
        return True

    def _compute_job_allocs(self, allocs: Optional[list] = None) -> None:
        if allocs is None:
            allocs = filter_terminal_allocs(
                self.state.allocs_by_job(self.eval.job_id))
        tainted = tainted_nodes(self.state, allocs)

        diff = diff_system_allocs(self.job, self.nodes, tainted, allocs)

        for tup in diff.stop:
            self.plan.append_update(tup.alloc, ALLOC_DESIRED_STATUS_STOP,
                                    ALLOC_NOT_NEEDED)

        diff.update = inplace_update(self.ctx, self.eval, self.job,
                                     self.stack, diff.update)

        limit = [len(diff.update)]
        if self.job is not None and self.job.update.rolling():
            limit = [self.job.update.max_parallel]
        self.limit_reached = evict_and_place(
            self.ctx, diff, diff.update, ALLOC_UPDATING, limit)

        if diff.place:
            self._compute_placements(diff.place)

    def _compute_placements(self, place: list) -> None:
        node_by_id = {n.id: n for n in self.nodes}
        failed_tg: dict = {}

        for missing in place:
            node = node_by_id.get(missing.alloc.node_id)
            if node is None:
                raise KeyError(
                    f"could not find node {missing.alloc.node_id!r}")

            self.stack.set_nodes([node])
            option, size = self.stack.select(missing.task_group)

            if option is None:
                prior_fail = failed_tg.get(id(missing.task_group))
                if prior_fail is not None:
                    prior_fail.metrics.coalesced_failures += 1
                    continue

            alloc = Allocation(
                id=generate_uuid(),
                eval_id=self.eval.id,
                name=missing.name,
                job_id=self.job.id,
                job=self.job,
                task_group=missing.task_group.name,
                resources=size,
                metrics=self.ctx.metrics(),
            )
            if option is not None:
                alloc.node_id = option.node.id
                alloc.task_resources = option.task_resources
                alloc.desired_status = ALLOC_DESIRED_STATUS_RUN
                alloc.client_status = ALLOC_CLIENT_STATUS_PENDING
                self.plan.append_alloc(alloc)
            else:
                alloc.desired_status = ALLOC_DESIRED_STATUS_FAILED
                alloc.desired_description = \
                    "failed to find a node for placement"
                alloc.client_status = ALLOC_CLIENT_STATUS_FAILED
                self.plan.append_failed(alloc)
                failed_tg[id(missing.task_group)] = alloc


def new_system_scheduler(state, planner) -> SystemScheduler:
    return SystemScheduler(state, planner)
