"""Generic scheduler for service + batch jobs.

Capability parity with reference scheduler/generic_sched.go:
reconcile job vs existing allocs, place/update/migrate/stop, retry on plan
conflict (5 attempts service / 2 batch), rolling-update limits with
follow-up evals.
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
    EVAL_TRIGGER_ROLLING_UPDATE,
    Allocation,
    Evaluation,
    filter_terminal_allocs,
    generate_uuid,
)

from .context import EvalContext
from .interfaces import SetStatusError
from .stack import GenericStack
from .util import (
    ALLOC_MIGRATING,
    ALLOC_NOT_NEEDED,
    ALLOC_UPDATING,
    diff_allocs,
    evict_and_place,
    inplace_update,
    materialize_task_groups,
    ready_nodes_in_dcs,
    retry_max,
    set_status,
    tainted_nodes,
)

MAX_SERVICE_SCHEDULE_ATTEMPTS = 5
MAX_BATCH_SCHEDULE_ATTEMPTS = 2

# Triggers the generic scheduler accepts (shared with the batch runner).
VALID_GENERIC_TRIGGERS = (
    EVAL_TRIGGER_JOB_REGISTER, EVAL_TRIGGER_NODE_UPDATE,
    EVAL_TRIGGER_JOB_DEREGISTER, EVAL_TRIGGER_ROLLING_UPDATE,
)

logger = logging.getLogger("nomad_tpu_torch.scheduler.generic")


class GenericScheduler:
    def __init__(self, state, planner, batch: bool) -> None:
        self.state = state
        self.planner = planner
        self.batch = batch

        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[GenericStack] = None
        self.limit_reached = False
        self.next_eval: Optional[Evaluation] = None

    # -- entry point ------------------------------------------------------
    def process(self, ev: Evaluation) -> None:
        self.eval = ev

        if ev.triggered_by not in VALID_GENERIC_TRIGGERS:
            set_status(self.planner, ev, self.next_eval, EVAL_STATUS_FAILED,
                       f"scheduler cannot handle '{ev.triggered_by}' "
                       "evaluation reason")
            return

        limit = MAX_BATCH_SCHEDULE_ATTEMPTS if self.batch else \
            MAX_SERVICE_SCHEDULE_ATTEMPTS
        try:
            retry_max(limit, self._process)
        except SetStatusError as e:
            set_status(self.planner, ev, self.next_eval, e.eval_status,
                       str(e))
            return

        set_status(self.planner, ev, self.next_eval, EVAL_STATUS_COMPLETE)

    # -- one attempt ------------------------------------------------------
    def _begin(self) -> None:
        """Reconcile phase: build plan/ctx/stack and compute job allocs.
        Split from submission so a batch driver can pause between the two
        (nomad_tpu_torch/scheduler/batch.py)."""
        self.job = self.state.job_by_id(self.eval.job_id)
        self.plan = self.eval.make_plan(self.job)
        self.ctx = EvalContext(self.state, self.plan, logger)
        self.stack = GenericStack(self.batch, self.ctx)
        if self.job is not None:
            self.stack.set_job(self.job)

        self._compute_job_allocs()

    def _process(self) -> bool:
        self._begin()
        return self._submit()

    def _submit(self) -> bool:
        done = self._submit_begin()
        if done is not None:
            return done
        result, new_state = self.planner.submit_plan(self.plan)
        return self._submit_finish(result, new_state)

    def _submit_begin(self) -> "Optional[bool]":
        """Pre-submission step: noop short-circuit + rolling-update
        follow-up eval.  Returns True when there is nothing to submit,
        None when the plan should go to the planner — split out so a
        window driver (scheduler/batch.py) can gather many plans and
        submit them as one group."""
        if self.plan.is_noop():
            return True

        # Rolling-update limit: schedule a follow-up eval after the stagger.
        if self.limit_reached and self.next_eval is None:
            self.next_eval = self.eval.next_rolling_eval(
                self.job.update.stagger)
            self.planner.create_eval(self.next_eval)
        return None

    def _submit_finish(self, result, new_state) -> bool:
        """Interpret one submitted plan's response (the post-submission
        half of ``_submit``)."""
        if new_state is not None:
            # Forced refresh: stale data, try again.
            self.state = new_state
            return False

        full_commit, expected, actual = result.full_commit(self.plan)
        if not full_commit:
            logger.debug("eval %s: attempted %d placements, %d placed",
                         self.eval.id, expected, actual)
            return False
        return True

    # -- reconciliation ---------------------------------------------------
    def _compute_job_allocs(self) -> None:
        groups = materialize_task_groups(self.job)

        allocs = self.state.allocs_by_job(self.eval.job_id)
        allocs = filter_terminal_allocs(allocs)

        tainted = tainted_nodes(self.state, allocs)
        diff = diff_allocs(self.job, tainted, groups, allocs,
                           cache_fresh=True)

        for tup in diff.stop:
            self.plan.append_update(tup.alloc, ALLOC_DESIRED_STATUS_STOP,
                                    ALLOC_NOT_NEEDED)

        diff.update = inplace_update(self.ctx, self.eval, self.job,
                                     self.stack, diff.update)

        limit = [len(diff.update) + len(diff.migrate)]
        if self.job is not None and self.job.update.rolling():
            limit = [self.job.update.max_parallel]

        self.limit_reached = evict_and_place(
            self.ctx, diff, diff.migrate, ALLOC_MIGRATING, limit)
        self.limit_reached = evict_and_place(
            self.ctx, diff, diff.update, ALLOC_UPDATING, limit) \
            or self.limit_reached

        if diff.place:
            self._compute_placements(diff.place)

    def _compute_placements(self, place: list) -> None:
        nodes = ready_nodes_in_dcs(self.state, self.job.datacenters)
        self.stack.set_nodes(nodes)

        failed_tg: dict = {}
        for missing in place:
            # Coalesce repeated failures of the same task group.
            prior_fail = failed_tg.get(id(missing.task_group))
            if prior_fail is not None:
                prior_fail.metrics.coalesced_failures += 1
                continue

            option, size = self.stack.select(missing.task_group)

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


def new_service_scheduler(state, planner) -> GenericScheduler:
    return GenericScheduler(state, planner, batch=False)


def new_batch_scheduler(state, planner) -> GenericScheduler:
    return GenericScheduler(state, planner, batch=True)
