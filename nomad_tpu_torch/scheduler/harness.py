"""Scheduler test + bench harness.

Capability parity with the reference's Harness rig
(reference scheduler/scheduler_test.go:14-177): a real StateStore plus
an in-memory Planner that applies plans directly to state and records
Plans/Evals/CreateEvals; `RejectPlan` injects plan-rejection faults to
exercise the refresh/retry path, and `VerifyingPlanner` puts the
leader's plan verification (partial accept + RefreshIndex, group
commit) between the schedulers and the store.  This is the primary test
loop for both the sequential and the device schedulers.

``Harness(device=None)`` computes on the card: ``device`` is handed to
the device schedulers it runs, ``None`` means ``cuda`` and raises
``RuntimeError`` when no CUDA device is present; tests pass
``device="cpu"``.
"""
from __future__ import annotations

import itertools
import threading
from typing import Optional

from nomad_tpu_torch.parallel.devices import resolve_device
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import Evaluation, Plan, PlanResult

from .interfaces import new_scheduler


class Harness:
    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self.state = StateStore()
        self.planner = None  # optional plan interceptor (e.g. RejectPlan)
        self.plans: list[Plan] = []
        self.evals: list[Evaluation] = []
        self.create_evals: list[Evaluation] = []
        self._lock = threading.Lock()
        self._next_index = itertools.count(1000)

    def next_index(self) -> int:
        return next(self._next_index)

    # -- Planner interface ------------------------------------------------
    def submit_plans(self, plans: list) -> list:
        """Group submit: one window of plans, results in plan order —
        identical to per-plan ``submit_plan`` calls in that order.
        Delegates to an interceptor's group path when it has one (the
        VerifyingPlanner's vectorized conflict window)."""
        with self._lock:
            self.plans.extend(plans)
        if self.planner is not None:
            group = getattr(self.planner, "submit_plans", None)
            if group is not None:
                return group(plans)
            return [self.planner.submit_plan(p) for p in plans]
        return [self._apply_direct(p) for p in plans]

    def submit_plan(self, plan: Plan) -> tuple[PlanResult, Optional[object]]:
        with self._lock:
            self.plans.append(plan)

        if self.planner is not None:
            return self.planner.submit_plan(plan)
        return self._apply_direct(plan)

    def _apply_direct(self, plan: Plan
                      ) -> tuple[PlanResult, Optional[object]]:
        """Apply the full plan directly to the state store."""
        index = self.next_index()
        allocs = []
        for updates in plan.node_update.values():
            allocs.extend(updates)
        for placements in plan.node_allocation.values():
            allocs.extend(placements)
        allocs.extend(plan.failed_allocs)
        self.state.upsert_allocs(index, allocs)

        result = PlanResult(
            node_update=plan.node_update,
            node_allocation=plan.node_allocation,
            failed_allocs=plan.failed_allocs,
            alloc_index=index,
        )
        return result, None

    def update_eval(self, ev: Evaluation) -> None:
        with self._lock:
            self.evals.append(ev)

    def create_eval(self, ev: Evaluation) -> None:
        with self._lock:
            self.create_evals.append(ev)

    # -- driving ----------------------------------------------------------
    def process(self, scheduler_name: str, ev: Evaluation) -> None:
        sched = new_scheduler(scheduler_name, self.state.snapshot(), self)
        sched.process(ev)

    def snapshot(self):
        return self.state.snapshot()


class RejectPlan:
    """Planner that rejects every plan with a state refresh, simulating
    leader-side plan rejection (fault injection for the retry path)."""

    def __init__(self, harness: Harness) -> None:
        self.harness = harness

    def submit_plan(self, plan: Plan):
        result = PlanResult(refresh_index=self.harness.state.latest_index())
        return result, self.harness.state.snapshot()

    def update_eval(self, ev: Evaluation) -> None:
        pass

    def create_eval(self, ev: Evaluation) -> None:
        pass


class VerifyingPlanner:
    """Leader plan-applier semantics over a Harness: verify each node's
    placements against live state (partial accept + RefreshIndex,
    server/plan_apply.evaluate_plan), commit only the accepted portion,
    and hand back a fresh snapshot when the scheduler must retry — the
    serialization point optimistic eval storms rely on in the real
    server.  Computes on its harness's ``device``: under the ``device``
    verify policy (ops/verify_policy.py) each window's base fit runs in
    the window-verify kernel there."""

    def __init__(self, h: Harness) -> None:
        self.h = h
        self.conflicts = 0  # plans that came back partial/rejected
        # Group-commit observability:
        self.commits = 0            # commit operations (group or single)
        self.committed_plans = 0    # plans those commits carried
        self.conflict_fallbacks = 0  # window plans needing the exact
        #                              per-plan walk (prefix conflicts)

    @property
    def device(self):
        return self.h.device

    def submit_plans(self, plans: list):
        """Group-commit twin of per-plan ``submit_plan``: one vectorized
        cross-plan conflict window (ops/plan_conflict.evaluate_window)
        plus ONE batched store upsert, with one index consumed per plan
        — results and final state identical to calling ``submit_plan``
        per plan in order."""
        from nomad_tpu_torch.ops.plan_conflict import (_accepted_allocs,
                                                       evaluate_window)

        with self.h._lock:
            # devlint-ok(transfer-under-lock): the harness lock IS the
            # rig's serialization point (verify+commit must be atomic
            # for concurrent fuzz submitters); the device verify's
            # counted window-descriptor fetch under it is test-rig-only
            # — the real applier verifies on its own single thread.
            outcomes = evaluate_window(self.h.state, plans,
                                       device=self.device)
            items = []
            out = []
            for outcome in outcomes:
                result = outcome.result
                allocs = _accepted_allocs(result)
                index = self.h.next_index()
                if allocs:
                    items.append((index, allocs))
                result.alloc_index = index
                if result.refresh_index:
                    self.conflicts += 1
                if outcome.fallback:
                    self.conflict_fallbacks += 1
                out.append(result)
            if items:
                self.h.state.upsert_allocs_batched(items)
                self.commits += 1
                self.committed_plans += len(items)
        # ONE post-commit snapshot shared by every refreshing plan —
        # the same view a retrying scheduler would get from the
        # sequential path's state_refresh hook.
        refreshed = None
        results = []
        for r in out:
            if r.refresh_index and refreshed is None:
                refreshed = self.h.state.snapshot()
            results.append((r, refreshed if r.refresh_index else None))
        return results

    def submit_plan(self, plan: Plan):
        from nomad_tpu_torch.ops.plan_conflict import _accepted_allocs
        from nomad_tpu_torch.server.plan_apply import evaluate_plan

        # No h.plans bookkeeping here: when reached through
        # Harness.submit_plan (h.planner delegation) the harness has
        # already recorded the plan.
        with self.h._lock:
            result = evaluate_plan(self.h.state, plan)
            allocs = _accepted_allocs(result)
            index = self.h.next_index()
            if allocs:
                self.h.state.upsert_allocs(index, allocs)
                self.commits += 1
                self.committed_plans += 1
            result.alloc_index = index
            if result.refresh_index:
                self.conflicts += 1
        state = self.h.state.snapshot() if result.refresh_index else None
        return result, state

    def update_eval(self, ev: Evaluation) -> None:
        self.h.update_eval(ev)

    def create_eval(self, ev: Evaluation) -> None:
        self.h.create_eval(ev)
