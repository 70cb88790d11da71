"""Scheduler test + bench harness.

Capability parity with the reference's Harness rig
(reference scheduler/scheduler_test.go:14-177): a real StateStore plus
an in-memory Planner that applies plans directly to state and records
Plans/Evals/CreateEvals; `RejectPlan` injects plan-rejection faults to
exercise the refresh/retry path.  This is the primary test loop for both
the sequential and the device schedulers.

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
