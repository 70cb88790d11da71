"""Scheduler contracts + registry.

Capability parity with reference scheduler/scheduler.go:13-87: the
scheduler layer is pure business logic behind two tiny seams — ``State`` (a
read snapshot) and ``Planner`` (submit plan / update + create eval).  All
plumbing (raft, queues, RPC) stays outside.  The registry carries the built-in
``service``/``batch`` schedulers plus the device backend
``torch-binpack``, dispatched identically.
"""
from __future__ import annotations

from typing import Callable, Optional, Protocol

from nomad_tpu_torch.structs import Allocation, Evaluation, Job, Node, Plan, PlanResult


class State(Protocol):
    """Immutable view of global state available to schedulers."""

    def nodes(self) -> list: ...
    def allocs_by_job(self, job_id: str) -> list: ...
    def allocs_by_node(self, node_id: str) -> list: ...
    def node_by_id(self, node_id: str) -> Optional[Node]: ...
    def job_by_id(self, job_id: str) -> Optional[Job]: ...


class Planner(Protocol):
    """Plan submission seam implemented by the worker (and test Harness)."""

    def submit_plan(self, plan: Plan) -> tuple[PlanResult, Optional[State]]: ...
    def update_eval(self, ev: Evaluation) -> None: ...
    def create_eval(self, ev: Evaluation) -> None: ...


class Scheduler(Protocol):
    def process(self, ev: Evaluation) -> None: ...


class SetStatusError(Exception):
    """Raised to set the evaluation status on unrecoverable failure."""

    def __init__(self, msg: str, eval_status: str) -> None:
        super().__init__(msg)
        self.eval_status = eval_status


Factory = Callable[[State, Planner], Scheduler]

BUILTIN_SCHEDULERS: dict[str, Factory] = {}


def register_scheduler(name: str, factory: Factory) -> None:
    BUILTIN_SCHEDULERS[name] = factory


def new_scheduler(name: str, state: State, planner: Planner) -> Scheduler:
    factory = BUILTIN_SCHEDULERS.get(name)
    if factory is None:
        raise ValueError(f"unknown scheduler {name!r}")
    return factory(state, planner)
