"""Per-evaluation placement context.

Capability parity with reference scheduler/context.go: carries the
state snapshot, the in-flight plan, per-placement metrics, and the
regex/version-constraint caches.  ``proposed_allocs`` is the optimistic view:
existing allocs minus planned evictions plus planned placements.
"""
from __future__ import annotations

import logging
from typing import Optional

from nomad_tpu_torch.structs import (
    AllocMetric,
    Plan,
    filter_terminal_allocs,
    remove_allocs,
)

logger = logging.getLogger("nomad_tpu_torch.scheduler")


class EvalContext:
    def __init__(self, state, plan: Plan,
                 log: Optional[logging.Logger] = None) -> None:
        self._state = state
        self._plan = plan
        self._logger = log or logger
        self._metrics = AllocMetric()
        self.regexp_cache: dict = {}
        self.constraint_cache: dict = {}

    def state(self):
        return self._state

    def set_state(self, state) -> None:
        self._state = state

    def plan(self) -> Plan:
        return self._plan

    def logger(self) -> logging.Logger:
        return self._logger

    def metrics(self) -> AllocMetric:
        return self._metrics

    def reset(self) -> None:
        """Invoked after each placement: fresh metrics."""
        self._metrics = AllocMetric()

    def proposed_allocs(self, node_id: str) -> list:
        """Existing allocs - planned evictions + planned placements."""
        existing = filter_terminal_allocs(self._state.allocs_by_node(node_id))
        update = self._plan.node_update.get(node_id, [])
        proposed = remove_allocs(existing, update) if update else existing
        return list(proposed) + list(self._plan.node_allocation.get(node_id, []))
