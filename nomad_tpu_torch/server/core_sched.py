"""Core scheduler: the internal "_core" admin scheduler (GC).

Capability parity with reference nomad/core_sched.go:15-188: eval GC
reaps terminal evaluations (and their terminal allocs) older than the
TimeTable cutoff; node GC deregisters down nodes with no remaining allocs.
Dispatched by workers exactly like user-facing schedulers, via core evals
the leader emits periodically (reference nomad/leader.go:171-199).
"""
from __future__ import annotations

import logging
import time

from nomad_tpu_torch.structs import (
    CORE_JOB_EVAL_GC,
    CORE_JOB_FORCE_GC,
    CORE_JOB_NODE_GC,
    Evaluation,
    codec,
)

logger = logging.getLogger("nomad_tpu_torch.server.core_sched")


class CoreScheduler:
    """Registered under eval type "_core"; JobID selects the task."""

    def __init__(self, server, snap) -> None:
        self.server = server
        self.snap = snap

    # Force GC runs the collectors with the age gate bypassed: any
    # terminal object is fair game regardless of modify_index
    # (reference uses math.MaxUint64 as the force threshold).
    FORCE_THRESHOLD = 2 ** 63

    def process(self, ev: Evaluation) -> None:
        if ev.job_id == CORE_JOB_EVAL_GC:
            self._eval_gc()
        elif ev.job_id == CORE_JOB_NODE_GC:
            self._node_gc()
        elif ev.job_id == CORE_JOB_FORCE_GC:
            self._eval_gc(force=True)
            self._node_gc(force=True)
        else:
            raise ValueError(
                f"core scheduler cannot handle job '{ev.job_id}'")

    def _eval_gc(self, force: bool = False) -> None:
        if force:
            old_threshold = self.FORCE_THRESHOLD
        else:
            tt = self.server.fsm.timetable
            cutoff = time.time() - self.server.config.eval_gc_threshold
            old_threshold = tt.nearest_index(cutoff)

        gc_evals, gc_allocs = [], []
        for ev in self.snap.evals():
            if not ev.terminal_status() or ev.modify_index > old_threshold:
                continue
            allocs = self.snap.allocs_by_eval(ev.id)
            if any(not a.terminal_status() or
                   a.modify_index > old_threshold for a in allocs):
                continue  # eval stays while its allocs are alive
            gc_evals.append(ev.id)
            gc_allocs.extend(a.id for a in allocs)

        if not gc_evals and not gc_allocs:
            return
        logger.debug("eval GC reaping %d evals, %d allocs",
                     len(gc_evals), len(gc_allocs))
        self.server.raft_apply(codec.EVAL_DELETE_REQUEST,
                               {"evals": gc_evals, "allocs": gc_allocs})

    def _node_gc(self, force: bool = False) -> None:
        if force:
            old_threshold = self.FORCE_THRESHOLD
        else:
            tt = self.server.fsm.timetable
            cutoff = time.time() - self.server.config.node_gc_threshold
            old_threshold = tt.nearest_index(cutoff)

        for node in self.snap.nodes():
            if not node.terminal_status() or \
                    node.modify_index > old_threshold:
                continue
            allocs = self.snap.allocs_by_node(node.id)
            if any(not a.terminal_status() for a in allocs):
                continue
            logger.debug("node GC deregistering %s", node.id)
            self.server.raft_apply(codec.NODE_DEREGISTER_REQUEST,
                                   {"node_id": node.id})
