"""The core-scheduler GC table of tests/test_core_sched_port.py (the
reference's core_sched_test.go) against the port's server/core_sched.py.

Eval GC (thresholds, alloc gating, partial batches), node GC (down and
empty vs. pinned vs. alive, thresholds) and force GC (threshold
bypass), on a port server on the CPU.  The JAX table's
System.GarbageCollect endpoint case needs the RPC plane, which the port
has not ported; ``test_force_gc_core_eval_through_the_workers`` drives
the same force-GC core eval through the broker and a plain worker
instead.
"""
from __future__ import annotations

import time

import pytest

import nomad_tpu_torch.mock as mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.core_sched import CoreScheduler
from nomad_tpu_torch.structs import (
    CORE_JOB_EVAL_GC,
    CORE_JOB_FORCE_GC,
    CORE_JOB_NODE_GC,
    NODE_STATUS_DOWN,
    Evaluation,
    codec,
    generate_uuid,
)
from tests.conftest import wait_until


def make_server(**kw) -> Server:
    kw.setdefault("num_schedulers", 0)
    kw.setdefault("device", "cpu")
    kw.setdefault("tune_gc", False)
    srv = Server(ServerConfig(**kw))
    srv.establish_leadership()
    return srv


def _core_eval(job_id: str) -> Evaluation:
    return Evaluation(id=generate_uuid(), type="_core", job_id=job_id)


def _insert_eval(srv, status: str = "complete") -> str:
    ev = mock.eval()
    ev.status = status
    srv.raft_apply(codec.EVAL_UPDATE_REQUEST, {"evals": [ev.to_dict()]})
    return ev.id


def _insert_alloc(srv, eval_id: str, desired: str = "stop",
                  node_id: str = "foo") -> str:
    a = mock.alloc()
    a.eval_id = eval_id
    a.node_id = node_id
    a.desired_status = desired
    srv.raft_apply(codec.ALLOC_UPDATE_REQUEST, {"alloc": [a.to_dict()]})
    return a.id


def _age_everything(srv) -> None:
    """Make the timetable call every current index old (bypasses the
    5-minute witness granularity, reference test's fake time advance)."""
    srv.fsm.timetable.granularity = 0.0
    srv.fsm.timetable.witness(srv.raft.applied_index() + 1, time.time())


def _run_gc(srv, job_id: str) -> None:
    CoreScheduler(srv, srv.fsm.state.snapshot()).process(_core_eval(job_id))


class TestEvalGC:
    def test_reaps_old_terminal_eval_and_allocs(self):
        """core_sched_test.go TestCoreScheduler_EvalGC: a terminal eval
        past the threshold goes, and its terminal allocs go with it."""
        srv = make_server(eval_gc_threshold=0.0)
        try:
            eid = _insert_eval(srv)
            aid = _insert_alloc(srv, eid)
            _age_everything(srv)
            _run_gc(srv, CORE_JOB_EVAL_GC)
            assert srv.fsm.state.eval_by_id(eid) is None
            assert srv.fsm.state.alloc_by_id(aid) is None
        finally:
            srv.shutdown()

    def test_threshold_keeps_young_evals(self):
        """An eval younger than eval_gc_threshold survives even though
        it is terminal."""
        srv = make_server(eval_gc_threshold=3600.0)
        try:
            eid = _insert_eval(srv)
            _age_everything(srv)  # witnesses are recent: cutoff finds none
            _run_gc(srv, CORE_JOB_EVAL_GC)
            assert srv.fsm.state.eval_by_id(eid) is not None
        finally:
            srv.shutdown()

    def test_non_terminal_eval_survives(self):
        srv = make_server(eval_gc_threshold=0.0)
        try:
            eid = _insert_eval(srv, status="pending")
            _age_everything(srv)
            _run_gc(srv, CORE_JOB_EVAL_GC)
            assert srv.fsm.state.eval_by_id(eid) is not None
        finally:
            srv.shutdown()

    def test_live_alloc_pins_its_eval(self):
        """A terminal eval with a non-terminal alloc stays — collecting
        it would orphan a running allocation's bookkeeping."""
        srv = make_server(eval_gc_threshold=0.0)
        try:
            eid = _insert_eval(srv)
            aid = _insert_alloc(srv, eid, desired="run")
            _age_everything(srv)
            _run_gc(srv, CORE_JOB_EVAL_GC)
            assert srv.fsm.state.eval_by_id(eid) is not None
            assert srv.fsm.state.alloc_by_id(aid) is not None
        finally:
            srv.shutdown()

    def test_partial_batch(self):
        """core_sched_test.go TestCoreScheduler_EvalGC_Partial: in one
        GC round, the collectable eval (terminal, terminal allocs) goes
        while the pinned eval (live alloc) and ALL its allocs stay."""
        srv = make_server(eval_gc_threshold=0.0)
        try:
            gone = _insert_eval(srv)
            gone_alloc = _insert_alloc(srv, gone)
            kept = _insert_eval(srv)
            kept_live = _insert_alloc(srv, kept, desired="run")
            kept_dead = _insert_alloc(srv, kept)  # rides its eval's fate
            _age_everything(srv)
            _run_gc(srv, CORE_JOB_EVAL_GC)
            state = srv.fsm.state
            assert state.eval_by_id(gone) is None
            assert state.alloc_by_id(gone_alloc) is None
            assert state.eval_by_id(kept) is not None
            assert state.alloc_by_id(kept_live) is not None
            assert state.alloc_by_id(kept_dead) is not None
        finally:
            srv.shutdown()


class TestNodeGC:
    def _down(self, srv, node) -> None:
        srv.raft_apply(codec.NODE_UPDATE_STATUS_REQUEST,
                       {"node_id": node.id, "status": NODE_STATUS_DOWN})

    def test_reaps_old_down_empty_node(self):
        srv = make_server(node_gc_threshold=0.0)
        try:
            node = mock.node(1)
            srv.node_register(node)
            self._down(srv, node)
            _age_everything(srv)
            _run_gc(srv, CORE_JOB_NODE_GC)
            assert srv.fsm.state.node_by_id(node.id) is None
        finally:
            srv.shutdown()

    def test_terminal_allocs_do_not_pin_node(self):
        """core_sched_test.go TestCoreScheduler_NodeGC_TerminalAllocs:
        only non-terminal allocs keep a down node registered."""
        srv = make_server(node_gc_threshold=0.0)
        try:
            node = mock.node(1)
            srv.node_register(node)
            eid = _insert_eval(srv)
            _insert_alloc(srv, eid, desired="stop", node_id=node.id)
            self._down(srv, node)
            _age_everything(srv)
            _run_gc(srv, CORE_JOB_NODE_GC)
            assert srv.fsm.state.node_by_id(node.id) is None
        finally:
            srv.shutdown()

    def test_running_allocs_pin_node(self):
        """core_sched_test.go TestCoreScheduler_NodeGC_RunningAllocs."""
        srv = make_server(node_gc_threshold=0.0)
        try:
            node = mock.node(1)
            srv.node_register(node)
            eid = _insert_eval(srv)
            aid = _insert_alloc(srv, eid, desired="run", node_id=node.id)
            self._down(srv, node)
            _age_everything(srv)
            _run_gc(srv, CORE_JOB_NODE_GC)
            assert srv.fsm.state.node_by_id(node.id) is not None
            assert srv.fsm.state.alloc_by_id(aid) is not None
        finally:
            srv.shutdown()

    def test_ready_node_survives(self):
        srv = make_server(node_gc_threshold=0.0)
        try:
            node = mock.node(1)
            srv.node_register(node)
            _age_everything(srv)
            _run_gc(srv, CORE_JOB_NODE_GC)
            assert srv.fsm.state.node_by_id(node.id) is not None
        finally:
            srv.shutdown()

    def test_threshold_keeps_young_down_node(self):
        srv = make_server(node_gc_threshold=24 * 3600.0)
        try:
            node = mock.node(1)
            srv.node_register(node)
            self._down(srv, node)
            _age_everything(srv)
            _run_gc(srv, CORE_JOB_NODE_GC)
            assert srv.fsm.state.node_by_id(node.id) is not None
        finally:
            srv.shutdown()


class TestForceGC:
    def test_force_bypasses_both_thresholds(self):
        """One force-gc core eval collects the terminal eval AND the
        down node despite day-long thresholds and no timetable aging."""
        srv = make_server(eval_gc_threshold=3600.0,
                          node_gc_threshold=24 * 3600.0)
        try:
            eid = _insert_eval(srv)
            aid = _insert_alloc(srv, eid)
            node = mock.node(1)
            srv.node_register(node)
            srv.raft_apply(codec.NODE_UPDATE_STATUS_REQUEST,
                           {"node_id": node.id,
                            "status": NODE_STATUS_DOWN})
            _run_gc(srv, CORE_JOB_FORCE_GC)
            state = srv.fsm.state
            assert state.eval_by_id(eid) is None
            assert state.alloc_by_id(aid) is None
            assert state.node_by_id(node.id) is None
        finally:
            srv.shutdown()

    def test_unknown_core_job_rejected(self):
        srv = make_server()
        try:
            with pytest.raises(ValueError):
                _run_gc(srv, "not-a-core-job")
        finally:
            srv.shutdown()


class TestCoreEvalThroughWorkers:
    def test_force_gc_core_eval_through_the_workers(self):
        """The leader's core-eval path end to end: a ``_core`` force-GC
        eval enqueued on the broker is dequeued by a plain worker,
        which runs the CoreScheduler and acks; the terminal eval and
        the down node are collected through raft."""
        srv = make_server(num_schedulers=2)
        try:
            eid = _insert_eval(srv)
            node = mock.node(1)
            srv.node_register(node)
            srv.raft_apply(codec.NODE_UPDATE_STATUS_REQUEST,
                           {"node_id": node.id,
                            "status": NODE_STATUS_DOWN})
            srv._enqueue_core_eval(CORE_JOB_FORCE_GC)
            wait_until(lambda: srv.fsm.state.eval_by_id(eid) is None
                       and srv.fsm.state.node_by_id(node.id) is None,
                       msg="force GC through the workers")
            wait_until(lambda: srv.eval_broker.stats()["acks"] >= 1,
                       msg="core eval acked")
            assert srv._worker_stats()["failures"] == 0
        finally:
            srv.shutdown()
