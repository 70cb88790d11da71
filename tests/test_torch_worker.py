"""The worker table of tests/test_worker_port.py (the reference's
worker_test.go scenarios) against the port's server/worker.py.

The same scenarios as the JAX package's table, on a port server on the
CPU (``ServerConfig(device="cpu")``): dequeue, invoke and ack; a
scheduler crash nacks to the failed queue; the plan wait; raft
catch-up; plan submission with token fencing and state refresh; and the
token-fenced eval writes.  None of them needs the RPC plane.
"""
from __future__ import annotations

import threading
import time

import pytest

import nomad_tpu_torch.mock as mock
from tests.conftest import wait_until
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.worker import Worker
from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    Allocation,
    Evaluation,
    Plan,
    Resources,
    generate_uuid,
)


def make_eval(job_id=None, type_="service") -> Evaluation:
    return Evaluation(
        id=generate_uuid(), priority=50, type=type_,
        job_id=job_id or generate_uuid(), status="pending",
        triggered_by="job-register",
    )


def make_server(**kw) -> Server:
    srv = Server(ServerConfig(device="cpu", num_schedulers=0,
                              tune_gc=False, **kw))
    srv.establish_leadership()
    return srv


def place_plan(node, ev, token, cpu=1000) -> Plan:
    plan = Plan(eval_id=ev.id, eval_token=token)
    plan.append_alloc(Allocation(
        id=generate_uuid(), node_id=node.id, job_id=ev.job_id,
        task_group="web", resources=Resources(cpu=cpu, memory_mb=256),
        desired_status=ALLOC_DESIRED_STATUS_RUN,
        client_status=ALLOC_CLIENT_STATUS_PENDING,
    ))
    return plan


class TestDequeueAck:
    def test_dequeue_invoke_ack(self):
        """TestWorker_dequeueEvaluation + sendAck: the loop drains a
        ready eval to a terminal status and leaves nothing unacked."""
        srv = make_server()
        try:
            ev = make_eval()
            srv.apply_eval_update([ev])
            w = Worker(srv)
            w.start()
            try:
                wait_until(
                    lambda: (srv.fsm.state.eval_by_id(ev.id) or ev
                             ).status == "complete",
                    msg="worker completes eval")
                wait_until(
                    lambda: srv.eval_broker.stats()[
                        "total_unacked"] == 0,
                    msg="eval acked")
            finally:
                w.stop()
        finally:
            srv.shutdown()

    def test_shutdown_stops_loop(self):
        """TestWorker_dequeueEvaluation_shutdown: stop() ends the run
        loop even with an empty queue."""
        srv = make_server()
        try:
            w = Worker(srv)
            w.start()
            w.stop()
            w._thread.join(timeout=5)
            assert not w._thread.is_alive()
        finally:
            srv.shutdown()

    def test_scheduler_crash_nacks_to_failed_status(self, monkeypatch):
        """TestWorker_invalidateEval: a crashing scheduler nacks; past
        the delivery limit the broker routes the eval to `_failed`,
        where the leader's reaper marks it terminally failed with the
        delivery-limit description."""
        srv = make_server(eval_nack_timeout=5.0, eval_delivery_limit=2)
        try:
            import nomad_tpu_torch.server.worker as worker_mod

            def boom(name, state, planner):
                raise RuntimeError("scheduler exploded")

            monkeypatch.setattr(worker_mod, "new_scheduler", boom)
            ev = make_eval()
            srv.apply_eval_update([ev])
            w = Worker(srv)
            w.start()
            try:
                wait_until(
                    lambda: (srv.fsm.state.eval_by_id(ev.id) or ev
                             ).status == "failed",
                    msg="eval failed after delivery limit")
                got = srv.fsm.state.eval_by_id(ev.id)
                assert "delivery limit" in got.status_description
                assert srv.eval_broker.stats()["total_unacked"] == 0
            finally:
                w.stop()
        finally:
            srv.shutdown()


class TestWaitPlan:
    def test_responded_timeout_error_propagates_not_spins(self):
        """A plan RESPONDED with a TimeoutError result (e.g. a raft
        apply timeout surfaced through the applier) must re-raise to
        the worker, not be mistaken for the poll expiring — that
        mistake zero-sleep spun _wait_plan forever (code-review
        regression)."""
        from nomad_tpu_torch.server.plan_queue import PlanFuture

        srv = make_server()
        try:
            srv.plan_queue.set_enabled(True)
            w = Worker(srv)
            future = PlanFuture(mock.plan())
            future.respond(None, TimeoutError("raft apply timed out"))
            start = time.monotonic()
            with pytest.raises(TimeoutError, match="raft apply"):
                w._wait_plan(future)
            # Propagated immediately — not after a poll interval, and
            # certainly not never.
            assert time.monotonic() - start < 1.0
        finally:
            srv.shutdown()

    def test_respond_racing_poll_expiry_returns_result(self):
        """respond(result) landing between the poll's TimeoutError and
        the done() check must surface the RESULT, not the spurious poll
        error — a committed plan reported as failed would be retried
        and double-place (code-review regression)."""
        srv = make_server()
        try:
            w = Worker(srv)

            class ScriptedFuture:
                """First wait raises like an expired poll; by then the
                applier has responded."""

                def __init__(self, result):
                    self._result = result
                    self._calls = 0

                def wait(self, timeout=None):
                    self._calls += 1
                    if self._calls == 1:
                        raise TimeoutError("poll expired")
                    return self._result

                def done(self):
                    return True

            sentinel = object()
            assert w._wait_plan(ScriptedFuture(sentinel)) is sentinel
        finally:
            srv.shutdown()


class TestWaitForIndex:
    def test_returns_when_index_lands_mid_wait(self):
        """TestWorker_waitForIndex: an apply landing WHILE the worker
        waits releases it (raft catch-up, worker.go:209-230)."""
        srv = make_server()
        try:
            w = Worker(srv)
            target = srv.raft.applied_index() + 1

            def apply_later():
                time.sleep(0.1)  # sleep-ok: delayed apply exercises mid-wait wakeup
                srv.apply_eval_update([make_eval()])

            t = threading.Thread(target=apply_later)
            t.start()
            w._wait_for_index(target, timeout=5.0)  # must not raise
            t.join()
            assert srv.raft.applied_index() >= target
        finally:
            srv.shutdown()

    def test_timeout(self):
        srv = make_server()
        try:
            w = Worker(srv)
            with pytest.raises(TimeoutError):
                w._wait_for_index(srv.raft.applied_index() + 100,
                                  timeout=0.15)
        finally:
            srv.shutdown()


class TestSubmitPlan:
    def _outstanding_eval(self, srv):
        ev = make_eval()
        srv.apply_eval_update([ev])
        got, token = srv.eval_broker.dequeue(["service"], timeout=2)
        assert got.id == ev.id
        return got, token

    def test_submit_plan_commits(self):
        """TestWorker_SubmitPlan: full commit — result carries the
        commit index, no refreshed state handed back."""
        srv = make_server()
        try:
            node = mock.node()
            srv.node_register(node)
            ev, token = self._outstanding_eval(srv)
            w = Worker(srv)
            w.eval_token = token
            plan = place_plan(node, ev, "")  # worker stamps the token
            result, state = w.submit_plan(plan)
            assert plan.eval_token == token, "worker must stamp token"
            assert state is None
            assert result.alloc_index > 0
            assert srv.fsm.state.allocs_by_node(node.id)
        finally:
            srv.shutdown()

    def test_submit_plan_rejection_returns_fresh_state(self):
        """TestWorker_SubmitPlan_MissingNodeRefresh: a plan touching a
        node the applier can't verify comes back empty with a caught-up
        snapshot so the scheduler retries against fresh data."""
        srv = make_server()
        try:
            srv.node_register(mock.node())  # nodes table index > 0
            ev, token = self._outstanding_eval(srv)
            w = Worker(srv)
            w.eval_token = token
            ghost = mock.node()  # never registered
            result, state = w.submit_plan(place_plan(ghost, ev, ""))
            assert result.node_allocation == {}
            assert result.refresh_index > 0
            assert state is not None
            assert state.node_by_id(ghost.id) is None
        finally:
            srv.shutdown()

    def test_submit_plan_invalid_token_fenced(self):
        """A stale/wrong token is refused by the applier before
        touching state (split-brain fence, plan_apply.go:53-65)."""
        srv = make_server()
        try:
            node = mock.node()
            srv.node_register(node)
            ev, _token = self._outstanding_eval(srv)
            w = Worker(srv)
            w.eval_token = "not-the-token"
            with pytest.raises(RuntimeError, match="token does not"):
                w.submit_plan(place_plan(node, ev, ""))
            assert not srv.fsm.state.allocs_by_node(node.id)
        finally:
            srv.shutdown()


class TestEvalWrites:
    def test_update_eval_persists_through_raft(self):
        """TestWorker_UpdateEval: the worker's status write lands in
        the FSM under its delivery token."""
        srv = make_server()
        try:
            ev = make_eval()
            srv.apply_eval_update([ev])
            got, token = srv.eval_broker.dequeue(["service"], timeout=2)
            w = Worker(srv)
            w.eval_token = token
            done = got.copy()
            done.status = "complete"
            w.update_eval(done)
            assert srv.fsm.state.eval_by_id(ev.id).status == "complete"
        finally:
            srv.shutdown()

    def test_update_eval_wrong_token_rejected(self):
        """An outstanding eval may only be updated by its holder."""
        srv = make_server()
        try:
            ev = make_eval()
            srv.apply_eval_update([ev])
            got, _token = srv.eval_broker.dequeue(["service"], timeout=2)
            w = Worker(srv)
            w.eval_token = "imposter"
            done = got.copy()
            done.status = "complete"
            with pytest.raises(PermissionError):
                w.update_eval(done)
        finally:
            srv.shutdown()

    def test_create_eval_enqueues_follow_up(self):
        """TestWorker_CreateEval: a follow-up eval (rolling-update
        stagger) written by the worker reaches the broker as pending
        work for its job."""
        srv = make_server()
        try:
            ev = make_eval()
            srv.apply_eval_update([ev])
            got, token = srv.eval_broker.dequeue(["service"], timeout=2)
            w = Worker(srv)
            w.eval_token = token
            follow = make_eval(job_id=got.job_id)
            follow.previous_eval = got.id
            w.create_eval(follow)
            assert srv.fsm.state.eval_by_id(follow.id) is not None
            # Same job, earlier eval outstanding: serialized behind it.
            srv.eval_broker.ack(got.id, token)
            nxt, _ = srv.eval_broker.dequeue(["service"], timeout=2)
            assert nxt.id == follow.id
        finally:
            srv.shutdown()
