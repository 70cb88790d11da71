"""The heartbeat table of tests/test_heartbeat_port.py (the
reference's heartbeat_test.go) against the port's server/heartbeat.py,
on fake clocks: timers are inert records fired by hand, so the
TTL-expiry path (initialize-on-leadership, reset rate scaling,
invalidate -> node down -> node-update evals) runs without real timer
waits, on a port server on the CPU.
"""
from __future__ import annotations

import pytest

import nomad_tpu_torch.mock as mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.heartbeat import HeartbeatManager
from nomad_tpu_torch.structs import NODE_STATUS_DOWN


class FakeTimer:
    """Inert timer: records its TTL, fires only when told to."""

    def __init__(self, ttl, fn, args) -> None:
        self.ttl = ttl
        self.fn = fn
        self.args = args
        self.started = False
        self.cancelled = False

    def start(self) -> None:
        self.started = True

    def cancel(self) -> None:
        self.cancelled = True

    def fire(self) -> None:
        self.fn(*self.args)


@pytest.fixture
def srv():
    server = Server(ServerConfig(device="cpu", num_schedulers=0,
                                 tune_gc=False))
    server.establish_leadership()
    server.heartbeats = HeartbeatManager(server, timer_factory=FakeTimer)
    yield server
    server.heartbeats.clear()
    server.shutdown()


def _timer(hb, node_id):
    with hb._lock:
        return hb._timers.get(node_id)


class TestHeartbeatPort:
    def test_initialize_on_leadership(self, srv):
        """heartbeat_test.go TestInitializeHeartbeatTimers: every live
        node is re-armed at the failover TTL — a new leader can't know
        when the last heartbeats happened."""
        live = [mock.node(i) for i in range(3)]
        for node in live:
            srv.node_register(node)
        downed = mock.node(9)
        srv.node_register(downed)
        srv.node_update_status(downed.id, NODE_STATUS_DOWN)

        srv.heartbeats.initialize()
        assert srv.heartbeats.active() == len(live)
        for node in live:
            timer = _timer(srv.heartbeats, node.id)
            assert timer is not None and timer.started
            assert timer.ttl == srv.heartbeats.failover_ttl
        # Terminal nodes are not re-armed (they'd just re-invalidate).
        assert _timer(srv.heartbeats, downed.id) is None

    def test_reset_heartbeat_timer(self, srv):
        """TestHeartbeat_ResetHeartbeatTimer: a reset arms a timer at
        ttl+grace and returns the client's wait."""
        ttl = srv.heartbeats.reset_heartbeat_timer("n-1")
        assert ttl >= srv.heartbeats.min_ttl
        timer = _timer(srv.heartbeats, "n-1")
        assert timer is not None and timer.started
        assert timer.ttl == pytest.approx(ttl + srv.heartbeats.grace)

    def test_reset_renews_existing_timer(self, srv):
        """TestResetHeartbeatTimerLocked_Renew: resetting an armed node
        cancels the old timer and arms a fresh one."""
        srv.heartbeats.reset_heartbeat_timer("n-1")
        first = _timer(srv.heartbeats, "n-1")
        srv.heartbeats.reset_heartbeat_timer("n-1")
        second = _timer(srv.heartbeats, "n-1")
        assert second is not first
        assert first.cancelled and not second.cancelled
        assert srv.heartbeats.active() == 1

    @pytest.mark.parametrize("armed,expect_rate_bound", [
        (0, False),      # empty table: the floor dominates
        (100, False),    # 100 nodes / 50 per sec = 2s < 10s floor
        (1000, True),    # 20s > floor: rate bound dominates
        (5000, True),    # 100s
    ])
    def test_reset_ttl_rate_scaling(self, srv, armed, expect_rate_bound):
        """TestHeartbeat_ResetTTL table: ttl = max(n/max_rate, min_ttl)
        + jitter <= ttl/16, so aggregate heartbeat load stays under
        max_rate regardless of fleet size."""
        hb = srv.heartbeats
        with hb._lock:
            for i in range(armed):
                hb._timers[f"filler-{i}"] = FakeTimer(0, lambda: None, [])
        ttl = hb.reset_heartbeat_timer("n-probe")
        n = max(armed + (0 if armed else 0), 1)
        base = max(n / hb.max_rate, hb.min_ttl)
        assert base <= ttl <= base * (1 + 1 / 16)
        assert (base > hb.min_ttl) == expect_rate_bound

    def test_invalidate_marks_node_down_and_evaluates(self, srv):
        """TestHeartbeat_InvalidateHeartbeat: expiry forces the node
        down and spawns node-update evaluations for every job with
        allocs there."""
        node = mock.node(1)
        srv.node_register(node)
        alloc = mock.alloc()
        alloc.node_id = node.id
        srv.fsm.state.upsert_job(srv.raft.applied_index() + 1, alloc.job)
        srv.fsm.state.upsert_allocs(srv.raft.applied_index() + 2,
                                    [alloc])
        srv.heartbeats.reset_heartbeat_timer(node.id)

        _timer(srv.heartbeats, node.id).fire()  # the TTL "expires"

        assert srv.fsm.state.node_by_id(node.id).status == \
            NODE_STATUS_DOWN
        evs = [e for e in srv.fsm.state.evals()
               if e.triggered_by == "node-update"
               and e.node_id == node.id]
        assert len(evs) == 1
        assert evs[0].job_id == alloc.job_id
        # The fired timer is gone from the table.
        assert _timer(srv.heartbeats, node.id) is None

    def test_clear_cancels_everything(self, srv):
        """Leadership revoked: clear() cancels every armed timer so a
        follower never invalidates nodes (heartbeat.go ClearAll)."""
        timers = []
        for i in range(4):
            srv.heartbeats.reset_heartbeat_timer(f"n-{i}")
            timers.append(_timer(srv.heartbeats, f"n-{i}"))
        srv.heartbeats.clear()
        assert srv.heartbeats.active() == 0
        assert all(t.cancelled for t in timers)

    def test_invalidation_failure_does_not_unwind(self, srv):
        """heartbeat.go invalidateHeartbeat logs and moves on when the
        status write fails (here: unknown node) — the timer thread must
        never die on it."""
        srv.heartbeats.reset_heartbeat_timer("ghost-node")
        _timer(srv.heartbeats, "ghost-node").fire()  # must not raise
        assert _timer(srv.heartbeats, "ghost-node") is None
