"""The port's node endpoints over its ``InprocRPC``: twins of
tests/test_node_endpoint_port.py on ``nomad_tpu_torch`` (a CPU server).

Port of the reference node endpoint table
(nomad/node_endpoint_test.go, v0.1.2): register / heartbeat /
deregister / status-transition behavior over the wire method table —
asserting heartbeat TTL responses and node-status transitions.

Every call here rides the full endpoint chain, which now includes the
overload admission wrapper (server/overload.py): node lifecycle is
system class and heartbeats ride the bypass lane, so this table is also
the regression net proving admission never starves node liveness —
including under a FORCED overload state (the last tests).
"""
from __future__ import annotations

import pytest

import nomad_tpu_torch.mock as mock
from nomad_tpu_torch.agent.agent import InprocRPC
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.overload import OVERLOAD
from nomad_tpu_torch.structs import (
    NODE_STATUS_DOWN,
    NODE_STATUS_INIT,
    NODE_STATUS_READY,
)


@pytest.fixture
def rig():
    srv = Server(ServerConfig(device="cpu", num_schedulers=0,
                              tune_gc=False))
    srv.establish_leadership()
    rpc = InprocRPC(srv)
    yield srv, rpc
    srv.shutdown()


def _register(rpc, node):
    return rpc.call("Node.Register", {"node": node.to_dict()})


class TestNodeRegister:
    def test_register_returns_index_and_ttl(self, rig):
        """TestClientEndpoint_Register: the response carries the raft
        index, a heartbeat TTL (leader only), and the node is in
        state."""
        srv, rpc = rig
        node = mock.node(1)
        resp = _register(rpc, node)
        assert resp["index"] > 0
        assert resp["heartbeat_ttl"] >= srv.heartbeats.min_ttl
        out = srv.fsm.state.node_by_id(node.id)
        assert out is not None
        assert out.status == NODE_STATUS_READY
        assert out.create_index == resp["index"]

    def test_register_missing_node_id_errors(self, rig):
        _srv, rpc = rig
        node = mock.node(1)
        node.id = ""
        with pytest.raises(ValueError, match="missing node ID"):
            _register(rpc, node)

    def test_register_missing_datacenter_errors(self, rig):
        _srv, rpc = rig
        node = mock.node(1)
        node.datacenter = ""
        with pytest.raises(ValueError, match="missing datacenter"):
            _register(rpc, node)

    def test_ready_register_with_allocs_creates_evals(self, rig):
        """node_endpoint.go:64-90: a (re-)registering ready node with
        schedulable work triggers node-update evaluations."""
        srv, rpc = rig
        node = mock.node(1)
        _register(rpc, node)
        alloc = mock.alloc()
        alloc.node_id = node.id
        idx = srv.raft.applied_index()
        srv.fsm.state.upsert_job(idx + 1, alloc.job)
        srv.fsm.state.upsert_allocs(idx + 2, [alloc])
        resp = _register(rpc, node)
        assert resp["eval_ids"], "re-register must evaluate node work"
        ev = srv.fsm.state.eval_by_id(resp["eval_ids"][0])
        assert ev is not None and ev.triggered_by == "node-update"
        assert ev.job_id == alloc.job_id

    def test_init_register_creates_no_evals(self, rig):
        _srv, rpc = rig
        node = mock.node(1)
        node.status = NODE_STATUS_INIT
        resp = _register(rpc, node)
        assert resp["eval_ids"] == []


class TestNodeHeartbeat:
    def test_heartbeat_resets_ttl(self, rig):
        """TestClientEndpoint_UpdateStatus_HeartbeatOnly shape: each
        heartbeat returns a fresh TTL and re-arms the timer."""
        srv, rpc = rig
        node = mock.node(1)
        _register(rpc, node)
        assert srv.heartbeats.active() == 1
        resp = rpc.call("Node.Heartbeat", {"node_id": node.id})
        assert resp["heartbeat_ttl"] >= srv.heartbeats.min_ttl
        assert srv.heartbeats.active() == 1

    def test_heartbeat_unknown_node_errors(self, rig):
        _srv, rpc = rig
        with pytest.raises(KeyError):
            rpc.call("Node.Heartbeat", {"node_id": "nope"})

    def test_update_status_ready_returns_ttl_down_does_not(self, rig):
        """TestClientEndpoint_UpdateStatus: only the ready transition
        re-arms a TTL; down marks the node and spawns evals."""
        srv, rpc = rig
        node = mock.node(1)
        _register(rpc, node)
        resp = rpc.call("Node.UpdateStatus",
                        {"node_id": node.id, "status": "ready"})
        assert resp["heartbeat_ttl"] > 0
        resp = rpc.call("Node.UpdateStatus",
                        {"node_id": node.id, "status": "down"})
        assert resp["heartbeat_ttl"] == 0.0
        assert srv.fsm.state.node_by_id(node.id).status == \
            NODE_STATUS_DOWN

    def test_update_status_invalid_errors(self, rig):
        _srv, rpc = rig
        node = mock.node(1)
        _register(rpc, node)
        with pytest.raises(ValueError, match="invalid node status"):
            rpc.call("Node.UpdateStatus",
                     {"node_id": node.id, "status": "sideways"})


class TestNodeDeregister:
    def test_deregister_removes_node(self, rig):
        """TestClientEndpoint_Deregister: the node leaves state and the
        index advances."""
        srv, rpc = rig
        node = mock.node(1)
        _register(rpc, node)
        resp = rpc.call("Node.Deregister", {"node_id": node.id})
        assert resp["index"] > 0
        assert srv.fsm.state.node_by_id(node.id) is None

    def test_deregister_with_allocs_creates_evals(self, rig):
        """node_endpoint.go: deregistering a node with live allocs must
        evaluate every affected job so its work is replaced."""
        srv, rpc = rig
        node = mock.node(1)
        _register(rpc, node)
        alloc = mock.alloc()
        alloc.node_id = node.id
        idx = srv.raft.applied_index()
        srv.fsm.state.upsert_job(idx + 1, alloc.job)
        srv.fsm.state.upsert_allocs(idx + 2, [alloc])
        rpc.call("Node.Deregister", {"node_id": node.id})
        evs = [e for e in srv.fsm.state.evals()
               if e.triggered_by == "node-update"
               and e.node_id == node.id]
        assert len(evs) == 1 and evs[0].job_id == alloc.job_id


class TestNodeQueries:
    def test_get_node_round_trip(self, rig):
        srv, rpc = rig
        node = mock.node(1)
        _register(rpc, node)
        resp = rpc.call("Node.GetNode", {"node_id": node.id})
        assert resp["node"]["id"] == node.id
        assert resp["index"] == srv.fsm.state.get_index("nodes")
        assert rpc.call("Node.GetNode",
                        {"node_id": "nope"})["node"] is None

    def test_get_allocs_and_list(self, rig):
        srv, rpc = rig
        node = mock.node(1)
        _register(rpc, node)
        alloc = mock.alloc()
        alloc.node_id = node.id
        srv.fsm.state.upsert_allocs(srv.raft.applied_index() + 1,
                                    [alloc])
        resp = rpc.call("Node.GetAllocs", {"node_id": node.id})
        assert [a["id"] for a in resp["allocs"]] == [alloc.id]
        resp = rpc.call("Node.List", {})
        assert [n["id"] for n in resp["nodes"]] == [node.id]


class TestAdmissionPath:
    """The new part of the chain: the whole table above already rides
    the admission wrapper; these pin the OVERLOAD-state behavior."""

    def test_node_lifecycle_survives_full_overload(self, rig):
        """Node register/heartbeat/status/deregister are system class
        and heartbeats bypass admission: a fully overloaded server
        still serves ALL of them — shedding liveness would amplify the
        overload into a TTL-expiry storm."""
        srv, rpc = rig
        srv.overload.force_state(OVERLOAD)
        node = mock.node(1)
        resp = _register(rpc, node)
        assert resp["heartbeat_ttl"] > 0
        assert rpc.call("Node.Heartbeat",
                        {"node_id": node.id})["heartbeat_ttl"] > 0
        rpc.call("Node.UpdateStatus",
                 {"node_id": node.id, "status": "ready"})
        rpc.call("Node.Deregister", {"node_id": node.id})
        assert srv.fsm.state.node_by_id(node.id) is None
        assert srv.overload.stats()["heartbeat_lane"] >= 1

    def test_job_submission_sheds_in_overload(self, rig):
        from nomad_tpu_torch.server.overload import ErrOverloaded

        srv, rpc = rig
        srv.overload.force_state(OVERLOAD)
        with pytest.raises(ErrOverloaded):
            rpc.call("Job.Register", {"job": mock.job().to_dict()})
        srv.overload.force_state(None)
        assert rpc.call("Job.Register",
                        {"job": mock.job().to_dict()})["eval_id"]
