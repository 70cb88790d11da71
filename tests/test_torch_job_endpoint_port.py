"""The port's job endpoints over its ``InprocRPC``: twins of
tests/test_job_endpoint_port.py on ``nomad_tpu_torch`` (a CPU server).

Port of the reference job endpoint table (nomad/job_endpoint_test.go,
v0.1.2): register / re-register / deregister / evaluate over the wire
method table — asserting raft-index stamping, eval minting, and the
outstanding-token fence on eval updates.

Rides the same in-proc RPC rig as tests/test_node_endpoint_port.py, so
every call crosses the full endpoint chain (forwarding, admission,
blocking-query plumbing) rather than poking the server directly.
"""
from __future__ import annotations

import pytest

import nomad_tpu_torch.mock as mock
from nomad_tpu_torch.agent.agent import InprocRPC
from nomad_tpu_torch.server import Server, ServerConfig


@pytest.fixture
def rig():
    srv = Server(ServerConfig(device="cpu", num_schedulers=0,
                              tune_gc=False))
    srv.establish_leadership()
    rpc = InprocRPC(srv)
    yield srv, rpc
    srv.shutdown()


def _register(rpc, job):
    return rpc.call("Job.Register", {"job": job.to_dict()})


class TestJobRegister:
    def test_register_stamps_index_and_mints_eval(self, rig):
        """TestJobEndpoint_Register: the response carries the raft index
        (doubling as the job's modify index), the job lands in state
        stamped with it, and a job-register eval exists."""
        srv, rpc = rig
        job = mock.job()
        resp = _register(rpc, job)
        assert resp["index"] > 0
        assert resp["job_modify_index"] == resp["index"]
        out = srv.fsm.state.job_by_id(job.id)
        assert out is not None
        assert out.create_index == resp["index"]
        assert out.modify_index == resp["index"]
        ev = srv.fsm.state.eval_by_id(resp["eval_id"])
        assert ev is not None
        assert ev.triggered_by == "job-register"
        assert ev.job_id == job.id
        assert ev.job_modify_index == resp["index"]
        assert ev.priority == job.priority
        # The eval write is itself a raft entry, after the job's.
        assert ev.create_index > resp["index"]

    def test_register_invalid_job_errors(self, rig):
        _srv, rpc = rig
        job = mock.job()
        job.id = ""
        with pytest.raises(ValueError, match="missing job id"):
            _register(rpc, job)

    def test_reregister_bumps_modify_preserves_create(self, rig):
        """TestJobEndpoint_Register_Existing: updating a job advances
        modify_index (the version bump) but keeps create_index, and
        mints a fresh eval for the new version."""
        srv, rpc = rig
        job = mock.job()
        first = _register(rpc, job)
        job.priority = job.priority + 1
        second = _register(rpc, job)
        assert second["index"] > first["index"]
        assert second["eval_id"] != first["eval_id"]
        out = srv.fsm.state.job_by_id(job.id)
        assert out.create_index == first["index"]
        assert out.modify_index == second["index"]
        assert out.priority == job.priority
        ev = srv.fsm.state.eval_by_id(second["eval_id"])
        assert ev.job_modify_index == second["index"]


class TestJobDeregister:
    def test_deregister_removes_job_and_mints_eval(self, rig):
        """TestJobEndpoint_Deregister: the job is gone from state and a
        job-deregister eval (carrying the dead job's priority) exists so
        the scheduler reaps its allocations."""
        srv, rpc = rig
        job = mock.job()
        _register(rpc, job)
        resp = rpc.call("Job.Deregister", {"job_id": job.id})
        assert resp["index"] > 0
        assert srv.fsm.state.job_by_id(job.id) is None
        ev = srv.fsm.state.eval_by_id(resp["eval_id"])
        assert ev is not None
        assert ev.triggered_by == "job-deregister"
        assert ev.job_id == job.id
        assert ev.priority == job.priority


class TestJobEvaluate:
    def test_evaluate_mints_eval_for_existing_job(self, rig):
        """TestJobEndpoint_Evaluate: forces a fresh evaluation of a
        registered job without changing it."""
        srv, rpc = rig
        job = mock.job()
        reg = _register(rpc, job)
        resp = rpc.call("Job.Evaluate", {"job_id": job.id})
        assert resp["eval_id"] != reg["eval_id"]
        ev = srv.fsm.state.eval_by_id(resp["eval_id"])
        assert ev is not None
        assert ev.triggered_by == "job-register"
        assert ev.job_modify_index == reg["index"]

    def test_evaluate_missing_job_errors(self, rig):
        _srv, rpc = rig
        with pytest.raises(KeyError, match="job not found"):
            rpc.call("Job.Evaluate", {"job_id": "no-such-job"})


class TestEvalTokenFence:
    def test_outstanding_eval_rejects_mismatched_token(self, rig):
        """eval_endpoint.go:123-143 via the job path: once a worker holds
        the minted eval, updates without its token are fenced off."""
        srv, rpc = rig
        job = mock.job()
        resp = _register(rpc, job)
        ev, token = srv.eval_broker.dequeue([job.type], timeout=5)
        assert ev is not None and ev.id == resp["eval_id"]
        ev.status = "complete"
        with pytest.raises(PermissionError, match="token"):
            srv.apply_eval_update([ev], token="bogus-token")
        index = srv.apply_eval_update([ev], token=token)
        assert index > resp["index"]
        assert srv.fsm.state.eval_by_id(ev.id).status == "complete"


class TestJobQueries:
    def test_get_list_allocations_evaluations(self, rig):
        srv, rpc = rig
        job = mock.job()
        reg = _register(rpc, job)
        got = rpc.call("Job.GetJob", {"job_id": job.id})
        assert got["job"]["id"] == job.id
        assert rpc.call("Job.GetJob", {"job_id": "nope"})["job"] is None
        listed = rpc.call("Job.List", {})
        assert [j["id"] for j in listed["jobs"]] == [job.id]
        alloc = mock.alloc()
        alloc.job = job
        alloc.job_id = job.id
        idx = srv.raft.applied_index()
        srv.fsm.state.upsert_allocs(idx + 1, [alloc])
        allocs = rpc.call("Job.Allocations", {"job_id": job.id})
        assert [a["id"] for a in allocs["allocations"]] == [alloc.id]
        evals = rpc.call("Job.Evaluations", {"job_id": job.id})
        assert reg["eval_id"] in [e["id"] for e in evals["evaluations"]]
