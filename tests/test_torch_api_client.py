"""The port's API client against the port's dev agent (CPU): twins of
tests/test_api_client.py on ``nomad_tpu_torch``.

API client library suite (reference api/*_test.go): every typed
wrapper exercised against a live dev agent, plus QueryMeta plumbing.
The HTTP wire contracts live in test_http_api2; this file covers the
CLIENT-side surface the reference's api package tests."""
from __future__ import annotations

import pytest

from nomad_tpu_torch.api import APIError, QueryOptions
from nomad_tpu_torch.jobspec import parse
from tests.conftest import wait_until
from tests.test_torch_agent import boot_dev_agent

JOBSPEC = """
job "api-probe" {
    datacenters = ["dc1"]
    group "g" {
        count = 1
        task "t" {
            driver = "raw_exec"
            config {
                command = "/bin/sleep"
                args = "60"
            }
            resources {
                cpu = 50
                memory = 32
            }
        }
    }
}
"""


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    agent, client = boot_dev_agent(
        str(tmp_path_factory.mktemp("agent-api-client")))
    yield agent, client
    agent.shutdown()


@pytest.fixture
def job(rig):
    _agent, client = rig
    j = parse(JOBSPEC)
    resp = client.job_register(j)
    assert resp["eval_id"]
    yield j, resp["eval_id"]
    try:
        client.job_deregister(j.id)
    except APIError:
        pass


def test_jobs_surface(rig, job):
    _agent, client = rig
    j, eval_id = job
    jobs, meta = client.jobs_list()
    assert any(x.id == j.id for x in jobs)
    assert meta.last_index > 0

    info, _meta = client.job_info(j.id)
    assert info.id == j.id and info.task_groups[0].name == "g"

    wait_until(lambda: client.job_allocations(j.id)[0],
               msg="job allocations")
    allocs, _ = client.job_allocations(j.id)
    assert allocs[0].job_id == j.id

    evals, _ = client.job_evaluations(j.id)
    assert any(e.id == eval_id for e in evals)

    forced = client.job_evaluate(j.id)
    assert forced["eval_id"] and forced["eval_id"] != eval_id

    client.job_deregister(j.id)
    with pytest.raises(APIError):
        client.job_info(j.id)


def test_nodes_surface(rig):
    _agent, client = rig
    nodes, meta = client.nodes_list()
    assert nodes and meta.last_index > 0
    node_id = nodes[0].id

    info, _ = client.node_info(node_id)
    assert info.id == node_id and info.status == "ready"

    allocs, _ = client.node_allocations(node_id)
    assert isinstance(allocs, list)

    client.node_drain(node_id, True)
    info, _ = client.node_info(node_id)
    assert info.drain is True
    client.node_drain(node_id, False)
    info, _ = client.node_info(node_id)
    assert info.drain is False

    client.node_evaluate(node_id)
    with pytest.raises(APIError):
        client.node_info("definitely-not-a-node")


def test_evals_and_allocs_surface(rig, job):
    _agent, client = rig
    j, eval_id = job
    evs, _ = client.evaluations_list()
    assert any(e.id == eval_id for e in evs)

    ev, meta = client.eval_info(eval_id)
    assert ev.id == eval_id and meta.last_index > 0

    wait_until(lambda: client.eval_allocations(eval_id)[0],
               msg="eval allocations")
    allocs, _ = client.eval_allocations(eval_id)
    a_id = allocs[0].id

    listed, _ = client.allocations_list()
    assert any(a.id == a_id for a in listed)
    alloc, _ = client.alloc_info(a_id)
    assert alloc.id == a_id and alloc.job_id == j.id
    assert alloc.metrics is not None  # explainability travels the wire


def test_agent_and_status_surface(rig):
    agent, client = rig
    self_info = client.agent_self()
    assert "config" in self_info and "stats" in self_info

    members = client.agent_members()
    assert isinstance(members, list)

    leader = client.status_leader()
    assert leader  # dev agent leads itself
    peers = client.status_peers()
    assert isinstance(peers, list) and peers

    servers = client.agent_servers()
    assert isinstance(servers, list)


def test_query_options_stale_and_wait(rig, job):
    import time

    _agent, client = rig
    j, _eval_id = job
    _jobs, meta = client.jobs_list()
    # Already-satisfied index (1 <= current) returns promptly with data.
    t0 = time.monotonic()
    jobs, _m = client.jobs_list(QueryOptions(
        wait_index=1, wait_time=5.0, allow_stale=True))
    assert time.monotonic() - t0 < 2.0
    assert any(x.id == j.id for x in jobs)
    # Unsatisfied index genuinely blocks until wait_time elapses.
    t0 = time.monotonic()
    _jobs, meta2 = client.jobs_list(QueryOptions(
        wait_index=meta.last_index, wait_time=0.3))
    assert time.monotonic() - t0 >= 0.25
    assert meta2.last_index >= meta.last_index
