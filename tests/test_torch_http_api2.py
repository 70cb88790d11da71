"""The port's HTTP surface (a CPU dev agent): twins of
tests/test_http_api2.py on ``nomad_tpu_torch``.

Second HTTP-surface suite: the wire-level contracts the reference
asserts in command/agent/http_test.go and the per-endpoint method
tables of {job,node,eval,alloc}_endpoint_test.go — response headers
(X-Nomad-Index), JSON content type, ?pretty, bad ?wait/?index -> 400,
405s, job update/delete/force-evaluate, node drain/evaluate via HTTP,
and unknown-region errors."""
from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

from nomad_tpu_torch.jobspec import parse
from tests.conftest import wait_until
from tests.test_torch_agent import boot_dev_agent

JOBSPEC = """
job "pings" {
    datacenters = ["dc1"]
    group "g" {
        count = 1
        task "t" {
            driver = "raw_exec"
            config {
                command = "/bin/sleep"
                args = "120"
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
def agent(tmp_path_factory):
    a, _client = boot_dev_agent(
        str(tmp_path_factory.mktemp("agent-http2")))
    yield a
    a.shutdown()


def _url(agent, path):
    return f"http://127.0.0.1:{agent.http.address[1]}{path}"


def _req(agent, path, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(_url(agent, path), data=data,
                                 method=method)
    try:
        resp = urllib.request.urlopen(req, timeout=10)
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _register(agent):
    job = parse(JOBSPEC)
    code, _h, raw = _req(agent, "/v1/jobs", "PUT",
                         {"job": job.to_dict()})
    assert code == 200, raw
    return job, json.loads(raw)


# ---------------------------------------------------------------------------
# wire-level contracts (http_test.go:48-160)
# ---------------------------------------------------------------------------

def test_content_type_and_index_header(agent):
    code, headers, raw = _req(agent, "/v1/nodes")
    assert code == 200
    assert headers.get("Content-Type", "").startswith("application/json")
    assert int(headers.get("X-Nomad-Index", "0")) > 0
    assert isinstance(json.loads(raw), list)


def test_pretty_print(agent):
    _code, _h, plain = _req(agent, "/v1/nodes")
    _code, _h, pretty = _req(agent, "/v1/nodes?pretty=1")
    assert b"\n" in pretty and len(pretty) > len(plain)
    assert json.loads(pretty) == json.loads(plain)


def test_invalid_wait_and_index_are_400(agent):
    code, _h, _raw = _req(agent, "/v1/nodes?wait=nope")
    assert code == 400
    code, _h, _raw = _req(agent, "/v1/nodes?index=abc")
    assert code == 400


def test_unknown_path_404(agent):
    code, _h, _raw = _req(agent, "/v1/nonsense")
    assert code == 404
    code, _h, _raw = _req(agent, "/notv1")
    assert code == 404


def test_method_not_allowed_405(agent):
    code, _h, _raw = _req(agent, "/v1/jobs", "DELETE")
    assert code == 405


def test_unknown_region_errors(agent):
    code, _h, raw = _req(agent, "/v1/nodes?region=mars")
    assert code == 500
    assert b"region" in raw.lower()


# ---------------------------------------------------------------------------
# job endpoint methods (job_endpoint_test.go:59-340)
# ---------------------------------------------------------------------------

def test_job_register_query_update_delete(agent):
    job, reg = _register(agent)
    assert reg["eval_id"]

    code, _h, raw = _req(agent, f"/v1/job/{job.id}")
    assert code == 200
    got = json.loads(raw)
    assert got["id"] == job.id

    # Update: re-register with a different count through PUT /v1/job/<id>.
    job.task_groups[0].count = 2
    code, _h, raw = _req(agent, f"/v1/job/{job.id}", "PUT",
                         {"job": job.to_dict()})
    assert code == 200
    code, _h, raw = _req(agent, f"/v1/job/{job.id}")
    assert json.loads(raw)["task_groups"][0]["count"] == 2

    # Evaluations + allocations sub-endpoints list this job's records.
    def evals_listed():
        _c, _h, r = _req(agent, f"/v1/job/{job.id}/evaluations")
        return len(json.loads(r)) >= 1
    wait_until(evals_listed, msg="job evaluations")

    def allocs_listed():
        _c, _h, r = _req(agent, f"/v1/job/{job.id}/allocations")
        return len(json.loads(r)) >= 1
    wait_until(allocs_listed, msg="job allocations")

    # Force evaluate mints a fresh eval.
    code, _h, raw = _req(agent, f"/v1/job/{job.id}/evaluate", "PUT", {})
    assert code == 200
    assert json.loads(raw)["eval_id"]

    # Delete deregisters; the job disappears.
    code, _h, _raw = _req(agent, f"/v1/job/{job.id}", "DELETE")
    assert code == 200
    wait_until(lambda: _req(agent, f"/v1/job/{job.id}")[0] == 404,
               msg="job deregistered")


def test_job_query_missing_404(agent):
    code, _h, _raw = _req(agent, "/v1/job/no-such-job")
    assert code == 404


# ---------------------------------------------------------------------------
# node endpoint methods (node_endpoint_test.go:59-256)
# ---------------------------------------------------------------------------

def test_node_query_allocations_drain_evaluate(agent):
    _code, _h, raw = _req(agent, "/v1/nodes")
    nodes = json.loads(raw)
    assert nodes, "dev agent registers one node"
    node_id = nodes[0]["id"]

    code, _h, raw = _req(agent, f"/v1/node/{node_id}")
    assert code == 200 and json.loads(raw)["id"] == node_id

    code, _h, raw = _req(agent, f"/v1/node/{node_id}/allocations")
    assert code == 200 and isinstance(json.loads(raw), list)

    code, _h, raw = _req(agent, f"/v1/node/{node_id}/evaluate", "PUT")
    assert code == 200

    # Drain on, visible in the node record, then off again.
    code, _h, _raw = _req(agent,
                          f"/v1/node/{node_id}/drain?enable=true", "PUT")
    assert code == 200
    _c, _h, raw = _req(agent, f"/v1/node/{node_id}")
    assert json.loads(raw)["drain"] is True
    _req(agent, f"/v1/node/{node_id}/drain?enable=false", "PUT")
    _c, _h, raw = _req(agent, f"/v1/node/{node_id}")
    assert json.loads(raw)["drain"] is False


def test_eval_endpoints(agent):
    job, reg = _register(agent)
    eval_id = reg["eval_id"]
    code, _h, raw = _req(agent, f"/v1/evaluation/{eval_id}")
    assert code == 200 and json.loads(raw)["id"] == eval_id

    code, _h, raw = _req(agent, f"/v1/evaluation/{eval_id}/allocations")
    assert code == 200 and isinstance(json.loads(raw), list)

    code, _h, raw = _req(agent, "/v1/evaluations")
    assert code == 200
    assert any(e["id"] == eval_id for e in json.loads(raw))
    _req(agent, f"/v1/job/{job.id}", "DELETE")


def test_blocking_query_returns_on_change(agent):
    # Self-containment: on a fresh agent the jobs table index is 0 and
    # `?index=0` takes the immediate-return path without ever parking a
    # watcher — seed one write so the long-poll actually blocks.
    seed, _ = _register(agent)
    _req(agent, f"/v1/job/{seed.id}", "DELETE")
    _c, headers, _raw = _req(agent, "/v1/jobs")
    index = int(headers["X-Nomad-Index"])

    import threading
    results = []

    def blocked():
        results.append(_req(
            agent, f"/v1/jobs?index={index}&wait=10s"))

    t = threading.Thread(target=blocked)
    t.start()
    # Event-driven: the query is parked once the store has a watcher on
    # the jobs table (was a fixed 0.2s sleep).
    wait_until(lambda: agent.server.fsm.state.watch.live_waiters() > 0,
               msg="blocking query parked server-side")
    job, _ = _register(agent)
    t.join(timeout=10)
    assert not t.is_alive(), "blocking query must return on the write"
    code, headers2, raw = results[0]
    assert code == 200
    assert int(headers2["X-Nomad-Index"]) > index
    assert any(j["id"] == job.id for j in json.loads(raw))
    _req(agent, f"/v1/job/{job.id}", "DELETE")
