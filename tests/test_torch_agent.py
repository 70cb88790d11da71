"""The port's agent, HTTP API, api client, jobspec and CLI against the
JAX package's.

Twins of tests/test_agent_api.py on ``nomad_tpu_torch`` (a dev agent on
the CPU: ``AgentConfig.device = "cpu"``); then the same HTTP sequence
against a JAX dev agent and a port dev agent, whose status codes, bodies
and ``X-Nomad-Index`` ordering must be equal once ids, addresses and
times are masked; each package's ``APIClient`` against the other's
agent; and the agent's refusal to start a server without a card.
"""
from __future__ import annotations

import contextlib
import difflib
import io
import json
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import APIClient, APIError, QueryOptions
from nomad_tpu_torch.jobspec import ParseError, parse

from tests.conftest import wait_until


def boot_dev_agent(data_dir: str):
    """tests/conftest.py's ``boot_dev_agent`` for the port: a dev agent
    on the CPU; returns (agent, api_client) with the client node
    registered."""
    cfg = AgentConfig.dev()
    cfg.device = "cpu"
    cfg.data_dir = data_dir
    cfg.client_options["fingerprint.skip_accel"] = "1"
    agent = Agent(cfg)
    client = APIClient(f"http://127.0.0.1:{agent.http.address[1]}")
    wait_until(lambda: agent.server.fsm.state.nodes(),
               msg="client node registration")
    return agent, client


JOBSPEC = """
job "web" {
    datacenters = ["dc1"]
    type = "service"

    constraint {
        attribute = "$attr.kernel.name"
        value = "linux"
    }

    update {
        stagger = "10s"
        max_parallel = 1
    }

    group "frontend" {
        count = 2
        task "server" {
            driver = "raw_exec"
            config {
                command = "/bin/sleep"
                args = "120"
            }
            env {
                PORT = "8080"
            }
            resources {
                cpu = 100
                memory = 64
                network {
                    mbits = 5
                    dynamic_ports = ["http"]
                }
            }
        }
        meta {
            owner = "team-web"
        }
    }
}
"""


# ---------------------------------------------------------------------------
# jobspec parsing
# ---------------------------------------------------------------------------

class TestJobspec:
    def test_parse_full_spec(self):
        job = parse(JOBSPEC)
        assert job.id == "web"
        assert job.datacenters == ["dc1"]
        assert job.constraints[0].l_target == "$attr.kernel.name"
        assert job.update.stagger == 10.0
        assert job.update.max_parallel == 1
        tg = job.task_groups[0]
        assert tg.name == "frontend" and tg.count == 2
        task = tg.tasks[0]
        assert task.driver == "raw_exec"
        assert task.config["command"] == "/bin/sleep"
        assert task.env["PORT"] == "8080"
        assert task.resources.cpu == 100
        assert task.resources.networks[0].dynamic_ports == ["http"]
        assert tg.meta["owner"] == "team-web"

    def test_parse_reference_example(self):
        """The reference's `nomad init` example parses (docker variant)."""
        spec = """
job "example" {
    datacenters = ["dc1"]
    constraint {
        attribute = "$attr.kernel.name"
        value = "linux"
    }
    update {
        stagger = "10s"
        max_parallel = 1
    }
    group "cache" {
        count = 1
        task "redis" {
            driver = "docker"
            config {
                image = "redis:latest"
            }
            resources {
                cpu = 500
                memory = 256
                network {
                    mbits = 10
                    dynamic_ports = ["6379"]
                }
            }
        }
    }
}
"""
        job = parse(spec)
        assert job.task_groups[0].tasks[0].config["image"] == \
            "redis:latest"

    def test_job_level_task_wraps_group(self):
        spec = """
job "solo" {
    datacenters = ["dc1"]
    task "one" {
        driver = "exec"
        config { command = "/bin/true" }
    }
}
"""
        job = parse(spec)
        assert len(job.task_groups) == 1
        assert job.task_groups[0].name == "one"

    def test_constraint_sugar(self):
        spec = """
job "sugar" {
    datacenters = ["dc1"]
    constraint {
        attribute = "$attr.version"
        version = ">= 0.1.0"
    }
    constraint {
        attribute = "$node.name"
        regexp = "web-.*"
    }
    group "g" {
        task "t" { driver = "exec" config { command = "/bin/true" } }
    }
}
"""
        job = parse(spec)
        assert job.constraints[0].operand == "version"
        assert job.constraints[1].operand == "regexp"

    def test_errors(self):
        with pytest.raises(ParseError):
            parse("not a job")
        with pytest.raises(ParseError):
            parse('job "x" {}')  # missing dc + groups
        with pytest.raises(ParseError):
            parse('job "x" { datacenters = ["dc1"] '
                  'group "g" { task "t" { driver = "exec" '
                  'resources { network { dynamic_ports = ["bad!port"] '
                  '} } } } }')


# ---------------------------------------------------------------------------
# agent + HTTP + api client end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev_agent(tmp_path_factory):
    agent, client = boot_dev_agent(str(tmp_path_factory.mktemp("agent")))
    yield agent, client
    agent.shutdown()


class TestHTTPAPI:
    def test_run_job_via_api(self, dev_agent):
        agent, client = dev_agent
        job = parse(JOBSPEC)
        resp = client.job_register(job)
        assert resp["eval_id"]

        # Eval completes; allocations placed and eventually running.
        def eval_done():
            ev, _ = client.eval_info(resp["eval_id"])
            return ev.status == "complete"
        wait_until(eval_done, msg="eval completion")

        allocs, meta = client.job_allocations("web")
        assert len(allocs) == 2
        assert meta.last_index > 0
        wait_until(lambda: all(
            a.client_status == "running"
            for a, _m in [client.alloc_info(al.id) for al in allocs]
            for a in [a]), timeout=20, msg="tasks running")

        got, _ = client.job_info("web")
        assert got.id == "web"
        jobs, _ = client.jobs_list()
        assert any(j.id == "web" for j in jobs)

        evals, _ = client.job_evaluations("web")
        assert evals

        # Node surface.
        nodes, _ = client.nodes_list()
        assert len(nodes) == 1
        node, _ = client.node_info(nodes[0].id)
        assert node.status == "ready"
        node_allocs, _ = client.node_allocations(node.id)
        assert len(node_allocs) == 2

        # Status surface.
        assert client.status_leader()
        assert client.agent_self()["stats"]["nomad"]["leader"] == "true"

        # Stop the job.
        client.job_deregister("web")

        def stopped():
            allocs, _ = client.job_allocations("web")
            return all(a.desired_status == "stop" for a in allocs)
        wait_until(stopped, msg="job stopped")

    def test_blocking_query_via_api(self, dev_agent):
        agent, client = dev_agent
        _, meta = client.nodes_list()
        start = time.monotonic()
        _, meta2 = client.nodes_list(QueryOptions(
            wait_index=meta.last_index, wait_time=0.5))
        elapsed = time.monotonic() - start
        assert elapsed >= 0.4  # blocked until the (jittered) wait expired

    def test_404s(self, dev_agent):
        _, client = dev_agent
        with pytest.raises(APIError) as e:
            client.job_info("no-such-job")
        assert e.value.status == 404
        with pytest.raises(APIError):
            client.raw("GET", "/v1/bogus")

    def test_pprof_endpoint(self, dev_agent):
        """Thread-stack dump — the pprof-goroutine analogue (reference
        http.go:115-120)."""
        _, client = dev_agent
        data, _ = client.raw("GET", "/v1/agent/pprof")
        stacks = data["stacks"]
        assert any("MainThread" in name for name in stacks)
        frames = next(iter(stacks.values()))
        assert frames and {"file", "line", "func"} <= set(frames[0])

    def test_pprof_gated_on_enable_debug(self, dev_agent):
        agent, client = dev_agent
        agent.config.enable_debug = False
        try:
            with pytest.raises(APIError) as e:
                client.raw("GET", "/v1/agent/pprof")
            assert e.value.status == 404
        finally:
            agent.config.enable_debug = True

    def test_device_profile_needs_the_card(self, dev_agent, tmp_path,
                                           monkeypatch):
        """/v1/agent/profile starts the port's torch.profiler session on
        the card.  Without one (forced, so the test means the same on a
        machine with a card) the start is a 400 that names CUDA and
        nothing is traced; stop is a 400 too."""
        _, client = dev_agent
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        trace_dir = str(tmp_path / "torch-trace")
        with pytest.raises(APIError) as e:
            client.raw("PUT", "/v1/agent/profile",
                       params={"action": "start", "dir": trace_dir})
        assert e.value.status == 400 and "CUDA" in str(e.value)
        data, _ = client.raw("PUT", "/v1/agent/profile",
                             params={"action": "status"})
        assert data == {"tracing": None}
        with pytest.raises(APIError) as e:
            client.raw("PUT", "/v1/agent/profile",
                       params={"action": "stop"})
        assert e.value.status == 400
        assert not os.path.exists(trace_dir)


# ---------------------------------------------------------------------------
# CLI (in-process, pointed at the dev agent)
# ---------------------------------------------------------------------------

class TestCLI:
    def run_cli(self, dev_agent, *argv) -> tuple[int, str]:
        from nomad_tpu_torch.cli import main

        agent, _ = dev_agent
        address = f"http://127.0.0.1:{agent.http.address[1]}"
        stdout = io.StringIO()
        old = sys.stdout
        sys.stdout = stdout
        try:
            code = main(["-address", address] + list(argv))
        finally:
            sys.stdout = old
        return code, stdout.getvalue()

    def test_version(self, dev_agent):
        code, out = self.run_cli(dev_agent, "version")
        assert code == 0 and "nomad-tpu v" in out

    def test_client_config_view_and_update(self, dev_agent):
        agent, _ = dev_agent
        # Dev agent uses in-proc RPC; the config list is what's shown.
        code, out = self.run_cli(
            dev_agent, "client-config",
            "-update-servers", "10.0.0.9:4647,10.0.0.10:4647")
        assert code == 0, out
        assert "2 servers" in out
        assert agent.client.servers() == [("10.0.0.9", 4647),
                                          ("10.0.0.10", 4647)]
        code, out = self.run_cli(dev_agent, "client-config")
        assert code == 0
        assert "10.0.0.9:4647" in out and "10.0.0.10:4647" in out

    def test_server_force_leave_cli(self, dev_agent):
        # An unknown member: the command still succeeds as a no-op
        # (parity with the reference's idempotent force-leave).
        code, out = self.run_cli(dev_agent, "server-force-leave",
                                 "nonexistent-member")
        assert code == 0
        assert "Forced leave" in out

    def test_node_status(self, dev_agent):
        code, out = self.run_cli(dev_agent, "node-status")
        assert code == 0
        assert "ready" in out

    def test_node_drain_cli(self, dev_agent):
        """`node-drain -enable <id>` marks the node draining; -disable
        clears it (reference command/node_drain.go)."""
        agent, _ = dev_agent
        node_id = agent.client.node.id
        code, out = self.run_cli(dev_agent, "node-drain", "-enable",
                                 node_id)
        assert code == 0, out
        assert agent.server.fsm.state.node_by_id(node_id).drain
        code, out = self.run_cli(dev_agent, "node-drain", "-disable",
                                 node_id)
        assert code == 0, out
        assert not agent.server.fsm.state.node_by_id(node_id).drain

    def test_run_status_stop(self, dev_agent, tmp_path):
        spec = tmp_path / "cli-job.nomad"
        spec.write_text(JOBSPEC.replace('job "web"', 'job "cli-job"')
                        .replace('count = 2', 'count = 1'))
        code, out = self.run_cli(dev_agent, "run", str(spec))
        assert code == 0, out
        assert "complete" in out

        code, out = self.run_cli(dev_agent, "status", "cli-job")
        assert code == 0
        assert "cli-job" in out

        code, out = self.run_cli(dev_agent, "stop", "cli-job")
        assert code == 0

    def test_validate_and_init(self, dev_agent, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        code, out = self.run_cli(dev_agent, "init")
        assert code == 0
        code, out = self.run_cli(dev_agent, "validate", "example.nomad")
        assert code == 0, out
        assert "successful" in out


def test_agent_monitor_ring_and_cli(dev_agent, capsys):
    """/v1/agent/monitor serves the recent-log ring; the monitor CLI
    prints it (reference command/agent/log_writer.go consumer)."""
    import logging

    from nomad_tpu_torch.cli.main import main as cli_main
    from nomad_tpu_torch.utils.gated_log import LogWriter

    agent, client = dev_agent
    writer = LogWriter()
    log = logging.getLogger("nomad_tpu_torch.test.monitorcli")
    log.setLevel(logging.INFO)
    log.propagate = False
    log.addHandler(writer)
    agent.log_writer = writer
    try:
        log.info("monitor line alpha")
        log.info("monitor line beta")
        lines = client.agent_monitor()
        assert any("monitor line alpha" in ln for ln in lines)
        assert any("monitor line beta" in ln for ln in lines)
        assert len(client.agent_monitor(lines=1)) == 1

        addr = f"http://127.0.0.1:{agent.http.address[1]}"
        rc = cli_main(["-address", addr, "monitor", "-lines", "2"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "monitor line alpha" in out and "monitor line beta" in out
    finally:
        agent.log_writer = None
        log.removeHandler(writer)


def test_agent_monitor_absent_without_ring(dev_agent):
    """Library embeddings (no CLI boot gate) 404 the monitor endpoint."""
    agent, client = dev_agent
    assert agent.log_writer is None
    with pytest.raises(Exception) as exc:
        client.agent_monitor()
    assert "404" in str(exc.value) or "not" in str(exc.value).lower()


# ---------------------------------------------------------------------------
# the port's agent against the JAX package's
# ---------------------------------------------------------------------------

PARITY_JOB = {"job": {
    "id": "par", "name": "par", "type": "service",
    "datacenters": ["dc1"],
    "task_groups": [{
        "name": "tg", "count": 2,
        "tasks": [{"name": "t", "driver": "raw_exec",
                   "config": {"command": "/bin/sleep", "args": "120"},
                   "resources": {"cpu": 50, "memory_mb": 16}}]}]}}
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")
ADDR = re.compile(r"^127\.0\.0\.1:\d+$")
INDEX_KEYS = {"index", "create_index", "modify_index", "job_modify_index",
              "alloc_index", "node_modify_index", "alloc_modify_index"}


def _http(base, path, method="GET", body=None):
    """(status, X-Nomad-Index or None, decoded body)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            index = resp.headers.get("X-Nomad-Index")
            return resp.status, index, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("X-Nomad-Index"), json.loads(e.read())


class _Masker:
    """One world's masking: uuids by order of first appearance (so a
    reference to an id stays a reference), listener addresses, times,
    the agent's data dir, and raft indexes by rank among every index the
    world showed (the ordering is compared, not the values).  An alloc's
    ``modify_index`` is its client's last status write: the client
    batches its updates as they come, so how many writes it took is
    timing, and the index is masked (``_indexes`` leaves it out)."""

    def __init__(self, indexes, data_dir) -> None:
        self.ids: dict = {}
        self.rank = {v: i for i, v in enumerate(sorted(set(indexes)))}
        self.data_dir = data_dir

    def _id(self, text: str) -> str:
        return UUID.sub(lambda m: self.ids.setdefault(
            m.group(0), f"<id{len(self.ids)}>"), text)

    def __call__(self, value, key=""):
        if isinstance(value, dict):
            return {self._id(k): "<client write>"
                    if k == "modify_index" and "client_status" in value
                    else self(v, k) for k, v in value.items()}
        if isinstance(value, list):
            if len(value) == 2 and value[0] == "127.0.0.1":
                return "<addr>"
            return [self(v, key) for v in value]
        if key in INDEX_KEYS and isinstance(value, int):
            return ("<index>", self.rank.get(value, value))
        if key.endswith("_time") and isinstance(value, float):
            return "<time>"
        if isinstance(value, str):
            if ADDR.match(value):
                return "<addr>"
            return self._id(value.replace(self.data_dir, "<data>"))
        return value


def _indexes(value, key=""):
    if isinstance(value, dict):
        for k, v in value.items():
            if k != "modify_index" or "client_status" not in value:
                yield from _indexes(v, k)
    elif isinstance(value, list):
        for v in value:
            yield from _indexes(v, key)
    elif key in INDEX_KEYS and isinstance(value, int):
        yield value


def _sequence(agent):
    """One HTTP session against a fresh dev agent: reads before and
    after a job runs, the error codes, a deregister.  Returns the
    masked (path, status, index, body) rows."""
    base = f"http://127.0.0.1:{agent.http.address[1]}"
    rows = []

    def call(path, method="GET", body=None):
        status, index, got = _http(base, path, method, body)
        rows.append((method, path, status, index, got))
        return got

    def allocs():
        return _http(base, "/v1/job/par/allocations")[2]

    node_id = call("/v1/nodes")[0]["id"]
    call(f"/v1/node/{node_id}")
    eval_id = call("/v1/jobs", "PUT", PARITY_JOB)["eval_id"]
    wait_until(lambda: _http(base, f"/v1/evaluation/{eval_id}")[2][
        "status"] == "complete", msg="eval complete")
    wait_until(lambda: len(allocs()) == 2 and all(
        a["client_status"] == "running" for a in allocs()),
        timeout=30, msg="both allocs running")
    alloc_ids = [a["id"] for a in sorted(allocs(), key=lambda a: a["name"])]
    for path in ("/v1/job/par", "/v1/jobs", "/v1/job/par/evaluations",
                 f"/v1/evaluation/{eval_id}", "/v1/evaluations",
                 f"/v1/allocation/{alloc_ids[0]}",
                 f"/v1/allocation/{alloc_ids[1]}",
                 "/v1/status/leader", "/v1/status/peers",
                 "/v1/agent/members", "/v1/agent/servers",
                 "/v1/job/nope", "/v1/nonsense", "/v1/nodes?wait=nope",
                 "/v1/nodes?index=abc", "/v1/nodes?region=mars"):
        call(path)
    call("/v1/jobs", "DELETE")
    stop_eval = call("/v1/job/par", "DELETE")["eval_id"]
    wait_until(lambda: _http(base, f"/v1/evaluation/{stop_eval}")[2][
        "status"] == "complete", msg="deregister eval complete")
    wait_until(lambda: all(a["client_status"] != "running"
                           for a in allocs()), timeout=30,
               msg="tasks stopped")
    call("/v1/job/par")
    return rows


@pytest.fixture
def frozen_host(monkeypatch):
    """Both agents' clients fingerprint one instant of the host
    (/proc/cpuinfo's MHz moves with the clock, and a node's cpu
    capacity feeds the placement scores)."""
    import builtins
    import shutil

    snap = {}
    for path in ("/proc/cpuinfo", "/proc/meminfo"):
        with open(path) as fh:
            snap[path] = fh.read()
    real_open = builtins.open

    def frozen_open(file, *a, **kw):
        if file in snap:
            return io.StringIO(snap[file])
        return real_open(file, *a, **kw)
    usage = shutil.disk_usage("/")
    monkeypatch.setattr(builtins, "open", frozen_open)
    monkeypatch.setattr(shutil, "disk_usage", lambda path: usage)


def test_http_sequence_equals_the_jax_agents(tmp_path, frozen_host):
    """The same HTTP session against a JAX dev agent and a port dev
    agent (one node each, the same job of two raw_exec tasks): equal
    methods, paths and status codes, equal bodies and the same order of
    ``X-Nomad-Index`` values once ids, addresses and times are
    masked."""
    from tests.conftest import boot_dev_agent as jax_boot_dev_agent

    worlds = {}
    for name, boot in (("jax", jax_boot_dev_agent),
                       ("port", boot_dev_agent)):
        agent, _client = boot(str(tmp_path / name))
        try:
            rows = _sequence(agent)
        finally:
            agent.shutdown()
        indexes = [int(r[3]) for r in rows if r[3] is not None]
        for r in rows:
            indexes += list(_indexes(r[4]))
        mask = _Masker(indexes, str(tmp_path / name))
        worlds[name] = [
            (method, mask(path), status,
             None if index is None else mask.rank[int(index)], mask(body))
            for method, path, status, index, body in rows]
    assert [r[:3] for r in worlds["port"]] == \
        [r[:3] for r in worlds["jax"]]
    for got, want in zip(worlds["port"], worlds["jax"]):
        assert got == want, f"{got[:2]} differs:\n" + "\n".join(
            difflib.unified_diff(
                json.dumps(want, indent=1, sort_keys=True).splitlines(),
                json.dumps(got, indent=1, sort_keys=True).splitlines(),
                "jax", "port", lineterm="", n=2))
    codes = [r[2] for r in worlds["port"]]
    assert codes.count(404) == 3 and 400 in codes and 405 in codes \
        and 500 in codes


CLI_JOBS = {
    "cli": """
job "cli" {
    datacenters = ["dc1"]
    group "g" {
        count = 2
        task "t" {
            driver = "raw_exec"
            config {
                command = "/bin/sleep"
                args = "120"
            }
            resources {
                cpu = 20
                memory = 16
            }
        }
    }
}
""",
    # Every node filtered: the monitor and alloc-status render the
    # placement failure's metrics.
    "nofit": """
job "nofit" {
    datacenters = ["dc1"]
    constraint {
        attribute = "$attr.kernel.name"
        value = "windows"
    }
    group "g" {
        task "t" {
            driver = "raw_exec"
            config {
                command = "/bin/sleep"
                args = "120"
            }
            resources {
                cpu = 20
                memory = 16
            }
        }
    }
}
""",
}
SHORT_ID = re.compile(r"\b[0-9a-f]{8}\b")
ADDR_TEXT = re.compile(r"\['127\.0\.0\.1', \d+\]|127\.0\.0\.1:\d+")


def _cli_session(agent, cli_main, tmp) -> tuple:
    """Every read subcommand of one package's CLI against its own dev
    agent, around two jobs submitted with ``run`` (its eval monitor
    printing), then ``stop``.  Returns the (argv, exit code, stdout,
    stderr) rows, the agent's ids in the session's order, and
    ``agent-info``'s document."""
    base = f"http://127.0.0.1:{agent.http.address[1]}"
    rows = []

    def cli(*argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli_main(["-address", base, *argv])
        rows.append((list(argv), rc, out.getvalue(), err.getvalue()))
        return out.getvalue()

    def allocs(job):
        return sorted(_http(base, f"/v1/job/{job}/allocations")[2],
                      key=lambda a: a["name"])

    node_id = _http(base, "/v1/nodes")[2][0]["id"]
    for name, text in CLI_JOBS.items():
        path = os.path.join(tmp, f"{name}.hcl")
        with open(path, "w") as fh:
            fh.write(text)
        cli("run", path)
    wait_until(lambda: [a["client_status"] for a in allocs("cli")]
               == ["running", "running"], timeout=30,
               msg="both tasks running")
    evals = [a["eval_id"] for a in allocs("cli")[:1] + allocs("nofit")]
    ids = [node_id] + evals + [a["id"] for job in CLI_JOBS
                               for a in allocs(job)]
    cli("status")
    for job in CLI_JOBS:
        cli("status", job)
    for alloc_id in ids[3:]:
        cli("alloc-status", alloc_id)
    for eval_id in evals:
        cli("eval-monitor", eval_id)
    cli("node-status")
    cli("node-status", node_id)
    cli("server-members")
    cli("client-config")
    cli("status", "nope")
    cli("alloc-status", "nope")
    cli("agent-info")
    info = json.loads(rows.pop()[2])
    for job in CLI_JOBS:
        cli("stop", job)
    wait_until(lambda: all(a["client_status"] != "running"
                           for a in allocs("cli")), timeout=30,
               msg="tasks stopped")
    ids += [e["id"] for e in sorted(
        _http(base, "/v1/evaluations")[2], key=lambda e: e["create_index"])
        if e["id"] not in ids]
    cli("status", "cli")
    cli("status")
    return rows, ids, info


ALLOC_ROW = re.compile(r"^\s*(Allocation )?<id\d+>")


def _mask_text(text: str, mask: "_Masker", ids: list) -> str:
    """Ids in full and as the CLI's 8-character prefixes, listener
    addresses and the data dir; a prefix of no id of the session fails.
    The store lists an eval's, a job's and a node's allocations in hash
    order, in either package, so each run of allocation rows is sorted
    (by mask, which numbers a job's allocations by name)."""
    text = ADDR_TEXT.sub("<addr>", mask(text))

    def short(m):
        full = [i for i in ids if i.startswith(m.group(0))]
        assert len(full) == 1, f"{m.group(0)} is no id of the session"
        return mask._id(full[0]) + "[:8]"
    lines, run = [], []
    for line in SHORT_ID.sub(short, text).splitlines(keepends=True):
        if ALLOC_ROW.match(line):
            run.append(line)
            continue
        lines += sorted(run) + [line]
        run = []
    return "".join(lines + sorted(run))


def _paths(doc, prefix=""):
    if isinstance(doc, dict):
        for k, v in doc.items():
            yield from _paths(v, f"{prefix}.{k}")
    else:
        yield prefix


def test_cli_reads_equal_the_jax_clis(tmp_path, frozen_host):
    """Each package's CLI against its own dev agent, through the same
    session: ``run`` (its eval monitor) of a job that places and of one
    that every node filters, then ``status``, ``alloc-status``,
    ``eval-monitor``, ``node-status``, ``server-members``,
    ``client-config``, the 404s and ``stop``.  Exit codes, stdout and
    stderr are equal once ids, addresses and the data dir are masked;
    ``agent-info`` has the same fields, ``config.device`` and the
    process-wide metrics sink's keys aside, and the same config."""
    from nomad_tpu.cli.main import main as jax_cli
    from nomad_tpu_torch.cli.main import main as port_cli
    from tests.conftest import boot_dev_agent as jax_boot_dev_agent

    worlds = {}
    for name, boot, cli_main in (("jax", jax_boot_dev_agent, jax_cli),
                                 ("port", boot_dev_agent, port_cli)):
        data = tmp_path / name
        agent, _client = boot(str(data))
        try:
            rows, ids, info = _cli_session(agent, cli_main, str(tmp_path))
        finally:
            agent.shutdown()
        mask = _Masker([], str(data))
        for i in ids:
            mask._id(i)
        worlds[name] = (
            [(argv[0], mask(argv[1:]), rc, _mask_text(out, mask, ids),
              _mask_text(err, mask, ids)) for argv, rc, out, err in rows],
            info)
    (port, port_info), (jax, jax_info) = worlds["port"], worlds["jax"]
    assert [r[:3] for r in port] == [r[:3] for r in jax]
    for got, want in zip(port, jax):
        assert got == want, f"{got[:2]} differs:\n" + "\n".join(
            difflib.unified_diff(want[3].splitlines() + want[4].splitlines(),
                                 got[3].splitlines() + got[4].splitlines(),
                                 "jax", "port", lineterm="", n=2))
    rcs = [r[2] for r in port]
    assert rcs.count(1) == 3 and set(rcs) == {0, 1}  # the 404s
    text = "".join(r[3] for r in port)
    assert "Evaluation status: complete" in text and \
        "nodes filtered" in text and "Client     = running" in text
    assert port_info["config"].pop("device") == "cpu"
    assert mask(port_info["config"]) == \
        _Masker([], str(tmp_path / "jax"))(jax_info["config"])
    # The in-memory metrics sink is the process's: its keys depend on
    # what else ran in this process, so only its sections compare.
    assert set(port_info["stats"].pop("metrics")) == \
        set(jax_info["stats"].pop("metrics"))
    assert sorted(_paths(port_info)) == sorted(_paths(jax_info))


@pytest.fixture(scope="module")
def jax_agent(tmp_path_factory):
    from tests.conftest import boot_dev_agent as jax_boot_dev_agent

    agent, client = jax_boot_dev_agent(
        str(tmp_path_factory.mktemp("jax-agent")))
    yield agent, client
    agent.shutdown()


CROSS_JOB = """
job "cross-%(side)s" {
    datacenters = ["dc1"]
    group "g" {
        count = 2
        task "t" {
            driver = "raw_exec"
            config {
                command = "/bin/sleep"
                args = "60"
            }
            resources {
                cpu = 20
                memory = 16
            }
        }
    }
}
"""


@pytest.mark.parametrize("side", ["jax-client-port-agent",
                                  "port-client-jax-agent"])
def test_api_clients_cross_packages(side, dev_agent, jax_agent):
    """Each package's ``APIClient`` drives the other's agent: register
    a job of its own package's jobspec, read it back as its own
    package's structs, watch its eval and allocations, deregister."""
    from nomad_tpu.api import APIClient as JAPIClient
    from nomad_tpu.jobspec import parse as jparse

    if side == "jax-client-port-agent":
        agent, _ = dev_agent
        client_cls, parse_fn, pkg = JAPIClient, jparse, "nomad_tpu"
    else:
        agent, _ = jax_agent
        client_cls, parse_fn, pkg = APIClient, parse, "nomad_tpu_torch"
    client = client_cls(f"http://127.0.0.1:{agent.http.address[1]}")
    job = parse_fn(CROSS_JOB % dict(side=side))
    resp = client.job_register(job)
    wait_until(lambda: client.eval_info(resp["eval_id"])[0].status
               == "complete", msg="eval complete")
    got, meta = client.job_info(job.id)
    assert type(got).__module__.split(".")[0] == pkg
    assert meta.last_index > 0
    assert got.task_groups[0].to_dict() == job.task_groups[0].to_dict()
    wait_until(lambda: len(client.job_allocations(job.id)[0]) == 2,
               msg="two allocs")
    allocs, _ = client.job_allocations(job.id)
    assert {a.node_id for a in allocs} == {agent.client.node.id}
    assert {type(a).__module__.split(".")[0] for a in allocs} == {pkg}
    evals, _ = client.eval_allocations(resp["eval_id"])
    assert sorted(a.id for a in evals) == sorted(a.id for a in allocs)
    nodes, _ = client.nodes_list()
    assert [n.id for n in nodes] == [agent.client.node.id]
    assert client.agent_self()["stats"]["nomad"]["leader"] == "true"
    assert len(client.agent_members()) == 1
    client.job_deregister(job.id)
    wait_until(lambda: all(a.desired_status == "stop"
                           for a in client.job_allocations(job.id)[0]),
               msg="job stopped")


def test_agent_members_is_the_gossip_pool(dev_agent):
    """A server agent runs gossip, dev mode included: one alive member,
    tagged with the agent's region and RPC address."""
    agent, client = dev_agent
    (member,) = client.agent_members()
    assert member["status"] == "alive"
    assert member["tags"]["role"] == "nomad-server"
    assert member["tags"]["region"] == agent.config.region
    assert tuple(member["tags"]["rpc"]) == agent.server.rpc_address()
    assert tuple(member["addr"]) == agent.server.gossip.addr


# ---------------------------------------------------------------------------
# the agent means the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dev", "server", "client-and-server"])
def test_server_agent_without_a_card_raises_and_leaves_nothing(
        mode, monkeypatch, tmp_path):
    """``Agent(AgentConfig.dev())`` and every agent that runs a server
    mean the card: without one (forced, so the test means the same on
    a machine with a card) the constructor raises ``RuntimeError``
    before any thread, socket or temporary directory exists."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    if mode == "dev":
        cfg = AgentConfig.dev()
    else:
        cfg = AgentConfig(server_enabled=True,
                          client_enabled=mode != "server",
                          http_port=0, rpc_port=0, serf_port=0)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="CUDA"):
        Agent(cfg)
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
    assert os.listdir(tmp_path) == []


def test_a_taken_serf_port_fails_the_boot_and_leaves_nothing():
    """``-serf-port`` already taken: the server binds gossip after its
    workers and listener exist, and the agent's boot fails with no
    thread left behind and the RPC and HTTP listeners closed."""
    import socket

    held = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    held.bind(("127.0.0.1", 0))
    try:
        before = set(threading.enumerate())
        fds = set(os.listdir("/proc/self/fd"))
        with pytest.raises(OSError):
            Agent(AgentConfig(server_enabled=True, client_enabled=False,
                              http_port=0, rpc_port=0,
                              serf_port=held.getsockname()[1],
                              device="cpu"))
        assert [t.name for t in threading.enumerate()
                if t not in before and t.is_alive()] == []
        left = [os.readlink(f"/proc/self/fd/{fd}")
                for fd in set(os.listdir("/proc/self/fd")) - fds
                if os.path.exists(f"/proc/self/fd/{fd}")]
        assert [link for link in left if link.startswith("socket:")] == []
    finally:
        held.close()
