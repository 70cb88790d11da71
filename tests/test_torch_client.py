"""The port's client agent (nomad_tpu_torch/client) against the JAX
package's.

First the JAX package's client tests run against the port:
tests/test_client.py's fingerprint, alloc dir, environment, task
runner, alloc runner and client cases (its driver cases are in
tests/test_torch_drivers.py), with the port's ``Server(device="cpu",
enable_rpc=True)`` where the JAX tests run the JAX server; and
tests/test_faultinject.py's client cases (the ``driver.start`` site,
queued ``Node.UpdateAlloc`` updates, registration backoff) with the
port's ``faultinject``.

Then parity with the JAX package, with no tolerance: ``fingerprint_node``
with the same options gives equal attributes, resources and links
(``accel.*`` in a fresh interpreter, where JAX's CPU backend has its
default one device); ``task_environment`` gives equal dicts; state and
task handle files written by either package's ``AllocRunner`` are
restored by the other's, byte for byte, re-attached to the same PID; a
JAX ``Client`` runs a raw_exec job from the port's server and a port
``Client`` one from the JAX server, and their ``Node.Register`` payloads
are equal apart from the node id.  On a CUDA host ``accel`` reports
platform ``gpu`` and the card's name (``torch.cuda`` stubbed here).
"""
from __future__ import annotations

import builtins
import importlib
import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest
import torch

import nomad_tpu_torch.mock as mock
from nomad_tpu_torch import faultinject
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.client.allocdir import AllocDir
from nomad_tpu_torch.client.alloc_runner import AllocRunner
from nomad_tpu_torch.client.driver.base import ExecContext
from nomad_tpu_torch.client.fingerprint import (
    accel_fingerprint,
    fingerprint_node,
)
from nomad_tpu_torch.client.task_env import task_environment
from nomad_tpu_torch.client.task_runner import TaskRunner
from nomad_tpu_torch.faultinject import FaultPlan
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs import (
    NetworkResource,
    Node,
    Resources,
    Task,
)

from tests.conftest import wait_until

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_server(**kw) -> Server:
    """The port's server where the JAX tests build the JAX one."""
    return Server(ServerConfig(device="cpu", tune_gc=False, **kw))


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faultinject.clear_plan()
    yield
    faultinject.clear_plan()


# -- tests/test_client.py -----------------------------------------------------


def raw_task(name="echo", command="/bin/sh",
             args="-c 'echo hello-from-task'") -> Task:
    return Task(name=name, driver="raw_exec",
                config={"command": command, "args": args},
                resources=Resources(cpu=100, memory_mb=64))


def test_fingerprint_populates_node():
    cfg = ClientConfig(options={"fingerprint.skip_accel": "1"})
    node = Node()
    applied = fingerprint_node(cfg, node)
    assert "arch" in applied and "cpu" in applied and "memory" in applied
    assert node.attributes["kernel.name"]
    assert node.resources.cpu > 0
    assert node.resources.memory_mb > 0
    assert node.resources.disk_mb > 0
    assert node.attributes["cpu.numcores"]
    assert node.resources.networks


def test_env_cloud_fingerprints():
    """AWS/GCE metadata probes: off by default, detect against a local
    fake metadata server when enabled (reference env_aws_test.go /
    gce_test.go with httptest)."""
    import http.server
    import threading

    from nomad_tpu_torch.client.fingerprint import (
        env_aws_fingerprint,
        env_gce_fingerprint,
    )

    class _Meta(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), _Meta)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        # Off by default: no probe, no attributes.
        node = mock.node()
        assert not env_aws_fingerprint(ClientConfig(), node)
        assert not env_gce_fingerprint(ClientConfig(), node)
        assert "platform.aws.detected" not in node.attributes

        cfg = ClientConfig(options={
            "fingerprint.env_aws": "1",
            "fingerprint.env_aws.url": url,
            "fingerprint.env_gce": "1",
            "fingerprint.env_gce.url": url,
        })
        node = mock.node()
        assert env_aws_fingerprint(cfg, node)
        assert node.attributes["platform.aws.detected"] == "true"
        assert env_gce_fingerprint(cfg, node)
        assert node.attributes["platform.gce.detected"] == "true"

        # Unreachable endpoint: enabled but cleanly not-detected.
        # A freshly bound-then-closed port is deterministically dead.
        import socket
        s2 = socket.socket()
        s2.bind(("127.0.0.1", 0))
        dead_port = s2.getsockname()[1]
        s2.close()
        cfg = ClientConfig(options={
            "fingerprint.env_aws": "1",
            "fingerprint.env_aws.url": f"http://127.0.0.1:{dead_port}",
        })
        node = mock.node()
        assert not env_aws_fingerprint(cfg, node)
    finally:
        srv.shutdown()
        srv.server_close()


def test_alloc_dir_tree(tmp_path):
    ad = AllocDir(str(tmp_path / "a1"))
    ad.build([raw_task("t1"), raw_task("t2")])
    assert os.path.isdir(ad.shared_dir + "/logs")
    assert os.path.isdir(os.path.join(ad.task_dirs["t1"], "local"))
    # Shared dir visible from inside each task dir.
    assert os.path.islink(os.path.join(ad.task_dirs["t2"], "alloc"))
    ad.destroy()
    assert not os.path.exists(ad.alloc_dir)


def test_task_environment():
    task = raw_task()
    task.env = {"CUSTOM": "yes"}
    task.meta = {"owner": "ops"}
    res = Resources(cpu=250, memory_mb=128, networks=[NetworkResource(
        ip="10.0.0.5", reserved_ports=[22, 8080],
        dynamic_ports=["http"], mbits=10)])
    env = task_environment(task, alloc_dir="/a", task_dir="/t",
                          resources=res)
    assert env["NOMAD_ALLOC_DIR"] == "/a"
    assert env["NOMAD_MEMORY_LIMIT"] == "128"
    assert env["NOMAD_CPU_LIMIT"] == "250"
    assert env["NOMAD_IP"] == "10.0.0.5"
    assert env["NOMAD_PORT_http"] == "8080"
    assert env["NOMAD_META_OWNER"] == "ops"
    assert env["CUSTOM"] == "yes"


def test_task_runner_completes(tmp_path):
    ad = AllocDir(str(tmp_path / "alloc"))
    task = raw_task()
    ad.build([task])
    ctx = ExecContext(ad, "alloc-1")
    states = []
    tr = TaskRunner(ctx, task, state_dir=str(tmp_path / "state"),
                    on_state=lambda n, s, d: states.append(s))
    tr.start()
    wait_until(lambda: tr.state == "dead", msg="task completion")
    assert not tr.failed
    with open(ad.log_path("echo", "stdout")) as fh:
        assert "hello-from-task" in fh.read()


def test_task_runner_failure(tmp_path):
    ad = AllocDir(str(tmp_path / "alloc"))
    task = raw_task(command="/bin/false", args="")
    ad.build([task])
    tr = TaskRunner(ExecContext(ad, "a"), task)
    tr.start()
    wait_until(lambda: tr.state == "dead", msg="task exit")
    assert tr.failed


def test_task_runner_destroy_kills(tmp_path):
    ad = AllocDir(str(tmp_path / "alloc"))
    task = raw_task(command="/bin/sleep", args="300")
    ad.build([task])
    tr = TaskRunner(ExecContext(ad, "a"), task)
    tr.start()
    wait_until(lambda: tr.state == "running", msg="task start")
    tr.destroy()
    wait_until(lambda: tr.state == "dead", msg="task killed")


def test_task_runner_reattach(tmp_path):
    """Agent restart: a new TaskRunner re-attaches to the live process via
    the persisted handle id instead of restarting the task."""
    ad = AllocDir(str(tmp_path / "alloc"))
    task = raw_task(command="/bin/sleep", args="30")
    ad.build([task])
    state_dir = str(tmp_path / "state")
    tr = TaskRunner(ExecContext(ad, "a"), task, state_dir=state_dir)
    tr.start()
    wait_until(lambda: tr.state == "running", msg="task start")
    pid = tr.handle.pid

    # "Restart": fresh runner from persisted state.
    tr2 = TaskRunner(ExecContext(ad, "a"), task, state_dir=state_dir)
    assert tr2.restore_state()
    assert tr2.handle.pid == pid
    tr2.start()
    wait_until(lambda: tr2.state == "running", msg="re-attached running")
    tr2.destroy()
    wait_until(lambda: tr2.state == "dead", msg="killed after re-attach")
    tr.destroy()


def make_alloc(command="/bin/sh", args="-c 'echo done'"):
    job = mock.job()
    tg = job.task_groups[0]
    tg.tasks = [raw_task(command=command, args=args)]
    alloc = mock.alloc()
    alloc.job = job
    alloc.job_id = job.id
    alloc.task_group = tg.name
    alloc.task_resources = {}
    return alloc


def test_alloc_runner_lifecycle(tmp_path):
    alloc = make_alloc()
    statuses = []
    runner = AllocRunner(alloc, str(tmp_path / "alloc"),
                         state_dir=str(tmp_path / "state"),
                         on_status=lambda a: statuses.append(
                             a.client_status))
    runner.run()
    # on_status runs after the alloc's swap, outside the publish lock:
    # wait for the callback itself, not for the swap.
    wait_until(lambda: "dead" in statuses, msg="alloc completion")
    assert runner.alloc.client_status == "dead"


def test_alloc_runner_failed_task(tmp_path):
    alloc = make_alloc(command="/bin/false", args="")
    runner = AllocRunner(alloc, str(tmp_path / "alloc"))
    runner.run()
    wait_until(lambda: runner.alloc.client_status == "failed",
               msg="alloc failure")


@pytest.fixture
def cluster(tmp_path):
    srv = port_server(num_schedulers=2, enable_rpc=True)
    srv.establish_leadership()
    cfg = ClientConfig(
        state_dir=str(tmp_path / "client-state"),
        alloc_dir=str(tmp_path / "allocs"),
        servers=[srv.rpc_address()],
        options={"driver.raw_exec.enable": "1",
                 "fingerprint.skip_accel": "1"},
    )
    client = Client(cfg)
    client.start()
    yield srv, client
    client.shutdown()
    client.destroy_all()
    srv.shutdown()


def test_client_registers_and_runs_job(cluster):
    srv, client = cluster
    wait_until(lambda: srv.fsm.state.node_by_id(client.node.id)
               is not None, msg="node registration")
    node = srv.fsm.state.node_by_id(client.node.id)
    assert node.status == "ready"
    assert node.attributes.get("driver.raw_exec") == "1"

    job = mock.job()
    job.task_groups[0].count = 1
    job.task_groups[0].tasks = [Task(
        name="hello", driver="raw_exec",
        config={"command": "/bin/sh", "args": "-c 'echo job-output'"},
        resources=Resources(cpu=100, memory_mb=64))]
    job.constraints = []
    _, eval_id = srv.job_register(job)
    srv.wait_for_evals([eval_id], timeout=15)

    # The client picks up the alloc, runs it, and syncs terminal status.
    def alloc_done():
        allocs = srv.fsm.state.allocs_by_job(job.id)
        return allocs and allocs[0].client_status == "dead"
    wait_until(alloc_done, timeout=20, msg="alloc ran to completion")

    alloc = srv.fsm.state.allocs_by_job(job.id)[0]
    log = os.path.join(client._alloc_root(alloc.id), "alloc", "logs",
                       "hello.stdout")
    with open(log) as fh:
        assert "job-output" in fh.read()


def test_client_stops_alloc_on_deregister(cluster):
    srv, client = cluster
    wait_until(lambda: srv.fsm.state.node_by_id(client.node.id)
               is not None, msg="node registration")
    job = mock.job()
    job.task_groups[0].count = 1
    job.task_groups[0].tasks = [Task(
        name="sleeper", driver="raw_exec",
        config={"command": "/bin/sleep", "args": "300"},
        resources=Resources(cpu=100, memory_mb=64))]
    job.constraints = []
    _, eval_id = srv.job_register(job)
    srv.wait_for_evals([eval_id], timeout=15)

    def running():
        allocs = srv.fsm.state.allocs_by_job(job.id)
        return allocs and allocs[0].client_status == "running"
    wait_until(running, timeout=20, msg="task running")

    _, e2 = srv.job_deregister(job.id)
    srv.wait_for_evals([e2], timeout=15)

    def stopped():
        runner = client.alloc_runners.get(
            srv.fsm.state.allocs_by_job(job.id)[0].id)
        return runner is not None and \
            runner.alloc.client_status in ("dead", "failed")
    wait_until(stopped, timeout=20, msg="task stopped after deregister")


def test_agent_restart_does_not_resurrect_completed_allocs(tmp_path):
    """A finished alloc must not re-run its tasks when the agent
    restarts."""
    alloc = make_alloc(command="/bin/sh",
                       args=f"-c 'echo ran >> {tmp_path}/count'")
    state_dir = str(tmp_path / "state")
    runner = AllocRunner(alloc, str(tmp_path / "alloc"),
                         state_dir=state_dir)
    runner.run()
    wait_until(lambda: runner.alloc.client_status == "dead",
               msg="first run completes")

    # Simulate agent restart via a fresh client restore pass.
    cfg = ClientConfig(
        state_dir=str(tmp_path),
        alloc_dir=str(tmp_path / "alloc-root"),
        rpc_handler=type("NoRPC", (), {
            "call": lambda self, m, a, timeout=None: {}})(),
        options={"fingerprint.skip_accel": "1"},
    )
    os.makedirs(os.path.join(str(tmp_path), "allocs"), exist_ok=True)
    os.rename(state_dir, os.path.join(str(tmp_path), "allocs", alloc.id))
    client = Client(cfg)
    assert alloc.id not in client.alloc_runners
    time.sleep(0.3)  # sleep-ok: window proves the ABSENCE of a second run
    with open(tmp_path / "count") as fh:
        assert fh.read().count("ran") == 1


def test_alloc_dir_reembed_refreshes_stale_entries(tmp_path):
    """Re-embedding picks up changed files and retargeted symlinks
    (previously any existing dest was skipped forever)."""
    src = tmp_path / "srcdir"
    src.mkdir()
    (src / "config").write_text("v1")
    (src / "current").symlink_to("config")

    ad = AllocDir(str(tmp_path / "alloc"))
    task = Task(name="t", driver="exec", config={},
                resources=Resources(cpu=100, memory_mb=64))
    ad.build([task])
    dest = os.path.join(ad.task_dirs["t"], "embedded")
    ad.embed("t", {str(src): "embedded"})
    assert open(os.path.join(dest, "config")).read() == "v1"
    assert os.readlink(os.path.join(dest, "current")) == "config"

    # Change content (newer mtime) and retarget the symlink.
    time.sleep(0.01)  # sleep-ok: force a distinct mtime
    (src / "other").write_text("v2-content")
    cfg = src / "config"
    cfg.unlink()
    cfg.write_text("v2")
    now = time.time() + 5
    os.utime(cfg, (now, now))
    cur = src / "current"
    cur.unlink()
    cur.symlink_to("other")

    ad.embed("t", {str(src): "embedded"})
    assert open(os.path.join(dest, "config")).read() == "v2"
    assert os.readlink(os.path.join(dest, "current")) == "other"


# -- tests/test_faultinject.py's client cases -------------------------------


def test_driver_start_site(tmp_path):
    from nomad_tpu_torch.client.allocdir import AllocDir
    from nomad_tpu_torch.client.driver.base import ExecContext
    from nomad_tpu_torch.client.task_runner import TaskRunner
    from nomad_tpu_torch.structs import Resources, Task

    task = Task(name="echo", driver="raw_exec",
                config={"command": "/bin/sh",
                        "args": "-c 'echo hi'"},
                resources=Resources(cpu=100, memory_mb=64))
    ad = AllocDir(str(tmp_path / "alloc"))
    ad.build([task])
    states = []
    tr = TaskRunner(ExecContext(ad, "a"), task,
                    on_state=lambda n, s, d: states.append((s, d)))
    with faultinject.injected(
            FaultPlan().add("driver.start", "error",
                            method="raw_exec")):
        tr.run()  # inline: deterministic, no thread needed
    assert tr.failed
    assert tr.state == "dead"
    assert any("injected" in d for _s, d in states)


class _ScriptedRPC:
    """In-proc rpc_handler whose UpdateAlloc failures are scripted."""

    def __init__(self, fail_updates: int = 0) -> None:
        self.fail_updates = fail_updates
        self.update_payloads: list = []
        self.lock = threading.Lock()

    def call(self, method: str, args: dict, timeout=None):
        if method == "Node.UpdateAlloc":
            with self.lock:
                if self.fail_updates > 0:
                    self.fail_updates -= 1
                    raise ConnectionError("scripted outage")
                self.update_payloads.append(args["alloc"])
            return {}
        return {"heartbeat_ttl": 10.0}


def _make_client(rpc_handler):
    from nomad_tpu_torch.client import Client, ClientConfig

    return Client(ClientConfig(
        rpc_handler=rpc_handler,
        options={"fingerprint.skip_accel": "1"}))


def _alloc_update(alloc_id: str, status: str):
    from nomad_tpu_torch.structs import Allocation

    return Allocation(id=alloc_id, client_status=status,
                      node_id="n-1", task_states={})


class TestClientRetries:
    def test_update_alloc_failure_queues_for_heartbeat(self, monkeypatch):
        """A Node.UpdateAlloc that exhausts its retry burst
        is queued, not dropped, and the next heartbeat delivers it."""
        import nomad_tpu_torch.client.client as client_mod
        from nomad_tpu_torch.utils.retry import RetryPolicy

        monkeypatch.setattr(
            client_mod, "UPDATE_ALLOC_POLICY",
            RetryPolicy(base=0.01, max_delay=0.02, max_attempts=2,
                        retryable=lambda e: isinstance(e, Exception),
                        name="test.update_alloc"))
        rpc = _ScriptedRPC(fail_updates=5)  # outlasts one burst
        client = _make_client(rpc)
        try:
            client._sync_alloc_status(_alloc_update("a-1", "failed"))
            with client._update_lock:
                assert "a-1" in client._pending_updates  # queued, not lost
            # Newer status for the same alloc supersedes the queued one.
            client._sync_alloc_status(_alloc_update("a-1", "complete"))

            rpc.fail_updates = 0  # server back: heartbeat flushes
            client._flush_alloc_updates()
            with client._update_lock:
                assert not client._pending_updates
            assert len(rpc.update_payloads) == 1
            (delivered,) = rpc.update_payloads[0]
            assert delivered["id"] == "a-1"
            assert delivered["client_status"] == "complete"
        finally:
            client.shutdown()

    def test_flush_retry_resnapshots_queue(self, monkeypatch):
        """Regression: a retry attempt must re-snapshot the
        queue, never re-send a payload a newer update superseded
        mid-burst (the stale re-send would regress a terminal status
        on the server)."""
        import nomad_tpu_torch.client.client as client_mod
        from nomad_tpu_torch.utils.retry import RetryPolicy

        monkeypatch.setattr(
            client_mod, "UPDATE_ALLOC_POLICY",
            RetryPolicy(base=0.01, max_delay=0.02, max_attempts=3,
                        retryable=lambda e: isinstance(e, Exception),
                        name="test.update_alloc"))

        client = _make_client(None)  # handler installed below

        class _FailOnceThenRecord:
            def __init__(self):
                self.payloads = []
                self.failed = False

            def call(self, method, args, timeout=None):
                if method != "Node.UpdateAlloc":
                    return {"heartbeat_ttl": 10.0}
                if not self.failed:
                    self.failed = True
                    # Simulate a runner queueing a NEWER status while
                    # this attempt is failing.
                    with client._update_lock:
                        client._pending_updates["a-1"] = {
                            "id": "a-1", "client_status": "complete",
                            "client_description": "",
                            "task_states": {}, "node_id": "n-1"}
                    raise ConnectionError("first attempt lost")
                self.payloads.append(args["alloc"])
                return {}

        rpc = _FailOnceThenRecord()
        client.rpc = rpc
        try:
            client._sync_alloc_status(_alloc_update("a-1", "running"))
            assert len(rpc.payloads) == 1
            (delivered,) = rpc.payloads[0]
            assert delivered["client_status"] == "complete"  # not stale
            with client._update_lock:
                assert not client._pending_updates
        finally:
            client.shutdown()

    def test_update_alloc_success_path_unqueued(self):
        rpc = _ScriptedRPC()
        client = _make_client(rpc)
        try:
            client._sync_alloc_status(_alloc_update("a-2", "running"))
            with client._update_lock:
                assert not client._pending_updates
            assert len(rpc.update_payloads) == 1
        finally:
            client.shutdown()

    def test_register_backoff_with_injected_fault(self, monkeypatch,
                                                  caplog):
        """Registration under an injected rpc.send fault
        retries with capped backoff and logs one traceback then
        one-line WARNs — and eventually registers."""
        import nomad_tpu_torch.client.client as client_mod

        monkeypatch.setattr(client_mod, "REGISTER_RETRY_INTERVAL", 0.02)
        monkeypatch.setattr(client_mod, "REGISTER_RETRY_MAX", 0.05)
        srv = port_server(enable_rpc=True, num_schedulers=0)
        srv.establish_leadership()
        client = None
        try:
            from nomad_tpu_torch.client import Client, ClientConfig

            client = Client(ClientConfig(
                servers=[srv.rpc_address()],
                options={"fingerprint.skip_accel": "1"}))
            plan = FaultPlan().add("rpc.send", "error", count=3,
                                   method="Node.Register")
            with caplog.at_level(logging.WARNING, logger="nomad_tpu_torch"):
                with faultinject.injected(plan):
                    client._register()
            assert srv.fsm.state.node_by_id(client.node.id) is not None
            assert plan.fire_count("rpc.send") == 3
            warns = [r for r in caplog.records
                     if "registration" in r.getMessage()]
            assert len(warns) == 3
            assert all(r.levelno == logging.WARNING for r in warns)
            # Traceback on the first only; the rest are one-liners.
            assert warns[0].exc_info
            assert not any(r.exc_info for r in warns[1:])
        finally:
            if client is not None:
                client.shutdown()
            srv.shutdown()

    def test_register_gives_up_on_shutdown(self, monkeypatch):
        """The capped backoff honors shutdown: _register returns when
        the client stops, instead of spinning forever."""
        import nomad_tpu_torch.client.client as client_mod

        monkeypatch.setattr(client_mod, "REGISTER_RETRY_INTERVAL", 0.02)
        monkeypatch.setattr(client_mod, "REGISTER_RETRY_MAX", 0.05)

        class _DeadRPC:
            def call(self, method, args, timeout=None):
                raise ConnectionError("nobody home")

        client = _make_client(_DeadRPC())
        t = threading.Thread(target=client._register, daemon=True)
        t.start()
        time.sleep(0.1)  # sleep-ok: park _register inside its backoff sleep
        client._shutdown.set()
        t.join(2.0)
        assert not t.is_alive()
        client.shutdown()


# -- parity with the JAX package ---------------------------------------------


def _pkg(package):
    get = importlib.import_module
    return dict(
        client=get(f"{package}.client"),
        fingerprint=get(f"{package}.client.fingerprint"),
        task_env=get(f"{package}.client.task_env"),
        alloc_runner=get(f"{package}.client.alloc_runner"),
        task_runner=get(f"{package}.client.task_runner"),
        mock=get(f"{package}.mock"),
        structs=get(f"{package}.structs"),
        server=get(f"{package}.server"))


HOST_FILES = ("/proc/cpuinfo", "/proc/meminfo")


@pytest.fixture
def frozen_host(monkeypatch):
    """The host as both packages see it at one instant: /proc/cpuinfo
    (whose MHz moves with the clock), /proc/meminfo and the free disk
    read once and served to every later read."""
    import io

    snap = {}
    for path in HOST_FILES:
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


FINGERPRINT_OPTIONS = {
    "defaults": {},
    "network-ip": {"network.ip": "10.1.2.3", "network.speed": "250"},
    "consul": {"consul.address": "127.0.0.1:8500"},
    "denylist": {"fingerprint.denylist": "network,storage"},
    "raw-exec": {"driver.raw_exec.enable": "1"},
}


def _fingerprint(package, options, alloc_dir):
    m = _pkg(package)
    node = m["structs"].Node()
    cfg = m["client"].ClientConfig(alloc_dir=alloc_dir, options=options)
    applied = m["fingerprint"].fingerprint_node(cfg, node)
    return dict(applied=applied, attributes=node.attributes,
                resources=node.resources.to_dict(), links=node.links,
                name=node.name)


@pytest.mark.parametrize("name", sorted(FINGERPRINT_OPTIONS))
def test_fingerprint_node_equals_the_jax_one(name, tmp_path, frozen_host):
    """Every detector but ``accel`` in this process (the suite forces
    JAX onto 8 virtual CPU devices); ``accel`` in the next test."""
    options = dict(FINGERPRINT_OPTIONS[name], **{
        "fingerprint.skip_accel": "1"})
    want = _fingerprint("nomad_tpu", options, str(tmp_path))
    got = _fingerprint("nomad_tpu_torch", options, str(tmp_path))
    assert got == want
    assert "accel" not in got["applied"]


ACCEL_SCRIPT = r"""
import builtins, io, json, shutil, sys
snap = {p: open(p).read() for p in ("/proc/cpuinfo", "/proc/meminfo")}
real_open = builtins.open
builtins.open = lambda f, *a, **k: (io.StringIO(snap[f]) if f in snap
                                    else real_open(f, *a, **k))
usage = shutil.disk_usage("/")
shutil.disk_usage = lambda path: usage
out = {}
for package in ("nomad_tpu", "nomad_tpu_torch"):
    fp = __import__(package + ".client.fingerprint", fromlist=["x"])
    client = __import__(package + ".client", fromlist=["x"])
    structs = __import__(package + ".structs", fromlist=["x"])
    node = structs.Node()
    cfg = client.ClientConfig(alloc_dir=sys.argv[1])
    applied = fp.fingerprint_node(cfg, node)
    out[package] = dict(applied=applied, attributes=node.attributes,
                        resources=node.resources.to_dict(),
                        links=node.links)
print(json.dumps(out))
"""


def test_accel_fingerprint_equals_the_jax_cpu_backend(tmp_path):
    """The whole chain with ``accel``, in an interpreter where JAX runs
    its CPU backend as it comes (one device, not the suite's 8): the
    port reports what JAX reports there, on a host without CUDA."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", ACCEL_SCRIPT, str(tmp_path)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    both = json.loads(out.stdout.strip().splitlines()[-1])
    assert both["nomad_tpu_torch"] == both["nomad_tpu"]
    accel = {k: v for k, v in both["nomad_tpu"]["attributes"].items()
             if k.startswith("accel.")}
    assert accel == {"accel.count": "1", "accel.platform": "cpu",
                     "accel.kind.cpu": "1"}


def test_accel_fingerprint_reads_the_cards_on_a_cuda_host(monkeypatch):
    names = ["NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3",
             "NVIDIA A100-SXM4-80GB"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(names))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: names[i])
    node = Node()
    assert accel_fingerprint(ClientConfig(), node)
    assert node.attributes == {
        "accel.count": "3", "accel.platform": "gpu",
        "accel.kind.nvidia-h100-80gb-hbm3": "2",
        "accel.kind.nvidia-a100-sxm4-80gb": "1"}
    skipped = Node()
    assert not accel_fingerprint(
        ClientConfig(options={"fingerprint.skip_accel": "1"}), skipped)
    assert skipped.attributes == {}


ENV_CASES = {
    "bare": dict(task={"name": "t", "driver": "raw_exec"}),
    "dirs": dict(task={"name": "t", "driver": "raw_exec"},
                 alloc_dir="/a", task_dir="/t"),
    "full": dict(
        task={"name": "t", "driver": "raw_exec",
              "env": {"CUSTOM": "yes", "NOMAD_CPU_LIMIT": "override"},
              "meta": {"owner": "ops", "Tier": "gold"},
              "resources": {"cpu": 250, "memory_mb": 128}},
        alloc_dir="/a", task_dir="/t",
        resources={"cpu": 500, "memory_mb": 256, "networks": [{
            "ip": "10.0.0.5", "reserved_ports": [22, 8080, 9090],
            "dynamic_ports": ["http", "admin"], "mbits": 10}]}),
    "meta-arg": dict(task={"name": "t", "driver": "raw_exec",
                           "meta": {"owner": "ops"}},
                     meta={"region": "emea"}),
}


@pytest.mark.parametrize("name", sorted(ENV_CASES))
def test_task_environment_equals_the_jax_one(name):
    case = ENV_CASES[name]
    envs = []
    for package in ("nomad_tpu", "nomad_tpu_torch"):
        m = _pkg(package)
        structs = m["structs"]
        task = structs.Task.from_dict(case["task"])
        res = (structs.Resources.from_dict(case["resources"])
               if "resources" in case else None)
        envs.append(m["task_env"].task_environment(
            task, alloc_dir=case.get("alloc_dir"),
            task_dir=case.get("task_dir"), resources=res,
            meta=case.get("meta")))
    assert envs[0] == envs[1]
    assert envs[0]


def _sleeper_alloc(package):
    m = _pkg(package)
    structs = m["structs"]
    job = m["mock"].job()
    tg = job.task_groups[0]
    tg.tasks = [structs.Task(
        name="sleeper", driver="raw_exec",
        config={"command": "/bin/sleep", "args": "30"},
        resources=structs.Resources(cpu=100, memory_mb=64))]
    alloc = m["mock"].alloc()
    alloc.id = "0d15ea5e-0000-4000-8000-000000000011"
    alloc.job, alloc.job_id, alloc.task_group = job, job.id, tg.name
    alloc.task_resources = {}
    return alloc


@pytest.mark.parametrize("writer,reader", [
    ("nomad_tpu", "nomad_tpu_torch"), ("nomad_tpu_torch", "nomad_tpu")])
def test_alloc_state_restores_across_packages(writer, reader, tmp_path):
    """One package's AllocRunner runs a sleeper and persists its state;
    the other's restores the alloc from ``state.json`` and re-attaches
    to the same PID through the task handle file; each file the reader
    writes back equals the writer's byte for byte."""
    root, state_dir = str(tmp_path / "alloc"), str(tmp_path / "state")
    w = _pkg(writer)["alloc_runner"].AllocRunner(
        _sleeper_alloc(writer), root, state_dir=state_dir)
    w.run()
    paths = [os.path.join(state_dir, n)
             for n in ("state.json", "task-sleeper.json")]

    def persisted_running():
        # The runner publishes the status, then writes state.json: wait
        # for the file, or it may still hold the pending alloc.
        try:
            with open(paths[0]) as fh:
                return json.load(fh)["alloc"]["client_status"] == "running"
        except (OSError, ValueError, KeyError):
            return False
    wait_until(lambda: w.alloc.client_status == "running"
               and persisted_running(), msg="writer's task running")
    pid = w.task_runners["sleeper"].handle.pid
    written = []
    for path in paths:
        with open(path, "rb") as fh:
            written.append(fh.read())
    # The writer's process exits here (in one process its runner
    # threads stay, cut off from the state dir, reaping the task).
    w.state_dir = ""
    w.task_runners["sleeper"].state_dir = ""
    r = _pkg(reader)["alloc_runner"].AllocRunner.restore(root, state_dir)
    assert type(r).__module__.split(".")[0] == reader
    r.run(restore=True)
    tr = r.task_runners["sleeper"]
    try:
        wait_until(lambda: tr.state == "running", msg="re-attached")
        assert tr.handle.pid == pid
        assert tr.handle.proc is None  # adopted, not started again
        tr.save_state()
        for path, want in zip(paths, written):
            with open(path, "rb") as fh:
                assert fh.read() == want, path
        assert json.loads(written[1])["handle_id"] == f"raw:{pid}"
    finally:
        r.destroy_tasks()
        wait_until(lambda: tr.state == "dead", msg="reader killed it")
        wait_until(lambda: w.task_runners["sleeper"].state == "dead",
                   msg="writer reaped it")
    wait_until(lambda: r.alloc.client_status == "dead",
               msg="the reader's alloc dead")


RAW_JOB_OUTPUT = "twin-output"


def _raw_job(package):
    m = _pkg(package)
    structs = m["structs"]
    job = m["mock"].job()
    job.task_groups[0].count = 1
    job.task_groups[0].tasks = [structs.Task(
        name="hello", driver="raw_exec",
        config={"command": "/bin/sh",
                "args": f"-c 'echo {RAW_JOB_OUTPUT}'"},
        resources=structs.Resources(cpu=100, memory_mb=64))]
    job.constraints = []
    return job


def _run_against(client_pkg, server_pkg, state_dir, alloc_dir):
    """A ``client_pkg`` Client against a ``server_pkg`` server over the
    wire: registers, runs one raw_exec job to ``dead``; returns its
    ``Node.Register`` payload with the node id taken out."""
    c, s = _pkg(client_pkg), _pkg(server_pkg)
    kw = dict(device="cpu", tune_gc=False) \
        if server_pkg == "nomad_tpu_torch" else {}
    srv = s["server"].Server(s["server"].ServerConfig(
        num_schedulers=2, enable_rpc=True, **kw))
    srv.establish_leadership()
    payloads = []
    client = None
    try:
        os.makedirs(alloc_dir)
        client = c["client"].Client(c["client"].ClientConfig(
            state_dir=state_dir, alloc_dir=alloc_dir,
            servers=[srv.rpc_address()],
            options={"driver.raw_exec.enable": "1",
                     "fingerprint.skip_accel": "1"}))
        call = client.rpc.call

        def recorded(method, args, timeout=None):
            if method == "Node.Register":
                payloads.append(json.loads(json.dumps(args)))
            return call(method, args, timeout=timeout)
        client.rpc.call = recorded
        client.start()
        wait_until(lambda: srv.fsm.state.node_by_id(client.node.id)
                   is not None, msg="node registration")
        job = _raw_job(server_pkg)
        _, eval_id = srv.job_register(job)
        srv.wait_for_evals([eval_id], timeout=15)

        def done():
            allocs = srv.fsm.state.allocs_by_job(job.id)
            return allocs and allocs[0].client_status == "dead"
        wait_until(done, timeout=20, msg="alloc ran to completion")
        alloc = srv.fsm.state.allocs_by_job(job.id)[0]
        log = os.path.join(client._alloc_root(alloc.id), "alloc", "logs",
                           "hello.stdout")
        with open(log) as fh:
            assert fh.read() == RAW_JOB_OUTPUT + "\n"
    finally:
        if client is not None:
            client.shutdown()
            client.destroy_all()
        srv.shutdown()
    shutil.rmtree(alloc_dir)
    (payload,) = payloads
    node_id = payload["node"].pop("id")
    assert node_id == client.node.id
    return payload


def test_clients_run_jobs_from_the_other_packages_server(tmp_path,
                                                         frozen_host):
    """A JAX Client runs a raw_exec job placed by the port's server, and
    a port Client one placed by the JAX server, both over the wire;
    their Node.Register payloads are equal apart from the node id (the
    alloc dir, which the storage detector reports, is the same path)."""
    alloc_dir = str(tmp_path / "allocs")
    from_jax = _run_against("nomad_tpu", "nomad_tpu_torch",
                            str(tmp_path / "jax-state"), alloc_dir)
    from_port = _run_against("nomad_tpu_torch", "nomad_tpu",
                             str(tmp_path / "port-state"), alloc_dir)
    assert from_port == from_jax
    assert from_port["node"]["status"] == "ready"
    assert from_port["node"]["attributes"]["driver.raw_exec"] == "1"
