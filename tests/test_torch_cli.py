"""The port's CLI against the JAX package's.

Twins of tests/test_cli_args.py on ``python -m nomad_tpu_torch.cli``
(in process: no agent needed for argument errors); ``lint``, whose
analyzers are not ported, refusing by name; ``agent -dev`` without
``-device`` meaning the card; and twins of tests/test_blackbox.py's
process-boundary cases on subprocess agents ``agent ... -device cpu``
(the real agent process driven over HTTP: submit, schedule, run,
reload, graceful shutdown, SIGKILL and re-attach).  The three-server
failover case needs networked raft, which is not ported.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from nomad_tpu_torch.cli.main import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def run_cli(argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:  # argparse errors exit(2)
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("argv", [
    ["validate"],                 # missing file
    ["run"],                      # missing file
    ["stop"],                     # missing job id
    ["status", "--bogus-flag"],
    ["node-drain"],               # missing node + mode
    ["alloc-status"],             # missing alloc id
    ["eval-monitor"],             # missing eval id
    ["server-join"],              # missing address
    ["server-force-leave"],       # missing node
    ["no-such-command"],
])
def test_bad_args_fail_with_usage(argv, capsys):
    rc, out, err = run_cli(argv, capsys)
    assert rc not in (0, None), argv
    assert "usage" in (out + err).lower(), argv


def test_validate_missing_file_errors(tmp_path, capsys):
    rc, out, err = run_cli(
        ["validate", str(tmp_path / "nope.hcl")], capsys)
    assert rc != 0
    # A real file error, not a bogus agent connection message.
    assert "Error reading" in err
    assert "connecting" not in err

    rc, out, err = run_cli(["run", str(tmp_path / "nope.hcl")], capsys)
    assert rc != 0 and "Error reading" in err


def test_validate_bad_spec_errors(tmp_path, capsys):
    bad = tmp_path / "bad.hcl"
    bad.write_text('job "x" { priority = "high" }')
    rc, out, err = run_cli(["validate", str(bad)], capsys)
    assert rc != 0
    assert "validation failed" in (out + err).lower()


def test_init_refuses_to_clobber(tmp_path, capsys, monkeypatch):
    """init + validate roundtrip is covered by test_agent_api; the
    clobber refusal (reference init_test.go) is the new bit."""
    monkeypatch.chdir(tmp_path)
    rc, _out, _err = run_cli(["init"], capsys)
    assert rc == 0
    rc, _out, _err = run_cli(["init"], capsys)
    assert rc != 0


def test_connection_refused_is_clean_error(capsys):
    """Commands against a dead agent fail with a clean message; an
    uncaught exception would propagate out of run_cli and ERROR the
    test, which IS the traceback check (reference meta_test paths)."""
    rc, out, err = run_cli(
        ["-address", "http://127.0.0.1:1", "status"], capsys)
    assert rc != 0
    assert "Error connecting" in err


# ---------------------------------------------------------------------------
# what the port's CLI does differently, on purpose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["lint"],
    ["lint", "-json"],
    ["lint", "nomad_tpu_torch", "-strict", "-changed", "HEAD"],
], ids=["plain", "json", "changed"])
def test_lint_refuses_and_names_the_roadmap_item(argv, capsys):
    """The JAX CLI's lint reads ``analysis/``, which the port does not
    have yet: every form of the command exits 1 and says so."""
    rc, out, err = run_cli(argv, capsys)
    assert rc == 1 and out == ""
    assert "not ported" in err and "ROADMAP Queue 1 item 4" in err


def test_lint_imports_nothing_of_the_jax_package():
    code = ("import sys\n"
            "from nomad_tpu_torch.cli import main\n"
            "rc = main(['lint'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'nomad_tpu')]\n"
            "assert rc == 1 and not bad, (rc, bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ROADMAP Queue 1 item 4" in proc.stderr


def test_version_prints_the_ports_version(capsys):
    import nomad_tpu_torch

    rc, out, _err = run_cli(["version"], capsys)
    assert rc == 0
    assert out.strip() == f"nomad-tpu v{nomad_tpu_torch.__version__}"


def test_every_jax_subcommand_is_taken(monkeypatch):
    """``python -m nomad_tpu_torch.cli`` takes every subcommand the JAX
    CLI takes, with the same flags; ``agent`` has one more,
    ``-device``.  (Each CLI's parser is caught at its ``parse_args``.)"""
    import argparse
    import importlib

    jmain_mod = importlib.import_module("nomad_tpu.cli.main")
    tmain_mod = importlib.import_module("nomad_tpu_torch.cli.main")

    def flags(mod):
        captured = {}

        def grab(self, args=None, namespace=None):
            captured["parser"] = self
            raise SystemExit(0)
        with monkeypatch.context() as m:
            m.setattr(argparse.ArgumentParser, "parse_args", grab)
            with pytest.raises(SystemExit):
                mod.main([])
        sub = next(a for a in captured["parser"]._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {name: sorted(o for a in p._actions
                             for o in a.option_strings)
                for name, p in sub.choices.items()}
    jflags, tflags = flags(jmain_mod), flags(tmain_mod)
    assert sorted(tflags) == sorted(jflags) == sorted(tmain_mod.COMMANDS)
    assert tflags.pop("agent") == sorted(jflags.pop("agent")
                                         + ["-device"])
    assert tflags == jflags


def test_agent_dev_without_device_means_the_card(tmp_path):
    """``agent -dev`` with no ``-device`` runs on the card: with no card
    visible it exits non-zero, names the card, and serves nothing."""
    proc = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.cli", "agent", "-dev",
         "-http-port", "0", "-rpc-port", "0"],
        env=_env(CUDA_VISIBLE_DEVICES=""), cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "card" in proc.stderr
    assert "HTTP:" not in proc.stdout


# ---------------------------------------------------------------------------
# the real agent process (tests/test_blackbox.py's rig)
# ---------------------------------------------------------------------------

JOB = {"job": {
    "id": "bb", "name": "bb", "type": "service",
    "datacenters": ["dc1"],
    "task_groups": [{
        "name": "tg", "count": 2,
        "tasks": [{"name": "sleep", "driver": "raw_exec",
                   "config": {"command": "/bin/sleep", "args": "300"},
                   "resources": {"cpu": 50, "memory_mb": 16}}]}]}}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http(method: str, url: str, body=None, timeout=10):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"null")


@pytest.fixture
def agent_proc(tmp_path):
    cfg = tmp_path / "agent.hcl"
    cfg.write_text('log_level = "WARN"\n')
    proc, base, _rpc = _spawn_agent(tmp_path, "dev", "-dev",
                                    "-config", str(cfg))
    _wait_http(proc, base)
    yield proc, base
    if proc.poll() is None:
        proc.kill()
        proc.wait(10)


def _spawn_agent(tmp_path, tag, *argv):
    http_port = _free_port()
    rpc_port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch.cli", "agent",
         "-http-port", str(http_port), "-rpc-port", str(rpc_port),
         "-serf-port", "0",  # ephemeral: parallel agents never collide
         "-device", "cpu",
         "-data-dir", str(tmp_path / f"data-{tag}")] + list(argv),
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, f"http://127.0.0.1:{http_port}", rpc_port


def _wait_http(proc, base, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"agent died:\n{proc.stdout.read()}")
        try:
            return _http("GET", base + "/v1/agent/self", timeout=2)
        except Exception:
            time.sleep(0.2)  # sleep-ok: poll interval of the bounded wait
    raise AssertionError("agent never served HTTP")


def _write_client_cfg(tmp_path):
    cfg = tmp_path / "client.hcl"
    cfg.write_text(
        'client {\n'
        '  options {\n'
        '    "driver.raw_exec.enable" = "1"\n'
        '    "fingerprint.skip_accel" = "1"\n'
        '  }\n'
        '}\n')
    return cfg


def wait_for(fn, msg, timeout=45):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.3)  # sleep-ok: poll interval of the bounded wait
    raise AssertionError(f"timeout: {msg}")


def test_blackbox_two_process_cluster(tmp_path):
    """A server-only agent and a client-only agent as separate OS
    processes: registration, heartbeats, long-poll alloc delivery, and
    task execution all cross a real process + network boundary."""
    server = client = None
    try:
        server, server_base, server_rpc = _spawn_agent(
            tmp_path, "srv", "-server")
        _wait_http(server, server_base)
        cli_cfg = _write_client_cfg(tmp_path)
        client, client_base, _ = _spawn_agent(
            tmp_path, "cli", "-client",
            "-servers", f"127.0.0.1:{server_rpc}",
            "-config", str(cli_cfg))
        _wait_http(client, client_base)

        # Client node registers with the server over real RPC.
        wait_for(lambda: any(
            n["status"] == "ready"
            for n in _http("GET", server_base + "/v1/nodes")),
            "client node ready")

        # A raw_exec task needs the option enabled: client agents enable
        # it via config; dev-mode defaults don't apply here, so use a
        # job the exec fallback can run.
        job = dict(JOB)
        resp = _http("PUT", server_base + "/v1/jobs", job)
        wait_for(lambda: _http(
            "GET",
            f"{server_base}/v1/evaluation/{resp['eval_id']}"
        )["status"] == "complete", "eval complete")
        wait_for(lambda: any(
            a["client_status"] == "running"
            for a in _http("GET", server_base + "/v1/job/bb/allocations")),
            "alloc running on remote client")

        # The client's own HTTP agent-self sees its allocs.
        self_doc = _http("GET", client_base + "/v1/agent/self")
        assert self_doc["stats"]["client"]["allocs"] >= 1
    finally:
        for proc in (client, server):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(10)


def test_blackbox_job_lifecycle(agent_proc):
    proc, base = agent_proc
    resp = _http("PUT", base + "/v1/jobs", JOB)
    eval_id = resp["eval_id"]

    wait_for(lambda: _http(
        "GET", f"{base}/v1/evaluation/{eval_id}")["status"] == "complete",
        "eval complete")
    wait_for(lambda: len([
        a for a in _http("GET", base + "/v1/job/bb/allocations")
        if a["client_status"] == "running"]) == 2, "2 allocs running")

    # SIGHUP config reload across the process boundary.
    proc.send_signal(signal.SIGHUP)
    # SIGUSR1 metrics dump (reference go-metrics InmemSignal).
    proc.send_signal(signal.SIGUSR1)
    time.sleep(1.0)  # sleep-ok: prove the agent SURVIVES the signals
    assert proc.poll() is None, "agent must survive SIGHUP/SIGUSR1"
    self_doc = _http("GET", base + "/v1/agent/self")
    assert self_doc["stats"]["nomad"]["leader"] == "true"

    # Stop the job; allocs wind down.
    _http("DELETE", base + "/v1/job/bb")
    wait_for(lambda: all(
        a["desired_status"] == "stop"
        for a in _http("GET", base + "/v1/job/bb/allocations")),
        "job stopped")

    # Graceful shutdown on SIGTERM.
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(20) == 0
    out = proc.stdout.read()
    assert "shutting down" in out
    assert "metrics snapshot" in out


def test_blackbox_agent_kill9_reattach(tmp_path):
    """Checkpoint/resume across a real process boundary: SIGKILL the
    client agent mid-run, restart it on the same state dir, and the
    task PROCESS must survive and be re-attached — not restarted
    (reference client restore, task_runner.go:92-105; SURVEY §5)."""
    server = client = client2 = None
    pid = None
    pid_job = {"job": {
        "id": "pidjob", "name": "pidjob", "type": "service",
        "datacenters": ["dc1"],
        "task_groups": [{
            "name": "tg", "count": 1,
            "tasks": [{"name": "pidtask", "driver": "raw_exec",
                       "config": {
                           "command": "/bin/sh",
                           "args": "-c 'echo $$ > \"$NOMAD_TASK_DIR/pid\";"
                                   " exec sleep 300'"},
                       "resources": {"cpu": 20, "memory_mb": 16}}]}]}}

    def alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False

    try:
        server, server_base, server_rpc = _spawn_agent(
            tmp_path, "srv", "-server")
        _wait_http(server, server_base)
        cli_cfg = _write_client_cfg(tmp_path)
        spawn_client = lambda: _spawn_agent(
            tmp_path, "cli", "-client",
            "-servers", f"127.0.0.1:{server_rpc}",
            "-config", str(cli_cfg))
        client, client_base, _ = spawn_client()
        _wait_http(client, client_base)
        wait_for(lambda: any(
            n["status"] == "ready"
            for n in _http("GET", server_base + "/v1/nodes")),
            "client node ready")

        _http("PUT", server_base + "/v1/jobs", pid_job)
        wait_for(lambda: any(
            a["client_status"] == "running"
            for a in _http("GET",
                           server_base + "/v1/job/pidjob/allocations")),
            "alloc running")

        # The task wrote its own pid into its task dir.
        import glob

        def read_pid():
            nonlocal pid
            for path in glob.glob(str(tmp_path / "data-cli" / "**" /
                                      "pid"), recursive=True):
                content = open(path).read().strip()
                if content:
                    pid = int(content)
                    return True
            return False
        wait_for(read_pid, "task pid file")
        assert alive(pid)

        # Hard-kill the agent: the task (own session) must survive.
        client.kill()
        client.wait(10)
        assert alive(pid), "task died with the agent"

        # Restart on the same state dir: re-attach, don't restart.
        client2, client2_base, _ = spawn_client()
        _wait_http(client2, client2_base)
        wait_for(lambda: _http(
            "GET", client2_base + "/v1/agent/self"
        )["stats"]["client"]["allocs"] >= 1, "restored alloc", timeout=60)
        assert alive(pid), "task was restarted, not re-attached"
        wait_for(lambda: any(
            a["client_status"] == "running"
            for a in _http("GET",
                           server_base + "/v1/job/pidjob/allocations")),
            "alloc still running after restart")

        # Stopping the job through the restarted agent kills the
        # re-attached process — proving the new handle controls it.
        _http("DELETE", server_base + "/v1/job/pidjob")
        wait_for(lambda: not alive(pid), "re-attached task killed")
    finally:
        # The task detaches into its own session (start_new_session), so
        # killing the agents cannot reap it: kill it directly if the
        # test bailed before the job delete.
        if pid is not None and alive(pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for proc in (client2, client, server):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(10)
