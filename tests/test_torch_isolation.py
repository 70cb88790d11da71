"""The port stands alone: nomad_tpu_torch imports neither JAX nor the JAX
package, its entry points run on the card unless told otherwise, and
CPU tensors go through the plain versions without a kernel launch."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nomad_tpu.mock as mock
from nomad_tpu_torch import convert

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "nomad_tpu_torch")


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    files = []
    for root, _dirs, names in os.walk(PACKAGE):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "nomad_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert bad == []


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import nomad_tpu_torch, nomad_tpu_torch.scheduler\n"
        "import nomad_tpu_torch.convert, nomad_tpu_torch.mock\n"
        "import nomad_tpu_torch.scheduler.batch\n"
        "import nomad_tpu_torch.ops.plan_conflict\n"
        "import nomad_tpu_torch.server.plan_apply\n"
        "import nomad_tpu_torch.utils.gctune, nomad_tpu_torch.utils.metrics\n"
        "import nomad_tpu_torch.parallel.mesh, nomad_tpu_torch.ops.verify_policy\n"
        "import nomad_tpu_torch.structs.node_slab\n"
        "import nomad_tpu_torch.structs.alloc_slab\n"
        "import nomad_tpu_torch.utils.native\n"
        "import nomad_tpu_torch.scheduler.system\n"
        "import nomad_tpu_torch.scheduler.system_vec\n"
        "import nomad_tpu_torch.scheduler.executor\n"
        "import nomad_tpu_torch.scheduler.breaker\n"
        "import nomad_tpu_torch.scheduler.pipeline\n"
        "import nomad_tpu_torch.ops.binpack_host\n"
        "import nomad_tpu_torch.server\n"
        "import nomad_tpu_torch.server.server, nomad_tpu_torch.server.worker\n"
        "import nomad_tpu_torch.server.eval_broker\n"
        "import nomad_tpu_torch.server.plan_queue\n"
        "import nomad_tpu_torch.server.fsm, nomad_tpu_torch.server.raft\n"
        "import nomad_tpu_torch.server.heartbeat\n"
        "import nomad_tpu_torch.server.core_sched\n"
        "import nomad_tpu_torch.server.overload\n"
        "import nomad_tpu_torch.server.timetable\n"
        "import nomad_tpu_torch.structs.codec, nomad_tpu_torch.utils.retry\n"
        "import nomad_tpu_torch.faultinject\n"
        "import nomad_tpu_torch.faultinject.plan\n"
        "import nomad_tpu_torch.obs, nomad_tpu_torch.obs.trace\n"
        "import nomad_tpu_torch.obs.registry, nomad_tpu_torch.obs.flight\n"
        "import nomad_tpu_torch.utils.profiling\n"
        "import nomad_tpu_torch.server.mux, nomad_tpu_torch.server.rpc\n"
        "import nomad_tpu_torch.server.endpoints\n"
        "import nomad_tpu_torch.agent, nomad_tpu_torch.agent.swarm\n"
        "import nomad_tpu_torch.client, nomad_tpu_torch.client.client\n"
        "import nomad_tpu_torch.client.driver\n"
        "import nomad_tpu_torch.client.fingerprint\n"
        "import nomad_tpu_torch.client.alloc_runner\n"
        "import nomad_tpu_torch.jobspec, nomad_tpu_torch.jobspec.parse\n"
        "import nomad_tpu_torch.utils.duration\n"
        "import nomad_tpu_torch.agent.agent, nomad_tpu_torch.agent.config\n"
        "import nomad_tpu_torch.agent.http_server\n"
        "import nomad_tpu_torch.api, nomad_tpu_torch.api.client\n"
        "import nomad_tpu_torch.cli, nomad_tpu_torch.cli.main\n"
        "import nomad_tpu_torch.utils.gated_log\n"
        "import nomad_tpu_torch.server.gossip\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nomad_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


# The serving plane's modules (obs/, the RPC plane, the agent swarm,
# profiling): each exists and imports neither JAX nor the JAX package.
SERVING_PLANE = ("obs/__init__.py", "obs/trace.py", "obs/registry.py",
                 "obs/flight.py", "agent/__init__.py", "agent/swarm.py",
                 "server/mux.py", "server/rpc.py", "server/endpoints.py",
                 "utils/profiling.py")


@pytest.mark.parametrize("rel", SERVING_PLANE)
def test_serving_plane_module_imports_neither_jax_nor_the_jax_package(rel):
    path = os.path.join(PACKAGE, rel)
    assert os.path.isfile(path)
    mods = list(_imported_modules(path))
    bad = [m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "nomad_tpu")]
    assert bad == []


# The client slice's modules: the client agent, its six drivers, the
# jobspec parser and the duration strings it reads.
CLIENT_SLICE = ("client/__init__.py", "client/client.py",
                "client/config.py", "client/task_env.py",
                "client/allocdir.py", "client/artifact.py",
                "client/fingerprint.py", "client/task_runner.py",
                "client/alloc_runner.py", "client/driver/__init__.py",
                "client/driver/base.py", "client/driver/raw_exec.py",
                "client/driver/exec_driver.py", "client/driver/java.py",
                "client/driver/qemu.py", "client/driver/docker.py",
                "client/driver/rkt.py", "jobspec/__init__.py",
                "jobspec/hcl.py", "jobspec/parse.py", "utils/duration.py")


@pytest.mark.parametrize("rel", CLIENT_SLICE)
def test_client_slice_module_imports_neither_jax_nor_the_jax_package(rel):
    path = os.path.join(PACKAGE, rel)
    assert os.path.isfile(path)
    mods = list(_imported_modules(path))
    bad = [m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "nomad_tpu")]
    assert bad == []


def test_client_modules_are_the_jax_packages():
    """Every module of the JAX package's client/ and jobspec/ has its
    port at the same path."""
    jax_pkg = os.path.join(REPO, "nomad_tpu")
    for sub in ("client", "client/driver", "jobspec"):
        names = sorted(n for n in os.listdir(os.path.join(jax_pkg, sub))
                       if n.endswith(".py"))
        assert [f"{sub}/{n}" for n in names] == sorted(
            r for r in CLIENT_SLICE if os.path.dirname(r) == sub)


# The agent slice's modules: the agent, its config files and HTTP API,
# the api client, the CLI, the boot-log gate and gossip.
AGENT_SLICE = ("agent/agent.py", "agent/config.py", "agent/http_server.py",
               "api/__init__.py", "api/client.py", "cli/__init__.py",
               "cli/__main__.py", "cli/main.py", "utils/gated_log.py",
               "server/gossip.py")


@pytest.mark.parametrize("rel", AGENT_SLICE)
def test_agent_slice_module_imports_neither_jax_nor_the_jax_package(rel):
    path = os.path.join(PACKAGE, rel)
    assert os.path.isfile(path)
    mods = list(_imported_modules(path))
    bad = [m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "nomad_tpu")]
    assert bad == []


def test_agent_modules_are_the_jax_packages():
    """Every module of the JAX package's agent/, api/ and cli/ has its
    port at the same path (agent/swarm.py came with the serving
    plane)."""
    jax_pkg = os.path.join(REPO, "nomad_tpu")
    for sub in ("agent", "api", "cli"):
        names = sorted(n for n in os.listdir(os.path.join(jax_pkg, sub))
                       if n.endswith(".py"))
        ported = sorted(n for n in os.listdir(os.path.join(PACKAGE, sub))
                        if n.endswith(".py"))
        assert ported == names, sub


def test_obs_imports_nothing_of_the_port_outside_utils():
    """The JAX package's layering: obs/ may be imported by every other
    subsystem, so it imports only ``utils`` of its own package."""
    for rel in SERVING_PLANE[:4]:
        for mod in _imported_modules(os.path.join(PACKAGE, rel)):
            parts = mod.split(".")
            if parts[0] == "nomad_tpu_torch":
                assert parts[1] in ("utils", "obs"), (rel, mod)


def test_entry_points_raise_without_cuda(monkeypatch):
    """Without a CUDA device the defaults raise; they never fall back to
    the CPU.  (Forced unavailable so the test means the same on a
    machine with a card.)"""
    from nomad_tpu_torch.parallel import devices
    from nomad_tpu_torch.scheduler import Harness, TorchBinPackScheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Harness()
    with pytest.raises(RuntimeError):
        TorchBinPackScheduler(None, None, batch=False)
    with pytest.raises(RuntimeError):
        devices.default_device()
    with pytest.raises(RuntimeError):
        devices.put_counted(np.zeros(3), "cuda")
    h = Harness(device="cpu")
    assert h.device == torch.device("cpu")
    from nomad_tpu_torch.agent import Agent, AgentConfig
    with pytest.raises(RuntimeError):
        Agent(AgentConfig.dev())


def test_cli_agent_runs_on_the_card():
    """``python -m nomad_tpu_torch.cli agent -dev`` means the card: with
    none visible it exits 1 naming it; ``-device cpu`` is how a caller
    asks for the CPU (the agent then starts, shown by its HTTP line,
    and stops on SIGTERM with exit 0)."""
    import signal

    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               PYTHONUNBUFFERED="1")
    argv = [sys.executable, "-m", "nomad_tpu_torch.cli", "agent", "-dev",
            "-http-port", "0", "-rpc-port", "0"]
    out = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr
    proc = subprocess.Popen(argv + ["-device", "cpu"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "HTTP:" in line:
                break
        assert any("HTTP: http://127.0.0.1:" in ln for ln in lines), lines
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    from nomad_tpu_torch.models import fleet
    from nomad_tpu_torch.ops import binpack

    before = (binpack.place_sequence.launches, binpack.place_rounds.launches,
              fleet.scatter_rows.launches)
    n, g = 8, 2
    cap = torch.full((n, 6), 1000.0)
    res = torch.zeros((n, 6))
    usage = torch.zeros((n, 6))
    jc = torch.zeros(n, dtype=torch.int32)
    feas = torch.ones((g, n), dtype=torch.bool)
    asks = torch.full((g, 6), 10.0)
    distinct = torch.zeros(g, dtype=torch.bool)
    chosen, _s, _u = binpack.place_sequence(
        cap, res, usage, jc, feas, asks, distinct,
        torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
        10.0)
    assert chosen.tolist() == [0, 1, 2, 3]
    chosen, _s, _u = binpack.place_rounds(
        cap, res, usage, jc, feas, asks, distinct,
        torch.tensor([3, 0], dtype=torch.int32), 10.0, k_cap=4, rounds=1)
    assert chosen[0].tolist() == [0, 1, 2, -1]
    fleet.scatter_rows(usage, torch.tensor([1], dtype=torch.int32),
                       torch.ones((1, 6)))
    assert (binpack.place_sequence.launches, binpack.place_rounds.launches,
            fleet.scatter_rows.launches) == before


def test_wrappers_refuse_tensors_on_two_devices():
    from nomad_tpu_torch.ops import kernels

    with pytest.raises(ValueError):
        kernels.route({"a": torch.zeros(1), "b": torch.zeros(1,
                                                             device="meta")})


def test_convert_round_trips_nodes_jobs_and_allocs():
    nodes = [mock.node(i) for i in range(3)]
    jobs = [mock.job(), mock.system_job()]
    allocs = [mock.alloc() for _ in range(2)]
    for src, conv in ((nodes, convert.nodes_from_reference),
                      (jobs, convert.jobs_from_reference),
                      (allocs, convert.allocs_from_reference)):
        out = conv(src)
        assert [type(o).__module__.split(".")[0] for o in out] == \
            ["nomad_tpu_torch"] * len(src)
        assert [o.to_dict() for o in out] == [s.to_dict() for s in src]
    # plain dicts are taken as they are
    (node,) = convert.nodes_from_reference([nodes[0].to_dict()])
    assert node.to_dict() == nodes[0].to_dict()
