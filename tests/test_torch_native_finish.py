"""The port's native (C) bulk finish against its Python tail and against
the JAX package's native finish.

With the same uuid stream and port-LCG seed the port's native prefix
(nomad_tpu_torch/csrc/port_alloc.cpp, through
``torch_binpack._native_bulk``) and its Python tail must give
BYTE-IDENTICAL plans — same nodes, ports, offers, metrics (apart from
the wall-clock allocation_time) — on both alloc contracts: columnar
(``bulk_finish_cols`` into an AllocSlab) and objects (``bulk_finish``).
Twins of tests/test_native_finish.py's four cases.  Each case is also
run through the JAX package (its own native finish, the repo-root
``_nomad_native``) on the same nodes and jobs (nomad_tpu_torch.convert)
with the same uuids and LCG seed, and held to the parity contract:
equal nodes and ports for every placement, equal failures.

The port's extension is built here with g++ at first use into
nomad_tpu_torch/_build/; a failed build raises.
"""
from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

import nomad_tpu.mock as mock
import nomad_tpu.scheduler.jax_binpack as jb
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.structs import (
    EVAL_TRIGGER_JOB_REGISTER,
    Evaluation,
    NetworkResource,
    Resources,
    Task,
    TaskGroup,
)
from nomad_tpu_torch import convert
from nomad_tpu_torch.scheduler.executor import executor_override as \
    t_executor_override
from nomad_tpu_torch.scheduler import Harness as THarness
from nomad_tpu_torch.scheduler import TorchBinPackScheduler
from nomad_tpu_torch.scheduler import torch_binpack as tb
from nomad_tpu_torch.structs import Evaluation as TEvaluation
from nomad_tpu_torch.structs import alloc_slab
from nomad_tpu_torch.utils import native

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONTRACTS = ["columnar", "object"]


def make_eval(job):
    return Evaluation(id=f"ev-{job.id}", priority=job.priority,
                      type="service",
                      triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                      job_id=job.id)


def _job(n_groups=6, count=2, with_failures=False):
    job = mock.job()
    groups = []
    for g in range(n_groups):
        cpu = 100_000 if (with_failures and g % 3 == 0) else 100
        tg = TaskGroup(
            name=f"tg-{g}", count=count,
            tasks=[
                Task(name="web", driver="exec",
                     resources=Resources(
                         cpu=cpu, memory_mb=64,
                         networks=[NetworkResource(
                             mbits=5, dynamic_ports=["http", "admin"])])),
                Task(name="sidecar", driver="exec",
                     resources=Resources(cpu=50, memory_mb=32)),
            ])
        groups.append(tg)
    job.task_groups = groups
    return job


def _bandwidth_job():
    job = mock.job()
    job.task_groups = [TaskGroup(
        name=f"tg-{g}", count=1,
        tasks=[Task(name="t", driver="exec",
                    resources=Resources(
                        cpu=10, memory_mb=8,
                        networks=[NetworkResource(
                            mbits=400, dynamic_ports=["p"])]))])
        for g in range(8)]
    return job


# name -> (nodes, jobs): tests/test_native_finish.py's four cases.
CASES = {
    "basic": (16, lambda: [_job(n_groups=6, count=2)]),
    "failures": (8, lambda: [_job(n_groups=6, count=3,
                                  with_failures=True)]),
    "busy": (6, lambda: [_job(n_groups=3, count=2),
                         _job(n_groups=4, count=2)]),
    "bandwidth": (2, lambda: [_bandwidth_job()]),
}


def _deterministic(monkeypatch, module):
    counter = {"n": 0}

    def fake_uuids(n):
        base = counter["n"]
        counter["n"] += n
        return [f"u-{base + i:08d}" for i in range(n)]

    monkeypatch.setattr(module, "generate_uuids", fake_uuids)
    monkeypatch.setattr(module, "_randrange", lambda n: 987654321 % n)


def _normalize(plan):
    out = {}
    for node_id, allocs in plan.node_allocation.items():
        rows = []
        for a in allocs:
            d = a.to_dict()
            d["metrics"]["allocation_time"] = 0.0
            rows.append(d)
        out[node_id] = rows
    failed = []
    for a in plan.failed_allocs:
        d = a.to_dict()
        d["metrics"]["allocation_time"] = 0.0
        failed.append(d)
    return out, failed


def _world(case):
    n_nodes, make_jobs = CASES[case]
    return [mock.node(i) for i in range(n_nodes)], make_jobs()


def _run_port(monkeypatch, native_on: bool, contract: str, nodes, jobs,
              starts=None):
    """The JAX-built nodes and jobs, converted, through the port's
    torch-binpack on the CPU; returns the normalized plans.  ``starts``
    collects each finish's native resume index."""
    _deterministic(monkeypatch, tb)
    monkeypatch.setattr(alloc_slab, "COLUMNAR", contract == "columnar")
    if not native_on:
        monkeypatch.setattr(tb, "_native_bulk", lambda: None)
    if starts is not None:
        real = TorchBinPackScheduler._finish_python_tail

        def tail(self, fs):
            starts.append((fs.start_p, len(fs.place)))
            return real(self, fs)
        monkeypatch.setattr(TorchBinPackScheduler, "_finish_python_tail",
                            tail)
    h = THarness(device="cpu")
    for n in convert.nodes_from_reference(nodes):
        h.state.upsert_node(h.next_index(), n)
    plans = []
    for job in convert.jobs_from_reference(jobs):
        h.state.upsert_job(h.next_index(), job)
        with t_executor_override("device"):
            h.process("torch-binpack", TEvaluation.from_dict(
                make_eval(job).to_dict()))
        plans.append(_normalize(h.plans[-1]))
    return plans


def _run_jax(monkeypatch, nodes, jobs):
    _deterministic(monkeypatch, jb)
    h = JHarness()
    for n in nodes:
        h.state.upsert_node(h.next_index(), n)
    plans = []
    for job in jobs:
        h.state.upsert_job(h.next_index(), job)
        h.process("jax-binpack", make_eval(job))
        plans.append(_normalize(h.plans[-1]))
    return plans


def _placements(plans):
    """(job, alloc name) -> (node id, reserved ports), and the failed
    allocs' (name, coalesced count), of normalized plans."""
    placed, failed = {}, []
    for rows, fails in plans:
        for node_id, allocs in rows.items():
            for a in allocs:
                ports = tuple(p for tr in a["task_resources"].values()
                              for net in tr["networks"]
                              for p in net["reserved_ports"])
                placed[(a["job_id"], a["name"])] = (node_id, ports)
        failed += [(f["name"], f["metrics"]["coalesced_failures"])
                   for f in fails]
    return placed, failed


def _check_case(case, plans):
    """The case's own checks, as tests/test_native_finish.py makes
    them."""
    if case == "basic":
        placed, failed = plans[0]
        assert sum(len(v) for v in placed.values()) == 12 and not failed
    elif case == "failures":
        _placed, failed = plans[0]
        assert failed
        assert any(f["metrics"]["coalesced_failures"] > 0 for f in failed)
    elif case == "busy":
        # Ports unique per node across BOTH jobs' offers.
        seen: set = set()
        for placed, _f in plans:
            for node_id, allocs in placed.items():
                for a in allocs:
                    for tr in a["task_resources"].values():
                        for net in tr["networks"]:
                            for port in net["reserved_ports"]:
                                assert (node_id, port) not in seen
                                seen.add((node_id, port))
    else:
        placed, failed = plans[0]
        per_node_bw: dict = {}
        for node_id, allocs in placed.items():
            for a in allocs:
                for tr in a["task_resources"].values():
                    for net in tr["networks"]:
                        per_node_bw[node_id] = \
                            per_node_bw.get(node_id, 0) + net["mbits"]
        # mock nodes advertise 1000 mbits: never oversubscribed.
        assert all(bw <= 1000 for bw in per_node_bw.values())
        assert sum(len(v) for v in placed.values()) + len(failed) >= 5


@pytest.mark.parametrize("contract", CONTRACTS)
@pytest.mark.parametrize("case", list(CASES))
def test_native_prefix_equals_python_tail(monkeypatch, case, contract):
    nodes, jobs = _world(case)
    with monkeypatch.context() as m:
        py = _run_port(m, False, contract, nodes, [j.copy() for j in jobs])
    starts: list = []
    with monkeypatch.context() as m:
        nat = _run_port(m, True, contract, nodes, [j.copy() for j in jobs],
                        starts)
    assert py == nat
    _check_case(case, nat)
    if case in ("basic", "busy"):
        # Nothing to hand back: C finished every placement.
        assert all(s == n for s, n in starts), starts
    if case == "bandwidth":
        # C handed the placement list back when a node's bandwidth
        # filled, and the Python tail took it from there.
        assert starts and starts[0][0] < starts[0][1]


@pytest.mark.parametrize("contract", CONTRACTS)
@pytest.mark.parametrize("case", list(CASES))
def test_native_finish_equals_jax_native_finish(monkeypatch, case,
                                                contract):
    nodes, jobs = _world(case)
    with monkeypatch.context() as m:
        want = _run_jax(m, nodes, [j.copy() for j in jobs])
    with monkeypatch.context() as m:
        got = _run_port(m, True, contract, nodes, [j.copy() for j in jobs])
    assert _placements(got) == _placements(want)


def test_a_config4_shaped_eval_finishes_every_placement_in_c(monkeypatch):
    """No silent fallback: 200 single-task groups with a dynamic port on
    mock nodes (config 4's group shape) finish in C, columnar, with
    every row in the slab."""
    nodes = [mock.node(i) for i in range(64)]
    job = mock.job()
    job.task_groups = [TaskGroup(name=f"tg-{g}", count=1, tasks=[Task(
        name="web", driver="exec", resources=Resources(
            cpu=100, memory_mb=64, networks=[NetworkResource(
                mbits=5, dynamic_ports=["http"])]))]) for g in range(200)]
    starts: list = []
    with monkeypatch.context() as m:
        nat = _run_port(m, True, "columnar", nodes, [job], starts)
    assert starts == [(200, 200)]
    assert sum(len(v) for v in nat[0][0].values()) == 200


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback to pure Python: a compiler that does not run makes
    the first load raise."""
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "_LOADED", [])
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="build failed"):
        native.load()
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_a_wrong_abi_raises(monkeypatch):
    native.load()  # built and loaded as usual
    monkeypatch.setattr(native, "_LOADED", [])
    monkeypatch.setattr(native, "EXPECTED_ABI", native.EXPECTED_ABI + 1)
    with pytest.raises(RuntimeError, match="ABI"):
        native.load()


def test_the_port_never_loads_the_jax_packages_extension():
    """A fresh interpreter: the port's module loads from
    nomad_tpu_torch/_build/, under its own name, and ``_nomad_native``
    (the JAX package's, which the repo root may hold) is not
    imported."""
    code = (
        "import os, sys\n"
        "from nomad_tpu_torch.scheduler import torch_binpack\n"
        "m = torch_binpack._native_bulk()\n"
        "assert m.__name__ == '_nomad_torch_native', m.__name__\n"
        "assert m.ABI_VERSION == 6\n"
        "build = os.path.join(os.getcwd(), 'nomad_tpu_torch', '_build')\n"
        "assert os.path.dirname(os.path.abspath(m.__file__)) == build, "
        "m.__file__\n"
        "assert '_nomad_native' not in sys.modules\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'nomad_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
