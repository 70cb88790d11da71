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
