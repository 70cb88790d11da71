"""The port's device-plane lint (nomad_tpu_torch/analysis/devlint.py).

1. Every synthetic package of ``tests/test_devlint.py`` gives the same
   findings from the JAX package's five shared passes and the port's.
2. Each rule of the port's devlint (mesh-bypass, sharding-mix,
   resident-bypass, transfer-under-lock, transfer-in-hot-loop) fires
   on a snippet and stays silent on its sanctioned twin; the kernels
   are the port's wrappers (``kernels.library`` / ``kernels.check`` /
   ``kernels.route``) and the ``*_sharded`` family; ``recompile-churn``
   has no counterpart.
"""
from __future__ import annotations

import textwrap

import pytest

from nomad_tpu_torch.analysis import devlint

from tests import torch_lint_cases as cases

CASES = cases.harvest("test_devlint.py")


@pytest.mark.parametrize("files", [c[1] for c in CASES],
                         ids=[c[0].split("::")[1] for c in CASES])
def test_jax_suite_package_reads_alike(files, tmp_path):
    cases.assert_reads_alike(tmp_path, files)


# A synthetic port: ops/kernels.py (the launch helpers), ops/wrap.py (an
# unsharded wrapper), parallel/mesh.py (the mesh authority and a
# self-placing sharded wrapper), parallel/devices.py (the counted seam).
BASE = {
    "ops/kernels.py": """
        def route(tensors):
            return next(iter(tensors.values())).device

        def library(name):
            return None

        def check(lib, what, code):
            return None
        """,
    "ops/wrap.py": """
        from dp.ops import kernels

        def place(capacity, usage, k_cap: int = 1):
            device = kernels.route(dict(capacity=capacity, usage=usage))
            lib = kernels.library("binpack")
            return capacity
        """,
    "parallel/devices.py": """
        import torch

        def put_counted(x, device=None):
            return torch.tensor(x, device=device)

        def fetch_host(x):
            return x
        """,
    "parallel/mesh.py": """
        def dispatch_mesh(n, pad, device=None):
            return None

        def _put(x, mesh, spec):
            return x

        def place_sharded(mesh: "Mesh", capacity, usage):
            ops = [_put(capacity, mesh, 0), _put(usage, mesh, 0)]
            return ops

        def raw_sharded(mesh: "Mesh", capacity, usage):
            return capacity
        """,
}


def lint(tmp_path, caller: str) -> dict:
    files = dict(BASE, **{"sched.py": caller})
    root = tmp_path / "dp"
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    out: dict = {}
    for f in devlint.analyze_package(str(root)):
        out.setdefault(f.rule, []).append(f)
    return out


DEVLINT_CASES = {
    "mesh-bypass": ("""
        from dp.ops import wrap
        from dp.parallel.devices import put_counted

        def dispatch(c, u, device):
            return wrap.place(put_counted(c, device), put_counted(u, device))
        """, {"mesh-bypass": ["dispatch.place"]}),
    "mesh-consulted": ("""
        from dp.ops import wrap
        from dp.parallel import mesh
        from dp.parallel.devices import put_counted

        def dispatch(c, u, device):
            if mesh.dispatch_mesh(1, 8) is None:
                return wrap.place(put_counted(c, device),
                                  put_counted(u, device))
        """, {}),
    "sharding-mix": ("""
        from dp.parallel import mesh

        def dispatch(m, c, u):
            return mesh.raw_sharded(m, c, u)
        """, {"sharding-mix": ["dispatch.capacity", "dispatch.usage"]}),
    "self-placing-sharded-wrapper": ("""
        from dp.parallel import mesh

        def dispatch(m, c, u):
            return mesh.place_sharded(m, c, u)
        """, {}),
    "resident-bypass-to": ("""
        def move(x, device):
            return x.to(device)
        """, {"resident-bypass": ["move"]}),
    "resident-bypass-cuda": ("""
        def move(x):
            return x.cuda()
        """, {"resident-bypass": ["move"]}),
    "resident-bypass-tensor-device": ("""
        import torch

        def move(rows, device):
            return torch.as_tensor(rows, device=device)
        """, {"resident-bypass": ["move"]}),
    "dtype-and-cpu-moves-are-not-uploads": ("""
        import torch

        def convert(x):
            return x.to(torch.float32), x.to("cpu"), x.to(dtype=x.dtype)
        """, {}),
    "resident-bypass-marker": ("""
        def gather(x, lead):
            # devlint-ok(resident-bypass): card to card, the walk's
            # results onto the lead.
            return x.to(lead)
        """, {}),
    "transfer-under-lock": ("""
        import threading
        from dp.parallel.devices import put_counted

        class Mirror:
            def __init__(self):
                self._lock = threading.Lock()
                self.d = None

            def sync(self, x, device):
                with self._lock:
                    self.d = put_counted(x, device)
        """, {"transfer-under-lock": ["Mirror.sync[Mirror._lock]"]}),
    "transfer-outside-lock": ("""
        import threading
        from dp.parallel.devices import put_counted

        class Mirror:
            def __init__(self):
                self._lock = threading.Lock()
                self.d = None

            def sync(self, x, device):
                d = put_counted(x, device)
                with self._lock:
                    self.d = d
        """, {}),
    "transfer-in-hot-loop": ("""
        import numpy as np
        from dp.ops import wrap
        from dp.parallel import mesh
        from dp.parallel.devices import put_counted

        class Sched:
            def dispatch_device(self, c, u, device):
                mesh.dispatch_mesh(1, 8)
                out = wrap.place(put_counted(c, device), u)
                return np.asarray(out)
        """, {"transfer-in-hot-loop": ["Sched.dispatch_device.usage",
                                       "Sched.dispatch_device.np.asarray"]}),
    "hot-loop-placed-and-fetched": ("""
        from dp.ops import wrap
        from dp.parallel import mesh
        from dp.parallel.devices import fetch_host, put_counted

        class Sched:
            def dispatch_device(self, c, u, device):
                mesh.dispatch_mesh(1, 8)
                out = wrap.place(put_counted(c, device),
                                 put_counted(u, device))
                return fetch_host(out)
        """, {}),
}


@pytest.mark.parametrize("name", sorted(DEVLINT_CASES))
def test_devlint_rule(name, tmp_path):
    caller, want = DEVLINT_CASES[name]
    got = lint(tmp_path, caller)
    assert {rule: sorted({f.where for f in fs})
            for rule, fs in got.items()} == \
        {rule: sorted(w) for rule, w in want.items()}


def test_kernels_are_the_wrappers_and_the_sharded_family(tmp_path):
    from nomad_tpu_torch.analysis.callgraph import CallGraph

    lint(tmp_path, "X = 1\n")
    kernels = devlint._find_kernels(CallGraph.build(str(tmp_path / "dp")))
    by_name = {next(iter(k.names)): k for k in kernels.values()}
    assert set(by_name) == {"place", "place_sharded", "raw_sharded"}
    assert not by_name["place"].sharded
    assert by_name["place"].static == {"k_cap"}
    assert by_name["raw_sharded"].static == {"mesh"}
    assert by_name["place_sharded"].self_placing
    assert not by_name["raw_sharded"].self_placing


def test_port_seams_sanction_device_moves(tmp_path):
    """parallel/devices.py and the named seams may move tensors: the
    synthetic put_counted's ``torch.tensor(..., device=)`` is not a
    finding."""
    got = lint(tmp_path, "X = 1\n")
    assert "resident-bypass" not in got, got
