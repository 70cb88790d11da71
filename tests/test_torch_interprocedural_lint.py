"""The port's interprocedural passes (callgraph + blocking) against the
JAX package's.

1. Every synthetic package of ``tests/test_interprocedural_lint.py``
   gives the same finding keys, severities, lines and call-graph
   coverage from the JAX package's five shared passes and the port's.
2. The five shared passes over the whole of ``nomad_tpu/`` give the
   JAX passes' findings (the tree is parsed once for the module).
3. The port's own device round trips (``devices.fetch_host``,
   ``torch.cuda.synchronize``, ``Event.synchronize``,
   ``Stream.synchronize``, and ``.item()`` / ``.cpu()`` / ``.tolist()``
   where a CUDA tensor may reach them): each is a blocking root under a
   lock in the port's pass and not in the JAX pass, and a host value's
   ``.tolist()`` stays silent in both.
"""
from __future__ import annotations

import os
import textwrap

import pytest

from tests import torch_lint_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = cases.harvest("test_interprocedural_lint.py")


@pytest.mark.parametrize("files", [c[1] for c in CASES],
                         ids=[c[0].split("::")[1] for c in CASES])
def test_jax_suite_package_reads_alike(files, tmp_path):
    cases.assert_reads_alike(tmp_path, files)


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX package's tree through both packages' shared passes
    (one parse, reused by both)."""
    from nomad_tpu_torch.analysis import lockcheck

    tree = os.path.join(REPO, "nomad_tpu")
    jax_cov: dict = {}
    torch_cov: dict = {}
    jax = cases.shared_findings("jax", tree, coverage_out=jax_cov)
    port = cases.shared_findings("torch", tree,
                                 scan=lockcheck.scan_package(tree),
                                 coverage_out=torch_cov)
    return jax, port, jax_cov, torch_cov


def test_jax_tree_reads_alike(jax_tree):
    """Over nomad_tpu/ the port's shared passes find exactly what the
    JAX passes find (the JAX tree has no torch round trip)."""
    jax, port, _jc, _tc = jax_tree
    assert cases.keyed(port) == cases.keyed(jax)
    assert not any(cases.is_torch_round_trip(f) for f in port)


def test_jax_tree_coverage_alike(jax_tree):
    _j, _p, jax_cov, torch_cov = jax_tree
    assert torch_cov == jax_cov


def write_pkg(tmp_path, source) -> str:
    d = tmp_path / "rt"
    d.mkdir()
    (d / "mod.py").write_text(textwrap.dedent(source))
    return str(d)


def blocking_findings(package: str, tree: str) -> list:
    return [f for f in cases.shared_findings(package, tree)
            if f.rule == "blocking-under-lock"]


ROUND_TRIPS = {
    "fetch_host": """
        import threading
        from pkg.parallel import devices

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = None

            def read(self, y):
                with self._lock:
                    self.x = devices.fetch_host(y)
        """,
    "cuda-synchronize": """
        import threading
        import torch

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def wait(self):
                with self._lock:
                    torch.cuda.synchronize()
                    self.n += 1
        """,
    "event-synchronize": """
        import threading
        import torch

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.event = torch.cuda.Event()
                self.n = 0

            def wait(self):
                with self._lock:
                    self.event.synchronize()
                    self.n += 1
        """,
    "stream-synchronize": """
        import threading
        import torch

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def wait(self, device):
                with self._lock:
                    torch.cuda.current_stream(device).synchronize()
                    self.n += 1
        """,
    "item": """
        import threading
        import torch

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def count(self, x):
                with self._lock:
                    t = torch.as_tensor(x)
                    self.n = t.sum().item()
        """,
    "cpu": """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.usage_d = None
                self.host = None

            def snapshot(self):
                with self._lock:
                    self.host = self.usage_d.cpu()
        """,
    "tolist": """
        import threading
        from pkg.parallel.devices import put_counted

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.rows = None

            def rows_of(self, x, device):
                with self._lock:
                    y = put_counted(x, device)
                    self.rows = y.tolist()
        """,
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_torch_round_trip_blocks_under_lock(name, tmp_path):
    tree = write_pkg(tmp_path, ROUND_TRIPS[name])
    port = blocking_findings("torch", tree)
    assert len(port) == 1 and cases.is_torch_round_trip(port[0]), port
    assert blocking_findings("jax", tree) == []


def test_host_tolist_under_lock_is_silent(tmp_path):
    """A numpy array's ``.tolist()`` (no CUDA tensor can reach it)
    blocks nothing in either package."""
    tree = write_pkg(tmp_path, """
        import threading
        import numpy as np

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.rows = None

            def rows_of(self, n):
                with self._lock:
                    a = np.arange(n)
                    self.rows = a.tolist()
        """)
    assert blocking_findings("torch", tree) == []
    assert blocking_findings("jax", tree) == []


def test_round_trip_under_lock_propagates_through_callees(tmp_path):
    """A lock held across a call chain that ends in a device sync is
    flagged with the chain, as the JAX pass flags its device
    dispatch/collect."""
    tree = write_pkg(tmp_path, """
        import threading
        import torch

        def _drain():
            torch.cuda.synchronize()

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def step(self):
                with self._lock:
                    _drain()
                    self.n += 1
        """)
    port = blocking_findings("torch", tree)
    assert [f.where for f in port] == ["C.step[C._lock]"]
    assert "_drain" in port[0].message and "device sync" in \
        port[0].message
    assert blocking_findings("jax", tree) == []
