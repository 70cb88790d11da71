"""The port's failure-plane lint against the JAX package's, and the
premises of the port's own waivers.

1. Every synthetic package of ``tests/test_faultlint.py`` gives the
   same findings (and the same deadline / boundary / retry coverage)
   from the JAX package's five shared passes and the port's.
2. The premises LINT_ALLOWLIST_TORCH.txt and the port's markers rest
   on, held by behavior: the mux session's TLS socket is non-blocking
   (so ``_SerialTLS.recv`` never waits under its lock), and a loaded
   kernel library is read without the build lock.
"""
from __future__ import annotations

import socket
import threading

import pytest

from tests import torch_lint_cases as cases

CASES = cases.harvest("test_faultlint.py")


@pytest.mark.parametrize("files", [c[1] for c in CASES],
                         ids=[c[0].split("::")[1] for c in CASES])
def test_jax_suite_package_reads_alike(files, tmp_path):
    cases.assert_reads_alike(tmp_path, files)


def test_serial_tls_socket_is_non_blocking():
    """``_SerialTLS`` sets its socket non-blocking, so ``recv`` under
    its lock returns at once (data, or SSLWantRead) and the wait for
    readiness happens in ``_wait``, outside the lock."""
    from nomad_tpu_torch.server.rpc import _SerialTLS

    a, b = socket.socketpair()
    try:
        s = _SerialTLS(a)
        assert a.getblocking() is False
        with pytest.raises(ValueError):
            s.settimeout(1.0)
    finally:
        a.close()
        b.close()


def test_loaded_kernel_library_takes_no_lock(monkeypatch):
    """``kernels.library`` returns a loaded library without touching
    the build lock: a thread holding ``_LOCK`` (a build in progress)
    never delays a launch of a library already loaded."""
    from nomad_tpu_torch.ops import kernels

    lib = object()
    monkeypatch.setitem(kernels._LIBS, "loaded", lib)
    got = []
    with kernels._LOCK:
        t = threading.Thread(target=lambda: got.append(
            kernels.library("loaded")))
        t.start()
        t.join(10)
    assert got == [lib]
