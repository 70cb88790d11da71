"""The port's runtime sanitizers (nomad_tpu_torch/analysis/sanitizers.py)
against their JAX twins.

- The lock-order witness takes its real constructors from ``_thread``
  whatever is installed when it is imported (the JAX witness is, for
  the whole session), matches its package by path components (so it
  never wraps ``nomad_tpu/``'s locks), and an inverted lock order
  reports the same cycle as the JAX witness.
- A nondeterministic apply diverges the port's shadow twin as it does
  the JAX package's; a clean replay stays byte-identical.
- The transfer guard refuses an implicit host->device move inside a
  seam before it is dispatched (so it runs without a card), lets the
  counted seams through, and raises on a seam it cannot find.
- The budget witness records an untimed wait on a thread serving an
  admitted RPC of the port's endpoints.
- A port Server on InmemRaft places config 1 on the CPU under all four
  sanitizers at once, and they report nothing.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import nomad_tpu.mock as jax_mock
import nomad_tpu_torch.mock as mock
from nomad_tpu_torch.analysis import sanitizers
from nomad_tpu_torch.analysis.sanitizers import (
    BudgetWitnessSanitizer,
    ImplicitTransferError,
    LockOrderWitness,
    ReplicaDivergenceSanitizer,
    TransferGuardSanitizer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# lock-order witness
# ---------------------------------------------------------------------------

def test_real_constructors_survive_an_installed_jax_witness():
    """Imported while a JAX witness has replaced the threading
    constructors, the module still takes the real ones: a lock the
    port's witness makes is recorded by the port's witness alone."""
    from nomad_tpu.analysis.sanitizers import LockOrderWitness as JaxWitness

    jax_w = JaxWitness(package_prefix=REPO).install()
    try:
        assert not isinstance(threading.Condition, type)
        spec = importlib.util.spec_from_file_location(
            "_port_sanitizers_copy", sanitizers.__file__)
        copy = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(copy)
        import _thread

        assert copy._real_lock is _thread.allocate_lock
        assert isinstance(copy._RealCondition, type)
        assert copy._RealCondition is sanitizers._RealCondition
        port_w = copy.LockOrderWitness(
            package_prefix=os.path.join(REPO, "tests")).install()
        try:
            jax_sites = set(jax_w.sites)
            a = threading.Lock()
            b = threading.Lock()
            with a:
                with b:
                    pass
        finally:
            port_w.uninstall()
    finally:
        jax_w.uninstall()
    here = os.path.relpath(__file__, REPO)
    assert all(site.startswith(f"tests/{os.path.basename(here)}:")
               for site in port_w.sites), port_w.sites
    assert len(port_w.sites) == 2 and len(port_w.edges) == 1
    assert set(jax_w.sites) == jax_sites   # nothing recorded twice


def test_prefix_matches_whole_path_components():
    assert sanitizers._in_package("/r/nomad_tpu_torch/a.py",
                                  "/r/nomad_tpu_torch")
    assert not sanitizers._in_package("/r/nomad_tpu_torch/a.py",
                                      "/r/nomad_tpu")
    w = LockOrderWitness()
    assert w.package_prefix.endswith("nomad_tpu_torch")


def test_jax_package_locks_are_not_wrapped():
    """The port's witness never wraps a lock created in nomad_tpu/
    (the JAX witness's startswith test matched the port; this one does
    not match the JAX package)."""
    from nomad_tpu.server.eval_broker import EvalBroker as JaxBroker

    with LockOrderWitness() as w:
        JaxBroker()
    assert not any(site.startswith("nomad_tpu/") for site in w.sites)


def _load_ordered(tmp_path, name):
    """A module whose two functions take locks A and B in opposite
    orders, loaded fresh (its locks made under the installed witness)."""
    pkg = tmp_path / "lo"
    pkg.mkdir(exist_ok=True)
    path = pkg / f"{name}.py"
    path.write_text(textwrap.dedent("""
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def forward():
            with A:
                with B:
                    pass

        def backward():
            with B:
                with A:
                    pass
        """))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.forward()
    mod.backward()
    return str(pkg)


def test_inverted_lock_order_reports_the_same_cycle(tmp_path):
    from nomad_tpu.analysis.sanitizers import LockOrderWitness as JaxWitness

    prefix = str(tmp_path / "lo")
    cycles = {}
    for name, cls in (("port", LockOrderWitness), ("jax", JaxWitness)):
        with cls(package_prefix=prefix) as w:
            _load_ordered(tmp_path, "order")
        with pytest.raises(AssertionError, match="lock-order cycles"):
            w.check()
        cycles[name] = sorted(tuple(sorted(c)) for c in w.find_cycles())
    assert cycles["port"] == cycles["jax"] == [
        ("lo/order.py:4", "lo/order.py:5")]


def test_consistent_order_passes(tmp_path):
    pkg = tmp_path / "ok"
    pkg.mkdir()
    (pkg / "m.py").write_text(textwrap.dedent("""
        import threading

        A = threading.Lock()
        B = threading.RLock()
        C = threading.Condition()

        def run():
            with A:
                with B:
                    with C:
                        C.notify_all()
        """))
    with LockOrderWitness(package_prefix=str(pkg)) as w:
        spec = importlib.util.spec_from_file_location("ok_m", pkg / "m.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.run()
    w.check()
    assert len(w.sites) == 3 and len(w.edges) == 2


# ---------------------------------------------------------------------------
# replica divergence
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_divergence():
    """The session's JAX divergence sanitizer when active (conftest),
    else one installed here; divergences this test injects are scrubbed
    afterwards so the session's check stays clean."""
    import conftest as cft
    from nomad_tpu.analysis.sanitizers import \
        ReplicaDivergenceSanitizer as JaxDivergence

    san = cft.DIVERGENCE
    if san is not None:
        before = len(san.mismatches)
        yield san
        del san.mismatches[before:]
    else:
        san = JaxDivergence().install()
        try:
            yield san
        finally:
            san.uninstall()


def _entries(codec, node_mod, n):
    return [codec.encode(codec.NODE_REGISTER_REQUEST,
                         {"node": node_mod.node(i).to_dict()})
            for i in range(1, n + 1)]


def _tainted_apply(fsm, codec):
    clean = fsm._handlers[codec.NODE_REGISTER_REQUEST]

    def tainted(index, payload):
        # a wall-clock value smuggled into replicated state
        payload["node"]["name"] = f"joined-{time.time_ns()}"
        return clean(index, payload)

    fsm._handlers[codec.NODE_REGISTER_REQUEST] = tainted


def test_nondeterministic_apply_diverges_in_both(jax_divergence):
    from nomad_tpu.server.fsm import NomadFSM as JaxFSM
    from nomad_tpu.structs import codec as jax_codec
    from nomad_tpu_torch.server.fsm import NomadFSM
    from nomad_tpu_torch.structs import codec

    with ReplicaDivergenceSanitizer() as port:
        fsm = NomadFSM()
        assert fsm._divergence_twin is not None
        _tainted_apply(fsm, codec)
        with pytest.raises(AssertionError, match="replica divergence"):
            fsm.apply(1, _entries(codec, mock, 1)[0])
        assert fsm._divergence_twin is None
    assert len(port.mismatches) == 1
    with pytest.raises(AssertionError, match="replica divergence"):
        port.check()

    jfsm = JaxFSM()
    assert jfsm._divergence_twin is not None
    _tainted_apply(jfsm, jax_codec)
    with pytest.raises(AssertionError, match="replica divergence"):
        jfsm.apply(1, _entries(jax_codec, jax_mock, 1)[0])


def test_clean_replay_stays_byte_identical():
    from nomad_tpu_torch.server.fsm import NomadFSM
    from nomad_tpu_torch.structs import codec

    with ReplicaDivergenceSanitizer() as san:
        fsm = NomadFSM()
        for i, entry in enumerate(_entries(codec, mock, 6), 1):
            fsm.apply(i, entry)
        san.compare_all()
    assert fsm._divergence_twin is not None
    assert fsm.state.fingerprint() == \
        fsm._divergence_twin.state.fingerprint()
    assert san.compared >= 5 and not san.mismatches


def test_pairs_compare_the_callers_digest():
    """A caller's digest (a function of a store) is what each pair
    compares; the default is the store's fingerprint."""
    from nomad_tpu_torch.server.fsm import NomadFSM
    from nomad_tpu_torch.structs import codec

    seen = []

    def digest(state):
        seen.append(state)
        return state.fingerprint(changelog_since=10**9)

    with ReplicaDivergenceSanitizer(digest=digest) as san:
        fsm = NomadFSM()
        fsm.apply(1, _entries(codec, mock, 1)[0])
    assert san.compared == 1 and not san.mismatches
    assert seen == [fsm.state, fsm._divergence_twin.state]
    assert ReplicaDivergenceSanitizer().digest(fsm.state) == \
        fsm.state.fingerprint()


def test_out_of_band_writes_drop_the_pair_not_a_report():
    from nomad_tpu_torch.server.fsm import NomadFSM
    from nomad_tpu_torch.structs import codec

    with ReplicaDivergenceSanitizer() as san:
        fsm = NomadFSM()
        fsm.state.upsert_job(1, mock.job())
        fsm.apply(2, _entries(codec, mock, 1)[0])
    assert fsm._divergence_twin is None
    assert san.desynced == 1 and not san.mismatches


# ---------------------------------------------------------------------------
# transfer guard
# ---------------------------------------------------------------------------

def _seam_module(tmp_path, body: str):
    """A module with a seam ``dispatch`` and a counted ``place``."""
    path = tmp_path / "guard_seams.py"
    path.write_text(textwrap.dedent("""
        import numpy as np
        import torch

        def place(x):
            return torch.as_tensor(x).to("cuda")

        def dispatch(x):
        """) + textwrap.indent(textwrap.dedent(body), "    "))
    sys.path.insert(0, str(tmp_path))
    try:
        sys.modules.pop("guard_seams", None)
        return importlib.import_module("guard_seams")
    finally:
        sys.path.remove(str(tmp_path))


GUARD_CASES = {
    "to-cuda": ("return x.to('cuda')", "Tensor.to(cuda)"),
    "to-device": ("return x.to(torch.device('cuda', 0))", "Tensor.to"),
    "cuda": ("return x.cuda()", "Tensor.cuda()"),
    "tensor-on-card": ("return torch.tensor(np.ones(3), device='cuda')",
                       "torch.tensor"),
    "as-tensor-on-card": ("return torch.as_tensor([1, 2], device='cuda:0')",
                          "torch.as_tensor"),
}


@pytest.mark.parametrize("name", sorted(GUARD_CASES))
def test_guard_refuses_implicit_upload_before_dispatch(name, tmp_path):
    body, what = GUARD_CASES[name]
    mod = _seam_module(tmp_path, body)
    guard = TransferGuardSanitizer(seams=(("guard_seams", None,
                                           "dispatch"),),
                                   counted=(("guard_seams", None,
                                             "place"),))
    with guard:
        with pytest.raises(ImplicitTransferError, match="transfer guard"):
            mod.dispatch(torch.ones(3))
    assert len(guard.refused) == 1 and what in guard.refused[0]
    assert guard.entries == 1
    with pytest.raises(AssertionError, match="refused"):
        guard.check()


def test_guard_lets_host_work_and_counted_seams_through(tmp_path):
    """Host-only tensor work inside a seam passes; a move made by a
    counted seam is not refused (it then fails here only because the
    CPU build has no CUDA, which is torch's own error)."""
    mod = _seam_module(tmp_path, """
        y = (x * 2).to(torch.float64).to("cpu")
        if y.sum() > 100:
            return place(y)
        return y
        """)
    guard = TransferGuardSanitizer(seams=(("guard_seams", None,
                                           "dispatch"),),
                                   counted=(("guard_seams", None,
                                             "place"),))
    with guard:
        assert mod.dispatch(torch.ones(3)).dtype == torch.float64
        with pytest.raises(Exception) as info:
            mod.dispatch(torch.full((3,), 100.0))
        assert not isinstance(info.value, ImplicitTransferError)
    assert guard.refused == []
    guard.check()
    # Outside the seam nothing is guarded.
    assert mod.place.__name__ == "place"


def test_guard_wraps_the_ports_seams_and_restores_them():
    from nomad_tpu_torch.ops import plan_conflict
    from nomad_tpu_torch.scheduler.torch_binpack import TorchBinPackScheduler

    before = (TorchBinPackScheduler.dispatch_device,
              plan_conflict._dispatch_window_fit)
    with TransferGuardSanitizer():
        assert TorchBinPackScheduler.dispatch_device.__wrapped__ is \
            before[0]
        assert plan_conflict._dispatch_window_fit.__wrapped__ is before[1]
    assert (TorchBinPackScheduler.dispatch_device,
            plan_conflict._dispatch_window_fit) == before


def test_guard_refuses_a_seam_it_cannot_find():
    with pytest.raises(AttributeError, match="no seam"):
        TransferGuardSanitizer(seams=(
            ("nomad_tpu_torch.ops.plan_conflict", None, "no_such_seam"),
        )).install()
    with pytest.raises(ImportError):
        TransferGuardSanitizer(seams=(
            ("nomad_tpu_torch.no_such_module", None, "x"),)).install()


# ---------------------------------------------------------------------------
# budget witness
# ---------------------------------------------------------------------------

def test_budget_witness_records_an_untimed_wait_while_serving():
    from nomad_tpu_torch.server.endpoints import Endpoints

    ev = threading.Event()
    ev.set()

    def handler(args):
        ev.wait()             # untimed: recorded (it returns at once)
        ev.wait(timeout=1.0)  # timed: not recorded
        return {}

    with BudgetWitnessSanitizer(package_prefix=REPO) as san:
        Endpoints._admitted_body(_Bare(), "Job.List", handler, {})
        Endpoints._admitted_body(_Bare(), "Node.Heartbeat", handler, {})
    assert [(m, p) for m, p, _t, _s in san.hits] == [
        ("Job.List", "Event.wait")]
    with pytest.raises(AssertionError, match="budget-witness"):
        san.check_test()
    san.check()


class _Bare:
    """An Endpoints stand-in with no server: admission is skipped."""

    class server:
        overload = None


# ---------------------------------------------------------------------------
# all four on a port server (config 1 on the CPU)
# ---------------------------------------------------------------------------

def test_port_server_places_config1_under_all_sanitizers():
    from nomad_tpu_torch.scheduler.executor import executor_override
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.rpc import ConnPool

    sans = [LockOrderWitness(), TransferGuardSanitizer(),
            ReplicaDivergenceSanitizer(), BudgetWitnessSanitizer()]
    for san in sans:
        san.install()
    try:
        with executor_override("device"):
            srv = Server(ServerConfig(device="cpu", tune_gc=False,
                                      enable_rpc=True))
            pool = ConnPool()
            try:
                for i in range(100):
                    srv.node_register(mock.node(i))
                srv.establish_leadership()
                jobs = [mock.job() for _ in range(4)]
                ids = [srv.job_register(j)[1] for j in jobs]
                assert srv.wait_for_evals(ids, timeout=60)
                addr = srv.rpc_address()
                for j in jobs:
                    reply = pool.call(addr, "Job.Allocations",
                                      {"job_id": j.id}, timeout=30)
                    assert len(reply["allocations"]) == 10
                pool.call(addr, "Job.List", {}, timeout=30)
            finally:
                pool.shutdown()
                srv.shutdown()
        sans[2].compare_all()
    finally:
        for san in reversed(sans):
            san.uninstall()
    witness, guard, divergence, budget = sans
    for check in (witness.check, guard.check, divergence.check,
                  budget.check):
        check()
    assert witness.sites and witness.edges
    assert guard.entries > 0 and divergence.compared > 0
