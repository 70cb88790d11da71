"""Runtime sanitizers: cross-check the static analysis with real runs.

Counterpart of ``nomad_tpu/analysis/sanitizers.py`` for
``nomad_tpu_torch/``.  Static analysis sees possible orders; these see
ACTUAL ones.

**LockOrderWitness** — `threading.Lock/RLock/Condition` constructors are
wrapped so every lock created from package code carries its creation
*site* (file:line).  Each thread keeps a held-site stack; acquiring B
while holding A records the edge A→B.  A cycle in the observed graph
means two real code paths took the same pair of lock classes in
opposite orders — the deadlock precondition, caught even when the run
never deadlocks.  Edges are keyed by site, not instance; same-site
nesting of distinct instances is collected separately (``self_edges``,
advisory).  The real constructors come from ``_thread`` (and the
Condition class from what ``threading`` builds), never from whatever
``threading.Lock`` names when this module is imported, so a witness of
the JAX package installed first is neither wrapped again nor recorded
through; and "package code" is a path-component test, so
``nomad_tpu/`` is not mistaken for ``nomad_tpu_torch/``.

**TransferGuardSanitizer** — PyTorch has no ``jax.transfer_guard``, so
the guard is a ``torch.overrides.TorchFunctionMode`` entered, on the
calling thread, inside each dispatch seam of ``TRANSFER_SEAMS``.  It
refuses every host->device move the seam makes implicitly — a
``Tensor.to`` / ``.cuda()`` of a host tensor to the card, a ``copy_``
or item store into a CUDA tensor from host data, a ``torch.tensor`` /
``as_tensor`` / ``asarray`` on the card from host data, a host tensor
or array mixed into an op on a CUDA tensor — unless a counted seam
(``COUNTED_SEAMS``: ``devices._put``, the move of ``put_counted`` and
``ensure_on_default``, ``PinnedStaging.upload``, ``mesh._put``) is on
the stack.  A refusal raises
``ImplicitTransferError`` in the offending call, before the move runs,
and is kept for ``check()``.  The device->host direction is not guarded
(devlint's concretize pass owns it).  A seam that cannot be imported
or found raises at ``install()``.

**ReplicaDivergenceSanitizer** — every ``NomadFSM`` of the port carries
a shadow twin fed the same raft entries; store fingerprints are
byte-compared at commit quiescence points.

**BudgetWitnessSanitizer** — while a thread serves an admitted RPC
(the port's ``Endpoints._admitted_body``, heartbeat lane excluded), an
``Event.wait`` / ``Condition.wait`` / blocking ``Queue.get`` entered
with no timeout is recorded with its stack.

``RecompileSentinel`` is left out by name: the port compiles each
``.cu`` source once, under a digest of the source and the flags, and
shapes are launch arguments, so there is no trace cache to budget.

All are opt-in via install()/uninstall() (or ``with``); chip_smoke.py's
``sanitizers`` phase installs all four on the card.
"""
from __future__ import annotations

import _thread
import importlib
import os
import sys
import threading
from typing import Optional

_real_lock = _thread.allocate_lock
_real_rlock = getattr(_thread, "RLock", None) or threading._PyRLock


def _condition_class() -> type:
    """The ``threading.Condition`` class, whatever the name is bound to
    now: a witness may have replaced it with a factory, but what
    ``threading`` itself builds for an Event is still the class."""
    cond = threading.Condition
    if isinstance(cond, type):
        return cond
    return type(threading.Event()._cond)


_RealCondition = _condition_class()


def _in_package(path: str, prefix: str) -> bool:
    """Is ``path`` inside the directory ``prefix`` (whole components:
    ``nomad_tpu_torch/x.py`` is not inside ``nomad_tpu``)?"""
    try:
        return os.path.commonpath([path, prefix]) == prefix
    except ValueError:  # different drives
        return False


def _package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _WrappedLock:
    """Order-tracking proxy around a real Lock/RLock."""

    __slots__ = ("_inner", "_site", "_witness")

    def __init__(self, inner, site: str, witness: "LockOrderWitness"):
        self._inner = inner
        self._site = site
        self._witness = witness

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness._on_acquire(self._site, id(self))
        return got

    def release(self) -> None:
        self._inner.release()
        self._witness._on_release(self._site, id(self))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # Condition(wrapped_lock) support: Condition feature-detects
    # _release_save/_acquire_restore/_is_owned via attribute existence,
    # so these must exist exactly when the INNER lock has them (RLock
    # yes, Lock no) — hence __getattr__, not plain methods.  The
    # save/restore round-trip stays order-tracked.
    def __getattr__(self, name: str):
        if name == "_release_save":
            inner_fn = self._inner._release_save
            witness, site, me = self._witness, self._site, id(self)

            def _release_save():
                state = inner_fn()
                witness._on_release(site, me)
                return state
            return _release_save
        if name == "_acquire_restore":
            inner_fn = self._inner._acquire_restore
            witness, site, me = self._witness, self._site, id(self)

            def _acquire_restore(state):
                inner_fn(state)
                witness._on_acquire(site, me)
            return _acquire_restore
        if name in ("_is_owned", "_at_fork_reinit"):
            return getattr(self._inner, name)
        raise AttributeError(name)


class LockOrderWitness:
    """Records real lock-acquisition chains; reports order cycles."""

    def __init__(self, package_prefix: Optional[str] = None) -> None:
        if package_prefix is None:
            package_prefix = _package_dir()
        self.package_prefix = os.path.abspath(package_prefix)
        self._tls = threading.local()
        self._graph_lock = _real_lock()
        self.edges: dict = {}     # (site_a, site_b) -> count
        self.self_edges: set = set()  # same-site, distinct-instance nests
        self.sites: set = set()
        self._installed = False
        self._saved: Optional[tuple] = None

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _on_acquire(self, site: str, lock_id: int) -> None:
        stack = self._stack()
        if stack:
            top_site, top_id = stack[-1]
            if top_site != site:
                edge = (top_site, site)
                with self._graph_lock:
                    self.edges[edge] = self.edges.get(edge, 0) + 1
            elif top_id != lock_id:
                # Two INSTANCES of one lock class nested: advisory only
                # (hierarchical same-class locks are legitimate), kept
                # for inspection alongside the static
                # nested-self-acquire rule.
                with self._graph_lock:
                    self.self_edges.add(site)
        stack.append((site, lock_id))

    def _on_release(self, site: str, lock_id: int) -> None:
        stack = self._stack()
        # Locks are not always released LIFO: drop the innermost match.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == (site, lock_id):
                del stack[i]
                return

    def _site_of_caller(self) -> Optional[str]:
        frame = sys._getframe(2)
        fname = os.path.abspath(frame.f_code.co_filename)
        if not _in_package(fname, self.package_prefix):
            return None
        rel = os.path.relpath(fname, os.path.dirname(self.package_prefix))
        return f"{rel}:{frame.f_lineno}"

    # -- install / uninstall ----------------------------------------------
    def install(self) -> "LockOrderWitness":
        """Patch the threading lock constructors; only locks created
        from files under ``package_prefix`` are wrapped."""
        if self._installed:
            return self
        # Save whatever is installed NOW (possibly another witness's
        # factories) so nested install/uninstall pairs restore correctly.
        self._saved = (threading.Lock, threading.RLock,
                       threading.Condition)
        witness = self

        def _wrap(inner, site):
            if site is None:
                return inner
            witness.sites.add(site)
            return _WrappedLock(inner, site, witness)

        def make_lock():
            return _wrap(_real_lock(), witness._site_of_caller())

        def make_rlock():
            return _wrap(_real_rlock(), witness._site_of_caller())

        def make_condition(lock=None):
            # A Condition over an (already wrapped) lock tracks through
            # the wrapper; a bare Condition() gets its own wrapped RLock
            # when created from package code (site = the Condition()
            # call, resolved HERE — one frame up would blame this file).
            if lock is None:
                lock = _wrap(_real_rlock(), witness._site_of_caller())
            return _RealCondition(lock)

        threading.Lock = make_lock
        threading.RLock = make_rlock
        threading.Condition = make_condition
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        threading.Lock, threading.RLock, threading.Condition = self._saved
        self._installed = False
        self._saved = None

    def __enter__(self) -> "LockOrderWitness":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- reporting ---------------------------------------------------------
    def find_cycles(self) -> list:
        """Elementary cycles in the observed order graph (site level)."""
        from .lockcheck import find_cycles

        graph: dict = {}
        with self._graph_lock:
            for (a, b) in self.edges:
                graph.setdefault(a, set()).add(b)
        return find_cycles(graph)

    def check(self) -> None:
        """Raise AssertionError when an order cycle was observed."""
        cycles = self.find_cycles()
        if cycles:
            lines = [" -> ".join(c + (c[0],)) for c in cycles]
            raise AssertionError(
                "lock-order cycles observed at runtime:\n  " +
                "\n  ".join(lines))


# ---------------------------------------------------------------------------
# Transfer guard
# ---------------------------------------------------------------------------

# The dispatch seams the guard wraps: every scheduler-driven device
# dispatch of the port flows through one of these.  (import path,
# class-or-None, attribute.)  Direct wrapper calls outside them — the
# parity suites feeding tensors on purpose — are not guarded: the
# discipline is a property of the scheduler seams, not of the kernels.
TRANSFER_SEAMS = (
    ("nomad_tpu_torch.scheduler.torch_binpack", "TorchBinPackScheduler",
     "dispatch_device"),
    ("nomad_tpu_torch.scheduler.batch", "BatchEvalRunner", "_process"),
    ("nomad_tpu_torch.models.fleet", "UsageMirror", "_update_device"),
    ("nomad_tpu_torch.parallel.mesh", None, "place_sequence_sharded"),
    ("nomad_tpu_torch.parallel.mesh", None, "place_rounds_sharded"),
    ("nomad_tpu_torch.parallel.mesh", None, "place_rounds_batch_sharded"),
    ("nomad_tpu_torch.parallel.mesh", None, "place_sequence_batch_sharded"),
    ("nomad_tpu_torch.parallel.mesh", None, "window_verify_sharded"),
    ("nomad_tpu_torch.ops.plan_conflict", None, "_dispatch_window_fit"),
)

# The counted placements: a move made with one of these on the stack is
# explicit (and on the transfer odometer), not implicit.
COUNTED_SEAMS = (
    ("nomad_tpu_torch.parallel.devices", None, "_put"),
    ("nomad_tpu_torch.parallel.devices", "PinnedStaging", "upload"),
    ("nomad_tpu_torch.parallel.mesh", None, "_put"),
)

# How far up the stack a counted seam is looked for.
_SEAM_DEPTH = 64


class ImplicitTransferError(RuntimeError):
    """An implicit host->device move inside a guarded dispatch seam."""


def _resolve(mod_path: str, cls_name: Optional[str], attr: str):
    """(holder, function) of one seam; raises when it cannot be found —
    a guard that silently skips a seam guards nothing."""
    mod = importlib.import_module(mod_path)
    holder = getattr(mod, cls_name) if cls_name else mod
    fn = getattr(holder, attr, None)
    if fn is None:
        raise AttributeError(
            f"transfer guard: no seam {mod_path}."
            f"{cls_name + '.' if cls_name else ''}{attr}")
    return holder, fn


class TransferGuardSanitizer:
    """Refuses IMPLICIT host->device moves inside the dispatch seams.

    ``refused`` keeps every refusal (the raise may be swallowed by a
    worker loop; ``check()`` still fails).  ``entries`` counts the seam
    entries that ran under the guard.
    """

    def __init__(self, seams=TRANSFER_SEAMS,
                 counted=COUNTED_SEAMS) -> None:
        self.seams = seams
        self.counted = counted
        self.refused: list = []
        self.entries = 0
        self._saved: list = []
        self._codes: set = set()
        self._tls = threading.local()
        self._lock = _real_lock()
        self._installed = False
        self._mode = None

    # -- the check ----------------------------------------------------------
    def _made_by_counted_seam(self) -> bool:
        frame = sys._getframe(2)
        for _ in range(_SEAM_DEPTH):
            if frame is None:
                return False
            if frame.f_code in self._codes:
                return True
            frame = frame.f_back
        return False

    def _refuse(self, what: str) -> None:
        with self._lock:
            self.refused.append(what)
        raise ImplicitTransferError(
            f"transfer guard: implicit host->device move inside a "
            f"dispatch seam: {what} — place it through the counted "
            "seams (devices.put_counted / PinnedStaging.upload / "
            "mesh._put)")

    # -- install / uninstall -------------------------------------------------
    def install(self) -> "TransferGuardSanitizer":
        if self._installed:
            return self
        import torch

        codes = set()
        for mod_path, cls_name, attr in self.counted:
            _holder, fn = _resolve(mod_path, cls_name, attr)
            codes.add(getattr(fn, "__wrapped__", fn).__code__)
        self._codes = codes
        targets = [(*_resolve(*seam), seam[2]) for seam in self.seams]
        self._mode = _guard_mode(torch, self)
        guard = self

        def wrap(fn):
            def guarded(*args, **kwargs):
                if getattr(guard._tls, "inside", False):
                    return fn(*args, **kwargs)
                guard._tls.inside = True
                with guard._lock:
                    guard.entries += 1
                try:
                    with guard._mode():
                        return fn(*args, **kwargs)
                finally:
                    guard._tls.inside = False
            guarded.__name__ = fn.__name__
            guarded.__qualname__ = getattr(fn, "__qualname__",
                                           fn.__name__)
            guarded.__wrapped__ = fn
            return guarded

        for holder, fn, attr in targets:
            self._saved.append((holder, attr, fn))
            setattr(holder, attr, wrap(fn))
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for holder, attr, fn in reversed(self._saved):
            setattr(holder, attr, fn)
        self._saved = []
        self._installed = False

    def __enter__(self) -> "TransferGuardSanitizer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def check(self) -> None:
        """Raise AssertionError when any implicit move was refused."""
        with self._lock:
            refused = list(self.refused)
        if refused:
            raise AssertionError(
                "transfer guard refused implicit host->device moves:\n  "
                + "\n  ".join(refused))


def _guard_mode(torch, guard: TransferGuardSanitizer):
    """The TorchFunctionMode class the guard enters inside a seam."""
    from torch.overrides import TorchFunctionMode

    def on_card(dev) -> bool:
        if isinstance(dev, torch.device):
            return dev.type == "cuda"
        if isinstance(dev, str):
            return dev.startswith("cuda")
        return isinstance(dev, int) and not isinstance(dev, bool)

    def host_data(x) -> bool:
        if isinstance(x, torch.Tensor):
            return x.device.type == "cpu"
        return not isinstance(x, (int, float, bool, complex)) and \
            x is not None

    def operands(args, kwargs):
        for x in list(args) + list(kwargs.values()):
            if isinstance(x, (list, tuple)):
                yield from x
            else:
                yield x

    def implicit_upload(name, args, kwargs) -> Optional[str]:
        if name == "to" and args and isinstance(args[0], torch.Tensor):
            dev = kwargs.get("device")
            for a in args[1:]:
                if isinstance(a, (str, torch.device, int)) and \
                        not isinstance(a, bool):
                    dev = a
                elif isinstance(a, torch.Tensor):
                    dev = a.device
            if args[0].device.type == "cpu" and on_card(dev):
                return f"Tensor.to({dev}) of a host tensor"
            return None
        if name == "cuda" and args and isinstance(args[0], torch.Tensor):
            return "Tensor.cuda() of a host tensor" \
                if args[0].device.type == "cpu" else None
        if name == "copy_" and len(args) > 1:
            dst, src = args[0], args[1]
            if isinstance(dst, torch.Tensor) and dst.is_cuda and \
                    host_data(src):
                return "copy_ into a CUDA tensor from host data"
            return None
        if name in ("tensor", "as_tensor", "asarray"):
            data = args[0] if args else kwargs.get("data")
            if on_card(kwargs.get("device")) and not (
                    isinstance(data, torch.Tensor) and data.is_cuda):
                return f"torch.{name}(..., device={kwargs['device']}) " \
                    "from host data"
            return None
        tensors = [x for x in operands(args, kwargs)
                   if isinstance(x, torch.Tensor)]
        if not any(t.is_cuda for t in tensors):
            return None
        import numpy as np

        for x in operands(args, kwargs):
            if isinstance(x, torch.Tensor) and x.device.type == "cpu":
                return f"host tensor operand of {name} on a CUDA tensor"
            if isinstance(x, np.ndarray):
                return f"numpy operand of {name} on a CUDA tensor"
        return None

    class GuardMode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")
            what = implicit_upload(name, args, kwargs)
            if what is not None and not guard._made_by_counted_seam():
                guard._refuse(what)
            return func(*args, **kwargs)

    return GuardMode


class ReplicaDivergenceSanitizer:
    """Shadow-replica twin: the runtime proof of apply determinism.

    While installed, every ``NomadFSM`` constructed carries a hidden
    in-proc twin (no broker, no hooks, no trace spans).  Each raft
    entry the primary applies is re-applied to the twin, and
    ``store.fingerprint()`` (or the caller's ``digest`` of a store) is
    byte-compared at commit quiescence points — the first few applies
    (including the first applies after a ``restore``, which resets the
    count; restore itself compares lazily so fingerprinting doesn't
    materialize freshly restored columnar slabs), every ``interval``
    thereafter, and at each ``compare_all``.  Any nondeterminism the static
    consensuslint pass can't
    see (a hash-order walk that escaped the AST patterns, a
    time-dependent value smuggled through a helper) diverges the twin
    and fails the test that caused it.

    Tests that seed state by writing the primary's store DIRECTLY
    (bypassing the raft log) would falsely diverge the twin, so each
    store counts its write-method commits (``_bump``) while the
    sanitizer is installed: a primary/twin commit-count mismatch means
    out-of-band writes, and that FSM's pair is dropped from comparison
    (counted in ``desynced``, not silent) instead of reported.

    Divergence raises inside the offending apply AND is recorded for
    ``check()`` at session teardown — a raise swallowed by a raft
    apply loop still fails the session.
    """

    def __init__(self, interval: int = 64, digest=None) -> None:
        self.interval = interval
        # What a pair compares: the store's fingerprint unless the
        # caller passes a digest of its own (a function of a store).
        self.digest = digest or _fingerprint
        self.mismatches: list = []
        self.desynced = 0
        self.compared = 0
        self._installed = False
        self._saved: list = []
        self._fsms: list = []     # weakrefs of primaries
        self._reg_lock = threading.Lock()
        self._tls = threading.local()

    # -- install/uninstall --------------------------------------------------
    def install(self) -> "ReplicaDivergenceSanitizer":
        if self._installed:
            return self
        import weakref

        from nomad_tpu_torch.server.fsm import NomadFSM
        from nomad_tpu_torch.state.store import StateStore

        san = self
        orig_init = NomadFSM.__init__
        orig_apply = NomadFSM.apply
        orig_restore = NomadFSM.restore
        orig_bump = StateStore._bump
        self._saved = [(NomadFSM, "__init__", orig_init),
                       (NomadFSM, "apply", orig_apply),
                       (NomadFSM, "restore", orig_restore),
                       (StateStore, "_bump", orig_bump)]

        def counted_bump(store, table, index):
            store._sanitizer_bumps = \
                getattr(store, "_sanitizer_bumps", 0) + 1
            return orig_bump(store, table, index)

        def init(fsm, *args, **kwargs):
            orig_init(fsm, *args, **kwargs)
            if getattr(san._tls, "constructing", False):
                return          # this IS a twin being built
            san._tls.constructing = True
            try:
                twin = NomadFSM()
            finally:
                san._tls.constructing = False
            # Shadow the span recorder on the twin: the obs plane's
            # exactly-once apply-span accounting must see each entry
            # once, not once per replica.
            twin._record_apply_spans = _noop_spans
            fsm._divergence_twin = twin
            fsm._divergence_lock = _real_lock()
            fsm._divergence_applied = 0
            with san._reg_lock:
                san._fsms.append(weakref.ref(fsm))

        def apply(fsm, index, entry):
            twin = getattr(fsm, "_divergence_twin", None)
            if twin is None:
                return orig_apply(fsm, index, entry)
            with fsm._divergence_lock:
                try:
                    result = orig_apply(fsm, index, entry)
                except BaseException:
                    # A deterministic rejection must hit the twin too,
                    # or the next compare reports a skew that isn't
                    # nondeterminism.
                    try:
                        orig_apply(twin, index, entry)
                    except BaseException:
                        pass
                    raise
                try:
                    orig_apply(twin, index, entry)
                except BaseException as e:
                    san._report(
                        fsm, index,
                        f"shadow twin raised {e!r} on an entry the "
                        f"primary applied cleanly")
                fsm._divergence_applied += 1
                n = fsm._divergence_applied
                if n <= 4 or n % san.interval == 0:
                    san._compare(fsm, twin, index)
                return result

        def restore(fsm, blob):
            twin = getattr(fsm, "_divergence_twin", None)
            if twin is None:
                return orig_restore(fsm, blob)
            with fsm._divergence_lock:
                result = orig_restore(fsm, blob)
                orig_restore(twin, blob)
                fsm._divergence_applied = 0
                # No eager compare here: fingerprint() would materialize
                # the freshly restored columnar slabs, destroying the
                # lazy-restore property tests assert on.  The first
                # post-restore applies and the per-test teardown sweep
                # compare the restored pair instead.
                return result

        NomadFSM.__init__ = init
        NomadFSM.apply = apply
        NomadFSM.restore = restore
        StateStore._bump = counted_bump
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for holder, attr, fn in self._saved:
            setattr(holder, attr, fn)
        self._saved = []
        self._installed = False

    def __enter__(self) -> "ReplicaDivergenceSanitizer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- comparison ---------------------------------------------------------
    def _compare(self, fsm, twin, index: int) -> None:
        p_bumps = getattr(fsm.state, "_sanitizer_bumps", 0)
        t_bumps = getattr(twin.state, "_sanitizer_bumps", 0)
        if p_bumps != t_bumps:
            # Out-of-band direct store writes (test seeding): this
            # pair can never agree again; drop it, visibly.
            fsm._divergence_twin = None
            self.desynced += 1
            return
        self.compared += 1
        a = self.digest(fsm.state)
        b = self.digest(twin.state)
        if a != b:
            self._report(
                fsm, index,
                f"primary fingerprint {a[:16]}… != shadow twin "
                f"{b[:16]}… after identical entries")

    def _report(self, fsm, index: int, detail: str) -> None:
        # One report per pair: a diverged twin stays diverged, so drop
        # it rather than re-reporting at every later quiescence point.
        fsm._divergence_twin = None
        where = "restore" if index < 0 else f"index {index}"
        msg = (f"replica divergence at {where}: {detail} — the apply "
               f"path consumed a nondeterministic input (wall clock, "
               f"RNG, host env, or hash-order); see "
               f"nomad_tpu_torch/analysis/consensuslint.py rules")
        self.mismatches.append(msg)
        raise AssertionError(msg)

    def compare_all(self) -> None:
        """Quiescence-point sweep (per-test teardown): fingerprint every
        live pair; raises on the first divergence found."""
        if not self._installed:
            return
        with self._reg_lock:
            refs = list(self._fsms)
            self._fsms = [r for r in refs if r() is not None]
        for ref in refs:
            fsm = ref()
            if fsm is None:
                continue
            twin = getattr(fsm, "_divergence_twin", None)
            if twin is None:
                continue
            with fsm._divergence_lock:
                self._compare(fsm, twin, index=fsm._divergence_applied)

    def check(self) -> None:
        """Session-teardown catch-all: any recorded divergence — even
        one whose in-apply raise was swallowed by a raft loop — fails
        the session."""
        if self.mismatches:
            raise AssertionError(
                "replica divergence observed during the session:\n" +
                "\n".join(f"  - {m}" for m in self.mismatches))


def _noop_spans(*args, **kwargs) -> None:
    return None


def _fingerprint(state) -> str:
    return state.fingerprint()


# ---------------------------------------------------------------------------
# Budget witness
# ---------------------------------------------------------------------------

class BudgetWitnessSanitizer:
    """Records unbounded waits taken on a thread serving an admitted RPC.

    The deadline discipline (server/overload.py) says every wait on a
    request path consumes the admitted envelope's budget.  faultlint
    proves the *syntactic* form; this witness proves the runtime one: a
    ``timeout=None`` hiding behind a variable or a default argument is
    invisible to the AST but lands here, on the actual serving thread,
    with the wait's call stack.

    Waits are recorded, never blocked — the per-test ``check_test()``
    (conftest ``budget_quiescence``) fails the offending test and
    resets; session ``check()`` is the catch-all for hits recorded
    outside any test body.  The heartbeat/liveness lane is exempt, same
    as the static pass.
    """

    def __init__(self, package_prefix: Optional[str] = None) -> None:
        if package_prefix is None:
            package_prefix = _package_dir()
        self.package_prefix = os.path.abspath(package_prefix)
        self.hits: list = []        # (method, primitive, test, stack)
        self._tls = threading.local()
        self._hits_lock = _real_lock()
        self._installed = False
        self._saved: list = []

    # -- install/uninstall --------------------------------------------------
    def install(self) -> "BudgetWitnessSanitizer":
        if self._installed:
            return self
        import queue

        from nomad_tpu_torch.server.endpoints import Endpoints
        from nomad_tpu_torch.server.overload import HEARTBEAT_LANE

        san = self
        orig_body = Endpoints._admitted_body
        # Patch the REAL primitive classes: a lock-order witness
        # rebinds the threading.Condition *name* to a factory, but its
        # instances are still _RealCondition objects, so the method
        # patch covers every installation order.
        orig_event_wait = threading.Event.wait
        orig_cond_wait = _RealCondition.wait
        orig_get = queue.Queue.get
        self._saved = [(Endpoints, "_admitted_body", orig_body),
                       (threading.Event, "wait", orig_event_wait),
                       (_RealCondition, "wait", orig_cond_wait),
                       (queue.Queue, "get", orig_get)]

        def admitted_body(ep, method, handler, args):
            if method in HEARTBEAT_LANE or "heartbeat" in method.lower():
                return orig_body(ep, method, handler, args)
            prev = getattr(san._tls, "serving", None)
            san._tls.serving = method
            try:
                return orig_body(ep, method, handler, args)
            finally:
                san._tls.serving = prev

        def record(primitive: str) -> None:
            method = getattr(san._tls, "serving", None)
            if method is None:
                return
            # Only PACKAGE wait sites count — stdlib-internal waits
            # (Thread.start's _started handshake, Queue.get's internal
            # Condition) are not budget holders; this is the same
            # domain restriction the static pass has.
            caller = sys._getframe(2).f_code.co_filename
            if not _in_package(os.path.abspath(caller),
                               san.package_prefix):
                return
            import traceback

            # Drop the two witness frames; keep the caller's chain.
            stack = "".join(traceback.format_stack(limit=14)[:-2])
            test = os.environ.get("PYTEST_CURRENT_TEST", "<no test>")
            with san._hits_lock:
                san.hits.append((method, primitive, test, stack))

        def event_wait(ev, timeout=None):
            if timeout is None:
                record("Event.wait")
            return orig_event_wait(ev, timeout)

        def cond_wait(cond, timeout=None):
            if timeout is None:
                record("Condition.wait")
            return orig_cond_wait(cond, timeout)

        def queue_get(q, block=True, timeout=None):
            if block and timeout is None:
                record("Queue.get")
            return orig_get(q, block, timeout)

        Endpoints._admitted_body = admitted_body
        threading.Event.wait = event_wait
        _RealCondition.wait = cond_wait
        queue.Queue.get = queue_get
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for holder, attr, fn in self._saved:
            setattr(holder, attr, fn)
        self._saved = []
        self._installed = False

    def __enter__(self) -> "BudgetWitnessSanitizer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- reporting ----------------------------------------------------------
    def _render(self, hits: list) -> str:
        lines = []
        for method, primitive, test, stack in hits:
            lines.append(
                f"unbounded {primitive} while serving {method} "
                f"(test: {test}):\n{stack}")
        return (
            "budget-witness: wait with no timeout on an RPC-serving "
            "thread — the admitted envelope's budget was dropped (see "
            "nomad_tpu_torch/analysis/faultlint.py deadline pass):\n" +
            "\n".join(lines))

    def check_test(self) -> None:
        """Per-test teardown: fail THIS test on any hit it recorded,
        then reset so later tests report only their own."""
        with self._hits_lock:
            hits, self.hits = self.hits, []
        if hits:
            raise AssertionError(self._render(hits))

    def check(self) -> None:
        """Session catch-all for hits recorded outside any test body
        (module fixtures, background threads between tests)."""
        with self._hits_lock:
            hits = list(self.hits)
        if hits:
            raise AssertionError(self._render(hits))
