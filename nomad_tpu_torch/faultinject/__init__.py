"""Deterministic fault injection at the system's chokepoints.

Counterpart of ``nomad_tpu/faultinject/__init__.py`` and ``plan.py``.
The port wires the server plane's sites (broker enqueue, raft apply,
the raft storage sites, heartbeat delivery, the store's watch
delivery), the RPC plane's (``rpc.send``, ``rpc.recv``,
``rpc.admit``, ``mux.accept``, ``conn.read``) and the pipelined runner's
(``device.dispatch``, ``device.collect``); ``CrashHarness``
(``faultinject/crash.py``) hard-kills and reboots a server.

The runtime consults a process-global plan at named *sites* — RPC
send/receive/admit, raft apply, heartbeat delivery, broker enqueue,
device dispatch/collect, driver start — so failure paths that
production only exercises during
an outage (lost frames, hung device calls, expiring TTLs) can be driven
on demand, deterministically, in tests and soaks.

Usage::

    from nomad_tpu_torch import faultinject

    plan = faultinject.FaultPlan(seed=7)
    plan.add("rpc.send", "drop", count=2, method="Node.UpdateAlloc")
    with faultinject.injected(plan):
        ...   # the next two Node.UpdateAlloc sends raise FaultDropped

or via the environment (parsed once at import; ``NOMAD_TPU_FAULTS`` is
the JAX package's variable too, so one process running both packages
reads one spec, and the grammar and site names are the same)::

    NOMAD_TPU_FAULTS='seed=7;heartbeat.deliver=drop(node=n-3*,count=5)'

Instrumented call sites pay one module-attribute read when no plan is
installed::

    if faultinject.ACTIVE:
        faultinject.fire("raft.apply")

``ACTIVE`` flips with install/clear, so the disabled path is a single
bool check — no lock, no dict lookups, no context building.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

from .plan import (  # noqa: F401  (public API re-exports)
    ACTIONS,
    SITES,
    STORAGE_SITES,
    FaultCrash,
    FaultDropped,
    FaultInjected,
    FaultPlan,
    FaultRule,
    FaultSpecError,
)

# True whenever a plan is installed.  Read bare by instrumented sites
# (the whole point is a near-zero disabled path); written only under
# _install_lock, always together with _active.
ACTIVE: bool = False

_active: Optional[FaultPlan] = None
_install_lock = threading.Lock()

ENV_VAR = "NOMAD_TPU_FAULTS"


def install_plan(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-global active plan (replacing any)."""
    global ACTIVE, _active
    with _install_lock:
        _active = plan
        ACTIVE = True
    return plan


def clear_plan() -> None:
    global ACTIVE, _active
    with _install_lock:
        _active = None
        ACTIVE = False


def active_plan() -> Optional[FaultPlan]:
    return _active


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """Scoped install: the plan is active inside the block, cleared (or
    the previous plan restored) on exit — exception-safe, so a test
    that fails mid-soak can't leak faults into the next test."""
    with _install_lock:
        previous = _active
    install_plan(plan)
    try:
        yield plan
    finally:
        if previous is None:
            clear_plan()
        else:
            install_plan(previous)


def fire(site: str, method: Optional[str] = None,
         node: Optional[str] = None) -> None:
    """Consult the active plan at ``site``; no-op when none installed.

    Callers on hot paths should guard with ``if faultinject.ACTIVE:`` so
    the disabled cost is one attribute read, but calling bare is safe.
    """
    plan = _active
    if plan is None:
        return
    plan.fire(site, method=method, node=node)


def crashed(path: Optional[str] = None) -> bool:
    """True after a ``crash`` fault fired and before a CrashHarness
    reboot: the simulated process is dead, so every storage site it
    covers must refuse writes (the first torn record must stay the
    LAST byte the process ever wrote).  ``path`` is the caller's
    on-disk location — a crash rule scoped with a ``method`` path
    prefix latches only the stores under that prefix (one server's
    data_dir in a multi-server soak); an unscoped rule latches them
    all."""
    plan = _active
    return plan is not None and plan.is_crashed(path)


def fire_rpc(site: str, method: str, args) -> None:
    """RPC-plane consultation: extracts the node id (when the request
    shape carries one — ``node_id``, a nested ``node``, or the first
    alloc-update's ``node_id``) so node-predicate rules can target a
    single client's traffic."""
    plan = _active
    if plan is None:
        return
    node = None
    if isinstance(args, dict):
        node = args.get("node_id")
        if node is None:
            n = args.get("node")
            if isinstance(n, dict):
                node = n.get("id")
        if node is None:
            updates = args.get("alloc")
            if isinstance(updates, (list, tuple)) and updates and \
                    isinstance(updates[0], dict):
                node = updates[0].get("node_id")
    plan.fire(site, method=method, node=node)


# Environment opt-in: one parse at import, so every process (pytest
# worker, bench, agent) wired through NOMAD_TPU_FAULTS participates
# without code changes.  A malformed spec fails the import — silently
# injecting nothing would be the worst outcome for a chaos run.
_env_spec = os.environ.get(ENV_VAR)
if _env_spec:
    install_plan(FaultPlan.parse(_env_spec))
del _env_spec
