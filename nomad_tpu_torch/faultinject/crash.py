"""CrashHarness: hard-drop a server (simulated power loss) and reboot
a fresh one from the same data_dir.

A graceful ``Server.shutdown()`` proves nothing about durability — it
flushes, snapshots, joins, and answers everyone before exiting.  The
harness models what production actually meets: the process dies
mid-commit.

``kill(server)`` does exactly two things, in order:

1. **Freeze storage** (:func:`freeze_storage`): every durable store of
   the server's raft backend — log, snapshots, term/vote metadata — is
   marked dead, so not one more byte reaches the data_dir.  When the
   kill follows an injected ``crash`` fault, the torn bytes that fault
   left ARE the final disk state, exactly as a power cut would leave
   them.
2. **Abandon the process shell** (``Server.abandon``): stop events are
   signalled (the OS reaping threads), sockets sever mid-frame, and
   nothing is joined, flushed, persisted, or responded.

``reboot(config)`` clears the process-wide crash latch (the dead
process is gone; the reborn one's stores may write) and constructs a
fresh ``Server`` over the same data_dir — boot-time recovery (snapshot
restore, log tail-scan + replay) is exercised for real.

``reap()`` is suite hygiene only, NOT part of the crash model: it
fully tears down the abandoned husks after the proof ran, so a session
doesn't accumulate daemon threads, and drops the husks' fleet tensors
from the process-wide fleet cache, so a dead server's copies stop
holding the card's memory.

Counterpart of ``nomad_tpu/faultinject/crash.py`` over the port's
``Server`` and ``InmemRaft``.
"""
from __future__ import annotations

from typing import Optional

from . import active_plan


def freeze_storage(raft) -> None:
    """Mark every durable store of a raft backend dead (see
    FileLogStore.die): the process is gone, its data_dir must stay
    byte-exact.  Works on both backends — InmemRaft exposes
    ``log_store``/``snapshots``, NetRaft ``_log_store``/``_snap_store``/
    ``_meta``."""
    for attr in ("log_store", "snapshots", "_log_store", "_snap_store",
                 "_meta"):
        store = getattr(raft, attr, None)
        die = getattr(store, "die", None)
        if callable(die):
            die()


class CrashHarness:
    """Kill/reboot rig for the crash-recovery proofs
    (tests/test_torch_crash_recovery.py, chip_smoke.py's failover
    phase)."""

    def __init__(self) -> None:
        self.dead: list = []   # abandoned husks awaiting reap()
        self.kills = 0

    def kill(self, server) -> None:
        """Hard-drop ``server``: freeze its storage, then abandon the
        process shell.  No graceful teardown of any kind runs — see
        the module docstring for the exact contract."""
        freeze_storage(server.raft)
        server.abandon()
        self.dead.append(server)
        self.kills += 1

    def reboot(self, config):
        """Boot a fresh Server over ``config`` (same data_dir, same
        address as the husk it replaces).  Clears the plan-wide crash
        latch first: the dead process is gone, the reborn one's stores
        write normally.  Single-node (InmemRaft) servers get the same
        ``establish_leadership`` bring-up the agent performs."""
        from nomad_tpu_torch.server import Server
        from nomad_tpu_torch.server.raft import InmemRaft

        plan = active_plan()
        if plan is not None:
            plan.reset_crashed()
        server = Server(config)
        if isinstance(server.raft, InmemRaft):
            server.establish_leadership()
        return server

    def reap(self, also: Optional[list] = None) -> None:
        """Post-proof hygiene: fully tear down the abandoned husks
        (and any ``also`` servers) so the session doesn't accumulate
        daemon threads, then forget their fleet generations.  Every
        step is best-effort — a husk is already half-dead by design."""
        from nomad_tpu_torch.models.fleet import fleet_cache

        for server in self.dead + list(also or ()):
            for step in (server.shutdown,
                         getattr(server.raft, "shutdown", None),
                         server.heartbeats.shutdown,
                         server.fsm.state.watch.shutdown,
                         lambda s=server: fleet_cache.forget(s.fsm.state)):
                if step is None:
                    continue
                try:
                    step()
                except Exception:
                    pass
        self.dead = []
