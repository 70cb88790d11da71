"""Client: the node agent.

Capability parity with reference client/client.go: fingerprint the
host into a Node, register with servers, heartbeat at the server-given TTL,
long-poll ``Node.GetAllocs`` for assigned allocations, diff added/removed/
updated (reference client/util.go:34-70), and manage an AllocRunner per
allocation.  Node ID and alloc state persist under state_dir so a restarted
agent re-attaches to running tasks.

Server transport is the ``rpc_handler`` seam: an in-proc object (the
colocated server, reference agent.go:176-178) or a pooled network client.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from nomad_tpu_torch.structs import (
    NODE_STATUS_INIT,
    NODE_STATUS_READY,
    Allocation,
    Node,
    generate_uuid,
)
from nomad_tpu_torch.utils.retry import Backoff, RetryPolicy
from nomad_tpu_torch.utils.sync import Immutable

from .alloc_runner import AllocRunner, CorruptAllocState, reclaim_orphan
from .config import ClientConfig
from .driver import BUILTIN_DRIVERS
from .fingerprint import fingerprint_node

logger = logging.getLogger("nomad_tpu_torch.client")

REGISTER_RETRY_INTERVAL = 1.0   # registration backoff base
REGISTER_RETRY_MAX = 30.0       # registration backoff cap
STATE_SNAPSHOT_INTERVAL = 60.0

# Node.UpdateAlloc sync: a short bounded burst with a per-attempt
# transport timeout AND a total deadline well under the ~20s
# server-side TTL+grace window (a hung server must not pin the status
# outbox — or delay the next heartbeat — long enough to expire the
# node); anything that still fails stays queued for the next heartbeat
# (never dropped).  Breadth of `Exception` is deliberate —
# RPCError("no leader") is as transient here as a dead socket.
UPDATE_ALLOC_POLICY = RetryPolicy(
    base=0.2, max_delay=2.0, max_attempts=3, attempt_timeout=3.0,
    deadline=5.0,
    retryable=lambda e: isinstance(e, Exception),
    name="client.update_alloc")


class NetRPCHandler:
    """Network transport: calls a server over the conn pool."""

    def __init__(self, servers: list) -> None:
        from nomad_tpu_torch.server.rpc import ConnPool

        self.servers = [tuple(s) for s in servers]
        self.pool = ConnPool()
        self._i = 0

    def call(self, method: str, args: dict, timeout=None):
        # Snapshot the list: set_servers may swap it from another thread
        # (PUT /v1/agent/servers) mid-call.
        servers = self.servers
        last_err: Optional[Exception] = None
        for _ in range(len(servers)):
            address = servers[self._i % len(servers)]
            try:
                return self.pool.call(address, method, args,
                                      timeout=timeout)
            except Exception as e:
                last_err = e
                self._i += 1
        raise last_err or RuntimeError("no servers configured")


class Client:
    def __init__(self, config: ClientConfig) -> None:
        # The config OBJECT is never rebound (set_servers mutates its
        # server list in place, atomically).
        self.config: Immutable = config
        self.rpc = config.rpc_handler or NetRPCHandler(config.servers)

        self.node = config.node or Node()
        self._setup_node()
        self._fingerprint()
        self._setup_drivers()

        self.alloc_runners: dict = {}
        self._alloc_lock = threading.Lock()
        # Allocs whose persisted state was corrupt at restore (torn
        # write from a crash mid-save): the alloc dir is KEPT and the
        # first alloc watch re-fetches the spec from the server; the
        # fresh runner runs with restore=True so a still-live task
        # re-attaches via its (separately persisted) handle instead of
        # doubling.  Guarded by _alloc_lock after construction.
        self._recover_alloc_ids: set = set()
        # Client-authoritative alloc updates awaiting delivery
        # (alloc id -> update dict, newest wins); flushed inline and
        # re-flushed after each successful heartbeat.
        self._pending_updates: dict = {}
        self._update_lock = threading.Lock()
        # Serializes whole flush bursts (heartbeat thread vs inline
        # sync): two interleaved flushes could otherwise deliver a
        # stale snapshot AFTER a newer one, regressing a terminal
        # client_status on the server.
        self._flush_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._heartbeat_ttl = 10.0
        self._alloc_index = 0
        # Worker-thread registry (run/heartbeat loops + churn-spawned
        # destroy/reclaim workers): every mutation holds _threads_lock
        # — start() appends from the caller thread while the client-run
        # thread prunes via _retain, and an unlocked rebind could drop
        # a handle shutdown() must join.
        self._threads_lock = threading.Lock()
        self._threads: list = []
        self._restore_state()

    def servers(self) -> list:
        """The RPC server list (reference client_config.go surface)."""
        if isinstance(self.rpc, NetRPCHandler):
            return list(self.rpc.servers)
        return list(self.config.servers)

    def set_servers(self, servers: list) -> None:
        """Swap the RPC server list at runtime (reference
        command/agent agent servers endpoint + client_config.go)."""
        parsed = [tuple(s) for s in servers]
        self.config.servers = list(parsed)
        if isinstance(self.rpc, NetRPCHandler):
            self.rpc.servers = parsed

    # -- setup -------------------------------------------------------------
    def _setup_node(self) -> None:
        node = self.node
        if not node.id:
            node.id = self._restore_or_create_node_id()
        if not node.datacenter:
            node.datacenter = "dc1"
        node.status = NODE_STATUS_INIT

    def _restore_or_create_node_id(self) -> str:
        if self.config.state_dir:
            path = os.path.join(self.config.state_dir, "client-id")
            try:
                with open(path) as fh:
                    return fh.read().strip()
            except OSError:
                pass
            node_id = generate_uuid()
            os.makedirs(self.config.state_dir, exist_ok=True)
            with open(path, "w") as fh:
                fh.write(node_id)
            return node_id
        return generate_uuid()

    def _fingerprint(self) -> None:
        applied = fingerprint_node(self.config, self.node)
        logger.info("client: fingerprints applied: %s",
                    ",".join(applied))

    def _setup_drivers(self) -> None:
        found = []
        for name, cls in BUILTIN_DRIVERS.items():
            try:
                if cls.fingerprint(self.config, self.node):
                    found.append(name)
            except Exception:
                logger.exception("driver fingerprint %s failed", name)
        logger.info("client: available drivers: %s", ",".join(found))

    # -- state persistence --------------------------------------------------
    def _alloc_state_dir(self, alloc_id: str) -> str:
        return os.path.join(self.config.state_dir, "allocs", alloc_id) \
            if self.config.state_dir else ""

    def _alloc_root(self, alloc_id: str) -> str:
        base = self.config.alloc_dir or \
            os.path.join(self.config.state_dir or "/tmp/nomad-client",
                         "alloc")
        return os.path.join(base, alloc_id)

    def _restore_state(self) -> None:
        """Re-attach to allocs persisted by a previous agent process.
        Terminal allocs are cleaned up, never re-run."""
        import shutil

        if not self.config.state_dir:
            return
        allocs_dir = os.path.join(self.config.state_dir, "allocs")
        if not os.path.isdir(allocs_dir):
            return
        for alloc_id in os.listdir(allocs_dir):
            state_dir = os.path.join(allocs_dir, alloc_id)
            try:
                runner = AllocRunner.restore(
                    self._alloc_root(alloc_id), state_dir,
                    on_status=self._sync_alloc_status,
                    options=self.config.options)
            except CorruptAllocState as e:
                # Torn local state (crash mid-save): the server still
                # knows this alloc.  Keep the directories and re-fetch
                # the spec from the first alloc watch — discarding it
                # here would orphan a possibly-running task.
                logger.warning(
                    "client: alloc %s state is corrupt (%s); will "
                    "re-fetch it from the server and re-attach",
                    alloc_id, e)
                self._recover_alloc_ids.add(alloc_id)
                continue
            if runner is None:
                continue
            if runner.alloc.terminal_status() or \
                    runner.alloc.client_status in ("dead", "failed"):
                shutil.rmtree(state_dir, ignore_errors=True)
                shutil.rmtree(self._alloc_root(alloc_id),
                              ignore_errors=True)
                continue
            self.alloc_runners[alloc_id] = runner
            runner.run(restore=True)
            logger.info("client: restored alloc %s", alloc_id)

    # -- main loop ----------------------------------------------------------
    def start(self) -> None:
        t = threading.Thread(target=self.run, daemon=True,
                             name="client-run")
        t.start()
        self._retain(t)

    def run(self) -> None:
        self._register()
        t = threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name="client-heartbeat")
        t.start()
        self._retain(t)
        self._watch_allocations()

    def shutdown(self) -> None:
        self._shutdown.set()
        pool = getattr(self.rpc, "pool", None)
        if pool is not None:
            pool.shutdown()
        with self._threads_lock:
            threads = list(self._threads)
        # Shared deadline across the joins: the registry now includes
        # churn workers (destroy/reclaim/flush bursts), and 1s EACH
        # would make shutdown latency scale with live churn.
        import time as _time
        deadline = _time.monotonic() + 3.0
        for t in threads:
            t.join(max(0.0, deadline - _time.monotonic()))

    def destroy_all(self) -> None:
        with self._alloc_lock:
            runners = list(self.alloc_runners.values())
        for r in runners:
            r.destroy_tasks()

    # -- registration / heartbeat -------------------------------------------
    def _register(self) -> None:
        node = self.node.copy()
        node.status = NODE_STATUS_READY
        backoff = Backoff(base=REGISTER_RETRY_INTERVAL,
                          max_delay=REGISTER_RETRY_MAX, jitter=0.5)
        while not self._shutdown.is_set():
            try:
                resp = self.rpc.call("Node.Register",
                                     {"node": node.to_dict()})
            except Exception as e:
                # First failure carries the traceback; the rest are
                # one-line WARNs — an unreachable server is expected
                # during bring-up and must not fill the log.
                first = backoff.failures == 0
                delay = backoff.next()
                if first:
                    logger.warning(
                        "client: registration failed; retrying with "
                        "capped backoff (next in %.1fs)", delay,
                        exc_info=True)
                else:
                    logger.warning(
                        "client: registration still failing after %d "
                        "attempts (next in %.1fs): %s",
                        backoff.failures, delay, e)
                self._shutdown.wait(delay)
                continue
            self.node = node
            if resp.get("heartbeat_ttl"):
                self._heartbeat_ttl = resp["heartbeat_ttl"]
            logger.info("client: registered node %s", node.id)
            return

    def _heartbeat_loop(self) -> None:
        while not self._shutdown.is_set():
            # Heartbeat at a fraction of the TTL so jitter can't expire us.
            self._shutdown.wait(max(0.2, self._heartbeat_ttl / 2))
            if self._shutdown.is_set():
                return
            try:
                resp = self.rpc.call("Node.Heartbeat",
                                     {"node_id": self.node.id})
                if resp.get("heartbeat_ttl"):
                    self._heartbeat_ttl = resp["heartbeat_ttl"]
            except Exception:
                logger.warning("client: heartbeat failed; re-registering")
                self._register()
            else:
                # The server is reachable: deliver any alloc updates a
                # failed sync left queued.  Non-blocking — the
                # heartbeat cadence must never wait out a flush burst
                # (a stalled burst outlasting the TTL would expire this
                # node and duplicate its allocations elsewhere).
                with self._update_lock:
                    dirty = bool(self._pending_updates)
                if dirty:
                    t = threading.Thread(
                        target=self._flush_alloc_updates,
                        kwargs={"block": False}, daemon=True,
                        name="client-alloc-flush")
                    t.start()
                    # Retained in the locked registry so shutdown reaps
                    # it; _retain prunes superseded bursts (each is
                    # deadline-capped at 5s by UPDATE_ALLOC_POLICY).
                    self._retain(t)

    # -- alloc watching ------------------------------------------------------
    def _watch_allocations(self) -> None:
        while not self._shutdown.is_set():
            try:
                # Stale read (reference client.go:601-608 AllowStale):
                # any server answers from local state, so alloc watching
                # scales across followers and survives elections; the
                # min_query_index long-poll still guarantees progress.
                resp = self.rpc.call("Node.GetAllocs", {
                    "node_id": self.node.id,
                    "min_query_index": self._alloc_index,
                    "max_query_time": 5.0,
                    "stale": True,
                })
            except Exception:
                logger.exception("client: alloc watch failed")
                self._shutdown.wait(1.0)
                continue
            index = resp.get("index", 0)
            if index <= self._alloc_index:
                # Timeout, or a stale server lagging behind state we
                # already applied: never diff on it — a lagging
                # follower's absence of a live alloc would destroy it
                # (reference client.go:633-636 Index<=MinQueryIndex).
                if index <= 0:
                    # Pre-first-write table: back off instead of a hot
                    # loop of immediate returns.
                    self._shutdown.wait(0.2)
                continue
            self._alloc_index = index
            allocs = [Allocation.from_dict(a)
                      for a in resp.get("allocs", [])]
            self._run_allocs(allocs)

    def _run_allocs(self, updated: list) -> None:
        """Diff assigned allocs vs running runners
        (reference client/util.go:34-70 + client.go:650-728)."""
        assigned = {a.id: a for a in updated}
        reclaim: list = []
        destroy: list = []
        with self._alloc_lock:
            existing = dict(self.alloc_runners)

            # Removed: server no longer lists the alloc — stop it, drop
            # the runner, and reclaim its directories in the background
            # (threads spawned OUTSIDE the lock, below).
            for alloc_id, runner in existing.items():
                if alloc_id not in assigned:
                    self.alloc_runners.pop(alloc_id, None)
                    destroy.append(runner)

            # A recovering (torn-state) alloc the server no longer
            # lists at all — GC'd while the client was down: same
            # semantics as the Removed branch, but there is no runner,
            # so the persisted task handles drive the kill + reclaim.
            for alloc_id in list(self._recover_alloc_ids):
                if alloc_id not in assigned:
                    self._recover_alloc_ids.discard(alloc_id)
                    reclaim.append(alloc_id)

            for alloc in assigned.values():
                runner = existing.get(alloc.id)
                if runner is None:
                    recover = alloc.id in self._recover_alloc_ids
                    self._recover_alloc_ids.discard(alloc.id)
                    if alloc.terminal_status():
                        if recover:
                            # The server is done with it; the torn
                            # state still names live task handles —
                            # kill the orphan and reclaim, never just
                            # forget it.
                            reclaim.append(alloc.id)
                        continue
                    runner = AllocRunner(
                        alloc, self._alloc_root(alloc.id),
                        state_dir=self._alloc_state_dir(alloc.id),
                        on_status=self._sync_alloc_status,
                        options=self.config.options)
                    self.alloc_runners[alloc.id] = runner
                    # A re-fetched corrupt-state alloc runs the restore
                    # path: task handles persist separately from alloc
                    # state, so a live task re-attaches (exactly-once)
                    # instead of starting a double.
                    runner.run(restore=recover)
                elif alloc.modify_index > runner.alloc.modify_index:
                    runner.update(alloc)
        for runner in destroy:
            # Teardown off the watch loop, bounded by destroy()'s
            # per-task join timeouts; retained so shutdown joins it
            # like the reclaim threads.
            t = threading.Thread(target=runner.destroy, daemon=True,
                                 name="alloc-destroy")
            t.start()
            self._retain(t)
        for alloc_id in reclaim:
            self._reclaim_recover(alloc_id)

    def _retain(self, t) -> None:
        """Retain a worker thread for shutdown's join, pruning finished
        ones so alloc churn over a long-lived client cannot grow the
        list without bound (all mutations under _threads_lock — see
        __init__)."""
        with self._threads_lock:
            self._threads = [x for x in self._threads
                             if x.is_alive()] + [t]

    def _reclaim_recover(self, alloc_id: str) -> None:
        """Background kill-and-reclaim of a corrupt-state alloc the
        server is done with (reclaim_orphan re-attaches any live task
        by its persisted handle first — blocking driver work stays off
        the watch loop, like the Removed branch's destroy).  The
        handle is retained: shutdown() joins it like every other
        client thread."""
        t = threading.Thread(
            target=reclaim_orphan,
            args=(alloc_id, self._alloc_root(alloc_id),
                  self._alloc_state_dir(alloc_id)),
            kwargs={"options": self.config.options},
            daemon=True, name=f"alloc-reclaim-{alloc_id[:8]}")
        t.start()
        self._retain(t)

    def _sync_alloc_status(self, alloc: Allocation) -> None:
        """Dirty-sync client-authoritative fields to the server.  The
        update is queued first, so a server outage longer than the
        retry burst leaves it pending for the next heartbeat instead of
        dropping it (a silent loss: a terminal status the server never
        heard about pins the alloc live forever)."""
        update = {
            "id": alloc.id,
            "client_status": alloc.client_status,
            "client_description": alloc.client_description,
            "task_states": alloc.task_states,
            "node_id": alloc.node_id,
        }
        with self._update_lock:
            self._pending_updates[alloc.id] = update
        self._flush_alloc_updates()

    def _flush_alloc_updates(self, block: bool = True) -> None:
        """Push every queued alloc update in one call (jittered bounded
        retries); failures leave the queue intact — newest update per
        alloc wins, delivery retries on the next heartbeat.

        One burst at a time (`_flush_lock`), and each retry attempt
        re-snapshots the queue, so a retry never re-sends a payload
        that a newer update has superseded mid-burst.  ``block=False``
        (the heartbeat path) bails out when a burst is already in
        flight — its later attempts re-snapshot and pick our update
        up, or the next heartbeat retries."""
        if not self._flush_lock.acquire(blocking=block):
            return
        try:
            self._flush_alloc_updates_locked()
        finally:
            self._flush_lock.release()

    def _flush_alloc_updates_locked(self) -> None:
        delivered: dict = {}

        def attempt(timeout=None) -> None:
            with self._update_lock:
                snapshot = dict(self._pending_updates)
            if not snapshot:
                delivered.clear()
                return
            self.rpc.call("Node.UpdateAlloc",
                          {"alloc": list(snapshot.values())},
                          timeout=timeout)
            delivered.clear()
            delivered.update(snapshot)

        with self._update_lock:
            if not self._pending_updates:
                return
        try:
            UPDATE_ALLOC_POLICY.call(attempt, stop=self._shutdown)
        except Exception as e:
            with self._update_lock:
                queued = len(self._pending_updates)
            logger.warning(
                "client: alloc status sync failed; %d update(s) "
                "queued for next heartbeat: %s", queued, e)
            return
        with self._update_lock:
            for alloc_id, update in delivered.items():
                # Drop only what we actually delivered: a runner
                # may have queued a newer update mid-flight.
                if self._pending_updates.get(alloc_id) is update:
                    del self._pending_updates[alloc_id]
