"""MVCC in-memory state store with O(1) snapshots.

Capability parity with reference nomad/state/state_store.go (go-memdb
immutable-radix MVCC): tables ``index, nodes, jobs, evals, allocs``; per-table
raft-index bookkeeping; secondary indexes (allocs by node/job/eval, evals by
job); snapshot in O(1); change notification for blocking queries.

Implementation is copy-on-write at table granularity instead of radix trees:
a snapshot freezes the current table dicts; the first write to a table after a
snapshot copies that table's dict (and the touched secondary-index buckets).
The store never mutates an object in place — every upsert stores a copy and
every reader must treat returned objects as immutable, exactly the contract
the reference documents (state_store.go:17-19).

The store is also the source feeding the device-resident fleet tensors: it
exposes a monotonically increasing per-table index that the state->device bridge
uses as its RefreshIndex-style fence (see nomad_tpu_torch/models/fleet.py).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional

from nomad_tpu_torch import faultinject
from nomad_tpu_torch.structs import (
    Allocation,
    Evaluation,
    Job,
    Node,
    valid_node_status,
)

TABLES = ("nodes", "jobs", "evals", "allocs")


class _Waiter:
    """One parked watch subscription (a callback, never a thread)."""

    __slots__ = ("token", "key", "min_index", "deliver", "timed",
                 "deadline")

    def __init__(self, token: str, key, min_index: int, deliver,
                 timed: bool, deadline: Optional[float]) -> None:
        self.token = token
        self.key = key
        self.min_index = min_index
        self.deliver = deliver   # deliver(timed_out: bool), exactly once
        self.timed = timed       # True = armed on the timeout wheel
        self.deadline = deadline  # absolute monotonic; None = untimed


class StateWatch:
    """Shared watch fan-out keyed by (key, min_index).

    Parity role: nomad/state/notify.go NotifyGroup — blocking queries
    register on keys like ("allocs",) or ("alloc-node", node_id) and are
    woken when a write touches the key.

    Beyond the reference (the event-driven serving plane): waiters are
    *callbacks* in ONE shared registry instead of one parked
    Event-holding thread each.  ``subscribe(key, deliver, min_index,
    ttl)`` parks a callback that the single notifier drains when the
    key's table index advances past ``min_index``; timeouts ride one
    shared TTL wheel (server/ttlwheel.py) instead of per-waiter timers;
    and every exit path — wakeup, timeout, unsubscribe, conn death —
    removes the waiter, so an abandoned long-poll can never leak a
    registry entry (``live_waiters()`` is the gauge; the regression
    test churns abandoned polls and asserts it returns to zero).  The
    legacy ``watch``/``stop_watch`` Event API rides the same registry.

    The ``watch.deliver`` fault site fires per matured wakeup: ``drop``
    leaves the waiter parked (a lost wakeup — the wheel timeout still
    delivers later, so even injected loss cannot leak), ``delay``
    stalls the notifier like a slow fan-out.
    """

    def __init__(self, index_of=None) -> None:
        self._lock = threading.Lock()
        self._waiters: dict = {}    # token -> _Waiter
        self._by_key: dict = {}     # key -> {token: _Waiter}
        self._seq = 0
        self._wheel = None          # lazy: most stores never park timed waiters
        self._index_of = index_of   # key -> current table index (lost-wakeup recheck)
        # Counters, guarded by _lock.
        self.delivered = 0          # matured wakeups delivered
        self.timeouts = 0           # wheel-expired deliveries
        self.dropped_wakeups = 0    # injected watch.deliver drops

    # -- subscription ------------------------------------------------------
    def subscribe(self, key, deliver, min_index: int = 0,
                  ttl: Optional[float] = None) -> str:
        """Park ``deliver(timed_out)`` until a write moves ``key`` past
        ``min_index`` (0 = any touch) or ``ttl`` expires on the shared
        wheel (None = caller owns the timeout and MUST unsubscribe).
        Exactly-once: wakeup, timeout and unsubscribe race safely.  The
        post-register index recheck closes the lost-wakeup window — a
        write landing between the caller's check and this call delivers
        immediately (possibly on the calling thread)."""
        with self._lock:
            self._seq += 1
            token = f"w{self._seq}"
            waiter = _Waiter(token, key, min_index, deliver,
                             ttl is not None,
                             time.monotonic() + ttl
                             if ttl is not None else None)
            self._waiters[token] = waiter
            self._by_key.setdefault(key, {})[token] = waiter
            if ttl is not None:
                self._wheel_locked().arm(token, ttl)
        if min_index > 0 and self._index_of is not None:
            current = self._index_of(key)
            if current > min_index:
                popped = self._pop(token)
                if popped is not None:
                    with self._lock:
                        self.delivered += 1
                    popped.deliver(False)
        return token

    def unsubscribe(self, token: str) -> bool:
        """Deregister; True when the waiter was still parked (its
        callback will never fire)."""
        return self._pop(token) is not None

    def watch(self, key) -> threading.Event:
        """Legacy Event API: one event per caller, riding the shared
        registry (no wheel entry — stop_watch/notify clean up)."""
        ev = threading.Event()
        token = self.subscribe(key, lambda timed_out: ev.set())
        ev._watch_token = token  # for stop_watch
        return ev

    def stop_watch(self, key, ev: threading.Event) -> None:
        token = getattr(ev, "_watch_token", None)
        if token is not None:
            self.unsubscribe(token)

    # -- notification ------------------------------------------------------
    def notify(self, *keys, index: Optional[int] = None) -> None:
        """A write touched ``keys`` at ``index``: drain every matured
        waiter (min_index 0, or index unknown, or index past
        min_index).  Runs on the writer's thread, outside the store
        lock; callbacks must be quick (set an event / re-enqueue a
        dispatch)."""
        matured: list = []
        with self._lock:
            for key in keys:
                bucket = self._by_key.get(key)
                if not bucket:
                    continue
                for token in list(bucket):
                    waiter = bucket[token]
                    if waiter.min_index and index is not None and \
                            index <= waiter.min_index:
                        continue
                    matured.append(waiter)
                    del bucket[token]
                    self._waiters.pop(token, None)
                if not bucket:
                    self._by_key.pop(key, None)
        for waiter in matured:
            if faultinject.ACTIVE:
                try:
                    faultinject.fire("watch.deliver",
                                     method=str(waiter.key[0]))
                except Exception:
                    # Injected lost wakeup: re-park the waiter — its
                    # wheel timeout (or the caller's own wait) still
                    # delivers, so loss degrades to latency, never a
                    # stuck or leaked waiter.  Re-ARM timed waiters:
                    # the original wheel entry may have fired into the
                    # pop-to-re-park gap, and a timed waiter without a
                    # timer would violate exactly that guarantee.
                    with self._lock:
                        self.dropped_wakeups += 1
                        self._waiters[waiter.token] = waiter
                        self._by_key.setdefault(waiter.key, {})[
                            waiter.token] = waiter
                        if waiter.timed:
                            self._wheel_locked().arm(
                                waiter.token,
                                max(waiter.deadline -
                                    time.monotonic(), 0.001))
                    continue
            self._deliver(waiter, timed_out=False)

    def notify_all(self) -> None:
        """Wake every watcher — used when the whole world may have
        changed (snapshot restore)."""
        with self._lock:
            waiters = list(self._waiters.values())
            self._waiters.clear()
            self._by_key.clear()
        for waiter in waiters:
            self._deliver(waiter, timed_out=False)

    # -- internals ---------------------------------------------------------
    def _wheel_locked(self):
        if self._wheel is None:
            # Lazy import: state must not import nomad_tpu_torch.server at
            # module load (fsm -> state would cycle); by first timed
            # subscribe the server package is long imported.
            from nomad_tpu_torch.server.ttlwheel import TTLWheel
            self._wheel = TTLWheel(self._on_timeout,
                                   name="watch-timeout-wheel")
        return self._wheel

    def _pop(self, token: str) -> Optional[_Waiter]:
        with self._lock:
            waiter = self._waiters.pop(token, None)
            if waiter is None:
                return None
            bucket = self._by_key.get(waiter.key)
            if bucket is not None:
                bucket.pop(token, None)
                if not bucket:
                    self._by_key.pop(waiter.key, None)
            if waiter.timed and self._wheel is not None:
                self._wheel.cancel(token)
        return waiter

    def _deliver(self, waiter: _Waiter, timed_out: bool) -> None:
        with self._lock:
            if timed_out:
                self.timeouts += 1
            else:
                self.delivered += 1
            if waiter.timed and not timed_out and self._wheel is not None:
                self._wheel.cancel(waiter.token)
        waiter.deliver(timed_out)

    def _on_timeout(self, token: str) -> None:
        """Wheel callback: the waiter's wait expired undelivered."""
        waiter = self._pop(token)
        if waiter is not None:
            self._deliver(waiter, timed_out=True)

    # -- introspection / lifecycle ----------------------------------------
    def live_waiters(self) -> int:
        """The leak gauge: parked waiters right now."""
        with self._lock:
            return len(self._waiters)

    def stats(self) -> dict:
        with self._lock:
            return {
                "live_waiters": len(self._waiters),
                "delivered": self.delivered,
                "timeouts": self.timeouts,
                "dropped_wakeups": self.dropped_wakeups,
            }

    def shutdown(self) -> None:
        """Stop the timeout wheel (server teardown); parked waiters are
        delivered as timed out so no caller is left hanging."""
        with self._lock:
            wheel = self._wheel
            waiters = list(self._waiters.values())
            self._waiters.clear()
            self._by_key.clear()
        if wheel is not None:
            wheel.stop()
        for waiter in waiters:
            self._deliver(waiter, timed_out=True)


class _LineageToken:
    """Weakref-able identity token (bare ``object()`` is not)."""

    __slots__ = ("__weakref__",)


class _Tables:
    """One immutable-once-shared generation of all table + index dicts."""

    __slots__ = ("tables", "indexes", "allocs_by_node", "allocs_by_job",
                 "allocs_by_eval", "evals_by_job", "alloc_log",
                 "alloc_log_base", "lineage")

    def __init__(self) -> None:
        self.tables = {name: {} for name in TABLES}
        self.indexes = {name: 0 for name in TABLES}
        self.allocs_by_node: dict = {}
        self.allocs_by_job: dict = {}
        self.allocs_by_eval: dict = {}
        self.evals_by_job: dict = {}
        # Alloc changelog: append-only [(index, (alloc_id, ...))], index
        # ascending — the feed for the incremental state->device usage
        # mirror (nomad_tpu_torch/models/fleet.py UsageMirror).  Entries with
        # index <= alloc_log_base have been compacted away; a mirror
        # older than that must rebuild.  The list object is intentionally
        # shared across generations (readers filter by their snapshot's
        # allocs index; appends only ever add higher indexes).
        self.alloc_log: list = []
        self.alloc_log_base: int = 0
        # Lineage token: identity preserved across clones and changelog
        # compaction, REPLACED by snapshot restore — a mirror synced under
        # a different lineage must rebuild even if the raft index matches
        # (the world was swapped wholesale).  Weakref-able on purpose:
        # per-lineage caches (scheduler/util._READY_CACHE) key on it with
        # a WeakKeyDictionary so a dead world's entries free themselves.
        self.lineage: object = _LineageToken()

    def clone(self) -> "_Tables":
        new = _Tables.__new__(_Tables)
        new.tables = {k: v for k, v in self.tables.items()}
        new.indexes = dict(self.indexes)
        new.allocs_by_node = self.allocs_by_node
        new.allocs_by_job = self.allocs_by_job
        new.allocs_by_eval = self.allocs_by_eval
        new.evals_by_job = self.evals_by_job
        new.alloc_log = self.alloc_log
        new.alloc_log_base = self.alloc_log_base
        new.lineage = self.lineage
        return new


class _ReadMixin:
    """Shared read API between the live store and snapshots."""

    _t: _Tables

    # -- nodes ------------------------------------------------------------
    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._t.tables["nodes"].get(node_id)

    def nodes(self) -> Iterable[Node]:
        return list(self._t.tables["nodes"].values())

    # -- jobs -------------------------------------------------------------
    def job_by_id(self, job_id: str) -> Optional[Job]:
        return self._t.tables["jobs"].get(job_id)

    def jobs(self) -> Iterable[Job]:
        return list(self._t.tables["jobs"].values())

    def jobs_by_scheduler(self, sched_type: str) -> list:
        return [j for j in self._t.tables["jobs"].values()
                if j.type == sched_type]

    # -- evals ------------------------------------------------------------
    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._t.tables["evals"].get(eval_id)

    def evals(self) -> Iterable[Evaluation]:
        return list(self._t.tables["evals"].values())

    def evals_by_job(self, job_id: str) -> list:
        table = self._t.tables["evals"]
        return [table[i] for i in self._t.evals_by_job.get(job_id, ())]

    # -- allocs -----------------------------------------------------------
    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self._t.tables["allocs"].get(alloc_id)

    def allocs(self) -> Iterable[Allocation]:
        return list(self._t.tables["allocs"].values())

    def allocs_by_node(self, node_id: str) -> list:
        table = self._t.tables["allocs"]
        return [table[i] for i in self._t.allocs_by_node.get(node_id, ())]

    def has_allocs_on_node(self, node_id: str) -> bool:
        """O(1) emptiness probe — the scheduler finish path calls this
        once per placed node to skip proposed-alloc scans on fresh
        nodes."""
        return bool(self._t.allocs_by_node.get(node_id))

    def allocs_node_index(self) -> dict:
        """The raw node_id -> alloc-id-collection index, READ-ONLY.

        Handed to the native bulk finish (native/port_alloc.cpp) so the
        per-node emptiness probe is a C dict lookup instead of a Python
        call per placement.  Safe to borrow for an eval: writers copy
        shared indexes before mutating (copy-on-write, _writable_index)."""
        return self._t.allocs_by_node

    def allocs_by_job(self, job_id: str) -> list:
        table = self._t.tables["allocs"]
        return [table[i] for i in self._t.allocs_by_job.get(job_id, ())]

    def allocs_by_eval(self, eval_id: str) -> list:
        table = self._t.tables["allocs"]
        return [table[i] for i in self._t.allocs_by_eval.get(eval_id, ())]

    # -- indexes ----------------------------------------------------------
    def get_index(self, table: str) -> int:
        return self._t.indexes.get(table, 0)

    def latest_index(self) -> int:
        return max(self._t.indexes.values(), default=0)

    # -- identity ---------------------------------------------------------
    def fingerprint(self, changelog_since: int = 0) -> str:
        """Canonical digest of the full store: every table's objects
        (sorted by id), the per-table raft indexes, and the alloc
        changelog above ``changelog_since``.

        Two stores that evolved through the same committed write
        sequence digest identically; any divergence — a lost committed
        write, a duplicated alloc, a drifted index — differs here.
        The crash-recovery proofs byte-compare a rebooted store
        against a replay of the recorded committed prefix with it
        (``changelog_since`` skips entries a snapshot restore
        legitimately compacted away: a restored store's changelog
        starts empty)."""
        import hashlib

        import msgpack

        t = self._t
        # The changelog list object is shared across generations
        # (append-only, see _Tables.alloc_log); bound it by this
        # view's own allocs index so entries appended AFTER the view
        # was taken never leak into its digest.
        upto = t.indexes.get("allocs", 0)
        payload = {
            "indexes": {name: t.indexes.get(name, 0) for name in TABLES},
            "tables": {
                name: sorted(
                    (obj.to_dict() for obj in t.tables[name].values()),
                    key=lambda d: d.get("id", ""))
                for name in TABLES
            },
            "changelog": [
                (index, sorted(ids))
                for index, ids in t.alloc_log
                if changelog_since < index <= upto
            ],
        }
        return hashlib.sha256(
            msgpack.packb(payload, use_bin_type=True)).hexdigest()


class StateSnapshot(_ReadMixin):
    """A frozen point-in-time view of the store (O(1) to create)."""

    def __init__(self, tables: _Tables) -> None:
        self._t = tables


class StateStore(_ReadMixin):
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._t = _Tables()
        self._gen_shared = False    # generation container shared w/ snapshot
        self._shared: set = set()   # table names shared with a snapshot
        self._idx_shared = set()    # secondary index names shared
        # The watch's index resolver must NOT close a store<->watch
        # reference cycle: the store teardown story is refcount-only
        # (tests/test_gc_untrack.py), so the fan-out holds the store
        # weakly and a dead store resolves to 0 (recheck no-ops).
        import weakref
        store_ref = weakref.ref(self)

        def _index_of(key) -> int:
            store = store_ref()
            return store._watch_index(key) if store is not None else 0
        self.watch = StateWatch(index_of=_index_of)

    def _watch_index(self, key) -> int:
        """Current table index behind a watch key (the fan-out's
        lost-wakeup recheck).  Unkeyed/odd keys report the latest index
        so a recheck can only over-deliver, never under-deliver."""
        kind = key[0] if isinstance(key, tuple) and key else key
        if kind in TABLES:
            return self.get_index(kind)
        table = {"node": "nodes", "job": "jobs", "eval": "evals",
                 "alloc-node": "allocs"}.get(kind)
        if table is not None:
            return self.get_index(table)
        return self.latest_index()

    # -- snapshot / restore ----------------------------------------------
    def snapshot(self) -> StateSnapshot:
        with self._lock:
            self._gen_shared = True
            self._shared = set(TABLES)
            self._idx_shared = {"allocs_by_node", "allocs_by_job",
                                "allocs_by_eval", "evals_by_job"}
            return StateSnapshot(self._t)

    def fingerprint(self, changelog_since: int = 0) -> str:
        # A live store digests a frozen generation: concurrent raft
        # applies (a follower catching up while a soak compares
        # replicas) must not mutate tables mid-iteration or tear the
        # view.
        return self.snapshot().fingerprint(changelog_since)

    def restore(self) -> "StateRestore":
        """Bulk-load rig used by FSM snapshot restore: stage into a fresh
        generation, swap atomically on commit."""
        return StateRestore(self)

    def stats(self) -> dict:
        """Registry provider (obs/registry.py): table sizes, per-table
        indexes, changelog length, and the watch fan-out's gauges —
        the store's share of /v1/agent/metrics."""
        with self._lock:
            t = self._t
            out = {
                "tables": {name: len(table)
                           for name, table in t.tables.items()},
                "indexes": dict(t.indexes),
                "alloc_log": len(t.alloc_log),
            }
        out["watch"] = self.watch.stats()
        return out

    # -- write plumbing ---------------------------------------------------
    def _writable_table(self, name: str) -> dict:
        if self._gen_shared:
            self._t = self._t.clone()
            self._gen_shared = False
        if name in self._shared:
            self._t.tables[name] = dict(self._t.tables[name])
            self._shared.discard(name)
        return self._t.tables[name]

    def _writable_index(self, name: str) -> dict:
        if self._gen_shared:
            self._t = self._t.clone()
            self._gen_shared = False
        if name in self._idx_shared:
            setattr(self._t, name, dict(getattr(self._t, name)))
            self._idx_shared.discard(name)
        return getattr(self._t, name)

    @staticmethod
    def _index_add(idx: dict, key: str, item_id: str) -> None:
        bucket = idx.get(key)
        bucket = set() if bucket is None else set(bucket)
        bucket.add(item_id)
        idx[key] = bucket

    @staticmethod
    def _index_remove(idx: dict, key: str, item_id: str) -> None:
        bucket = idx.get(key)
        if bucket is None:
            return
        bucket = set(bucket)
        bucket.discard(item_id)
        if bucket:
            idx[key] = bucket
        else:
            idx.pop(key, None)

    def _bump(self, table: str, index: int) -> None:
        self._t.indexes[table] = index

    _ALLOC_LOG_MAX = 16384

    def _log_alloc_change(self, index: int, alloc_ids) -> None:
        """Record changed alloc ids for incremental mirror sync.  Called
        under the store lock AFTER _writable_table (generation private)."""
        log = self._t.alloc_log
        log.append((index, tuple(alloc_ids)))
        if len(log) > self._ALLOC_LOG_MAX:
            keep = self._ALLOC_LOG_MAX // 2
            # New list: older generations keep the one they saw.
            self._t.alloc_log_base = log[-keep - 1][0]
            self._t.alloc_log = log[-keep:]

    # -- nodes ------------------------------------------------------------
    def upsert_node(self, index: int, node: Node) -> None:
        with self._lock:
            table = self._writable_table("nodes")
            existing = table.get(node.id)
            new = node.copy()
            if existing is not None:
                new.create_index = existing.create_index
            else:
                new.create_index = index
            new.modify_index = index
            table[new.id] = new
            self._bump("nodes", index)
        self.watch.notify(("nodes",), ("node", node.id), index=index)

    def upsert_node_slab(self, index: int, slab) -> None:
        """Bulk-register a columnar node table (structs/node_slab.py):
        every slab row lands in one lock hold with ONE coalesced watch
        notification, and rows are stored as the slab's lazy SlabNode
        objects WITHOUT the per-node defensive copy — the caller hands
        the slab over and its columns are immutable from then on.  This
        is the 100k-1M-node fleet load path: per-row cost is one small
        lazy object, not ~8 (Resources/NetworkResource/attr dicts).

        Rows replace any existing node with the same id wholesale
        (fresh create_index) — the intended use is initial fleet load
        or whole-generation extension, not the incremental per-node
        upsert contract, which stays on ``upsert_node``."""
        slab.index = index
        with self._lock:
            table = self._writable_table("nodes")
            for r in range(slab.n):
                node = slab.node(r)
                # Rows materialized BEFORE this upsert carry the
                # slab's previous index in their eager dict: stamp
                # every stored row explicitly.  Dict pokes, not
                # attribute writes — a public-field setattr would flag
                # the row mutated and disqualify the fleet fast path.
                d = node.__dict__
                d["create_index"] = index
                d["modify_index"] = index
                table[node.id] = node
            self._bump("nodes", index)
        self.watch.notify(("nodes",), index=index)

    def delete_node(self, index: int, node_id: str) -> None:
        with self._lock:
            table = self._writable_table("nodes")
            if node_id not in table:
                raise KeyError(f"node not found: {node_id}")
            del table[node_id]
            self._bump("nodes", index)
        self.watch.notify(("nodes",), ("node", node_id), index=index)

    def update_node_status(self, index: int, node_id: str,
                           status: str) -> None:
        if not valid_node_status(status):
            raise ValueError(f"invalid node status {status!r}")
        with self._lock:
            table = self._writable_table("nodes")
            existing = table.get(node_id)
            if existing is None:
                raise KeyError(f"node not found: {node_id}")
            new = existing.copy()
            new.status = status
            new.modify_index = index
            table[node_id] = new
            self._bump("nodes", index)
        self.watch.notify(("nodes",), ("node", node_id), index=index)

    def update_node_drain(self, index: int, node_id: str,
                          drain: bool) -> None:
        with self._lock:
            table = self._writable_table("nodes")
            existing = table.get(node_id)
            if existing is None:
                raise KeyError(f"node not found: {node_id}")
            new = existing.copy()
            new.drain = drain
            new.modify_index = index
            table[node_id] = new
            self._bump("nodes", index)
        self.watch.notify(("nodes",), ("node", node_id), index=index)

    # -- jobs -------------------------------------------------------------
    def upsert_job(self, index: int, job: Job) -> None:
        with self._lock:
            table = self._writable_table("jobs")
            existing = table.get(job.id)
            new = job.copy()
            if existing is not None:
                new.create_index = existing.create_index
            else:
                new.create_index = index
            new.modify_index = index
            table[new.id] = new
            self._bump("jobs", index)
        self.watch.notify(("jobs",), ("job", job.id), index=index)

    def delete_job(self, index: int, job_id: str) -> None:
        with self._lock:
            table = self._writable_table("jobs")
            if job_id not in table:
                raise KeyError(f"job not found: {job_id}")
            del table[job_id]
            self._bump("jobs", index)
        self.watch.notify(("jobs",), ("job", job_id), index=index)

    # -- evals ------------------------------------------------------------
    def upsert_evals(self, index: int, evals: list) -> None:
        with self._lock:
            table = self._writable_table("evals")
            by_job = self._writable_index("evals_by_job")
            for ev in evals:
                existing = table.get(ev.id)
                new = ev.copy()
                if existing is not None:
                    new.create_index = existing.create_index
                else:
                    new.create_index = index
                new.modify_index = index
                table[new.id] = new
                self._index_add(by_job, new.job_id, new.id)
            self._bump("evals", index)
        self.watch.notify(("evals",), index=index)

    def delete_eval(self, index: int, eval_ids: list,
                    alloc_ids: list) -> None:
        """Reap evals + allocs in one txn (reference: Eval.Reap)."""
        touched_nodes = []
        with self._lock:
            evals = self._writable_table("evals")
            by_job = self._writable_index("evals_by_job")
            for eid in eval_ids:
                ev = evals.pop(eid, None)
                if ev is not None:
                    self._index_remove(by_job, ev.job_id, eid)
            allocs = self._writable_table("allocs")
            a_node = self._writable_index("allocs_by_node")
            a_job = self._writable_index("allocs_by_job")
            a_eval = self._writable_index("allocs_by_eval")
            removed = []
            for aid in alloc_ids:
                alloc = allocs.pop(aid, None)
                if alloc is not None:
                    self._index_remove(a_node, alloc.node_id, aid)
                    self._index_remove(a_job, alloc.job_id, aid)
                    self._index_remove(a_eval, alloc.eval_id, aid)
                    touched_nodes.append(alloc.node_id)
                    removed.append(aid)
            self._bump("evals", index)
            self._bump("allocs", index)
            if removed:
                self._log_alloc_change(index, removed)
        # sorted(): the dedup set's iteration order is hash-seeded, and
        # the notify key order escapes to watch subscribers — replicas
        # must fan out identically for the same log entry.
        keys = [("evals",), ("allocs",)]
        keys += [("alloc-node", n) for n in sorted(set(touched_nodes))]
        self.watch.notify(*keys, index=index)

    # -- allocs -----------------------------------------------------------
    def upsert_allocs(self, index: int, allocs: list) -> None:
        """Scheduler/plan-authoritative write: preserves client-owned fields
        of any existing alloc (reference: state_store.go:601-637).  One
        item of the batched path — the merge semantics live in exactly
        one place (upsert_allocs_batched)."""
        if not allocs:
            # The batched path skips empty items; a bare index write
            # must still move the table fence — on a PRIVATE generation
            # (_writable_table clones when shared), never in place under
            # a live snapshot.
            with self._lock:
                self._writable_table("allocs")
                self._bump("allocs", index)
            self.watch.notify(("allocs",), index=index)
            return
        self.upsert_allocs_batched([(index, allocs)])

    def upsert_allocs_batched(self, items: list) -> None:
        """Group-commit write: ``items`` is ``[(index, allocs), ...]`` in
        eval order, applied under ONE lock hold with one coalesced watch
        notification — byte-identical final state to calling
        ``upsert_allocs(index, allocs)`` per item in order (same
        create/modify indexes, same changelog entries, same last-writer-
        wins on duplicate alloc ids), minus the per-plan lock/notify
        churn.  The raft path passes one shared entry index per item;
        the harness path passes per-plan indexes so sequential replays
        stay index-exact.

        Columnar contract (structs/alloc_slab.py): slab-backed allocs
        store as lazy SlabAlloc copies — one small dict copy plus the
        scalar stamps below; the heavy fields (task_resources/metrics)
        never materialize on this path, and the secondary indexes bump
        off the eager scalar columns alone."""
        touched_nodes = []
        last_index = 0  # highest index bumped; rides the watch notify
        # Buckets already copied within THIS call: _index_add/_remove
        # copy the shared bucket set on every touch (snapshot safety);
        # across a whole window that is O(bucket x allocs) churn for
        # buckets that are only shared once.  Copy each bucket the
        # first time the window touches it, then mutate the private
        # copy in place.
        fresh: dict = {}  # (id(index dict), key) -> private bucket

        def add(idx: dict, key: str, item_id: str) -> None:
            bucket = fresh.get((id(idx), key))
            if bucket is None:
                base = idx.get(key)
                bucket = set() if base is None else set(base)
                idx[key] = fresh[(id(idx), key)] = bucket
            bucket.add(item_id)

        def remove(idx: dict, key: str, item_id: str) -> None:
            bucket = fresh.get((id(idx), key))
            if bucket is None:
                base = idx.get(key)
                if base is None:
                    return
                bucket = idx[key] = fresh[(id(idx), key)] = set(base)
            bucket.discard(item_id)
            if not bucket:
                idx.pop(key, None)
                fresh.pop((id(idx), key), None)

        with self._lock:
            table = self._writable_table("allocs")
            a_node = self._writable_index("allocs_by_node")
            a_job = self._writable_index("allocs_by_job")
            a_eval = self._writable_index("allocs_by_eval")
            for index, allocs in items:
                if not allocs:
                    continue
                for alloc in allocs:
                    existing = table.get(alloc.id)
                    new = alloc.copy()
                    if existing is not None:
                        new.create_index = existing.create_index
                        new.client_status = existing.client_status
                        new.client_description = \
                            existing.client_description
                        # Skip the task_states carry-over when BOTH
                        # sides are canonically empty slab rows: the
                        # getter would materialize an empty dict and
                        # the setter would flag the row off the
                        # columnar wire encoding for no semantic
                        # difference (a shared {} vs a lazy {}).
                        if existing.__dict__.get("task_states") \
                                is not None or \
                                "_slab" not in existing.__dict__:
                            new.task_states = existing.task_states
                        remove(a_node, existing.node_id, alloc.id)
                    else:
                        new.create_index = index
                    new.modify_index = index
                    table[new.id] = new
                    add(a_node, new.node_id, new.id)
                    add(a_job, new.job_id, new.id)
                    if new.eval_id:
                        add(a_eval, new.eval_id, new.id)
                    touched_nodes.append(new.node_id)
                self._bump("allocs", index)
                self._log_alloc_change(index, [a.id for a in allocs])
                last_index = index
        # sorted(): same determinism contract as delete_eval — notify
        # fan-out order must not depend on the process hash seed.
        keys = [("allocs",)] + [("alloc-node", n)
                                for n in sorted(set(touched_nodes))]
        self.watch.notify(*keys, index=last_index)

    def update_alloc_from_client(self, index: int,
                                 alloc: Allocation) -> None:
        """Client-authoritative merge: only client status fields move
        (reference: state_store.go:556-597)."""
        with self._lock:
            table = self._writable_table("allocs")
            existing = table.get(alloc.id)
            if existing is None:
                raise KeyError(f"alloc not found: {alloc.id}")
            new = existing.copy()
            new.client_status = alloc.client_status
            new.client_description = alloc.client_description
            new.task_states = dict(alloc.task_states)
            new.modify_index = index
            table[new.id] = new
            self._bump("allocs", index)
            self._log_alloc_change(index, (alloc.id,))
        self.watch.notify(("allocs",), ("alloc-node", alloc.node_id),
                          index=index)


class StateRestore:
    """Accumulates objects into a fresh generation, swapped in atomically.

    Parity role: state_store.go StateRestore / fsm.go Restore — snapshot
    restore rebuilds the whole store in one transaction.
    """

    def __init__(self, store: StateStore) -> None:
        self._store = store
        self._t = _Tables()

    def node_restore(self, node: Node) -> None:
        self._t.tables["nodes"][node.id] = node
        self._t.indexes["nodes"] = max(self._t.indexes["nodes"],
                                       node.modify_index)

    def job_restore(self, job: Job) -> None:
        self._t.tables["jobs"][job.id] = job
        self._t.indexes["jobs"] = max(self._t.indexes["jobs"],
                                      job.modify_index)

    def eval_restore(self, ev: Evaluation) -> None:
        self._t.tables["evals"][ev.id] = ev
        self._t.indexes["evals"] = max(self._t.indexes["evals"],
                                       ev.modify_index)
        StateStore._index_add(self._t.evals_by_job, ev.job_id, ev.id)

    def alloc_restore(self, alloc: Allocation) -> None:
        self._t.tables["allocs"][alloc.id] = alloc
        self._t.indexes["allocs"] = max(self._t.indexes["allocs"],
                                        alloc.modify_index)
        StateStore._index_add(self._t.allocs_by_node, alloc.node_id, alloc.id)
        StateStore._index_add(self._t.allocs_by_job, alloc.job_id, alloc.id)
        if alloc.eval_id:
            StateStore._index_add(self._t.allocs_by_eval, alloc.eval_id,
                                  alloc.id)

    def index_restore(self, table: str, index: int) -> None:
        self._t.indexes[table] = index

    def commit(self) -> None:
        # A restored generation carries a fresh lineage token (set in
        # _Tables.__init__), forcing every existing mirror to rebuild once
        # — even one whose raft-index fence matches the restored index.
        with self._store._lock:
            self._store._t = self._t
            self._store._gen_shared = False
            self._store._shared = set()
            self._store._idx_shared = set()
        self._store.watch.notify_all()
