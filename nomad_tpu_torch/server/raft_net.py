"""Networked raft: leader election + replicated log over the RPC plane.

Capability parity role: the reference replicates state with hashicorp/raft
sharing the server's RPC port (reference nomad/raft_rpc.go, RaftLayer;
nomad/server.go:397-500).  Here the three raft RPCs (RequestVote,
AppendEntries, InstallSnapshot) ride the same msgpack-RPC listener as the
nomad endpoints — same single-port design, Python implementation of the
standard algorithm:

  - randomized election timeouts; terms; majority voting;
  - one long-lived replication thread per peer (no per-tick thread churn,
    single writer for that peer's next_index/match_index);
  - commit advance only for current-term entries with majority match;
  - snapshot installation for far-behind followers;
  - optional durability: term/vote metadata + appended log entries under
    ``data_dir`` are reloaded on boot (raft safety across restarts).

Leadership changes surface through ``notify`` callbacks delivered IN ORDER
by a single notifier thread — the Server's establish/revoke must observe
gains and losses in the sequence they happened (reference
nomad/leader.go:16-50 monitorLeadership).

Counterpart of ``nomad_tpu/server/raft_net.py``: the same algorithm, RPC
method names and msgpack shapes, so a port ``NetRaft`` and a JAX one
vote for and replicate to each other, and the same ``data_dir`` layout.
Every exchange with a peer treats a failed call as a failed exchange:
a peer whose listener is bound but not yet serving (the port's server
starts its listener last) times out, and the port's ``ConnPool`` raises
``ConnectionError`` once shut down, which ends a replicator's or a vote
ask's exchange as quietly as a dead peer does.  A follower's election
timer restarts when an AppendEntries or InstallSnapshot exchange ends,
not only when it begins (the JAX follower restarts it on receipt only),
so a catch-up batch that takes longer than the timeout to persist and
apply does not end in an election of its own.
"""
from __future__ import annotations

import logging
import os
import queue
import random
import threading
import time
from typing import Callable, Optional

import msgpack

from nomad_tpu_torch import faultinject
from nomad_tpu_torch.structs import codec
from nomad_tpu_torch.utils.sync import Immutable

from .raft import (
    ApplyFuture,
    CommittedDataLoss,
    FileLogStore,
    MetaStore,
    SnapshotStore,
    resolve_snapshot_dir,
    unwrap_snapshot,
)

logger = logging.getLogger("nomad_tpu_torch.server.raft_net")

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

# Leader no-op: an ignorable-typed entry the FSM skips (committed at the
# start of each term so commit_index can advance, and used by barrier()).
NOOP_ENTRY = codec.encode(codec.IGNORE_UNKNOWN_TYPE_FLAG | 127, {})

# One AppendEntries carries at most this many entries (the reference's
# MaxAppendEntries) and, past its first entry, at most this many bytes
# of entry data: a follower far behind catches up in exchanges that
# each finish well inside the call's timeout, instead of one exchange
# that times out and is sent again whole.
MAX_APPEND_ENTRIES = 64
MAX_APPEND_BYTES = 4 * 1024 * 1024


class _PeerReplicator:
    """One long-lived thread replicating the leader's log to one peer.

    A reachable peer is driven at the heartbeat interval; a dead one is
    backed off (jittered exponential, capped well under the failover
    TTL) so a partitioned follower doesn't cost the leader a hot
    dial-fail loop per heartbeat tick.  Any successful exchange — or a
    fresh ``wake`` from an apply — snaps the cadence back."""

    def __init__(self, raft: "NetRaft", peer: tuple) -> None:
        self.raft = raft
        self.peer = peer
        self.wake = threading.Event()
        self.stop = threading.Event()
        self.thread = threading.Thread(
            target=self.run, daemon=True,
            name=f"raft-repl-{peer[0]}:{peer[1]}")
        self.thread.start()

    def join(self, timeout: "float | None" = None) -> None:
        self.thread.join(timeout)

    def run(self) -> None:
        from nomad_tpu_torch.utils.retry import Backoff

        # Capped at half the shortest election timeout: a peer that
        # comes back (a rebooted server) hears from this leader before
        # its own election timer can run out.
        backoff = Backoff(base=self.raft.heartbeat_interval,
                          max_delay=min(2.0, self.raft.election_timeout[0]
                                        / 2),
                          jitter=0.5)
        wait = self.raft.heartbeat_interval
        while not self.stop.is_set():
            self.wake.wait(wait)
            self.wake.clear()
            if self.stop.is_set():
                return
            if not self.raft.is_leader():
                backoff.reset()
                wait = self.raft.heartbeat_interval
                continue
            ok = False
            try:
                ok = self.raft._append_to_peer(self.peer)
            except Exception:
                logger.debug("replication to %s failed", self.peer,
                             exc_info=True)
            if ok:
                backoff.reset()
                wait = self.raft.heartbeat_interval
            else:
                wait = backoff.next()


class NetRaft:
    def __init__(self, fsm, rpc_server, conn_pool,
                 peers: Optional[list] = None,
                 election_timeout: tuple = (0.15, 0.30),
                 heartbeat_interval: float = 0.05,
                 snapshot_threshold: int = 8192,
                 data_dir: Optional[str] = None,
                 defer_elections: bool = False,
                 start: bool = True) -> None:
        self.fsm = fsm
        self.rpc = rpc_server
        self.pool = conn_pool
        self.address: Immutable = tuple(rpc_server.address)
        self.election_timeout: Immutable = election_timeout
        self.heartbeat_interval = heartbeat_interval
        self.snapshot_threshold = snapshot_threshold

        self._lock = threading.RLock()
        self._state = FOLLOWER
        self._term = 0
        self._voted_for: Optional[tuple] = None
        self._leader: Optional[tuple] = None
        # Log: list of dicts {term, index, data}; 1-indexed via offset.
        self._log: list = []
        self._log_base_index = 0   # index of entry before self._log[0]
        self._log_base_term = 0
        self._commit_index = 0
        self._last_applied = 0
        self._peers: list = []
        self._replicators: dict = {}   # peer -> _PeerReplicator
        self._match_index: dict = {}
        self._next_index: dict = {}
        self._futures: dict = {}   # log index -> ApplyFuture
        self._stop = threading.Event()
        self._election_deadline = 0.0
        self._elections_enabled = not defer_elections
        self._snap_blob: Optional[bytes] = None
        self._snap_index = 0
        self._snap_term = 0

        # Durability (term/vote + snapshots + log), reloaded on boot.
        # All three handles are bound during construction and never
        # rebound; shutdown only calls the log store's idempotent close.
        self._meta: Immutable = None
        self._log_store: Immutable = None
        self._snap_store: Immutable = None
        if data_dir:
            os.makedirs(f"{data_dir}/raft", exist_ok=True)
            self._meta = MetaStore(f"{data_dir}/raft/meta.json")
            self._load_meta()
            self._snap_store = SnapshotStore(resolve_snapshot_dir(data_dir))
            latest = self._snap_store.latest()
            if latest is not None:
                # Snapshot files wrap (term, fsm_blob) so the log base term
                # survives restarts (reference FileSnapshotStore metadata);
                # unwrap tolerates legacy bare blobs.
                snap_index, wrapped = latest
                snap_term, blob = unwrap_snapshot(wrapped)
                self.fsm.restore(bytes(blob))
                self._snap_blob = bytes(blob)
                self._snap_index = snap_index
                self._snap_term = snap_term
                self._log_base_index = snap_index
                self._log_base_term = snap_term
                self._commit_index = snap_index
                self._last_applied = snap_index
            self._log_store = FileLogStore(f"{data_dir}/raft/log.bin")
            for index, record in self._log_store.replay():
                term, data = record["t"], record["d"]
                if index <= self._log_base_index:
                    continue
                if index <= self._last_index():
                    # A re-appended record at an already-seen index marks a
                    # conflict truncation (_handle_append_entries rewrites
                    # from here): drop the stale suffix, last writer wins.
                    cut = index - self._log_base_index - 1
                    self._log = self._log[:cut]
                if index > self._last_index() + 1:
                    raise CommittedDataLoss(
                        f"raft log for {data_dir}: committed entries "
                        f"{self._last_index() + 1}..{index - 1} are "
                        "missing between the snapshot restore point "
                        "and the compacted log; refusing to boot")
                if index == self._last_index() + 1:
                    self._log.append({"term": term, "index": index,
                                      "data": data})

        # Deferral applies to FIRST boots only: a node that restored
        # persisted raft state belongs to an already-bootstrapped cluster
        # and must be able to elect with whatever quorum survives a
        # restart (reference maybeBootstrap: skip when LastIndex != 0).
        if not self._elections_enabled and (
                self._term > 0 or self._last_index() > 0):
            self._elections_enabled = True

        # Last election's voter-ask threads (see _start_election):
        # replaced wholesale per election, reaped by shutdown.
        self._election_askers: list = []
        # Ordered leadership notifications.
        self._notify: list = []
        self._notify_queue: queue.Queue = queue.Queue()
        self._notifier = threading.Thread(target=self._notify_loop,
                                          daemon=True, name="raft-notify")
        self._notifier.start()

        for p in peers or []:
            self.add_peer(p)

        rpc_server.register("Raft.RequestVote", self._handle_request_vote)
        rpc_server.register("Raft.AppendEntries",
                            self._handle_append_entries)
        rpc_server.register("Raft.InstallSnapshot",
                            self._handle_install_snapshot)

        self._ticker = threading.Thread(target=self._run, daemon=True,
                                        name="raft-ticker")
        if start:
            self.start()

    def start(self) -> None:
        """Arm the election timer and start the ticker.  A server whose
        listener starts after its raft (``start=False``) calls it once
        the listener serves, so this node cannot campaign before its
        peers can reach it."""
        with self._lock:
            self._reset_election_timer()
        self._ticker.start()

    # -- persistence -------------------------------------------------------
    def _load_meta(self) -> None:
        meta = self._meta.load()
        if meta is not None:
            self._term = meta.get("term", 0)
            voted = meta.get("voted_for")
            self._voted_for = tuple(voted) if voted else None

    def _save_meta(self) -> None:
        if self._meta is None:
            return
        self._meta.save({"term": self._term,
                         "voted_for": list(self._voted_for)
                         if self._voted_for else None})

    def _persist_entry(self, entry: dict) -> None:
        """Durable append.  Raft discipline: callers persist BEFORE the
        in-memory log moves, so a failed (or crashed) write leaves
        memory and disk agreeing and the in-memory log can never run
        ahead of what a reboot would replay."""
        if self._log_store is not None:
            self._log_store.append(entry["index"],
                                   {"t": entry["term"], "d": entry["data"]})

    # -- public API (matches InmemRaft) -----------------------------------
    def applied_index(self) -> int:
        with self._lock:
            return self._last_applied

    def is_leader(self) -> bool:
        with self._lock:
            return self._state == LEADER

    def leader_address(self) -> Optional[tuple]:
        with self._lock:
            return self._leader

    def peer_addresses(self) -> list:
        with self._lock:
            return [self.address] + list(self._peers)

    def add_peer(self, address: tuple) -> None:
        address = tuple(address)
        with self._lock:
            if address == self.address or address in self._peers:
                return
            self._peers.append(address)
            self._next_index[address] = self._last_index() + 1
            self._match_index[address] = 0
            self._replicators[address] = _PeerReplicator(self, address)

    def remove_peer(self, address: tuple) -> None:
        address = tuple(address)
        with self._lock:
            if address in self._peers:
                self._peers.remove(address)
                self._next_index.pop(address, None)
                self._match_index.pop(address, None)
                repl = self._replicators.pop(address, None)
            else:
                repl = None
        if repl is not None:
            repl.stop.set()
            repl.wake.set()
            # A removed peer's replicator must actually die (it holds a
            # conn-pool reference and wakes on every apply otherwise);
            # bounded join — a mid-flight RPC times out at 1s.
            repl.join(3.0)

    def notify_leadership(self, cb: Callable[[bool], None]) -> None:
        self._notify.append(cb)

    def shutdown(self) -> None:
        self._stop.set()
        with self._lock:
            replicators = list(self._replicators.values())
            # A waiter on an entry that will never commit here (a
            # leadership barrier on the notifier thread) returns now,
            # so the notifier's join below is not cut by its timeout.
            for future in self._futures.values():
                future.respond(0, None, RuntimeError("raft shut down"))
            self._futures.clear()
        for repl in replicators:
            repl.stop.set()
            repl.wake.set()
        self._notify_queue.put(None)
        # Reap every thread this instance started: ticker, per-peer
        # replicators, then the notifier (which exits on the sentinel).
        # All joins are bounded — the longest in-flight work is a 1s
        # peer RPC (analyzer: thread-leak).
        if self._ticker.ident is not None:
            self._ticker.join(2.0)
        for repl in replicators:
            repl.join(3.0)
        self._notifier.join(2.0)
        for t in self._election_askers:
            t.join(2.0)
        if self._log_store is not None:
            self._log_store.close()

    def apply(self, entry: bytes) -> ApplyFuture:
        if faultinject.ACTIVE:
            faultinject.fire("raft.apply")
        future = ApplyFuture()
        with self._lock:
            if self._state != LEADER:
                future.respond(0, None,
                               RuntimeError("node is not the leader"))
                return future
            index = self._last_index() + 1
            record = {"term": self._term, "index": index, "data": entry}
            try:
                self._persist_entry(record)
            except Exception as e:
                # Disk death/crash: reject with NO state moved — the
                # in-memory log must never run ahead of the durable one.
                future.respond(0, None, e)
                return future
            self._log.append(record)
            self._futures[index] = future
            if not self._peers:
                self._advance_commit()
        self._signal_replicators()
        return future

    def barrier(self) -> int:
        f = self.apply(NOOP_ENTRY)
        index, _ = f.wait(5.0)
        return index

    # -- internals ---------------------------------------------------------
    def _signal_replicators(self) -> None:
        with self._lock:
            replicators = list(self._replicators.values())
        for repl in replicators:
            repl.wake.set()

    def _notify_loop(self) -> None:
        while True:
            item = self._notify_queue.get()
            if item is None:
                return
            for cb in self._notify:
                try:
                    cb(item)
                except Exception:
                    logger.exception("leadership notify callback failed")

    def _last_index(self) -> int:
        return self._log[-1]["index"] if self._log else self._log_base_index

    def _last_term(self) -> int:
        return self._log[-1]["term"] if self._log else self._log_base_term

    def _entry_at(self, index: int) -> Optional[dict]:
        i = index - self._log_base_index - 1
        if 0 <= i < len(self._log):
            return self._log[i]
        return None

    def _term_at(self, index: int) -> Optional[int]:
        if index == self._log_base_index:
            return self._log_base_term
        e = self._entry_at(index)
        return e["term"] if e else None

    def enable_elections(self) -> None:
        """Arm the election timer of a deferred (bootstrap-expect) node.

        Until called, the node is passive: it votes and accepts appends
        (so it can be absorbed into an already-formed cluster) but never
        becomes a candidate — the gossip layer calls this once the
        expected server count is visible, so no server can elect itself
        leader of a one-node cluster and commit entries that a later
        join would silently discard (reference bootstrap-expect,
        command/agent/command.go + nomad/serf.go maybeBootstrap)."""
        with self._lock:
            if not self._elections_enabled:
                self._elections_enabled = True
                self._reset_election_timer()

    def elections_enabled(self) -> bool:
        with self._lock:
            return self._elections_enabled

    def _reset_election_timer(self) -> None:
        if not self._elections_enabled:
            self._election_deadline = float("inf")
            return
        lo, hi = self.election_timeout
        self._election_deadline = time.monotonic() + random.uniform(lo, hi)

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                state = self._state
                deadline = self._election_deadline
            if state != LEADER and time.monotonic() >= deadline:
                try:
                    self._start_election()
                except Exception:
                    # A node whose disk died (or crashed) cannot bump
                    # its term durably and must not become a candidate;
                    # the ticker survives to keep trying/heartbeating.
                    logger.exception("election attempt failed")
            time.sleep(0.01)

    # -- elections ---------------------------------------------------------
    def _start_election(self) -> None:
        with self._lock:
            # Candidacy requires a DURABLE term bump + self-vote before
            # anything moves: an unpersisted term would leak through
            # reply terms (deposing healthy leaders from a node that
            # can't even vote durably) and a reboot would reopen the
            # double-vote window.  On persist failure roll back, re-arm
            # the timer (so the ticker retries at election cadence, not
            # every tick), and stay a follower.
            prev = (self._term, self._voted_for, self._state)
            self._state = CANDIDATE
            self._term += 1
            self._voted_for = self.address
            try:
                self._save_meta()
            except Exception:
                self._term, self._voted_for, self._state = prev
                self._reset_election_timer()
                raise
            term = self._term
            self._leader = None
            self._reset_election_timer()
            peers = list(self._peers)
            last_index, last_term = self._last_index(), self._last_term()

        votes = [1]  # self
        needed = (len(peers) + 1) // 2 + 1
        done = threading.Event()

        def ask(peer) -> None:
            try:
                resp = self.pool.call(peer, "Raft.RequestVote", {
                    "term": term, "candidate": list(self.address),
                    "last_log_index": last_index,
                    "last_log_term": last_term,
                }, timeout=1.0)
            except Exception:
                return
            with self._lock:
                if resp["term"] > self._term:
                    self._step_down(resp["term"])
                    done.set()
                    return
                if resp.get("granted") and self._state == CANDIDATE and \
                        self._term == term:
                    votes[0] += 1
                    if votes[0] >= needed:
                        self._become_leader()
                        done.set()

        if not peers:
            with self._lock:
                if self._state == CANDIDATE and self._term == term:
                    self._become_leader()
            return
        askers = []
        for peer in peers:
            t = threading.Thread(target=ask, args=(peer,), daemon=True,
                                 name="raft-vote-ask")
            t.start()
            askers.append(t)
        # One voter ask per peer, bounded by the 1s RPC timeout; the
        # handles are retained so shutdown reaps the last election's
        # askers instead of abandoning them (analyzer: thread-leak).
        self._election_askers = askers
        done.wait(self.election_timeout[0])

    def _become_leader(self) -> None:
        # Caller holds the lock.
        logger.info("raft: %s becoming leader for term %d",
                    self.address, self._term)
        self._state = LEADER
        self._leader = self.address
        nxt = self._last_index() + 1
        for p in self._peers:
            self._next_index[p] = nxt
            self._match_index[p] = 0
        self._notify_queue.put(True)
        # Commit a no-op so the new leader can advance commit_index
        # (current-term entry requirement).
        record = {"term": self._term, "index": nxt, "data": NOOP_ENTRY}
        try:
            self._persist_entry(record)
        except Exception:
            # A leader whose disk just died cannot commit anything; it
            # keeps heartbeating (empty appends) until killed/replaced.
            logger.exception("no-op persist failed at leadership gain")
            return
        self._log.append(record)
        if not self._peers:
            self._advance_commit()
        self._signal_replicators()

    def _step_down(self, term: int) -> None:
        # Caller holds the lock.  voted_for only resets when the term
        # moves forward — clearing it within the same term would allow a
        # second vote in that term (split brain).
        was_leader = self._state == LEADER
        self._state = FOLLOWER
        if term > self._term:
            self._term = term
            self._voted_for = None
            try:
                self._save_meta()
            except Exception:
                # Memory moves anyway: refusing the observed higher
                # term would keep deposing the new leader with stale
                # replies.  Vote safety survives the durable lag
                # because every GRANT persists (term, vote) and
                # refuses when it can't (_handle_request_vote).
                logger.exception("meta persist failed on step-down")
        self._reset_election_timer()
        if was_leader:
            self._notify_queue.put(False)
            for future in self._futures.values():
                future.respond(0, None, RuntimeError("leadership lost"))
            self._futures.clear()

    # -- replication (called from one _PeerReplicator thread per peer) -----
    def _append_to_peer(self, peer: tuple) -> bool:
        """One replication exchange.  Returns False only when the peer
        could not be reached (its replicator backs off); bookkeeping
        outcomes — stepped down, stale term, rejected append — still
        count as contact."""
        with self._lock:
            if self._state != LEADER:
                return True
            term = self._term
            next_idx = self._next_index.get(peer, self._last_index() + 1)
            if next_idx <= self._log_base_index:
                # Peer is behind our snapshot horizon: install it.
                blob = self._snap_blob
                snap_index, snap_term = self._snap_index, self._snap_term
                if blob is None:
                    blob = self.fsm.snapshot()
                    snap_index = self._last_applied
                    snap_term = self._term_at(snap_index) or self._term
                args = {"term": term, "leader": list(self.address),
                        "last_included_index": snap_index,
                        "last_included_term": snap_term, "data": blob}
                install = True
            else:
                prev_index = next_idx - 1
                prev_term = self._term_at(prev_index)
                if prev_term is None:
                    return True
                entries = []
                size = 0
                for e in self._log[max(0, next_idx
                                       - self._log_base_index - 1):]:
                    size += len(e["data"])
                    if entries and (len(entries) >= MAX_APPEND_ENTRIES or
                                    size > MAX_APPEND_BYTES):
                        break
                    entries.append(e)
                args = {"term": term, "leader": list(self.address),
                        "prev_log_index": prev_index,
                        "prev_log_term": prev_term,
                        "entries": entries,
                        "leader_commit": self._commit_index}
                install = False

        try:
            method = "Raft.InstallSnapshot" if install else \
                "Raft.AppendEntries"
            resp = self.pool.call(peer, method, args, timeout=1.0)
        except Exception:
            return False

        with self._lock:
            if resp["term"] > self._term:
                self._step_down(resp["term"])
                return True
            if self._state != LEADER or self._term != term:
                return True
            if install:
                self._next_index[peer] = args["last_included_index"] + 1
                self._match_index[peer] = args["last_included_index"]
                return True
            if resp.get("success"):
                if args["entries"]:
                    last = args["entries"][-1]["index"]
                    self._next_index[peer] = last + 1
                    self._match_index[peer] = last
                self._advance_commit()
            else:
                hint = resp.get("conflict_index")
                self._next_index[peer] = max(
                    1, hint if hint else self._next_index.get(peer, 2) - 1)
        return True

    def _advance_commit(self) -> None:
        # Caller holds the lock.
        for index in range(self._last_index(), self._commit_index, -1):
            entry = self._entry_at(index)
            if entry is None or entry["term"] != self._term:
                continue
            votes = 1 + sum(1 for p in self._peers
                            if self._match_index.get(p, 0) >= index)
            if votes >= (len(self._peers) + 1) // 2 + 1:
                self._commit_index = index
                break
        self._apply_committed()

    def _apply_committed(self) -> None:
        # Caller holds the lock.
        while self._last_applied < self._commit_index:
            index = self._last_applied + 1
            entry = self._entry_at(index)
            if entry is None:
                break
            error = response = None
            try:
                response = self.fsm.apply(index, bytes(entry["data"]))
            except Exception as e:
                error = e
            self._last_applied = index
            future = self._futures.pop(index, None)
            if future is not None:
                future.respond(index, response, error)
        try:
            self._maybe_compact()
        except Exception:
            # Compaction failure (disk death, injected crash) must not
            # fail entries that already committed; the durable log
            # keeps everything a snapshot would have covered.
            logger.exception("raft log compaction failed")

    def _maybe_compact(self) -> None:
        if self._last_applied - self._log_base_index < \
                self.snapshot_threshold:
            return
        blob = self.fsm.snapshot()
        self._snap_blob = blob
        self._snap_index = self._last_applied
        self._snap_term = self._term_at(self._last_applied) or self._term
        # Persist the snapshot BEFORE truncating the durable log: a crash
        # between the two leaves either (old log, maybe-new snapshot) or
        # (new snapshot, truncated log) — both restorable.
        if self._snap_store is not None:
            self._snap_store.save(
                self._snap_index,
                msgpack.packb((self._snap_term, blob), use_bin_type=True))
        keep = [e for e in self._log if e["index"] > self._last_applied]
        self._log_base_term = self._snap_term
        self._log_base_index = self._snap_index
        self._log = keep
        if self._log_store is not None:
            # Atomic tmp+rename rewrite: a crash mid-compaction must not
            # lose entries above the snapshot that this node already
            # persisted (and may have counted toward commitment quorum).
            self._log_store.rewrite(
                (e["index"], {"t": e["term"], "d": e["data"]})
                for e in self._log)

    # -- RPC handlers ------------------------------------------------------
    def _handle_request_vote(self, args: dict) -> dict:
        with self._lock:
            term = args["term"]
            if term < self._term:
                return {"term": self._term, "granted": False}
            if term > self._term:
                self._step_down(term)
            candidate = tuple(args["candidate"])
            up_to_date = (
                args["last_log_term"] > self._last_term() or
                (args["last_log_term"] == self._last_term() and
                 args["last_log_index"] >= self._last_index()))
            if up_to_date and self._voted_for in (None, candidate):
                prev_vote = self._voted_for
                self._voted_for = candidate
                try:
                    self._save_meta()
                except Exception:
                    # A vote that isn't durable must not be granted: a
                    # reboot would forget it and could vote for a
                    # different candidate in the same term (two
                    # leaders).  Roll back and refuse.
                    self._voted_for = prev_vote
                    logger.exception("vote persist failed; refusing")
                    return {"term": self._term, "granted": False}
                self._reset_election_timer()
                return {"term": self._term, "granted": True}
            return {"term": self._term, "granted": False}

    def _handle_append_entries(self, args: dict) -> dict:
        with self._lock:
            term = args["term"]
            if term < self._term:
                return {"term": self._term, "success": False}
            if term > self._term or self._state != FOLLOWER:
                self._step_down(term)
            self._term = term
            self._leader = tuple(args["leader"])
            self._reset_election_timer()

            prev_index = args["prev_log_index"]
            prev_term = args["prev_log_term"]
            local_term = self._term_at(prev_index)
            if local_term is None:
                return {"term": self._term, "success": False,
                        "conflict_index": self._last_index() + 1}
            if local_term != prev_term:
                return {"term": self._term, "success": False,
                        "conflict_index": max(1, prev_index)}

            # Append/overwrite entries.
            for e in args.get("entries") or []:
                existing = self._entry_at(e["index"])
                if existing is not None and existing["term"] != e["term"]:
                    # Conflict: truncate from here.
                    cut = e["index"] - self._log_base_index - 1
                    self._log = self._log[:cut]
                    existing = None
                if existing is None and e["index"] == \
                        self._last_index() + 1:
                    record = dict(e)
                    try:
                        self._persist_entry(record)
                    except Exception:
                        # A follower whose disk died must not ack
                        # entries it cannot make durable (its match
                        # index would count toward commitment).
                        logger.exception(
                            "follower persist failed at index %d",
                            e["index"])
                        return {"term": self._term, "success": False}
                    self._log.append(record)

            leader_commit = args.get("leader_commit", 0)
            if leader_commit > self._commit_index:
                self._commit_index = min(leader_commit, self._last_index())
                self._apply_committed()
            # Contact counts from the end of the exchange, as the
            # reference's follower sets its last contact after storing
            # the entries: persisting and applying a long catch-up batch
            # must not run this follower's own election timer out.
            self._reset_election_timer()
            return {"term": self._term, "success": True}

    def _handle_install_snapshot(self, args: dict) -> dict:
        with self._lock:
            term = args["term"]
            if term < self._term:
                return {"term": self._term}
            self._step_down(term)
            self._term = term
            self._leader = tuple(args["leader"])
            self._reset_election_timer()
            index = args["last_included_index"]
            if index <= self._last_applied:
                return {"term": self._term}
            data = bytes(args["data"])
            # Persist BEFORE any memory moves (the same discipline as
            # every other persist site here): a follower that cannot
            # make the installed snapshot durable must refuse it
            # wholesale — advancing fsm/commit state it would not
            # replay after a reboot is the one unrecoverable shape.
            if self._snap_store is not None:
                try:
                    self._snap_store.save(
                        index,
                        msgpack.packb((args["last_included_term"], data),
                                      use_bin_type=True))
                except Exception:
                    logger.exception(
                        "snapshot install persist failed at index %d; "
                        "refusing the install (leader retries)", index)
                    return {"term": self._term}
            self.fsm.restore(data)
            self._log = []
            self._log_base_index = index
            self._log_base_term = args["last_included_term"]
            self._commit_index = index
            self._last_applied = index
            if self._log_store is not None:
                try:
                    self._log_store.truncate()
                except Exception:
                    # Contained: the snapshot IS durable and boot
                    # replay skips the stale pre-snapshot entries.
                    logger.exception(
                        "log truncate after snapshot install failed")
            self._snap_blob = data
            self._snap_index = index
            self._snap_term = args["last_included_term"]
            self._reset_election_timer()  # contact ends with the restore
            return {"term": self._term}
