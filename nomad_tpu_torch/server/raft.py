"""Replicated log backends.

The server core talks to raft through a tiny seam (``apply(entry) ->
ApplyFuture``) mirroring how the reference submits type-prefixed log entries
(reference nomad/rpc.go:230-256 raftApply).  Two backends:

  - ``InmemRaft``: single-node, applies synchronously — the dev-mode /
    single-server path, optionally durable via FileLogStore + snapshots
    (BoltDB + FileSnapshotStore parity, reference nomad/server.go:397-500).
  - ``NetRaft`` (``nomad_tpu/server/raft_net.py`` in the JAX package):
    leader election + log replication over TCP for multi-server
    clusters.  Not ported yet; the on-disk formats here are the ones it
    shares.

Counterpart of ``nomad_tpu/server/raft.py``.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import zlib
from typing import Optional

import msgpack

from nomad_tpu_torch import faultinject
from nomad_tpu_torch.utils.sync import Immutable

logger = logging.getLogger("nomad_tpu_torch.server.raft")

# On-disk format magics.  Files that do not start with one are legacy
# (pre-checksum) artifacts: logs are upgraded in place on open,
# snapshots are trusted as bare blobs (see SnapshotStore).
LOG_MAGIC = b"NTPLOG2\n"
SNAP_MAGIC = b"NTPSNP2\n"
_RECORD_HEAD = 8  # 4-byte big-endian length + 4-byte CRC32


class StorageDead(OSError):
    """The store took a (simulated) power loss or an unrecoverable
    write failure: no further bytes may reach its file.  The crash
    model depends on this — after the first torn write, the data_dir
    must stay byte-exact until a CrashHarness reboot."""


class CommittedDataLoss(RuntimeError):
    """Boot replay found a forward GAP in the durable history: the
    entry after the restore point is missing (typically the newest
    snapshot failed its checksum, fell back to an older one, and the
    log was already compacted past the fallback).  Booting anyway
    would silently drop committed writes — refuse instead; the
    data_dir needs a peer copy or a backup."""


def _fsync_dir(path: str) -> None:
    """Make a rename durable: POSIX requires fsyncing the containing
    directory, or a crash can lose the rename itself.  Best-effort —
    some filesystems refuse directory fds."""
    try:
        fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class ApplyFuture:
    """Resolved when the log entry is committed and applied."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self.index: int = 0
        self.response = None
        self.error: Optional[Exception] = None

    def respond(self, index: int, response=None,
                error: Optional[Exception] = None) -> None:
        self.index = index
        self.response = response
        self.error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("timed out waiting for raft apply")
        if self.error is not None:
            raise self.error
        return self.index, self.response


class FileLogStore:
    """Append-only durable log: CRC32-framed msgpack records.

    Parity role: raft-boltdb log store (server.go:27,429-465) — survives
    restarts; replayed into the FSM on boot.

    File layout: an 8-byte ``LOG_MAGIC`` header, then records of
    ``[4-byte length][4-byte CRC32(record)][record]`` where record is
    msgpack ``(index, entry)``.  Torn-write safety:

    - construction tail-scans the file and TRUNCATES at the first
      partial/corrupt record, so a crash mid-append leaves a
      recoverable prefix and later appends can never land after
      garbage;
    - a failed append re-stats and truncates back to the last
      known-good offset before further appends are allowed (a failed
      fsync may still have landed any prefix of the record);
    - legacy (pre-CRC) files are upgraded in place via an atomic
      rewrite on open;
    - the ``log.append``/``log.fsync`` crash points simulate power
      loss: a seeded torn or bit-rotted prefix of the in-flight record
      lands and the store refuses everything afterwards.
    """

    def __init__(self, path: str) -> None:
        self.path: Immutable = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._dead = False
        self._good_offset = self._scan_and_recover()
        self._fh = open(path, "ab")

    @staticmethod
    def _frame(record: bytes) -> bytes:
        return (len(record).to_bytes(4, "big")
                + zlib.crc32(record).to_bytes(4, "big") + record)

    def _scan_and_recover(self) -> int:
        """Boot tail-scan: walk the records, find the last byte of the
        last intact one, truncate anything after it.  Returns the
        resulting (good) file size."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = -1
        if size <= 0:
            with open(self.path, "wb") as fh:
                fh.write(LOG_MAGIC)
                fh.flush()
                os.fsync(fh.fileno())
            return len(LOG_MAGIC)
        with open(self.path, "rb") as fh:
            magic_ok = fh.read(len(LOG_MAGIC)) == LOG_MAGIC
        if not magic_ok:
            # Not necessarily a legacy file: a bit-rotted magic
            # header on an otherwise-intact CRC-framed log must
            # not go through the legacy parser — it would misread
            # the framing, collect nothing, and the "upgrade"
            # rewrite would erase every (individually recoverable)
            # record.  If CRC framing parses from where the magic
            # ends, rescue those records instead.
            rescued = self._parse_crc_records(len(LOG_MAGIC))
            if rescued:
                logger.warning(
                    "raft log %s: magic header corrupt but %d "
                    "CRC-framed records intact; rewriting with a "
                    "clean header", self.path, len(rescued))
                return self._rewrite_records(rescued)
            return self._upgrade_legacy()
        records = self._parse_crc_records(len(LOG_MAGIC))
        good = len(LOG_MAGIC) + sum(_RECORD_HEAD + len(r)
                                    for r in records)
        if good < size:
            logger.warning(
                "raft log %s: torn/corrupt tail at offset %d (file "
                "size %d); truncating to the last intact record",
                self.path, good, size)
            with open(self.path, "r+b") as fh:
                fh.truncate(good)
                # faultlint-ok(uninjectable-io): boot-time recovery
                # truncate, before the store is live; crash coverage
                # gates at the write sites via faultinject.crashed().
                os.fsync(fh.fileno())
        return good

    def _parse_crc_records(self, offset: int) -> list:
        """Parse CRC-framed records starting at ``offset``; stop at
        the first torn/corrupt one (the tail rule)."""
        records = []
        with open(self.path, "rb") as fh:
            fh.seek(offset)
            while True:
                header = fh.read(_RECORD_HEAD)
                if len(header) < _RECORD_HEAD:
                    break
                length = int.from_bytes(header[:4], "big")
                record = fh.read(length)
                if len(record) < length or zlib.crc32(record) != \
                        int.from_bytes(header[4:], "big"):
                    break
                try:
                    msgpack.unpackb(record, raw=False)
                except Exception:
                    break
                records.append(record)
        return records

    def _rewrite_records(self, records: list) -> int:
        """Atomically rewrite the whole file as magic + CRC-framed
        ``records`` (tmp + fsync + rename + dir fsync)."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(LOG_MAGIC)
            for record in records:
                fh.write(self._frame(record))
            fh.flush()
            # faultlint-ok(uninjectable-io): compaction/upgrade rewrite
            # runs outside the live append path; the durable write
            # sites (append/save) carry the log.fsync consult.
            os.fsync(fh.fileno())
        os.rename(tmp, self.path)
        _fsync_dir(self.path)
        return os.path.getsize(self.path)

    def _upgrade_legacy(self) -> int:
        """Pre-CRC file: parse the old [length][record] framing (stop
        at the first torn/corrupt record, same tail rule) and
        atomically rewrite the whole file checksummed."""
        records = []
        with open(self.path, "rb") as fh:
            while True:
                head = fh.read(4)
                if len(head) < 4:
                    break
                length = int.from_bytes(head, "big")
                record = fh.read(length)
                if len(record) < length:
                    break
                try:
                    msgpack.unpackb(record, raw=False)
                except Exception:
                    break
                records.append(record)
        size = self._rewrite_records(records)
        logger.info("raft log %s: upgraded %d legacy records to the "
                    "CRC-framed format", self.path, len(records))
        return size

    def append(self, index: int, entry) -> None:
        record = msgpack.packb((index, entry), use_bin_type=True)
        framed = self._frame(record)
        crash = None
        if faultinject.ACTIVE:
            # Consulted OUTSIDE the lock (a delay/hang action must not
            # serialize unrelated appenders); the power-loss simulation
            # itself runs inside it.
            if faultinject.crashed(self.path):
                raise StorageDead(
                    f"process crash latched; log store {self.path} "
                    f"refuses writes")
            try:
                faultinject.fire("log.append", method=self.path)
            except faultinject.FaultCrash as c:
                crash = c
        with self._lock:
            if self._dead:
                raise StorageDead(f"log store {self.path} is dead")
            pos = self._good_offset
            if crash is not None:
                self._power_loss(framed, pos, crash)
                raise crash
            try:
                self._fh.write(framed)
                self._fh.flush()
                # log.fsync fires at its real program point: the record
                # is in the page cache but not yet durable.  A crash
                # here models power loss before the fsync (any prefix —
                # including the whole record — may have landed; the
                # seeded fraction picks); an error action models a
                # failing fsync whose bytes may still have landed — the
                # raft.py torn-tail hazard — and rides _recover_tail
                # below.  Inside the lock by necessity: a delay here is
                # a slow fsync, which serializes appenders on a real
                # disk too.
                if faultinject.ACTIVE:
                    faultinject.fire("log.fsync", method=self.path)
                os.fsync(self._fh.fileno())
            except faultinject.FaultCrash as c:
                self._power_loss(framed, pos, c)
                raise
            except Exception:
                self._recover_tail(pos)
                raise
            self._good_offset = pos + len(framed)

    def _power_loss(self, framed: bytes, pos: int, crash) -> None:
        """Simulate the cut: ``pos`` good bytes survive plus a torn
        (or one-byte bit-rotted) prefix of the in-flight record; the
        store is dead from here on.  Caller holds the lock."""
        self._dead = True
        try:
            self._fh.flush()
        except OSError:
            pass
        kept = crash.torn_length(len(framed))
        durable = framed[:kept]
        if crash.mode == "corrupt" and kept > 0:
            rot = bytearray(durable)
            rot[kept - 1] ^= 0xFF
            durable = bytes(rot)
        with open(self.path, "r+b") as fh:
            fh.truncate(pos)
            fh.seek(pos)
            fh.write(durable)
            fh.flush()
            os.fsync(fh.fileno())

    def _recover_tail(self, pos: int) -> None:
        """After a failed append: the bytes may have partially — or,
        when only the fsync failed, even fully — landed.  Re-stat and
        truncate back to the last known-good offset so the framing
        stays intact for subsequent appends; when even that fails the
        store marks itself dead (appending after an unknown tail would
        poison replay).  Caller holds the lock."""
        try:
            self._fh.flush()
        except OSError:
            pass
        try:
            if os.stat(self.path).st_size != pos:
                self._fh.truncate(pos)
            self._fh.seek(pos)
            os.fsync(self._fh.fileno())
        except OSError:
            logger.exception(
                "raft log %s: could not truncate back to known-good "
                "offset %d; marking the store dead", self.path, pos)
            self._dead = True

    def replay(self):
        """Yield (index, entry) pairs from disk.  A torn or corrupt
        tail record (crash mid-append) ends the replay cleanly rather
        than corrupting the stream; legacy (pre-CRC) files replay with
        the old framing."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as fh:
            legacy = fh.read(len(LOG_MAGIC)) != LOG_MAGIC
            if legacy:
                fh.seek(0)
            head_len = 4 if legacy else _RECORD_HEAD
            while True:
                header = fh.read(head_len)
                if len(header) < head_len:
                    return
                size = int.from_bytes(header[:4], "big")
                record = fh.read(size)
                if len(record) < size:
                    return
                if not legacy and zlib.crc32(record) != \
                        int.from_bytes(header[4:], "big"):
                    return
                try:
                    index, entry = msgpack.unpackb(record, raw=False)
                except Exception:
                    return
                yield index, entry

    def truncate(self) -> None:
        """Drop the log.  Fencing rule: callers run this only AFTER
        SnapshotStore.save returned — i.e. after the covering
        snapshot's fsync + rename are durable — so a crash between the
        two leaves a recoverable (snapshot, old log) pair."""
        self._replace_with(())

    def rewrite(self, entries) -> None:
        """Atomically replace the log with ``entries`` [(index, entry)
        ...]: tmp file + rename + directory fsync, so a crash
        mid-compaction leaves either the full old log or the full kept
        tail — never a torn log (same pattern as SnapshotStore.save)."""
        self._replace_with(entries)

    def _replace_with(self, entries) -> None:
        tmp = self.path + ".tmp"
        with self._lock:
            if self._dead:
                raise StorageDead(f"log store {self.path} is dead")
            with open(tmp, "wb") as fh:
                fh.write(LOG_MAGIC)
                for index, entry in entries:
                    fh.write(self._frame(msgpack.packb(
                        (index, entry), use_bin_type=True)))
                fh.flush()
                os.fsync(fh.fileno())
            self._fh.close()
            os.rename(tmp, self.path)
            _fsync_dir(self.path)
            self._fh = open(self.path, "ab")
            self._good_offset = os.path.getsize(self.path)

    def die(self) -> None:
        """CrashHarness kill switch: freeze the store — the process is
        'dead', its data_dir must stay byte-exact as the crash left
        it."""
        with self._lock:
            self._dead = True

    def close(self) -> None:
        with self._lock:
            self._fh.close()


def unwrap_snapshot(wrapped: bytes) -> tuple[int, bytes]:
    """Decode a snapshot file: (term, fsm_blob).

    Current format is msgpack (term, blob); a blob that doesn't unpack as
    a 2-tuple is treated as a legacy bare term-0 FSM blob, so data_dirs
    written before the wrapped format restore instead of crashing."""
    try:
        unpacked = msgpack.unpackb(wrapped, raw=False)
        if isinstance(unpacked, (tuple, list)) and len(unpacked) == 2 \
                and isinstance(unpacked[0], int):
            return unpacked[0], bytes(unpacked[1])
    except Exception:
        pass
    return 0, bytes(wrapped)


class SnapshotStore:
    """Retains the N most recent FSM snapshots on disk, checksummed.

    Lives at ``<data_dir>/raft/snapshots``; ``resolve_snapshot_dir`` falls
    back to the legacy ``<data_dir>/snapshots`` location when only it has
    content, so pre-layout-change data_dirs keep restoring.

    Durability contract:

    - files carry ``SNAP_MAGIC`` + CRC32(blob) + blob; ``latest``
      verifies the checksum and falls back to the next-older snapshot
      on a mismatch (a torn or bit-rotted snapshot degrades to an
      older recovery point, never a crash or silent garbage state);
      pre-checksum files are trusted as legacy bare blobs;
    - ``save`` is atomic (tmp + rename + directory fsync) and prunes
      older snapshots only AFTER the new one is durable — the fencing
      that keeps a crash between persist and prune recoverable (the
      caller's log truncate is fenced the same way: it runs only after
      ``save`` returns);
    - the ``snapshot.persist`` crash point simulates power loss either
      mid-tmp-write (torn tmp, real snapshot set untouched) or between
      rename and prune (new snapshot durable, old ones — and the
      caller's log truncate — never happen)."""

    def __init__(self, directory: str, retain: int = 2) -> None:
        self.directory: Immutable = directory
        self.retain = retain
        self._lock = threading.Lock()
        self._dead = False
        os.makedirs(directory, exist_ok=True)

    def save(self, index: int, blob: bytes) -> str:
        path = os.path.join(self.directory, f"snapshot-{index:020d}.bin")
        tmp = path + ".tmp"
        framed = SNAP_MAGIC + zlib.crc32(blob).to_bytes(4, "big") + blob
        crash = None
        if faultinject.ACTIVE:
            if faultinject.crashed(self.directory):
                raise StorageDead(
                    f"process crash latched; snapshot store "
                    f"{self.directory} refuses writes")
            try:
                faultinject.fire("snapshot.persist", method=self.directory)
            except faultinject.FaultCrash as c:
                crash = c
        with self._lock:
            if self._dead:
                raise StorageDead(
                    f"snapshot store {self.directory} is dead")
            if crash is not None:
                self._power_loss(path, tmp, framed, crash)
                raise crash
            with open(tmp, "wb") as fh:
                fh.write(framed)
                fh.flush()
                os.fsync(fh.fileno())
            os.rename(tmp, path)
            _fsync_dir(path)
            # Fence: only now — with the new snapshot durable — may
            # older recovery points go away.
            self._prune()
        return path

    def _power_loss(self, path: str, tmp: str, framed: bytes,
                    crash) -> None:
        """Simulate the cut at one of the two interesting instants.
        Caller holds the lock."""
        self._dead = True
        if crash.fraction < 0.5:
            # Mid-tmp-write: a torn tmp that was never renamed — the
            # real snapshot set is untouched.
            kept = crash.torn_length(len(framed))
            with open(tmp, "wb") as fh:
                fh.write(framed[:kept])
                fh.flush()
                os.fsync(fh.fileno())
        else:
            # Between rename and prune: the new snapshot IS durable;
            # old snapshots and the caller's log truncate never happen.
            with open(tmp, "wb") as fh:
                fh.write(framed)
                fh.flush()
                os.fsync(fh.fileno())
            os.rename(tmp, path)
            _fsync_dir(path)

    def latest(self) -> Optional[tuple[int, bytes]]:
        for index, path in reversed(self._list()):
            blob = self._read_verified(path)
            if blob is not None:
                return index, blob
        return None

    def _read_verified(self, path: str) -> Optional[bytes]:
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError:
            return None
        if raw.startswith(SNAP_MAGIC):
            if zlib.crc32(raw[12:]) != int.from_bytes(raw[8:12], "big"):
                logger.warning(
                    "snapshot %s fails its checksum; falling back to "
                    "an older snapshot", path)
                return None
            return raw[12:]
        return raw  # legacy pre-checksum snapshot: bare blob

    def _list(self) -> list:
        out = []
        for name in sorted(os.listdir(self.directory)):
            if name.startswith("snapshot-") and name.endswith(".bin"):
                out.append((int(name[len("snapshot-"):-4]),
                            os.path.join(self.directory, name)))
        return out

    def _prune(self) -> None:
        snaps = self._list()
        for _, path in snaps[:-self.retain]:
            try:
                os.unlink(path)
            except OSError:
                pass  # a leftover old snapshot is harmless

    def die(self) -> None:
        """CrashHarness kill switch (see FileLogStore.die)."""
        with self._lock:
            self._dead = True


class MetaStore:
    """Raft term/vote metadata: atomic JSON persistence (tmp + replace
    + directory fsync) with a ``meta.persist`` crash point.  A
    mid-write power cut leaves a torn ``.tmp`` and the previous meta
    intact — term and vote can lag, never tear."""

    def __init__(self, path: str) -> None:
        self.path: Immutable = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._dead = False

    def load(self) -> Optional[dict]:
        try:
            with open(self.path) as fh:
                return json.load(fh)
        except FileNotFoundError:
            return None
        except ValueError:
            # Unreachable via save()'s atomic replace; bit rot on an
            # old file still must not crash-loop the boot.
            logger.warning("raft meta %s is corrupt; booting with "
                           "empty metadata", self.path)
            return None

    def save(self, meta: dict) -> None:
        data = json.dumps(meta).encode()
        tmp = self.path + ".tmp"
        crash = None
        if faultinject.ACTIVE:
            if faultinject.crashed(self.path):
                raise StorageDead(
                    f"process crash latched; meta store {self.path} "
                    f"refuses writes")
            try:
                faultinject.fire("meta.persist", method=self.path)
            except faultinject.FaultCrash as c:
                crash = c
        with self._lock:
            if self._dead:
                raise StorageDead(f"meta store {self.path} is dead")
            if crash is not None:
                self._dead = True
                kept = crash.torn_length(len(data))
                with open(tmp, "wb") as fh:
                    fh.write(data[:kept])
                    fh.flush()
                    os.fsync(fh.fileno())
                raise crash
            with open(tmp, "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
            _fsync_dir(self.path)

    def die(self) -> None:
        """CrashHarness kill switch (see FileLogStore.die)."""
        with self._lock:
            self._dead = True


def resolve_snapshot_dir(data_dir: str) -> str:
    """The snapshot directory for a data_dir: ``<data_dir>/raft/snapshots``
    unless only the legacy ``<data_dir>/snapshots`` holds snapshots."""
    current = os.path.join(data_dir, "raft", "snapshots")
    legacy = os.path.join(data_dir, "snapshots")

    def _has_snaps(d: str) -> bool:
        try:
            return any(n.startswith("snapshot-") and n.endswith(".bin")
                       for n in os.listdir(d))
        except OSError:
            return False

    if not _has_snaps(current) and _has_snaps(legacy):
        return legacy
    return current


class InmemRaft:
    """Single-node raft: every apply commits immediately.

    With a FileLogStore the log is durable and replayed on construction;
    ``maybe_snapshot`` compacts it through the SnapshotStore.
    """

    def __init__(self, fsm, log_store: Optional[FileLogStore] = None,
                 snapshots: Optional[SnapshotStore] = None,
                 snapshot_threshold: int = 8192) -> None:
        self.fsm = fsm
        self.log_store = log_store
        self.snapshots: Immutable = snapshots
        self.snapshot_threshold = snapshot_threshold
        self._lock = threading.Lock()
        self._applied = 0
        self._entries_since_snap = 0

        # Boot: restore newest snapshot, then replay the tail of the log.
        # Snapshot files wrap (term, fsm_blob) — shared format with NetRaft
        # so one data_dir moves between backends.
        if snapshots is not None:
            latest = snapshots.latest()
            if latest is not None:
                index, wrapped = latest
                _term, blob = unwrap_snapshot(wrapped)
                fsm.restore(blob)
                self._applied = index
        if log_store is not None:
            # Last-writer-wins on duplicate indexes: a failed append whose
            # record nonetheless landed is superseded by the caller's
            # retry under the same index (NetRaft replay parity).
            tail: dict = {}
            for index, entry in log_store.replay():
                if index <= self._applied:
                    continue
                tail[index] = entry
            for index in sorted(tail):
                if index != self._applied + 1:
                    raise CommittedDataLoss(
                        f"raft log {log_store.path}: committed entries "
                        f"{self._applied + 1}..{index - 1} are missing "
                        "between the snapshot restore point and the "
                        "compacted log; refusing to boot")
                try:
                    fsm.apply(index, tail[index])
                except Exception:
                    # A bad record must not crash-loop server boot; the
                    # write it carried already failed when first applied.
                    logger.exception("skipping unreplayable log entry %d",
                                     index)
                self._applied = index

    def applied_index(self) -> int:
        with self._lock:
            return self._applied

    def apply(self, entry: bytes) -> ApplyFuture:
        if faultinject.ACTIVE:
            # Before any state moves: an injected failure here is an
            # entry that never entered the log (callers retry/raise).
            faultinject.fire("raft.apply")
        future = ApplyFuture()
        with self._lock:
            index = self._applied + 1
            # Persist BEFORE applying (raft discipline, reference
            # raft-boltdb ordering): a disk failure rejects the entry with
            # no state moved, so the in-memory FSM can never run ahead of
            # the durable log.  An entry whose apply then fails stays on
            # disk but is harmless — boot replay tolerates unreplayable
            # entries (see replay try/except above), mirroring that the
            # write it carried failed when first applied.
            if self.log_store is not None:
                try:
                    self.log_store.append(index, entry)
                except Exception as e:
                    logger.exception("raft log append failed at index %d",
                                     index)
                    future.respond(index, None, e)
                    return future
            apply_error = None
            response = None
            try:
                response = self.fsm.apply(index, entry)
            except Exception as e:  # surface apply errors to the caller
                apply_error = e
            self._applied = index
            self._entries_since_snap += 1
        future.respond(index, response, apply_error)
        if apply_error is None:
            try:
                self._maybe_snapshot()
            except Exception:
                # A compaction failure (disk death, injected crash)
                # must not fail an apply that already committed; the
                # log keeps the entries a snapshot would have covered.
                logger.exception("snapshot compaction failed")
        return future

    def barrier(self) -> int:
        """All prior applies are visible once this returns (trivially true
        for the in-memory backend)."""
        return self.applied_index()

    def _maybe_snapshot(self) -> None:
        if self.snapshots is None:
            return  # set once in __init__, safe to read bare
        with self._lock:
            # Threshold check and counter reset must be one atomic step:
            # checked bare, two concurrent appliers both pass it and both
            # snapshot+truncate (duplicate compaction work, and the
            # second truncate races the first's fresh appends).
            if self._entries_since_snap < self.snapshot_threshold:
                return
            blob = self.fsm.snapshot()
            # Term 0: the single-node backend has no elections; NetRaft
            # reading this snapshot starts with a base term of 0.
            self.snapshots.save(
                self._applied, msgpack.packb((0, blob), use_bin_type=True))
            if self.log_store is not None:
                self.log_store.truncate()
            self._entries_since_snap = 0
