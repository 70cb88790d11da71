"""The port's durability and crash recovery against the JAX package's.

Twins of tests/test_crash_recovery.py on ``nomad_tpu_torch``:

1. **Storage crash points**: every torn-write shape the ``crash`` fault
   can leave in the port's log, snapshot and meta stores recovers to a
   clean committed prefix on the next open — and, where the result is
   data, to the prefix the JAX package's stores open the same bytes to.
   The same seeded fault plan, fired into an ``InmemRaft`` of each
   package fed the same entries, leaves data_dirs that boot (in either
   package) to equal store digests.
2. **Boot refuses a silent gap** in both raft backends, and a follower
   that cannot persist an installed snapshot refuses the install.
3. **Crash-point soak, meta-persist crash, leader-kill soak**: the slow
   twins, marked slow as the JAX tests are.
4. **Client reboot with a torn alloc state file**: the alloc is
   re-fetched and its task re-attached; an alloc the server stopped
   meanwhile is reclaimed.

Servers here run on the CPU (``device="cpu"``).
"""
from __future__ import annotations

import os
import random
import shutil
import threading
import time

import msgpack
import pytest

import nomad_tpu.mock as jmock
from nomad_tpu import faultinject as jfaultinject
from nomad_tpu.faultinject import FaultPlan as JFaultPlan
from nomad_tpu.server.fsm import NomadFSM as JFSM
from nomad_tpu.server.raft import FileLogStore as JLog
from nomad_tpu.server.raft import InmemRaft as JInmem
from nomad_tpu.server.raft import SnapshotStore as JSnaps
from nomad_tpu.structs import codec as jcodec
from nomad_tpu_torch import faultinject
from nomad_tpu_torch import mock
from nomad_tpu_torch.faultinject import FaultCrash, FaultPlan
from nomad_tpu_torch.faultinject.crash import CrashHarness, freeze_storage
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.fsm import NomadFSM
from nomad_tpu_torch.server.raft import (
    LOG_MAGIC,
    CommittedDataLoss,
    FileLogStore,
    InmemRaft,
    MetaStore,
    SnapshotStore,
    StorageDead,
    resolve_snapshot_dir,
)
from nomad_tpu_torch.server.raft_net import NetRaft
from nomad_tpu_torch.server.rpc import ConnPool
from nomad_tpu_torch.structs import Resources, Task, TaskGroup

from tests.conftest import wait_until
from tests.test_torch_raft_net import _RecordingFSM, _StubRPC

TERMINAL = ("complete", "failed", "canceled")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _small_job(n_groups: int = 2, count: int = 1):
    job = mock.job()
    job.constraints = []
    job.task_groups = [
        TaskGroup(name=f"tg-{g}", count=count,
                  tasks=[Task(name="web", driver="exec",
                              resources=Resources(cpu=100,
                                                  memory_mb=32))])
        for g in range(n_groups)]
    return job


def _assert_exactly_once(state, jobs) -> None:
    """Every job fully placed, no duplicate live alloc names."""
    for job in jobs:
        expected = sum(tg.count for tg in job.task_groups)
        live = [a for a in state.allocs_by_job(job.id)
                if not a.terminal_status()]
        names = [a.name for a in live]
        assert len(names) == len(set(names)), \
            f"duplicate allocs for {job.id}: {sorted(names)}"
        assert len(live) == expected, \
            f"job {job.id}: {len(live)} live allocs, want {expected}"


def _evals_terminal(state, jobs) -> bool:
    for job in jobs:
        evals = state.evals_by_job(job.id)
        if not evals:
            return False
        if any(e.status not in TERMINAL for e in evals):
            return False
    return True


def _replay_twin(history: list, upto: int) -> NomadFSM:
    """A fresh FSM fed the recorded applied history up to ``upto``."""
    twin = NomadFSM()
    for index, entry in history:
        if index > upto:
            break
        try:
            twin.apply(index, entry)
        except Exception:
            pass
    return twin


def _submit_retry(pool, addr_fn, method, args, acked=None, key=None,
                  deadline=30.0):
    """Client-style submission: retry across crashes and reboots until
    the server acks; records the acked raft index."""
    end = time.monotonic() + deadline
    while True:
        try:
            resp = pool.call(addr_fn(), method, args, timeout=2.0)
        except Exception:
            if time.monotonic() >= end:
                raise
            time.sleep(0.05)  # sleep-ok: bounded retry poll across a crash
            continue
        if acked is not None and key is not None:
            acked[key] = resp.get("index", 0)
        return resp


def _server_config(**kw) -> ServerConfig:
    kw.setdefault("device", "cpu")
    kw.setdefault("tune_gc", False)
    return ServerConfig(**kw)


# ---------------------------------------------------------------------------
# 1. storage crash points
# ---------------------------------------------------------------------------

class TestLogStoreCrashPoints:
    def _records(self, store):
        return [(i, bytes(d)) for i, d in store.replay()]

    def test_log_append_crash_leaves_recoverable_prefix(self, tmp_path):
        path = str(tmp_path / "log.bin")
        store = FileLogStore(path)
        store.append(1, b"one")
        store.append(2, b"two")
        plan = FaultPlan(seed=5).add("log.append", "crash", count=1)
        with faultinject.injected(plan):
            with pytest.raises(FaultCrash):
                store.append(3, b"three")
            with pytest.raises(StorageDead):
                store.append(4, b"four")
            assert plan.is_crashed()
        store.close()

        reopened = FileLogStore(path)
        records = self._records(reopened)
        full = [(1, b"one"), (2, b"two"), (3, b"three")]
        assert records == full[:len(records)] and len(records) >= 2
        reopened.append(len(records) + 1, b"next")
        reopened.close()

    def test_fsync_crash_full_record_lands_and_replays(self, tmp_path):
        """fraction=1.0: the whole record survived the cut; replay keeps
        it (last-writer-wins resolves the caller's re-append)."""
        path = str(tmp_path / "log.bin")
        store = FileLogStore(path)
        store.append(1, b"one")
        record = msgpack.packb((2, b"lost-but-landed"), use_bin_type=True)
        framed = store._frame(record)
        with store._lock:
            store._power_loss(framed, store._good_offset,
                              FaultCrash("log.fsync", 1.0, "torn"))
        store.close()
        want = [(1, b"one"), (2, b"lost-but-landed")]
        assert [(i, bytes(d)) for i, d in JLog(path).replay()] == want
        reopened = FileLogStore(path)
        assert self._records(reopened) == want
        reopened.close()

    def test_corrupt_crash_detected_by_crc(self, tmp_path):
        """mode=corrupt: every byte landed but one rotted.  The CRC
        catches it; the tail-scan truncates to the prior record."""
        path = str(tmp_path / "log.bin")
        store = FileLogStore(path)
        store.append(1, b"one")
        record = msgpack.packb((2, b"rotted"), use_bin_type=True)
        framed = store._frame(record)
        pos = store._good_offset
        with store._lock:
            store._power_loss(framed, pos,
                              FaultCrash("log.fsync", 1.0, "corrupt"))
        store.close()
        assert os.path.getsize(path) == pos + len(framed)
        reopened = FileLogStore(path)
        assert self._records(reopened) == [(1, b"one")]
        assert os.path.getsize(path) == pos
        reopened.close()

    def test_append_error_truncates_back_to_known_good(self, tmp_path):
        """A mid-record write failure leaves partial bytes; the store
        re-stats and truncates back to the last known-good offset before
        allowing appends."""
        path = str(tmp_path / "log.bin")
        store = FileLogStore(path)
        store.append(1, b"one")
        good = store._good_offset
        real_fh = store._fh

        class TornWriter:
            def __init__(self, fh, budget):
                self.fh = fh
                self.budget = budget

            def write(self, data):
                if len(data) > self.budget:
                    self.fh.write(data[:self.budget])
                    self.fh.flush()
                    self.budget = 0
                    raise OSError("disk error mid-record")
                self.budget -= len(data)
                return self.fh.write(data)

            def __getattr__(self, name):
                return getattr(self.fh, name)

        store._fh = TornWriter(real_fh, budget=7)
        with pytest.raises(OSError):
            store.append(2, b"torn-away")
        store._fh = real_fh
        assert os.path.getsize(path) == good
        store.append(2, b"two-retry")
        store.close()
        reopened = FileLogStore(path)
        assert self._records(reopened) == [(1, b"one"), (2, b"two-retry")]
        reopened.close()

    def test_legacy_log_upgraded_in_place(self, tmp_path):
        """Pre-CRC data_dirs keep restoring: the old [length][record]
        framing is parsed (tail rule included) and rewritten
        checksummed on open."""
        path = str(tmp_path / "log.bin")
        legacy = b""
        for i, data in ((1, b"a"), (2, b"b")):
            record = msgpack.packb((i, data), use_bin_type=True)
            legacy += len(record).to_bytes(4, "big") + record
        legacy += (99).to_bytes(4, "big") + b"torn"
        with open(path, "wb") as fh:
            fh.write(legacy)
        store = FileLogStore(path)
        assert self._records(store) == [(1, b"a"), (2, b"b")]
        with open(path, "rb") as fh:
            assert fh.read(len(LOG_MAGIC)) == LOG_MAGIC
        store.append(3, b"c")
        assert self._records(store) == [(1, b"a"), (2, b"b"), (3, b"c")]
        store.close()

    def test_rotted_magic_header_rescues_intact_records(self, tmp_path):
        """A bit-rotted MAGIC header does not route an intact CRC-framed
        log through the legacy parser: the records are rescued and the
        header rewritten."""
        path = str(tmp_path / "log.bin")
        store = FileLogStore(path)
        for i, data in ((1, b"a"), (2, b"bb"), (3, b"ccc")):
            store.append(i, data)
        store.close()
        with open(path, "r+b") as fh:
            fh.seek(2)
            byte = fh.read(1)
            fh.seek(2)
            fh.write(bytes([byte[0] ^ 0xFF]))
        rescued = FileLogStore(path)
        assert self._records(rescued) == [(1, b"a"), (2, b"bb"),
                                          (3, b"ccc")]
        with open(path, "rb") as fh:
            assert fh.read(len(LOG_MAGIC)) == LOG_MAGIC
        rescued.append(4, b"dddd")
        assert self._records(rescued)[-1] == (4, b"dddd")
        rescued.close()

    def test_random_crash_offsets_always_yield_committed_prefix(
            self, tmp_path):
        """Property: ANY truncation or single-byte corruption of a
        recorded log replays as a committed prefix — the same prefix
        in both packages."""
        path = str(tmp_path / "log.bin")
        store = FileLogStore(path)
        original = []
        for i in range(1, 21):
            data = f"entry-{i}".encode() * (i % 5 + 1)
            store.append(i, data)
            original.append((i, data))
        store.close()
        size = os.path.getsize(path)

        for trial in range(40):
            rng = random.Random(trial)
            offset = rng.randrange(len(LOG_MAGIC), size)
            truncate = rng.random() < 0.5
            got = {}
            for name, cls in (("torch", FileLogStore), ("jax", JLog)):
                victim = str(tmp_path / f"victim-{name}-{trial}.bin")
                shutil.copyfile(path, victim)
                with open(victim, "r+b") as fh:
                    if truncate:
                        fh.truncate(offset)
                    else:
                        fh.seek(offset)
                        byte = fh.read(1)
                        fh.seek(offset)
                        fh.write(bytes([byte[0] ^ 0xFF]))
                recovered = cls(victim)
                got[name] = [(i, bytes(d)) for i, d in recovered.replay()]
                recovered.close()
            records = got["torch"]
            assert records == original[:len(records)], \
                f"trial {trial} @ {offset}: not a committed prefix"
            assert got["jax"] == records, f"trial {trial} @ {offset}"


class TestSnapshotStoreCrashPoints:
    def _blob(self, tag: bytes) -> bytes:
        return tag * 64

    def test_checksum_fallback_to_older_snapshot(self, tmp_path):
        store = SnapshotStore(str(tmp_path), retain=2)
        store.save(5, self._blob(b"five"))
        path9 = store.save(9, self._blob(b"nine"))
        with open(path9, "r+b") as fh:
            fh.seek(30)
            byte = fh.read(1)
            fh.seek(30)
            fh.write(bytes([byte[0] ^ 0xFF]))
        assert store.latest() == (5, self._blob(b"five"))
        assert JSnaps(str(tmp_path), retain=2).latest() == store.latest()

    def test_save_prunes_only_after_durable_rename(self, tmp_path):
        store = SnapshotStore(str(tmp_path), retain=1)
        store.save(1, self._blob(b"one"))
        store.save(2, self._blob(b"two"))
        names = sorted(os.listdir(str(tmp_path)))
        assert names == ["snapshot-%020d.bin" % 2]

    def test_crash_mid_tmp_write_leaves_old_set_untouched(self, tmp_path):
        store = SnapshotStore(str(tmp_path), retain=2)
        store.save(1, self._blob(b"one"))
        framed = b"\0" * 64
        with store._lock:
            store._power_loss(
                os.path.join(str(tmp_path), "snapshot-%020d.bin" % 2),
                os.path.join(str(tmp_path),
                             "snapshot-%020d.bin.tmp" % 2),
                framed, FaultCrash("snapshot.persist", 0.3, "torn"))
        with pytest.raises(StorageDead):
            store.save(3, self._blob(b"three"))
        fresh = SnapshotStore(str(tmp_path), retain=2)
        assert fresh.latest() == (1, self._blob(b"one"))

    def test_crash_between_rename_and_prune_keeps_both(self, tmp_path):
        """The new snapshot IS durable; the old one never got deleted.
        Both recovery points remain."""
        import zlib

        store = SnapshotStore(str(tmp_path), retain=1)
        store.save(1, self._blob(b"one"))
        blob2 = self._blob(b"two")
        framed = (b"NTPSNP2\n" + zlib.crc32(blob2).to_bytes(4, "big")
                  + blob2)
        with store._lock:
            store._power_loss(
                os.path.join(str(tmp_path), "snapshot-%020d.bin" % 2),
                os.path.join(str(tmp_path),
                             "snapshot-%020d.bin.tmp" % 2),
                framed, FaultCrash("snapshot.persist", 0.9, "torn"))
        names = sorted(n for n in os.listdir(str(tmp_path))
                       if n.endswith(".bin"))
        assert len(names) == 2
        assert SnapshotStore(str(tmp_path), retain=1).latest() == \
            (2, blob2)

    def test_random_snapshot_truncations_never_raise(self, tmp_path):
        store = SnapshotStore(str(tmp_path / "snaps"), retain=3)
        store.save(3, self._blob(b"three"))
        path7 = store.save(7, self._blob(b"seven"))
        size = os.path.getsize(path7)
        for trial in range(20):
            rng = random.Random(1000 + trial)
            victim_dir = str(tmp_path / f"v{trial}")
            shutil.copytree(str(tmp_path / "snaps"), victim_dir)
            victim = os.path.join(victim_dir, os.path.basename(path7))
            with open(victim, "r+b") as fh:
                fh.truncate(rng.randrange(0, size))
            got = SnapshotStore(victim_dir, retain=3).latest()
            assert got is not None
            assert got[0] in (3, 7)
            if got[0] == 3:
                assert got[1] == self._blob(b"three")
            assert JSnaps(victim_dir, retain=3).latest() == got


class TestMetaStoreCrashPoints:
    def test_torn_tmp_keeps_previous_meta(self, tmp_path):
        path = str(tmp_path / "meta.json")
        store = MetaStore(path)
        store.save({"term": 3, "voted_for": ["127.0.0.1", 4000]})
        plan = FaultPlan(seed=9).add("meta.persist", "crash", count=1)
        with faultinject.injected(plan):
            with pytest.raises(FaultCrash):
                store.save({"term": 4, "voted_for": None})
            with pytest.raises(StorageDead):
                store.save({"term": 5, "voted_for": None})
        assert MetaStore(path).load() == {
            "term": 3, "voted_for": ["127.0.0.1", 4000]}

    def test_crash_latch_freezes_every_storage_site(self, tmp_path):
        """One crash = the whole process is dead: after log.append
        crashes, the snapshot and meta stores refuse writes too."""
        plan = FaultPlan(seed=1).add("log.append", "crash", count=1)
        log = FileLogStore(str(tmp_path / "log.bin"))
        snaps = SnapshotStore(str(tmp_path / "snaps"))
        meta = MetaStore(str(tmp_path / "meta.json"))
        with faultinject.injected(plan):
            with pytest.raises(FaultCrash):
                log.append(1, b"x")
            with pytest.raises(StorageDead):
                snaps.save(1, b"blob")
            with pytest.raises(StorageDead):
                meta.save({"term": 1})
            plan.reset_crashed()
            snaps.save(1, b"blob")
            meta.save({"term": 1})
            with pytest.raises(StorageDead):
                log.append(2, b"y")

    def test_scoped_crash_latch_spares_other_data_dirs(self, tmp_path):
        """A crash rule aimed at ONE server's data_dir freezes only that
        server's stores; its in-process peers keep committing."""
        s1, s2 = str(tmp_path / "s1"), str(tmp_path / "s2")
        plan = FaultPlan(seed=2).add("log.append", "crash", count=1,
                                     method=f"{s1}*")
        log1 = FileLogStore(f"{s1}/raft/log.bin")
        snaps1 = SnapshotStore(f"{s1}/raft/snapshots")
        log2 = FileLogStore(f"{s2}/raft/log.bin")
        snaps2 = SnapshotStore(f"{s2}/raft/snapshots")
        meta2 = MetaStore(f"{s2}/raft/meta.json")
        with faultinject.injected(plan):
            log2.append(1, b"unmatched path: no fire")
            with pytest.raises(FaultCrash):
                log1.append(1, b"x")
            with pytest.raises(StorageDead):
                snaps1.save(1, b"blob")
            log2.append(2, b"after the cut")
            snaps2.save(1, b"blob")
            meta2.save({"term": 1})
        log1.close()
        log2.close()


_CRASH_NODES = [jmock.node(i) for i in range(24)]


def _crash_entries() -> list:
    return [jcodec.encode(jcodec.NODE_REGISTER_REQUEST,
                          {"node": n.to_dict()}) for n in _CRASH_NODES]


PACKAGES = {
    "torch": (faultinject, FaultPlan, NomadFSM, InmemRaft, FileLogStore,
              SnapshotStore),
    "jax": (jfaultinject, JFaultPlan, JFSM, JInmem, JLog, JSnaps),
}


def _crash_run(pkg, data_dir, site, seed):
    """Feed the same entries into ``pkg``'s durable InmemRaft under a
    seeded crash at ``site``; stop at the crash, as the process would."""
    fi, plan_cls, fsm_cls, raft_cls, log_cls, snaps_cls = PACKAGES[pkg]
    # The log sites fire on the tenth append; snapshots are persisted
    # every 4 entries, so that site fires on the second.
    after = 1 if site == "snapshot.persist" else 9
    plan = plan_cls(seed=seed).add(site, "crash", count=1, after=after)
    log = log_cls(f"{data_dir}/raft/log.bin")
    snaps = snaps_cls(resolve_snapshot_dir(data_dir))
    with fi.injected(plan):
        raft = raft_cls(fsm_cls(), log, snaps, snapshot_threshold=4)
        for entry in _crash_entries():
            try:
                raft.apply(entry).wait(5)
            except Exception:
                pass
            if plan.is_crashed():
                break
        assert plan.fire_count(site) == 1
    log.close()


def _boot_digest(pkg, data_dir) -> str:
    _fi, _plan, fsm_cls, raft_cls, log_cls, snaps_cls = PACKAGES[pkg]
    fsm = fsm_cls()
    log = log_cls(f"{data_dir}/raft/log.bin")
    raft_cls(fsm, log, snaps_cls(resolve_snapshot_dir(data_dir)))
    log.close()
    return fsm.state.fingerprint(changelog_since=10**9)


@pytest.mark.parametrize("site,seed", [
    ("log.append", 11), ("log.fsync", 21), ("snapshot.persist", 31)])
def test_a_seeded_crash_recovers_to_the_same_store_in_both_packages(
        tmp_path, site, seed):
    """The same seeded fault plan, fired into each package's durable
    ``InmemRaft`` fed the same entries, tears the same bytes: the two
    logs are byte-identical (a snapshot carries its FSM's wall-clock
    time table, so snapshot files differ by those stamps), and each
    data_dir boots — in either package — to one store digest, a
    committed prefix of the entries."""
    dirs = {}
    for pkg in PACKAGES:
        dirs[pkg] = str(tmp_path / pkg)
        _crash_run(pkg, dirs[pkg], site, seed)
    logs = []
    for pkg in PACKAGES:
        with open(f"{dirs[pkg]}/raft/log.bin", "rb") as fh:
            logs.append(fh.read())
    assert logs[0] == logs[1]
    digests = {(reader, writer): _boot_digest(reader, dirs[writer])
               for reader in PACKAGES for writer in PACKAGES}
    assert len(set(digests.values())) == 1, digests
    fsm = NomadFSM()
    log = FileLogStore(f"{dirs['torch']}/raft/log.bin")
    raft = InmemRaft(fsm, log, SnapshotStore(
        resolve_snapshot_dir(dirs["torch"])))
    log.close()
    k = raft.applied_index()
    assert 0 < k < len(_CRASH_NODES)
    twin = _replay_twin(list(enumerate(_crash_entries(), start=1)), k)
    assert twin.state.fingerprint(changelog_since=10**9) == \
        digests[("torch", "torch")]


def lay_down_gap(tmp_path, record, blobs=(b"old-state", b"new-state")):
    """data_dir with snapshots at 2 (good) and 5 (rotted CRC) and a log
    compacted to entries 6..7: falling back to 2 leaves entries 3..5
    unrecoverable."""
    snap_dir = resolve_snapshot_dir(str(tmp_path))
    snaps = SnapshotStore(snap_dir)
    snaps.save(2, blobs[0])
    path5 = snaps.save(5, blobs[1])
    with open(path5, "r+b") as fh:
        fh.seek(20)
        byte = fh.read(1)
        fh.seek(20)
        fh.write(bytes([byte[0] ^ 0xFF]))
    log = FileLogStore(str(tmp_path / "raft" / "log.bin"))
    for i in (6, 7):
        log.append(i, record(i))
    log.close()


class TestBootRefusesSilentGap:
    """A checksum-failed newest snapshot falls back to an older one; if
    the log was compacted past the fallback, the durable history has a
    HOLE, and both raft backends refuse to boot (CommittedDataLoss)."""

    def test_inmem_boot_refuses_gap(self, tmp_path):
        lay_down_gap(tmp_path, lambda i: b"entry-%d" % i)
        log = FileLogStore(str(tmp_path / "raft" / "log.bin"))
        snaps = SnapshotStore(resolve_snapshot_dir(str(tmp_path)))
        with pytest.raises(CommittedDataLoss):
            InmemRaft(_RecordingFSM(), log, snaps)
        log.close()

    def test_net_raft_boot_refuses_gap(self, tmp_path):
        lay_down_gap(tmp_path, lambda i: {"t": 1, "d": b"entry-%d" % i})
        with pytest.raises(CommittedDataLoss):
            NetRaft(_RecordingFSM(), _StubRPC(), None,
                    election_timeout=(30.0, 60.0),
                    data_dir=str(tmp_path))

    def test_install_snapshot_persist_failure_refuses_install(
            self, tmp_path):
        """A follower whose snapshot store cannot make the installed
        blob durable refuses the install with NO state moved."""
        class RecordingRestoreFSM(_RecordingFSM):
            def __init__(self):
                super().__init__()
                self.restored = []

            def restore(self, blob):
                self.restored.append(bytes(blob))

        fsm = RecordingRestoreFSM()
        raft = NetRaft(fsm, _StubRPC(), None,
                       election_timeout=(30.0, 60.0),
                       data_dir=str(tmp_path))
        try:
            raft._snap_store.die()
            reply = raft._handle_install_snapshot({
                "term": 1, "leader": ["127.0.0.1", 4000],
                "last_included_index": 5, "last_included_term": 1,
                "data": b"snap-blob"})
            assert reply == {"term": 1}
            assert fsm.restored == []
            assert raft._last_applied == 0
            assert raft._commit_index == 0
            assert raft._log_base_index == 0
            assert raft._snap_blob is None
            assert raft._snap_store.latest() is None
        finally:
            raft.shutdown()


# ---------------------------------------------------------------------------
# 2. crash-point soak: committed prefix + exactly-once (slow)
# ---------------------------------------------------------------------------

def _soak_config(data_dir: str, snapshot_threshold: int) -> ServerConfig:
    return _server_config(
        data_dir=data_dir, enable_rpc=True, num_schedulers=2,
        raft_snapshot_threshold=snapshot_threshold)


@pytest.mark.slow
@pytest.mark.parametrize("site,seed", [
    ("log.append", 11),
    ("log.append", 12),
    ("log.fsync", 21),
    ("snapshot.persist", 31),
    ("snapshot.persist", 32),
])
def test_crash_point_soak_recovers_committed_prefix(tmp_path, site, seed):
    """A live submission storm, a seeded crash at ``site``, a hard kill,
    a reboot from the same data_dir: the rebooted store is a byte-exact
    committed prefix of the applied history, no acked write is lost,
    and retries converge to exactly-once placement."""
    data_dir = str(tmp_path / "server")
    threshold = 8 if site == "snapshot.persist" else 100_000
    server = Server(_soak_config(data_dir, threshold))
    server.establish_leadership()

    history: list = []
    server.fsm.on_entry = lambda i, e: history.append((i, e))

    current = {"server": server}
    harness = CrashHarness()
    pool = ConnPool()
    jobs = [_small_job() for _ in range(12)]
    acked: dict = {}
    stop = threading.Event()

    def addr_fn():
        return current["server"].rpc_address()

    def lane(lane_jobs):
        for job in lane_jobs:
            if stop.is_set():
                return
            _submit_retry(pool, addr_fn, "Job.Register",
                          {"job": job.to_dict()}, acked=acked,
                          key=job.id, deadline=60.0)

    plan = FaultPlan(seed=seed).add(site, "crash", count=1, after=4)
    try:
        for i in range(6):
            _submit_retry(pool, addr_fn, "Node.Register",
                          {"node": mock.node(i).to_dict()})
        with faultinject.injected(plan):
            lanes = [threading.Thread(target=lane, args=(jobs[i::2],),
                                      daemon=True) for i in range(2)]
            for t in lanes:
                t.start()

            wait_until(lambda: plan.fire_count(site) > 0, timeout=30,
                       msg=f"crash fired at {site}")
            harness.kill(server)
            pre_crash_history = list(history)
            acked_max = max(acked.values(), default=0)

            snap_store = SnapshotStore(resolve_snapshot_dir(data_dir))
            latest = snap_store.latest()
            since = latest[0] if latest else 0
            probe_fsm = NomadFSM()
            probe_raft = InmemRaft(
                probe_fsm, FileLogStore(f"{data_dir}/raft/log.bin"),
                snap_store)
            k = probe_raft.applied_index()
            probe_raft.log_store.close()
            assert k >= acked_max, \
                f"committed write lost: recovered to {k}, " \
                f"acked up to {acked_max}"
            twin = _replay_twin(pre_crash_history, k)
            assert probe_fsm.state.fingerprint(changelog_since=since) == \
                twin.state.fingerprint(changelog_since=since), \
                "recovered store is not a byte-exact committed prefix"

            server2 = harness.reboot(_soak_config(data_dir, threshold))
            current["server"] = server2
            for t in lanes:
                t.join(90.0)
            assert all(not t.is_alive() for t in lanes)
            assert set(acked) == {j.id for j in jobs}
            wait_until(lambda: _evals_terminal(server2.fsm.state, jobs),
                       timeout=60, msg="all evals terminal after reboot")
            _assert_exactly_once(server2.fsm.state, jobs)
    finally:
        stop.set()
        pool.shutdown()
        harness.reap(also=[current["server"]])


@pytest.mark.slow
def test_meta_persist_crash_recovers_and_elects(tmp_path):
    """A single-node NetRaft server crashes persisting its first
    election's term bump; the reboot elects cleanly and a storm then
    places exactly once."""
    data_dir = str(tmp_path / "server")
    cfg_kw = dict(
        data_dir=data_dir, raft_mode="net", num_schedulers=2,
        raft_election_timeout=(0.05, 0.10),
        raft_heartbeat_interval=0.02)
    harness = CrashHarness()
    pool = ConnPool()
    plan = FaultPlan(seed=77).add("meta.persist", "crash", count=1)
    server2 = None
    try:
        with faultinject.injected(plan):
            server = Server(_server_config(**cfg_kw))
            wait_until(lambda: plan.fire_count("meta.persist") > 0,
                       timeout=10, msg="crash fired at meta.persist")
            assert not server.raft.is_leader()
            harness.kill(server)

            server2 = harness.reboot(_server_config(**cfg_kw))
            wait_until(lambda: server2.raft.is_leader() and
                       server2.is_leader(), msg="post-reboot election")
            meta = MetaStore(f"{data_dir}/raft/meta.json").load()
            assert meta is not None and meta["term"] >= 1

            jobs = [_small_job() for _ in range(6)]
            for i in range(4):
                _submit_retry(pool, server2.rpc_address, "Node.Register",
                              {"node": mock.node(i).to_dict()})
            for job in jobs:
                _submit_retry(pool, server2.rpc_address, "Job.Register",
                              {"job": job.to_dict()})
            wait_until(lambda: _evals_terminal(server2.fsm.state, jobs),
                       timeout=30, msg="storm terminal after recovery")
            _assert_exactly_once(server2.fsm.state, jobs)
    finally:
        pool.shutdown()
        harness.reap(also=[server2] if server2 is not None else None)


# ---------------------------------------------------------------------------
# 3. leader-kill soak: rolling failover on a durable cluster (slow)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_leader_kill_soak_converges_exactly_once(tmp_path):
    """Three rolling leader kills (hard drops, storage frozen mid-flight)
    on a durable 3-server cluster under a live storm: survivors elect,
    the killed node reboots from its own data_dir and catches up, and
    the cluster converges to exactly-once placement with identical
    stores."""
    ports = [_free_port() for _ in range(3)]
    peers = [("127.0.0.1", p) for p in ports]

    def cfg(i: int) -> ServerConfig:
        return _server_config(
            data_dir=str(tmp_path / f"s{i}"), raft_mode="net",
            rpc_port=ports[i], raft_peers=list(peers),
            num_schedulers=1,
            raft_election_timeout=(0.10, 0.20),
            raft_heartbeat_interval=0.03,
            raft_snapshot_threshold=48)

    servers = {i: Server(cfg(i)) for i in range(3)}
    alive = dict(servers)
    harness = CrashHarness()
    pool = ConnPool()
    stop = threading.Event()
    jobs = [_small_job() for _ in range(24)]
    acked: dict = {}
    rr = [0]

    def addr_fn():
        targets = list(alive.values())
        rr[0] += 1
        return targets[rr[0] % len(targets)].rpc_address()

    def leader_of(pool_servers, timeout=15.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            leaders = [s for s in pool_servers.values()
                       if s.raft.is_leader()]
            if len(leaders) == 1:
                return leaders[0]
            time.sleep(0.02)  # sleep-ok: poll interval of the bounded wait
        raise AssertionError("no single leader")

    def lane(lane_jobs):
        for job in lane_jobs:
            if stop.is_set():
                return
            _submit_retry(pool, addr_fn, "Job.Register",
                          {"job": job.to_dict()}, acked=acked,
                          key=job.id, deadline=120.0)

    try:
        leader_of(alive)
        for i in range(8):
            _submit_retry(pool, addr_fn, "Node.Register",
                          {"node": mock.node(i).to_dict()})
        lanes = [threading.Thread(target=lane, args=(jobs[i::2],),
                                  daemon=True) for i in range(2)]
        for t in lanes:
            t.start()

        for kill in range(3):
            leader = leader_of(alive)
            victim = next(i for i, s in alive.items() if s is leader)
            harness.kill(leader)
            del alive[victim]

            new_leader = leader_of(alive)
            assert new_leader is not leader

            reborn = harness.reboot(cfg(victim))
            alive[victim] = reborn
            canary = mock.node(100 + kill)
            _submit_retry(pool, addr_fn, "Node.Register",
                          {"node": canary.to_dict()})
            wait_until(
                lambda: reborn.fsm.state.node_by_id(canary.id)
                is not None,
                timeout=30, msg=f"reborn s{victim} caught up "
                f"(kill {kill})")

        for t in lanes:
            t.join(150.0)
        assert all(not t.is_alive() for t in lanes)
        assert set(acked) == {j.id for j in jobs}, "lost submissions"

        leader = leader_of(alive)
        wait_until(lambda: _evals_terminal(leader.fsm.state, jobs),
                   timeout=90, msg="storm terminal after 3 kills")
        _assert_exactly_once(leader.fsm.state, jobs)

        def converged():
            prints = {s.fsm.state.fingerprint(changelog_since=10**9)
                      for s in alive.values()}
            return len(prints) == 1
        wait_until(converged, timeout=30, msg="replica convergence")
    finally:
        stop.set()
        pool.shutdown()
        harness.reap(also=list(alive.values()))


def test_freeze_storage_and_reap_leave_no_thread(tmp_path):
    """``CrashHarness.kill`` freezes every store of a NetRaft server and
    abandons it; the husk's data_dir takes no byte more, a reboot over
    it resumes from what was durable, and ``reap`` leaves no thread of
    either server and forgets the husk's fleet generation."""
    from nomad_tpu_torch.models.fleet import fleet_cache

    before = set(threading.enumerate())
    cfg = _server_config(
        data_dir=str(tmp_path / "s"), raft_mode="net", num_schedulers=1,
        raft_election_timeout=(0.05, 0.10), raft_heartbeat_interval=0.02)
    harness = CrashHarness()
    server = Server(cfg)
    reborn = None
    try:
        wait_until(lambda: server.is_leader(), timeout=10,
                   msg="election")
        nodes = [mock.node(i) for i in range(4)]
        for n in nodes:
            server.node_register(n)
        fleet_cache.statics_for(server.fsm.state)
        log_path = str(tmp_path / "s" / "raft" / "log.bin")
        harness.kill(server)
        size = os.path.getsize(log_path)
        with pytest.raises(StorageDead):
            server.raft._log_store.append(99, {"t": 1, "d": b"x"})
        assert os.path.getsize(log_path) == size
        freeze_storage(server.raft)  # idempotent
        reborn = harness.reboot(cfg)
        wait_until(lambda: reborn.is_leader(), timeout=10,
                   msg="re-election")
        wait_until(lambda: all(reborn.fsm.state.node_by_id(n.id)
                               for n in nodes), timeout=10,
                   msg="replay after the kill")
    finally:
        harness.reap(also=[reborn] if reborn is not None else None)
    assert fleet_cache._table(server.fsm.state, "nodes") is not None
    assert id(fleet_cache._table(server.fsm.state, "nodes")) not in \
        fleet_cache._statics
    wait_until(lambda: not [t for t in threading.enumerate()
                            if t not in before and t.is_alive()],
               timeout=10, msg="no thread outlives reap")


# ---------------------------------------------------------------------------
# 4. client crash-reattach
# ---------------------------------------------------------------------------

def _client_rig(tmp_path):
    from nomad_tpu_torch.client.config import ClientConfig

    srv = Server(_server_config(num_schedulers=2, enable_rpc=True))
    srv.establish_leadership()
    cfg = ClientConfig(
        state_dir=str(tmp_path / "client-state"),
        alloc_dir=str(tmp_path / "allocs"),
        servers=[srv.rpc_address()],
        options={"driver.raw_exec.enable": "1",
                 "fingerprint.skip_accel": "1"},
    )
    return srv, cfg


def _run_sleeper(srv, client):
    job = mock.job()
    job.constraints = []
    job.task_groups[0].count = 1
    job.task_groups[0].tasks = [Task(
        name="sleeper", driver="raw_exec",
        config={"command": "/bin/sleep", "args": "300"},
        resources=Resources(cpu=100, memory_mb=32))]
    _, eval_id = srv.job_register(job)
    srv.wait_for_evals([eval_id], timeout=15)

    def task_running():
        for runner in client.alloc_runners.values():
            tr = runner.task_runners.get("sleeper")
            if tr is not None and tr.state == "running":
                return True
        return False
    wait_until(task_running, timeout=20, msg="task running")
    alloc_id = next(iter(client.alloc_runners))
    pid = client.alloc_runners[alloc_id].task_runners["sleeper"].handle.pid
    return job, alloc_id, pid


def test_client_reboot_with_corrupt_alloc_state_reattaches(tmp_path):
    """A client hard-rebooted mid-task with a TORN alloc state file does
    not discard the allocation: it is re-fetched from the server and
    the still-running task re-attached via its handle — same pid."""
    from nomad_tpu_torch.client import Client

    srv, cfg = _client_rig(tmp_path)
    client = Client(cfg)
    client2 = None
    try:
        client.start()
        wait_until(lambda: srv.fsm.state.node_by_id(client.node.id)
                   is not None, msg="node registration")
        _job, alloc_id, pid = _run_sleeper(srv, client)

        client.shutdown()
        state_path = os.path.join(str(tmp_path / "client-state"),
                                  "allocs", alloc_id, "state.json")
        size = os.path.getsize(state_path)
        with open(state_path, "r+b") as fh:
            fh.truncate(size // 2)

        client2 = Client(cfg)
        assert alloc_id not in client2.alloc_runners
        assert alloc_id in client2._recover_alloc_ids
        assert os.path.isdir(os.path.dirname(state_path))
        client2.start()

        def reattached():
            runner = client2.alloc_runners.get(alloc_id)
            if runner is None:
                return False
            tr = runner.task_runners.get("sleeper")
            return tr is not None and tr.state == "running" and \
                tr.handle is not None
        wait_until(reattached, timeout=20, msg="re-attach after reboot")
        tr2 = client2.alloc_runners[alloc_id].task_runners["sleeper"]
        assert tr2.handle.pid == pid
        assert alloc_id not in client2._recover_alloc_ids
    finally:
        if client2 is not None:
            client2.shutdown()
            client2.destroy_all()
        client.destroy_all()
        srv.shutdown()


def test_client_reboot_with_corrupt_state_and_stopped_alloc_reclaims(
        tmp_path):
    """A torn-state alloc the SERVER is done with (job stopped while the
    client was down) is not forgotten: the orphan is re-attached by its
    handle, killed, and both directories reclaimed."""
    from nomad_tpu_torch.client import Client
    from nomad_tpu_torch.client.driver.base import _pid_alive

    srv, cfg = _client_rig(tmp_path)
    client = Client(cfg)
    client2 = None
    try:
        client.start()
        wait_until(lambda: srv.fsm.state.node_by_id(client.node.id)
                   is not None, msg="node registration")
        job, alloc_id, pid = _run_sleeper(srv, client)

        client.shutdown()
        state_dir = os.path.join(str(tmp_path / "client-state"),
                                 "allocs", alloc_id)
        state_path = os.path.join(state_dir, "state.json")
        with open(state_path, "r+b") as fh:
            fh.truncate(os.path.getsize(state_path) // 2)
        _, stop_eval = srv.job_deregister(job.id)
        srv.wait_for_evals([stop_eval], timeout=15)

        client2 = Client(cfg)
        assert alloc_id in client2._recover_alloc_ids
        client2.start()
        alloc_root = client2._alloc_root(alloc_id)

        def reclaimed():
            return (alloc_id not in client2.alloc_runners
                    and not os.path.isdir(state_dir)
                    and not os.path.isdir(alloc_root)
                    and not _pid_alive(pid))
        wait_until(reclaimed, timeout=60,
                   msg="orphan killed and directories reclaimed")
        assert alloc_id not in client2._recover_alloc_ids
    finally:
        if client2 is not None:
            client2.shutdown()
            client2.destroy_all()
        client.destroy_all()
        srv.shutdown()
