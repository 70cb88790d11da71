"""The port's raft storage against the JAX package's, on disk.

``FileLogStore`` (CRC-framed records behind a magic header) with a torn
tail: the last record cut short (a power loss mid-append) or one of its
bytes flipped (bit rot), written by either package.  Both packages'
stores must open the file to the same committed prefix — every record
before the damaged one — truncate the damage away, and keep appending
after it.  ``InmemRaft`` on a damaged log boots to the FSM state of that
prefix in both packages, and ``SnapshotStore`` falls back past a corrupt
newest snapshot alike.
"""
from __future__ import annotations

import os

import msgpack
import pytest

import nomad_tpu.mock as jmock
from nomad_tpu.server.fsm import NomadFSM as JFSM
from nomad_tpu.server.raft import FileLogStore as JLog
from nomad_tpu.server.raft import InmemRaft as JRaft
from nomad_tpu.server.raft import SnapshotStore as JSnaps
from nomad_tpu.structs import codec
from nomad_tpu_torch.server.fsm import NomadFSM as TFSM
from nomad_tpu_torch.server.raft import LOG_MAGIC
from nomad_tpu_torch.server.raft import FileLogStore as TLog
from nomad_tpu_torch.server.raft import InmemRaft as TRaft
from nomad_tpu_torch.server.raft import SnapshotStore as TSnaps

LOGS = {"jax": JLog, "torch": TLog}
N = 6


_NODES = [jmock.node(i) for i in range(N)]


def _entries():
    return [codec.encode(codec.NODE_REGISTER_REQUEST,
                         {"node": node.to_dict()}) for node in _NODES]


def _write(path, writer):
    log = LOGS[writer](path)
    for index, entry in enumerate(_entries(), start=1):
        log.append(index, entry)
    log.close()


def _damage(path, mode):
    """Damage the last record: cut it short, or flip one of its bytes."""
    size = os.path.getsize(path)
    last = len(msgpack.packb((N, _entries()[-1]), use_bin_type=True))
    if mode == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(size - last // 2)
    else:
        with open(path, "r+b") as fh:
            fh.seek(size - last // 3)
            byte = fh.read(1)
            fh.seek(size - last // 3)
            fh.write(bytes([byte[0] ^ 0x40]))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_torn_tail_replays_to_the_committed_prefix(tmp_path, writer, mode):
    want = list(enumerate(_entries(), start=1))[:-1]
    for reader in ("jax", "torch"):
        path = str(tmp_path / f"{reader}.bin")
        _write(path, writer)
        _damage(path, mode)
        log = LOGS[reader](path)
        try:
            got = [(i, bytes(e)) for i, e in log.replay()]
            assert got == want, reader
            # the damage was truncated away: a new append lands right
            # after the prefix and replays
            log.append(N, b"again")
            assert [i for i, _e in log.replay()] == list(range(1, N + 1))
        finally:
            log.close()
    with open(str(tmp_path / "jax.bin"), "rb") as a, \
            open(str(tmp_path / "torch.bin"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_raft_boots_to_the_prefix_state_like_jax(tmp_path, mode):
    path = str(tmp_path / "log.bin")
    _write(path, "torch")
    _damage(path, mode)
    jfsm, tfsm = JFSM(), TFSM()
    with open(path, "rb") as fh:
        damaged = fh.read()
    jpath = str(tmp_path / "jax" / "log.bin")
    os.makedirs(os.path.dirname(jpath))
    with open(jpath, "wb") as fh:
        fh.write(damaged)
    jraft, traft = JRaft(jfsm, JLog(jpath)), TRaft(tfsm, TLog(path))
    try:
        assert traft.applied_index() == jraft.applied_index() == N - 1
        assert tfsm.state.fingerprint() == jfsm.state.fingerprint()
        assert len(list(tfsm.state.nodes())) == N - 1
    finally:
        jraft.log_store.close()
        traft.log_store.close()


def test_log_starts_with_the_shared_magic(tmp_path):
    path = str(tmp_path / "log.bin")
    TLog(path).close()
    with open(path, "rb") as fh:
        assert fh.read() == LOG_MAGIC


def test_corrupt_newest_snapshot_falls_back_like_jax(tmp_path):
    """The newest snapshot fails its checksum: both packages' stores
    fall back to the older one."""
    for store_c in (JSnaps, TSnaps):
        d = str(tmp_path / store_c.__module__.split(".")[0])
        store = store_c(d, retain=2)
        store.save(10, b"older")
        newest = store.save(20, b"newer")
        with open(newest, "r+b") as fh:
            fh.seek(-1, os.SEEK_END)
            byte = fh.read(1)
            fh.seek(-1, os.SEEK_END)
            fh.write(bytes([byte[0] ^ 0x01]))
        assert store_c(d, retain=2).latest() == (10, b"older")
