"""The port's networked raft against the JAX package's.

Twins of tests/test_raft_net.py on ``nomad_tpu_torch`` servers
(``device="cpu"``): self-election, election and replication over three
servers, follower forwarding, stale follower reads, leader failover with
the new leader's bring-up, durability and compaction across a restart,
last-writer-wins replay, and the storage cases of ``InmemRaft``,
``FileLogStore`` and ``SnapshotStore`` those tests hold.  Where the
result is data it is held against the JAX package on the same input: a
restarted data_dir boots to the store (its digest) a JAX server boots
to from the same directory, and the replayed logs and applied entries
are equal.
Beyond the twins: a JAX ``NetRaft`` and two port ``NetRaft``s elect one
leader between them and replicate each other's writes (the wire is the
same), and a server whose construction fails leaves nothing running.

Every wait on an election or a convergence has its own bound.
"""
from __future__ import annotations

import threading
import time

import msgpack
import pytest

import nomad_tpu_torch.mock as mock
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.server.raft import FileLogStore as JLog
from nomad_tpu.server.raft import InmemRaft as JInmem
from nomad_tpu.server.raft_net import NetRaft as JNetRaft
from nomad_tpu.structs import codec as jcodec
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.raft import (
    FileLogStore,
    InmemRaft,
    SnapshotStore,
    resolve_snapshot_dir,
    unwrap_snapshot,
)
from nomad_tpu_torch.server.raft_net import NOOP_ENTRY as NOOP
from nomad_tpu_torch.server.raft_net import NetRaft
from nomad_tpu_torch.server.rpc import ConnPool, RPCError
from nomad_tpu_torch.structs import Evaluation, codec, generate_uuid

from tests.conftest import wait_until

FAST = dict(
    raft_mode="net",
    raft_election_timeout=(0.05, 0.10),
    raft_heartbeat_interval=0.02,
    num_schedulers=1,
    device="cpu",
    tune_gc=False,
)


def make_cluster(n: int, **kw):
    servers = [Server(ServerConfig(**dict(FAST, **kw))) for _ in range(n)]
    addrs = [s.rpc_address() for s in servers]
    for s in servers:
        for a in addrs:
            s.raft.add_peer(a)
    return servers


def wait_for_leader(servers, timeout=10.0) -> Server:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [s for s in servers if s.raft.is_leader()]
        if len(leaders) == 1 and leaders[0].is_leader():
            return leaders[0]
        time.sleep(0.02)  # sleep-ok: poll interval of the bounded wait
    raise AssertionError("no single leader elected")


def wait_for_stable_leader(servers, timeout=30.0, stable_polls=5):
    """A leader that holds leadership across ``stable_polls``
    consecutive observations (a loaded host can flap leadership between
    single-instant polls)."""
    deadline = time.monotonic() + timeout
    candidate, streak = None, 0
    while time.monotonic() < deadline:
        leaders = [s for s in servers if s.raft.is_leader()]
        if len(leaders) == 1 and leaders[0].is_leader():
            if leaders[0] is candidate:
                streak += 1
                if streak >= stable_polls:
                    return candidate
            else:
                candidate, streak = leaders[0], 1
        else:
            candidate, streak = None, 0
        time.sleep(0.05)  # sleep-ok: poll interval of the bounded wait
    raise AssertionError(f"no stable single leader within {timeout}s")


def shutdown_all(servers) -> None:
    for s in servers:
        try:
            s.shutdown()
        except Exception:
            pass


@pytest.fixture
def pool():
    p = ConnPool()
    yield p
    p.shutdown()


def _call_retry(pool, addr, method, args, timeout=20.0):
    """RPC with retry across leadership churn (the tight timings can
    drop leadership mid-call under host load; real clients retry)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return pool.call(addr, method, args, timeout=10)
        except RPCError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.1)  # sleep-ok: poll interval of the bounded retry


def test_single_node_self_elects():
    s = Server(ServerConfig(**FAST))
    try:
        wait_until(lambda: s.raft.is_leader() and s.is_leader(),
                   timeout=10, msg="self-election")
    finally:
        s.shutdown()


def test_three_node_election_and_replication():
    servers = make_cluster(3)
    try:
        leader = wait_for_leader(servers)
        node = mock.node()
        leader.node_register(node)
        wait_until(
            lambda: all(s.fsm.state.node_by_id(node.id) is not None
                        for s in servers),
            timeout=10, msg="replication to all followers")
    finally:
        shutdown_all(servers)


def test_follower_forwards_writes(pool):
    servers = make_cluster(3)
    try:
        wait_for_leader(servers)
        follower = next(s for s in servers if not s.raft.is_leader())
        for i in range(3):
            _call_retry(pool, follower.rpc_address(), "Node.Register",
                        {"node": mock.node(i).to_dict()})
        job = mock.job()
        job.task_groups[0].count = 3
        out = _call_retry(pool, follower.rpc_address(), "Job.Register",
                          {"job": job.to_dict()})
        assert out["eval_id"]
        wait_until(
            lambda: all(len(s.fsm.state.allocs_by_job(job.id)) == 3
                        for s in servers),
            timeout=30, msg="alloc replication")
    finally:
        shutdown_all(servers)


def test_stale_reads_serve_locally_on_follower(pool):
    """A read with ``stale`` set is answered from the follower's own
    store, never forwarded; without it the read needs the leader."""
    servers = make_cluster(3)
    try:
        leader = wait_for_leader(servers)
        node = mock.node()
        leader.node_register(node)
        follower = next(s for s in servers if not s.raft.is_leader())
        wait_until(lambda: follower.fsm.state.node_by_id(node.id)
                   is not None, timeout=10, msg="replication to follower")

        def boom(*a, **kw):
            raise AssertionError("stale read was forwarded")
        orig_call = follower.conn_pool.call
        follower.conn_pool.call = boom
        try:
            out = pool.call(follower.rpc_address(), "Node.GetNode",
                            {"node_id": node.id, "stale": True},
                            timeout=10)
            assert out["node"]["id"] == node.id
            assert out["known_leader"] is True
            with pytest.raises(RPCError):
                pool.call(follower.rpc_address(), "Node.GetNode",
                          {"node_id": node.id}, timeout=10)
        finally:
            follower.conn_pool.call = orig_call
    finally:
        shutdown_all(servers)


def test_leader_failover():
    """The leader goes; the two survivors elect, the new leader's
    bring-up re-arms every node's heartbeat and restores a committed
    pending eval into its broker, and it makes progress."""
    servers = make_cluster(3)
    try:
        leader = wait_for_leader(servers)
        node = mock.node()
        leader.node_register(node)
        parked_eval = Evaluation(
            id=generate_uuid(), priority=50, type="exotic",
            triggered_by="test", job_id="parked-job", status="pending")
        leader.apply_eval_update([parked_eval])

        survivors = [s for s in servers if s is not leader]
        leader.shutdown()
        for s in survivors:
            s.raft.remove_peer(leader.rpc_address())

        new_leader = wait_for_leader(survivors, timeout=15)
        assert new_leader is not leader
        wait_until(
            lambda: new_leader.fsm.state.node_by_id(node.id) is not None,
            timeout=10, msg="committed entry visible on new leader")
        wait_until(lambda: new_leader.heartbeats.active() >= 1,
                   timeout=10, msg="heartbeat timers re-armed")
        wait_until(
            lambda: any(e.id == parked_eval.id
                        for q in new_leader.eval_broker._ready.values()
                        for *_prio, e in q._heap),
            timeout=10, msg="pending eval restored into the broker")
        node2 = mock.node(2)
        new_leader.node_register(node2)
        wait_until(
            lambda: all(s.fsm.state.node_by_id(node2.id) is not None
                        for s in survivors),
            timeout=10, msg="post-failover replication")
    finally:
        shutdown_all(servers)


def _jax_boot_digest(data_dir, node_ids) -> str:
    """The store a JAX single-node NetRaft server boots to from
    ``data_dir`` once it re-elected and replayed."""
    js = JServer(JServerConfig(
        data_dir=str(data_dir), tune_gc=False,
        **{k: v for k, v in FAST.items() if k not in ("device",
                                                       "tune_gc")}))
    try:
        wait_until(lambda: js.raft.is_leader(), timeout=10,
                   msg="jax re-election")
        wait_until(lambda: all(js.fsm.state.node_by_id(i) is not None
                               for i in node_ids),
                   timeout=10, msg="jax replay")
        return _tables(js)
    finally:
        js.shutdown()


def _tables(srv) -> str:
    """The digest of a server's store: every table and its raft index
    (a boot's leader no-op touches no table)."""
    return srv.fsm.state.fingerprint(changelog_since=10**9)


def test_net_raft_durability(tmp_path):
    """Term/vote metadata and log entries survive a restart, and the
    JAX package boots the same data_dir to the same nodes."""
    cfg = dict(FAST, data_dir=str(tmp_path))
    s = Server(ServerConfig(**cfg))
    try:
        wait_until(lambda: s.raft.is_leader(), timeout=10, msg="election")
        node = mock.node()
        s.node_register(node)
        term_before = s.raft._term
    finally:
        s.shutdown()

    s2 = Server(ServerConfig(**cfg))
    try:
        assert s2.raft._term >= term_before
        wait_until(lambda: s2.raft.is_leader(), timeout=10,
                   msg="re-election")
        wait_until(lambda: s2.fsm.state.node_by_id(node.id) is not None,
                   timeout=10, msg="log replay apply")
        port_nodes = _tables(s2)
    finally:
        s2.shutdown()
    assert _jax_boot_digest(tmp_path, [node.id]) == port_nodes


def test_net_raft_compaction_survives_restart(tmp_path):
    """Log compaction persists the snapshot: a restart after the durable
    log was truncated restores from the snapshot file, and so does the
    JAX package from the same directory."""
    cfg = dict(FAST, data_dir=str(tmp_path), raft_snapshot_threshold=8)
    s = Server(ServerConfig(**cfg))
    nodes = [mock.node(i) for i in range(12)]
    try:
        wait_until(lambda: s.raft.is_leader(), timeout=10, msg="election")
        for n in nodes:
            s.node_register(n)
        wait_until(lambda: s.raft._log_base_index > 0, timeout=10,
                   msg="compaction")
    finally:
        s.shutdown()

    s2 = Server(ServerConfig(**cfg))
    try:
        assert s2.raft._last_applied >= 8
        wait_until(lambda: s2.raft.is_leader(), timeout=10,
                   msg="re-election")
        wait_until(
            lambda: all(s2.fsm.state.node_by_id(n.id) is not None
                        for n in nodes),
            timeout=10, msg="snapshot restore + log tail replay")
        port_nodes = _tables(s2)
    finally:
        s2.shutdown()
    assert _jax_boot_digest(tmp_path, [n.id for n in nodes]) == \
        port_nodes


class _StubRPC:
    address = ("127.0.0.1", 0)

    def register(self, name, fn):
        pass


class _RecordingFSM:
    def __init__(self):
        self.applied = []

    def apply(self, index, data):
        self.applied.append((index, bytes(data)))

    def snapshot(self):
        return b"snap"

    def restore(self, blob):
        pass


def _conflicted_log(path, log_cls):
    store = log_cls(path)
    store.append(1, {"t": 1, "d": b"a"})
    store.append(2, {"t": 1, "d": b"stale"})
    store.append(3, {"t": 1, "d": b"stale2"})
    # Conflict truncation at index 2: leader of term 2 rewrites the suffix.
    store.append(2, {"t": 2, "d": b"B"})
    store.append(3, {"t": 2, "d": b"C"})
    store.append(4, {"t": 2, "d": b"D"})
    store.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_net_raft_replay_is_last_writer_wins(tmp_path, writer):
    """A record re-appended at an existing index marks a follower
    conflict truncation; boot replay takes the LAST record per index,
    in both packages, whichever package wrote the log."""
    (tmp_path / "raft").mkdir()
    _conflicted_log(str(tmp_path / "raft" / "log.bin"),
                    JLog if writer == "jax" else FileLogStore)
    logs = {}
    for name, cls in (("torch", NetRaft), ("jax", JNetRaft)):
        raft = cls(_RecordingFSM(), _StubRPC(), None,
                   election_timeout=(30.0, 60.0), data_dir=str(tmp_path))
        try:
            logs[name] = [(e["index"], e["term"], bytes(e["data"]))
                          for e in raft._log]
        finally:
            raft.shutdown()
    assert logs["torch"] == logs["jax"] == [
        (1, 1, b"a"), (2, 2, b"B"), (3, 2, b"C"), (4, 2, b"D")]


def test_inmem_raft_append_before_apply(tmp_path):
    """Entries are persisted BEFORE the FSM applies them: a failing
    apply consumes its index and leaves a poisoned entry that boot
    replay skips, as in the JAX package."""
    class FSM(_RecordingFSM):
        def apply(self, index, data):
            if data == b"boom":
                raise RuntimeError("bad entry")
            super().apply(index, data)

    replayed = {}
    for name, raft_cls, log_cls in (("torch", InmemRaft, FileLogStore),
                                    ("jax", JInmem, JLog)):
        path = str(tmp_path / f"{name}.bin")
        raft = raft_cls(FSM(), log_cls(path))
        raft.apply(b"one").wait(1)
        bad = raft.apply(b"boom")
        assert bad.error is not None
        raft.apply(b"two").wait(1)
        assert raft.applied_index() == 3
        raft.log_store.close()

        fsm2 = FSM()
        raft2 = raft_cls(fsm2, log_cls(path))
        assert raft2.applied_index() == 3
        raft2.log_store.close()
        replayed[name] = fsm2.applied
    assert replayed["torch"] == replayed["jax"] == [(1, b"one"),
                                                    (3, b"two")]


def test_inmem_raft_disk_failure_rejects_before_apply(tmp_path):
    """A failing durable append rejects the entry with NO state moved:
    the FSM is untouched and the index is not consumed."""
    class FlakyLog(FileLogStore):
        fail = False

        def append(self, index, entry):
            if self.fail:
                raise OSError("disk full")
            super().append(index, entry)

    fsm = _RecordingFSM()
    log = FlakyLog(str(tmp_path / "log.bin"))
    raft = InmemRaft(fsm, log)
    raft.apply(b"one").wait(1)
    log.fail = True
    fut = raft.apply(b"lost")
    assert isinstance(fut.error, OSError)
    assert raft.applied_index() == 1
    assert [d for _, d in fsm.applied] == [b"one"]
    log.fail = False
    raft.apply(b"two").wait(1)
    assert [d for _, d in fsm.applied] == [b"one", b"two"]
    log.close()


def test_log_rewrite_is_atomic_replacement(tmp_path):
    """FileLogStore.rewrite replaces the log via tmp+rename, appends keep
    working afterwards, and the JAX store replays the same records."""
    import os

    path = str(tmp_path / "log.bin")
    log = FileLogStore(path)
    for i in range(1, 6):
        log.append(i, f"e{i}".encode())
    log.rewrite((i, f"e{i}".encode()) for i in (4, 5))
    log.append(6, b"e6")
    log.close()
    assert not os.path.exists(path + ".tmp")
    want = [(4, b"e4"), (5, b"e5"), (6, b"e6")]
    assert [(i, bytes(d)) for i, d in FileLogStore(path).replay()] == want
    assert [(i, bytes(d)) for i, d in JLog(path).replay()] == want


def test_snapshot_legacy_format_and_location(tmp_path):
    """Pre-layout data_dirs restore: bare (unwrapped) snapshot blobs in
    the legacy <data_dir>/snapshots location are found and decoded."""
    data_dir = str(tmp_path)
    legacy = SnapshotStore(f"{data_dir}/snapshots")
    legacy.save(7, b"raw-fsm-blob")

    resolved = resolve_snapshot_dir(data_dir)
    assert resolved == f"{data_dir}/snapshots"
    assert unwrap_snapshot(b"raw-fsm-blob") == (0, b"raw-fsm-blob")

    class FSM(_RecordingFSM):
        restored = None

        def restore(self, blob):
            self.restored = blob

    fsm = FSM()
    raft = InmemRaft(fsm, None, SnapshotStore(resolved))
    assert fsm.restored == b"raw-fsm-blob"
    assert raft.applied_index() == 7

    cur = SnapshotStore(f"{data_dir}/raft/snapshots")
    cur.save(9, msgpack.packb((3, b"new-blob"), use_bin_type=True))
    assert resolve_snapshot_dir(data_dir) == f"{data_dir}/raft/snapshots"
    assert unwrap_snapshot(
        msgpack.packb((3, b"new-blob"), use_bin_type=True)) == \
        (3, b"new-blob")


def test_inmem_replay_last_writer_wins_and_torn_tail(tmp_path):
    """Duplicate indexes replay last-writer-wins; a torn tail record
    ends replay cleanly — in both packages, on the same file."""
    path = str(tmp_path / "log.bin")
    log = FileLogStore(path)
    log.append(1, b"one")
    log.append(2, b"lost-but-landed")
    log.append(2, b"two-retry")
    log.close()
    with open(path, "ab") as fh:
        fh.write((999).to_bytes(4, "big"))
        fh.write(b"partial")

    fsm = _RecordingFSM()
    raft = InmemRaft(fsm, FileLogStore(path))
    assert [(i, bytes(d)) for i, d in fsm.applied] == \
        [(1, b"one"), (2, b"two-retry")]
    assert raft.applied_index() == 2
    raft.log_store.close()
    jfsm = _RecordingFSM()
    jraft = JInmem(jfsm, JLog(path))
    assert jfsm.applied == fsm.applied
    jraft.log_store.close()


def test_a_jax_and_a_port_net_raft_form_one_cluster():
    """One JAX server and two port servers, all ``raft_mode="net"``:
    they vote for each other, elect one leader, and an entry written
    through the leader — whichever package it is — lands in every
    store (the raft RPCs' names and msgpack shapes are the JAX
    package's)."""
    jfast = {k: v for k, v in FAST.items() if k != "device"}
    servers = [JServer(JServerConfig(**dict(jfast, num_schedulers=0))),
               Server(ServerConfig(**dict(FAST, num_schedulers=0))),
               Server(ServerConfig(**dict(FAST, num_schedulers=0)))]
    try:
        addrs = [s.rpc_address() for s in servers]
        for s in servers:
            for a in addrs:
                s.raft.add_peer(a)
        leader = wait_for_stable_leader(servers, timeout=30)
        node = mock.node()
        index = leader.raft_apply(jcodec.NODE_REGISTER_REQUEST,
                                  {"node": node.to_dict()})
        assert index > 0
        wait_until(lambda: all(s.fsm.state.node_by_id(node.id)
                               is not None for s in servers),
                   timeout=15, msg="replication across packages")
        terms = {s.raft._term for s in servers}
        assert len(terms) == 1
        assert codec.NODE_REGISTER_REQUEST == jcodec.NODE_REGISTER_REQUEST
    finally:
        shutdown_all(servers)


def test_a_net_server_whose_construction_fails_leaves_nothing(tmp_path):
    """A taken RPC port fails a ``raft_mode="net"`` boot before any
    raft thread starts; a data_dir with a gap in its committed history
    fails it after the listener bound, and the listener closes."""
    import socket

    before = set(threading.enumerate())
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    try:
        with pytest.raises(OSError):
            Server(ServerConfig(**dict(FAST,
                                       rpc_port=taken.getsockname()[1])))
    finally:
        taken.close()
    from tests.test_torch_crash_recovery import lay_down_gap

    from nomad_tpu_torch.server.raft import CommittedDataLoss

    from nomad_tpu_torch.server.fsm import NomadFSM

    blob = msgpack.packb((1, NomadFSM().snapshot()), use_bin_type=True)
    lay_down_gap(tmp_path, lambda i: {"t": 1, "d": b"entry-%d" % i},
                 blobs=(blob, blob))
    with pytest.raises(CommittedDataLoss):
        Server(ServerConfig(**dict(FAST, data_dir=str(tmp_path))))
    wait_until(lambda: not [t for t in threading.enumerate()
                            if t not in before and t.is_alive()],
               timeout=10, msg="no thread outlives the failed boots")


def test_raft_rpcs_ride_the_dispatch_liveness_lane():
    """Raft's RPCs jump the dispatch queue and its bound, as heartbeats
    do: with the one worker busy and the queue full, a plain call is
    shed while an AppendEntries is taken and served first."""
    from nomad_tpu.server.overload import HEARTBEAT_LANE as J_LANE
    from nomad_tpu_torch.server.overload import HEARTBEAT_LANE
    from nomad_tpu_torch.server.rpc import RPCServer

    assert HEARTBEAT_LANE - J_LANE == {
        "Raft.RequestVote", "Raft.AppendEntries", "Raft.InstallSnapshot"}
    busy, release = threading.Event(), threading.Event()
    order = []

    def block(args):
        busy.set()
        release.wait(10)
        return {}

    def record(name):
        def fn(args):
            order.append(name)
            return {}
        return fn
    srv = RPCServer(dispatch_workers=1, dispatch_queue=1)
    srv.register("Test.Block", block)
    srv.register("Test.Queued", record("queued"))
    srv.register("Test.Shed", record("shed"))
    srv.register("Raft.AppendEntries", record("raft"))
    srv.start()
    pools = [ConnPool() for _ in range(4)]
    out = {}
    try:
        addr = srv.address
        calls = [threading.Thread(target=lambda: pools[0].call(
            addr, "Test.Block", {}, timeout=10))]
        calls[0].start()
        assert busy.wait(10)

        def call(i, method):
            try:
                out[method] = pools[i].call(addr, method, {}, timeout=10)
            except RPCError as e:
                out[method] = e
        for i, method in ((1, "Test.Queued"),):
            calls.append(threading.Thread(target=call, args=(i, method)))
            calls[-1].start()
        wait_until(lambda: srv.stats()["pool"]["depth"] >= 1, timeout=10,
                   msg="the queue holds one call")
        call(2, "Test.Shed")
        assert isinstance(out["Test.Shed"], RPCError)
        calls.append(threading.Thread(target=call,
                                      args=(3, "Raft.AppendEntries")))
        calls[-1].start()
        wait_until(lambda: srv.stats()["pool"]["depth"] >= 2, timeout=10,
                   msg="the raft call queued past the bound")
        release.set()
        for t in calls:
            t.join(10)
        assert out["Raft.AppendEntries"] == {} and out["Test.Queued"] == {}
        assert order == ["raft", "queued"]
    finally:
        release.set()
        for p in pools:
            p.shutdown()
        srv.shutdown()


class _SlowFSM(_RecordingFSM):
    def apply(self, index, data):
        time.sleep(0.05)  # sleep-ok: a slow apply
        super().apply(index, data)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_long_catch_up_leaves_the_election_timer_running(pkg):
    """A follower that takes longer than its election timeout to apply
    a catch-up batch restarts its timer when the exchange ends (the
    reference's follower sets its last contact after storing), so it
    does not start an election the moment the batch is done; the JAX
    follower restarts it on receipt only."""
    cls = NetRaft if pkg == "torch" else JNetRaft
    raft = cls(_SlowFSM(), _StubRPC(), None,
               election_timeout=(0.10, 0.12))
    # The ticker would campaign (and move the deadline) on its own.
    raft._stop.set()
    raft._ticker.join(2)
    try:
        entries = [{"term": 1, "index": i, "data": b"e"}
                   for i in range(1, 7)]
        reply = raft._handle_append_entries({
            "term": 1, "leader": ["127.0.0.1", 4000], "prev_log_index": 0,
            "prev_log_term": 0, "entries": entries, "leader_commit": 6})
        assert reply["success"] and raft._last_applied == 6
        left = raft._election_deadline - time.monotonic()
        if pkg == "torch":
            assert left > 0.05, left
        else:
            assert left < 0, left
    finally:
        raft.shutdown()


def test_a_lagging_follower_catches_up_in_capped_exchanges():
    """The leader sends a follower far behind at most
    ``MAX_APPEND_ENTRIES`` entries an AppendEntries (the reference's
    MaxAppendEntries), so each exchange ends well inside its timeout;
    the JAX leader sends the whole suffix at once."""
    from nomad_tpu_torch.server import raft_net

    servers = make_cluster(2)
    sizes = []
    try:
        leader = wait_for_leader(servers)
        follower = next(s for s in servers if s is not leader)
        handle = follower.raft._handle_append_entries

        def recording(args):
            sizes.append(len(args.get("entries") or []))
            return handle(args)
        follower.rpc_server.register("Raft.AppendEntries", recording)
        follower.raft._stop.set()  # keep it a follower
        with leader.raft._lock:
            peer = follower.rpc_address()
            # As if the follower had missed everything since boot.
            for i in range(200):
                leader.raft.apply(NOOP)
            leader.raft._next_index[peer] = 1
        wait_until(lambda: follower.raft.applied_index()
                   >= leader.raft.applied_index(), timeout=20,
                   msg="the follower caught up")
        assert max(sizes) <= raft_net.MAX_APPEND_ENTRIES
        assert sum(1 for n in sizes if n == raft_net.MAX_APPEND_ENTRIES) \
            >= 3
    finally:
        shutdown_all(servers)


def test_a_returning_peer_hears_from_the_leader_before_it_campaigns():
    """A peer that was down while the leader backed off from it comes
    back (a reboot on its address) and follows without an election of
    its own: the leader's backoff is capped at half the shortest
    election timeout, and the returning server's timer starts only once
    its listener serves."""
    import socket

    ports = []
    for _ in range(3):
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        ports.append(sock.getsockname()[1])
        sock.close()
    peers = [("127.0.0.1", p) for p in ports]
    cfg = [dict(FAST, rpc_port=p, raft_peers=list(peers),
                raft_election_timeout=(0.5, 1.0),
                raft_heartbeat_interval=0.05) for p in ports]
    servers = [Server(ServerConfig(**c)) for c in cfg[:2]]
    try:
        leader = wait_for_stable_leader(servers, timeout=30)
        time.sleep(1.5)  # sleep-ok: backoff grows
        term = leader.raft._term
        node = mock.node()
        leader.node_register(node)
        servers.append(Server(ServerConfig(**cfg[2])))
        wait_until(lambda: servers[2].fsm.state.node_by_id(node.id)
                   is not None, timeout=15, msg="the peer caught up")
        assert servers[2].raft._term == term == leader.raft._term
        assert leader.raft.is_leader()
    finally:
        shutdown_all(servers)
