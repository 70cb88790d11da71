"""The port's server as a whole against the JAX package's server.

A JAX ``Server`` and a port ``Server(ServerConfig(device="cpu"))`` run
the same deterministic setup: the same nodes and jobs registered
through raft before leadership, so leadership's broker restore enqueues
every pending eval at once and ONE ``BatchWorker`` (``device_batch`` >=
jobs) dequeues them in one batch and fuses them into one K4 launch (its
plain version here: the tensors lie on the CPU); then a ``system`` job,
which a plain worker runs.  The JAX side runs under
``mesh_override("off")`` and ``executor_override("device")``, the port
under its own ``executor_override("device")``, as
tests/test_torch_batch.py runs the storms.  The workers start only
after ``random`` is seeded and the broker is enabled (a server built
with ``num_schedulers=0``, its workers set up after leadership), so no
worker's backoff jitter draws from ``random`` between the seed and the
finish that draws each plan's dynamic ports.  Placements must be equal
node for node and port for port, by alloc name.

Also: a ``device=None`` server raises without a card and starts no
thread; every key of an unported plane raises ``ValueError``, while
``enable_rpc`` opens a listener and each TLS file loads into the RPC
plane's contexts; a typo'd
``$NOMAD_TPU_EXECUTOR`` fails the boot; a ``data_dir`` server restarts
from its log (and its snapshot) to an equal store, in either package;
``use_device_scheduler=False`` runs the sequential schedulers; shutdown
joins every thread the server started.
"""
from __future__ import annotations

import contextlib
import random
import threading

import numpy as np
import pytest
import torch

import nomad_tpu.mock as jmock
from nomad_tpu.parallel.mesh import mesh_override
from nomad_tpu.scheduler.executor import executor_override as j_executor
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu_torch import convert
from nomad_tpu_torch.scheduler.executor import ExecutorPolicyError
from nomad_tpu_torch.scheduler.executor import executor_override as \
    t_executor
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.worker import BatchWorker, Worker
from nomad_tpu_torch.structs import allocs_fit

torch.set_num_threads(1)

WAIT_S = 60.0


def _service_job(count, cpu=None):
    j = jmock.job()
    j.task_groups[0].count = count
    if cpu is not None:
        j.task_groups[0].tasks[0].resources.cpu = cpu
    return j


def _batch_job(count):
    j = jmock.job()
    j.type = "batch"
    j.task_groups[0].count = count
    return j


def _sized_nodes(n, seed):
    rng = np.random.default_rng(seed)
    nodes = [jmock.node(i) for i in range(n)]
    for node in nodes:
        node.resources.cpu = int(rng.integers(2000, 6000))
        node.resources.memory_mb = int(rng.integers(4096, 12288))
    return nodes


def _storm_jobs():
    """tests/test_torch_batch.py's mixed storm: service and batch jobs
    that all fit (no conflicts, so the applier's window split cannot
    change a verdict)."""
    return [_service_job(4), _batch_job(3), _service_job(2, cpu=900),
            _batch_job(5), _service_job(4), _batch_job(1)]


@contextlib.contextmanager
def _seeded(seed):
    saved = random.getstate()
    random.seed(seed)
    try:
        yield
    finally:
        random.setstate(saved)


def _placements(srv):
    """(job, alloc name, node id, reserved ports) of every live alloc,
    sorted (a system job's allocs share one name, one a node), and each
    eval's status."""
    state = srv.fsm.state
    placed = sorted((a.job_id, a.name, a.node_id, tuple(
        p for tr in a.task_resources.values() for n in tr.networks
        for p in n.reserved_ports))
        for a in state.allocs() if not a.terminal_status())
    return placed, sorted(e.status for e in state.evals())


def _drive(srv, nodes, jobs, system_job):
    """Register, take leadership, start the workers, run the storm, then
    the system job; returns the eval ids."""
    for n in nodes:
        srv.node_register(n)
    ids = [srv.job_register(j)[1] for j in jobs]
    srv.establish_leadership()
    with _seeded(11):
        srv.config.num_schedulers = 2
        srv._setup_workers()
        srv.wait_for_evals(ids, timeout=WAIT_S)
    with _seeded(12):
        ids.append(srv.job_register(system_job)[1])
        srv.wait_for_evals(ids, timeout=WAIT_S)
    return ids


def _run_jax(nodes, jobs, system_job):
    srv = JServer(JServerConfig(num_schedulers=0, tune_gc=False))
    try:
        with mesh_override("off"), j_executor("device"):
            _drive(srv, nodes, jobs, system_job)
        return _placements(srv), srv.plan_applier.stats()
    finally:
        srv.shutdown()


def _port_server(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("tune_gc", False)
    return Server(ServerConfig(**kw))


def _run_port(nodes, jobs, system_job):
    srv = _port_server(num_schedulers=0)
    try:
        with t_executor("device"):
            _drive(srv, convert.nodes_from_reference(nodes),
                   convert.jobs_from_reference(jobs),
                   convert.jobs_from_reference([system_job])[0])
        assert isinstance(srv.workers[0], BatchWorker)
        assert [type(w) for w in srv.workers[1:]] == [Worker]
        assert srv._worker_stats()["failures"] == 0
        for node in srv.fsm.state.nodes():
            live = [a for a in srv.fsm.state.allocs_by_node(node.id)
                    if not a.terminal_status()]
            fit, dim, _ = allocs_fit(node, live)
            assert fit, f"node {node.id} oversubscribed on {dim}"
        return _placements(srv), srv.plan_applier.stats()
    finally:
        srv.shutdown()


def test_server_places_like_the_jax_server():
    nodes = _sized_nodes(16, 1)
    jobs = _storm_jobs()
    system_job = jmock.system_job()
    (j_placed, j_status), j_stats = _run_jax(nodes, jobs, system_job)
    (t_placed, t_status), t_stats = _run_port(nodes, jobs, system_job)
    assert t_placed == j_placed
    assert t_status == j_status == ["complete"] * 7
    system = [p for p in t_placed if p[0] == system_job.id]
    assert len(t_placed) - len(system) == 19
    # at most one system alloc a node; those the storm left room on
    assert 0 < len(system) == len({p[2] for p in system}) <= len(nodes)
    # the storm's six plans, then the system scheduler's
    assert t_stats["plans_committed"] == j_stats["plans_committed"] > 6


def test_server_without_a_device_raises_and_starts_nothing(monkeypatch):
    """``device=None`` means ``cuda``: without a card the constructor
    raises before any thread starts (no fallback to the CPU or to the
    sequential schedulers)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(ServerConfig(tune_gc=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(ServerConfig(device="cuda", use_device_scheduler=False,
                            tune_gc=False))
    assert set(threading.enumerate()) <= before


@pytest.mark.parametrize("key,value", [
    ("raft_mode", "net"), ("control_enabled", True)])
def test_unported_planes_raise(key, value):
    before = set(threading.enumerate())
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 3"):
        _port_server(**{key: value})
    assert set(threading.enumerate()) <= before


def _joined_after(before, srv):
    srv.shutdown()
    return [t for t in threading.enumerate()
            if t not in before and t.is_alive()]


def test_enable_rpc_opens_a_listener_that_answers_ping():
    from nomad_tpu_torch.server.rpc import ConnPool

    before = set(threading.enumerate())
    srv = _port_server(num_schedulers=0, enable_rpc=True)
    pool = ConnPool()
    try:
        host, port = srv.rpc_address()
        assert port > 0
        assert pool.call((host, port), "Status.Ping", {}, timeout=10) == {}
        assert srv.obs_registry.providers().count("rpc") == 1
    finally:
        pool.shutdown()
    assert _joined_after(before, srv) == []


def test_a_failed_construction_leaves_no_serving_thread(monkeypatch):
    """The listener starts after every component a handler reaches:
    a construction step that raises leaves no loop or dispatch thread
    behind."""
    from nomad_tpu_torch.server import server as server_mod

    def broken(*a, **kw):
        raise RuntimeError("worker construction failed")
    monkeypatch.setattr(server_mod.Server, "_setup_workers", broken)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="worker construction failed"):
        _port_server(num_schedulers=0, enable_rpc=True)
    assert [t.name for t in threading.enumerate()
            if t not in before and t.name.startswith("rpc-")] == []


def _sockets() -> set:
    """This process's open sockets, by inode."""
    import os

    out = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            link = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if link.startswith("socket:"):
            out.add(link)
    return out


@pytest.mark.parametrize("workers", [0, 2])
def test_a_taken_gossip_port_leaves_nothing_running(workers):
    """Gossip binds its port after the applier, the RPC listener and the
    workers exist: when that port is taken the constructor raises and
    stops them all, and closes the listener."""
    import socket

    held = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    held.bind(("127.0.0.1", 0))
    try:
        before = set(threading.enumerate())
        socks = _sockets()
        with pytest.raises(OSError):
            _port_server(num_schedulers=workers, enable_rpc=True,
                         enable_gossip=True,
                         gossip_port=held.getsockname()[1])
        assert [t.name for t in threading.enumerate()
                if t not in before and t.is_alive()] == []
        assert _sockets() - socks == set()
    finally:
        held.close()


def test_without_enable_rpc_no_listener_opens():
    srv = _port_server(num_schedulers=0)
    try:
        assert srv.rpc_server is None and srv.rpc_address() is None
        assert "rpc" not in srv.obs_registry.providers()
    finally:
        srv.shutdown()


def test_tls_cert_and_key_load_into_the_server_context(tmp_path):
    import ssl

    from nomad_tpu_torch.server.rpc import ConnPool, client_tls_context
    from tests.test_rpc import _make_cert

    cert, key = _make_cert(tmp_path)
    srv = _port_server(num_schedulers=0, enable_rpc=True,
                       tls_cert_file=cert, tls_key_file=key)
    pool = ConnPool(tls_context=client_tls_context(ca_file=cert),
                    server_hostname="localhost")
    try:
        server_ctx = srv.rpc_server._tls_context
        assert isinstance(server_ctx, ssl.SSLContext)
        # without a CA file the server verifies no client
        assert server_ctx.verify_mode == ssl.CERT_NONE
        # the cert the server presents is the one loaded
        assert pool.call(srv.rpc_address(), "Status.Ping", {},
                         timeout=10) == {}
    finally:
        pool.shutdown()
        srv.shutdown()


def test_tls_key_file_that_does_not_match_fails_the_boot(tmp_path):
    import ssl

    from tests.test_rpc import _make_cert

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    cert, _key = _make_cert(tmp_path / "a")
    _cert, other_key = _make_cert(tmp_path / "b")
    before = set(threading.enumerate())
    with pytest.raises(ssl.SSLError):
        _port_server(num_schedulers=0, enable_rpc=True,
                     tls_cert_file=cert, tls_key_file=other_key)
    assert set(threading.enumerate()) <= before


def test_tls_ca_file_loads_into_both_contexts(tmp_path):
    import ssl

    from tests.test_rpc import _make_cert

    cert, key = _make_cert(tmp_path)
    srv = _port_server(num_schedulers=0, enable_rpc=True,
                       tls_cert_file=cert, tls_key_file=key,
                       tls_ca_file=cert, tls_verify_client=True)
    try:
        server_ctx = srv.rpc_server._tls_context
        client_ctx = srv.conn_pool.tls_context
        assert server_ctx.verify_mode == ssl.CERT_REQUIRED
        assert server_ctx.cert_store_stats()["x509"] == 1
        # the server's own pools dial with the client context
        assert client_ctx.verify_mode == ssl.CERT_REQUIRED
        assert client_ctx.cert_store_stats()["x509"] == 1
        assert srv.raft_pool.tls_context is client_ctx
    finally:
        srv.shutdown()


def test_unknown_config_key_raises_like_jax():
    with pytest.raises(TypeError):
        ServerConfig(no_such_key=1)
    with pytest.raises(TypeError):
        JServerConfig(no_such_key=1)


def test_boot_validates_the_executor_policy(monkeypatch):
    """A typo'd ``$NOMAD_TPU_EXECUTOR`` (the JAX package's variable)
    fails the boot, as the JAX server's does; so does a bad
    ``executor`` config value."""
    monkeypatch.setenv("NOMAD_TPU_EXECUTOR", "gpu")
    with pytest.raises(ExecutorPolicyError):
        _port_server(num_schedulers=0)
    monkeypatch.delenv("NOMAD_TPU_EXECUTOR")
    with pytest.raises(ExecutorPolicyError):
        _port_server(num_schedulers=0, executor="tpu")


def _data_dir_world(srv, n_nodes=8):
    nodes = convert.nodes_from_reference(
        [jmock.node(i) for i in range(n_nodes)])
    for n in nodes:
        srv.node_register(n)
    srv.establish_leadership()
    jobs = convert.jobs_from_reference(
        [_service_job(3), _batch_job(2), _service_job(2)])
    ids = [srv.job_register(j)[1] for j in jobs]
    srv.wait_for_evals(ids, timeout=WAIT_S)
    srv.node_update_drain(nodes[0].id, True)  # node-update evals
    srv.job_deregister(jobs[2].id)
    srv.wait_for_evals([e.id for e in srv.fsm.state.evals()],
                       timeout=WAIT_S)


@pytest.mark.parametrize("threshold", [8192, 16])
def test_data_dir_restart_replays_to_an_equal_store(tmp_path, threshold):
    """A ``data_dir`` server restarts from its raft log (and, past the
    snapshot threshold, from its newest snapshot plus the log's tail)
    to a store that digests equal; the JAX server boots from the same
    data_dir to the same store (one on-disk format)."""
    with t_executor("device"):
        srv = _port_server(data_dir=str(tmp_path), num_schedulers=2,
                           raft_snapshot_threshold=threshold)
        try:
            _data_dir_world(srv)
            want = srv.fsm.state.fingerprint(changelog_since=10**9)
            applied = srv.raft.applied_index()
        finally:
            srv.shutdown()
    again = _port_server(data_dir=str(tmp_path), num_schedulers=0,
                         raft_snapshot_threshold=threshold)
    try:
        assert again.raft.applied_index() == applied
        assert again.fsm.state.fingerprint(changelog_since=10**9) == want
    finally:
        again.shutdown()
    jax_srv = JServer(JServerConfig(data_dir=str(tmp_path),
                                    num_schedulers=0, tune_gc=False,
                                    raft_snapshot_threshold=threshold))
    try:
        assert jax_srv.raft.applied_index() == applied
        assert jax_srv.fsm.state.fingerprint(changelog_since=10**9) == want
    finally:
        jax_srv.shutdown()


def test_sequential_schedulers_by_choice():
    """``use_device_scheduler=False`` keeps the JAX meaning: plain
    workers running the sequential service/batch schedulers."""
    srv = _port_server(num_schedulers=2, use_device_scheduler=False)
    try:
        assert [type(w) for w in srv.workers] == [Worker, Worker]
        nodes = convert.nodes_from_reference(
            [jmock.node(i) for i in range(6)])
        for n in nodes:
            srv.node_register(n)
        srv.establish_leadership()
        jobs = convert.jobs_from_reference([_service_job(3),
                                            _batch_job(2)])
        ids = [srv.job_register(j)[1] for j in jobs]
        assert sorted(srv.wait_for_evals(ids, timeout=WAIT_S).values()) \
            == ["complete", "complete"]
        assert len([a for a in srv.fsm.state.allocs()
                    if not a.terminal_status()]) == 5
    finally:
        srv.shutdown()


def test_shutdown_joins_every_thread_it_started():
    before = set(threading.enumerate())
    with t_executor("device"):
        srv = _port_server(num_schedulers=2)
        try:
            _data_dir_world(srv)
            # a heartbeat arms the heartbeat manager's TTL wheel
            assert srv.node_heartbeat(
                next(iter(srv.fsm.state.nodes())).id) > 0
        finally:
            srv.shutdown()
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    assert left == []


def test_worker_failure_is_recorded_and_nacked(monkeypatch):
    """A failing fused dispatch (a kernel that cannot build, launch or
    fetch raises the same way) is nacked and recorded on the worker;
    past the delivery limit the eval ends ``failed`` — nothing moves the
    work to another executor."""
    from nomad_tpu_torch.scheduler import batch

    def boom(self, pending):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(batch.BatchEvalRunner, "_dispatch_fused", boom)
    with t_executor("device"):
        srv = _port_server(num_schedulers=1, eval_delivery_limit=2)
        try:
            for i in range(4):
                srv.node_register(convert.nodes_from_reference(
                    [jmock.node(i)])[0])
            srv.establish_leadership()
            (job,) = convert.jobs_from_reference([_service_job(2)])
            _, eid = srv.job_register(job)
            assert srv.wait_for_evals([eid], timeout=WAIT_S) == \
                {eid: "failed"}
            stats = srv._worker_stats()
            assert stats["failures"] == 2
            assert "kernel launch failed" in str(srv.workers[0].last_error)
            assert not list(srv.fsm.state.allocs())
        finally:
            srv.shutdown()
