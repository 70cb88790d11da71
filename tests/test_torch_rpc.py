"""The port's RPC plane (server/mux.py, server/rpc.py) against the JAX
package's.

The wire: ``encode_frame``/``send_frame`` give the JAX package's bytes
for the same payloads, and each side's ``recv_frame`` reads the other's.
Both directions on every client plane: the port's ``ConnPool`` calls a
JAX ``RPCServer`` and the JAX ``ConnPool`` calls the port's, over the
multiplexed (0x03) and plain (0x01) planes, each in the clear and
inside TLS (0x04).  Then the port's plane alone: parking and unparking
a request, the dispatch pool's bound and overflow, ``sever``, the
``rpc.send``/``rpc.recv``/``mux.accept``/``conn.read`` fault sites, the
client span of ``trace.client_call``, TLS refusals, and a shutdown that
leaves no thread behind.

TLS and threads: the JAX package reads and writes one SSL socket from
two threads, in its multiplexed session (a reader and a writer thread)
and in its server's TLS stream (the reader and the reply writer).
OpenSSL allows neither: under TLS 1.3 a session ticket that the
session's reader consumes while its writer sends loses a frame, and its
caller waits out the 330 s default call timeout (why the JAX package's
TLS tests fail now and then in a loaded suite), and the server's two
threads once aborted a test worker here.  The port serializes the SSL
calls of its own shared sockets, and its server issues no tickets, so
the JAX package's session runs unpatched against it (jax->port).  Where
a test here runs the JAX package's TLS server (port->jax),
``jax_tls_server_serialized`` puts the port's serialization under that
server's TLS stream alone (its framing, handshake, planes and dispatch
unchanged), so the test holds the wire, not the reference's thread
fault (ROADMAP Queue 3).  Every TLS call carries a timeout, and the
plaintext rejection is checked on raw sockets (the server closes each
after its plane byte).
"""
from __future__ import annotations

import socket
import threading

import msgpack
import pytest

from nomad_tpu.server import mux as jmux
from nomad_tpu.server import rpc as jrpc
from nomad_tpu_torch import faultinject
from nomad_tpu_torch.obs import trace
from nomad_tpu_torch.server import mux, rpc
from nomad_tpu_torch.server.rpc import (
    ConnPool,
    MuxConn,
    RPCError,
    RPCServer,
    client_tls_context,
    server_tls_context,
)
from tests.conftest import wait_until

PAYLOADS = [
    {},
    {"seq": 1, "method": "Status.Ping", "args": {}},
    {"seq": 7, "error": None, "result": {"allocs": [{"id": "a" * 36}]}},
    {"seq": 2**40, "method": "Node.Register",
     "args": {"node": {"id": "n", "attributes": {"kernel.name": "linux"},
                       "resources": {"cpu": 4000, "memory_mb": 8192}},
              "_deadline": 2.5, "blob": b"\x00\x01\xff"}},
    {"seq": 3, "error": "overloaded: server dispatch queue full",
     "result": None, "nested": [[1, 2.5, -3], {"k": True}]},
]


@pytest.mark.parametrize("payload", PAYLOADS)
def test_encode_frame_gives_the_jax_bytes(payload):
    assert mux.encode_frame(payload) == jmux.encode_frame(payload)


@pytest.mark.parametrize("payload", PAYLOADS[1:4])
def test_send_frame_bytes_and_recv_frame_cross(payload):
    for send, recv in ((rpc.send_frame, jrpc.recv_frame),
                       (jrpc.send_frame, rpc.recv_frame)):
        a, b = socket.socketpair()
        try:
            send(a, payload)
            a.shutdown(socket.SHUT_WR)
            raw = b.recv(1 << 20)
            assert raw == jmux.encode_frame(payload)
            c, d = socket.socketpair()
            try:
                c.sendall(raw)
                c.shutdown(socket.SHUT_WR)
                assert recv(d) == msgpack.unpackb(
                    msgpack.packb(payload, use_bin_type=True), raw=False)
                assert recv(d) is None
            finally:
                c.close()
                d.close()
        finally:
            a.close()
            b.close()


# ---------------------------------------------------------------------------
# both directions, every plane
# ---------------------------------------------------------------------------

def _echo_server(server_cls, tls=None, **kw):
    srv = server_cls(tls_context=tls, **kw)
    srv.register("Echo.Hello", lambda args: {"hi": args.get("x"),
                                             "keys": sorted(args)})
    srv.register("Echo.Fail", lambda args: 1 / 0)
    srv.start()
    return srv


@pytest.fixture
def jax_tls_server_serialized(monkeypatch):
    """Serialize the SSL calls of the JAX package's server TLS stream
    (a reader and a reply writer on one SSL socket) with the port's
    wrapper."""
    serve = jrpc.RPCServer._serve_tls_stream

    def serialized_stream(self, sock):
        return serve(self, rpc._SerialTLS(sock))
    monkeypatch.setattr(jrpc.RPCServer, "_serve_tls_stream",
                        serialized_stream)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    from tests.test_rpc import _make_cert

    return _make_cert(tmp_path_factory.mktemp("certs"))


@pytest.mark.parametrize("plane", ["mux", "plain", "tls-mux", "tls-plain"])
@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_calls_cross_between_the_packages(direction, plane, certs,
                                          request):
    cert, key = certs
    if direction == "port->jax":
        srv_mod, pool_mod = jrpc, rpc
        request.getfixturevalue("jax_tls_server_serialized")
    else:
        srv_mod, pool_mod = rpc, jrpc
    tls = plane.startswith("tls")
    srv = _echo_server(srv_mod.RPCServer,
                       srv_mod.server_tls_context(cert, key) if tls else None)
    pool = pool_mod.ConnPool(
        tls_context=pool_mod.client_tls_context(ca_file=cert) if tls
        else None,
        server_hostname="localhost", multiplex=plane.endswith("mux"))
    try:
        for i in range(4):
            out = pool.call(srv.address, "Echo.Hello", {"x": i}, timeout=10)
            # the transport timeout rides as the deadline envelope
            assert out == {"hi": i, "keys": ["_deadline", "x"]}
        with pytest.raises(pool_mod.RPCError, match="division by zero"):
            pool.call(srv.address, "Echo.Fail", {}, timeout=10)
        with pytest.raises(pool_mod.RPCError, match="unknown method"):
            pool.call(srv.address, "No.Such", {}, timeout=10)
        if tls:
            assert srv.stats()["tls_conns"] >= 1
    finally:
        pool.shutdown()
        srv.shutdown()


def test_async_mux_calls_cross_to_a_jax_server():
    srv = _echo_server(jrpc.RPCServer)
    conn = MuxConn(tuple(srv.address))
    got = {}
    done = threading.Event()

    def cb(i):
        def on_done(result, exc):
            got[i] = (result, exc)
            if len(got) == 16:
                done.set()
        return on_done
    try:
        for i in range(16):
            assert conn.call_async("Echo.Hello", {"x": i}, cb(i)) is not None
        assert done.wait(10)
        assert {i: r["hi"] for i, (r, e) in got.items()} == \
            {i: i for i in range(16)}
        assert all(e is None for _r, e in got.values())
    finally:
        conn.close()
        srv.shutdown()


# ---------------------------------------------------------------------------
# parking, the dispatch pool, sever
# ---------------------------------------------------------------------------

def test_a_parked_request_frees_its_worker_until_resumed():
    srv = RPCServer(dispatch_workers=1)
    resumes = []

    def wait_handler(args):
        if "_watch_fired" in args:
            return {"fired": args["_watch_fired"]}

        def subscribe(resume):
            resumes.append(resume)
            return lambda: None
        raise mux.Parked(subscribe)
    srv.register("W.Wait", wait_handler)
    srv.register("W.Ping", lambda args: {})
    srv.start()
    pool = ConnPool()
    out = {}
    t = threading.Thread(target=lambda: out.update(
        pool.call(srv.address, "W.Wait", {}, timeout=10)))
    try:
        t.start()
        wait_until(lambda: srv._loop.parked_requests() == 1,
                   msg="request parked")
        # the one worker is free while the request is parked
        assert pool.call(srv.address, "W.Ping", {}, timeout=10) == {}
        resumes[0](False)
        t.join(10)
        assert out == {"fired": "change"}
        assert srv._loop.parked_requests() == 0
    finally:
        t.join(10)
        pool.shutdown()
        srv.shutdown()


def test_dispatch_pool_bound_sheds_and_overflows_a_blocked_worker():
    pool = mux.DispatchPool(workers=1, max_queue=1, name="t-port-pool")
    release = threading.Event()
    done = []
    pool.start()
    try:
        def long_op():
            with mux.blocking_section():
                release.wait(10)
        assert pool.submit(long_op)
        wait_until(lambda: pool.stats()["blocked"] == 1,
                   msg="worker in a blocking section")
        assert pool.submit(lambda: done.append(1))
        wait_until(lambda: done == [1], msg="overflow worker ran it")
        assert pool.stats()["overflow_spawns"] >= 1
        release.set()
        wait_until(lambda: pool.stats()["overflow"] == 0,
                   msg="overflow worker exited")
    finally:
        release.set()
        pool.shutdown()
    assert all(not t.is_alive() for t in pool._threads)


def test_sever_drops_every_connection_and_shutdown_joins():
    before = set(threading.enumerate())
    srv = _echo_server(RPCServer)
    conn = MuxConn(tuple(srv.address))
    try:
        assert conn.call("Echo.Hello", {"x": 1}, timeout=10)["hi"] == 1
        srv.sever()
        wait_until(lambda: conn.broken, msg="client saw the sever")
        with pytest.raises(ConnectionError):
            conn.call("Echo.Hello", {"x": 2}, timeout=10)
    finally:
        conn.close()
        srv.shutdown()
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    assert left == []


@pytest.mark.parametrize("multiplex", [True, False])
def test_a_shut_down_pool_refuses_calls_and_opens_nothing(multiplex):
    """A call after ``ConnPool.shutdown`` raises ``ConnectionError`` and
    dials nothing, so no connection outlives the pool (the JAX pool
    dials a fresh one that nothing closes)."""
    srv = _echo_server(RPCServer)
    pool = ConnPool(multiplex=multiplex)
    try:
        assert pool.call(srv.address, "Echo.Hello", {"x": 1},
                         timeout=10)["hi"] == 1
        pool.shutdown()
        with pytest.raises(ConnectionError, match="shut down"):
            pool.call(srv.address, "Echo.Hello", {"x": 2}, timeout=10)
        assert pool._sessions == {} and pool._pools == {}
        wait_until(lambda: srv.stats()["loop"]["open_conns"] == 0,
                   msg="the pool's connection closed")
    finally:
        pool.shutdown()
        srv.shutdown()


def test_a_session_dialed_across_shutdown_is_closed(monkeypatch):
    """A thread that dials while another shuts the pool down (a client
    thread mid-call as its client stops): its fresh session is closed
    and its call raises, so the server sees no connection left."""
    srv = _echo_server(RPCServer)
    pool = ConnPool()
    dialing, shut = threading.Event(), threading.Event()
    real = rpc.MuxConn

    def slow_dial(*a, **kw):
        conn = real(*a, **kw)
        dialing.set()
        shut.wait(10)
        return conn
    monkeypatch.setattr(rpc, "MuxConn", slow_dial)
    errors = []

    def call():
        try:
            pool.call(srv.address, "Echo.Hello", {"x": 1}, timeout=10)
        except ConnectionError as e:
            errors.append(e)
    caller = threading.Thread(target=call)
    try:
        caller.start()
        assert dialing.wait(10)
        pool.shutdown()
        shut.set()
        caller.join(10)
        assert len(errors) == 1 and pool._sessions == {}
        wait_until(lambda: srv.stats()["loop"]["open_conns"] == 0,
                   msg="the dialed session closed")
    finally:
        shut.set()
        caller.join(10)
        srv.shutdown()


def test_server_stats_have_the_jax_keys():
    tsrv, jsrv = _echo_server(RPCServer), _echo_server(jrpc.RPCServer)
    try:
        ts, js = tsrv.stats(), jsrv.stats()
        assert sorted(ts) == sorted(js)
        assert sorted(ts["loop"]) == sorted(js["loop"])
        assert sorted(ts["pool"]) == sorted(js["pool"])
    finally:
        tsrv.shutdown()
        jsrv.shutdown()


# ---------------------------------------------------------------------------
# fault sites and the client span
# ---------------------------------------------------------------------------

def test_rpc_send_drop_never_leaves_the_client():
    srv = _echo_server(RPCServer)
    pool = ConnPool()
    plan = faultinject.FaultPlan(seed=1).add("rpc.send", "drop", count=1,
                                             method="Echo.Hello")
    try:
        with faultinject.injected(plan):
            with pytest.raises(ConnectionError):
                pool.call(srv.address, "Echo.Hello", {"x": 1}, timeout=5)
            assert pool.call(srv.address, "Echo.Hello", {"x": 2},
                             timeout=5)["hi"] == 2
        assert plan.fire_count("rpc.send") == 1
        assert srv.stats()["pool"]["dispatched"] == 1
    finally:
        pool.shutdown()
        srv.shutdown()


def test_rpc_recv_drop_gets_no_reply_and_error_gets_one():
    srv = _echo_server(RPCServer)
    pool = ConnPool()
    plan = (faultinject.FaultPlan(seed=1)
            .add("rpc.recv", "drop", count=1, method="Echo.Hello")
            .add("rpc.recv", "error", count=1, method="Echo.Fail"))
    try:
        with faultinject.injected(plan):
            with pytest.raises(TimeoutError):
                pool.call(srv.address, "Echo.Hello", {"x": 1}, timeout=0.5)
            with pytest.raises(RPCError):
                pool.call(srv.address, "Echo.Fail", {}, timeout=5)
            assert pool.call(srv.address, "Echo.Hello", {"x": 3},
                             timeout=5)["hi"] == 3
        assert plan.fire_count("rpc.recv") == 2
    finally:
        pool.shutdown()
        srv.shutdown()


def test_mux_accept_error_refuses_one_connection():
    srv = _echo_server(RPCServer)
    plan = faultinject.FaultPlan(seed=1).add("mux.accept", "error",
                                             count=1)
    try:
        with faultinject.injected(plan):
            with pytest.raises((ConnectionError, OSError, TimeoutError)):
                c = MuxConn(tuple(srv.address))
                try:
                    c.call("Echo.Hello", {}, timeout=2)
                finally:
                    c.close()
            assert plan.fire_count("mux.accept") == 1
        assert srv._loop.stats()["accept_faults"] == 1
        c2 = MuxConn(tuple(srv.address))
        assert c2.call("Echo.Hello", {"x": 5}, timeout=5)["hi"] == 5
        c2.close()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("action", ["error", "drop"])
def test_conn_read_fault_severs_or_stalls_the_connection(action):
    srv = _echo_server(RPCServer, read_deadline=0.3)
    plan = faultinject.FaultPlan(seed=1).add("conn.read", action, count=1)
    try:
        with faultinject.injected(plan):
            sess = MuxConn(tuple(srv.address))
            with pytest.raises((ConnectionError, OSError, TimeoutError)):
                sess.call("Echo.Hello", {}, timeout=1.0)
            assert plan.fire_count("conn.read") == 1
            wait_until(lambda: sess.broken, timeout=10,
                       msg="the faulted connection closed")
            sess.close()
        stats = srv._loop.stats()
        assert stats["read_faults"] == 1
        key = "closed_error" if action == "error" else "closed_deadline"
        assert stats[key] >= 1
    finally:
        srv.shutdown()


def test_client_call_records_one_client_span_and_ships_the_envelope():
    srv = RPCServer()
    seen = []
    srv.register("T.Env", lambda args: seen.append(
        trace.extract(args)) or {})
    srv.start()
    pool = ConnPool()
    try:
        with trace.tracing(seed=4) as t:
            with t.span("outer") as outer:
                pool.call(srv.address, "T.Env", {}, timeout=5)
            spans = {s["name"]: s for s in t.snapshot()}
        client = spans["rpc.client.T.Env"]
        assert client["parent_id"] == outer["span_id"]
        assert seen == [{"trace_id": outer["trace_id"],
                         "span_id": client["span_id"]}]
    finally:
        pool.shutdown()
        srv.shutdown()


# ---------------------------------------------------------------------------
# TLS refusals
# ---------------------------------------------------------------------------

def test_tls_is_refused_without_a_server_context():
    srv = _echo_server(RPCServer)
    pool = ConnPool(tls_context=client_tls_context())
    try:
        with pytest.raises((ConnectionError, OSError)):
            pool.call(srv.address, "Echo.Hello", {}, timeout=2)
    finally:
        pool.shutdown()
        srv.shutdown()


def test_tls_sessions_survive_post_handshake_tickets(
        certs, jax_tls_server_serialized):
    """Repeated fresh TLS mux sessions of the port's client against the
    JAX package's server, which sends TLS 1.3 session tickets after each
    handshake: a session whose reader consumes them while its writer
    sends loses the frame (the JAX package's own session does).  The
    port's session serializes its SSL calls and gets every reply; the
    port's server sends no tickets."""
    cert, key = certs
    assert server_tls_context(cert, key).num_tickets == 0
    assert jrpc.server_tls_context(cert, key).num_tickets > 0
    srv = _echo_server(jrpc.RPCServer, jrpc.server_tls_context(cert, key))
    try:
        for i in range(40):
            pool = ConnPool(
                tls_context=client_tls_context(ca_file=cert),
                server_hostname="localhost")
            try:
                assert pool.call(srv.address, "Echo.Hello", {"x": i},
                                 timeout=10)["hi"] == i
            finally:
                pool.shutdown()
    finally:
        srv.shutdown()


def test_jax_tls_sessions_run_unpatched_against_the_port(certs):
    """Repeated fresh TLS mux sessions of the JAX package's own client,
    unpatched, against the port's server: with no session ticket after
    the handshake nothing reaches the session's reader while its writer
    sends, and every call gets its reply."""
    cert, key = certs
    srv = _echo_server(RPCServer, server_tls_context(cert, key))
    try:
        for i in range(40):
            pool = jrpc.ConnPool(
                tls_context=jrpc.client_tls_context(ca_file=cert),
                server_hostname="localhost")
            try:
                assert pool.call(srv.address, "Echo.Hello", {"x": i},
                                 timeout=10)["hi"] == i
                assert srv.stats()["tls_conns"] >= 1
            finally:
                pool.shutdown()
    finally:
        srv.shutdown()


@pytest.fixture
def high_descriptors():
    """Hold every descriptor below 1,100 so the test's sockets get
    numbers past ``select``'s limit of 1,024."""
    import os
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < 4096:
        resource.setrlimit(resource.RLIMIT_NOFILE, (min(4096, hard), hard))
    held: list = []
    try:
        while not held or held[-1] < 1100:
            held.append(os.open(os.devnull, os.O_RDONLY))
        yield
    finally:
        for fd in held:
            os.close(fd)
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))


@pytest.mark.parametrize("multiplex", [True, False])
def test_tls_calls_on_descriptors_past_1024(certs, high_descriptors,
                                            multiplex):
    """A TLS session whose socket numbers pass 1,024 waits in poll, so
    the calls of a process holding many connections still get their
    replies, on the server's TLS stream and the client's session."""
    cert, key = certs
    probe = socket.socket()
    assert probe.fileno() >= 1024
    probe.close()
    srv = _echo_server(RPCServer, server_tls_context(cert, key))
    pool = ConnPool(tls_context=client_tls_context(ca_file=cert),
                    server_hostname="localhost", multiplex=multiplex)
    try:
        for i in range(8):
            assert pool.call(srv.address, "Echo.Hello", {"x": i},
                             timeout=10)["hi"] == i
        assert srv.stats()["tls_conns"] >= 1
    finally:
        pool.shutdown()
        srv.shutdown()


def test_require_tls_rejects_plaintext(certs):
    cert, key = certs
    srv = _echo_server(RPCServer, server_tls_context(cert, key),
                       require_tls=True)
    tls_pool = ConnPool(tls_context=client_tls_context(ca_file=cert),
                        server_hostname="localhost")
    try:
        assert tls_pool.call(srv.address, "Echo.Hello", {"x": 1},
                             timeout=10)["hi"] == 1
        closed_before = srv._loop.stats()["closed_error"]
        for plane in (jrpc.RPC_MUX, jrpc.RPC_NOMAD):
            raw = socket.create_connection(tuple(srv.address), timeout=10)
            try:
                raw.sendall(bytes([plane]))
                # the server closes it after the plane byte: EOF or a
                # reset, never a reply
                try:
                    assert raw.recv(64) == b""
                except ConnectionResetError:
                    pass
            finally:
                raw.close()
        wait_until(lambda: srv._loop.stats()["closed_error"] >=
                   closed_before + 2, msg="both plaintext planes refused")
        assert srv.stats()["pool"]["dispatched"] == 1
    finally:
        tls_pool.shutdown()
        srv.shutdown()
