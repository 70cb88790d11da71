"""msgpack-RPC transport: event-driven TCP listener with 1-byte demux.

Capability parity with reference nomad/rpc.go:20-158 + nomad/pool.go:
the server's single TCP port serves multiple planes, demuxed by the first
byte of each connection (0x01 nomad RPC, 0x02 raft hand-off, 0x03
multiplexed RPC, 0x04 TLS — the TLS byte wraps the stream and re-demuxes
the inner byte, exactly the reference's recursive handleConn at
rpc.go:73-117); RPC frames are length-prefixed msgpack maps.

The 0x03 plane is the yamux equivalent: many logical request/response
streams share one connection per peer, identified by ``seq``, with
replies written as handlers finish (out of order), so long blocking
queries never monopolize a connection.  ConnPool defaults to one mux
session per peer; the 0x01 plane (one in-flight request per pooled
connection) remains for simple clients.

Serving is event-driven (server/mux.py): ONE selector thread owns every
plaintext client socket and a bounded dispatch pool runs the handlers,
so server resource usage is O(worker pools), not O(connected clients) —
blocking queries park as watch-fan-out callbacks (``mux.Parked``), a
stalled or slowloris client is reaped on a read deadline without ever
touching a worker, and overflow (connection cap, dispatch queue) is
shed with ``overloaded:`` errors the retry layer already classifies.
The raft (0x02) and TLS (0x04) planes hand their sockets to dedicated
threads — blocking I/O, O(peers) — because raft owns its socket
wholesale and ``ssl`` wants a blocking handshake; TLS'd requests still
ride the shared dispatch pool and can park.

Frame format (both directions): 4-byte big-endian length + msgpack body.
Request body:  {"seq": int, "method": "Service.Method", "args": {...}}
Response body: {"seq": int, "error": str|None, "result": {...}}

Counterpart of ``nomad_tpu/server/rpc.py``, on the same wire: either
package's ``ConnPool`` calls the other's ``RPCServer`` on every plane.
Two differences, both on TLS: a TLS socket that a reader thread and a
writer thread share has its SSL calls serialized (``_SerialTLS``), and
the server's TLS context issues no session tickets.
"""
from __future__ import annotations

import logging
import queue
import select
import socket
import ssl
import struct
import threading
from typing import Callable, Optional

import msgpack

from nomad_tpu_torch import faultinject
from nomad_tpu_torch.obs import trace as trace_mod
from nomad_tpu_torch.utils.retry import OVERLOADED_MARKER
from nomad_tpu_torch.utils.sync import Immutable

from . import mux as mux_mod
from .mux import DispatchPool, EdgeLoop, Parked, encode_frame  # noqa: F401

logger = logging.getLogger("nomad_tpu_torch.server.rpc")

RPC_NOMAD = 0x01
RPC_RAFT = 0x02
RPC_MUX = 0x03   # multiplexed: concurrent requests, out-of-order replies
RPC_TLS = 0x04

MAX_FRAME = 128 * 1024 * 1024

# The dispatch-plane liveness lane (front of the queue, never shed at
# the dispatch bound) is THE SAME lane as the admission controller's:
# one source of truth, or adding a liveness method to one layer would
# silently strand it in the other.
from .overload import HEARTBEAT_LANE as _LIVENESS_METHODS  # noqa: E402


def server_tls_context(cert_file: str, key_file: str,
                       ca_file: Optional[str] = None,
                       verify_client: bool = False) -> ssl.SSLContext:
    """Server-side TLS context for the RPC plane.

    It issues no TLS 1.3 session tickets: no client of this plane
    resumes a session (every dial is a fresh handshake), and a ticket
    arrives after the handshake, where a client that reads and writes
    one SSL socket from two threads (the JAX package's multiplexed
    session) can lose a frame to it (see _SerialTLS)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.num_tickets = 0
    ctx.load_cert_chain(cert_file, key_file)
    if ca_file:
        ctx.load_verify_locations(ca_file)
    if verify_client:
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_tls_context(ca_file: Optional[str] = None,
                       cert_file: Optional[str] = None,
                       key_file: Optional[str] = None,
                       check_hostname: bool = True) -> ssl.SSLContext:
    """Client-side TLS context; verifies the server against ca_file (or
    skips verification entirely when none is given — dev mode).  With
    ``check_hostname=False`` the peer cert chain is still verified
    against the CA but no name is matched — the mode for inter-server
    dials addressed by raw IP when no tls_server_name is configured."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if ca_file:
        ctx.check_hostname = check_hostname
        ctx.load_verify_locations(ca_file)
    else:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    if cert_file:
        ctx.load_cert_chain(cert_file, key_file)
    return ctx


def send_frame(sock: socket.socket, obj) -> None:
    body = msgpack.packb(obj, use_bin_type=True)
    sock.sendall(struct.pack(">I", len(body)) + body)


def recv_frame(sock: socket.socket):
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    length = struct.unpack(">I", head)[0]
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    body = _recv_exact(sock, length)
    if body is None:
        return None
    return msgpack.unpackb(body, raw=False, strict_map_key=False)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class _SerialTLS:
    """A TLS socket shared by one reader thread and writer threads, with
    every OpenSSL call on it serialized under one lock.

    An SSL object is not safe for concurrent use.  The JAX package's
    multiplexed session reads on one thread and writes on another over
    the same SSL socket: under TLS 1.3 the server sends its session
    tickets after the handshake, the reader consumes them inside
    SSL_read while the writer is inside SSL_write, and a frame is lost
    — the caller then waits out its whole call timeout.  Here the socket
    is non-blocking and no thread holds the lock while it waits: each
    call tries the SSL operation under the lock and, when OpenSSL wants
    the socket readable or writable, releases the lock and waits in
    ``poll`` for that (not ``select``, which refuses a descriptor of
    1,024 or more, and a server holds many more connections)."""

    def __init__(self, sock: ssl.SSLSocket) -> None:
        self._sock = sock
        self._lock = threading.Lock()
        sock.setblocking(False)

    def settimeout(self, timeout) -> None:
        if timeout is not None:
            raise ValueError("a serialized TLS socket blocks without "
                             "a timeout; callers time out on events")

    def _wait(self, want_read: bool) -> None:
        fd = self._sock.fileno()
        if fd < 0:
            raise ConnectionError("TLS socket closed")
        poller = select.poll()
        poller.register(fd, select.POLLIN if want_read else select.POLLOUT)
        for _, events in poller.poll():
            if events & select.POLLNVAL:
                raise ConnectionError("TLS socket closed")

    def recv(self, n: int) -> bytes:
        while True:
            with self._lock:
                try:
                    # faultlint-ok(uninjectable-io): the TLS session's
                    # serialized read (non-blocking, the wait is in
                    # _wait); the framed reads above it consult
                    # rpc.recv once the stream reaches _execute.
                    return self._sock.recv(n)
                except ssl.SSLWantReadError:
                    want_read = True
                except ssl.SSLWantWriteError:
                    want_read = False
            self._wait(want_read)

    def sendall(self, data: bytes) -> None:
        view = memoryview(data)
        while view:
            with self._lock:
                try:
                    view = view[self._sock.send(view):]
                    continue
                except ssl.SSLWantWriteError:
                    want_read = False
                except ssl.SSLWantReadError:
                    want_read = True
            self._wait(want_read)

    def shutdown(self, how: int) -> None:
        # The raw socket's shutdown (not SSLSocket.shutdown, which drops
        # the SSL object under a concurrent reader): it wakes the
        # reader's poll with EOF.
        socket.socket.shutdown(self._sock, how)

    def close(self) -> None:
        with self._lock:
            self._sock.close()


class _LoopSink:
    """Reply channel for requests that arrived on the event loop."""

    __slots__ = ("loop", "conn")

    def __init__(self, loop: EdgeLoop, conn) -> None:
        self.loop = loop
        self.conn = conn

    def reply(self, payload: dict) -> None:
        self.loop.send(self.conn, encode_frame(payload))

    def done(self) -> None:
        self.loop.request_done(self.conn)

    def park(self, rec: dict) -> None:
        self.loop.park(self.conn, rec)

    def unpark(self, rec: dict) -> None:
        self.loop.unpark(self.conn, rec)


class _ThreadSink:
    """Reply channel for TLS-plane connections (thread-served reader).

    Replies ride a dedicated writer thread fed by an unbounded queue —
    no lock is held across a socket send, and out-of-order replies
    (parked long-polls resuming) interleave safely with fresh ones.
    Parked records are cleaned up when the reader sees EOF, so a dead
    TLS client deregisters its waiters exactly like a loop connection.
    """

    def __init__(self, sock) -> None:
        self.sock = sock
        self._outq: queue.Queue = queue.Queue()
        self._plock = threading.Lock()
        self._parked: dict = {}
        self._closed = False
        self._writer = threading.Thread(target=self._write_loop,
                                        daemon=True,
                                        name="rpc-tls-writer")
        self._writer.start()

    def _write_loop(self) -> None:
        while True:
            payload = self._outq.get()
            if payload is None:
                return
            try:
                send_frame(self.sock, payload)
            except (ConnectionError, OSError, ssl.SSLError):
                pass  # peer gone; the reader notices on its next recv

    def reply(self, payload: dict) -> None:
        self._outq.put(payload)

    def done(self) -> None:
        pass

    def park(self, rec: dict) -> None:
        with self._plock:
            if not self._closed and not rec.get("done"):
                self._parked[id(rec)] = rec
                return
        EdgeLoop._unsub(rec)

    def unpark(self, rec: dict) -> None:
        with self._plock:
            self._parked.pop(id(rec), None)

    def close(self) -> None:
        """Reader EOF: deregister parked waiters, stop the writer."""
        with self._plock:
            self._closed = True
            recs = list(self._parked.values())
            self._parked.clear()
        for rec in recs:
            EdgeLoop._unsub(rec)
        self._outq.put(None)
        if self._writer is not threading.current_thread():
            self._writer.join(2.0)


class RPCServer:
    """Event-driven TCP listener demuxing nomad-RPC, raft and TLS streams.

    One selector thread (``rpc-loop``) owns every plaintext client
    socket; a bounded ``DispatchPool`` runs the handlers; blocking
    queries park as watch-fan-out callbacks instead of pinning workers.
    Public surface (register/register_service/set_raft_handler/start/
    shutdown/address) is unchanged from the threaded implementation.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 tls_context: Optional[ssl.SSLContext] = None,
                 require_tls: bool = False,
                 dispatch_workers: int = mux_mod.DISPATCH_WORKERS,
                 dispatch_queue: int = mux_mod.DISPATCH_QUEUE,
                 max_conns: int = mux_mod.MAX_CONNS,
                 idle_timeout: float = mux_mod.IDLE_TIMEOUT,
                 read_deadline: float = mux_mod.READ_DEADLINE) -> None:
        self._handlers: dict = {}        # "Service.Method" -> callable
        self._raft_handler: Optional[Callable] = None
        self._tls_context = tls_context
        self._require_tls = require_tls and tls_context is not None
        self._lock = threading.Lock()
        self._handoffs: set = set()      # raft/TLS threads; guarded
        self._handoff_socks: set = set()  # their raw sockets; guarded
        self._tls_sinks: set = set()     # live TLS reply sinks; guarded
        self.dispatch_sheds = 0          # queue-full rejections; guarded
        self.handoff_sheds = 0           # over-cap handoffs; guarded
        self._read_deadline = read_deadline

        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((host, port))
        listener.listen(512)
        listener.setblocking(False)
        self.address = listener.getsockname()  # (host, port)

        # Port-qualified thread names: in multi-server processes
        # (tests, benches, crash soaks) every serving thread is
        # attributable to its server, and a census of ONE server's
        # threads can't count another's (or a dead husk's).
        self._pool = DispatchPool(dispatch_workers, dispatch_queue,
                                  name=f"rpc-dispatch:{self.address[1]}")
        self._loop = EdgeLoop(listener, self, max_conns=max_conns,
                              idle_timeout=idle_timeout,
                              read_deadline=read_deadline,
                              name=f"rpc-loop:{self.address[1]}")
        self._thread: Optional[threading.Thread] = None

    # -- registration -----------------------------------------------------
    def register(self, method: str, handler: Callable) -> None:
        self._handlers[method] = handler

    def register_service(self, name: str, obj) -> None:
        """Register every public method of obj as ``Name.method``."""
        for attr in dir(obj):
            if attr.startswith("_"):
                continue
            fn = getattr(obj, attr)
            if callable(fn):
                self._handlers[f"{name}.{attr}"] = fn

    def set_raft_handler(self, handler: Callable) -> None:
        self._raft_handler = handler

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._pool.start()
        self._loop.start()
        self._thread = self._loop._thread

    def sever(self) -> None:
        """Crash-simulation teardown (Server.abandon): signal stop and
        sever every socket the way a dead process's OS would, joining
        NOTHING — in-flight handlers die against reset sockets on
        their own time.  The suite-hygiene joins happen later when
        CrashHarness.reap() runs the graceful shutdown()."""
        self._loop.sever()
        self._pool.sever()
        with self._lock:
            sinks = list(self._tls_sinks)
            socks = list(self._handoff_socks)
        for sink in sinks:
            try:
                sink.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def shutdown(self) -> None:
        # Loop teardown severs every client socket (parked waiters
        # deregister via each connection's close path), then the pool
        # drains, then the raft/TLS threads get reaped.
        self._loop.shutdown()
        self._pool.shutdown()
        with self._lock:
            sinks = list(self._tls_sinks)
            handoffs = list(self._handoffs)
            socks = list(self._handoff_socks)
        for sink in sinks:
            try:
                sink.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for sock in socks:
            # Sever mid-handshake/raft handoff sockets too, or their
            # threads would outlive the join below.
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in handoffs:
            if t is not threading.current_thread():
                t.join(2.0)

    def stats(self) -> dict:
        out = {"loop": self._loop.stats(), "pool": self._pool.stats()}
        with self._lock:
            out["dispatch_sheds"] = self.dispatch_sheds
            out["tls_conns"] = len(self._tls_sinks)
        return out

    # -- EdgeLoop protocol --------------------------------------------------
    def shed_payload(self) -> bytes:
        return encode_frame({
            "seq": 0,
            "error": f"{OVERLOADED_MARKER} connection limit reached",
            "result": None})

    def on_plane(self, conn, byte: int) -> str:
        if byte == RPC_TLS:
            if self._tls_context is None:
                logger.warning("TLS connection attempted but no TLS "
                               "configured")
                return "reject"
            return "handoff"
        if self._require_tls:
            # TLS-required listeners reject plaintext planes outright:
            # encryption/mTLS must not be bypassable on the same port.
            logger.warning("rejecting non-TLS connection (%#x): TLS "
                           "required", byte)
            return "reject"
        if byte in (RPC_NOMAD, RPC_MUX):
            return "stream"
        if byte == RPC_RAFT:
            return "handoff" if self._raft_handler is not None \
                else "reject"
        logger.warning("unrecognized RPC byte: %#x", byte)
        return "reject"

    def on_frame(self, conn, obj) -> bool:
        if not isinstance(obj, dict):
            # Malformed frame: this peer doesn't speak the protocol;
            # drop the connection rather than guess at a reply seq.
            logger.warning("dropping connection: non-dict RPC frame "
                           "(%s)", type(obj).__name__)
            return False
        sink = _LoopSink(self._loop, conn)
        # The dispatch-plane liveness lane: heartbeats jump the queue
        # AND its bound — shedding (or queueing) liveness during a
        # long-poll wake storm would cause the TTL-expiry spiral the
        # overload plane exists to prevent (overload.HEARTBEAT_LANE is
        # the same lane one layer up).
        front = obj.get("method") in _LIVENESS_METHODS
        if not self._pool.submit(lambda: self._execute(sink, obj),
                                 front=front):
            # Dispatch queue full: shed with an explicit overloaded:
            # error — one queue check and a pre-decoded frame, vs
            # accepting work the pool cannot start.
            with self._lock:
                self.dispatch_sheds += 1
            self._loop.send(conn, encode_frame({
                "seq": obj.get("seq", 0),
                "error": f"{OVERLOADED_MARKER} server dispatch queue "
                         f"full",
                "result": None}))
            return True
        conn.pending += 1
        return True

    # Raft/TLS handoff threads are O(peers) by design; this cap makes
    # it a guarantee — an attacker looping "send 0x04, stall" must not
    # mint unbounded threads past the event loop's max_conns cap.
    MAX_HANDOFFS = 128

    def handoff(self, sock: socket.socket, byte: int) -> None:
        with self._lock:
            if len(self._handoffs) >= self.MAX_HANDOFFS:
                self.handoff_sheds += 1
                over = True
            else:
                over = False
        if over:
            try:
                sock.close()
            except OSError:
                pass
            return
        t = threading.Thread(target=self._serve_handoff,
                             args=(sock, byte), daemon=True,
                             name="rpc-handoff")
        with self._lock:
            self._handoffs.add(t)
            self._handoff_socks.add(sock)
        t.start()

    # -- raft / TLS planes (thread-served, O(peers)) -----------------------
    def _serve_handoff(self, sock: socket.socket, byte: int) -> None:
        try:
            if byte == RPC_RAFT:
                if self._raft_handler is not None:
                    self._raft_handler(sock)
                return
            # TLS: blocking handshake, then the inner plane byte rides
            # encrypted (reference rpc.go:73-117; no nested TLS).  The
            # handshake + inner byte are read-deadline-bounded — a
            # client that sends 0x04 and stalls costs this thread at
            # most read_deadline, same as a plaintext slowloris.
            sock.settimeout(self._read_deadline)
            wrapped = self._tls_context.wrap_socket(sock,
                                                    server_side=True)
            # faultlint-ok(uninjectable-io): TLS handoff lane; framed
            # reads consult rpc.recv once the stream reaches _execute,
            # and the handshake is read-deadline-bounded above.
            inner = wrapped.recv(1)
            if not inner:
                return
            wrapped.settimeout(None)  # established sessions may idle
            if inner[0] == RPC_RAFT:
                if self._raft_handler is not None:
                    self._raft_handler(wrapped)
            elif inner[0] in (RPC_NOMAD, RPC_MUX):
                # Reader here, replies on the sink's writer thread: one
                # SSL socket, two threads (see _SerialTLS).
                self._serve_tls_stream(_SerialTLS(wrapped))
            else:
                logger.warning("unrecognized RPC byte inside TLS: %#x",
                               inner[0])
        except (ConnectionError, OSError, ssl.SSLError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass
            with self._lock:
                self._handoffs.discard(threading.current_thread())
                self._handoff_socks.discard(sock)

    def _serve_tls_stream(self, sock) -> None:
        """Frame loop for one TLS connection: the reader blocks here
        (one thread per TLS peer), but requests still run on the shared
        dispatch pool and blocking queries still park — no per-request
        threads, no parked workers."""
        sink = _ThreadSink(sock)
        with self._lock:
            self._tls_sinks.add(sink)
        try:
            while True:
                req = recv_frame(sock)
                if req is None:
                    return
                if not isinstance(req, dict):
                    logger.warning("dropping TLS connection: non-dict "
                                   "frame (%s)", type(req).__name__)
                    return
                if not self._pool.submit(
                        lambda r=req: self._execute(sink, r),
                        front=req.get("method") in _LIVENESS_METHODS):
                    with self._lock:
                        self.dispatch_sheds += 1
                    sink.reply({
                        "seq": req.get("seq", 0),
                        "error": f"{OVERLOADED_MARKER} server dispatch "
                                 f"queue full",
                        "result": None})
        finally:
            with self._lock:
                self._tls_sinks.discard(sink)
            sink.close()

    # -- request execution -------------------------------------------------
    def _execute(self, sink, req: dict, resumed: bool = False) -> None:
        """Run one request on a dispatch worker and answer through
        ``sink``.  A handler that would block raises ``Parked`` and the
        request resumes — through this same path, ``resumed=True`` —
        when the watch fan-out matures or times out."""
        seq = req.get("seq", 0)
        method = req.get("method", "")
        args = req.get("args") or {}
        if faultinject.ACTIVE and not resumed:
            try:
                faultinject.fire_rpc("rpc.recv", method, args)
            except faultinject.FaultDropped:
                # Injected lost frame: no reply at all — the caller
                # sees only its own timeout, like wire loss.
                sink.done()
                return
            except Exception as e:
                sink.reply({"seq": seq, "error": str(e), "result": None})
                sink.done()
                return
        handler = self._handlers.get(method)
        if handler is None:
            sink.reply({"seq": seq,
                        "error": f"unknown method {method!r}",
                        "result": None})
            sink.done()
            return
        try:
            with mux_mod.parkable():
                result = handler(args)
        except Parked as parked:
            self._park(sink, req, parked)
            return
        except Exception as e:  # error surface mirrors net/rpc
            logger.debug("rpc %s failed: %s", method, e)
            sink.reply({"seq": seq, "error": str(e), "result": None})
            sink.done()
            return
        sink.reply({"seq": seq, "error": None, "result": result})
        sink.done()

    def _park(self, sink, req: dict, parked: Parked) -> None:
        """Park one request: register the resume callback with the
        handler's watch subscription and free the worker.  The record
        lives on the connection so a dead client deregisters it."""
        rec: dict = {"done": False, "unsub": None}
        lock = threading.Lock()

        def resume(timed_out: bool) -> None:
            with lock:
                if rec["done"]:
                    return
                rec["done"] = True
            args = req.get("args")
            if isinstance(args, dict):
                args["_watch_fired"] = "timeout" if timed_out \
                    else "change"
            sink.unpark(rec)
            if not self._pool.submit(
                    lambda: self._execute(sink, req, resumed=True),
                    urgent=True):
                sink.done()  # pool stopped: shutdown owns cleanup

        try:
            unsub = parked.subscribe(resume)
        except Exception as e:
            sink.reply({"seq": req.get("seq", 0), "error": str(e),
                        "result": None})
            sink.done()
            return
        with lock:
            if not rec["done"]:
                rec["unsub"] = unsub
        sink.park(rec)


class RPCError(Exception):
    pass


class _SendError(ConnectionError):
    """The request never left this host (stale pooled conn) — safe to
    retry on a fresh connection even for non-idempotent writes."""


DEFAULT_CALL_TIMEOUT = 330.0  # > blocking-query max


def _dial(address: tuple, plane: int,
          tls_context: Optional[ssl.SSLContext] = None,
          server_hostname: str = "",
          connect_timeout: float = 330.0) -> socket.socket:
    """Connect and select a plane: optional outer TLS byte in the clear,
    handshake, then the inner plane byte rides encrypted (reference
    rpc.go:73-117)."""
    sock = socket.create_connection(address, timeout=connect_timeout)
    try:
        # Frames are small and latency-sensitive (heartbeats, votes):
        # never wait out Nagle + delayed-ACK.
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    if tls_context is not None:
        sock.sendall(bytes([RPC_TLS]))
        sock = tls_context.wrap_socket(
            sock,
            server_hostname=server_hostname or address[0]
            if tls_context.check_hostname else None)
    sock.sendall(bytes([plane]))
    return sock


class _PooledConn:
    def __init__(self, address: tuple,
                 tls_context: Optional[ssl.SSLContext] = None,
                 server_hostname: str = "") -> None:
        self.sock: Immutable = _dial(address, RPC_NOMAD, tls_context,
                                     server_hostname)
        self.lock = threading.Lock()
        self.seq = 0

    def call(self, method: str, args: dict, timeout: Optional[float] = None):
        with self.lock:
            self.seq += 1
            # Always (re)set: a previous caller's short timeout must not
            # stick to the pooled connection.
            self.sock.settimeout(timeout if timeout is not None
                                 else DEFAULT_CALL_TIMEOUT)
            try:
                send_frame(self.sock, {"seq": self.seq, "method": method,
                                       "args": args})
            except (ConnectionError, OSError) as e:
                raise _SendError(str(e)) from e
            resp = recv_frame(self.sock)
        if resp is None:
            raise ConnectionError("connection closed by server")
        if resp.get("error"):
            raise RPCError(resp["error"])
        return resp.get("result")

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class MuxConn:
    """One multiplexed connection: concurrent callers share the socket,
    a reader thread routes replies to waiters by ``seq`` (the client
    half of the 0x03 plane — the reference's yamux session).

    Writes ride ONE writer thread fed by an unbounded queue: no lock is
    ever held across a socket send (a slow/large frame stalls only the
    writer, never reply delivery or other callers' enqueues), and a
    frame the writer fails to put on the wire answers its own waiter
    with ``_SendError`` — "never left this host", safe to retry — while
    marking the session broken for everyone after it."""

    def __init__(self, address: tuple,
                 tls_context: Optional[ssl.SSLContext] = None,
                 server_hostname: str = "",
                 connect_timeout: float = 330.0) -> None:
        sock = _dial(address, RPC_MUX, tls_context, server_hostname,
                     connect_timeout=connect_timeout)
        if isinstance(sock, ssl.SSLSocket):
            # A reader and a writer thread share it (see _SerialTLS).
            sock = _SerialTLS(sock)
        self.sock: Immutable = sock
        self.sock.settimeout(None)  # reader blocks; callers use events
        self._lock = threading.Lock()    # waiter table + seq + broken
        self._seq = 0
        self._waiters: dict = {}   # seq -> [event, resp, exc] | {"cb": fn}
        self._broken: Optional[Exception] = None
        self._outq: queue.Queue = queue.Queue()  # (seq, payload) | None
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True, name="rpc-mux-read")
        self._reader.start()
        self._writer = threading.Thread(target=self._write_loop,
                                        daemon=True,
                                        name="rpc-mux-write")
        self._writer.start()

    def _write_loop(self) -> None:
        while True:
            item = self._outq.get()
            if item is None:
                return
            seq, payload = item
            try:
                send_frame(self.sock, payload)
            except (ConnectionError, OSError, ssl.SSLError) as e:
                self._send_failed(seq, e)

    def _send_failed(self, seq: int, e: Exception) -> None:
        err = _SendError(str(e))
        with self._lock:
            if self._broken is None:
                self._broken = err
            waiter = self._waiters.pop(seq, None)
        if waiter is None:
            return
        if isinstance(waiter, list):
            waiter[2] = err
            waiter[0].set()
        else:
            self._finish_async(waiter, None, err)

    def _read_loop(self) -> None:
        err: Exception = ConnectionError("connection closed by server")
        try:
            while True:
                resp = recv_frame(self.sock)
                if resp is None:
                    break
                with self._lock:
                    waiter = self._waiters.pop(resp.get("seq"), None)
                if waiter is None:
                    continue
                if isinstance(waiter, list):   # sync caller
                    waiter[1] = resp
                    waiter[0].set()
                else:                          # async callback waiter
                    e = resp.get("error")
                    self._finish_async(
                        waiter, resp.get("result"),
                        RPCError(e) if e else None)
        except (ConnectionError, OSError, ValueError) as e:
            err = e
        with self._lock:
            self._broken = err
            waiters, self._waiters = list(self._waiters.values()), {}
        for waiter in waiters:
            if isinstance(waiter, list):
                waiter[0].set()
            else:
                self._finish_async(waiter, None, ConnectionError(str(err)))

    @staticmethod
    def _finish_async(waiter: dict, result, exc) -> None:
        try:
            waiter["cb"](result, exc)
        except Exception:
            logger.exception("async rpc callback failed")

    def call_async(self, method: str, args: dict,
                   on_done: Callable) -> Optional[int]:
        """Fire one request without blocking: ``on_done(result, exc)``
        runs exactly once — on the reader thread when the reply lands,
        on the writer thread when the send fails, or on the canceller's
        thread via :meth:`cancel_async`.  No per-call Event or timer is
        allocated; callers multiplexing many in-flight requests (the
        agent swarm) arm timeouts for the returned seq on their own TTL
        wheel.  Returns None when the session is already broken
        (``on_done`` already ran with the error)."""
        with self._lock:
            if self._broken is not None:
                err: Optional[Exception] = _SendError(str(self._broken))
                seq = None
            else:
                self._seq += 1
                seq = self._seq
                self._waiters[seq] = {"cb": on_done}
                err = None
        if err is not None:
            self._finish_async({"cb": on_done}, None, err)
            return None
        self._outq.put((seq, {"seq": seq, "method": method,
                              "args": args}))
        return seq

    def cancel_async(self, seq: int, exc: Optional[Exception] = None
                     ) -> bool:
        """Abandon an async call (its timeout expired): the callback
        runs with ``exc`` unless the reply already won the race."""
        with self._lock:
            waiter = self._waiters.pop(seq, None)
        if waiter is None or isinstance(waiter, list):
            return False
        self._finish_async(waiter, None,
                           exc or TimeoutError(f"rpc seq {seq} timed out"))
        return True

    def call(self, method: str, args: dict,
             timeout: Optional[float] = None):
        waiter = [threading.Event(), None, None]  # [event, resp, exc]
        # seq allocation + waiter registration under the state lock;
        # the actual send rides the writer thread — a slow/large send
        # must not block the reader from delivering other streams'
        # completed responses, nor other callers from enqueueing
        # (head-of-line liveness: raft heartbeats share sessions with
        # bulk transfers).
        with self._lock:
            if self._broken is not None:
                raise _SendError(str(self._broken))
            self._seq += 1
            seq = self._seq
            self._waiters[seq] = waiter
        self._outq.put((seq, {"seq": seq, "method": method,
                              "args": args}))
        if not waiter[0].wait(timeout if timeout is not None
                              else DEFAULT_CALL_TIMEOUT):
            with self._lock:
                self._waiters.pop(seq, None)
            raise TimeoutError(f"rpc {method} timed out")
        if waiter[2] is not None:  # the writer couldn't send it
            raise waiter[2]
        resp = waiter[1]
        if resp is None:  # reader died
            with self._lock:
                err = self._broken
            raise ConnectionError(str(err))
        if resp.get("error"):
            raise RPCError(resp["error"])
        return resp.get("result")

    @property
    def broken(self) -> bool:
        with self._lock:
            return self._broken is not None

    def close(self) -> None:
        # shutdown() (not just close) reliably wakes a blocked recv AND
        # a mid-send writer with EOF/EPIPE; both service threads then
        # exit and get reaped, so a torn-down session never leaves a
        # thread behind.  Frames still queued behind the sentinel are
        # abandoned unsent (the writer returns at the sentinel without
        # draining); their waiters are answered by the reader's
        # teardown, which pops every registered waiter with a generic
        # ConnectionError — NOT the writer-side _SendError path, so a
        # caller racing close() cannot rely on the "never left this
        # host" retry-safety signal for those frames.
        with self._lock:
            if self._broken is None:
                # Callers racing close() fail fast instead of waiting
                # out their timeout against a writer that already quit.
                self._broken = _SendError("session closed")
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self._outq.put(None)
        if self._reader is not threading.current_thread():
            self._reader.join(2.0)
        if self._writer is not threading.current_thread():
            self._writer.join(2.0)


class ConnPool:
    """Client connections per server address (reference nomad/pool.go).
    Default is one multiplexed session per peer (the 0x03 plane — the
    reference's pooled yamux sessions); ``multiplex=False`` falls back
    to plain pooled one-in-flight connections.  With a ``tls_context``
    every connection rides the server's 0x04 TLS plane."""

    def __init__(self, max_per_host: int = 4,
                 tls_context: Optional[ssl.SSLContext] = None,
                 server_hostname: str = "",
                 multiplex: bool = True) -> None:
        self.max_per_host = max_per_host
        self.tls_context: Immutable = tls_context
        self.server_hostname: Immutable = server_hostname
        self.multiplex = multiplex
        self._lock = threading.Lock()
        self._pools: dict = {}   # address -> [idle _PooledConn]
        self._sessions: dict = {}  # address -> MuxConn
        # Set by shutdown: a later call raises instead of dialing a
        # session nothing would close (a client thread mid-call while
        # its client shuts down).  guarded by _lock
        self._closed = False

    def _refuse(self) -> None:
        raise ConnectionError("connection pool is shut down")

    def _session(self, address: tuple) -> MuxConn:
        with self._lock:
            if self._closed:
                self._refuse()
            sess = self._sessions.get(address)
            if sess is not None and not sess.broken:
                return sess
        # Dial OUTSIDE the pool lock: a slow or unreachable peer (the
        # connect timeout is 330s) must not stall every other thread's
        # RPC to every other address behind this lock
        # (analyzer: blocking-under-lock).  Concurrent re-dials to the
        # same address may race; the loser's session is closed.
        fresh = MuxConn(address, tls_context=self.tls_context,
                        server_hostname=self.server_hostname)
        stale = loser = keep = None
        with self._lock:
            current = self._sessions.get(address)
            if self._closed:
                loser = fresh  # shut down while this thread dialed
            elif current is not None and not current.broken and \
                    current is not sess:
                keep, loser = current, fresh  # another thread won
            else:
                stale, keep = current, fresh
                self._sessions[address] = fresh
        # close() joins the reader thread — never under the pool lock.
        if stale is not None:
            stale.close()
        if loser is not None:
            loser.close()
        if keep is None:
            self._refuse()
        return keep

    def _call_mux(self, address: tuple, method: str, args: dict,
                  timeout: Optional[float]):
        sess = self._session(address)
        try:
            return sess.call(method, args, timeout)
        except _SendError:
            # Session died before the request left: one fresh session.
            return self._session(address).call(method, args, timeout)

    def call(self, address: tuple, method: str, args: dict,
             timeout: Optional[float] = None):
        if faultinject.ACTIVE:
            # The send chokepoint: an injected drop/error here is a
            # request that never leaves this host — transport-shaped,
            # so callers' retry policies treat it like a dead socket.
            faultinject.fire_rpc("rpc.send", method, args)
        if timeout is not None and "_deadline" not in args:
            # Deadline propagation (server/overload.py): the transport
            # timeout IS the caller's remaining budget (RetryPolicy
            # feeds each attempt's share here) — ship it so the server
            # can drop the work the moment nobody is waiting.  Copy:
            # retry loops re-send the same args dict.
            args = dict(args, _deadline=timeout)
        address = (address[0], address[1])
        if trace_mod.ENABLED:
            # Trace envelope, beside the deadline: ship the context and
            # record one client span per attempt (a retry is a new
            # attempt, a new span, same trace) — obs/trace.client_call.
            with trace_mod.client_call(method, args) as args:
                return self._dispatch_call(address, method, args,
                                           timeout)
        return self._dispatch_call(address, method, args, timeout)

    def _dispatch_call(self, address: tuple, method: str, args: dict,
                       timeout: Optional[float]):
        if self.multiplex:
            return self._call_mux(address, method, args, timeout)
        conn = self._checkout(address)
        try:
            result = conn.call(method, args, timeout)
        except RPCError:
            # Application-level error: the connection is healthy.
            self._checkin(address, conn)
            raise
        except _SendError:
            # Request never reached the server: retry once on a fresh
            # connection (safe even for writes).
            conn.close()
            conn = self._new_conn(address)
            try:
                result = conn.call(method, args, timeout)
            except RPCError:
                self._checkin(address, conn)
                raise
            except Exception:
                conn.close()
                raise
        except (ConnectionError, OSError, TimeoutError):
            # Failure after the request may have been processed: do NOT
            # re-send (the call may not be idempotent); surface the error.
            conn.close()
            raise
        self._checkin(address, conn)
        return result

    def _new_conn(self, address: tuple) -> _PooledConn:
        return _PooledConn(address, tls_context=self.tls_context,
                           server_hostname=self.server_hostname)

    def _checkout(self, address: tuple) -> _PooledConn:
        with self._lock:
            if self._closed:
                self._refuse()
            pool = self._pools.get(address)
            if pool:
                return pool.pop()
        return self._new_conn(address)

    def _checkin(self, address: tuple, conn: _PooledConn) -> None:
        with self._lock:
            pool = None if self._closed else \
                self._pools.setdefault(address, [])
            if pool is not None and len(pool) < self.max_per_host:
                pool.append(conn)
                return
        conn.close()

    def shutdown(self) -> None:
        # Detach under the lock, close outside it (MuxConn.close joins
        # its reader thread).
        with self._lock:
            self._closed = True
            pools = list(self._pools.values())
            self._pools.clear()
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for pool in pools:
            for conn in pool:
                conn.close()
        for sess in sessions:
            sess.close()
