"""Event-driven serving plane: selector mux + bounded dispatch pool.

The client-facing edge (agent heartbeats, blocking queries, alloc
long-polls — PAPER.md's traffic-heavy layer) was thread-per-connection:
``ThreadingTCPServer`` accept threads, one spawned worker per mux
request, and one parked Event-holding thread per blocking poller.  At
the fleet sizes the ROADMAP targets (10k-100k agents) that is tens of
thousands of parked OS threads, and thread exhaustion at the edge is
exactly the resource-collapse spiral the overload plane
(server/overload.py) exists to prevent.

This module makes server resource usage O(worker pools), not
O(connected clients):

- :class:`EdgeLoop` — ONE selector thread owns every client socket:
  accepts (with a max-connection cap that sheds via an ``overloaded:``
  error frame instead of accepting-then-starving), decodes the
  length-prefixed msgpack frames incrementally, reaps idle connections,
  and kills slowloris-style stalled partial frames on a per-connection
  read deadline (counted from accept for a connection that has never
  completed a frame, so silent connects cannot camp the max_conns cap
  for the much longer idle timeout) — a stalled client can never reach
  (let alone pin) a dispatch worker, because only complete frames
  dispatch.
- :class:`DispatchPool` — a fixed worker pool with a bounded intake
  queue; overflow is shed with ``overloaded:`` (rejecting is radically
  cheaper than serving).  ``urgent`` submits (resumed long-polls, tiny
  by construction) bypass the bound so the watch fan-out can never
  deadlock behind fresh traffic.
- :class:`Parked` — the asynchronous-completion protocol: a handler
  that would block (a blocking query whose min_index hasn't passed)
  raises ``Parked(subscribe)`` instead; the serving plane registers a
  resume callback with the state store's watch fan-out
  (state/store.StateWatch) and frees the worker.  When the watched
  index advances — or the wait expires on the shared TTL wheel — the
  request is re-dispatched and answered.  A parked long-poll costs one
  registry entry and one small record on its connection, not a thread.

Fault sites: ``mux.accept`` fires per accepted connection (error/drop
close it — a refused accept), ``conn.read`` fires per readable chunk
(drop discards the bytes — wire loss that degrades into a stalled
partial frame the read deadline reaps; error severs the connection).

Counterpart of ``nomad_tpu/server/mux.py``, unchanged: the frames it
writes are the JAX package's, byte for byte.
"""
from __future__ import annotations

import contextlib
import logging
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Optional

import msgpack

from nomad_tpu_torch import faultinject
from nomad_tpu_torch.utils.sync import Immutable

logger = logging.getLogger("nomad_tpu_torch.server.mux")

MAX_FRAME = 128 * 1024 * 1024
_RECV_CHUNK = 262144

# Frames decoded per connection per loop iteration: one storm-flooded
# connection must not monopolize the loop while heartbeat connections
# wait — leftovers carry over through the reparse set, round-robin.
_FRAME_BUDGET = 256

# Serving-plane defaults (ServerConfig overrides ride through RPCServer).
DISPATCH_WORKERS = 8
DISPATCH_QUEUE = 1024
MAX_CONNS = 20000
IDLE_TIMEOUT = 600.0
READ_DEADLINE = 30.0
SWEEP_INTERVAL = 0.25


def encode_frame(payload: dict) -> bytes:
    """One wire frame: 4-byte big-endian length + msgpack body."""
    body = msgpack.packb(payload, use_bin_type=True)
    return struct.pack(">I", len(body)) + body


class Parked(Exception):
    """Raised by a handler on the event-driven plane instead of blocking.

    ``subscribe(resume)`` must register ``resume(timed_out: bool)`` to
    be called EXACTLY ONCE when the watched condition matures or the
    wait expires, and return an idempotent unsubscribe callable for
    connection-death cleanup.  ``resume`` may fire on any thread —
    including synchronously inside ``subscribe`` when the lost-wakeup
    recheck finds the condition already matured.
    """

    def __init__(self, subscribe: Callable) -> None:
        super().__init__("handler parked on a watch")
        self.subscribe = subscribe


_park_local = threading.local()


def parking_enabled() -> bool:
    """True while the current thread is executing a handler whose
    caller can service a :class:`Parked` (the serving plane's dispatch
    workers).  Synchronous paths (in-proc agent RPC) see False and
    block the old way."""
    return getattr(_park_local, "enabled", False)


@contextlib.contextmanager
def parkable():
    prev = getattr(_park_local, "enabled", False)
    _park_local.enabled = True
    try:
        yield
    finally:
        _park_local.enabled = prev


@contextlib.contextmanager
def blocking_section():
    """Mark a long synchronous wait on the current dispatch worker —
    leader/region forwards of blocking queries, anything that must hold
    the worker for up to a blocking-query window.  Delegates to the
    owning pool's :meth:`DispatchPool.blocking` (bounded overflow
    workers keep the plane live — a handful of 300s forwarded
    long-polls must not pin every worker and starve heartbeats); a
    no-op on threads that are not pool workers (in-proc agent RPC)."""
    pool = getattr(_park_local, "pool", None)
    if pool is None:
        yield
    else:
        with pool.blocking():
            yield


class DispatchPool:
    """Fixed worker pool with a bounded intake queue.

    ``submit`` returns False when the queue is full (the caller sheds
    with ``overloaded:``) — a stalled pool surfaces as cheap rejections,
    never as unbounded queueing.  ``urgent=True`` bypasses the bound:
    resumed long-polls must always re-enter, or the fan-out would leak
    answered-but-never-delivered requests under load.

    Workers that must legitimately wait out a long operation (the HTTP
    edge's blocking queries, which cannot park) wrap it in
    :meth:`blocking`: while every non-blocked worker is busy and work
    queues, bounded temporary overflow workers keep the pool live — a
    handful of 300s long-polls can never freeze the whole plane.
    """

    # Bound on temporary overflow workers (the old thread-per-request
    # model's worst case, now an explicit ceiling).
    MAX_BLOCKING_OVERFLOW = 256

    def __init__(self, workers: int = DISPATCH_WORKERS,
                 max_queue: int = DISPATCH_QUEUE,
                 name: str = "rpc-dispatch") -> None:
        self.workers: Immutable = workers
        self.max_queue = max_queue
        self.name = name
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._q: deque = deque()
        self._threads: list = []
        self._temp_threads: set = set()
        self._stopped = False
        # Counters guarded by _lock.
        self.dispatched = 0
        self.rejected = 0
        self._busy = 0
        self._blocked = 0     # workers parked inside blocking()
        self._temp = 0        # live overflow workers
        self.overflow_spawns = 0

    def start(self) -> None:
        for i in range(self.workers):
            t = threading.Thread(target=self._run, daemon=True,
                                 name=f"{self.name}-{i}")
            t.start()
            self._threads.append(t)

    @contextlib.contextmanager
    def blocking(self):
        """Mark the current worker as parked in a long wait; spawns a
        bounded overflow worker when the rest of the pool is saturated
        and work is queued."""
        with self._cond:
            self._blocked += 1
            self._maybe_overflow_locked()
        try:
            yield
        finally:
            with self._cond:
                self._blocked -= 1

    def _maybe_overflow_locked(self) -> None:
        free = self.workers + self._temp - self._busy
        if self._q and not self._stopped and self._blocked > 0 and \
                free <= 0 and self._temp < self.MAX_BLOCKING_OVERFLOW:
            self._temp += 1
            self.overflow_spawns += 1
            t = threading.Thread(target=self._run_temp, daemon=True,
                                 name=f"{self.name}-overflow")
            self._temp_threads.add(t)
            t.start()

    def _run_temp(self) -> None:
        """Overflow worker: drains the queue, exits when it is empty."""
        _park_local.pool = self  # blocking_section() finds its pool
        try:
            while True:
                with self._cond:
                    if not self._q or self._stopped:
                        return
                    fn = self._q.popleft()
                    self._busy += 1
                    self.dispatched += 1
                try:
                    fn()
                except Exception:
                    logger.exception("dispatch worker: request raised")
                finally:
                    with self._lock:
                        self._busy -= 1
        finally:
            with self._cond:
                self._temp -= 1
                self._temp_threads.discard(threading.current_thread())

    def submit(self, fn: Callable, urgent: bool = False,
               front: bool = False) -> bool:
        """Queue one unit of work.  ``urgent`` bypasses the bound
        (resumed long-polls must always re-enter); ``front`` bypasses
        it AND jumps the queue — the dispatch-plane liveness lane, so a
        heartbeat never waits out a wake storm's worth of resumed
        polls (the same reasoning as the admission controller's
        heartbeat lane, one layer down)."""
        with self._cond:
            if self._stopped:
                return False
            if not (urgent or front) and len(self._q) >= self.max_queue:
                self.rejected += 1
                return False
            if front:
                self._q.appendleft(fn)
            else:
                self._q.append(fn)
            self._cond.notify()
            self._maybe_overflow_locked()
            return True

    def _run(self) -> None:
        _park_local.pool = self  # blocking_section() finds its pool
        while True:
            with self._cond:
                while not self._q and not self._stopped:
                    self._cond.wait(1.0)
                if not self._q:
                    if self._stopped:
                        return
                    continue
                fn = self._q.popleft()
                self._busy += 1
                self.dispatched += 1
            try:
                fn()
            except Exception:
                # One request's failure must not kill a shared worker.
                logger.exception("dispatch worker: request raised")
            finally:
                with self._lock:
                    self._busy -= 1

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def stats(self) -> dict:
        with self._lock:
            return {"workers": self.workers, "depth": len(self._q),
                    "busy": self._busy, "blocked": self._blocked,
                    "overflow": self._temp,
                    "overflow_spawns": self.overflow_spawns,
                    "dispatched": self.dispatched,
                    "rejected": self.rejected}

    def sever(self) -> None:
        """Crash path (Server.abandon): signal stop, join NOTHING —
        busy workers die against severed sockets on their own time;
        the suite-hygiene joins run later via shutdown()."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def shutdown(self, timeout: float = 2.0) -> None:
        self.sever()
        with self._cond:
            temps = list(self._temp_threads)
        for t in self._threads + temps:
            if t is not threading.current_thread():
                t.join(timeout)


class _Conn:
    """One client connection owned by the event loop."""

    __slots__ = ("sock", "fd", "addr", "buf", "plane", "out", "last_rx",
                 "partial_since", "pending", "parked", "closed", "events")

    def __init__(self, sock: socket.socket, addr) -> None:
        self.sock = sock
        self.fd = sock.fileno()
        self.addr = addr
        self.buf = bytearray()
        self.plane: Optional[int] = None
        self.out: deque = deque()      # worker-appended reply bytes
        self.last_rx = time.monotonic()
        # A fresh connection is "awaiting its first frame": stamped
        # from accept so a silent connect (or a plane byte and nothing
        # more) is reaped on read_deadline, not parked against
        # max_conns for the whole idle_timeout.  Cleared when a
        # complete frame parses; re-stamped when a partial head
        # appears.
        self.partial_since: Optional[float] = self.last_rx
        self.pending = 0               # dispatched-or-parked requests
        self.parked: dict = {}         # id(rec) -> parked record
        self.closed = False
        self.events = selectors.EVENT_READ


class EdgeLoop:
    """One selector thread owning every client socket on the RPC edge.

    The ``protocol`` (RPCServer) supplies:

    - ``on_plane(conn, byte)`` -> ``"stream"`` (frame-decode here),
      ``"handoff"`` (raft/TLS: the protocol takes the raw blocking
      socket onto its own thread), or ``"reject"``;
    - ``on_frame(conn, obj)`` -> False to drop the connection
      (malformed frame);
    - ``handoff(sock, byte)`` for the raft/TLS planes;
    - ``shed_payload()`` -> the pre-built ``overloaded:`` error frame
      written to connections refused at the max-connection cap.

    Cross-thread API (dispatch workers): :meth:`send`,
    :meth:`request_done`, :meth:`park`, :meth:`unpark` — all post ops
    through a waker socketpair; only the loop thread touches selector
    and connection state.
    """

    def __init__(self, listener: socket.socket, protocol, *,
                 max_conns: int = MAX_CONNS,
                 idle_timeout: float = IDLE_TIMEOUT,
                 read_deadline: float = READ_DEADLINE,
                 sweep_interval: float = SWEEP_INTERVAL,
                 name: str = "rpc-loop") -> None:
        self._listener = listener
        self._protocol = protocol
        self.max_conns = max_conns
        self.idle_timeout = idle_timeout
        self.read_deadline = read_deadline
        self.sweep_interval = sweep_interval
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._ops: deque = deque()       # thread-safe cross-thread ops
        # fd -> _Conn.  Mutated by the loop thread only, but stats()/
        # parked_requests() snapshot it from monitoring threads — the
        # lock covers just the dict insert/pop/copy so a mid-churn
        # snapshot can't hit "dict changed size during iteration".
        self._conns: dict = {}
        self._conns_lock = threading.Lock()
        self._reparse: set = set()       # conns w/ budget-deferred frames
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Counters: written by the loop thread only; stats() snapshots.
        self.accepts = 0
        self.conn_sheds = 0
        self.accept_faults = 0
        self.read_faults = 0
        self.frames_in = 0
        self.closed_eof = 0
        self.closed_idle = 0
        self.closed_deadline = 0
        self.closed_error = 0
        self.handoffs = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.name)
        self._thread.start()

    def sever(self) -> None:
        """Crash path (Server.abandon): stop the loop and sever every
        socket immediately — peers see resets mid-frame even before
        the loop thread is next scheduled — joining NOTHING.  Uses
        socket.shutdown (not close) so no fd is reused under the
        still-running selector; the loop's own _teardown closes the
        fds on its way out."""
        self._stop.set()
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns.values())
        for conn in conns:
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.wake()

    def shutdown(self, timeout: float = 2.0) -> None:
        if self._thread is None:
            # Never started (a server whose construction raised): no
            # loop thread will close the listener and the waker.
            self._teardown()
            return
        self._stop.set()
        self.wake()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)

    # -- cross-thread API --------------------------------------------------
    def wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass  # full pipe still wakes; closed pipe = loop is gone

    def post(self, op: tuple) -> None:
        self._ops.append(op)
        self.wake()

    def send(self, conn: _Conn, data: bytes) -> None:
        """Queue reply bytes on ``conn`` (any thread)."""
        conn.out.append(data)
        self.post(("flush", conn))

    def request_done(self, conn: _Conn) -> None:
        self.post(("done", conn))

    def park(self, conn: _Conn, rec: dict) -> None:
        self.post(("park", conn, rec))

    def unpark(self, conn: _Conn, rec: dict) -> None:
        self.post(("unpark", conn, rec))

    # -- introspection -----------------------------------------------------
    def open_conns(self) -> int:
        return len(self._conns)

    def parked_requests(self) -> int:
        with self._conns_lock:
            conns = list(self._conns.values())
        return sum(len(c.parked) for c in conns)

    def stats(self) -> dict:
        return {
            "open_conns": len(self._conns),
            "parked_requests": self.parked_requests(),
            "accepts": self.accepts,
            "conn_sheds": self.conn_sheds,
            "frames_in": self.frames_in,
            "closed_eof": self.closed_eof,
            "closed_idle": self.closed_idle,
            "closed_deadline": self.closed_deadline,
            "closed_error": self.closed_error,
            "handoffs": self.handoffs,
            "accept_faults": self.accept_faults,
            "read_faults": self.read_faults,
        }

    # -- loop --------------------------------------------------------------
    def _run(self) -> None:
        last_sweep = time.monotonic()
        try:
            while not self._stop.is_set():
                # Per-iteration guard: this ONE thread is the entire
                # client edge.  The old thread-per-connection model
                # isolated an unexpected exception (a failed handoff
                # thread spawn, a selector re-register race) to one
                # connection; here it would take down every connection
                # and the listener with it.  Log, pause a beat so a
                # persistent failure can't hot-spin, keep serving.
                try:
                    last_sweep = self._run_once(last_sweep)
                except Exception:
                    logger.exception("%s: loop iteration failed; "
                                     "continuing", self.name)
                    time.sleep(0.05)
        finally:
            self._teardown()

    def _run_once(self, last_sweep: float) -> float:
        events = self._sel.select(
            0.0 if self._reparse else self.sweep_interval)
        for key, _mask in events:
            what = key.data
            if what == "accept":
                self._accept()
            elif what == "wake":
                self._drain_waker()
            else:
                self._service(what, _mask)
        if self._reparse:
            pending, self._reparse = self._reparse, set()
            for conn in pending:
                if not conn.closed:
                    self._parse_frames(conn)
        self._drain_ops()
        now = time.monotonic()
        if now - last_sweep >= self.sweep_interval:
            self._sweep(now)
            return now
        return last_sweep

    def _teardown(self) -> None:
        for conn in list(self._conns.values()):
            self._close(conn, "eof")
        for sock in (self._listener, self._wake_r, self._wake_w):
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError):
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._sel.close()

    def _drain_waker(self) -> None:
        try:
            # faultlint-ok(uninjectable-io): socketpair self-wake drain
            # — process-local plumbing, not a cluster transport edge.
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _drain_ops(self) -> None:
        while True:
            try:
                op = self._ops.popleft()
            except IndexError:
                return
            kind = op[0]
            conn = op[1]
            if kind == "flush":
                # _flush itself arms write interest iff data remains
                # after the send — no pre-arm (two epoll_ctl per reply
                # on the happy path is real money in a wake storm).
                if not conn.closed and conn.out:
                    self._flush(conn)
            elif kind == "done":
                if conn.pending > 0:
                    conn.pending -= 1
            elif kind == "park":
                rec = op[2]
                if conn.closed:
                    self._unsub(rec)
                elif not rec.get("done"):
                    conn.parked[id(rec)] = rec
            elif kind == "unpark":
                conn.parked.pop(id(op[2]), None)

    # -- accept ------------------------------------------------------------
    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            self.accepts += 1
            if faultinject.ACTIVE:
                try:
                    faultinject.fire("mux.accept")
                except Exception:
                    # Injected accept failure: the connection never
                    # existed as far as the edge is concerned.
                    self.accept_faults += 1
                    try:
                        sock.close()
                    except OSError:
                        pass
                    continue
            if len(self._conns) >= self.max_conns:
                # Shed at the door: an explicit overloaded: frame and a
                # close is honest back-pressure; accepting and starving
                # is the slow-collapse alternative.
                self.conn_sheds += 1
                try:
                    sock.setblocking(False)
                    sock.send(self._protocol.shed_payload())
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sock.setblocking(False)
            try:
                # Small request/reply frames must not wait out Nagle +
                # delayed-ACK (40-200ms per round trip).
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, addr)
            with self._conns_lock:
                self._conns[conn.fd] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    # -- read / frame decode ----------------------------------------------
    def _service(self, conn: _Conn, mask: int) -> None:
        if conn.closed:
            return
        if mask & selectors.EVENT_WRITE:
            self._flush(conn)
        if conn.closed or not mask & selectors.EVENT_READ:
            return
        if conn.plane is None:
            # First byte selects the plane; read exactly one so a
            # handed-off raft/TLS stream keeps every byte it sent.
            try:
                first = conn.sock.recv(1)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._close(conn, "error")
                return
            if not first:
                self._close(conn, "eof")
                return
            conn.last_rx = time.monotonic()
            action = self._protocol.on_plane(conn, first[0])
            if action == "stream":
                conn.plane = first[0]
            elif action == "handoff":
                self._handoff(conn, first[0])
            else:
                self._close(conn, "error")
            return
        try:
            data = conn.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn, "error")
            return
        if not data:
            self._close(conn, "eof")
            return
        if faultinject.ACTIVE:
            try:
                faultinject.fire("conn.read")
            except faultinject.FaultDropped:
                # Injected wire loss: the bytes evaporate.  The frame
                # stream stalls (or desyncs) and the read deadline — or
                # a garbage length field — reaps the connection, which
                # is exactly what real loss looks like to the server.
                self.read_faults += 1
                if conn.partial_since is None:
                    conn.partial_since = time.monotonic()
                return
            except Exception:
                self.read_faults += 1
                self._close(conn, "error")
                return
        conn.last_rx = time.monotonic()
        conn.buf += data
        self._parse_frames(conn)

    def _parse_frames(self, conn: _Conn) -> bool:
        """Decode up to _FRAME_BUDGET complete frames; leftovers carry
        over via the reparse set (round-robin fairness under storms).
        Also maintains the partial-frame deadline stamp: it marks when
        an INCOMPLETE frame head first appeared and is never refreshed
        by further trickle — a 1-byte-per-second slowloris still gets
        reaped on schedule.  False = connection closed."""
        buf = conn.buf
        parsed = 0
        while parsed < _FRAME_BUDGET:
            if len(buf) < 4:
                break
            length = int.from_bytes(buf[:4], "big")
            if length > MAX_FRAME:
                logger.warning("dropping connection: frame too large "
                               "(%d)", length)
                self._close(conn, "error")
                return False
            if len(buf) < 4 + length:
                break
            body = bytes(buf[4:4 + length])
            del buf[:4 + length]
            parsed += 1
            try:
                obj = msgpack.unpackb(body, raw=False,
                                      strict_map_key=False)
            except Exception:
                logger.warning("dropping connection: undecodable frame")
                self._close(conn, "error")
                return False
            self.frames_in += 1
            if not self._protocol.on_frame(conn, obj):
                self._close(conn, "error")
                return False
        if len(buf) >= 4 and \
                len(buf) >= 4 + int.from_bytes(buf[:4], "big"):
            # A complete frame waits on OUR budget, not on the client:
            # no read deadline, just another round-robin turn.
            self._reparse.add(conn)
            conn.partial_since = None
        elif buf:
            if parsed or conn.partial_since is None:
                # Stamp when an incomplete head first appears — and
                # RE-stamp whenever this round parsed complete frames:
                # a healthy pipelining connection whose recv chunks
                # keep ending mid-frame is making progress, not
                # slowlorising, and must not accumulate toward the
                # deadline across minutes of sustained traffic.
                conn.partial_since = time.monotonic()
        else:
            conn.partial_since = None
        return True

    def _handoff(self, conn: _Conn, byte: int) -> None:
        """Raft/TLS plane: the loop releases the socket to a dedicated
        protocol thread (blocking I/O; O(peers), not O(clients))."""
        self.handoffs += 1
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        with self._conns_lock:
            self._conns.pop(conn.fd, None)
        conn.closed = True  # loop's view; the socket lives on
        try:
            conn.sock.setblocking(True)
        except OSError:
            try:
                conn.sock.close()
            except OSError:
                pass
            return
        self._protocol.handoff(conn.sock, byte)

    # -- write -------------------------------------------------------------
    def _flush(self, conn: _Conn) -> None:
        while conn.out:
            # Coalesce queued frames into one send: a 10k-waiter wake
            # storm answers thousands of frames per connection, and
            # one syscall per frame would make the loop thread the
            # bottleneck.
            if len(conn.out) > 1:
                chunks: list = []
                size = 0
                while conn.out and size < 262144 and len(chunks) < 256:
                    chunk = conn.out.popleft()
                    chunks.append(chunk)
                    size += len(chunk)
                data = b"".join(chunks)
            else:
                data = conn.out.popleft()
            try:
                n = conn.sock.send(data)
            except (BlockingIOError, InterruptedError):
                conn.out.appendleft(data)
                break
            except OSError:
                self._close(conn, "error")
                return
            if n < len(data):
                conn.out.appendleft(data[n:])
                break
        self._want_write(conn, bool(conn.out))

    def _want_write(self, conn: _Conn, want: bool) -> None:
        events = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if want else 0)
        if events == conn.events or conn.closed:
            return
        conn.events = events
        try:
            self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            pass

    # -- reaping -----------------------------------------------------------
    def _sweep(self, now: float) -> None:
        for conn in list(self._conns.values()):
            if conn.closed:
                continue
            if conn.partial_since is not None and \
                    now - conn.partial_since > self.read_deadline:
                # Slowloris / lost bytes: a partial frame this old will
                # never complete; reap it before it costs anything more
                # than this selector slot.
                self._close(conn, "deadline")
                continue
            if conn.pending == 0 and not conn.parked and not conn.out \
                    and conn.partial_since is None and \
                    now - conn.last_rx > self.idle_timeout:
                self._close(conn, "idle")

    # -- close -------------------------------------------------------------
    @staticmethod
    def _unsub(rec: dict) -> None:
        rec["done"] = True
        unsub = rec.get("unsub")
        if unsub is not None:
            try:
                unsub()
            except Exception:
                logger.exception("parked-request unsubscribe failed")

    def _close(self, conn: _Conn, reason: str) -> None:
        if conn.closed:
            return
        conn.closed = True
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        # Account BEFORE the socket close: the FIN is externally
        # visible the instant close() runs, and a peer woken by it may
        # immediately sample stats() — the close must already be
        # attributed (and the conn deregistered) by then, or the
        # observer sees a closed wire with an open, unaccounted conn.
        with self._conns_lock:
            self._conns.pop(conn.fd, None)
        if reason == "eof":
            self.closed_eof += 1
        elif reason == "idle":
            self.closed_idle += 1
        elif reason == "deadline":
            self.closed_deadline += 1
        else:
            self.closed_error += 1
        try:
            conn.sock.close()
        except OSError:
            pass
        # A dead connection must deregister every parked waiter — this
        # is the watcher-leak fix: abandoned long-polls leave the watch
        # registry empty, not populated until some far-future timeout.
        for rec in list(conn.parked.values()):
            self._unsub(rec)
        conn.parked.clear()
