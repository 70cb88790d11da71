"""HTTP API: the /v1 REST surface.

Capability parity with reference command/agent/http.go: JSON codec,
the route table of http.go:93-121, blocking-query params
(?wait=5s&index=N&stale&pretty), X-Nomad-Index response headers, and error
coding (404 unknown route, 405 bad method, 500 with message body).

Serving is event-driven like the RPC plane (server/mux.py): one
selector thread accepts connections and watches idle keep-alive
sockets, and a bounded worker pool parses/answers requests — resource
usage is O(worker pool), not O(connected clients).  A connection only
costs a thread while a complete-ish request is being served (the
per-request socket timeout bounds a mid-headers slowloris); between
requests it parks in the selector.  Past the connection cap new
clients are shed with an immediate 503 instead of accepted-then-
starved, and idle keep-alive connections are reaped on a timeout.

Counterpart of ``nomad_tpu/agent/http_server.py``, the same routes and
answers.  ``/v1/agent/profile`` starts the port's ``torch.profiler``
session (``utils/profiling.py``) on the card; where there is none the
start raises and the route answers 400.
"""
from __future__ import annotations

import json
import logging
import selectors
import socket
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler
from typing import Optional
from urllib.parse import parse_qs, urlparse

from nomad_tpu_torch.server.mux import DispatchPool
from nomad_tpu_torch.utils.duration import parse_duration

logger = logging.getLogger("nomad_tpu_torch.agent.http")

HTTP_WORKERS = 8
HTTP_MAX_CONNS = 2048
HTTP_IDLE_TIMEOUT = 120.0
HTTP_READ_DEADLINE = 10.0

_SHED_503 = (b"HTTP/1.1 503 Service Unavailable\r\n"
             b"Content-Length: 22\r\nConnection: close\r\n"
             b"Content-Type: application/json\r\n\r\n"
             b'{"error":"overloaded"}')


class BadRequest(Exception):
    """Client error -> HTTP 400 (reference http.go CodedError)."""


def _read_exact(rfile, n: int) -> bytes:
    """Read exactly ``n`` body bytes from the unbuffered rfile (raw
    SocketIO reads may return short)."""
    chunks = []
    while n > 0:
        chunk = rfile.read(n)
        if not chunk:
            break
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class HTTPServer:
    def __init__(self, agent, host: str = "127.0.0.1",
                 port: int = 4646, workers: int = HTTP_WORKERS,
                 max_conns: int = HTTP_MAX_CONNS,
                 idle_timeout: float = HTTP_IDLE_TIMEOUT,
                 read_deadline: float = HTTP_READ_DEADLINE) -> None:
        self.agent = agent
        self.max_conns = max_conns
        self.idle_timeout = idle_timeout
        self.read_deadline = read_deadline
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = read_deadline  # socket timeout while parsing

            def log_message(self, fmt, *args) -> None:
                logger.debug("http: " + fmt, *args)

            def _buffered_pending(self) -> bool:
                """Bytes already pulled into the buffered reader (or
                readable right now) — they must be served before the
                raw socket re-parks in the selector, or a pipelined
                request would be silently swallowed.  Probed without
                blocking: an empty buffer + quiet socket returns
                False via BlockingIOError."""
                try:
                    self.connection.settimeout(0)
                    try:
                        return bool(self.rfile.peek(1))
                    finally:
                        self.connection.settimeout(self.timeout)
                except (BlockingIOError, OSError, ValueError):
                    return False

            def handle(self) -> None:
                # One dispatch serves the request in hand plus any
                # already-buffered pipelined ones; keep-alive then
                # re-parks the socket instead of pinning a worker.
                self.close_connection = True
                self.handle_one_request()
                while not self.close_connection and \
                        self._buffered_pending():
                    self.handle_one_request()

            def _respond(self, code: int, payload, pretty: bool = False,
                         index: Optional[int] = None) -> None:
                body = json.dumps(payload,
                                  indent=4 if pretty else None
                                  ).encode() + b"\n"
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if index is not None:
                    self.send_header("X-Nomad-Index", str(index))
                self.end_headers()
                self.wfile.write(body)

            def _handle(self) -> None:
                url = urlparse(self.path)
                query = {k: v[0] for k, v in
                         parse_qs(url.query, keep_blank_values=True
                                  ).items()}
                body = {}
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    try:
                        body = json.loads(_read_exact(self.rfile,
                                                      length))
                    except ValueError:
                        self._respond(400, {"error": "invalid JSON body"})
                        return
                try:
                    if "index" in query:
                        # Blocking query: the in-proc RPC path waits
                        # synchronously, so mark this worker parked —
                        # bounded overflow workers keep the HTTP plane
                        # live while long-polls wait (a handful of 5m
                        # watches must never freeze the whole API).
                        with outer._pool.blocking():
                            code, payload, index = outer.route(
                                self.command, url.path, query, body)
                    else:
                        code, payload, index = outer.route(
                            self.command, url.path, query, body)
                except KeyError as e:
                    self._respond(404, {"error": str(e)})
                    return
                except BadRequest as e:
                    self._respond(400, {"error": str(e)})
                    return
                except MethodNotAllowed:
                    self._respond(405, {"error": "method not allowed"})
                    return
                except Exception as e:
                    logger.debug("http request failed", exc_info=True)
                    self._respond(500, {"error": str(e)})
                    return
                self._respond(code, payload, pretty="pretty" in query,
                              index=index)

            do_GET = do_PUT = do_POST = do_DELETE = _handle

        self._handler_cls = _Handler
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((host, port))
        listener.listen(256)
        listener.setblocking(False)
        self._listener = listener
        self.address = listener.getsockname()

        self._pool = DispatchPool(workers, max_queue=max_conns,
                                  name="http-dispatch")
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._ops: deque = deque()   # (sock, addr) to re-park
        # fd -> (sock, addr, last_activity, reap_after).  A freshly
        # accepted connection that has never spoken gets read_deadline
        # before the sweep reaps it — a silent connect must not camp a
        # max_conns slot for the whole keep-alive idle_timeout; only a
        # connection that has completed a request earns idle_timeout.
        self._conns: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Counters (loop thread only).
        self.accepts = 0
        self.conn_sheds = 0
        self.closed_idle = 0
        self.closed_deadline = 0

    def start(self) -> None:
        self._pool.start()
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="http-loop")
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        self._wakeup()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(2.0)
        self._pool.shutdown()

    def stats(self) -> dict:
        return {"open_conns": len(self._conns), "accepts": self.accepts,
                "conn_sheds": self.conn_sheds,
                "closed_idle": self.closed_idle,
                "closed_deadline": self.closed_deadline,
                "pool": self._pool.stats()}

    # -- the edge loop ------------------------------------------------------
    def _wakeup(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass

    def _run(self) -> None:
        last_sweep = time.monotonic()
        try:
            while not self._stop.is_set():
                # Per-iteration guard: one thread IS the whole HTTP
                # edge — an unexpected exception must cost at most one
                # iteration, never the listener (same rationale as
                # EdgeLoop._run).
                try:
                    last_sweep = self._run_once(last_sweep)
                except Exception:
                    logger.exception("http loop iteration failed; "
                                     "continuing")
                    time.sleep(0.05)
        finally:
            for sock, _addr, _ts, _reap in list(self._conns.values()):
                self._drop(sock)
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

    def _run_once(self, last_sweep: float) -> float:
        events = self._sel.select(0.25)
        for key, _mask in events:
            if key.data == "accept":
                self._accept()
            elif key.data == "wake":
                try:
                    # faultlint-ok(uninjectable-io): socketpair
                    # self-wake drain — process-local plumbing.
                    while self._wake_r.recv(4096):
                        pass
                except (BlockingIOError, OSError):
                    pass
            else:
                self._dispatch(key.data)
        while self._ops:
            try:
                sock, addr = self._ops.popleft()
            except IndexError:
                break
            self._park(sock, addr)
        now = time.monotonic()
        if now - last_sweep >= 1.0:
            self._sweep(now)
            return now
        return last_sweep

    def _accept(self) -> None:
        while True:
            try:
                # faultlint-ok(uninjectable-io): agent-local HTTP API
                # plane, not the cluster RPC transport (mux.accept /
                # conn.read cover that); HTTP failure handling is
                # driven directly by the HTTP tests.
                sock, addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            self.accepts += 1
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                pass
            if len(self._conns) + self._pool.depth() >= self.max_conns:
                # Shed at the door: a 503 now beats accept-then-starve.
                self.conn_sheds += 1
                try:
                    sock.setblocking(False)
                    sock.send(_SHED_503)
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            self._park(sock, addr, fresh=True)

    def _park(self, sock: socket.socket, addr, fresh: bool = False) -> None:
        """Watch an (idle) connection for its next request.  ``fresh``
        connections (straight off accept, no request served yet) are
        reaped on ``read_deadline``; keep-alive re-parks earn the full
        ``idle_timeout``."""
        if self._stop.is_set():
            self._drop(sock)
            return
        reap_after = self.read_deadline if fresh else self.idle_timeout
        try:
            sock.setblocking(False)
            self._conns[sock.fileno()] = (sock, addr, time.monotonic(),
                                          reap_after)
            self._sel.register(sock, selectors.EVENT_READ, (sock, addr))
        except (OSError, ValueError, KeyError):
            self._drop(sock)

    def _dispatch(self, data) -> None:
        """A parked connection went readable: hand it to the pool."""
        sock, addr = data
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        self._conns.pop(sock.fileno(), None)
        if not self._pool.submit(lambda: self._serve_one(sock, addr)):
            try:
                sock.send(_SHED_503)
            except OSError:
                pass
            self._drop(sock)

    def _serve_one(self, sock: socket.socket, addr) -> None:
        """Worker: parse and answer ONE request, then re-park or close.
        The handler's socket timeout bounds a stalled mid-request
        client, so a slowloris costs a worker at most read_deadline."""
        try:
            sock.setblocking(True)
            handler = self._handler_cls(sock, addr, self)
            keep = not handler.close_connection
        except (ConnectionError, OSError, ValueError):
            keep = False
        except Exception:
            logger.debug("http connection failed", exc_info=True)
            keep = False
        if keep and not self._stop.is_set():
            self._ops.append((sock, addr))
            self._wakeup()
        else:
            self._drop(sock)

    def _sweep(self, now: float) -> None:
        for fd, (sock, _addr, ts, reap_after) in list(self._conns.items()):
            if now - ts > reap_after:
                try:
                    self._sel.unregister(sock)
                except (KeyError, ValueError):
                    pass
                self._conns.pop(fd, None)
                self._drop(sock)
                if reap_after == self.idle_timeout:
                    self.closed_idle += 1
                else:
                    self.closed_deadline += 1

    @staticmethod
    def _drop(sock: socket.socket) -> None:
        try:
            sock.close()
        except OSError:
            pass

    # -- routing -----------------------------------------------------------
    def route(self, method: str, path: str, query: dict, body):
        agent = self.agent
        rpc_args = {}
        try:
            if "index" in query:
                rpc_args["min_query_index"] = int(query["index"])
            if "wait" in query:
                rpc_args["max_query_time"] = parse_duration(query["wait"])
        except ValueError as e:
            raise BadRequest(str(e)) from e
        if "stale" in query:
            rpc_args["stale"] = True
        if query.get("region"):
            # Cross-region addressing (reference http.go parseRegion):
            # the server's _forward routes it or errors on unknown.
            rpc_args["region"] = query["region"]

        parts = [p for p in path.split("/") if p]
        if not parts or parts[0] != "v1":
            raise KeyError(f"unknown path {path}")
        parts = parts[1:]

        def out(resp: dict, key: Optional[str] = None, code: int = 200):
            index = resp.get("index") if isinstance(resp, dict) else None
            payload = resp.get(key) if key else resp
            return code, payload, index

        # ---- /v1/jobs ----------------------------------------------------
        if parts == ["jobs"]:
            if method == "GET":
                return out(agent.rpc("Job.List", rpc_args), "jobs")
            if method in ("PUT", "POST"):
                return out(agent.rpc("Job.Register",
                                     {"job": body.get("job", body)}))
            raise MethodNotAllowed

        if len(parts) >= 2 and parts[0] == "job":
            job_id = parts[1]
            rest = parts[2:]
            if not rest:
                if method == "GET":
                    resp = agent.rpc("Job.GetJob",
                                     dict(rpc_args, job_id=job_id))
                    if resp.get("job") is None:
                        raise KeyError(f"job not found: {job_id}")
                    return out(resp, "job")
                if method in ("PUT", "POST"):
                    return out(agent.rpc("Job.Register",
                                         {"job": body.get("job", body)}))
                if method == "DELETE":
                    return out(agent.rpc("Job.Deregister",
                                         {"job_id": job_id}))
                raise MethodNotAllowed
            if rest == ["allocations"]:
                return out(agent.rpc("Job.Allocations",
                                     dict(rpc_args, job_id=job_id)),
                           "allocations")
            if rest == ["evaluations"]:
                return out(agent.rpc("Job.Evaluations",
                                     dict(rpc_args, job_id=job_id)),
                           "evaluations")
            if rest == ["evaluate"]:
                return out(agent.rpc("Job.Evaluate", {"job_id": job_id}))
            raise KeyError(f"unknown path {path}")

        # ---- /v1/nodes ---------------------------------------------------
        if parts == ["nodes"]:
            return out(agent.rpc("Node.List", rpc_args), "nodes")
        if len(parts) >= 2 and parts[0] == "node":
            node_id = parts[1]
            rest = parts[2:]
            if not rest:
                resp = agent.rpc("Node.GetNode",
                                 dict(rpc_args, node_id=node_id))
                if resp.get("node") is None:
                    raise KeyError(f"node not found: {node_id}")
                return out(resp, "node")
            if rest == ["allocations"]:
                return out(agent.rpc("Node.GetAllocs",
                                     dict(rpc_args, node_id=node_id)),
                           "allocs")
            if rest == ["drain"]:
                enable = str(query.get("enable", "")).lower() in \
                    ("1", "true")
                return out(agent.rpc("Node.UpdateDrain",
                                     {"node_id": node_id,
                                      "drain": enable}))
            if rest == ["evaluate"]:
                return out(agent.rpc("Node.Evaluate",
                                     {"node_id": node_id}))
            raise KeyError(f"unknown path {path}")

        # ---- /v1/allocations --------------------------------------------
        if parts == ["allocations"]:
            return out(agent.rpc("Alloc.List", rpc_args), "allocations")
        if len(parts) == 2 and parts[0] == "allocation":
            resp = agent.rpc("Alloc.GetAlloc",
                             dict(rpc_args, alloc_id=parts[1]))
            if resp.get("alloc") is None:
                raise KeyError(f"alloc not found: {parts[1]}")
            return out(resp, "alloc")

        # ---- /v1/evaluations --------------------------------------------
        if parts == ["evaluations"]:
            return out(agent.rpc("Eval.List", rpc_args), "evaluations")
        if len(parts) >= 2 and parts[0] == "evaluation":
            eval_id = parts[1]
            rest = parts[2:]
            if not rest:
                resp = agent.rpc("Eval.GetEval",
                                 dict(rpc_args, eval_id=eval_id))
                if resp.get("eval") is None:
                    raise KeyError(f"eval not found: {eval_id}")
                return out(resp, "eval")
            if rest == ["allocations"]:
                return out(agent.rpc("Eval.Allocations",
                                     dict(rpc_args, eval_id=eval_id)),
                           "allocations")
            raise KeyError(f"unknown path {path}")

        # ---- /v1/agent + /v1/status -------------------------------------
        if parts == ["agent", "self"]:
            return 200, {"config": vars(agent.config),
                         "stats": agent.stats()}, None
        if parts == ["agent", "metrics"]:
            # The unified metrics registry (obs/registry.py): every
            # stats() provider in the process flattened to nomad.*
            # keys + the in-mem telemetry sink.  Always mounted (not
            # behind enable_debug): metrics are the production
            # monitoring surface, like the reference's /v1/agent/self
            # stats block, and carry no secrets.  ?filter=sub trims
            # the provider keys server-side — the `metrics -watch`
            # poller re-samples every N seconds and should not drag
            # the full document over the wire each round.
            payload = agent.metrics_payload()
            flt = str(query.get("filter", "") or "")
            if flt:
                payload["providers"] = {
                    k: v for k, v in payload["providers"].items()
                    if flt in k}
                # The inmem sink's sections are flat {key: ...} maps;
                # trim them by the same substring — the counters and
                # sample summaries are the BULK of the document, and a
                # tight watch poll must not re-download them all.
                payload["inmem"] = {
                    section: ({k: v for k, v in vals.items()
                               if flt in k}
                              if isinstance(vals, dict) else vals)
                    for section, vals in
                    (payload.get("inmem") or {}).items()}
            return 200, payload, None
        if parts == ["agent", "monitor"]:
            # Recent agent log lines from the in-process ring
            # (reference command/agent/log_writer.go: the monitor's
            # backlog source).  ?lines=N trims to the newest N.
            writer = getattr(agent, "log_writer", None)
            if writer is None:
                raise KeyError("agent log ring not installed "
                               "(library embedding)")

            def _qint(key):
                try:
                    return max(0, int(query.get(key, "0")))
                except ValueError:
                    return 0
            # ?since=offset -> lines after that monotonic offset
            # (follow mode; offsets survive ring eviction);
            # ?lines=N -> trim to the newest N.  The returned offset
            # resumes a follow stream from exactly this response.
            lines, offset = writer.lines_since(_qint("since"))
            n = _qint("lines")
            return 200, {"lines": lines[-n:] if n else lines,
                         "offset": offset}, None
        if parts == ["agent", "members"]:
            members = []
            if agent.server is not None:
                gossip = getattr(agent.server, "gossip", None)
                if gossip is not None:
                    members = gossip.members()
                else:
                    members = [
                        {"name": agent.config.name or "server",
                         "addr": list(agent.server.rpc_address() or ())}]
            return 200, {"members": members}, None
        if parts == ["agent", "servers"]:
            if method in ("PUT", "POST"):
                # Update the client's server list (reference
                # agent_endpoint.go updateServers).
                if agent.client is None:
                    raise BadRequest("agent is not running in client mode")
                raw_list = body if isinstance(body, list) else \
                    (body or {}).get("servers", [])
                parsed = []
                for spec in raw_list:
                    if isinstance(spec, (list, tuple)) and len(spec) == 2:
                        host, port = str(spec[0]), spec[1]
                    else:
                        host, _, port = str(spec).rpartition(":")
                    try:
                        port = int(port)
                    except (TypeError, ValueError):
                        port = -1
                    if not host or not 0 < port < 65536:
                        raise BadRequest(
                            f"invalid server address {spec!r}")
                    parsed.append((host, port))
                if not parsed:
                    raise BadRequest("no server addresses given")
                agent.client.set_servers(parsed)
                return 200, {}, None
            if agent.client is not None:
                servers = [list(s) for s in agent.client.servers()]
            elif agent.server is not None:
                servers = [list(p) for p in agent.server.peers()]
            else:
                servers = []
            return 200, servers, None
        if parts == ["agent", "join"]:
            address = query.get("address", "")
            try:
                host, port = address.rsplit(":", 1)
                target = (host, int(port))
            except ValueError as e:
                raise BadRequest(
                    f"invalid join address {address!r}") from e
            n = agent.join(target)
            return 200, {"num_joined": n}, None
        if parts == ["agent", "force-leave"]:
            name = query.get("node") or \
                (body.get("node", "") if isinstance(body, dict) else "")
            if agent.server is not None and \
                    getattr(agent.server, "gossip", None) is not None:
                agent.server.gossip.force_leave(name)
            return 200, {}, None

        if parts and parts[0] == "agent" and \
                parts[1:2] in (["pprof"], ["profile"]):
            # Debug introspection, mounted only when enable_debug is set
            # (reference http.go:115-120 pprof under enableDebug).
            if not agent.config.enable_debug:
                raise KeyError("debug endpoints disabled "
                               "(set enable_debug)")
            from nomad_tpu_torch.utils import profiling

            if parts[1] == "pprof":
                return 200, {"stacks": profiling.thread_stacks()}, None
            action = query.get("action", "")
            if action == "start":
                log_dir = query.get("dir", "")
                if not log_dir:
                    raise BadRequest("profile start needs ?dir=")
                try:
                    profiling.start_device_trace(log_dir)
                except RuntimeError as e:
                    raise BadRequest(str(e)) from e
                return 200, {"tracing": log_dir}, None
            if action == "stop":
                try:
                    done = profiling.stop_device_trace()
                except RuntimeError as e:
                    raise BadRequest(str(e)) from e
                return 200, {"traced": done}, None
            if action == "status":
                return 200, {"tracing":
                             profiling.active_trace_dir()}, None
            raise BadRequest("profile wants ?action=start|stop|status")

        if parts == ["status", "leader"]:
            return out(agent.rpc("Status.Leader", {}), "leader")
        if parts == ["status", "peers"]:
            return out(agent.rpc("Status.Peers", {}), "peers")

        raise KeyError(f"unknown path {path}")


class MethodNotAllowed(Exception):
    pass
