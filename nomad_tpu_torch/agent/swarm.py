"""Agent swarm: N simulated agents on K connections and ONE timer wheel.

The client half of the serving-plane story (bench row
``5d_client_swarm``): ten thousand heartbeating, long-polling agents
must cost the *client* harness O(connections + one wheel), or the bench
would measure its own thread army instead of the server.  Three pieces:

- **Shared mux sessions** (:class:`_Chan`): all agents multiplex over a
  handful of 0x03 sessions (``MuxConn.call_async`` — callback waiters,
  no per-call Event or thread), with lazy redial when a session breaks
  (chaos: injected ``conn.read``/``mux.accept`` faults sever
  connections; agents must ride it out).  Heartbeats ride DEDICATED
  sessions — the client-side mirror of the server's liveness lane, so
  a long-poll wake storm queuing thousands of replies can never delay
  the frames that keep nodes alive.
- **One TTL wheel** (server/ttlwheel.py) schedules every per-agent
  heartbeat AND every in-flight call timeout: 10k agents = 10k wheel
  entries and one service thread, the exact structure the server uses
  for TTL expiry.
- **Long-polls as callbacks**: each agent keeps one
  ``Node.GetAllocs(min_query_index)`` parked server-side; completion
  re-issues from the reader-thread callback, so wakeup->repoll costs
  no thread handoff at all.

Everything is seedable (stagger + jitter) so chaos soaks replay.

Counterpart of ``nomad_tpu/agent/swarm.py``, unchanged.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional

from nomad_tpu_torch.server.rpc import MuxConn
from nomad_tpu_torch.server.ttlwheel import TTLWheel
from nomad_tpu_torch.structs import Node
from nomad_tpu_torch.utils.sync import Immutable

logger = logging.getLogger("nomad_tpu_torch.agent.swarm")


def default_node(i: int) -> Node:
    return Node(id=f"swarm-{i:06d}", name=f"swarm-{i}",
                datacenter="dc1", status="ready")


class _Chan:
    """One shared mux session with lazy redial on breakage.

    ``session()`` can run on the swarm's wheel thread (a heartbeat or
    re-poll callback needing a redial), and the wheel's contract is
    that callbacks are QUICK — so the dial is bounded at DIAL_TIMEOUT
    (not the server pool's 330s), and a failed dial fails every caller
    fast for REDIAL_COOLOFF instead of each callback serially waiting
    out its own connect against a down server.  Callers already treat
    a raised dial as a failed call and retry through the wheel."""

    DIAL_TIMEOUT = 5.0
    REDIAL_COOLOFF = 1.0

    def __init__(self, address: tuple) -> None:
        self.address = address
        self._lock = threading.Lock()
        self._conn: Optional[MuxConn] = None
        self._last_fail = 0.0
        self.dials = 0

    def session(self) -> MuxConn:
        with self._lock:
            conn = self._conn
            if conn is not None and not conn.broken:
                return conn
            if time.monotonic() - self._last_fail < self.REDIAL_COOLOFF:
                raise ConnectionError("redial cooloff after failed dial")
        # Dial outside the lock (same discipline as ConnPool._session);
        # a concurrent redial race loser is closed.
        try:
            fresh = MuxConn(self.address,
                            connect_timeout=self.DIAL_TIMEOUT)
        except Exception:
            with self._lock:
                self._last_fail = time.monotonic()
            raise
        stale = loser = None
        with self._lock:
            current = self._conn
            if current is not None and not current.broken and \
                    current is not conn:
                keep, loser = current, fresh
            else:
                stale, keep = current, fresh
                self._conn = fresh
                self.dials += 1
        if stale is not None:
            stale.close()
        if loser is not None:
            loser.close()
        return keep

    def close(self) -> None:
        with self._lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()


class AgentSwarm:
    """N simulated agents heartbeating + long-polling through one server.

    ``start()`` registers every node (bounded-in-flight async
    registration with retries), arms staggered heartbeats on the wheel,
    and parks one alloc long-poll per agent server-side.  ``stats()``
    snapshots latency percentiles and counters; ``stop()`` tears down
    to zero threads (wheel stopped, sessions closed and reader threads
    joined).
    """

    def __init__(self, address: tuple, n_agents: int, *,
                 conns: int = 8, hb_conns: int = 2,
                 beat_interval: float = 10.0, poll_wait: float = 30.0,
                 rpc_timeout: float = 10.0, seed: int = 0,
                 node_factory: Callable[[int], Node] = default_node,
                 long_polls: bool = True) -> None:
        self.address = (address[0], address[1])
        self.n_agents: Immutable = n_agents
        self.beat_interval = beat_interval
        self.poll_wait = poll_wait
        self.rpc_timeout = rpc_timeout
        self.long_polls = long_polls
        self._rng = random.Random(seed)
        self._nodes = [node_factory(i) for i in range(n_agents)]
        self._poll_index = [0] * n_agents
        self._chans = [_Chan(self.address) for _ in range(max(1, conns))]
        # The client-side liveness lane: heartbeats never share a
        # session (and its write queue) with long-poll wake storms.
        self._hb_chans = [_Chan(self.address)
                          for _ in range(max(1, hb_conns))]
        self._wheel: Immutable = TTLWheel(self._on_wheel,
                                          name="swarm-wheel")
        self._lock = threading.Lock()
        self._calls: dict = {}     # kid -> (session, seq); guarded
        self._kid = 0
        self._stopped = threading.Event()
        # Counters + latencies, guarded by _lock.
        self.beats_ok = 0
        self.beat_errors = 0
        self.beat_lat: list = []
        self.polls_issued = 0
        self.poll_wakeups = 0
        self.poll_timeouts = 0
        self.poll_errors = 0
        self.register_errors = 0
        # Unified metrics registry (obs/registry.py): a live swarm is
        # a process-wide load source worth one nomad.swarm.* provider;
        # stop() deregisters it.
        from nomad_tpu_torch.obs import REGISTRY
        self._obs_token = REGISTRY.register("swarm", self.stats)

    # -- async call plumbing ------------------------------------------------
    def _call_async(self, chan: _Chan, method: str, args: dict,
                    on_done, timeout: float) -> None:
        """One async call with its timeout armed on the swarm wheel —
        ``on_done(result, exc)`` exactly once."""
        try:
            sess = chan.session()
        except Exception as e:
            on_done(None, e)
            return
        with self._lock:
            self._kid += 1
            kid = self._kid
        key = f"to:{kid}"

        def done(result, exc) -> None:
            with self._lock:
                self._calls.pop(kid, None)
            self._wheel.cancel(key)
            on_done(result, exc)

        seq = sess.call_async(method, args, done)
        if seq is None:
            return  # send failed; done already ran with the error
        with self._lock:
            self._calls[kid] = (sess, seq)
        try:
            self._wheel.arm(key, timeout)
        except RuntimeError:
            pass  # wheel stopped mid-teardown: the close path finishes it

    def _on_wheel(self, key: str) -> None:
        kind, _, rest = key.partition(":")
        if kind == "to":
            with self._lock:
                entry = self._calls.pop(int(rest), None)
            if entry is not None:
                sess, seq = entry
                sess.cancel_async(seq)
        elif kind == "hb":
            self._beat(int(rest))
        elif kind == "poll":
            self._issue_poll(int(rest))

    # -- lifecycle ----------------------------------------------------------
    def start(self, register_timeout: float = 120.0) -> None:
        # First beats are armed PER AGENT as its own registration
        # lands (register_all's success callback), exactly like a real
        # agent: the earliest-registered nodes carry the server's
        # minimum ~10s rate-scaled TTL, so waiting for the WHOLE
        # fleet to register before anyone beat tied their liveness to
        # fleet-wide registration time — on a host slower than
        # fleet/10s of registration throughput the early cohort
        # genuinely expired before its first beat.
        self.register_all(timeout=register_timeout)
        if self.long_polls:
            for i in range(self.n_agents):
                self._issue_poll(i)

    def register_all(self, timeout: float = 120.0,
                     max_inflight: int = 128) -> None:
        """Register every node over the wire (Node.Register is an
        idempotent upsert, so retries are safe)."""
        pending = list(range(self.n_agents))
        deadline = time.monotonic() + timeout
        for attempt in range(10):
            if not pending:
                return
            failed: list = []
            cond = threading.Condition()
            state = {"inflight": 0, "done": 0}

            def finish(i: int, exc) -> None:
                with cond:
                    state["inflight"] -= 1
                    state["done"] += 1
                    if exc is not None:
                        failed.append(i)
                    cond.notify_all()
                if exc is None:
                    # Registered: this agent starts heartbeating NOW
                    # (staggered within its cadence so the fleet never
                    # beats in lockstep), not when the whole swarm is
                    # up — its TTL is already running.  Idempotent
                    # retry registrations just re-stagger the beat.
                    self._wheel.arm(f"hb:{i}",
                                    self._rng.uniform(
                                        0.05, min(self.beat_interval,
                                                  5.0)))

            for i in pending:
                with cond:
                    while state["inflight"] >= max_inflight:
                        if not cond.wait(5.0) and \
                                time.monotonic() > deadline:
                            raise TimeoutError("swarm registration "
                                               "stalled")
                    state["inflight"] += 1
                chan = self._chans[i % len(self._chans)]
                self._call_async(
                    chan, "Node.Register",
                    {"node": self._nodes[i].to_dict()},
                    lambda _r, e, i=i: finish(i, e),
                    timeout=self.rpc_timeout)
            with cond:
                want = len(pending)
                while state["done"] < want:
                    if not cond.wait(5.0) and \
                            time.monotonic() > deadline:
                        raise TimeoutError("swarm registration stalled")
            with self._lock:
                self.register_errors += len(failed)
            pending = failed
        if pending:
            raise RuntimeError(
                f"{len(pending)} nodes failed to register after retries")

    def stop(self) -> None:
        self._stopped.set()
        from nomad_tpu_torch.obs import REGISTRY
        REGISTRY.deregister(self._obs_token)
        self._wheel.stop()
        for chan in self._chans + self._hb_chans:
            chan.close()

    # -- heartbeats ---------------------------------------------------------
    def _beat(self, idx: int) -> None:
        if self._stopped.is_set():
            return
        nid = self._nodes[idx].id
        chan = self._hb_chans[idx % len(self._hb_chans)]
        t0 = time.monotonic()

        def done(result, exc) -> None:
            lat = time.monotonic() - t0
            with self._lock:
                if exc is None:
                    self.beats_ok += 1
                    self.beat_lat.append(lat)
                else:
                    self.beat_errors += 1
            if not self._stopped.is_set():
                # Like a real client: never outwait the server-granted
                # TTL (the configured cadence only applies once the
                # rate-scaled TTL has grown past it).
                ttl = float((result or {}).get("heartbeat_ttl") or 0.0) \
                    if exc is None else 0.0
                nxt = min(self.beat_interval, ttl / 2) if ttl \
                    else min(self.beat_interval, 5.0)
                try:
                    self._wheel.arm(f"hb:{idx}",
                                    nxt * self._rng.uniform(0.9, 1.1))
                except RuntimeError:
                    pass

        self._call_async(chan, "Node.Heartbeat", {"node_id": nid},
                         done, timeout=self.rpc_timeout)

    # -- long-polls ---------------------------------------------------------
    def _issue_poll(self, idx: int) -> None:
        if self._stopped.is_set() or not self.long_polls:
            return
        nid = self._nodes[idx].id
        chan = self._chans[idx % len(self._chans)]
        with self._lock:
            min_index = self._poll_index[idx]

        def done(result, exc) -> None:
            if exc is not None:
                with self._lock:
                    self.poll_errors += 1
                if not self._stopped.is_set():
                    # Back off through the wheel instead of a hot
                    # re-issue loop against a broken session.
                    try:
                        self._wheel.arm(f"poll:{idx}",
                                        self._rng.uniform(0.2, 1.0))
                    except RuntimeError:
                        pass
                return
            index = int((result or {}).get("index") or 0)
            with self._lock:
                if index > self._poll_index[idx]:
                    self._poll_index[idx] = index
                    self.poll_wakeups += 1
                else:
                    self.poll_timeouts += 1
            if index <= 0:
                # Pre-first-write table: min_index 0 returns
                # immediately, so re-issuing inline would hot-loop
                # (client.py's watcher backs off the same way).
                try:
                    self._wheel.arm(f"poll:{idx}",
                                    self._rng.uniform(0.3, 0.8))
                except RuntimeError:
                    pass
                return
            self._issue_poll(idx)

        with self._lock:
            self.polls_issued += 1
        self._call_async(
            chan, "Node.GetAllocs",
            {"node_id": nid, "min_query_index": min_index,
             "max_query_time": self.poll_wait},
            done, timeout=self.poll_wait * 1.5 + 5.0)

    # -- introspection ------------------------------------------------------
    @staticmethod
    def _percentile(values: list, p: float) -> float:
        if not values:
            return 0.0
        ordered = sorted(values)
        k = min(len(ordered) - 1, int(len(ordered) * p / 100.0))
        return ordered[k]

    def stats(self) -> dict:
        with self._lock:
            lat = list(self.beat_lat)
            out = {
                "agents": self.n_agents,
                "beats_ok": self.beats_ok,
                "beat_errors": self.beat_errors,
                "polls_issued": self.polls_issued,
                "poll_wakeups": self.poll_wakeups,
                "poll_timeouts": self.poll_timeouts,
                "poll_errors": self.poll_errors,
                "register_errors": self.register_errors,
                "inflight_calls": len(self._calls),
            }
        out["p50_beat_ms"] = round(self._percentile(lat, 50) * 1e3, 2)
        out["p99_beat_ms"] = round(self._percentile(lat, 99) * 1e3, 2)
        out["redials"] = sum(max(0, c.dials - 1)
                             for c in self._chans + self._hb_chans)
        return out
