"""Gossip membership: SWIM-style failure detection + server discovery.

Capability parity with reference nomad/serf.go + the serf/memberlist
stack: servers gossip their existence over UDP, detect failures by periodic
probe (direct ping, then indirect ping via k peers), and disseminate
alive/suspect/dead transitions by piggybacking state on every message.
Member tags carry role/region/rpc address (reference server.go:503-538),
and join/fail events drive raft peer reconciliation on the leader
(reference nomad/serf.go nodeJoin/nodeFailed + leader.go:277-303
reconcileMember).

Protocol (msgpack over UDP):
  {"t": "ping",     "seq": n, "from": [h, p]}
  {"t": "ack",      "seq": n, "from": [h, p]}
  {"t": "ping-req", "seq": n, "from": [h, p], "target": [h, p]}
  every message carries "members": [{addr, tags, incarnation, status}]

Counterpart of ``nomad_tpu/server/gossip.py``, with the same wire byte
for byte: a JAX server's gossip and a port server's see each other.
"""
from __future__ import annotations

import logging
import random
import socket
import threading
import time
from typing import Callable, Optional

import msgpack

from nomad_tpu_torch.utils.sync import Immutable

logger = logging.getLogger("nomad_tpu_torch.server.gossip")

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
LEFT = "left"


class Member:
    __slots__ = ("addr", "tags", "incarnation", "status", "status_at")

    def __init__(self, addr: tuple, tags: dict, incarnation: int = 0,
                 status: str = ALIVE) -> None:
        self.addr = tuple(addr)
        self.tags = tags
        self.incarnation = incarnation
        self.status = status
        self.status_at = time.monotonic()

    def to_wire(self) -> dict:
        return {"addr": list(self.addr), "tags": self.tags,
                "incarnation": self.incarnation, "status": self.status}


class Gossip:
    def __init__(self, tags: dict, bind: str = "127.0.0.1", port: int = 0,
                 probe_interval: float = 0.5,
                 probe_timeout: float = 0.2,
                 suspect_timeout: float = 2.0,
                 on_join: Optional[Callable] = None,
                 on_leave: Optional[Callable] = None,
                 on_fail: Optional[Callable] = None) -> None:
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((bind, port))
        self.sock.settimeout(0.2)
        self.addr: Immutable = self.sock.getsockname()
        self.tags = tags
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.suspect_timeout = suspect_timeout
        self.on_join = on_join
        self.on_leave = on_leave
        self.on_fail = on_fail

        self._lock = threading.Lock()
        self._incarnation = 0
        self._members: dict = {
            self.addr: Member(self.addr, tags, 0, ALIVE)}
        self._acks: dict = {}    # seq -> threading.Event
        self._seq = 0
        self._stop = threading.Event()

        self._rx = threading.Thread(target=self._recv_loop, daemon=True,
                                    name="gossip-rx")
        self._probe = threading.Thread(target=self._probe_loop,
                                       daemon=True, name="gossip-probe")
        self._rx.start()
        self._probe.start()

    # -- public API ---------------------------------------------------------
    def members(self, status: Optional[str] = ALIVE) -> list:
        with self._lock:
            return [
                {"addr": list(m.addr), "tags": m.tags,
                 "status": m.status}
                for m in self._members.values()
                if status is None or m.status == status]

    def alive_addrs(self) -> list:
        with self._lock:
            return [m.addr for m in self._members.values()
                    if m.status == ALIVE]

    def join(self, address: tuple) -> int:
        """Ping a known member to merge membership (serf join)."""
        self._send(tuple(address), {"t": "ping", "seq": self._next_seq(),
                                    "from": list(self.addr)})
        return 1

    def leave(self) -> None:
        """Broadcast a graceful leave before shutdown."""
        with self._lock:
            me = self._members[self.addr]
            me.status = LEFT
            me.incarnation += 1
            peers = [m.addr for m in self._members.values()
                     if m.status == ALIVE and m.addr != self.addr]
        for peer in peers:
            self._send(peer, {"t": "ack", "seq": 0,
                              "from": list(self.addr)})

    def force_leave(self, name_or_addr) -> None:
        with self._lock:
            for m in self._members.values():
                if m.tags.get("name") == name_or_addr or \
                        f"{m.addr[0]}:{m.addr[1]}" == name_or_addr:
                    m.status = LEFT
                    m.status_at = time.monotonic()

    def shutdown(self) -> None:
        self.leave()
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass
        # Reap both loops: the rx loop pops out on the closed socket /
        # its 0.2s recv timeout, the probe loop on its next stop check.
        # Leaving them running leaked two threads per torn-down server
        # (analyzer: thread-leak).
        if self._rx is not threading.current_thread():
            self._rx.join(3.0)
        if self._probe is not threading.current_thread():
            self._probe.join(3.0)

    # -- wire ---------------------------------------------------------------
    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _snapshot(self) -> list:
        with self._lock:
            return [m.to_wire() for m in self._members.values()]

    def _send(self, addr: tuple, msg: dict) -> None:
        msg["members"] = self._snapshot()
        try:
            self.sock.sendto(msgpack.packb(msg, use_bin_type=True),
                             tuple(addr))
        except OSError:
            pass

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                # faultlint-ok(uninjectable-io): best-effort UDP gossip
                # — drops ARE the protocol's normal case; deterministic
                # chaos rides the RPC/heartbeat sites.
                data, _src = self.sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                msg = msgpack.unpackb(data, raw=False,
                                      strict_map_key=False)
            except Exception:
                continue
            self._merge(msg.get("members") or [])
            kind = msg.get("t")
            sender = tuple(msg.get("from", ()))
            if kind == "ping":
                self._send(sender, {"t": "ack", "seq": msg["seq"],
                                    "from": list(self.addr)})
            elif kind == "ack":
                ev = self._acks.pop(msg.get("seq"), None)
                if ev is not None:
                    ev.set()
            elif kind == "ping-req":
                # Indirect probe: ping the target on the requester's
                # behalf and relay the ack.
                target = tuple(msg["target"])
                seq = self._next_seq()
                ev = threading.Event()
                self._acks[seq] = ev
                self._send(target, {"t": "ping", "seq": seq,
                                    "from": list(self.addr)})
                if ev.wait(self.probe_timeout):
                    self._send(sender, {"t": "ack", "seq": msg["seq"],
                                        "from": list(self.addr)})

    # -- membership ---------------------------------------------------------
    def _merge(self, members: list) -> None:
        joined, failed, left = [], [], []
        with self._lock:
            for w in members:
                addr = tuple(w["addr"])
                if addr == self.addr:
                    # Refute rumors about ourselves.
                    me = self._members[self.addr]
                    if w["status"] != ALIVE and \
                            w["incarnation"] >= me.incarnation:
                        me.incarnation = w["incarnation"] + 1
                    continue
                existing = self._members.get(addr)
                if existing is None:
                    m = Member(addr, w.get("tags") or {},
                               w.get("incarnation", 0),
                               w.get("status", ALIVE))
                    self._members[addr] = m
                    if m.status == ALIVE:
                        joined.append(m)
                    continue
                inc = w.get("incarnation", 0)
                status = w.get("status", ALIVE)
                if inc < existing.incarnation:
                    continue
                if inc == existing.incarnation and \
                        _rank(status) <= _rank(existing.status):
                    continue
                was = existing.status
                existing.incarnation = inc
                existing.status = status
                existing.status_at = time.monotonic()
                existing.tags = w.get("tags") or existing.tags
                if status == ALIVE and was != ALIVE:
                    joined.append(existing)
                elif status == DEAD and was != DEAD:
                    failed.append(existing)
                elif status == LEFT and was != LEFT:
                    left.append(existing)
        for m in joined:
            self._emit(self.on_join, m)
        for m in failed:
            self._emit(self.on_fail, m)
        for m in left:
            self._emit(self.on_leave, m)

    def _emit(self, cb, member: Member) -> None:
        if cb is None:
            return
        try:
            cb(member)
        except Exception:
            logger.exception("gossip event callback failed")

    # -- failure detection ---------------------------------------------------
    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.probe_interval)
            if self._stop.is_set():
                return
            target = self._pick_probe_target()
            if target is not None:
                self._probe_member(target)
            self._expire_suspects()

    def _pick_probe_target(self) -> Optional[Member]:
        with self._lock:
            candidates = [m for m in self._members.values()
                          if m.addr != self.addr and
                          m.status in (ALIVE, SUSPECT)]
        return random.choice(candidates) if candidates else None

    def _probe_member(self, member: Member) -> None:
        seq = self._next_seq()
        ev = threading.Event()
        self._acks[seq] = ev
        self._send(member.addr, {"t": "ping", "seq": seq,
                                 "from": list(self.addr)})
        if ev.wait(self.probe_timeout):
            self._mark(member.addr, ALIVE)
            return
        # Indirect probes via up to 3 other members.
        with self._lock:
            others = [m.addr for m in self._members.values()
                      if m.status == ALIVE and
                      m.addr not in (self.addr, member.addr)]
        seq2 = self._next_seq()
        ev2 = threading.Event()
        self._acks[seq2] = ev2
        for relay in random.sample(others, min(3, len(others))):
            self._send(relay, {"t": "ping-req", "seq": seq2,
                               "from": list(self.addr),
                               "target": list(member.addr)})
        if ev2.wait(self.probe_timeout * 2):
            self._mark(member.addr, ALIVE)
        else:
            self._mark(member.addr, SUSPECT)

    def _mark(self, addr: tuple, status: str) -> None:
        failed = None
        with self._lock:
            m = self._members.get(addr)
            if m is None or m.status == status:
                return
            if status == SUSPECT and m.status == ALIVE:
                m.status = SUSPECT
                m.status_at = time.monotonic()
            elif status == ALIVE:
                m.status = ALIVE
                m.status_at = time.monotonic()

    def _expire_suspects(self) -> None:
        failed = []
        with self._lock:
            now = time.monotonic()
            for m in self._members.values():
                if m.status == SUSPECT and \
                        now - m.status_at > self.suspect_timeout:
                    m.status = DEAD
                    m.status_at = now
                    failed.append(m)
        for m in failed:
            self._emit(self.on_fail, m)


def _rank(status: str) -> int:
    return {ALIVE: 0, SUSPECT: 1, LEFT: 2, DEAD: 3}.get(status, 0)
