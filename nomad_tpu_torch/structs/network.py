"""Network resource indexing: port + bandwidth accounting per node.

Capability parity with reference nomad/structs/network.go:21-204.
Port assignment for dynamic ports stays host-side (inherently sequential);
the device-side scheduler models bandwidth and port-slot capacity as extra
resource dims so its fit mask over-approximates soundly before this exact
assignment runs.
"""
from __future__ import annotations

import ipaddress
import random
from typing import Optional

from .model import (
    MAX_DYNAMIC_PORT,
    MAX_RAND_PORT_ATTEMPTS,
    MIN_DYNAMIC_PORT,
    Allocation,
    NetworkResource,
    Node,
)


_CIDR_CACHE: dict = {}
_CIDR_CACHE_MAX_IPS = 256


def _cidr_ips(cidr: str):
    """Yield a CIDR's IP strings; the first 256 are cached (node CIDRs are
    static and usually /32 — re-parsing per placement dominated the
    scheduler's host time), the rest iterate lazily so a /8 or IPv6 block
    never materializes in memory."""
    cached = _CIDR_CACHE.get(cidr)
    if cached is None:
        try:
            net = ipaddress.ip_network(cidr, strict=False)
        except ValueError:
            _CIDR_CACHE[cidr] = ([], True)
            return
        head: list = []
        complete = True
        for ip in net:
            if len(head) >= _CIDR_CACHE_MAX_IPS:
                complete = False
                break
            head.append(str(ip))
        if len(_CIDR_CACHE) > 65536:
            _CIDR_CACHE.clear()
        _CIDR_CACHE[cidr] = cached = (head, complete)
    head, complete = cached
    yield from head
    if not complete:
        for i, ip in enumerate(ipaddress.ip_network(cidr, strict=False)):
            if i >= _CIDR_CACHE_MAX_IPS:
                yield str(ip)


class NetworkIndex:
    """Tracks available and used network resources on one node."""

    def __init__(self) -> None:
        self.avail_networks: list[NetworkResource] = []
        self.avail_bandwidth: dict[str, int] = {}
        self.used_ports: dict[str, set[int]] = {}
        self.used_bandwidth: dict[str, int] = {}

    def overcommitted(self) -> bool:
        for device, used in self.used_bandwidth.items():
            if used > self.avail_bandwidth.get(device, 0):
                return True
        return False

    def set_node(self, node: Node) -> bool:
        """Register the node's networks; True if reserved ports collide."""
        collide = False
        for n in node.resources.networks:
            if n.device:
                self.avail_networks.append(n)
                self.avail_bandwidth[n.device] = n.mbits
        if node.reserved is not None:
            for n in node.reserved.networks:
                if self.add_reserved(n):
                    collide = True
        return collide

    def add_allocs(self, allocs: list[Allocation]) -> bool:
        collide = False
        for alloc in allocs:
            for task_res in alloc.task_resources.values():
                if not task_res.networks:
                    continue
                if self.add_reserved(task_res.networks[0]):
                    collide = True
        return collide

    def add_reserved(self, n: NetworkResource) -> bool:
        collide = False
        used = self.used_ports.setdefault(n.ip, set())
        for port in n.reserved_ports:
            if port in used:
                collide = True
            else:
                used.add(port)
        self.used_bandwidth[n.device] = \
            self.used_bandwidth.get(n.device, 0) + n.mbits
        return collide

    def remove_reserved(self, n: NetworkResource) -> None:
        """Undo add_reserved (speculative offers rolled back)."""
        used = self.used_ports.get(n.ip)
        if used is not None:
            for port in n.reserved_ports:
                used.discard(port)
        self.used_bandwidth[n.device] = \
            self.used_bandwidth.get(n.device, 0) - n.mbits

    def _yield_ips(self):
        for n in self.avail_networks:
            for ip in _cidr_ips(n.cidr):
                yield n, ip

    def assign_network(
        self, ask: NetworkResource,
        rng: Optional[random.Random] = None,
    ) -> tuple[Optional[NetworkResource], str]:
        """Offer an IP + ports satisfying the ask, or (None, reason)."""
        rng = rng or random
        err = "no networks available"
        for n, ip_str in self._yield_ips():
            if (self.used_bandwidth.get(n.device, 0) + ask.mbits
                    > self.avail_bandwidth.get(n.device, 0)):
                err = "bandwidth exceeded"
                continue

            used = self.used_ports.get(ip_str)
            if used is None:
                used = self.used_ports.setdefault(ip_str, set())

            if any(port in used for port in ask.reserved_ports):
                err = "reserved port collision"
                continue

            offer = NetworkResource(
                device=n.device,
                ip=ip_str,
                mbits=ask.mbits,
                reserved_ports=list(ask.reserved_ports),
                dynamic_ports=list(ask.dynamic_ports),
            )

            ok = True
            for _ in range(len(ask.dynamic_ports)):
                for attempt in range(MAX_RAND_PORT_ATTEMPTS):
                    port = rng.randrange(MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT)
                    if port not in used and port not in offer.reserved_ports:
                        offer.reserved_ports.append(port)
                        break
                else:
                    ok = False
                    break
            if not ok:
                err = "dynamic port selection failed"
                continue

            return offer, ""
        return None, err
