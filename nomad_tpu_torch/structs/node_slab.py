"""Columnar node table: a fleet of 100k-1M nodes without a Node object
graph per row.

Counterpart of ``nomad_tpu/structs/node_slab.py``.  At 100k-1M nodes the
cost is not device memory but the per-object node table feeding it: a
full ``Node`` costs ~8 Python objects (Resources + NetworkResource
pairs, four dicts), so a 1M-node fleet is ~8M objects to build, walk
and collect before a single tensor uploads.  ``NodeSlab`` stores such a
fleet as columns:

  - ONE template carries everything a (near-)uniform fleet shares —
    resource/reserved protos, network shapes, attributes/meta/links,
    node class, status — and dense columns carry the per-row scalars
    (ids, names, datacenters, per-row ip/cidr);
  - each store row is a tiny lazy ``SlabNode`` whose heavy fields
    (``resources``/``reserved``/``attributes``/``links``/``meta``)
    are data-descriptor properties materializing from the slab on
    first read, equal to the object path's;
  - the state->device bridge (models/fleet.build_fleet) reads the
    slab's dense vectors directly — no per-node Python walk — and
    constraint masks compile ONCE per (constraint, slab) instead of
    once per (constraint, node) because the slab declares attribute
    uniformity.

``state/store.upsert_node_slab`` bulk-registers a slab in one lock
hold.  A slab row that is *written* through the object API
(status/drain updates) detaches into a plain copied row, and the fleet
bridge then reads the whole table as objects.
"""
from __future__ import annotations

import weakref

import numpy as np

from .model import (
    NODE_STATUS_READY,
    NetworkResource,
    Node,
    Resources,
)

_MISS = object()

# Heavy Node fields backed by slab columns/templates.  Everything else
# is an eager scalar (or a dataclass class-attribute default).
_NODE_LAZY = ("resources", "reserved", "attributes", "links", "meta")


def _node_lazy_field(name: str):
    """Data-descriptor for one heavy Node field: reads materialize from
    the slab on first access; writes mark the row mutated (``_hmut``)
    so the fleet fast path stops speaking for this object."""

    def _get(self):
        d = self.__dict__
        v = d.get(name, _MISS)
        if v is _MISS:
            v = d[name] = self._nslab.materialize(self._nrow, name)
        return v

    def _set(self, value):
        d = self.__dict__
        d[name] = value
        mut = d.get("_hmut")
        if mut is None:
            mut = d["_hmut"] = set()
        mut.add(name)

    return property(_get, _set)


class SlabNode(Node):
    """A Node backed by one NodeSlab row.

    Eagerly carries only the scalars the store/scheduler hot paths read
    (id, name, datacenter, status, indexes) plus ``_nslab``/``_nrow``;
    the heavy fields materialize lazily.  Materialized dicts/Resources
    are fresh per row (never the shared template itself), so callers
    keep the full Node mutability contract on their copies."""

    resources = _node_lazy_field("resources")
    reserved = _node_lazy_field("reserved")
    attributes = _node_lazy_field("attributes")
    links = _node_lazy_field("links")
    meta = _node_lazy_field("meta")

    def __setattr__(self, name, value):
        # ANY public-field write (status/drain flips on store copies
        # included) marks the row mutated: the slab no longer speaks
        # for this object, so the fleet fast path (node_slab_of) must
        # fall back to reading it as an object.  Internal caches
        # (underscore names) stay exempt.
        if not name.startswith("_"):
            d = self.__dict__
            mut = d.get("_hmut")
            if mut is None:
                mut = d["_hmut"] = set()
            mut.add(name)
        super().__setattr__(name, value)

    def copy(self) -> "SlabNode":
        # Node.copy() would read every heavy field through the
        # properties and deep-copy it; a slab-backed copy is one small
        # dict copy — materialized fields (already fresh per row) are
        # re-copied so the copy honors Node.copy()'s deep-dict contract.
        new = SlabNode.__new__(SlabNode)
        d = dict(self.__dict__)
        mut = d.get("_hmut")
        if mut is not None:
            d["_hmut"] = set(mut)
        for name in _NODE_LAZY:
            v = d.get(name)
            if v is None:
                continue
            d[name] = v.copy() if isinstance(v, Resources) else dict(v)
        new.__dict__ = d
        return new


def _net_from_proto(proto: dict, **overrides) -> NetworkResource:
    n = NetworkResource.__new__(NetworkResource)
    d = dict(proto)
    d["reserved_ports"] = list(d.get("reserved_ports", ()))
    d["dynamic_ports"] = list(d.get("dynamic_ports", ()))
    d.update(overrides)
    n.__dict__ = d
    return n


class NodeSlab:
    """Dense columns + one shared template for a homogeneous node fleet.

    ``template`` is a fully-formed Node whose resources/reserved/
    attributes/meta/links every row shares except for the per-row
    network endpoints: row r's ``resources`` network carries
    ``cidrs[r]`` and its ``reserved`` network carries ``ips[r]`` (None
    columns mean the template's own values everywhere).  Because the
    shared fields are uniform by construction, the slab can declare
    ``uniform=True`` and the fleet bridge compiles each constraint mask
    against ONE representative row instead of walking the fleet.
    """

    __slots__ = ("__weakref__", "n", "ids", "names", "datacenters",
                 "cidrs", "ips", "template", "index",
                 "_res_proto", "_res_net", "_rsv_proto", "_rsv_net",
                 "_cap6", "_rsv6", "_cache")

    def __init__(self, ids: list, names: list, datacenters,
                 template: Node, cidrs=None, ips=None) -> None:
        n = len(ids)
        self.n = n
        self.ids = ids
        self.names = names
        # Shared string when the whole slab lives in one datacenter.
        self.datacenters = datacenters
        self.cidrs = cidrs
        self.ips = ips
        self.template = template
        self.index = 0
        # Split the template into protos once: materialization is a
        # dict copy + per-row endpoint insert, no attribute walks.
        res = template.resources
        self._res_proto = {k: v for k, v in res.__dict__.items()
                           if k != "networks"}
        self._res_net = res.networks[0].__dict__ if res.networks else None
        rsv = template.reserved
        if rsv is not None:
            self._rsv_proto = {k: v for k, v in rsv.__dict__.items()
                               if k != "networks"}
            self._rsv_net = rsv.networks[0].__dict__ if rsv.networks \
                else None
        else:
            self._rsv_proto = None
            self._rsv_net = None
        # Canonical per-row vectors (uniform across rows: per-row
        # endpoints never change mbits/port counts).
        self._cap6 = np.asarray(res.as_vector(), dtype=np.float32)
        self._rsv6 = np.asarray(rsv.as_vector(), dtype=np.float32) \
            if rsv is not None else np.zeros(6, dtype=np.float32)
        # Canonical row objects, weakly held: the store's table keeps
        # rows alive; a dropped generation frees its rows
        # refcount-only.
        self._cache: "weakref.WeakValueDictionary" = \
            weakref.WeakValueDictionary()

    # -- columnar reads (the fleet bridge) ---------------------------------
    def datacenter_of(self, r: int) -> str:
        dc = self.datacenters
        return dc if isinstance(dc, str) else dc[r]

    def capacity_vec(self) -> np.ndarray:
        """f32[6] shared capacity vector (uniform fleet)."""
        return self._cap6

    def reserved_vec(self) -> np.ndarray:
        return self._rsv6

    def ready(self) -> bool:
        t = self.template
        return t.status == NODE_STATUS_READY and not t.drain

    # -- lazy materialization ----------------------------------------------
    def materialize(self, r: int, name: str):
        if name == "resources":
            res = Resources.__new__(Resources)
            d = dict(self._res_proto)
            if self._res_net is not None:
                cidr = self.cidrs[r] if self.cidrs is not None else None
                net = _net_from_proto(self._res_net) if cidr is None \
                    else _net_from_proto(self._res_net, cidr=cidr)
                d["networks"] = [net]
            else:
                d["networks"] = []
            res.__dict__ = d
            return res
        if name == "reserved":
            if self._rsv_proto is None:
                return None
            rsv = Resources.__new__(Resources)
            d = dict(self._rsv_proto)
            if self._rsv_net is not None:
                ip = self.ips[r] if self.ips is not None else None
                net = _net_from_proto(self._rsv_net) if ip is None \
                    else _net_from_proto(self._rsv_net, ip=ip)
                d["networks"] = [net]
            else:
                d["networks"] = []
            rsv.__dict__ = d
            return rsv
        if name == "attributes":
            return dict(self.template.attributes)
        if name == "links":
            return dict(self.template.links)
        if name == "meta":
            return dict(self.template.meta)
        raise KeyError(name)

    # -- row objects -------------------------------------------------------
    def _eager(self, r: int) -> dict:
        t = self.template
        return {
            "id": self.ids[r], "name": self.names[r],
            "datacenter": self.datacenter_of(r),
            "node_class": t.node_class, "status": t.status,
            "drain": t.drain,
            "create_index": self.index, "modify_index": self.index,
            "_nslab": self, "_nrow": r,
        }

    def node(self, r: int) -> SlabNode:
        """The canonical SlabNode for row ``r`` (weakly cached)."""
        node = self._cache.get(r)
        if node is None:
            node = SlabNode.__new__(SlabNode)
            node.__dict__ = self._eager(r)
            self._cache[r] = node
        return node

    def rows(self) -> list:
        return [self.node(r) for r in range(self.n)]


def node_slab_of(nodes: list):
    """The NodeSlab speaking for EVERY node in ``nodes`` (in row
    order, unmutated), or None — the fleet bridge's fast-path probe.
    A single mutated/foreign/out-of-order row disqualifies the slab:
    correctness first, the object walk handles mixed tables."""
    if not nodes:
        return None
    slab = nodes[0].__dict__.get("_nslab")
    if slab is None or slab.n != len(nodes):
        return None
    for i, node in enumerate(nodes):
        d = node.__dict__
        if d.get("_nslab") is not slab or d.get("_nrow") != i \
                or "_hmut" in d:
            return None
    return slab
