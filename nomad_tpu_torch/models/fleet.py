"""Fleet tensorization: the state -> device bridge.

Converts the host data model (Node/Allocation objects in the MVCC store)
into the device-resident tensors the torch-binpack scheduler consumes:

  capacity  f32[N, D]   node.resources       (D = ALL_FIT_DIMS = 6)
  reserved  f32[N, D]   node.reserved
  ready     bool[N]     status == ready and not draining
  dc_codes  i32[N]      interned datacenter id

plus host-side numpy mirrors used to compile constraint masks
(nomad_tpu_torch/models/constraints.py).  Capability parity role: this is the
device-side replacement for the iterator walk over memdb state in
reference scheduler/feasible.go + rank.go — instead of lazily visiting
nodes, the whole fleet is resident on device and every candidate is scored in
one dispatch.

Caching contract: the state store is copy-on-write at table granularity, so
the identity of a snapshot's frozen ``nodes`` table dict is a sound cache key
— if any node changes, the store swaps in a new dict.  ``fleet_cache`` keys
static tensors on that identity; per-eval dynamic state (usage, job counts)
is rebuilt from the allocs table (vectorized, numpy) and cached the same way.

Port/bandwidth dims are a *sound over-approximation* of the exact host-side
NetworkIndex accounting (reference nomad/structs/network.go): the device mask
never admits a node the exact check would reject on total bandwidth, and the
exact per-device/port assignment runs host-side after selection
(SURVEY.md section 7, "Network/port allocation").
"""
from __future__ import annotations

import itertools
import threading

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from nomad_tpu_torch.obs import trace as obs_trace
from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.structs import (
    ALL_FIT_DIMS,
    NODE_STATUS_READY,
    Allocation,
    Node,
    Resources,
)
from nomad_tpu_torch.utils.sync import CopySwap

NDIMS = len(ALL_FIT_DIMS)  # cpu, memory_mb, disk_mb, iops, mbits, port_slots

# Dynamic port range size: the port_slots capacity over-approximation
# (reference nomad/structs/network.go:9-18 — 20000..60000 dynamic ports).
PORT_SLOTS_CAPACITY = 40000.0


def _res_vector(res: Optional[Resources]) -> np.ndarray:
    if res is None:
        return np.zeros(NDIMS, dtype=np.float32)
    return np.asarray(res.as_vector(), dtype=np.float32)


def alloc_vec(alloc: "Allocation") -> np.ndarray:
    """Cached resource vector of an allocation.  Sound because committed
    allocations are replaced, never mutated (the store immutability
    contract, tests/test_state_store.py) — a new record is a new object
    with an empty cache; dataclasses.replace()-based copies don't carry
    the cache either.

    Slab-backed allocs (structs/alloc_slab.py) read the vector straight
    from the slab's per-slot columns — shared read-only across the
    slot's rows — without materializing ``resources``; an alloc whose
    ``resources`` was already materialized (or reassigned) keeps the
    object truth."""
    d = alloc.__dict__
    vec = d.get("_res_vec")
    if vec is None:
        slab = d.get("_slab")
        if slab is not None and "resources" not in d:
            vec = slab.vec(d["_srow"])
        else:
            vec = _res_vector(alloc.resources)
        d["_res_vec"] = vec
    return vec


def _pad_to(n: int) -> int:
    """Next power of two >= n (>= 8): the node axis of every device
    tensor (the kernels' bitonic top-k needs a power of two)."""
    p = 8
    while p < n:
        p *= 2
    return p


_FLEET_GEN = itertools.count()


class ShardedResidency:
    """THE residency policy for node-axis-sharded device caches.

    Every mesh-resident twin (statics capacity/reserved, per-job
    feasibility rows, the usage mirror's sharded copies) lives in one of
    these: entries are keyed by (class, ..., mesh) where ``key[0]`` names
    the entry's class ("capres" / "feas" / "usage"), bounded at
    ``max_resident`` entries PER CLASS with the whole class evicted at
    its bound, so a stream of distinct job versions churning feasibility
    entries can never evict the capacity/reserved or usage twins.  Each
    entry carries its scatters-since-upload count.  When a mesh resolves
    for a dispatch (parallel/mesh.dispatch_mesh), the operands here are
    the PRIMARY device copies."""

    __slots__ = ("max_resident", "_res")

    def __init__(self, max_resident: int = 4) -> None:
        self.max_resident = max_resident
        self._res: dict = {}   # key -> [operands tuple, scatter count]

    def lookup(self, key):
        entry = self._res.get(key)
        return entry[0] if entry is not None else None

    def prepare(self, mesh, arrays, spec=None) -> tuple:
        """EXPLICIT sharded upload (counted, one h2d per array) of
        ``arrays`` for ``mesh`` (node axis by default; ``spec`` cuts
        e.g. [G, N] group-major rows) WITHOUT touching the residency
        dict: a caller that serves readers under a lock (the usage
        mirror) uploads through this outside the lock, then ``adopt``s
        the result under it."""
        from nomad_tpu_torch.parallel.devices import note_transfer
        from nomad_tpu_torch.parallel.mesh import NODE, _shard

        note_transfer("h2d", len(arrays))
        return tuple(_shard(a, mesh, NODE if spec is None else spec)
                     for a in arrays)

    def adopt(self, key, arrays) -> tuple:
        """Make already-uploaded ``arrays`` (from ``prepare``) resident
        under ``key``; the per-class eviction bound applies here."""
        if key not in self._res:
            kind = key[0]
            same = [k for k in self._res if k[0] == kind]
            if len(same) >= self.max_resident:
                for k in same:
                    del self._res[k]
        self._res[key] = [arrays, 0]
        return arrays

    def install(self, key, mesh, arrays, spec=None) -> tuple:
        """prepare + adopt in one step, for callers holding no lock."""
        return self.adopt(key, self.prepare(mesh, arrays, spec=spec))

    def replace(self, key, arrays) -> None:
        """Swap a maintained entry's operands (scatter update) and count
        the scatter against its refresh budget."""
        entry = self._res[key]
        entry[0] = arrays
        entry[1] += 1

    def scatters(self, key) -> int:
        entry = self._res.get(key)
        return entry[1] if entry is not None else 0

    def drop(self, key) -> None:
        self._res.pop(key, None)

    def clear(self) -> None:
        self._res.clear()

    def keys(self) -> list:
        return list(self._res)


@dataclass
class FleetStatics:
    """Node-static tensors + host mirrors, cached per nodes-table generation."""

    n_real: int
    n_pad: int
    node_ids: list                      # index -> node id (real rows only)
    index_of: dict                      # node id -> index
    nodes: list                         # index -> Node (host objects)
    capacity: np.ndarray                # f32[n_pad, D]
    reserved: np.ndarray                # f32[n_pad, D]
    ready: np.ndarray                   # bool[n_pad] (padding rows False)
    datacenters: np.ndarray             # object[n_pad] (host-side dc strings)
    # Host-side attribute/meta mirrors for constraint compilation:
    attr_rows: list                     # index -> node.attributes dict
    meta_rows: list                     # index -> node.meta dict
    # True when the fleet came off a NodeSlab declaring row uniformity
    # (shared attributes/meta/class/datacenter): constraint masks then
    # compile against ONE representative row and broadcast
    # (models/constraints.py) instead of walking 100k-1M nodes.
    uniform: bool = False
    mask_cache: dict = field(default_factory=dict)   # constraint-key -> bool[n_pad]
    # Device-resident mirrors, populated lazily (torch tensors).  Keys:
    # "capres" -> (capacity, reserved); ("feas", group-keys) -> bool[G, N].
    # Keeping these resident avoids re-uploading the fleet every eval —
    # at 10k nodes the feasibility matrix transfer dominates eval latency.
    device_cache: dict = field(default_factory=dict)
    # Mesh-resident twins (capacity/reserved, sharded feasibility rows)
    # behind the one residency policy; PRIMARY when a mesh resolves for
    # the dispatch.
    sharded: ShardedResidency = field(default_factory=ShardedResidency)
    # node_index -> (frozen used_ports, bw_used, bw_avail, ip, device) or
    # None: the node-static half of the fast network assigner
    # (scheduler/torch_binpack.py _node_net_init).
    net_base: dict = field(default_factory=dict)
    # Process-unique generation id: lets per-job prep caches key on the
    # fleet generation WITHOUT holding a strong ref that would pin
    # evicted generations (and their device buffers) alive.
    gen: int = field(default_factory=lambda: next(_FLEET_GEN))
    # Lazily attached incremental usage mirror (see mirror_for()).
    mirror: Optional["UsageMirror"] = None

    def device_capacity_reserved(self, device):
        """(capacity, reserved) resident on ``device``, uploaded once per
        fleet generation and device."""
        from nomad_tpu_torch.parallel.devices import put_counted
        hit = self.capres_lease(device)
        if hit is None:
            hit = (put_counted(self.capacity, device),
                   put_counted(self.reserved, device))
            self.device_cache["capres"] = hit
        return hit

    def capres_lease(self, device):
        """(capacity, reserved) when already resident on ``device``,
        else None.  Never uploads: the window verify calls it under the
        mirror lock, where a fleet-sized transfer would park every
        other sync; ``device_capacity_reserved`` warms it outside."""
        from nomad_tpu_torch.parallel.devices import on_default_platform
        hit = self.device_cache.get("capres")
        if hit is None or not on_default_platform(hit[0], device):
            return None
        return hit


    def device_capacity_reserved_sharded(self, mesh):
        """Mesh-resident (node-axis-sharded) capacity/reserved, the
        PRIMARY copies for sharded dispatches, uploaded once per (fleet
        generation, mesh) under the residency policy."""
        key = ("capres", mesh)
        hit = self.sharded.lookup(key)
        if hit is None:
            hit = self.sharded.install(key, mesh,
                                       (self.capacity, self.reserved))
        return hit

    def device_feasible_sharded(self, mesh, feas_key, host: np.ndarray):
        """Mesh-resident [G, N] feasibility rows of one prep-cache
        feasibility entry, node axis sharded (group axis whole),
        uploaded once per (feas_key, mesh) like capacity/reserved."""
        from nomad_tpu_torch.parallel.mesh import GROUP_NODE

        key = ("feas", feas_key, mesh)
        hit = self.sharded.lookup(key)
        if hit is None:
            hit = self.sharded.install(key, mesh, (host,), spec=GROUP_NODE)
        return hit[0]


def build_fleet(nodes: list[Node]) -> FleetStatics:
    """State -> fleet tensors (host numpy; uploaded on first use).
    Columnar fast path: when every node is an unmutated row of ONE
    NodeSlab (structs/node_slab.py — the 100k-1M-node bulk-load
    shape), the static tensors come straight off the slab's dense
    vectors and shared template, with no per-node Python walk; a
    single mutated or foreign row falls the whole build back to the
    exact object path."""
    from nomad_tpu_torch.structs import node_slab_of

    slab = node_slab_of(nodes)
    if slab is not None:
        return _build_fleet_slab(nodes, slab)
    n_real = len(nodes)
    n_pad = _pad_to(n_real)

    capacity = np.zeros((n_pad, NDIMS), dtype=np.float32)
    reserved = np.zeros((n_pad, NDIMS), dtype=np.float32)
    ready = np.zeros(n_pad, dtype=bool)
    datacenters = np.empty(n_pad, dtype=object)
    attr_rows, meta_rows, node_ids = [], [], []
    index_of: dict = {}

    for i, node in enumerate(nodes):
        node_ids.append(node.id)
        index_of[node.id] = i
        cap = _res_vector(node.resources)
        cap[5] = PORT_SLOTS_CAPACITY  # port_slots capacity over-approximation
        capacity[i] = cap
        reserved[i] = _res_vector(node.reserved)
        ready[i] = node.status == NODE_STATUS_READY and not node.drain
        datacenters[i] = node.datacenter
        attr_rows.append(node.attributes)
        meta_rows.append(node.meta)

    return FleetStatics(
        n_real=n_real,
        n_pad=n_pad,
        node_ids=node_ids,
        index_of=index_of,
        nodes=list(nodes),
        capacity=capacity,
        reserved=reserved,
        ready=ready,
        datacenters=datacenters,
        attr_rows=attr_rows,
        meta_rows=meta_rows,
    )


def _build_fleet_slab(nodes: list, slab) -> FleetStatics:
    """FleetStatics off one NodeSlab's columns: broadcast vectors, the
    shared attribute/meta template per row, and ``uniform=True`` when
    the slab's rows share one datacenter — the flag the constraint
    compiler uses to judge ONE representative row for the whole
    fleet."""
    n_real = slab.n
    n_pad = _pad_to(n_real)
    capacity = np.zeros((n_pad, NDIMS), dtype=np.float32)
    capacity[:n_real] = slab.capacity_vec()
    capacity[:n_real, 5] = PORT_SLOTS_CAPACITY
    reserved = np.zeros((n_pad, NDIMS), dtype=np.float32)
    reserved[:n_real] = slab.reserved_vec()
    ready = np.zeros(n_pad, dtype=bool)
    ready[:n_real] = slab.ready()
    datacenters = np.empty(n_pad, dtype=object)
    uniform = isinstance(slab.datacenters, str)
    if uniform:
        datacenters[:n_real] = slab.datacenters
    else:
        for i in range(n_real):
            datacenters[i] = slab.datacenters[i]
    attrs = slab.template.attributes
    meta = slab.template.meta
    return FleetStatics(
        n_real=n_real,
        n_pad=n_pad,
        node_ids=list(slab.ids),
        index_of={nid: i for i, nid in enumerate(slab.ids)},
        nodes=list(nodes),
        capacity=capacity,
        reserved=reserved,
        ready=ready,
        datacenters=datacenters,
        # Shared template per row: mask compilation treats these as
        # read-only (the store immutability contract), and the uniform
        # flag means it rarely reads past row 0 anyway.
        attr_rows=_SharedRows(attrs, n_real),
        meta_rows=_SharedRows(meta, n_real),
        uniform=uniform,
    )


class _SharedRows:
    """A list-shaped view serving ONE shared row dict for every index —
    the uniform fleet's attr/meta mirror without n_real pointers."""

    __slots__ = ("row", "n")

    def __init__(self, row, n: int) -> None:
        self.row = row
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        if isinstance(i, int) and -self.n <= i < self.n:
            return self.row
        raise IndexError(i)


def net_base_for(statics: FleetStatics, node_index: int, node):
    """Node-static network base for the fast port/bandwidth paths:
    ``(frozen reserved-ports, reserved mbits, bandwidth capacity, ip,
    device)`` or None for topologies that need the exact NetworkIndex
    walk (multi-network nodes, unresolvable ip).  Cached on the fleet
    statics; shared by the scheduler's fast assigner
    (scheduler/torch_binpack.FastPlacementMixin)."""
    base_cache = statics.net_base
    base = base_cache.get(node_index, False)
    if base is not False:
        return base
    from nomad_tpu_torch.structs.network import _cidr_ips

    base = None
    nets = [n for n in node.resources.networks if n.device] \
        if node.resources is not None else []
    if len(nets) == 1:
        n0 = nets[0]
        ip = n0.ip
        if not ip:
            for ip in _cidr_ips(n0.cidr):
                break
        if ip:
            used: set = set()
            bw_used = 0
            if node.reserved is not None:
                for rn in node.reserved.networks:
                    used.update(rn.reserved_ports)
                    bw_used += rn.mbits
            base = (frozenset(used), bw_used, n0.mbits, ip,
                    n0.device)
    base_cache[node_index] = base
    return base


# Sentinel net key for allocs whose offers span ips/devices (or carry
# in-alloc oddities): forces the exact NetworkIndex path for their node.
NET_KEY_ODD = ("__odd__", "__odd__")


def _net_row(alloc: Allocation):
    """The plan verifier's network row for one alloc: ``(ports, mbits,
    (ip, device))`` aggregated over the FIRST network of each task —
    exactly the set NetworkIndex.add_allocs accounts (reference
    nomad/structs/network.go AddAllocs) — or None when the alloc
    reserves no network.  Offers spanning multiple ips or devices get
    NET_KEY_ODD.  Cached on the alloc under the same immutability
    contract as ``alloc_vec`` (store objects are replaced, never
    mutated)."""
    d = alloc.__dict__
    row = d.get("_net_row")
    if row is not None:
        return row[0]
    slab = d.get("_slab")
    if slab is not None and "task_resources" not in d:
        # Columnar fast path: ports/mbits/(ip, device) straight from
        # the slab columns — no task_resources materialization.  The
        # slab builds exactly what _net_row_build would compute on the
        # materialized row (single-network offers by construction).
        built = slab.net_row(d["_srow"])
    else:
        built = _net_row_build(alloc)
    d["_net_row"] = (built,)
    return built


def _net_row_build(alloc: Allocation):
    ports: list = []
    mbits = 0
    key = None
    for task_res in alloc.task_resources.values():
        nets = task_res.networks
        if not nets:
            continue
        n0 = nets[0]
        ports.extend(n0.reserved_ports)
        mbits += n0.mbits
        k = (n0.ip, n0.device)
        if key is None:
            key = k
        elif k != key:
            key = NET_KEY_ODD
    if key is None and not mbits:
        return None
    return (tuple(ports), mbits, key or NET_KEY_ODD)


# Sentinel: a freshly-built mirror view whose device-usage attachment
# has not resolved yet (UsageMirror._attach_device runs outside the
# mirror lock and replaces it with a real buffer or None).  Never
# escapes view()/view_at().
_PENDING_DEVICE = object()


@dataclass
class FleetView:
    """One eval's dynamic view: statics + usage + same-job alloc counts."""

    statics: FleetStatics
    usage: np.ndarray       # f32[n_pad, D] — sum of non-terminal alloc asks
    job_counts: np.ndarray  # i32[n_pad] — proposed allocs of the eval's job
    # Set when the view came from a UsageMirror with no plan deltas:
    # usage_device is the mirror's device-resident copy of exactly `usage`,
    # so the dispatch can skip the host->device upload entirely.
    usage_device: Optional[object] = None

    def dispatch_usage(self):
        """The usage argument for a device dispatch: the resident device
        copy when the mirror has one, else the host array (uploaded by
        the dispatch through put_counted)."""
        return self.usage_device if self.usage_device is not None \
            else self.usage


def build_usage(statics: FleetStatics, allocs: list[Allocation],
                job_id: str = "") -> FleetView:
    """Aggregate per-node usage + same-job counts from an alloc list.

    Vectorized host-side: one np.add.at scatter instead of a Python loop per
    (alloc x dim).  Terminal allocs must already be filtered by the caller.
    """
    usage = np.zeros((statics.n_pad, NDIMS), dtype=np.float32)
    job_counts = np.zeros(statics.n_pad, dtype=np.int32)
    if allocs:
        idx = np.empty(len(allocs), dtype=np.int64)
        vecs = np.empty((len(allocs), NDIMS), dtype=np.float32)
        keep = 0
        for a in allocs:
            i = statics.index_of.get(a.node_id, -1)
            if i < 0:
                continue
            idx[keep] = i
            vecs[keep] = alloc_vec(a)
            if job_id and a.job_id == job_id:
                job_counts[i] += 1
            keep += 1
        np.add.at(usage, idx[:keep], vecs[:keep])
    return FleetView(statics=statics, usage=usage, job_counts=job_counts)


class UsageMirror:
    """Incremental state->device bridge for the dynamic half of the fleet.

    Maintains per-node aggregate usage, per-job sparse alloc counts and a
    device-resident usage copy, updated from the store's alloc changelog
    (state/store.py ``alloc_log``) with a RefreshIndex-style fence: a sync
    applies only the deltas between the mirror's allocs index and the
    snapshot's, so the eval hot path does O(changed) host work instead of
    rebuilding usage from every alloc in the store (SURVEY.md section 7
    "Incremental device state"; reference analogue: the alloc-watch feed
    of nomad/state/state_store.go:115-156).

    Concurrency: one mutator at a time (internal lock); readers take the
    current arrays by reference — sync replaces arrays copy-on-write, so
    a view handed to an in-flight eval never mutates under it.  The
    device copy is likewise never written in place: a scatter allocates
    a new device buffer (``scatter_rows``), so tensors held by in-flight
    dispatches stay valid.  The mirror only moves forward: ``sync``
    against a snapshot older than the mirror returns False and the
    caller falls back to a from-scratch ``build_usage`` for that eval.
    """

    # Re-upload the full usage tensor after this many incremental device
    # scatters, bounding float drift between host and device mirrors.
    DEVICE_REFRESH_EVERY = 2048
    # Scatter at most this many changed rows per sync; beyond it a fresh
    # upload is cheaper.
    MAX_SCATTER_ROWS = 1024

    def __init__(self, statics: FleetStatics) -> None:
        self.statics = statics
        self.usage = np.zeros((statics.n_pad, NDIMS), dtype=np.float32)
        self.job_counts: dict = {}   # job_id -> {node_index: count}
        self.alloc_rows: dict = {}   # alloc_id -> (ni, vec, job_id)
        self.index = -1
        self.rebuilds = 0            # full O(allocs) rebuilds (observability)
        self._lineage: object = None
        self._log_ref: Optional[list] = None
        self._log_pos = 0
        # Invariant: _usage_d is None or exactly equals self.usage.
        self._usage_d = None
        self._scatters_since_upload = 0
        # Mesh twins of _usage_d behind the residency policy: node-axis-
        # sharded resident copies (the PRIMARY usage of sharded
        # dispatches), one per mesh, bounded, maintained by the same
        # scatters as the single-device copy.  Invariant: every resident
        # value exactly equals self.usage.
        self._sharded = ShardedResidency()
        # Per-node port/bandwidth tracking for the vectorized plan
        # verifier (server/plan_apply).  Disabled until sync_net() is
        # first called so scheduler-only users pay nothing; once
        # enabled, maintained incrementally by the same delta walk as
        # usage.  All keyed by node index, empties pruned:
        #   net_rows:   alloc_id -> (ni, ports, mbits, (ip, device))
        #   node_ports: ni -> {port: live count}
        #   node_dup:   ni -> number of ports with count > 1
        #   node_bw:    ni -> sum of live offer mbits
        #   node_net_keys: ni -> {(ip, device): count} (NET_KEY_ODD rows
        #                  force the exact path for their node)
        self._net_ready = False
        self.net_rows: dict = {}
        self.node_ports: dict = {}
        self.node_dup: dict = {}
        self.node_bw: dict = {}
        self.node_net_keys: dict = {}
        # Reentrant so a caller can hold the mirror across a composite
        # read (sync_net + the plan verifier's verdict loop) while the
        # internal sync paths re-acquire: the net dicts are mutated in
        # place by _apply_deltas, so unlike the copy-on-write usage
        # array they must not be read unlocked.
        self._lock = threading.RLock()
        # Published fence (index, lineage, net_ready): ONE CopySwap
        # tuple rebound under the lock by _publish_fence, read lock-free
        # by the sync fast paths — an already-current caller must never
        # block behind another thread's O(allocs) rebuild.
        self._fence: CopySwap = (-1, None, False)

    @property
    def lock(self):
        """Hold this across any multi-step read of the in-place-mutated
        net structures (node_ports/node_net_keys/net_rows/alloc_rows);
        the usage array itself is replaced copy-on-write and may be
        taken by reference."""
        return self._lock

    # -- sync --------------------------------------------------------------
    def _current(self, t) -> bool:
        """True when the mirror already matches this generation.  The
        fence is the monotonic allocs raft index plus the store lineage
        token — NOT table-dict identity, because the store mutates tables
        in place when no snapshot shares them.  The lineage token changes
        on snapshot restore (which can replace the world without raising
        the index); it survives clones and changelog compaction."""
        return (self.index == t.indexes["allocs"]
                and self._lineage is t.lineage)

    def _sync_locked(self, t) -> bool:
        if self._current(t):
            return True
        target = t.indexes["allocs"]
        if self._lineage is t.lineage and self.index > target:
            return False
        table = t.tables["allocs"]
        log = t.alloc_log
        # A new log list under the SAME lineage can only be compaction
        # (the kept tail retains every entry above alloc_log_base), so
        # scanning it from position 0 is sound.
        if self.index < 0 or self.index < t.alloc_log_base or \
                self._lineage is not t.lineage:
            self._rebuild(table)
        else:
            changed = self._changed_ids(log, target)
            if changed:
                self._apply_deltas(table, changed)
        self.index = target
        self._lineage = t.lineage
        self._log_ref = log
        self._log_pos = self._position_after(log, target)
        self._publish_fence()
        return True

    def _publish_fence(self) -> None:
        """Rebind the lock-free fence tuple (called under the lock
        after any index/lineage/net_ready move)."""
        self._fence = (self.index, self._lineage, self._net_ready)

    def sync(self, state) -> bool:
        """Bring the mirror to ``state``'s allocs table (store or
        snapshot).  O(changed allocs) when the changelog covers the gap;
        full rebuild otherwise.  Returns False (mirror untouched) when the
        snapshot is older than the mirror — the mirror is monotonic.

        Already-current fast path: one lock-free read of the CopySwap
        fence tuple — a caller whose snapshot the mirror already covers
        returns immediately even while another thread holds the lock
        through a full O(allocs) rebuild."""
        t = state._t
        index, lineage, _net = self._fence
        if index == t.indexes["allocs"] and lineage is t.lineage:
            return True
        with self._lock:
            return self._sync_locked(t)

    def sync_net(self, state) -> bool:
        """sync() plus per-node port/bandwidth tracking: enabled (full
        net rebuild) on first call, maintained incrementally by every
        later sync.  Same monotonicity and fast-path contract as
        sync()."""
        t = state._t
        index, lineage, net_ready = self._fence
        if net_ready and index == t.indexes["allocs"] and \
                lineage is t.lineage:
            return True
        with self._lock:
            ok = self._sync_locked(t)
            if ok and not self._net_ready:
                self._rebuild_net(t.tables["allocs"])
                self._net_ready = True
                self._publish_fence()
            return ok

    def _changed_ids(self, log: list, target: int) -> set:
        start = self._log_pos if log is self._log_ref else 0
        changed: set = set()
        n = len(log)
        for i in range(start, n):
            idx, ids = log[i]
            if idx <= self.index:
                continue
            if idx > target:
                break
            changed.update(ids)
        return changed

    @staticmethod
    def _position_after(log: list, target: int) -> int:
        n = len(log)
        pos = n
        while pos > 0 and log[pos - 1][0] > target:
            pos -= 1
        return pos

    def _rebuild(self, table: dict) -> None:
        statics = self.statics
        index_of = statics.index_of
        usage = np.zeros((statics.n_pad, NDIMS), dtype=np.float32)
        job_counts: dict = {}
        rows: dict = {}
        for alloc in table.values():
            if alloc.terminal_status():
                continue
            ni = index_of.get(alloc.node_id, -1)
            if ni < 0:
                continue
            vec = alloc_vec(alloc)
            usage[ni] += vec
            job_counts.setdefault(alloc.job_id, {})[ni] = \
                job_counts.get(alloc.job_id, {}).get(ni, 0) + 1
            rows[alloc.id] = (ni, vec, alloc.job_id)
        self.usage = usage
        self.job_counts = job_counts
        self.alloc_rows = rows
        self.rebuilds += 1
        self._usage_d = None
        self._sharded.clear()
        if self._net_ready:
            self._rebuild_net(table)

    # -- net tracking (vectorized plan verifier) ---------------------------
    def _rebuild_net(self, table: dict) -> None:
        index_of = self.statics.index_of
        self.net_rows = {}
        self.node_ports = {}
        self.node_dup = {}
        self.node_bw = {}
        self.node_net_keys = {}
        for alloc in table.values():
            if alloc.terminal_status():
                continue
            ni = index_of.get(alloc.node_id, -1)
            if ni < 0:
                continue
            self._net_add(alloc.id, ni, alloc)

    def _net_add(self, aid: str, ni: int, alloc: Allocation) -> None:
        row = _net_row(alloc)
        if row is None:
            return
        ports, mbits, key = row
        self.net_rows[aid] = (ni, ports, mbits, key)
        if mbits:
            self.node_bw[ni] = self.node_bw.get(ni, 0) + mbits
        keys = self.node_net_keys.setdefault(ni, {})
        keys[key] = keys.get(key, 0) + 1
        if ports:
            pc = self.node_ports.setdefault(ni, {})
            dup = 0
            for p in ports:
                c = pc.get(p, 0) + 1
                pc[p] = c
                if c == 2:
                    dup += 1
            if dup:
                self.node_dup[ni] = self.node_dup.get(ni, 0) + dup

    def _net_remove(self, aid: str) -> None:
        row = self.net_rows.pop(aid, None)
        if row is None:
            return
        ni, ports, mbits, key = row
        if mbits:
            bw = self.node_bw.get(ni, 0) - mbits
            if bw:
                self.node_bw[ni] = bw
            else:
                self.node_bw.pop(ni, None)
        keys = self.node_net_keys.get(ni)
        if keys is not None:
            c = keys.get(key, 0) - 1
            if c > 0:
                keys[key] = c
            else:
                keys.pop(key, None)
                if not keys:
                    self.node_net_keys.pop(ni, None)
        if ports:
            pc = self.node_ports.get(ni)
            if pc is not None:
                dup = 0
                for p in ports:
                    c = pc.get(p, 0) - 1
                    if c > 0:
                        pc[p] = c
                        if c == 1:
                            dup += 1
                    else:
                        pc.pop(p, None)
                if dup:
                    d = self.node_dup.get(ni, 0) - dup
                    if d > 0:
                        self.node_dup[ni] = d
                    else:
                        self.node_dup.pop(ni, None)
                if not pc:
                    self.node_ports.pop(ni, None)

    def _apply_deltas(self, table: dict, changed: set) -> None:
        statics = self.statics
        index_of = statics.index_of
        # Copy-on-write so views handed to in-flight evals stay frozen.
        usage = self.usage.copy()
        touched_rows: set = set()
        touched_jobs: dict = {}
        for aid in changed:
            old = self.alloc_rows.get(aid)
            if old is not None:
                ni, vec, jid = old
                usage[ni] -= vec
                jc = touched_jobs.get(jid)
                if jc is None:
                    jc = touched_jobs[jid] = dict(
                        self.job_counts.get(jid, ()))
                jc[ni] = jc.get(ni, 0) - 1
                del self.alloc_rows[aid]
                touched_rows.add(ni)
            if self._net_ready:
                self._net_remove(aid)
            new = table.get(aid)
            if new is not None and not new.terminal_status():
                ni = index_of.get(new.node_id, -1)
                if ni < 0:
                    continue
                vec = alloc_vec(new)
                usage[ni] += vec
                jid = new.job_id
                jc = touched_jobs.get(jid)
                if jc is None:
                    jc = touched_jobs[jid] = dict(
                        self.job_counts.get(jid, ()))
                jc[ni] = jc.get(ni, 0) + 1
                self.alloc_rows[aid] = (ni, vec, jid)
                touched_rows.add(ni)
                if self._net_ready:
                    self._net_add(aid, ni, new)
        for jid, jc in touched_jobs.items():
            jc = {ni: c for ni, c in jc.items() if c > 0}
            if jc:
                self.job_counts[jid] = jc
            else:
                self.job_counts.pop(jid, None)
        self._update_device(usage, touched_rows)
        self.usage = usage

    # -- device mirror -----------------------------------------------------
    def _update_device(self, new_usage: np.ndarray,
                       touched_rows: set) -> None:
        """Keep the device copies (single-device and mesh-sharded) equal
        to the (about-to-be-installed) host usage: scatter the touched
        rows into new buffers (K5; on a mesh, one launch on each shard
        that owns some, with its local row indices), or drop a copy when
        a fresh upload is cheaper.  Called under the lock from
        _apply_deltas."""
        sharded = self._sharded
        if self._usage_d is None and not sharded.keys():
            return
        big = len(touched_rows) > self.MAX_SCATTER_ROWS
        idx = rows = None
        if not big:
            idx = np.fromiter(touched_rows, dtype=np.int32,
                              count=len(touched_rows))
            rows = new_usage[idx]
        if self._usage_d is not None:
            if big or self._scatters_since_upload >= \
                    self.DEVICE_REFRESH_EVERY:
                self._usage_d = None
            else:
                self._usage_d = _scatter_rows(self._usage_d, idx, rows)
                self._scatters_since_upload += 1
        for key in sharded.keys():
            if big or sharded.scatters(key) >= self.DEVICE_REFRESH_EVERY:
                sharded.drop(key)
            else:
                (buf,) = sharded.lookup(key)
                sharded.replace(key, (_scatter_sharded(buf, idx, rows),))

    def device_usage(self, device):
        """Copy of the mirror's usage resident on ``device`` (uploaded on
        first use, then scatter-maintained alongside every host delta).

        The upload itself happens OUTSIDE the mirror lock: at 131k+
        nodes the full usage tensor is fleet-sized, and holding the lock
        across its host->device copy would park every worker's sync and
        view build behind one thread's transfer.  The install is
        revalidated under the lock exactly ONCE — a mirror that moved on
        mid-upload just gets the fresh copy of the snapshot we read,
        uninstalled."""
        from nomad_tpu_torch.parallel.devices import on_default_platform, \
            put_counted
        with self._lock:
            host = self.usage
            buf = self._usage_d
        if buf is not None and on_default_platform(buf, device):
            return buf
        fresh = put_counted(host, device)
        self._install(host, fresh, device)
        return fresh

    def device_usage_sharded(self, mesh, expect_usage):
        """Mesh-resident (node-axis-sharded) copy of the mirror's usage,
        the PRIMARY usage of a sharded dispatch, or None when the mirror
        has moved past the caller's view (``expect_usage`` is the view's
        host array; the caller then uploads that itself).  Uploaded on
        first use PER MESH under the residency policy, scatter-maintained
        alongside every host delta like the single-device copy.  The
        upload runs OUTSIDE the mirror lock
        (ShardedResidency.prepare/adopt)."""
        key = ("usage", mesh)
        with self._lock:
            if self.usage is not expect_usage:
                return None
            hit = self._sharded.lookup(key)
            if hit is not None:
                return hit[0]
        arrays = self._sharded.prepare(mesh, (expect_usage,))
        with self._lock:
            if self.usage is not expect_usage:
                return None  # moved past us mid-upload
            hit = self._sharded.lookup(key)
            if hit is None:
                hit = self._sharded.adopt(key, arrays)
            return hit[0]

    def window_lease(self, device):
        """Residency LEASE for a window verify: the usage copy resident
        on ``device`` for the mirror's CURRENT generation, or None; for
        a mesh (parallel/mesh.Mesh) its resident sharded copy, which a
        sync likewise replaces and never writes.
        Must be called under ``self.lock``.  Never uploads (that would
        be a fleet-sized transfer under the lock); cold callers warm
        the copy through ``device_usage`` OUTSIDE the lock and take the
        lease on a later window.

        The returned tensor stays valid for the whole window after the
        lock releases only because nothing writes ``_usage_d`` in
        place: ``_update_device`` keeps it equal to ``self.usage`` by
        scattering the touched rows into a NEW buffer (K5,
        ``scatter_rows``) and rebinding, or by dropping it.  A later
        sync therefore replaces the copy the lease holds and never
        mutates it."""
        from nomad_tpu_torch.parallel.devices import on_default_platform
        from nomad_tpu_torch.parallel.mesh import Mesh

        if isinstance(device, Mesh):
            hit = self._sharded.lookup(("usage", device))
            return hit[0] if hit is not None else None
        buf = self._usage_d
        if buf is not None and on_default_platform(buf, device):
            return buf
        return None

    def _install(self, host: np.ndarray, fresh, device) -> None:
        """Adopt ``fresh`` (a device copy of ``host``) as the resident
        copy when the mirror still holds ``host`` and has no copy on
        ``device``."""
        from nomad_tpu_torch.parallel.devices import on_default_platform
        with self._lock:
            if self.usage is host and (
                    self._usage_d is None or
                    not on_default_platform(self._usage_d, device)):
                self._usage_d = fresh
                self._scatters_since_upload = 0

    def _attach_device(self, view: "FleetView", device) -> "FleetView":
        """Resolve a view's pending device-usage attachment (set by
        _view_locked when the view rides the mirror's own array): reuse
        the resident copy, or upload one OUTSIDE the lock and install it
        when the mirror hasn't moved.  Either way the view gets a device
        copy of exactly ITS snapshot array."""
        if view is None or view.usage_device is not _PENDING_DEVICE:
            return view
        view.usage_device = None
        from nomad_tpu_torch.parallel.devices import on_default_platform, \
            put_counted
        host = view.usage
        with self._lock:
            buf = self._usage_d if self.usage is host else None
        if buf is not None and on_default_platform(buf, device):
            view.usage_device = buf
            return view
        fresh = put_counted(host, device)
        self._install(host, fresh, device)
        view.usage_device = fresh
        return view

    # -- views -------------------------------------------------------------
    def _view_locked(self, plan, job_id: str) -> FleetView:
        statics = self.statics
        jc_dense = np.zeros(statics.n_pad, dtype=np.int32)
        sparse = self.job_counts.get(job_id)
        if sparse:
            for ni, c in sparse.items():
                jc_dense[ni] = c
        usage = self.usage
        deltas = plan is not None and \
            (plan.node_update or plan.node_allocation)
        if not deltas:
            # The device copy is attached OUTSIDE the lock
            # (_attach_device): the sentinel marks the view as riding
            # the mirror's own array, so the attachment can validate
            # against it after the upload.
            return FleetView(statics=statics, usage=usage,
                             job_counts=jc_dense,
                             usage_device=_PENDING_DEVICE)
        usage = usage.copy()
        index_of = statics.index_of
        for updates in plan.node_update.values():
            for alloc in updates:
                row = self.alloc_rows.get(alloc.id)
                if row is None:
                    continue
                ni, vec, jid = row
                usage[ni] -= vec
                if jid == job_id:
                    jc_dense[ni] -= 1
        for placements in plan.node_allocation.values():
            for alloc in placements:
                ni = index_of.get(alloc.node_id, -1)
                if ni < 0:
                    continue
                usage[ni] += alloc_vec(alloc)
                if alloc.job_id == job_id:
                    jc_dense[ni] += 1
        return FleetView(statics=statics, usage=usage,
                         job_counts=jc_dense)

    def view(self, plan, job_id: str, device) -> FleetView:
        """A FleetView for one eval: mirror base plus the eval's in-flight
        plan deltas (EvalContext.ProposedAllocs semantics, reference
        scheduler/context.go:96-126, fleet-wide), with the usage copy on
        ``device`` attached when the view has no deltas."""
        with self._lock:
            view = self._view_locked(plan, job_id)
        return self._attach_device(view, device)

    def view_at(self, state, plan, job_id: str,
                device) -> Optional[FleetView]:
        """Atomically sync to ``state`` and build a view under one lock
        hold, so a concurrent worker cannot advance the mirror between
        the sync and the view (the view must reflect exactly this eval's
        snapshot).  Returns None when the snapshot is older than the
        mirror — the caller falls back to a from-scratch build.  The
        view's device-usage attachment resolves after the lock releases
        (_attach_device) so the first-use upload never serializes other
        workers' syncs."""
        t = state._t
        with self._lock:
            if not self._sync_locked(t):
                return None
            view = self._view_locked(plan, job_id)
        return self._attach_device(view, device)


_mirror_create_lock = threading.Lock()


def mirror_for(statics: FleetStatics) -> UsageMirror:
    """The one UsageMirror attached to a fleet generation (created on
    first use; a new fleet generation starts a fresh mirror)."""
    mirror = statics.mirror
    if mirror is None:
        with _mirror_create_lock:
            mirror = statics.mirror
            if mirror is None:
                mirror = statics.mirror = UsageMirror(statics)
    return mirror


def _scatter_rows(usage_d, idx: np.ndarray, rows: np.ndarray):
    """Device scatter of the touched rows into a NEW buffer (K5): the
    old one stays as it is, since in-flight dispatches may still read
    it.  Runs under the mirror lock by design: the scatter is a bounded
    (<= MAX_SCATTER_ROWS) asynchronous launch that must stay atomic
    with the host-array swap so the ``_usage_d == usage`` invariant
    holds.

    The batch is padded to a power-of-two row count as in the JAX
    package (pad entries rewrite row idx[0] with its own value — a
    no-op).  The idx/rows batch is uploaded EXPLICITLY (counted)."""
    n = len(idx)
    if n == 0:
        return usage_d
    if idx.min() < 0 or idx.max() >= usage_d.shape[0]:
        raise IndexError(
            f"scatter row index outside [0, {usage_d.shape[0]})")
    padded = 1 << int(n - 1).bit_length()
    if padded != n:
        pad = padded - n
        idx = np.concatenate([idx, np.repeat(idx[:1], pad)])
        rows = np.concatenate([rows, np.repeat(rows[:1], pad, axis=0)])
    from nomad_tpu_torch.parallel.devices import put_counted
    device = usage_d.device
    # devlint-ok(transfer-under-lock): bounded async update batch; must
    # stay atomic with the host swap (see docstring).
    idx_d = put_counted(idx.astype(np.int32), device)
    # devlint-ok(transfer-under-lock): as above, the batch's rows.
    rows_d = put_counted(rows.astype(np.float32), device)
    return scatter_rows(usage_d, idx_d, rows_d)


def _scatter_sharded(buf, idx: np.ndarray, rows: np.ndarray):
    """K5 on a sharded usage copy: the touched rows split by the shard
    that owns them, one scatter (a new buffer) on each shard that owns
    some, with its local indices; the other shards keep their tensors.
    Returns a new Sharded."""
    from nomad_tpu_torch.parallel.mesh import Sharded

    width = buf.mesh.fleet_ways
    local_rows = buf.shape[0] // width
    owner = idx // local_rows
    done: dict = {}
    shards = []
    for pos, shard in enumerate(buf):
        out = done.get(id(shard))
        if out is None:
            c = pos % width
            mine = owner == c
            out = done[id(shard)] = _scatter_rows(
                shard, idx[mine] - c * local_rows, rows[mine]) \
                if mine.any() else shard
        shards.append(out)
    return Sharded(shards, buf.mesh, buf.spec, buf.shape)


def scatter_rows_plain(usage, idx, rows):
    """Plain version of K5 (``usage.at[idx].set(rows)``): a new tensor
    equal to ``usage`` with rows ``idx`` replaced by ``rows``."""
    out = usage.clone()
    out[idx.long()] = rows
    return out


def scatter_rows(usage, idx, rows):
    """K5: the plain version for CPU tensors, ONE ``scatter_rows_kernel``
    launch (``csrc/scatter_rows.cu``) for CUDA tensors: it copies
    ``usage`` into a new buffer and writes the replaced rows in the same
    launch.  ``usage`` f32[N, D] is never modified.  Indices must lie in
    [0, N).  The checks take one comparison each on the common path (the
    call runs at the host's launch rate); anything off goes through
    ``kernels.route`` / ``kernels.check_args`` for the error."""
    device = usage.device
    if device.type != "cuda" or idx.device != device or \
            rows.device != device:
        device = kernels.route(dict(usage=usage, idx=idx, rows=rows))
        if device.type == "cpu":
            return scatter_rows_plain(usage, idx, rows)
    if usage.dim() != 2:
        raise ValueError(f"usage: shape {tuple(usage.shape)}, kernel takes "
                         "(N, D)")
    n, d = usage.shape
    r = idx.shape[0]
    if not (usage.dtype == torch.float32 and idx.dtype == torch.int32
            and rows.dtype == torch.float32 and idx.dim() == 1
            and rows.shape == (r, d) and usage.is_contiguous()
            and idx.is_contiguous() and rows.is_contiguous()):
        kernels.check_args(dict(usage=usage, idx=idx, rows=rows), dict(
            usage=(torch.float32, (n, d)), idx=(torch.int32, (r,)),
            rows=(torch.float32, (r, d))))
    out = torch.empty_like(usage)
    lib = kernels.library("scatter_rows")
    started = obs_trace.device_span(device) if obs_trace.ENABLED else None
    code = lib.nomad_scatter_rows(
        usage.data_ptr(), out.data_ptr(), idx.data_ptr(), rows.data_ptr(),
        r, n, d, kernels.stream_handle(device))
    if started is not None:
        started.end("device.K5", n=n, d=d, r=r)
    kernels.check(lib, "scatter_rows", code)
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0


class FleetCache:
    """Caches FleetStatics per nodes-table generation.  Sound because the
    MVCC store is copy-on-write: a frozen table dict is never mutated, only
    swapped."""

    def __init__(self, max_entries: int = 4) -> None:
        self.max_entries = max_entries
        self._statics: dict = {}

    def _table(self, state, table: str):
        t = getattr(state, "_t", None)
        if t is None:
            return None
        return t.tables[table]

    def statics_for(self, state) -> FleetStatics:
        table = self._table(state, "nodes")
        if table is not None:
            hit = self._statics.get(id(table))
            # Keep the keyed dict alive inside the entry so its id() cannot
            # be reused by a different dict while cached.
            if hit is not None and hit[0] is table:
                return hit[1]
        fleet = build_fleet(list(state.nodes()))
        if table is not None:
            if len(self._statics) >= self.max_entries:
                self._statics.clear()
            self._statics[id(table)] = (table, fleet)
        return fleet

    def forget(self, state) -> None:
        """Drop the generation cached for ``state``'s nodes table (a
        dead server's store: its statics and device copies go with
        it)."""
        table = self._table(state, "nodes")
        if table is not None:
            hit = self._statics.get(id(table))
            if hit is not None and hit[0] is table:
                del self._statics[id(table)]
                # Its mesh-resident twins go too, so a reaped server's
                # shards stop holding the card.
                fleet = hit[1]
                fleet.sharded.clear()
                if fleet.mirror is not None:
                    with fleet.mirror.lock:
                        fleet.mirror._sharded.clear()


fleet_cache = FleetCache()
