"""Columnar allocation slabs: the alloc contract of the scheduling hot path.

The port's copy of ``nomad_tpu/structs/alloc_slab.py``.  The object
contract of a finished eval costs ~12 Python objects per placement
(Allocation, AllocMetric, Resources and NetworkResource per task, port
lists, task dicts); the plan verifier walks them back into dense arrays,
the raft wire re-serializes every alloc as a ~17-key dict (embedding the
full job per alloc), and the store copies each object per upsert.

``AllocSlab`` replaces that round trip with columns.  One slab carries an
eval's placements as dense arrays — ids, node ids, slot indexes, scores,
a flat int32 port column — plus the per-slot templates (size/Resources
protos, network asks) every row shares.  The native finish
(nomad_tpu_torch/csrc/port_alloc.cpp ``bulk_finish_cols``) writes ports straight into
the slab's buffer and emits one tiny ``SlabAlloc`` per row: an
``Allocation`` whose heavy fields (``resources``, ``task_resources``,
``metrics``, ``task_states``) are data-descriptor properties that
materialize lazily FROM the slab on first read.  Everything downstream
consumes columns:

  - plan verify (ops/plan_conflict, server/plan_apply) reads
    ``slab.vec``/``slab.net_row`` through the slab-aware
    ``models/fleet.alloc_vec``/``_net_row`` — no ``task_resources`` walk;
  - the raft wire (``SlabWireEncoder``) encodes slab rows as
    ``[slab, row, delta]`` references against one shared column record
    (the job dict rides ONCE per slab, not once per alloc); the port has
    no FSM yet, so the wire half has no caller in it;
  - the state store upserts ``SlabAlloc`` objects whose ``copy()`` is
    one small dict copy — no task-resource materialization.

Full ``Allocation`` semantics materialize only when an API / client /
snapshot-digest consumer actually reads a heavy field, and the result is
bit-identical to the object path (``tests/test_torch_columnar_alloc.py``
byte-compares plans and store fingerprints between the two contracts).

Invalidation rule: slab columns are IMMUTABLE once sealed; any row
rewrite must go through ``patch_row``, which drops that row's cached
``SlabAlloc`` (and its derived net row) so no consumer can observe a
stale materialization.  Store-side updates never mutate rows — they
copy the object and override scalars, exactly like the object contract.
"""
from __future__ import annotations

import os
import threading
import weakref
from typing import Optional

import numpy as np

from .model import (
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    AllocMetric,
    Allocation,
    NetworkResource,
    Resources,
)

# Kill switch for the columnar contract (parity rigs flip it to replay
# identical storms through the legacy object path): the schedulers fall
# back to the object-emitting native finish when False.  The same
# variable as the JAX package's, as verify_policy shares NOMAD_TPU_VERIFY.
COLUMNAR = os.environ.get("NOMAD_TPU_COLUMNAR", "1") != "0"


def columnar_enabled() -> bool:
    return COLUMNAR


_MISS = object()

# One lock for all lazy materializations (same policy as AllocMetric's
# _METRIC_LAZY_LOCK): first reads are rare and idempotent, but two
# concurrent first reads of ``task_resources`` must not each install a
# half-observed dict.
_SLAB_LAZY_LOCK = threading.Lock()

# The scalar fields a slab row canonically determines.  ``job`` is
# checked by identity separately; the four heavy fields are never
# scalars.  Defaults mirror the Allocation dataclass (class attributes
# back any key the eager dict omits).
_SCALAR_FIELDS = (
    ("id", ""), ("eval_id", ""), ("name", ""), ("node_id", ""),
    ("job_id", ""), ("task_group", ""),
    ("desired_status", ""), ("desired_description", ""),
    ("client_status", ""), ("client_description", ""),
    ("create_index", 0), ("modify_index", 0),
)


def _lazy_field(name: str):
    """Data-descriptor property for one heavy Allocation field: reads
    materialize from the slab on first access; writes record the field
    in ``_hmut`` so the wire encoder knows the row no longer speaks for
    this object (it falls back to a full dict)."""

    def _get(self):
        d = self.__dict__
        v = d.get(name, _MISS)
        if v is _MISS:
            return _slab_fill(self, name)
        return v

    def _set(self, value):
        d = self.__dict__
        d[name] = value
        mut = d.get("_hmut")
        if mut is None:
            mut = d["_hmut"] = set()
        mut.add(name)

    return property(_get, _set)


def _slab_fill(alloc, name: str):
    with _SLAB_LAZY_LOCK:
        d = alloc.__dict__
        v = d.get(name, _MISS)
        if v is not _MISS:  # lost the race: another reader built it
            return v
        slab = d["_slab"]
        r = d["_srow"]
        if name == "resources":
            v = slab.size_of(r)
        elif name == "metrics":
            v = slab.metric_of(r)
        elif name == "task_resources":
            v = slab.task_resources_of(r)
        else:  # task_states
            v = {}
        d[name] = v
        return v


class SlabAlloc(Allocation):
    """An Allocation backed by one AllocSlab row.

    Eagerly carries only the scalars the store/verify hot paths read
    (ids, statuses, the job reference) plus ``_slab``/``_srow``; the
    heavy fields materialize lazily from the slab's columns.  The
    properties are data descriptors, so reads stay correct whether or
    not the field has materialized, and writes (rare: in-place updates)
    are flagged so the columnar wire encoder stops speaking for the
    object.  Never constructed through ``__init__`` — the native finish
    loop and ``AllocSlab.alloc`` build instances via ``__new__`` plus a
    template dict, the same pattern the object path already used."""

    resources = _lazy_field("resources")
    task_resources = _lazy_field("task_resources")
    metrics = _lazy_field("metrics")
    task_states = _lazy_field("task_states")

    def copy(self) -> "SlabAlloc":
        # dataclasses.replace would read every field through the
        # properties and materialize the whole row; a slab-backed copy
        # is one dict copy instead (the store upsert's per-alloc cost).
        new = SlabAlloc.__new__(SlabAlloc)
        d = dict(self.__dict__)
        d.pop("_res_vec", None)
        d.pop("_net_row", None)
        mut = d.get("_hmut")
        if mut is not None:
            d["_hmut"] = set(mut)
        tr = d.get("task_resources")
        if tr is not None:
            d["task_resources"] = dict(tr)
        ts = d.get("task_states")
        if ts is not None:
            d["task_states"] = dict(ts)
        new.__dict__ = d
        return new


class AllocSlab:
    """Dense columns for one eval's placements (or one decoded wire/
    snapshot record).  Rows [0, n) are valid; the scheduler allocates
    for the whole placement list and ``seal``s to the native prefix."""

    __slots__ = (
        "__weakref__",
        "eval_id", "job_id", "job",
        "slots",        # slot -> (size Resources, tasks_c) — build_slots_c layout
        "metric_proto",  # shared AllocMetric template (nodes_evaluated, time)
        "ids", "names", "tgs", "node_ids", "ips", "devs",
        "groups",       # row -> slot index (list)
        "scores",       # row -> float
        "ports",        # np.int32 flat dynamic-port column
        "port_off",     # np.int64 [rows+1] prefix offsets into ports
        "n",            # sealed row count
        "_cache",       # row -> canonical SlabAlloc (lazy; see alloc())
        "_slot_vec", "_slot_mbits", "_slot_has_net",
        "_owned",       # row columns private to this slab (see patch_row)
    )

    def __init__(self, eval_id: str, job, slots: list, metric_proto: dict,
                 groups: list, ids: list, names: list, tgs: list,
                 scores: list, port_off: np.ndarray, n_rows: int,
                 ports: Optional[np.ndarray] = None,
                 slot_mbits: Optional[list] = None,
                 slot_has_net: Optional[list] = None) -> None:
        self.eval_id = eval_id
        self.job = job
        self.job_id = job.id if job is not None else ""
        self.slots = slots
        self.metric_proto = metric_proto
        self.groups = groups
        self.ids = ids
        self.names = names
        self.tgs = tgs
        self.scores = scores
        self.port_off = port_off
        self.ports = ports if ports is not None else \
            np.empty(int(port_off[-1]) if len(port_off) else 0,
                     dtype=np.int32)
        self.node_ids: list = [None] * n_rows
        self.ips: list = [None] * n_rows
        self.devs: list = [None] * n_rows
        self.n = 0
        # Canonical row objects, WEAKLY held: a cached alloc references
        # the slab back, so a strong cache would close a tracked cycle
        # and break the store's refcount-only teardown contract
        # (tests/test_torch_columnar_alloc.py).  Weak entries dedup rows
        # within a decode pass and die with their last outside holder.
        self._cache: "weakref.WeakValueDictionary" = \
            weakref.WeakValueDictionary()
        self._slot_vec: dict = {}
        # Pre-derived per-slot network totals when the caller already
        # has them (the scheduler's col_meta cache); lazily derived
        # from ``slots`` otherwise.
        self._slot_mbits = slot_mbits
        self._slot_has_net = slot_has_net
        # Scheduler-built slabs SHARE their names/tgs (col_meta) and
        # groups columns with sibling slabs of the same job version;
        # patch_row privatizes before the first mutation.
        self._owned = False

    def seal(self, n: int) -> None:
        """Mark rows [0, n) valid (the native finish's happy prefix)."""
        self.n = n

    # -- per-slot derivations ---------------------------------------------
    def _slot_net(self) -> tuple[list, list]:
        mbits = self._slot_mbits
        if mbits is None:
            mbits = []
            has = []
            for _size, tasks in self.slots:
                mb = 0
                any_net = False
                for _t, _rp, net_c in tasks:
                    if net_c is not None:
                        any_net = True
                        mb += net_c[0]
                mbits.append(mb)
                has.append(any_net)
            self._slot_mbits = mbits
            self._slot_has_net = has
        return mbits, self._slot_has_net

    # -- columnar reads (the verify hot path) ------------------------------
    def vec(self, r: int) -> np.ndarray:
        """Resource vector of row ``r`` — per-slot constant, shared
        read-only across the slot's rows (models/fleet.alloc_vec)."""
        g = self.groups[r]
        v = self._slot_vec.get(g)
        if v is None:
            size = self.slots[g][0]
            v = self._slot_vec[g] = np.asarray(
                size.as_vector() if size is not None else [0] * 6,
                dtype=np.float32)
        return v

    def net_row(self, r: int):
        """The verifier's (ports, mbits, (ip, device)) row — identical
        to models/fleet._net_row_build on the materialized object."""
        mbits, has_net = self._slot_net()
        g = self.groups[r]
        if not has_net[g] and not mbits[g]:
            return None
        o0 = int(self.port_off[r])
        o1 = int(self.port_off[r + 1])
        return (tuple(self.ports[o0:o1].tolist()), mbits[g],
                (self.ips[r], self.devs[r]))

    # -- lazy materialization ----------------------------------------------
    def size_of(self, r: int):
        """Shared per-slot total Resources (the object path shared one
        size object per slot the same way)."""
        return self.slots[self.groups[r]][0]

    def metric_of(self, r: int) -> AllocMetric:
        m = AllocMetric.__new__(AllocMetric)
        d = dict(self.metric_proto)
        d["_lazy_score_key"] = self.node_ids[r] + ".binpack"
        d["_lazy_score_val"] = float(self.scores[r])
        m.__dict__ = d
        return m

    def task_resources_of(self, r: int) -> dict:
        ip = self.ips[r]
        dev = self.devs[r]
        off = int(self.port_off[r])
        out = {}
        for tname, res_proto, net_c in self.slots[self.groups[r]][1]:
            rd = dict(res_proto)
            if net_c is None:
                rd["networks"] = []
            else:
                _mbits, net_proto, labels = net_c
                nd = dict(net_proto)
                nd["device"] = dev
                nd["ip"] = ip
                nd["reserved_ports"] = \
                    self.ports[off:off + len(labels)].tolist()
                nd["dynamic_ports"] = list(labels)
                off += len(labels)
                offer = NetworkResource.__new__(NetworkResource)
                offer.__dict__ = nd
                rd["networks"] = [offer]
            tr = Resources.__new__(Resources)
            tr.__dict__ = rd
            out[tname] = tr
        return out

    # -- row objects -------------------------------------------------------
    def row_scalars(self, r: int) -> dict:
        """Canonical scalar values row ``r`` stands for — what a fresh
        placement carries before the store stamps indexes."""
        return {
            "id": self.ids[r], "eval_id": self.eval_id,
            "name": self.names[r], "node_id": self.node_ids[r],
            "job_id": self.job_id, "task_group": self.tgs[r],
            "desired_status": ALLOC_DESIRED_STATUS_RUN,
            "desired_description": "",
            "client_status": ALLOC_CLIENT_STATUS_PENDING,
            "client_description": "",
            "create_index": 0, "modify_index": 0,
        }

    def _eager(self, r: int) -> dict:
        # Mirrors the native loop's lazy proto exactly: scalars whose
        # values differ from the Allocation class defaults, plus the
        # slab backref.  Omitted keys resolve through class attributes.
        return {
            "id": self.ids[r], "eval_id": self.eval_id,
            "name": self.names[r], "node_id": self.node_ids[r],
            "job_id": self.job_id, "job": self.job,
            "task_group": self.tgs[r],
            "desired_status": ALLOC_DESIRED_STATUS_RUN,
            "client_status": ALLOC_CLIENT_STATUS_PENDING,
            "_slab": self, "_srow": r,
        }

    def alloc(self, r: int) -> SlabAlloc:
        """The canonical Allocation for row ``r``, built lazily and
        cached (the FSM decode path asks once per row; store upserts
        copy it).  ``patch_row`` invalidates the cache entry."""
        a = self._cache.get(r)
        if a is None:
            a = SlabAlloc.__new__(SlabAlloc)
            a.__dict__ = self._eager(r)
            self._cache[r] = a
        return a

    def alloc_with(self, r: int, **overrides) -> SlabAlloc:
        """Row ``r`` with scalar/task_states overrides (wire deltas,
        snapshot-restore indexes).  Never cached — overridden rows are
        one-off views."""
        a = SlabAlloc.__new__(SlabAlloc)
        d = self._eager(r)
        d.update(overrides)
        a.__dict__ = d
        return a

    def patch_row(self, r: int, **scalars) -> None:
        """THE row-mutation seam: rewrite scalar columns for row ``r``
        and drop every cached derivation so no consumer can observe a
        stale materialization.  Columns are otherwise immutable once
        sealed.

        Copy-on-first-write: scheduler-built slabs alias their
        names/tgs columns to the per-job-version col_meta cache (shared
        with every sibling slab of the same job version), so the first
        patch privatizes every patchable column — mutating a shared
        list in place would rewrite other evals' canonical rows."""
        if not self._owned:
            self.ids = list(self.ids)
            self.names = list(self.names)
            self.tgs = list(self.tgs)
            self.node_ids = list(self.node_ids)
            self.scores = list(self.scores)
            self.ips = list(self.ips)
            self.devs = list(self.devs)
            self._owned = True
        for key, value in scalars.items():
            if key == "id":
                self.ids[r] = value
            elif key == "name":
                self.names[r] = value
            elif key == "task_group":
                self.tgs[r] = value
            elif key == "node_id":
                self.node_ids[r] = value
            elif key == "score":
                self.scores[r] = value
            elif key == "ip":
                self.ips[r] = value
            elif key == "device":
                self.devs[r] = value
            else:
                raise KeyError(f"not a per-row scalar column: {key}")
        self._cache.pop(r, None)

    # -- wire / snapshot ---------------------------------------------------
    def wire(self, rows: Optional[list] = None) -> dict:
        """msgpack-safe columnar record for ``rows`` (default: all
        sealed rows).  The job dict rides ONCE here instead of once per
        alloc — the dominant term of the old per-alloc dict encoding."""
        if rows is None:
            rows = list(range(self.n))
        poff = [0]
        chunks = []
        for r in rows:
            o0 = int(self.port_off[r])
            o1 = int(self.port_off[r + 1])
            chunks.append(self.ports[o0:o1])
            poff.append(poff[-1] + (o1 - o0))
        ports = np.concatenate(chunks) if chunks else \
            np.empty(0, dtype=np.int32)
        slots_w = []
        for size, tasks in self.slots:
            tasks_w = [[t, rp, None if net_c is None
                        else [net_c[0], net_c[1], list(net_c[2])]]
                       for t, rp, net_c in tasks]
            slots_w.append([size.to_dict() if size is not None else None,
                            tasks_w])
        return {
            "eval_id": self.eval_id,
            "job": self.job.to_dict() if self.job is not None else None,
            "ne": self.metric_proto.get("nodes_evaluated", 0),
            "at": self.metric_proto.get("allocation_time", 0.0),
            "slots": slots_w,
            "ids": [self.ids[r] for r in rows],
            "names": [self.names[r] for r in rows],
            "tgs": [self.tgs[r] for r in rows],
            "nids": [self.node_ids[r] for r in rows],
            "ips": [self.ips[r] for r in rows],
            "devs": [self.devs[r] for r in rows],
            "groups": [self.groups[r] for r in rows],
            "scores": [self.scores[r] for r in rows],
            "ports": np.ascontiguousarray(ports).tobytes(),
            "poff": poff,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "AllocSlab":
        from .model import Job

        job = Job.from_dict(d["job"]) if d.get("job") is not None else None
        slots = []
        for size_d, tasks_w in d["slots"]:
            size = Resources.from_dict(size_d) if size_d is not None \
                else None
            tasks = [(t, rp, None if net_c is None
                      else (net_c[0], net_c[1], list(net_c[2])))
                     for t, rp, net_c in tasks_w]
            slots.append((size, tasks))
        from .model import proto_of as _proto_of
        metric_static, _ = _proto_of(AllocMetric)
        metric_proto = dict(metric_static, nodes_evaluated=d["ne"],
                            allocation_time=d["at"])
        n = len(d["ids"])
        port_off = np.asarray(d["poff"], dtype=np.int64)
        slab = cls(eval_id=d["eval_id"], job=job, slots=slots,
                   metric_proto=metric_proto, groups=list(d["groups"]),
                   ids=list(d["ids"]), names=list(d["names"]),
                   tgs=list(d["tgs"]), scores=list(d["scores"]),
                   port_off=port_off, n_rows=n,
                   ports=np.frombuffer(d["ports"], dtype=np.int32).copy())
        slab.node_ids = list(d["nids"])
        slab.ips = list(d["ips"])
        slab.devs = list(d["devs"])
        slab.seal(n)
        return slab


# ---------------------------------------------------------------------------
# Wire encoding: alloc lists as slab references
# ---------------------------------------------------------------------------

def slab_ref(a):
    """``(slab, row, delta)`` when ``a`` can ride a columnar reference,
    else None (heavy field assigned, job swapped, or not slab-backed).
    ``delta`` holds only the scalars that differ from the row's
    canonical values (evictions carry desired_status/description;
    store-resident rows carry their stamped indexes)."""
    d = a.__dict__
    slab = d.get("_slab")
    if slab is None or "_hmut" in d:
        return None
    if d.get("job") is not slab.job:
        return None
    r = d["_srow"]
    canon = slab.row_scalars(r)
    delta = {}
    for f, default in _SCALAR_FIELDS:
        v = d.get(f, default)
        if v != canon[f]:
            delta[f] = v
    ts = d.get("task_states")
    if ts:
        delta["task_states"] = ts
    return slab, r, delta


class SlabWireEncoder:
    """Accumulates alloc lists into wire entries plus a shared slab
    table.  An entry is either a plain to_dict() payload or a
    ``[slab_index, row, delta?]`` reference; ``slabs_wire()`` emits the
    referenced slabs with rows compacted to exactly those used."""

    def __init__(self) -> None:
        self._slabs: dict = {}  # id(slab) -> [index, slab, {row: pos}]

    def encode_list(self, allocs: list) -> list:
        entries = []
        for a in allocs:
            ref = slab_ref(a) if type(a) is SlabAlloc else None
            if ref is None:
                entries.append(a.to_dict())
                continue
            slab, r, delta = ref
            ent = self._slabs.get(id(slab))
            if ent is None:
                ent = self._slabs[id(slab)] = [len(self._slabs), slab, {}]
            rows = ent[2]
            pos = rows.get(r)
            if pos is None:
                pos = rows[r] = len(rows)
            entries.append([ent[0], pos, delta] if delta
                           else [ent[0], pos])
        return entries

    def slabs_wire(self) -> list:
        out: list = [None] * len(self._slabs)
        for index, slab, rows in self._slabs.values():
            ordered = sorted(rows, key=rows.get)
            out[index] = slab.wire(ordered)
        return out


def encode_alloc_update(allocs: list) -> dict:
    """ALLOC_UPDATE_REQUEST payload with columnar references."""
    enc = SlabWireEncoder()
    payload = {"alloc": enc.encode_list(allocs)}
    slabs = enc.slabs_wire()
    if slabs:
        payload["slabs"] = slabs
    return payload


def encode_plan_batch(alloc_lists: list) -> dict:
    """PLAN_BATCH_APPLY_REQUEST payload: sub-plans share one slab
    table (an eval's update+placement rows ride the same slab)."""
    enc = SlabWireEncoder()
    payload = {"plans": [{"alloc": enc.encode_list(allocs)}
                         for allocs in alloc_lists]}
    slabs = enc.slabs_wire()
    if slabs:
        payload["slabs"] = slabs
    return payload


def decode_slabs(payload: dict) -> list:
    return [AllocSlab.from_wire(w) for w in payload.get("slabs", ())]


def decode_alloc_list(entries: list, slabs: list) -> list:
    """Rebuild an alloc list from wire entries, order preserved (the
    store's last-writer-wins within a batch depends on it)."""
    out = []
    for e in entries:
        if isinstance(e, dict):
            out.append(Allocation.from_dict(e))
            continue
        slab = slabs[e[0]]
        if len(e) > 2 and e[2]:
            out.append(slab.alloc_with(e[1], **e[2]))
        else:
            out.append(slab.alloc(e[1]))
    return out
