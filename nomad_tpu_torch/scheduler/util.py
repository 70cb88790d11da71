"""Scheduler utilities: diffing, materialization, update helpers.

Capability parity with reference scheduler/util.go.
"""
from __future__ import annotations

import random
import threading
import weakref
from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Callable, Mapping, Optional

from nomad_tpu_torch.structs import (
    ALLOC_DESIRED_STATUS_RUN,
    ALLOC_DESIRED_STATUS_STOP,
    ALLOC_CLIENT_STATUS_PENDING,
    EVAL_STATUS_FAILED,
    NODE_STATUS_READY,
    Allocation,
    Constraint,
    Evaluation,
    Job,
    Node,
    Resources,
    TaskGroup,
    should_drain_node,
)
from nomad_tpu_torch.structs.model import proto_of

from .interfaces import SetStatusError

ALLOC_NOT_NEEDED = "alloc not needed due to job update"
ALLOC_MIGRATING = "alloc is being migrated"
ALLOC_UPDATING = "alloc is being updated due to job update"
ALLOC_IN_PLACE = "alloc updating in-place"


@dataclass
class AllocTuple:
    name: str = ""
    task_group: Optional[TaskGroup] = None
    alloc: Optional[Allocation] = None


@dataclass
class DiffResult:
    place: list = field(default_factory=list)
    update: list = field(default_factory=list)
    migrate: list = field(default_factory=list)
    stop: list = field(default_factory=list)
    ignore: list = field(default_factory=list)

    def append(self, other: "DiffResult") -> None:
        self.place += other.place
        self.update += other.update
        self.migrate += other.migrate
        self.stop += other.stop
        self.ignore += other.ignore


def materialize_task_groups(job: Optional[Job]) -> Mapping:
    """Count-expand task groups to named instances job.tg[i].

    Returns a READ-ONLY Mapping (MappingProxyType), memoized per
    (job object, modify_index): store-resident jobs are immutable by
    contract and every store write copies, so re-evals of the same job
    version (node-update storms re-evaluate every affected job) reuse
    the expansion.  The proxy also makes the shared cache
    mutation-proof — callers needing a private mutable copy must
    dict() it.  Identity-stable per job version, which the fresh-diff
    caches key on (diff_allocs cache_fresh)."""
    if job is None:
        return {}
    cached = job.__dict__.get("_materialized")
    if cached is not None and cached[0] == job.modify_index:
        return cached[1]
    out: dict = {}
    for tg in job.task_groups:
        for i in range(tg.count):
            out[f"{job.name}.{tg.name}[{i}]"] = tg
    # Read-only view: a caller mutation would otherwise poison every
    # later eval of this job version through the shared cache.
    view = MappingProxyType(out)
    job.__dict__["_materialized"] = (job.modify_index, view)
    return view


def diff_allocs(job: Optional[Job], tainted_nodes: dict, required: dict,
                allocs: list, cache_fresh: bool = False) -> DiffResult:
    """Set-difference target vs existing allocs into five outcome buckets.

    ``cache_fresh=True`` (generic scheduler only): when there are no
    existing allocs the diff is pure placement and deterministic per job
    version, so the AllocTuple list is memoized on the job object (store
    jobs are immutable; re-evals of the same version — eval storms,
    plan-retry attempts — reuse it).  The cached tuples are shared and
    READ-ONLY; diff_system_allocs must not use this path (it stamps
    per-node targets onto its place tuples)."""
    if cache_fresh and not allocs and job is not None:
        cached = job.__dict__.get("_fresh_place")
        if cached is not None and cached[0] == job.modify_index \
                and cached[1] is required:
            place = cached[2]
        else:
            # A TUPLE, so any future caller that tries to mutate the
            # shared diff (evict_and_place appends, truncation) fails
            # loudly instead of silently poisoning the per-version cache.
            # Mutating paths require existing allocs and never take this
            # branch.
            place = tuple(AllocTuple(name, tg)
                          for name, tg in required.items())
            job.__dict__["_fresh_place"] = (job.modify_index, required,
                                            place)
        result = DiffResult()
        result.place = place
        return result
    result = DiffResult()
    existing = set()
    for exist in allocs:
        name = exist.name
        existing.add(name)
        tg = required.get(name)
        if tg is None:
            result.stop.append(AllocTuple(name, tg, exist))
            continue
        if tainted_nodes.get(exist.node_id):
            result.migrate.append(AllocTuple(name, tg, exist))
            continue
        if job is not None and exist.job is not None and \
                job.modify_index != exist.job.modify_index:
            result.update.append(AllocTuple(name, tg, exist))
            continue
        result.ignore.append(AllocTuple(name, tg, exist))

    for name, tg in required.items():
        if name not in existing:
            result.place.append(AllocTuple(name, tg))
    return result


_ALLOC_STUB_STATIC, _ALLOC_STUB_FACTORIES = proto_of(Allocation)


def _node_alloc_stub(node_id: str) -> Allocation:
    """Template-built Allocation carrying only a target node (the marker
    diff_system_allocs pins placements with) — ``__new__`` + dict copy,
    ~3x cheaper than the generated ``__init__`` at 1k nodes/eval."""
    a = Allocation.__new__(Allocation)
    d = dict(_ALLOC_STUB_STATIC, node_id=node_id)
    for name, fac in _ALLOC_STUB_FACTORIES:
        d[name] = fac()
    a.__dict__ = d
    return a


def diff_system_allocs(job: Job, nodes: list, tainted_nodes: dict,
                       allocs: list) -> DiffResult:
    """Per-node diff for system jobs; place tuples carry the target node.

    Flat single-pass form of "run diff_allocs once per node": same
    buckets in the same (node-major, first-encounter) order, without one
    DiffResult + AllocTuple churn per node — at 1k nodes the per-node
    objects dominated the whole system eval.  Migrations don't apply to
    system jobs: a tainted node's allocs just stop."""
    required = materialize_task_groups(job)
    result = DiffResult()
    place, stop = result.place, result.stop
    update, ignore = result.update, result.ignore

    # Node order: alloc-bearing nodes in first-encounter order, then the
    # remaining provided nodes (dict-insertion semantics of the previous
    # per-node implementation, preserved so rolling-update limits truncate
    # the same allocs).
    allocs_by_node: dict = {}
    order: list = []
    for alloc in allocs:
        lst = allocs_by_node.get(alloc.node_id)
        if lst is None:
            allocs_by_node[alloc.node_id] = lst = []
            order.append(alloc.node_id)
        lst.append(alloc)
    for node in nodes:
        if node.id not in allocs_by_node:
            allocs_by_node[node.id] = []
            order.append(node.id)

    required_items = list(required.items())
    job_mi = job.modify_index if job is not None else None
    for node_id in order:
        nallocs = allocs_by_node[node_id]
        if not nallocs:
            # Fresh node: everything required is missing.
            for name, tg in required_items:
                place.append(AllocTuple(name, tg,
                                        _node_alloc_stub(node_id)))
            continue
        existing = set()
        tainted = tainted_nodes.get(node_id)
        for alloc in nallocs:
            name = alloc.name
            existing.add(name)
            tg = required.get(name)
            if tg is None or tainted:
                stop.append(AllocTuple(name, tg, alloc))
            elif job_mi is not None and alloc.job is not None and \
                    job_mi != alloc.job.modify_index:
                update.append(AllocTuple(name, tg, alloc))
            else:
                ignore.append(AllocTuple(name, tg, alloc))
        for name, tg in required_items:
            if name not in existing:
                place.append(AllocTuple(name, tg,
                                        _node_alloc_stub(node_id)))
    return result


# Ready-set memo: the scan below is O(fleet) and runs once per eval; its
# result only changes when the nodes table changes.  Keyed PER LINEAGE
# in a WeakKeyDictionary — lineage is identity-preserved across
# snapshots/clones and replaced wholesale by snapshot restore, so a dead
# world's entries free themselves when its store drops the token, while
# several live stores in one process (test rigs, multi-server dev
# agents) each keep their own bounded sub-cache.  Any node write bumps
# the nodes index, so a hit is always current.  Callers get a fresh
# list (they shuffle in place).  Locked: workers call this concurrently.
_READY_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_READY_CACHE_MAX = 16  # per lineage
_READY_CACHE_LOCK = threading.Lock()


def ready_nodes_in_dcs(state, datacenters: list) -> list:
    tables = getattr(state, "_t", None)
    key = sub = None
    if tables is not None:
        key = (tables.indexes["nodes"], tuple(sorted(datacenters)))
        with _READY_CACHE_LOCK:
            sub = _READY_CACHE.get(tables.lineage)
            hit = sub.get(key) if sub is not None else None
            if hit is not None:
                return list(hit)
    dc_set = set(datacenters)
    out = []
    for node in state.nodes():
        if node.status != NODE_STATUS_READY:
            continue
        if node.drain:
            continue
        if node.datacenter not in dc_set:
            continue
        out.append(node)
    if key is not None:
        with _READY_CACHE_LOCK:
            sub = _READY_CACHE.get(tables.lineage)
            if sub is None:
                sub = _READY_CACHE[tables.lineage] = {}
            while len(sub) >= _READY_CACHE_MAX:
                sub.pop(next(iter(sub)), None)
            sub[key] = out
        return list(out)
    return out


def retry_max(max_attempts: int, cb: Callable[[], bool]) -> None:
    """Run cb until it returns True; raise SetStatusError past the limit."""
    for _ in range(max_attempts):
        if cb():
            return
    raise SetStatusError(
        f"maximum attempts reached ({max_attempts})", EVAL_STATUS_FAILED)


def tainted_nodes(state, allocs: list) -> dict:
    """node_id -> must-migrate for every node carrying one of the allocs."""
    out: dict = {}
    for alloc in allocs:
        if alloc.node_id in out:
            continue
        node = state.node_by_id(alloc.node_id)
        if node is None:
            out[alloc.node_id] = True
            continue
        out[alloc.node_id] = should_drain_node(node.status) or node.drain
    return out


def shuffle_nodes(nodes: list, rng=None) -> None:
    (rng or random).shuffle(nodes)


def tasks_updated(a: TaskGroup, b: TaskGroup) -> bool:
    """Do two task groups differ in a way that forbids in-place update?"""
    if len(a.tasks) != len(b.tasks):
        return True
    for at in a.tasks:
        bt = b.lookup_task(at.name)
        if bt is None:
            return True
        if at.driver != bt.driver:
            return True
        if at.config != bt.config:
            return True
        if len(at.resources.networks) != len(bt.resources.networks):
            return True
        for an, bn in zip(at.resources.networks, bt.resources.networks):
            if len(an.dynamic_ports) != len(bn.dynamic_ports):
                return True
    return False


def set_status(planner, ev: Evaluation, next_eval: Optional[Evaluation],
               status: str, description: str = "") -> None:
    new_eval = ev.copy()
    new_eval.status = status
    new_eval.status_description = description
    if next_eval is not None:
        new_eval.next_eval = next_eval.id
    planner.update_eval(new_eval)


def inplace_update(ctx, ev: Evaluation, job: Job, stack,
                   updates: list) -> list:
    """Try to update allocs in place: speculatively evict, re-select on the
    same node, pop the eviction.  Returns the updates that still need a
    destructive (evict + place) path."""
    remaining = []
    inplace = 0
    for update in updates:
        existing_tg = update.alloc.job.lookup_task_group(
            update.task_group.name) if update.alloc.job else None
        if existing_tg is None or tasks_updated(update.task_group, existing_tg):
            remaining.append(update)
            continue

        node = ctx.state().node_by_id(update.alloc.node_id)
        if node is None:
            remaining.append(update)
            continue

        stack.set_nodes([node])
        # Stage an eviction so current usage is discounted during selection.
        ctx.plan().append_update(update.alloc, ALLOC_DESIRED_STATUS_STOP,
                                ALLOC_IN_PLACE)
        option, size = stack.select(update.task_group)
        ctx.plan().pop_update(update.alloc)

        if option is None:
            remaining.append(update)
            continue

        # Network assignments are immutable across in-place updates.
        for task_name, resources in option.task_resources.items():
            existing_res = update.alloc.task_resources.get(task_name)
            if existing_res is not None:
                resources.networks = existing_res.networks

        new_alloc = update.alloc.copy()
        new_alloc.eval_id = ev.id
        new_alloc.job = job
        new_alloc.resources = size
        new_alloc.task_resources = option.task_resources
        new_alloc.metrics = ctx.metrics()
        new_alloc.desired_status = ALLOC_DESIRED_STATUS_RUN
        new_alloc.desired_description = ""
        new_alloc.client_status = ALLOC_CLIENT_STATUS_PENDING
        ctx.plan().append_alloc(new_alloc)
        inplace += 1
    return remaining


def evict_and_place(ctx, diff: DiffResult, allocs: list, desc: str,
                    limit: list) -> bool:
    """Evict up to limit[0] allocs and queue replacements; True if limited.

    limit is a single-element list to emulate the reference's by-pointer
    rolling-update budget shared across migrate + update passes.
    """
    n = len(allocs)
    for i in range(min(n, limit[0])):
        a = allocs[i]
        ctx.plan().append_update(a.alloc, ALLOC_DESIRED_STATUS_STOP, desc)
        diff.place.append(a)
    if n <= limit[0]:
        limit[0] -= n
        return False
    limit[0] = 0
    return True


@dataclass
class TGConstraintTuple:
    constraints: list = field(default_factory=list)
    drivers: set = field(default_factory=set)
    size: Resources = field(default_factory=Resources)


def task_group_constraints(tg: TaskGroup) -> TGConstraintTuple:
    """Aggregate a task group's constraints, drivers and total resources."""
    c = TGConstraintTuple()
    c.constraints += tg.constraints
    for task in tg.tasks:
        c.drivers.add(task.driver)
        c.constraints += task.constraints
        c.size.add(task.resources)
    return c
