"""Plan verification: the serialization point of optimistic concurrency.

Counterpart of the verify half of ``nomad_tpu/server/plan_apply.py``
(reference nomad/plan_apply.go:171-284): every node a plan touches is
checked against a state snapshot (node ready + AllocsFit + exact ports
and bandwidth); the plan is partially accepted (or wholly rejected for
AllAtOnce plans) with a RefreshIndex that makes the scheduler refresh
its stale view.  ``OptimisticSnapshot`` overlays not-yet-committed
allocs on a snapshot so plan N+1 can be verified while plan N commits.

The leader's applier thread, the component executor and the committer
are not part of this module yet: the batch runner and the harness's
``VerifyingPlanner`` drive verification directly.
"""
from __future__ import annotations

import time
from typing import Optional

from nomad_tpu_torch.structs import (
    NODE_STATUS_READY,
    Plan,
    PlanResult,
    allocs_fit,
    filter_terminal_allocs,
    remove_allocs,
)
from nomad_tpu_torch.utils.metrics import metrics


class OptimisticSnapshot:
    """Read view = base snapshot + not-yet-committed alloc upserts.

    Lets the applier verify plan N+1 while plan N's raft apply is still in
    flight (the reference mutates its state snapshot in place; our MVCC
    snapshots are immutable, so this overlay provides the same effect)."""

    def __init__(self, base) -> None:
        self.base = base
        self._overlay: dict = {}        # alloc id -> Allocation
        self._by_node: dict = {}        # node id -> [alloc ids]

    def upsert_allocs(self, allocs: list) -> None:
        for a in allocs:
            if a.id not in self._overlay:
                self._by_node.setdefault(a.node_id, []).append(a.id)
            self._overlay[a.id] = a

    # -- read API used by plan evaluation ---------------------------------
    def node_by_id(self, node_id: str):
        return self.base.node_by_id(node_id)

    def allocs_by_node(self, node_id: str) -> list:
        base = self.base.allocs_by_node(node_id)
        if not self._overlay:
            return base
        merged = {a.id: a for a in base}
        for aid in self._by_node.get(node_id, ()):
            merged[aid] = self._overlay[aid]
        return list(merged.values())

    def get_index(self, table: str) -> int:
        return self.base.get_index(table)


def evaluate_plan(snap, plan: Plan) -> PlanResult:
    """Determine the committable portion of a plan
    (plan_apply.go:171-233).

    The per-node verdicts come from a vectorized pass over the fleet
    mirror when the snapshot supports it (one numpy fit row + O(plan)
    port/bandwidth bookkeeping per node, see _evaluate_plan_vec);
    nodes the vector pass cannot serve — and any snapshot without a
    mirror — fall back to the scalar allocs_fit/NetworkIndex walk,
    which stays the semantic truth."""
    _start = time.perf_counter()
    result = PlanResult(failed_allocs=list(plan.failed_allocs))

    node_ids = set(plan.node_update) | set(plan.node_allocation)
    # Evict-only plans are trivially acceptable per node; don't spin up
    # (or permanently enable) the mirror's net tracking for them.
    verdicts = _evaluate_plan_vec(snap, plan, node_ids) \
        if any(plan.node_allocation.values()) else None
    for node_id in node_ids:
        ok = verdicts.get(node_id) if verdicts is not None else None
        if ok is None:
            ok = _evaluate_node_plan(snap, plan, node_id)
        if ok:
            if plan.node_update.get(node_id):
                result.node_update[node_id] = plan.node_update[node_id]
            if plan.node_allocation.get(node_id):
                result.node_allocation[node_id] = \
                    plan.node_allocation[node_id]
            continue

        # Scheduler had stale data: RefreshIndex forces a fresh view.
        result.refresh_index = max(snap.get_index("nodes"),
                                   snap.get_index("allocs"))
        if plan.all_at_once:
            result.node_update = {}
            result.node_allocation = {}
            return result
        # Partial acceptance: skip this node only.
    metrics.measure_since("nomad.plan.evaluate", _start)
    return result


def _evaluate_plan_vec(snap, plan: Plan, node_ids) -> Optional[dict]:
    """Vectorized node verdicts: {node_id: True/False/None} or None when
    the snapshot cannot take the vector path at all.  ``None`` verdicts
    punt single nodes to the exact scalar walk.

    Capability parity with the per-node loop of
    reference nomad/plan_apply.go:238-284, restructured for
    throughput: instead of rebuilding a Resources sum and a NetworkIndex
    per node per plan, the fleet UsageMirror keeps per-node usage rows,
    port counts and bandwidth sums synced incrementally from the store
    changelog, so one plan's verification costs O(plan size), not
    O(allocs on touched nodes).  Dimension sums ride float32 like every
    other fleet tensor (exact for values < 2^24, i.e. any realistic
    node).  Nodes with multi-network topologies, mixed-ip/device alloc
    offers, or overlay (in-flight apply) deltas keep the scalar truth.
    """
    base = snap
    overlay = None
    if isinstance(snap, OptimisticSnapshot):
        overlay = snap
        base = snap.base
    if getattr(base, "_t", None) is None:
        return None
    from nomad_tpu_torch.models.fleet import (alloc_vec, fleet_cache,
                                              mirror_for)

    statics = fleet_cache.statics_for(base)
    mirror = mirror_for(statics)
    capacity = statics.capacity
    reserved = statics.reserved
    index_of = statics.index_of
    overlay_nodes = overlay._by_node if overlay is not None else {}

    # The net dicts are mutated in place by concurrent worker syncs;
    # hold the mirror for the whole composite read (the usage array is
    # copy-on-write, but alloc_rows/node_ports/net_rows are not).
    with mirror.lock:
        if not mirror.sync_net(base):
            return None  # snapshot older than the mirror: scalar truth
        usage = mirror.usage

        verdicts: dict = {}
        for nid in node_ids:
            placements = plan.node_allocation.get(nid)
            if not placements:
                verdicts[nid] = True  # evict-only plans always fit
                continue
            node = snap.node_by_id(nid)
            if node is None or node.status != NODE_STATUS_READY \
                    or node.drain:
                verdicts[nid] = False
                continue
            ni = index_of.get(nid, -1)
            if ni < 0 or overlay_nodes.get(nid):
                verdicts[nid] = None  # not in fleet / in-flight overlay
                continue

            # --- resource fit: mirror row + plan deltas (the 4 dims
            # Resources.superset checks) -----------------------------
            removed_ids = {a.id for a in plan.node_update.get(nid, ())}
            removed_ids.update(a.id for a in placements)  # in-place upd
            used = reserved[ni] + usage[ni]
            for a in placements:
                used = used + alloc_vec(a)
            for aid in removed_ids:
                row = mirror.alloc_rows.get(aid)
                if row is not None and row[0] == ni:
                    used = used - row[1]
            cap = capacity[ni]
            if not (used[0] <= cap[0] and used[1] <= cap[1]
                    and used[2] <= cap[2] and used[3] <= cap[3]):
                verdicts[nid] = False
                continue

            # --- port collisions + bandwidth (exact, incremental) ----
            verdicts[nid] = _verify_node_net(
                mirror, statics, node, ni, placements, removed_ids)
    return verdicts


def _verify_node_net(mirror, statics, node, ni: int, placements,
                     removed_ids) -> Optional[bool]:
    """Exact port/bandwidth verdict for one node from the mirror's
    incremental per-node state: True fit, False reject, None = topology
    needs the scalar NetworkIndex walk.  Caller holds the mirror lock."""
    from nomad_tpu_torch.models.fleet import _net_row, net_base_for

    base = net_base_for(statics, ni, node)
    if base is None:
        return None  # multi-network node: exact path
    frozen_used, bw_reserved, bw_avail, ip, device = base
    node_key = (ip, device)

    # Existing offers must all live on the node's (ip, device) for the
    # merged per-node counting to be sound; odd rows force the exact walk.
    keys = mirror.node_net_keys.get(ni)
    if keys and (len(keys) > 1 or next(iter(keys)) != node_key):
        return None
    # The node's own reserved networks must ride the same (ip, device)
    # too: the scalar walk accounts reserved ports per-ip and reserved
    # bandwidth per-device, so an off-network reservation (or one with
    # no device — whose bandwidth the scalar path books against a
    # zero-capacity device) needs the exact walk.
    if node.reserved is not None and node.reserved.networks:
        total_reserved_ports = 0
        for rn in node.reserved.networks:
            if rn.ip != ip or rn.device != device:
                return None
            total_reserved_ports += len(rn.reserved_ports)
        if total_reserved_ports > len(frozen_used):
            return False  # reserved ports self-collide: never fits

    removed_ports: dict = {}
    removed_mbits = 0
    for aid in removed_ids:
        nr = mirror.net_rows.get(aid)
        if nr is not None and nr[0] == ni:
            for p in nr[1]:
                removed_ports[p] = removed_ports.get(p, 0) + 1
            removed_mbits += nr[2]

    pc = mirror.node_ports.get(ni, {})
    # Collisions among the POST-removal live set (or between a live
    # alloc and the node's reserved ports) reject the plan the same way
    # the scalar walk's collide flag does: an eviction in this plan may
    # free the colliding port, so counts are checked net of removals.
    if mirror.node_dup.get(ni):
        for p, c in pc.items():
            if c - removed_ports.get(p, 0) > 1:
                return False
    if frozen_used and pc:
        it = (p for p in frozen_used if p in pc) \
            if len(frozen_used) <= len(pc) \
            else (p for p in pc if p in frozen_used)
        for p in it:
            if pc.get(p, 0) - removed_ports.get(p, 0) > 0:
                return False

    placed_mbits = 0
    staged: set = set()
    for a in placements:
        row = _net_row(a)
        if row is None:
            continue
        ports, mbits, key = row
        if key != node_key:
            return None  # offer off the node's network: exact path
        placed_mbits += mbits
        for p in ports:
            if p in staged:
                return False  # duplicate within the plan itself
            staged.add(p)
            live = pc.get(p, 0) - removed_ports.get(p, 0)
            if live > 0 or p in frozen_used:
                return False  # collides with a live alloc / reserved port

    bw = bw_reserved + mirror.node_bw.get(ni, 0) \
        - removed_mbits + placed_mbits
    if bw > bw_avail:
        return False  # bandwidth exceeded
    return True


def _evaluate_node_plan(snap, plan: Plan, node_id: str) -> bool:
    """Is the plan valid for one node? (plan_apply.go:238-284)."""
    placements = plan.node_allocation.get(node_id, [])
    if not placements:
        return True  # evict-only plans always fit

    node = snap.node_by_id(node_id)
    if node is None or node.status != NODE_STATUS_READY or node.drain:
        return False

    existing = filter_terminal_allocs(snap.allocs_by_node(node_id))
    remove = list(plan.node_update.get(node_id, ())) + list(placements)
    proposed = remove_allocs(existing, remove) + list(placements)

    fit, _dim, _util = allocs_fit(node, proposed)
    return fit
