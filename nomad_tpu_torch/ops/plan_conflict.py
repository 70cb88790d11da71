"""Partitioned cross-plan conflict windows for the group-commit applier.

The leader's plan applier is the serialization point of optimistic
concurrency (server/plan_apply.py): under a contended storm it pays one
verify + one commit per plan.  ``evaluate_window`` restructures the
verify side for a whole *window* of pending plans:

  - the per-node resource fit — the numpy-churn hot loop of
    ``_evaluate_plan_vec`` — is computed for every (plan, node) claim in
    the window with a handful of dense array ops against the base
    snapshot's incremental usage mirror (models/fleet.py UsageMirror);
  - the window is PARTITIONED into connected components of the claim
    graph (``partition_window``: plans are vertices, joined when they
    claim a node in common).  Plans in different components touch
    disjoint node sets and therefore *cannot* conflict — each component
    verifies independently (concurrently, when the applier passes its
    component executor), while eval order is preserved exactly *within*
    each component;
  - order sensitivity within a component rides a *component overlay*
    (``_WindowState``) over a read-only per-window ``_Frame`` copied
    from the mirror: each plan's accepted portion is folded into the
    overlay before the next plan's verdicts — so plan i's claims are
    checked against committed state plus every earlier claim that could
    possibly interact with them, exactly the state sequential
    application would have reached;
  - claims the incremental path cannot serve (node not in the fleet,
    odd network topology) punt to the exact scalar walk against a
    component-local OptimisticSnapshot carrying the same folds, exactly
    as the per-plan verifier punts them.

The frame is copied under the mirror lock and the lock is RELEASED
before any component walks, so concurrent worker-side syncs are never
blocked behind a window verify (the old code held the mirror for the
whole pass).

Deadline-aware component scheduling: components are ordered by their
nearest member deadline (then window position), and the executor starts
them in that order — under saturation a near-deadline plan's component
verifies first, which together with the plan queue's deadline-promoted
drain keeps ``expired_drops`` at 0.

A plan whose claims overlap an earlier plan in the window (the
order-sensitive prefix conflict) is reported as a ``fallback`` — its
verdicts rode the component overlay rather than the clean dense pass —
and counted by the applier's ``conflict_fallbacks`` stat.  Because two
overlapping plans are by construction in the same component, the flag
means exactly what it meant when the window was one flat list.

Results are identical to calling ``evaluate_plan`` per plan in eval
order with the accepted portion of each plan folded into the view before
the next — for both the partitioned and the ``partition=False``
sequential path.

Counterpart of ``nomad_tpu/ops/plan_conflict.py``, with both of its
engines for the base fit (ops/verify_policy.py).  The host engine is the
dense numpy pass against the mirror.  The device engine launches the
window-verify kernel (K6, parallel/mesh.window_verify) once per window
against the usage copy and capacity/reserved resident on the caller's
``device``: the kernel returns the base fit and, per claim, the verdict
of the optimistic overlay fold, which a component walk takes wherever it
can prove the fold's all-accepted prefix held.  Verdicts, accepted
alloc sets and store fingerprints are byte-identical under either
engine.  Under the ``device`` policy a window first asks for a mesh
(parallel/mesh.dispatch_mesh, two or more devices) and verifies on the
mesh's resident sharded twins (``window_verify_sharded``: K7d on each
shard, then K6), as the JAX package does; without a mesh the port
launches K6 on the caller's one device (the JAX package stays on the
host there), and ``auto`` stays on the host.  A K6 or K7d build, launch
or fetch failure on the CUDA path raises; it does not fall back to the
host engine.  ``executor`` is any object with
``run_components(tasks, descs)`` returning each task's result in order
(the leader applier's component executor, which comes with the server
slice); without one every component walks inline.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from nomad_tpu_torch.structs import PlanResult

from nomad_tpu_torch.utils.metrics import metrics

_MISS = object()

# Components below this size verify inline on the applier thread even
# when an executor is available: a saturated-but-uncontended window is
# dozens of single-plan components whose walks are a few microseconds
# of GIL-bound Python — worker handoff costs more than it buys.  A
# component at or past this size carries a real conflict cluster (an
# ordered chain of folds and possibly exact-walk punts), which is what
# concurrent verification exists for.
MIN_CONCURRENT_COMPONENT = 8


class WindowOutcome:
    """One plan's verdict within a window."""

    __slots__ = ("result", "fallback", "component")

    def __init__(self, result: PlanResult, fallback: bool,
                 component: int = 0) -> None:
        self.result = result
        # True when this plan's claims overlapped an earlier plan in the
        # window (or an in-flight apply) — the order-sensitive prefix
        # conflict: its verdicts came from the component overlay, not
        # the clean dense pass.
        self.fallback = fallback
        # Scheduling-order index of the claim-graph component this plan
        # verified in (0 on the unpartitioned paths).
        self.component = component


class WindowVerdicts(list):
    """The outcomes list plus window-level partition/scheduling info
    (``.info`` — None on the paths that never partitioned)."""

    def __init__(self, outcomes, info: Optional[dict] = None) -> None:
        super().__init__(outcomes)
        self.info = info


class _OverGet:
    """dict-shaped ``.get`` view: window overrides chained over the base
    frame's dict.  An override of None is a tombstone (entry removed
    within the window)."""

    __slots__ = ("over", "base")

    def __init__(self, over: dict, base: dict) -> None:
        self.over = over
        self.base = base

    def get(self, key, default=None):
        v = self.over.get(key, _MISS)
        if v is _MISS:
            return self.base.get(key, default)
        return default if v is None else v


class _DupGet:
    """``node_dup``-shaped view: duplicate-port counts recomputed from
    the window's materialized per-node port dicts, base passthrough for
    untouched nodes.  Port dicts are tens of entries, so the recompute
    is cheaper than incremental bookkeeping is error-prone."""

    __slots__ = ("ports", "base")

    def __init__(self, ports: dict, base: dict) -> None:
        self.ports = ports
        self.base = base

    def get(self, ni, default=None):
        pc = self.ports.get(ni)
        if pc is None:
            return self.base.get(ni, default)
        dup = sum(1 for c in pc.values() if c > 1)
        return dup if dup else default


class _Frame:
    """Read-only per-window copy of the mirror state the component
    walks consume, restricted to the window's touched nodes and claimed
    alloc ids.  Copied under the mirror lock, read without it — the
    lock is released before any component verifies, so worker-side
    mirror syncs never queue behind a window, and component walks on
    executor threads never read mirror state the lock discipline
    guards."""

    __slots__ = ("alloc_rows", "net_rows", "node_ports", "node_bw",
                 "node_net_keys", "node_dup")

    def __init__(self, mirror, ids, nis) -> None:
        alloc_rows = {}
        net_rows = {}
        m_rows = mirror.alloc_rows
        m_net = mirror.net_rows
        nis = set(nis)  # caller's set stays untouched; adds are O(1)
        for aid in ids:
            row = m_rows.get(aid)
            if row is not None:
                alloc_rows[aid] = (row[0], row[1])
                nis.add(row[0])
            nr = m_net.get(aid)
            if nr is not None:
                net_rows[aid] = nr
                nis.add(nr[0])
        self.alloc_rows = alloc_rows
        self.net_rows = net_rows
        self.node_ports = {}
        self.node_bw = {}
        self.node_net_keys = {}
        self.node_dup = {}
        for ni in nis:
            pc = mirror.node_ports.get(ni)
            if pc is not None:
                self.node_ports[ni] = dict(pc)
            bw = mirror.node_bw.get(ni)
            if bw:
                self.node_bw[ni] = bw
            keys = mirror.node_net_keys.get(ni)
            if keys is not None:
                self.node_net_keys[ni] = dict(keys)
            dup = mirror.node_dup.get(ni)
            if dup:
                self.node_dup[ni] = dup


class _WindowState:
    """Component overlay over a window ``_Frame``: base state plus the
    accepted portions of earlier plans in the component (and the
    in-flight apply's allocs that touch it), exposing exactly the reads
    the verifier needs — the same
    ``net_rows/node_ports/node_dup/node_bw/node_net_keys`` surface
    ``plan_apply._verify_node_net`` consumes, plus per-node 4-dim usage
    deltas for the fit check.  Never mutates the frame: per-node dicts
    are copied on first window write."""

    def __init__(self, frame, index_of) -> None:
        from nomad_tpu_torch.models.fleet import _net_row, alloc_vec

        self._net_row = _net_row
        self._alloc_vec = alloc_vec
        self.m = frame
        self.index_of = index_of
        self.usage_delta: dict = {}   # ni -> [f, f, f, f]
        self._rows: dict = {}         # aid -> (ni, vec) | None
        self._net_over: dict = {}     # aid -> net row | None
        self._ports: dict = {}        # ni -> merged {port: count}
        self._bw: dict = {}           # ni -> merged mbits
        self._keys: dict = {}         # ni -> merged {(ip, dev): count}
        # The verifier-facing surface:
        self.net_rows = _OverGet(self._net_over, frame.net_rows)
        self.node_ports = _OverGet(self._ports, frame.node_ports)
        self.node_bw = _OverGet(self._bw, frame.node_bw)
        self.node_net_keys = _OverGet(self._keys, frame.node_net_keys)
        self.node_dup = _DupGet(self._ports, frame.node_dup)

    # -- removal accounting (the caller's removed_ids walk) ---------------
    def alloc_row(self, aid):
        """(ni, vec) of a live alloc — window override first, then the
        frame — or None when absent/removed."""
        v = self._rows.get(aid, _MISS)
        if v is not _MISS:
            return v
        return self.m.alloc_rows.get(aid)

    # -- copy-on-write materialization ------------------------------------
    def _ports_for(self, ni) -> dict:
        pc = self._ports.get(ni)
        if pc is None:
            pc = self._ports[ni] = dict(self.m.node_ports.get(ni, ()))
        return pc

    def _keys_for(self, ni) -> dict:
        keys = self._keys.get(ni)
        if keys is None:
            keys = self._keys[ni] = dict(
                self.m.node_net_keys.get(ni, ()))
        return keys

    def _bw_add(self, ni, mbits) -> None:
        self._bw[ni] = self.node_bw.get(ni, 0) + mbits

    # -- folds -------------------------------------------------------------
    def fold(self, alloc) -> None:
        """Apply one accepted alloc (placement or eviction) to the
        component overlay — the same old-row-out/new-row-in transition
        the mirror's own delta sync performs on commit."""
        aid = alloc.id
        old = self.alloc_row(aid)
        if old is not None:
            ni0, vec0 = old
            d = self.usage_delta.setdefault(ni0, [0.0] * 4)
            d[0] -= float(vec0[0])
            d[1] -= float(vec0[1])
            d[2] -= float(vec0[2])
            d[3] -= float(vec0[3])
        self._rows[aid] = None
        nr = self.net_rows.get(aid)
        if nr is not None:
            ni0, ports, mbits, key = nr
            if mbits:
                self._bw_add(ni0, -mbits)
            keys = self._keys_for(ni0)
            c = keys.get(key, 0) - 1
            if c > 0:
                keys[key] = c
            else:
                keys.pop(key, None)
            if ports:
                pc = self._ports_for(ni0)
                for p in ports:
                    c = pc.get(p, 0) - 1
                    if c > 0:
                        pc[p] = c
                    else:
                        pc.pop(p, None)
        self._net_over[aid] = None

        if alloc.terminal_status():
            return
        ni = self.index_of.get(alloc.node_id, -1)
        if ni < 0:
            return
        vec = self._alloc_vec(alloc)
        self._rows[aid] = (ni, vec)
        d = self.usage_delta.setdefault(ni, [0.0] * 4)
        d[0] += float(vec[0])
        d[1] += float(vec[1])
        d[2] += float(vec[2])
        d[3] += float(vec[3])
        row = self._net_row(alloc)
        if row is not None:
            ports, mbits, key = row
            self._net_over[aid] = (ni, ports, mbits, key)
            if mbits:
                self._bw_add(ni, mbits)
            keys = self._keys_for(ni)
            keys[key] = keys.get(key, 0) + 1
            if ports:
                pc = self._ports_for(ni)
                for p in ports:
                    pc[p] = pc.get(p, 0) + 1


def _touched(plan) -> set:
    return set(plan.node_update) | set(plan.node_allocation)


def _plan_alloc_ids(plan) -> set:
    ids = set()
    for allocs in plan.node_update.values():
        ids.update(a.id for a in allocs)
    for allocs in plan.node_allocation.values():
        ids.update(a.id for a in allocs)
    return ids


def _accepted_allocs(result) -> list:
    allocs = []
    for updates in result.node_update.values():
        allocs.extend(updates)
    for placements in result.node_allocation.values():
        allocs.extend(placements)
    allocs.extend(result.failed_allocs)
    return allocs


def partition_window(plans: list) -> list:
    """Connected components of the window's claim graph: plans are
    vertices, joined when they claim (place on OR evict from) a node in
    common.  Returns a list of components, each an ascending list of
    plan indices, ordered by first member — so concatenating them in
    order visits a conflict-free permutation of the window.

    Union-find over a node-id -> first-claimant map: O(total claims)
    with near-constant find, cheap enough to run on every window."""
    n = len(plans)
    parent = list(range(n))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]  # path halving
            i = parent[i]
        return i

    owner: dict = {}
    for i, plan in enumerate(plans):
        for nid in _touched(plan):
            j = owner.get(nid)
            if j is None:
                owner[nid] = i
            else:
                ri, rj = find(i), find(j)
                if ri != rj:
                    # Union by MIN root: a component's root is always
                    # its earliest plan, keeping output deterministic.
                    if rj < ri:
                        ri, rj = rj, ri
                    parent[rj] = ri
    comps: dict = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    return [comps[r] for r in sorted(comps)]


def evaluate_window(snap, plans: list, executor=None,
                    partition: bool = True,
                    device=None) -> WindowVerdicts:
    """Verify a window of plans; returns one WindowOutcome per plan,
    results identical to sequential ``evaluate_plan`` + fold-into-
    overlay per plan in eval order.

    ``snap`` may be an OptimisticSnapshot carrying an in-flight apply's
    overlay; it is MUTATED — each plan's accepted portion is folded in so
    the caller's overlay ends up exactly as sequential application would
    leave it.

    ``partition=True`` splits the window into claim-graph components
    (scheduled nearest-deadline-first, concurrently when ``executor``
    is given); ``partition=False`` keeps the flat one-overlay walk —
    the pre-partition behavior, kept as the bench's in-run sequential
    baseline and exercised by the parity rigs.

    ``device`` is where the ``device`` verify policy launches K6 (a
    CUDA device: the kernel; ``cpu``: its plain version) when no mesh
    resolves; with None and no mesh that policy reports the ``no-mesh``
    fallback and the host engine runs.  ``info["device"]`` records what
    happened, with the JAX package's keys.
    """
    from nomad_tpu_torch.server.plan_apply import (
        OptimisticSnapshot,
        evaluate_plan,
    )

    overlay = snap if isinstance(snap, OptimisticSnapshot) \
        else OptimisticSnapshot(snap)
    if len(plans) == 1:
        # No cross-plan structure to exploit: the per-plan path already
        # carries its own vectorized fit (plan_apply._evaluate_plan_vec).
        # Same fallback definition as the window paths — overlap with
        # the in-flight apply's overlay counts.
        fallback = bool(_touched(plans[0])
                        & {n for n in overlay._by_node if n})
        result = evaluate_plan(snap, plans[0])
        if overlay is snap:
            # Only a caller-owned overlay needs the fold; a throwaway
            # one built here is dead work.
            overlay.upsert_allocs(_accepted_allocs(result))
        return WindowVerdicts([WindowOutcome(result, fallback)])

    start = time.perf_counter()
    outcomes = _evaluate_window_vec(overlay, plans, executor, partition,
                                    device)
    if outcomes is None:
        # No incremental mirror for this snapshot: per-plan exact path
        # against the running overlay, still in eval order.
        outcomes = WindowVerdicts([])
        dirty: set = {n for n in overlay._by_node if n}
        for plan in plans:
            nodes = _touched(plan)
            result = evaluate_plan(overlay, plan)
            outcomes.append(WindowOutcome(result, bool(nodes & dirty)))
            overlay.upsert_allocs(_accepted_allocs(result))
            # Same fallback definition as the vec path's `claimed`:
            # every node an earlier plan TOUCHED (accepted or not), so
            # the stat means one thing regardless of which path ran.
            dirty |= nodes
    metrics.measure_since("nomad.plan.evaluate_window", start)
    return outcomes


class _Prep:
    """Everything the component walks share, frozen by the coordinator
    before any component starts: the dense base-fit results, the frame,
    and the in-flight overlay's contents.  Read-only once built.

    ``devfit`` is None on the host engine; after a K6 launch it carries
    the kernel's optimistic fold verdicts (``base_used``/``caps`` then
    hold the FETCHED device numbers — byte-identical to the host
    gather, so the walks don't care which engine filled them)."""

    __slots__ = ("plans", "plan_nodes", "verdicts", "pairs", "pair_of",
                 "base_used", "caps", "frame", "index_of", "statics",
                 "base", "refresh_index", "inflight", "inflight_nodes",
                 "inflight_by_node", "inflight_by_id", "devfit")


class _DeviceFit:
    """Fetched per-pair results of one K6 launch.

    ``fits_seq[pair]`` is the kernel's optimistic overlay-fold verdict
    — base fit plus ALL earlier same-component window plans' deltas
    under the all-accepted assumption.  ``seq_ok`` is the window-level
    eligibility: False when any alloc id is referenced by two claims
    (double-evict / replace-after-place), where the optimistic prefix
    cannot equal the host fold order.  _walk_component additionally
    requires its own ``clean`` proof before trusting a verdict."""

    __slots__ = ("fits_seq", "seq_ok")


def _window_device_args(plans, plan_nodes, verdicts, pairs, mirror,
                        index_of, frame_ids, plan_comp, alloc_vec):
    """Per-window fold descriptors for K6, built under the mirror lock
    (reads ``mirror.alloc_rows`` — the same rows the ``_Frame``
    copies).  Simulates ``_WindowState.fold`` for every claim that can
    still be accepted (pass-1 rejections excluded, ``failed_allocs``
    included — the walk folds those even on rejection), tagging each
    entry with its window plan index and claim-graph component so the
    kernel's prefix mask reproduces the component-local host fold order
    exactly."""
    m_rows = mirror.alloc_rows
    seq_ni: list = []
    seq_vec: list = []
    seq_order: list = []
    seq_comp: list = []
    ref_count: dict = {}

    def sim_fold(a, i, ci) -> None:
        aid = a.id
        ref_count[aid] = ref_count.get(aid, 0) + 1
        # Frame-restricted like _WindowState.alloc_row: an id outside
        # the window's frame reads None on the host walk too.
        row = m_rows.get(aid) if aid in frame_ids else None
        if row is not None:
            v = row[1]
            seq_ni.append(row[0])
            seq_vec.append([-float(v[0]), -float(v[1]), -float(v[2]),
                           -float(v[3])])
            seq_order.append(i)
            seq_comp.append(ci)
        if a.terminal_status():
            return
        ni = index_of.get(a.node_id, -1)
        if ni < 0:
            return
        v = alloc_vec(a)
        seq_ni.append(ni)
        seq_vec.append([float(v[0]), float(v[1]), float(v[2]),
                        float(v[3])])
        seq_order.append(i)
        seq_comp.append(ci)

    for i, plan in enumerate(plans):
        ci = plan_comp[i]
        pv = verdicts[i]
        for nid in plan_nodes[i]:
            if pv.get(nid, _MISS) is False:
                continue  # pass-1 rejection: none of its allocs fold
            for a in plan.node_update.get(nid, ()):
                sim_fold(a, i, ci)
            for a in plan.node_allocation.get(nid, ()):
                sim_fold(a, i, ci)
        for a in plan.failed_allocs:
            sim_fold(a, i, ci)
    seq_ok = all(c == 1 for c in ref_count.values())

    pair_removed: list = []
    for (_i, _nid, ni, _node, _placements, removed) in pairs:
        r0 = r1 = r2 = r3 = 0.0
        for aid in removed:
            row = m_rows.get(aid)
            if row is not None and row[0] == ni:
                v = row[1]
                r0 += float(v[0])
                r1 += float(v[1])
                r2 += float(v[2])
                r3 += float(v[3])
        pair_removed.append([r0, r1, r2, r3])

    return {
        "pair_ni": [p[2] for p in pairs],
        "pair_order": [p[0] for p in pairs],
        "pair_comp": [plan_comp[p[0]] for p in pairs],
        "pair_removed": pair_removed,
        "seq_ni": seq_ni,
        "seq_vec": seq_vec,
        "seq_order": seq_order,
        "seq_comp": seq_comp,
        "seq_ok": seq_ok,
    }


def _dispatch_window_fit(capres, lease, dargs, vec_pair, vec_rows,
                         n_pairs, mesh=None):
    """ONE K6 launch for the whole window's base fit + overlay fold,
    against the resident tensors (``capres`` from the statics,
    ``lease`` from UsageMirror.window_lease); on a ``mesh``, the
    resident sharded twins through ``window_verify_sharded`` (K7d on
    each shard, then K6).  Runs OUTSIDE the mirror lock — the
    descriptors are tiny host arrays, padded to one shared power-of-two
    bucket.  Returns (used_rows, caps_rows, _DeviceFit, devinfo);
    used/caps come back through the counted fetch seam and drop into
    ``prep.base_used``/``prep.caps`` exactly where the host gather's
    ``.tolist()`` sat.  Any failure raises."""
    from functools import partial

    from nomad_tpu_torch.models.fleet import _pad_to
    from nomad_tpu_torch.parallel.devices import fetch_host, transfer_counts
    from nomad_tpu_torch.parallel.mesh import (
        unpack_results,
        window_verify,
        window_verify_sharded,
    )

    bucket = _pad_to(max(n_pairs, len(vec_rows), len(dargs["seq_ni"])))

    def pad_i(vals, fill):
        arr = np.full(bucket, fill, dtype=np.int32)
        if vals:
            arr[:len(vals)] = vals
        return arr

    def pad_v(vals):
        arr = np.zeros((bucket, 4), dtype=np.float32)
        if len(vals):
            arr[:len(vals)] = np.asarray(vals, dtype=np.float32)[:, :4]
        return arr

    t0 = time.perf_counter()
    before = transfer_counts()
    verify = window_verify if mesh is None \
        else partial(window_verify_sharded, mesh)
    out = verify(
        capres[0], capres[1], lease, packed=True,
        counts=(n_pairs, len(vec_rows), len(dargs["seq_ni"])),
        pair_ni=pad_i(dargs["pair_ni"], 0), row_pair=pad_i(vec_pair, 0),
        row_vec=pad_v(vec_rows), seq_ni=pad_i(dargs["seq_ni"], -1),
        seq_vec=pad_v(dargs["seq_vec"]),
        seq_order=pad_i(dargs["seq_order"], 0),
        seq_comp=pad_i(dargs["seq_comp"], -1),
        pair_order=pad_i(dargs["pair_order"], 0),
        pair_comp=pad_i(dargs["pair_comp"], 0),
        pair_removed=pad_v(dargs["pair_removed"]))
    # used, caps and fits of the real pairs: one buffer, one fetch
    used, caps, fits = unpack_results(fetch_host(out[:n_pairs]))
    after = transfer_counts()
    devfit = _DeviceFit()
    devfit.fits_seq = fits
    devfit.seq_ok = dargs["seq_ok"]
    devinfo = {
        "dispatched": True,
        "fallback": None,
        "pairs": n_pairs,
        "bucket": int(bucket),
        "seq_ok": dargs["seq_ok"],
        "h2d": after["h2d"] - before["h2d"],
        "d2h": after["d2h"] - before["d2h"],
        "wall": time.perf_counter() - t0,
    }
    return used.tolist(), caps.tolist(), devfit, devinfo


def _evaluate_window_vec(overlay, plans: list, executor, partition: bool,
                         device) -> Optional[WindowVerdicts]:
    """The vectorized window pass: dense base fit for every claim under
    the mirror lock, then per-component in-order verdict walks against
    the released frame.  Returns None when the snapshot cannot take the
    incremental path at all."""
    from nomad_tpu_torch.models.fleet import alloc_vec, fleet_cache, mirror_for
    from nomad_tpu_torch.structs import NODE_STATUS_READY

    base = overlay.base
    if getattr(base, "_t", None) is None:
        return None
    if not any(any(p.node_allocation.values()) for p in plans):
        # Evict/update-only window: every per-node verdict is True by
        # definition; don't spin up the mirror's net tracking for it.
        # The fallback stat keeps the uniform definition (claims
        # overlapping an earlier plan's touched nodes) even though the
        # verdicts here are state-independent.
        outcomes = WindowVerdicts([])
        claimed = {n for n in overlay._by_node if n}
        for plan in plans:
            nodes = _touched(plan)
            result = PlanResult(
                node_update={k: v for k, v in plan.node_update.items()
                             if v},
                node_allocation={k: v for k, v
                                 in plan.node_allocation.items() if v},
                failed_allocs=list(plan.failed_allocs))
            outcomes.append(WindowOutcome(result, bool(nodes & claimed)))
            overlay.upsert_allocs(_accepted_allocs(result))
            claimed |= nodes
        return outcomes

    statics = fleet_cache.statics_for(base)
    mirror = mirror_for(statics)
    capacity = statics.capacity
    index_of = statics.index_of

    # Pass-2 components are computed up front (pure on the plans): the
    # device fold descriptors need each plan's component id so the
    # kernel's prefix mask stays component-local — exactly the overlay
    # each host walk sees.
    if partition:
        comps = partition_window(plans)
    else:
        comps = [list(range(len(plans)))]
    plan_comp = [0] * len(plans)
    for ci, comp in enumerate(comps):
        for i in comp:
            plan_comp[i] = ci

    # Verify policy (ops/verify_policy.py): mesh and device resolution
    # and the warm-up of the resident copies happen OUTSIDE the mirror
    # lock; under the lock the device path only LOOKS UP residency (the
    # window-lease rule).  ``auto`` stays on the host.  Under ``device``
    # a window first asks for a mesh (parallel/mesh.dispatch_mesh) and
    # verifies on its sharded twins; without one K6 runs on the
    # caller's device.
    from nomad_tpu_torch.ops.verify_policy import VERIFY_DEVICE, \
        verify_policy

    dev = None
    dev_mesh = None
    devinfo = None
    if verify_policy() == VERIFY_DEVICE:
        from nomad_tpu_torch.parallel.mesh import dispatch_mesh
        dev_mesh = dispatch_mesh(1, statics.n_pad, device=device)
        if dev_mesh is None and device is None:
            devinfo = {"dispatched": False, "fallback": "no-mesh"}
        else:
            # Forced intent: warm the copies now (no-op when resident)
            # so this window holds the lease.  The mirror syncs to the
            # window's snapshot first: a fresh fleet generation's first
            # sync is a rebuild, which drops any copy warmed before it.
            if not mirror.sync_net(base):
                return None  # snapshot older than the mirror
            if dev_mesh is not None:
                statics.device_capacity_reserved_sharded(dev_mesh)
                mirror.device_usage_sharded(dev_mesh, mirror.usage)
            else:
                from nomad_tpu_torch.parallel.devices import resolve_device
                dev = resolve_device(device)
                statics.device_capacity_reserved(dev)
                mirror.device_usage(dev)

    prep = _Prep()
    prep.plans = plans
    prep.base = base
    prep.statics = statics
    prep.index_of = index_of
    prep.refresh_index = max(overlay.get_index("nodes"),
                             overlay.get_index("allocs"))
    prep.inflight = list(overlay._overlay.values())
    prep.inflight_nodes = {n for n in overlay._by_node if n}
    # Indexed ONCE per window: each component slices the in-flight
    # overlay by ITS nodes/ids in O(component), not O(overlay) — a
    # per-component scan would re-grow the O(window^2) fold churn the
    # partition exists to remove.  Entries carry their overlay
    # insertion ordinal so component folds keep the sequential order.
    prep.inflight_by_node = by_node = {}
    prep.inflight_by_id = by_id = {}
    for k, a in enumerate(prep.inflight):
        by_node.setdefault(a.node_id, []).append((k, a))
        by_id[a.id] = (k, a)
    prep.plan_nodes = [_touched(p) for p in plans]

    # The net dicts are mutated in place by concurrent worker syncs;
    # hold the mirror for the composite read — but ONLY for the dense
    # pass and the frame copy: the component walks run lock-free
    # against the frame.
    with mirror.lock:
        if not mirror.sync_net(base):
            return None  # snapshot older than the mirror: scalar truth
        usage = mirror.usage

        # Pass 1: classify every (plan, node) claim; gather the
        # placement-carrying in-fleet ones into flat arrays for ONE
        # dense base-fit pass (usage + reserved + sum-of-placements).
        verdicts: list = [dict() for _ in plans]
        pairs: list = []     # (plan_i, nid, ni, node, placements, removed)
        vec_rows: list = []  # placement resource vectors
        vec_pair: list = []  # pair index per vec row
        frame_ids: set = set()
        touched_nis: set = set()
        for i, plan in enumerate(plans):
            pv = verdicts[i]
            for nid in prep.plan_nodes[i]:
                placements = plan.node_allocation.get(nid)
                removed = {a.id for a in plan.node_update.get(nid, ())}
                frame_ids |= removed
                if not placements:
                    pv[nid] = True  # evict-only claims always fit
                    ni = index_of.get(nid, -1)
                    if ni >= 0:
                        touched_nis.add(ni)
                    continue
                frame_ids.update(a.id for a in placements)
                node = base.node_by_id(nid)
                if node is None or node.status != NODE_STATUS_READY \
                        or node.drain:
                    pv[nid] = False
                    continue
                ni = index_of.get(nid, -1)
                if ni < 0:
                    pv[nid] = None  # not in fleet: exact walk
                    continue
                touched_nis.add(ni)
                removed.update(a.id for a in placements)  # in-place upd
                pair = len(pairs)
                pairs.append((i, nid, ni, node, placements, removed))
                for a in placements:
                    vec_pair.append(pair)
                    vec_rows.append(alloc_vec(a))

        base_used: list = []
        caps: list = []
        dev_args = None
        dev_capres = None
        dev_lease = None
        if pairs:
            if dev_mesh is not None:
                # Residency lease on the mesh: the sharded twins of
                # THIS generation, or None — never an upload under the
                # lock.
                dev_lease = mirror.window_lease(dev_mesh)
                dev_capres = statics.sharded.lookup(("capres", dev_mesh))
            elif dev is not None:
                # Residency lease: references to the resident copies
                # of THIS generation, or None — never an upload under
                # the lock.
                dev_lease = mirror.window_lease(dev)
                dev_capres = statics.capres_lease(dev)
            if dev_lease is not None and dev_capres is not None:
                # Device engine: only the tiny fold descriptors are
                # built under the lock; the launch (and every counted
                # transfer) runs after release.
                dev_args = _window_device_args(
                    plans, prep.plan_nodes, verdicts, pairs, mirror,
                    index_of, frame_ids, plan_comp, alloc_vec)
            else:
                if dev is not None or dev_mesh is not None:
                    devinfo = {"dispatched": False,
                               "fallback": "lease-miss"
                               if dev_lease is None else "capres-miss"}
                # Host engine — dense fit inputs over every claim at
                # once: the 4 dims Resources.superset checks, float32
                # like the mirror rows (exact for values < 2^24, i.e.
                # any realistic node).
                ni_arr = np.fromiter((p[2] for p in pairs),
                                     dtype=np.int64, count=len(pairs))
                delta = np.zeros((len(pairs), 4), dtype=np.float32)
                np.add.at(delta, np.asarray(vec_pair, dtype=np.int64),
                          np.asarray(vec_rows, dtype=np.float32)[:, :4])
                used = usage[ni_arr, :4] \
                    + statics.reserved[ni_arr, :4] + delta
                base_used = used.tolist()
                caps = capacity[ni_arr, :4].tolist()

        # The in-flight apply's allocs fold into component overlays, so
        # their frame rows (and nodes) must ride along too.
        for a in prep.inflight:
            frame_ids.add(a.id)
            ni = index_of.get(a.node_id, -1)
            if ni >= 0:
                touched_nis.add(ni)
        prep.frame = _Frame(mirror, frame_ids, touched_nis)

    prep.devfit = None
    if dev_args is not None:
        base_used, caps, prep.devfit, devinfo = _dispatch_window_fit(
            dev_capres, dev_lease, dev_args, vec_pair, vec_rows,
            len(pairs), mesh=dev_mesh)

    prep.verdicts = verdicts
    prep.pairs = pairs
    prep.base_used = base_used
    prep.caps = caps
    pair_of: dict = {}
    for pair, (i, nid, *_rest) in enumerate(pairs):
        pair_of[(i, nid)] = pair
    prep.pair_of = pair_of

    # Pass 2: schedule and walk the components computed up front.
    # Mirror lock released — the walks read only the frame, the base
    # snapshot, and prep.
    if len(comps) > 1:
        # Deadline-aware scheduling: nearest member deadline first
        # (ties by window position), so a near-deadline plan's
        # component is never last in line behind the executor.
        def comp_key(comp):
            deadline = min((plans[i].deadline for i in comp
                            if plans[i].deadline), default=float("inf"))
            return (deadline, comp[0])
        order = sorted(range(len(comps)), key=lambda k: comp_key(comps[k]))
    else:
        order = list(range(len(comps)))

    wall0 = time.perf_counter()
    tasks = [(lambda comp=comps[k]: _walk_component(prep, comp))
             for k in order]
    if executor is not None and len(tasks) > 1 and \
            max(len(c) for c in comps) >= MIN_CONCURRENT_COMPONENT:
        results = executor.run_components(
            tasks, descs=[{"component": k, "plans": len(comps[k]),
                           "eval_ids": [plans[i].eval_id
                                        for i in comps[k]]}
                          for k in order])
    else:
        results = [t() for t in tasks]
    wall = time.perf_counter() - wall0

    slots: list = [None] * len(plans)
    comp_walls: list = []
    comp_t0s: list = []
    accepted_by_plan: list = [None] * len(plans)
    for ordinal, (entries, comp_t0, comp_wall) in enumerate(results):
        comp_walls.append(comp_wall)
        comp_t0s.append(comp_t0)
        for i, outcome, accepted in entries:
            outcome.component = ordinal
            slots[i] = outcome
            accepted_by_plan[i] = accepted
    # Fold every accepted portion into the caller's overlay in eval
    # order — the exact end state sequential application leaves.
    for i in range(len(plans)):
        overlay.upsert_allocs(accepted_by_plan[i])
    info = {
        "components": len(comps),
        "sizes": [len(c) for c in comps],
        "order": order,
        "comp_walls": comp_walls,
        "comp_t0s": comp_t0s,  # perf_counter epoch (span conversion)
        "wall": wall,
        # How much wall the partition saved vs walking the same
        # components serially (1.0 = none; GIL-bound walks cap this).
        "speedup": (sum(comp_walls) / wall) if wall > 0 else 1.0,
        # Device-verify engine record: None when the host engine ran by
        # policy; else the K6 dispatch or fallback record.
        "device": devinfo,
    }
    return WindowVerdicts(slots, info)


def _walk_component(prep, comp: list) -> tuple:
    """In-order verdict walk of one claim-graph component against its
    own overlay.  Returns ([(plan_index, WindowOutcome, accepted)],
    t0_perf_counter, wall_seconds).  Reads only frozen prep state + the
    base snapshot — safe on an executor thread."""
    from nomad_tpu_torch.server.plan_apply import (
        OptimisticSnapshot,
        _evaluate_node_plan,
        _verify_node_net,
    )

    t0 = time.perf_counter()
    plans = prep.plans
    statics = prep.statics
    inflight_nodes = prep.inflight_nodes
    wm = _WindowState(prep.frame, prep.index_of)
    comp_view: Optional[OptimisticSnapshot] = None
    accepted_log: list = []
    # Device fold verdicts apply only while the walk can PROVE the
    # kernel's optimistic all-accepted prefix held for this component:
    # window-unique alloc ids (seq_ok), no in-flight overlay folded in,
    # and every earlier plan of the component fully accepted.  Any
    # breach downgrades the REST of the component to the host
    # arithmetic — which reads prep.base_used/prep.caps, numbers that
    # are byte-identical under either engine.
    dev = prep.devfit
    dev_clean = dev is not None and dev.seq_ok

    comp_nodes: set = set()
    for i in comp:
        comp_nodes |= prep.plan_nodes[i]
    if prep.inflight:
        # Only the in-flight allocs this component can see: anything on
        # its nodes, or anything its plans replace/evict by id —
        # gathered via the per-window indexes in O(component), folded
        # in the overlay's insertion order (the fold order sequential
        # application used).
        picked: dict = {}
        for nid in comp_nodes:
            for k, a in prep.inflight_by_node.get(nid, ()):
                picked[k] = a
        by_id = prep.inflight_by_id
        for i in comp:
            for aid in _plan_alloc_ids(plans[i]):
                entry = by_id.get(aid)
                if entry is not None:
                    picked[entry[0]] = entry[1]
        for k in sorted(picked):
            wm.fold(picked[k])  # in-flight apply: committed state
        if picked:
            dev_clean = False  # overlay state the kernel never saw

    def view() -> OptimisticSnapshot:
        # Exact-walk punts are rare; the component's OptimisticSnapshot
        # is built lazily on the first one, seeded to the state the
        # shared sequential overlay would hold at this point.
        nonlocal comp_view
        if comp_view is None:
            comp_view = OptimisticSnapshot(prep.base)
            comp_view.upsert_allocs(prep.inflight)
            for accepted in accepted_log:
                comp_view.upsert_allocs(accepted)
        return comp_view

    entries: list = []
    claimed: set = set()
    last = comp[-1]
    for i in comp:
        plan = plans[i]
        pv = prep.verdicts[i]
        nodes = prep.plan_nodes[i]
        fallback = (not nodes.isdisjoint(claimed)) or \
                   (not nodes.isdisjoint(inflight_nodes))
        result = PlanResult(failed_allocs=list(plan.failed_allocs))
        plan_ok = True
        for nid in nodes:
            ok = pv.get(nid, _MISS)
            if ok is None:
                # Vector-ineligible claim: exact walk against the
                # component view (identical to the sequential verdict).
                ok = _evaluate_node_plan(view(), plan, nid)
            elif ok is _MISS:
                pair = prep.pair_of[(i, nid)]
                _i, _nid, ni, node, placements, removed = \
                    prep.pairs[pair]
                if dev_clean:
                    # The kernel's overlay fold IS this arithmetic
                    # (proof obligations met): take its verdict, keep
                    # the exact net checks.
                    ok = bool(dev.fits_seq[pair])
                else:
                    u0, u1, u2, u3 = prep.base_used[pair]
                    d = wm.usage_delta.get(ni)
                    if d is not None:
                        u0 += d[0]
                        u1 += d[1]
                        u2 += d[2]
                        u3 += d[3]
                    for aid in removed:
                        row = wm.alloc_row(aid)
                        if row is not None and row[0] == ni:
                            vec = row[1]
                            u0 -= float(vec[0])
                            u1 -= float(vec[1])
                            u2 -= float(vec[2])
                            u3 -= float(vec[3])
                    c = prep.caps[pair]
                    ok = (u0 <= c[0] and u1 <= c[1] and u2 <= c[2]
                          and u3 <= c[3])
                if ok:
                    # Port collisions + bandwidth: exact, against
                    # frame + component overlay (None punts the node
                    # to the scalar walk).
                    ok = _verify_node_net(wm, statics, node, ni,
                                          placements, removed)
                    if ok is None:
                        ok = _evaluate_node_plan(view(), plan, nid)
            if ok:
                if plan.node_update.get(nid):
                    result.node_update[nid] = plan.node_update[nid]
                if plan.node_allocation.get(nid):
                    result.node_allocation[nid] = \
                        plan.node_allocation[nid]
                continue
            plan_ok = False
            result.refresh_index = prep.refresh_index
            if plan.all_at_once:
                result.node_update = {}
                result.node_allocation = {}
                break
        if not plan_ok:
            # A rejected claim (or an aborted all_at_once plan) means
            # later plans in the component see an overlay the kernel's
            # all-accepted prefix did not model.
            dev_clean = False
        accepted = _accepted_allocs(result)
        accepted_log.append(accepted)
        if comp_view is not None:
            comp_view.upsert_allocs(accepted)
        if i != last:
            for alloc in accepted:
                wm.fold(alloc)
        claimed |= nodes
        entries.append((i, WindowOutcome(result, fallback), accepted))
    return entries, t0, time.perf_counter() - t0
