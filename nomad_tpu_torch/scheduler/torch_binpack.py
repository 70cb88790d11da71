"""Device scheduler backend on PyTorch + CUDA: batched bin-packing on the card.

Counterpart of ``nomad_tpu/scheduler/jax_binpack.py``, registered in
the scheduler factory as ``torch-binpack`` / ``torch-binpack-batch``
(reference seam: scheduler/scheduler.go:13-17 BuiltinSchedulers).

Architecture (reference walks nodes one iterator at a time,
scheduler/stack.go:126-153; this scores the whole fleet per placement):

  host (this file)                         device (nomad_tpu_torch/ops/binpack.py)
  ----------------                         ---------------------------------------
  reconcile job vs allocs (diff/migrate)   .
  compile constraint masks (numpy)     ──► feasible[G, N] resident on the card
  usage mirror synced from the store   ──► usage[N, D], job_counts[N]
  placement list (count expansion)     ──► place_rounds / place_sequence kernels
  exact port/bandwidth assignment      ◄── chosen[P], scores[P]
  plan construction / submit               .

The device mask is a sound over-approximation of network feasibility; the
exact NetworkIndex port assignment runs host-side on the winner, with a
sequential-stack fallback on the (rare) miss, so plans are exactly as valid
as the reference's.

The device the scheduler was built for is ``cuda`` by default
(``RuntimeError`` without one), ``cpu`` only when the caller passes it,
and then the kernels' plain versions run.  Per dispatch the executor
policy (scheduler/executor.py, ``choose_host_executor``) sends a walk
to that device or to the numpy twins of K2/K3 (ops/binpack_host.py):
a cost decision made before the dispatch, from constants measured on
an H100, never a fallback from a failed launch.

The finish runs in three phases, as in the JAX package: prepare, the
native happy-path prefix (the port's C extension, csrc/port_alloc.cpp,
built at first use by utils/native.py; columnar into an ``AllocSlab``
by default, the object contract when ``NOMAD_TPU_COLUMNAR=0``), then
the Python tail from wherever C handed the placement list back.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from random import randrange as _randrange

from nomad_tpu_torch.models.constraints import compile_group_mask, \
    group_mask_key
from nomad_tpu_torch.models.fleet import (
    NDIMS,
    _pad_to,
    build_usage,
    fleet_cache,
    mirror_for,
    net_base_for,
)
from nomad_tpu_torch.obs import trace as trace_mod
from nomad_tpu_torch.ops import binpack
from nomad_tpu_torch.parallel.devices import (
    copy_to_host_async,
    ensure_on_default,
    fetch_host,
    put_counted,
    resolve_device,
)
from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_FAILED,
    ALLOC_DESIRED_STATUS_RUN,
    CONSTRAINT_DISTINCT_HOSTS,
    AllocMetric,
    Allocation,
    NetworkIndex,
    NetworkResource,
    Resources,
    allocs_fit,
    generate_uuids,
)
from nomad_tpu_torch.structs.alloc_slab import (
    AllocSlab,
    SlabAlloc,
    columnar_enabled,
)
from nomad_tpu_torch.structs.model import MAX_DYNAMIC_PORT, \
    MIN_DYNAMIC_PORT, proto_of
from nomad_tpu_torch.utils import native as _native

from .generic import GenericScheduler
from .stack import (
    BATCH_JOB_ANTI_AFFINITY_PENALTY,
    SERVICE_JOB_ANTI_AFFINITY_PENALTY,
)
from .util import ready_nodes_in_dcs, task_group_constraints


_ALLOC_STATIC, _ALLOC_FACTORIES = proto_of(Allocation)
_METRIC_STATIC, _METRIC_FACTORIES = proto_of(AllocMetric)
_RES_STATIC, _RES_FACTORIES = proto_of(Resources)
_NET_STATIC, _NET_FACTORIES = proto_of(NetworkResource)


def _native_bulk():
    """The port's C extension (csrc/port_alloc.cpp), built and loaded at
    first use; a failed build raises.  The one seam through which the
    schedulers reach it: replacing it with a function that returns None
    runs the Python tail alone (the parity tests and chip_smoke.py's
    same-call comparison do)."""
    return _native.load()


def build_bulk_args(sched, place, group_l, chosen_l, scores_l,
                    uuids, slots_c, alloc_proto, metric_proto,
                    coalesce_all: int, port_lcg: int) -> tuple:
    """The native.bulk_finish argument tuple for one eval — the ONE
    producer of that layout, shared by the generic finish
    (``_finish_native_args`` with the columnar contract off) and the
    system scheduler (run_bulk_finish)."""
    plan = sched.plan
    statics = sched._statics
    return (
        place if type(place) is list else list(place),
        group_l, chosen_l, scores_l, uuids, slots_c,
        statics.nodes, sched._node_net, statics.net_base,
        sched._net_base_for,
        sched.state.allocs_node_index(), sched.ctx, plan.node_update,
        plan.node_allocation, plan.failed_allocs,
        alloc_proto, metric_proto,
        Allocation, AllocMetric, Resources, NetworkResource,
        (ALLOC_DESIRED_STATUS_RUN, ALLOC_CLIENT_STATUS_PENDING,
         ALLOC_DESIRED_STATUS_FAILED, ALLOC_CLIENT_STATUS_FAILED,
         "failed to find a node for placement"),
        coalesce_all, port_lcg, MIN_DYNAMIC_PORT,
        MAX_DYNAMIC_PORT)


def run_bulk_finish(native, sched, place, group_l, chosen_l, scores_l,
                    uuids, slots_c, alloc_proto, metric_proto,
                    coalesce_all: int):
    """One marshalling point for native.bulk_finish (the C finish-loop
    happy path, object contract).  ``sched`` supplies the per-eval
    placement state (_node_net/_net_base_for/_port_lcg via
    FastPlacementMixin, plan, state, ctx).  Returns (resume index,
    failed-TG map); updates sched._port_lcg."""
    start_p, sched._port_lcg, fmap = native.bulk_finish(
        *build_bulk_args(sched, place, group_l, chosen_l, scores_l,
                         uuids, slots_c, alloc_proto, metric_proto,
                         coalesce_all, sched._port_lcg))
    return start_p, fmap


def build_slots_c(slot_plans) -> list:
    """Slot table for the native bulk finish (csrc/port_alloc.cpp):
    one (size_obj, [(task_name, res_proto_dict, net_c), ...]) entry per
    slot, where net_c is None or (mbits, net_proto_dict, dyn_labels).
    ``slot_plans`` yields (size, plan_tasks) pairs (see _net_plan_for).
    Shared by the generic and system schedulers so the layout the C
    side consumes has exactly one producer."""
    slots_c = []
    for size, plan_tasks in slot_plans:
        tasks_c = []
        for tname, res, ask in plan_tasks:
            if res is None:
                res_proto = dict(_RES_STATIC)
            else:
                res_proto = dict(
                    _RES_STATIC, cpu=res.cpu, memory_mb=res.memory_mb,
                    disk_mb=res.disk_mb, iops=res.iops)
            net_c = None
            if ask is not None:
                net_c = (int(ask.mbits),
                         dict(_NET_STATIC, mbits=ask.mbits),
                         list(ask.dynamic_ports))
            tasks_c.append((tname, res_proto, net_c))
        slots_c.append((size, tasks_c))
    return slots_c


def _net_plan_for(tg):
    """Per-slot network plan for the finish loop:
    (fast_ok, [(task_name, base_resources, net_ask | None), ...]).
    fast_ok means every ask is a single network with only dynamic ports —
    the shape the O(1)-per-placement assigner handles; anything richer
    routes through the exact NetworkIndex."""
    plan_tasks = []
    fast_ok = True
    for task in tg.tasks:
        r = task.resources
        ask = None
        if r is not None and r.networks:
            if len(r.networks) != 1 or r.networks[0].reserved_ports:
                fast_ok = False
            ask = r.networks[0]
        plan_tasks.append((task.name, r, ask))
    return fast_ok, plan_tasks


def _fit_rounds(statics, view, feasible_h, asks, slot_placements,
                k_cap: int, rounds: int) -> tuple[int, bool]:
    """Fit-aware rounds refresh, run on EVERY dispatch (the prep cache
    can't carry it — usage moves without the job/fleet generation
    moving).  One round places at most one copy per currently-fitting
    node, so the static (constraint-only) estimate goes stale as the
    fleet fills: with 100 copies, 160 constraint-feasible nodes but
    only 60 with room, rounds=1 strands 40 copies that the next round
    would place.  Still an estimate — nodes filling MID-dispatch can
    strand copies; the finish loop's sequential fallback rescues those
    exactly.  Returns (rounds, rounds_eligible); need > 16 rounds means
    the eval is scan-shaped and the sequence kernel takes it."""
    n = statics.n_real
    if n == 0 or not slot_placements:
        return rounds, True
    if max(len(ps) for ps in slot_placements.values()) <= rounds:
        # No slot can need more rounds than it has copies (need =
        # ceil(count / fitting) <= count), so the per-slot fit walk
        # cannot raise ``rounds`` — skip it.  This is the 100k-1M-node
        # heterogeneous-storm shape (thousands of count-1 slots): the
        # walk would cost O(slots x nodes x dims) numpy per eval for a
        # guaranteed no-op answer.
        return rounds, True
    cap = statics.capacity[:n]
    res = statics.reserved[:n]
    usage = np.asarray(view.usage)[:n]
    for slot, ps in slot_placements.items():
        fit = ((usage + res + asks[slot]) <= cap).all(axis=-1)
        fit_count = int((fit & feasible_h[slot, :n]).sum())
        if fit_count == 0:
            # Nothing can place for this slot right now: one cheap
            # dispatch suffices — the finish fallback coalesces and
            # explains the failures.
            continue
        need = -(-len(ps) // min(fit_count, k_cap))  # ceil
        if need > 16:
            # Scan-shaped (huge count on a tiny fitting set): the exact
            # sequence kernel takes it.
            return rounds, False
        rounds = max(rounds, need)
    # Bucket to powers of two, as the JAX package does (there ``rounds``
    # is a static jit argument); the same value keeps the two packages'
    # placements equal.
    if rounds > 1:
        rounds = 1 << (rounds - 1).bit_length()
    return min(rounds, 16), True


def _refresh_rounds(args: "DeviceArgs") -> "DeviceArgs":
    """Per-dispatch rounds refinement applied to every DeviceArgs (both
    the prep-cache hit and the fresh build) — ONE call site per return
    so the policy cannot desynchronize."""
    if args.rounds_eligible:
        args.rounds, args.rounds_eligible = _fit_rounds(
            args.statics, args.view, args.feasible_h, args.asks,
            args.slot_placements, args.k_cap, args.rounds)
    return args


class DeviceArgs:
    """Everything one eval contributes to a (possibly batched) dispatch."""

    __slots__ = ("statics", "view", "feasible_d", "feasible_h", "asks",
                 "distinct", "group_idx", "valid", "sizes", "slot_of_tg",
                 "penalty", "g_pad", "p_pad", "start", "net_plans",
                 "n_groups", "n_place",
                 # rounds-mode plan (see ops/binpack.py place_rounds):
                 "counts", "slot_placements", "k_cap", "rounds",
                 "rounds_eligible",
                 # finish-loop derivations shared via the prep cache:
                 # fast_all = every slot takes the O(1) network path;
                 # group_l = group_idx[:n_place].tolist(); slots_c is a
                 # one-element holder lazily filled with the native
                 # bulk-finish slot table (built on first finish);
                 # col_meta is the columnar twin — a one-element holder
                 # for (names, tg_names, slot_mbits, slot_ndyn,
                 # slot_has, port_off), the per-job-version constants of
                 # the AllocSlab contract (built on first columnar
                 # finish; shared read-only across the job's slabs —
                 # AllocSlab.patch_row copies before mutating).
                 "fast_all", "group_l", "slots_c", "col_meta",
                 # dev_const: lazily filled device copies of the
                 # dispatch-constant arrays (asks/distinct/counts or
                 # group_idx/valid), shared through the prep cache so
                 # re-dispatching the same job version uploads them
                 # once, not per eval.
                 "dev_const",
                 # feas_key: the statics.device_cache key of this eval's
                 # feasibility entry, which also keys its mesh-resident
                 # twin (FleetStatics.device_feasible_sharded).
                 "feas_key")

    def __init__(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self, k, v)


class _FinishState:
    """Per-eval state carried across the split finish phases
    (_finish_prepare -> native bulk -> _finish_python_tail) so the
    batch runner can run a whole window's native phase in one C
    call."""

    __slots__ = ("place", "args", "chosen_l", "scores_l", "uuids",
                 "alloc_proto", "metric_proto", "failed_tg", "start_p",
                 # Columnar contract: the AllocSlab the native phase
                 # fills (None = the object-emitting native path).
                 "slab")


class FastPlacementMixin:
    """Host-side placement machinery shared by the device-backed generic
    scheduler and the vectorized system scheduler: fleet-wide proposed
    allocs, exact + O(1) network assignment, and post-divergence fit
    re-checks.  Host classes provide self.state/self.plan/self.ctx and
    per-eval `_statics`/`_net_cache`/`_node_net`/`_port_lcg`."""

    def _proposed_allocs_all(self) -> list:
        """All non-terminal allocs under the in-flight plan: existing minus
        planned evictions plus planned placements (EvalContext.ProposedAllocs
        semantics, reference scheduler/context.go:96-126, fleet-wide)."""
        evicted = set()
        for updates in self.plan.node_update.values():
            evicted.update(a.id for a in updates)
        allocs = [a for a in self.state.allocs()
                  if not a.terminal_status() and a.id not in evicted]
        for placements in self.plan.node_allocation.values():
            allocs.extend(placements)
        return allocs

    def _net_base_for(self, node_index: int, node):
        """Node-static network base (frozen used-ports, reserved bw, bw
        capacity, ip, device) or None for topologies needing the exact
        path.  Cached on the fleet statics (models/fleet.net_base_for);
        also the callback the native bulk finish uses on a base-cache
        miss."""
        return net_base_for(self._statics, node_index, node)

    def _node_net_init(self, node_index: int, node):
        """Fast per-node network state: [used_ports, bw_used, bw_avail,
        ip, device], or None when the topology needs the exact path
        (multi-network nodes).  The reserved-only base is node-static and
        cached on the fleet statics; per-eval state adds proposed allocs'
        offers on top."""
        base = self._net_base_for(node_index, node)
        if base is None:
            return None
        used = set(base[0])
        bw_used = base[1]
        # O(1) emptiness probes (live, not precomputed: the plan grows
        # during the finish loop): only nodes with store allocs or plan
        # deltas need the exact proposed-alloc walk.
        node_id = node.id
        plan = self.plan
        if self.state.has_allocs_on_node(node_id) or \
                node_id in plan.node_update or \
                node_id in plan.node_allocation:
            for alloc in self.ctx.proposed_allocs(node_id):
                for tr in alloc.task_resources.values():
                    for offer in tr.networks:
                        used.update(offer.reserved_ports)
                        bw_used += offer.mbits
        return [used, bw_used, base[2], base[3], base[4]]

    def _assign_networks_fast(self, node_index: int, node, plan_tasks):
        """O(1) port/bandwidth assignment for single-network dynamic-port
        asks.  Returns task name -> Resources, or None to trigger the
        sequential fallback (exact semantics preserved: bandwidth bound +
        port uniqueness per node IP, reference nomad/structs/network.go)."""
        st = self._node_net.get(node_index)
        if st is None:
            st = self._node_net_init(node_index, node)
            if st is None:
                # Complex topology: exact path.
                return self._assign_networks(
                    node, None, plan_tasks=plan_tasks)
            self._node_net[node_index] = st
        used, bw_used, bw_avail, ip, device = st

        out = {}
        span = MAX_DYNAMIC_PORT - MIN_DYNAMIC_PORT
        staged_bw = 0
        mirrored = []   # offers mirrored into the cached exact-path index
        net_cache = self._net_cache
        for name, res, ask in plan_tasks:
            if ask is None:
                r = Resources.__new__(Resources)
                r.__dict__ = dict(
                    _RES_STATIC, networks=[],
                    cpu=res.cpu, memory_mb=res.memory_mb,
                    disk_mb=res.disk_mb, iops=res.iops) \
                    if res is not None else dict(_RES_STATIC, networks=[])
                out[name] = r
                continue
            if bw_used + staged_bw + ask.mbits > bw_avail:
                # Roll back staged ports — and the offers already mirrored
                # into the cached exact-path NetworkIndex, which would
                # otherwise carry phantom reservations into later
                # exact-path assignments on this node.
                for tr in out.values():
                    for offer in tr.networks:
                        used.difference_update(offer.reserved_ports)
                for offer in mirrored:
                    net_cache[node.id].remove_reserved(offer)
                return None
            ports = []
            lcg = self._port_lcg
            for _label in ask.dynamic_ports:
                # LCG instead of random.randrange: one multiply per port
                # (the plan seed is random, spreading ports like the
                # reference's random picks; exact value is untested API).
                lcg = (lcg * 1103515245 + 12345) & 0x3FFFFFFF
                port = MIN_DYNAMIC_PORT + lcg % span
                while port in used:
                    port = MIN_DYNAMIC_PORT + (port - MIN_DYNAMIC_PORT
                                               + 1) % span
                used.add(port)
                ports.append(port)
            self._port_lcg = lcg
            offer = NetworkResource.__new__(NetworkResource)
            offer.__dict__ = dict(
                _NET_STATIC, device=device, ip=ip, mbits=ask.mbits,
                reserved_ports=ports,
                dynamic_ports=list(ask.dynamic_ports))
            staged_bw += ask.mbits
            r = Resources.__new__(Resources)
            r.__dict__ = dict(
                _RES_STATIC, cpu=res.cpu, memory_mb=res.memory_mb,
                disk_mb=res.disk_mb, iops=res.iops, networks=[offer])
            out[name] = r
            # Keep an exact-path NetworkIndex for this node (if one was
            # built for a non-fast slot) coherent with our offers.
            if net_cache:
                idx = net_cache.get(node.id)
                if idx is not None:
                    idx.add_reserved(offer)
                    mirrored.append(offer)
        st[1] = bw_used + staged_bw
        return out

    def _node_index_of(self, node) -> int:
        statics = getattr(self, "_statics", None)
        if statics is not None:
            return statics.index_of.get(node.id, -1)
        return -1

    def _still_fits(self, node, size) -> bool:
        """Exact host-side allocs_fit re-check, used after the plan has
        deviated from the device scan's usage accounting."""
        proposed = self.ctx.proposed_allocs(node.id)
        fit, _dim, _util = allocs_fit(
            node, proposed + [Allocation(resources=size)])
        return fit

    def _assign_networks(self, node, tg, plan_tasks=None):
        """Exact host-side port/bandwidth assignment on the device winner
        (BinPackIterator parity, reference scheduler/rank.go:180-205).
        Returns task name -> Resources, or None if the node can't take it."""
        cache = getattr(self, "_net_cache", None)
        net_idx = cache.get(node.id) if cache is not None else None
        if net_idx is None:
            net_idx = NetworkIndex()
            net_idx.set_node(node)
            net_idx.add_allocs(self.ctx.proposed_allocs(node.id))
            if cache is not None:
                cache[node.id] = net_idx
        if plan_tasks is not None:
            items = [(name, res) for name, res, _ask in plan_tasks]
        else:
            items = [(t.name, t.resources) for t in tg.tasks]
        staged = []
        out = {}
        for task_name, res in items:
            task_resources = res.copy() if res is not None else Resources()
            if task_resources.networks:
                ask = task_resources.networks[0]
                offer, _err = net_idx.assign_network(ask)
                if offer is None:
                    # Roll back offers staged for earlier tasks of this
                    # group so the cached index stays consistent.
                    for o in staged:
                        net_idx.remove_reserved(o)
                    return None
                net_idx.add_reserved(offer)
                staged.append(offer)
                task_resources.networks = [offer]
            out[task_name] = task_resources
        # Keep the fast per-node state (if built) coherent with these
        # exact-path offers.
        node_net = getattr(self, "_node_net", None)
        if node_net:
            st = node_net.get(self._node_index_of(node))
            if st is not None:
                for o in staged:
                    st[0].update(o.reserved_ports)
                    st[1] += o.mbits
        return out


class TorchBinPackScheduler(GenericScheduler, FastPlacementMixin):
    """GenericScheduler with the placement hot loop moved to the card.

    ``device`` is where the placement kernels run: ``None`` means the
    process default (``cuda``; ``RuntimeError`` when no CUDA device is
    present), ``"cpu"`` runs the kernels' plain versions.

    ``defer_device=True`` pauses after argument preparation so a batch
    driver (scheduler/batch.py) can fuse many evals into one device
    dispatch; ``finish_deferred`` resumes with the device results.
    """

    defer_device = False

    def __init__(self, state, planner, batch: bool, device=None) -> None:
        super().__init__(state, planner, batch)
        self.device = resolve_device(device)
        self.deferred: tuple | None = None  # (place, DeviceArgs)

    def _compute_placements(self, place: list) -> None:
        args = self._prepare_device(place)
        if self.defer_device:
            self.deferred = (place, args)
            return
        handles = self.dispatch_device(args)
        # faultlint-ok(uninjectable-io): synchronous compute lane (no
        # pipeline, no breaker); the injectable device seam is the
        # pipelined runner's dispatch/collect pair.
        chosen, scores = self.collect_device(args, handles)
        self.finish_deferred(place, args, chosen, scores)

    def _dev_const(self, args: "DeviceArgs", key: str,
                   host_arrays: tuple) -> list:
        """Device-resident copies of dispatch-constant host arrays,
        cached on the DeviceArgs' shared dev_const holder (one upload
        per job version per device; ensure_on_default re-validates the
        device)."""
        holder = args.dev_const.setdefault(key, [None] * len(host_arrays))
        for i, h in enumerate(host_arrays):
            holder[i] = ensure_on_default(holder[i], h, self.device)
        return holder

    # Executor policy: the walk's cost (steps x real node rows) up to
    # which the numpy twins (ops/binpack_host.py) beat a dispatch to the
    # card.  A pipelined caller pays only the front stage's dispatch
    # (uploads + launch + the start of the result copies); a single-shot
    # caller also waits for the kernel and the copies, and a fused storm
    # is one single shot of lanes x steps x real nodes (batch.py
    # ``fused_cost``).  Both constants are what the executor phase of
    # chip_smoke.py derives on an NVIDIA H100 80GB HBM3 at 700 W
    # (PERF.md, the executor crossover): the host's median beats the
    # front stage's up to a config-5b eval (cost 160; config 2's 1,000
    # is a near-tie the card won in most runs), and every single shot's
    # up to a one-lane config-5b storm (1,280, 2x faster on the host);
    # it loses by 2x and more from config 4 (10,000) and a 16-lane storm
    # (20,480) on.  The JAX package's values, set for a remote TPU's
    # ~100 ms round trip, are 1 << 18 and 1 << 25.
    HOST_ALWAYS_COST = 160
    HOST_SINGLE_SHOT_COST = 1_280

    # Which executor the last dispatch used: True host, False device,
    # None when no dispatch ran yet.  The pipelined runner reads it to
    # count host and device dispatches.
    dispatched_host: "bool | None" = None
    # Whether the last device dispatch ran node-axis-sharded over a
    # mesh (parallel/mesh.dispatch_mesh resolved one): the pipelined
    # runner's sharded_dispatches counts it.
    dispatched_sharded: "bool | None" = None

    def choose_host_executor(self, args: "DeviceArgs",
                             pipelined: bool) -> bool:
        """True when this dispatch should run on the host twins: forced
        by the policy, or under ``auto`` when the walk's cost is at most
        HOST_ALWAYS_COST, or at most HOST_SINGLE_SHOT_COST for a caller
        that is not pipelined."""
        return self.host_for_cost(executor_cost(args), pipelined)

    @classmethod
    def host_for_cost(cls, cost: int, pipelined: bool) -> bool:
        """The executor policy for a walk of ``cost`` (steps x real node
        rows): the forced side, else the cost rule of
        choose_host_executor."""
        from .executor import (EXECUTOR_DEVICE, EXECUTOR_HOST,
                               executor_policy)

        policy = executor_policy()
        if policy == EXECUTOR_HOST:
            return True
        if policy == EXECUTOR_DEVICE:
            return False
        if cost <= cls.HOST_ALWAYS_COST:
            return True
        return not pipelined and cost <= cls.HOST_SINGLE_SHOT_COST

    def dispatch_host(self, args: "DeviceArgs") -> tuple:
        """Run the placement walk eagerly with numpy
        (ops/binpack_host.py): same results, no launch and no transfer.
        Returns ready numpy (chosen, scores) for collect_device."""
        from nomad_tpu_torch.ops.binpack_host import (place_rounds_host,
                                                      place_sequence_host)

        self.dispatched_sharded = False
        statics = args.statics
        if args.rounds_eligible:
            chosen, scores, _ = place_rounds_host(
                statics.capacity, statics.reserved, args.view.usage,
                args.view.job_counts, args.feasible_h, args.asks,
                args.distinct, args.counts, args.penalty,
                k_cap=args.k_cap, rounds=args.rounds,
                n_real=statics.n_real)
        else:
            chosen, scores, _ = place_sequence_host(
                statics.capacity, statics.reserved, args.view.usage,
                args.view.job_counts, args.feasible_h, args.asks,
                args.distinct, args.group_idx, args.valid, args.penalty,
                n_real=statics.n_real)
        return chosen, scores

    def dispatch_device(self, args: "DeviceArgs", pipelined: bool = False,
                        force: bool = False) -> tuple:
        """Start the device dispatch for prepared args WITHOUT blocking:
        the kernel launch and its device->host result copies are left in
        flight (copy_to_host_async), so a caller can prepare the next
        eval while this one runs; collect_device waits for them.  A walk
        the executor policy keeps on the host comes back as ready numpy
        arrays (dispatch_host).

        ``force=True`` skips the policy: the caller already decided (the
        pipelined runner's breaker admission must not be re-decided here,
        or a policy flip mid-stream could run an in-flight probe on the
        host and orphan it)."""
        if not force and self.choose_host_executor(args, pipelined):
            self.dispatched_host = True
            return self.dispatch_host(args)
        self.dispatched_host = False
        from nomad_tpu_torch.parallel.mesh import dispatch_mesh

        mesh = dispatch_mesh(1, args.statics.n_pad, device=self.device)
        if mesh is not None:
            return self._dispatch_device_sharded(args, mesh)
        self.dispatched_sharded = False
        device = self.device
        capacity_d, reserved_d = \
            args.statics.device_capacity_reserved(device)
        feas_cached = args.feasible_d  # [host, device-or-None], lazy
        feas_cached[1] = ensure_on_default(feas_cached[1], feas_cached[0],
                                           device)
        feasible_d = feas_cached[1]
        # Per-eval varying operands are placed EXPLICITLY (counted by
        # the transfer odometer); the mirror's resident usage copy passes
        # through put_counted untouched.
        usage_d = put_counted(args.view.dispatch_usage(), device)
        jc_d = put_counted(args.view.job_counts, device)
        if args.rounds_eligible:
            asks_d, distinct_d, counts_d = self._dev_const(
                args, "rounds", (args.asks, args.distinct, args.counts))
            chosen_s, scores_s, _ = binpack.place_rounds(
                capacity_d, reserved_d, usage_d, jc_d, feasible_d,
                asks_d, distinct_d, counts_d, args.penalty,
                k_cap=args.k_cap, rounds=args.rounds)
        else:
            asks_d, distinct_d, group_idx_d, valid_d = self._dev_const(
                args, "seq", (args.asks, args.distinct, args.group_idx,
                              args.valid))
            chosen_s, scores_s, _ = binpack.place_sequence(
                capacity_d, reserved_d, usage_d, jc_d, feasible_d,
                asks_d, distinct_d, group_idx_d, valid_d, args.penalty)
        return copy_to_host_async(chosen_s), copy_to_host_async(scores_s)

    def _dev_const_repl(self, args: "DeviceArgs", key: tuple, mesh,
                        host_arrays: tuple) -> list:
        """Mesh-replicated twins of the dispatch-constant arrays for the
        sharded path, cached on the same prep-shared dev_const holder as
        the single-device copies (one upload per job version per
        mesh)."""
        from nomad_tpu_torch.parallel.mesh import REPL, _put

        holder = args.dev_const.setdefault(key, [None] * len(host_arrays))
        for i, h in enumerate(host_arrays):
            holder[i] = _put(h if holder[i] is None else holder[i], mesh,
                             REPL)
        return holder

    def _dispatch_device_sharded(self, args: "DeviceArgs", mesh) -> tuple:
        """Single-eval device dispatch with the node axis sharded over
        ``mesh``: capacity/reserved, this eval's feasibility rows and
        the usage mirror's copy are mesh-RESIDENT (uploaded once per
        fleet generation / job version / sync under the residency
        policy), and every step's cross-shard selection runs in K7
        (parallel/mesh.py).  Placements equal the unsharded kernels'.
        A failure raises: nothing runs the unsharded kernels or the host
        in its place."""
        from nomad_tpu_torch.parallel.mesh import (place_rounds_sharded,
                                                   place_sequence_sharded)

        self.dispatched_sharded = True
        statics = args.statics
        capacity_d, reserved_d = \
            statics.device_capacity_reserved_sharded(mesh)
        feasible_d = statics.device_feasible_sharded(
            mesh, args.feas_key, args.feasible_h)
        view = args.view
        usage = None
        if view.usage_device is not None and statics.mirror is not None:
            # The mirror's sharded twin IS this view's usage (the view
            # carried no plan deltas); None = the mirror moved past the
            # view, so the view's own host array uploads instead.
            usage = statics.mirror.device_usage_sharded(mesh, view.usage)
        if usage is None:
            usage = view.usage
        (pen_d,) = self._dev_const_repl(
            args, ("pen", mesh), mesh, (np.float32(args.penalty),))
        if args.rounds_eligible:
            asks_d, distinct_d, counts_d = self._dev_const_repl(
                args, ("rounds", mesh), mesh,
                (args.asks, args.distinct, args.counts))
            chosen_s, scores_s, _u = place_rounds_sharded(
                mesh, capacity_d, reserved_d, usage, view.job_counts,
                feasible_d, asks_d, distinct_d, counts_d, pen_d,
                k_cap=args.k_cap, rounds=args.rounds)
        else:
            asks_d, distinct_d, group_idx_d, valid_d = \
                self._dev_const_repl(
                    args, ("seq", mesh), mesh,
                    (args.asks, args.distinct, args.group_idx,
                     args.valid))
            chosen_s, scores_s, _u = place_sequence_sharded(
                mesh, capacity_d, reserved_d, usage, view.job_counts,
                feasible_d, asks_d, distinct_d, group_idx_d, valid_d,
                pen_d)
        return copy_to_host_async(chosen_s), copy_to_host_async(scores_s)

    def collect_device(self, args: "DeviceArgs", handles: tuple
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Block on a dispatch's results and map them to per-placement
        (chosen, scores) arrays.  The d2h fetch goes through the one
        sanctioned seam (devices.fetch_host)."""
        chosen, scores = (fetch_host(h) for h in handles)
        if args.rounds_eligible:
            chosen, scores = rounds_to_placements(args, chosen, scores)
        return chosen, scores

    def _derive_sem(self, job_sem_key, tg, job_triples, job_dist,
                    dcs_sorted):
        """One TG's semantic tuple: (job_key, dedupe key, ask vector,
        distinct_hosts, total Resources, net plan).  The single-task
        unconstrained shape (count expansion's output, and the dominant
        shape at 1k-group scale) takes a fused fast path with no
        intermediate object churn; its key exactly matches what the
        general path (group_mask_key) would produce for the same
        content, so fast- and general-path groups dedupe together."""
        tasks = tg.tasks
        if len(tasks) == 1 and not tg.constraints \
                and not tasks[0].constraints:
            task = tasks[0]
            r = task.resources
            ask = None
            mbits = ports = 0
            fast_ok = True
            if r is not None and r.networks:
                nets = r.networks
                if len(nets) != 1 or nets[0].reserved_ports:
                    fast_ok = False
                ask = nets[0]
                for n in nets:
                    mbits += n.mbits
                    ports += len(n.reserved_ports) + len(n.dynamic_ports)
            if r is None:
                size = Resources()
                ask_vec = (0, 0, 0, 0, 0, 0)
            else:
                # Networks are shared, not copied: `size` is only ever
                # read (as_vector/allocs_fit accumulate into their own
                # temporaries), same aliasing as the one-size-per-slot
                # sharing finish_deferred already does.
                size = Resources(cpu=r.cpu, memory_mb=r.memory_mb,
                                 disk_mb=r.disk_mb, iops=r.iops,
                                 networks=list(r.networks))
                ask_vec = (r.cpu, r.memory_mb, r.disk_mb, r.iops,
                           mbits, ports)
            key = ((dcs_sorted, job_triples, (task.driver,)), ask_vec,
                   job_dist)
            return (job_sem_key, key, ask_vec, job_dist, size,
                    (fast_ok, [(task.name, r, ask)]))
        tg_constr = task_group_constraints(tg)
        ask_vec = tuple(tg_constr.size.as_vector())
        dist = job_dist or any(
            c.hard and c.operand == CONSTRAINT_DISTINCT_HOSTS
            for c in tg_constr.constraints)
        key = (group_mask_key(self.job.datacenters, self.job.constraints,
                              tg_constr.constraints, tg_constr.drivers),
               ask_vec, dist)
        return (job_sem_key, key, ask_vec, dist, tg_constr.size,
                _net_plan_for(tg))

    def _prepare_device(self, place: list) -> DeviceArgs:
        start = time.perf_counter()
        statics = fleet_cache.statics_for(self.state)
        # Incremental usage: atomically sync the fleet's mirror to this
        # eval's snapshot (O(changed allocs) via the store changelog) and
        # take a view with this plan's in-flight deltas applied.  Falls
        # back to the from-scratch O(allocs) build only when the snapshot
        # is older than the mirror (another worker synced past us).
        view = mirror_for(statics).view_at(self.state, self.plan,
                                           self.job.id, self.device)
        if view is None:
            view = build_usage(statics, self._proposed_allocs_all(),
                               job_id=self.job.id)

        # Prep template cache: everything below is a pure function of
        # (job version, place list, fleet statics, batch flag).  The
        # fresh-placement diff (util.diff_allocs cache_fresh) hands out
        # an identity-stable place list per job version, so re-evals of
        # the same job against the same fleet (eval storms, plan-retry
        # attempts, node-update re-evals) skip the 1k-group derivation
        # entirely.  Cached fields are shared READ-ONLY across evals.
        job = self.job
        tmpl = job.__dict__.get("_prep_cache")
        if tmpl is not None and tmpl[0] == job.modify_index \
                and tmpl[1] == statics.gen and tmpl[2] is place \
                and tmpl[3] == self.batch:
            # Feasibility is re-fetched from the CURRENT statics'
            # device_cache (kw carries only the key): caching the
            # [host, device] entry on the job would pin evicted fleet
            # generations' device buffers for the job's lifetime.
            feas = statics.device_cache.get(tmpl[4])
            if feas is not None:
                return _refresh_rounds(DeviceArgs(
                    statics=statics, view=view, start=start,
                    feasible_d=feas, feasible_h=feas[0], **tmpl[5]))

        # Dedupe task groups by *semantic* key (constraints + drivers + dc +
        # ask): count-expanded groups collapse to one mask row, keeping the
        # device feasibility matrix tiny and its upload cacheable.  The
        # derived key/ask/net-plan is cached ON the TaskGroup object —
        # store-resident objects are immutable by contract (state/store.py)
        # and every store write copies, so identity is a sound cache key;
        # re-deriving it per eval dominated prep at 1k groups/job.
        groups: list = []          # slot -> representative TaskGroup
        slot_keys: list = []       # slot -> semantic key
        sizes: list = []           # slot -> total Resources ask
        net_plans: list = []       # slot -> (fast_ok, plan_tasks)
        dedupe: dict = {}          # semantic key -> slot
        slot_of_tg: dict = {}      # id(tg) -> slot
        asks_rows: list = []
        distinct_rows: list = []
        job_sem_key = (id(job), job.modify_index)
        # Job-level pieces of the semantic key, derived once per eval (the
        # per-TG loop below is the host hot path at 1k groups/job).
        jc = job.constraints
        job_triples = tuple(sorted(
            (c.l_target, c.operand, c.r_target) for c in jc
            if c.hard and c.operand != CONSTRAINT_DISTINCT_HOSTS))
        job_dist = any(c.hard and c.operand == CONSTRAINT_DISTINCT_HOSTS
                       for c in jc)
        dcs_sorted = tuple(sorted(job.datacenters))
        for missing in place:
            tg = missing.task_group
            if id(tg) in slot_of_tg:
                continue
            sem = tg.__dict__.get("_sem_cache")
            if sem is None or sem[0] != job_sem_key:
                sem = self._derive_sem(job_sem_key, tg, job_triples,
                                       job_dist, dcs_sorted)
                tg.__dict__["_sem_cache"] = sem
            _jk, key, ask_vec, dist, size, net_plan = sem
            slot = dedupe.get(key)
            if slot is None:
                slot = len(groups)
                dedupe[key] = slot
                groups.append(tg)
                slot_keys.append(key)
                sizes.append(size)
                net_plans.append(net_plan)
                asks_rows.append(ask_vec)
                distinct_rows.append(dist)
            slot_of_tg[id(tg)] = slot

        g_pad = _pad_to(len(groups))
        p_pad = _pad_to(len(place))
        asks = np.zeros((g_pad, NDIMS), dtype=np.float32)
        asks[:len(groups)] = asks_rows
        distinct = np.zeros(g_pad, dtype=bool)
        distinct[:len(groups)] = distinct_rows

        # Feasibility matrix: composed per-slot host masks; the dispatch
        # keeps a device-resident copy per (fleet generation, slot-key
        # tuple).
        feas_key = ("feas", tuple(slot_keys), g_pad)
        cached = statics.device_cache.get(feas_key)
        if cached is None:
            feasible_h = np.zeros((g_pad, statics.n_pad), dtype=bool)
            for g, tg in enumerate(groups):
                tg_constr = task_group_constraints(tg)
                mask, _dist = compile_group_mask(
                    statics, self.job.datacenters, self.job.constraints,
                    tg_constr.constraints, tg_constr.drivers)
                feasible_h[g] = mask
            # Device copy is lazy (filled on first device dispatch).
            cached = [feasible_h, None]
            statics.device_cache[feas_key] = cached
        feasible_h = cached[0]

        group_idx = np.zeros(p_pad, dtype=np.int32)
        valid = np.zeros(p_pad, dtype=bool)
        slot_placements: dict = {}
        for p, missing in enumerate(place):
            slot = slot_of_tg[id(missing.task_group)]
            group_idx[p] = slot
            valid[p] = True
            slot_placements.setdefault(slot, []).append(p)

        penalty = BATCH_JOB_ANTI_AFFINITY_PENALTY if self.batch else \
            SERVICE_JOB_ANTI_AFFINITY_PENALTY

        # Rounds-mode plan: place a whole top-k batch of copies per device
        # step instead of one-per-step (ops/binpack.py place_rounds).
        # Greedy-equivalent when the anti-affinity penalty exceeds the
        # worst-case packing-score gain of one extra copy.
        counts = np.zeros(g_pad, dtype=np.int32)
        for slot, ps in slot_placements.items():
            counts[slot] = len(ps)
        avail = statics.capacity[:statics.n_real] - \
            statics.reserved[:statics.n_real]
        min_cpu = float(avail[:, 0].min()) if statics.n_real else 1.0
        min_mem = float(avail[:, 1].min()) if statics.n_real else 1.0
        eligible = statics.n_real > 0
        rounds = 1
        # top_k's k may not exceed the node axis: clamp and let extra
        # rounds make up the difference (a round places <= k_cap copies).
        k_cap = min(
            _pad_to(max((len(ps) for ps in slot_placements.values()),
                        default=1)),
            statics.n_pad)
        for slot, ps in slot_placements.items():
            frac_c = asks[slot, 0] / max(min_cpu, 1.0)
            frac_m = asks[slot, 1] / max(min_mem, 1.0)
            gain_bound = 10.0 * (1.0 - 10.0 ** (-frac_c)) + \
                10.0 * (1.0 - 10.0 ** (-frac_m))
            if gain_bound >= penalty * 0.95:
                eligible = False
                break
            # Rounds themselves are estimated fit-aware per dispatch by
            # _refresh_rounds — the one producer of that policy.

        kw = dict(
            asks=asks, distinct=distinct,
            group_idx=group_idx, valid=valid, sizes=sizes,
            slot_of_tg=slot_of_tg, penalty=penalty, g_pad=g_pad,
            p_pad=p_pad, net_plans=net_plans, counts=counts,
            n_groups=len(groups), n_place=len(place),
            slot_placements=slot_placements, k_cap=k_cap, rounds=rounds,
            rounds_eligible=eligible,
            fast_all=all(np_[0] for np_ in net_plans),
            group_l=group_idx[:len(place)].tolist(), slots_c=[None],
            col_meta=[None], dev_const={}, feas_key=feas_key)
        # Keyed on the fleet GENERATION, not the statics object: a strong
        # statics ref here would pin evicted generations (device
        # feasibility buffers included) for as long as the job lives.
        # Same reason the feasibility entry is cached by KEY.
        job.__dict__["_prep_cache"] = (job.modify_index, statics.gen, place,
                                       self.batch, feas_key, kw)
        return _refresh_rounds(DeviceArgs(
            statics=statics, view=view, start=start,
            feasible_d=cached, feasible_h=feasible_h, **kw))

    def finish_deferred(self, place: list, args: DeviceArgs,
                        chosen: np.ndarray, scores: np.ndarray,
                        uuids: "list | None" = None) -> None:
        """Consume device decisions into the plan (exact host re-checks +
        network assignment + Allocation construction).

        Split into three phases so the batch runner can run a whole
        window's native phase in ONE C call (native.bulk_finish_many)
        and pass a shared uuid slab: prepare (host state init), native
        happy-path prefix, Python tail.  This entry point runs them
        back-to-back, each a phase span (obs/trace.py) when tracing is
        on."""
        t_phase = trace_mod.now()
        fs = self._finish_prepare(place, args, chosen, scores, uuids)
        nargs = self._finish_native_args(fs)
        t_phase = trace_mod.phase("finish.prepare", t_phase)
        if nargs is not None:
            native = _native_bulk()
            if fs.slab is not None:
                self._finish_consume_native(
                    fs, native.bulk_finish_cols(*nargs))
            else:
                self._finish_consume_native(
                    fs, native.bulk_finish(*nargs))
        t_phase = trace_mod.phase("finish.native", t_phase)
        self._finish_python_tail(fs)
        trace_mod.phase("finish.tail", t_phase)

    def _finish_prepare(self, place: list, args: DeviceArgs,
                        chosen, scores,
                        uuids: "list | None" = None) -> "_FinishState":
        """Host-side finish state for one eval: per-plan network caches,
        alloc/metric protos, list-form device choices, uuids (minted
        here unless the caller passed them)."""
        statics = args.statics
        device_time = time.perf_counter() - args.start
        per_time = device_time / max(1, len(place))
        # Per-node NetworkIndex cache for this plan (exact path) and the
        # fast per-node [used_ports, bw_used, bw_avail, ip, device] state.
        self._net_cache: dict = {}
        self._node_net: dict = {}
        self._statics = statics
        self._port_lcg = _randrange(1 << 30)

        fs = _FinishState()
        fs.place = place
        fs.args = args
        fs.chosen_l = chosen if type(chosen) is list else chosen.tolist()
        fs.scores_l = scores if type(scores) is list else scores.tolist()
        fs.uuids = uuids if uuids is not None else \
            generate_uuids(len(place))
        # Template-based construction (see _proto_of): the finish loop
        # builds one AllocMetric + Allocation per placement.
        fs.metric_proto = dict(_METRIC_STATIC,
                               nodes_evaluated=statics.n_real,
                               allocation_time=per_time)
        fs.alloc_proto = dict(_ALLOC_STATIC, eval_id=self.eval.id,
                              job_id=self.job.id, job=self.job)
        fs.failed_tg = {}
        fs.start_p = 0
        fs.slab = None
        return fs

    def _finish_native_args(self, fs: "_FinishState") -> "tuple | None":
        """Native argument tuple for this eval's happy-path prefix —
        columnar (bulk_finish_cols + an AllocSlab, ``fs.slab`` set) by
        default, the object-emitting bulk_finish tuple when the
        columnar contract is disabled — or None when the native path
        can't take it (the ``_native_bulk`` seam returned None, or a
        slot needs the exact NetworkIndex)."""
        args = fs.args
        native = _native_bulk()
        if native is None or not args.fast_all:
            return None
        slots_c = args.slots_c[0]
        if slots_c is None:
            # Built once per (job version, fleet) and shared through
            # the prep cache — the slot table only depends on the
            # deduped net plans and sizes.
            slots_c = build_slots_c(
                (args.sizes[g], args.net_plans[g][1])
                for g in range(args.n_groups))
            args.slots_c[0] = slots_c
        if not columnar_enabled():
            return build_bulk_args(
                self, fs.place, args.group_l, fs.chosen_l, fs.scores_l,
                fs.uuids, slots_c, fs.alloc_proto, fs.metric_proto,
                1,  # coalesce_all: generic TG placements interchangeable
                self._port_lcg)
        meta = args.col_meta[0]
        if meta is None:
            # Per-job-version constants of the columnar contract:
            # per-row names, per-slot network totals, and the prefix
            # offsets into the flat port column.  The place list is
            # identity-stable per job version (util.diff_allocs
            # cache_fresh), so these ride the prep cache like slots_c.
            place = fs.place
            names = [m.name for m in place]
            tg_names = [m.task_group.name for m in place]
            slot_mbits = []
            slot_ndyn = []
            slot_has = []
            for _size, tasks in slots_c:
                mb = nd = 0
                any_net = False
                for _t, _rp, net_c in tasks:
                    if net_c is not None:
                        any_net = True
                        mb += net_c[0]
                        nd += len(net_c[2])
                slot_mbits.append(mb)
                slot_ndyn.append(nd)
                slot_has.append(any_net)
            port_off = np.zeros(len(place) + 1, dtype=np.int64)
            if place:
                np.cumsum(np.asarray(slot_ndyn, dtype=np.int64)[
                    np.asarray(args.group_l, dtype=np.int64)],
                    out=port_off[1:])
            meta = (names, tg_names, slot_mbits, slot_ndyn, slot_has,
                    port_off)
            args.col_meta[0] = meta
        names, tg_names, slot_mbits, slot_ndyn, slot_has, port_off = meta
        slab = AllocSlab(
            eval_id=self.eval.id, job=self.job, slots=slots_c,
            metric_proto=fs.metric_proto, groups=args.group_l,
            ids=fs.uuids, names=names, tgs=tg_names,
            scores=fs.scores_l, port_off=port_off,
            n_rows=len(fs.place),
            slot_mbits=slot_mbits, slot_has_net=slot_has)
        fs.slab = slab
        lazy_proto = {
            "eval_id": self.eval.id, "job_id": self.job.id,
            "job": self.job,
            "desired_status": ALLOC_DESIRED_STATUS_RUN,
            "client_status": ALLOC_CLIENT_STATUS_PENDING,
            "_slab": slab,
        }
        return (fs.chosen_l, args.group_l, fs.uuids, names, tg_names,
                slot_mbits, slot_ndyn, slab.ports, slab.node_ids,
                slab.ips, slab.devs, lazy_proto, SlabAlloc,
                self._statics.nodes, self._node_net,
                self._statics.net_base, self._net_base_for,
                self.state.allocs_node_index(), self.ctx,
                self.plan.node_update, self.plan.node_allocation,
                self._port_lcg, MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT)

    def _finish_consume_native(self, fs: "_FinishState",
                               result: tuple) -> None:
        """Fold one native finish result back into the finish state.
        Columnar path: (n_done, lcg) — the slab seals its happy prefix.
        Object path: (n_done, lcg, failed map); fmap stays empty under
        generic semantics — the C loop bails on a task group's first
        chosen-less placement so the Python tail can rescue or explain
        it."""
        if fs.slab is not None:
            fs.start_p, self._port_lcg = result
            fs.slab.seal(fs.start_p)
            return
        fs.start_p, self._port_lcg, fmap = result
        fs.failed_tg.update(fmap)

    def _finish_python_tail(self, fs: "_FinishState") -> None:
        """Per-placement Python finish loop from fs.start_p: exact host
        re-checks, network assignment, Allocation construction.  The
        native prefix (parity-tested in tests/test_torch_native_finish.py)
        handled [0, start_p); this loop owns complex topologies,
        divergence recovery and failure explanation."""
        place = fs.place
        args = fs.args
        statics = args.statics
        sizes = args.sizes
        slot_of_tg = args.slot_of_tg
        net_plans = args.net_plans
        chosen_l = fs.chosen_l
        scores_l = fs.scores_l
        uuids = fs.uuids
        nodes_arr = statics.nodes
        plan = self.plan
        metric_proto = fs.metric_proto
        alloc_proto = fs.alloc_proto
        failed_tg = fs.failed_tg

        def fast_metric(score_key=None, score=0.0) -> AllocMetric:
            # Lazy form: factory dicts + the scores dict materialize on
            # first read (AllocMetric.__getattr__).
            m = AllocMetric.__new__(AllocMetric)
            d = dict(metric_proto)
            if score_key is not None:
                d["_lazy_score_key"] = score_key
                d["_lazy_score_val"] = score
            m.__dict__ = d
            return m

        # slot -> explained failure metrics: identical groups share one
        # fleet-walk verdict (usage is monotone within a finish pass).
        failed_slots: dict = {}
        fallback_nodes = None
        # Once any placement deviates from the device's choice, the device
        # scan's usage accounting has diverged from the plan's, so every
        # later device winner must be re-verified host-side with the exact
        # allocs_fit before being trusted.
        usage_diverged = False
        # One-shot vectorized recovery: on the first divergence the whole
        # remaining tail is re-planned by the exact host kernel instead
        # of falling into a per-placement sequential walk.
        redispatched = False

        p = fs.start_p
        while p < len(place):
            missing = place[p]
            tg = missing.task_group
            prior_fail = failed_tg.get(id(tg))
            if prior_fail is not None:
                prior_fail.metrics.coalesced_failures += 1
                p += 1
                continue

            g = slot_of_tg[id(tg)]
            size = sizes[g]
            node_index = chosen_l[p]
            option_node = nodes_arr[node_index] if node_index >= 0 else None
            from_device = option_node is not None

            task_resources = None
            if option_node is not None and usage_diverged and \
                    not self._still_fits(option_node, size):
                option_node = None
            if option_node is not None:
                fast_ok, plan_tasks = net_plans[g]
                if fast_ok:
                    task_resources = self._assign_networks_fast(
                        node_index, option_node, plan_tasks)
                else:
                    task_resources = self._assign_networks(option_node, tg)
                if task_resources is None:
                    option_node = None
            if option_node is None and not redispatched and \
                    (usage_diverged or from_device):
                # The device's remaining choices are stale (the plan
                # deviated from the kernel's assumed trajectory):
                # re-plan place[p:] in ONE place_sequence pass
                # against usage rebuilt from state + the in-flight
                # plan, then re-enter this iteration with the fresh
                # choice.  Turns the post-divergence tail from
                # per-placement sequential walks (~ms each under
                # contention) into a single vector pass.  A plain
                # chosen=-1 with NO divergence skips this — the rerun
                # would reproduce the same inputs and the same -1.
                redispatched = True
                fresh_c, fresh_s = self._redispatch_remaining(
                    place, args, p)
                chosen_l[p:] = fresh_c
                scores_l[p:] = fresh_s
                usage_diverged = False  # choices now exact vs the plan
                continue  # re-handle p with the fresh choice
            if option_node is None:
                # Sequential fallback, two jobs in one: when the device
                # picked a node the exact host accounting rejects
                # (over-approximation divergence) it re-selects; when
                # the device found NO candidate it produces the
                # reference's failure explanation — the stack chain
                # fills ctx metrics with per-constraint/class/dimension
                # filter and exhaustion counts (monitor.go
                # dumpAllocStatus is downstream of this data).
                if from_device:
                    # Device usage accounting included a placement the
                    # plan won't make: re-verify later winners exactly.
                    usage_diverged = True
                prior_verdict = failed_slots.get(g)
                if prior_verdict is not None:
                    # A semantically identical group already walked the
                    # fleet and failed; usage only grows within one
                    # finish pass, so the verdict (and its explanation)
                    # still holds — copy it instead of re-walking
                    # O(fleet x allocs) per identical group.  The
                    # source object lives on ANOTHER group's failed
                    # alloc and accumulates that group's coalesce
                    # count: zero it on the copy.
                    metrics = prior_verdict.copy()
                    metrics.coalesced_failures = 0
                else:
                    if fallback_nodes is None:
                        fallback_nodes = ready_nodes_in_dcs(
                            self.state, self.job.datacenters)
                    self.stack.set_nodes(list(fallback_nodes))
                    ranked, size = self.stack.select(tg)
                    if ranked is not None:
                        if not from_device:
                            # Host placed what the device didn't:
                            # diverged in the other direction.
                            usage_diverged = True
                        option_node = ranked.node
                        task_resources = ranked.task_resources
                        # The fallback assigned ports outside our
                        # per-node state: rebuild both on next use.
                        self._net_cache.pop(option_node.id, None)
                        self._node_net.pop(
                            statics.index_of.get(option_node.id), None)
                    # select populated fresh ctx metrics (incl. scores).
                    metrics = self.ctx.metrics()
                    if ranked is None:
                        failed_slots[g] = metrics
            else:
                metrics = fast_metric(option_node.id + ".binpack",
                                      scores_l[p])

            alloc = Allocation.__new__(Allocation)
            d = dict(alloc_proto)
            d["id"] = uuids[p]
            d["name"] = missing.name
            d["task_group"] = tg.name
            d["resources"] = size
            d["metrics"] = metrics
            d["task_states"] = {}
            if option_node is not None:
                d["node_id"] = option_node.id
                d["task_resources"] = task_resources
                d["desired_status"] = ALLOC_DESIRED_STATUS_RUN
                d["client_status"] = ALLOC_CLIENT_STATUS_PENDING
                alloc.__dict__ = d
                plan.append_alloc(alloc)
            else:
                d["task_resources"] = {}
                d["desired_status"] = ALLOC_DESIRED_STATUS_FAILED
                d["desired_description"] = \
                    "failed to find a node for placement"
                d["client_status"] = ALLOC_CLIENT_STATUS_FAILED
                alloc.__dict__ = d
                plan.append_failed(alloc)
                failed_tg[id(tg)] = alloc
            p += 1

    def _redispatch_remaining(self, place: list, args: DeviceArgs,
                              p: int) -> tuple[list, list]:
        """Re-plan place[p:] against usage rebuilt from state + the
        in-flight plan (the same math as the first dispatch, so results
        splice straight into the finish loop): a single shot of the
        sequence walk, on the side the executor policy picks for it, the
        exact host walk (ops/binpack_host.py) or K2 on the scheduler's
        device."""
        statics = args.statics
        view = build_usage(statics, self._proposed_allocs_all(),
                           job_id=self.job.id)
        rem = len(place) - p
        group_idx = np.asarray(args.group_idx[p:p + rem], dtype=np.int32)
        valid = np.ones(rem, dtype=bool)
        if self.host_for_cost(rem * statics.n_real, pipelined=False):
            from nomad_tpu_torch.ops.binpack_host import place_sequence_host

            chosen, scores, _u = place_sequence_host(
                statics.capacity, statics.reserved, view.usage,
                view.job_counts, args.feasible_h, args.asks, args.distinct,
                group_idx, valid, np.float32(args.penalty),
                n_real=statics.n_real)
            # devlint-ok(transfer-in-hot-loop): the host twin's numpy
            # results; the device branch below fetches with fetch_host.
            return np.asarray(chosen).tolist(), np.asarray(scores).tolist()
        device = self.device
        capacity_d, reserved_d = statics.device_capacity_reserved(device)
        args.feasible_d[1] = ensure_on_default(
            args.feasible_d[1], args.feasible_d[0], device)
        # devlint-ok(mesh-bypass): the re-plan of a walk's tail after a
        # conflict, one short walk on the scheduler's own device against
        # the fleet copies resident there (the JAX package re-plans on
        # the host); the eval's first walk took the mesh route.
        chosen, scores, _u = binpack.place_sequence(
            capacity_d, reserved_d, put_counted(view.usage, device),
            put_counted(view.job_counts, device), args.feasible_d[1],
            put_counted(args.asks, device),
            put_counted(args.distinct, device),
            put_counted(group_idx, device), put_counted(valid, device),
            args.penalty)
        return fetch_host(chosen).tolist(), fetch_host(scores).tolist()


def executor_cost(args: DeviceArgs) -> int:
    """The executor policy's size of one eval's walk: its steps (rounds
    x groups in rounds mode, placements otherwise) x real node rows."""
    steps = args.rounds * args.n_groups if args.rounds_eligible \
        else args.n_place
    return steps * args.statics.n_real


def fetch_results(*tensors) -> list:
    """Fetch device outputs with overlapped copies: start every
    device->host copy, then wait once per copy through the one
    sanctioned seam (devices.fetch_host).  Host values pass through."""
    pending = [copy_to_host_async(t) if isinstance(t, torch.Tensor) else t
               for t in tensors]
    return [fetch_host(p) for p in pending]


def rounds_to_placements(args: DeviceArgs, chosen_slots: np.ndarray,
                         score_slots: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Map place_rounds output ([G, rounds*k_cap] per-slot streams) back to
    per-placement arrays in the original placement order (vectorized:
    one fancy-index assignment per slot, no per-placement Python)."""
    chosen = np.full(args.p_pad, -1, dtype=np.int32)
    scores = np.zeros(args.p_pad, dtype=np.float32)
    for slot, ps in args.slot_placements.items():
        stream = chosen_slots[slot]
        taken = stream >= 0
        nodes = stream[taken]
        node_scores = score_slots[slot][taken]
        n = min(len(ps), len(nodes))
        idx = np.asarray(ps[:n], dtype=np.int64)
        chosen[idx] = nodes[:n]
        scores[idx] = node_scores[:n]
    return chosen, scores


def new_torch_binpack_scheduler(state, planner) -> TorchBinPackScheduler:
    """``torch-binpack``: service semantics, on the planner's device
    (``planner.device`` when it has one, else the default)."""
    return TorchBinPackScheduler(state, planner, batch=False,
                                 device=getattr(planner, "device", None))


def new_torch_binpack_batch_scheduler(state, planner
                                      ) -> TorchBinPackScheduler:
    """``torch-binpack-batch``: batch semantics, on the planner's
    device."""
    return TorchBinPackScheduler(state, planner, batch=True,
                                 device=getattr(planner, "device", None))
