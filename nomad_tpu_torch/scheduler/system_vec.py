"""Vectorized system scheduler: node-pinned placement without the
per-node iterator walk.

The port's copy of nomad_tpu/scheduler/system_vec.py, registered as
``system``.  Capability parity with reference scheduler/system_sched.go
via the same reconcile logic as the sequential SystemScheduler
(diff_system_allocs etc. — inherited unchanged), but
``_compute_placements`` is re-expressed over the whole fleet in three
stages:

  1. per-unique-TG feasibility masks compiled once over the whole fleet
     (nomad_tpu_torch/models/constraints.py — the same compiler the
     torch-binpack path uses, cached per fleet generation);
  2. fit + ScoreFit for ALL of a TG's node-pinned placements in one
     numpy pass (system placements name their node, so there is no
     argmax — every decision is O(D) vector math, batched);
  3. the per-placement finish (ports, Allocation/AllocMetric
     construction, plan append) through the native bulk finish
     (csrc/port_alloc.cpp ``bulk_finish``, object contract), resumed
     by a per-placement Python loop from wherever C left off.

No stage runs a kernel: the fit is numpy on the host.  The scheduler
still takes its planner's device like the other schedulers (``cuda``
by default, ``RuntimeError`` without one; ``cpu`` when the caller
passes it), for the usage mirror's view.

Batching stage 2 by task group is fit-order-equivalent to the
sequential (node-major) walk: a node's row accumulates each placed TG's
ask before the next TG's fit check reads it, exactly as the
interleaved order would.  The one divergence: usage for a fit-passing
placement is accumulated before its port/bandwidth assignment, so a
network-assign failure (exhausted bandwidth, rare) leaves that ask
counted — strictly conservative (later fits can only get harder; no
oversubscription).  Plans are otherwise exactly as valid as the
sequential scheduler's (parity-tested in tests/test_system_vec.py).
"""
from __future__ import annotations

import time

from random import randrange as _randrange

import numpy as np

from nomad_tpu_torch.models.constraints import compile_group_mask
from nomad_tpu_torch.models.fleet import build_usage, fleet_cache, \
    mirror_for
from nomad_tpu_torch.parallel.devices import resolve_device
from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_FAILED,
    ALLOC_DESIRED_STATUS_RUN,
    AllocMetric,
    Allocation,
    generate_uuids,
)
from nomad_tpu_torch.structs.funcs import score_fit_vec

from . import torch_binpack
from .torch_binpack import (
    _ALLOC_STATIC,
    _METRIC_STATIC,
    FastPlacementMixin,
    _net_plan_for,
    build_slots_c,
    run_bulk_finish,
)
from .system import SystemScheduler
from .util import task_group_constraints


class VectorSystemScheduler(SystemScheduler, FastPlacementMixin):
    def __init__(self, state, planner, device=None) -> None:
        super().__init__(state, planner)
        self.device = resolve_device(device)

    def _compute_job_allocs(self) -> None:
        """Fresh-registration fast path: with no existing allocs the
        system diff is pure node-pinned placement, deterministic per
        (job version, fleet generation) — exactly the shape node-join
        storms re-evaluate over and over.  Memoized as a read-only
        tuple on the job (same pattern as util.diff_allocs
        cache_fresh); anything with existing allocs takes the
        inherited general path."""
        from nomad_tpu_torch.structs import filter_terminal_allocs

        job = self.job
        if job is None:
            return super()._compute_job_allocs()
        allocs = filter_terminal_allocs(
            self.state.allocs_by_job(self.eval.job_id))
        if allocs:
            return super()._compute_job_allocs(allocs)
        # Fresh path truncates nothing; clear any limit left by a prior
        # retry attempt (retry_max reuses this scheduler instance).
        self.limit_reached = False
        statics = fleet_cache.statics_for(self.state)
        cached = job.__dict__.get("_sys_fresh")
        if cached is not None and cached[0] == job.modify_index \
                and cached[1] == statics.gen:
            place = cached[2]
        else:
            from .util import diff_system_allocs

            diff = diff_system_allocs(job, self.nodes, {}, [])
            place = tuple(diff.place)
            job.__dict__["_sys_fresh"] = (job.modify_index, statics.gen,
                                          place)
        if place:
            self._compute_placements(place)

    def _prep_slots(self, place, statics):
        """Stage 1: per-unique-TG masks/asks + per-placement slot and
        node-index arrays.  Pure in (job version, place identity, fleet
        generation) — memoized on the job for re-evals."""
        job = self.job
        tmpl = job.__dict__.get("_sys_prep")
        if tmpl is not None and tmpl[0] == job.modify_index \
                and tmpl[1] == statics.gen and tmpl[2] is place:
            return tmpl[3]

        slots: list = []    # slot -> (tg, mask, dist, ask_vec, size, plan)
        slot_of: dict = {}  # id(tg) -> slot
        group_l: list = []  # placement -> slot
        ni_l: list = []     # placement -> node index
        index_of = statics.index_of
        for missing in place:
            tg = missing.task_group
            s = slot_of.get(id(tg))
            if s is None:
                tg_constr = task_group_constraints(tg)
                mask, dist = compile_group_mask(
                    statics, job.datacenters, job.constraints,
                    tg_constr.constraints, tg_constr.drivers)
                ask_vec = np.asarray(tg_constr.size.as_vector(),
                                     dtype=np.float32)
                slot_of[id(tg)] = s = len(slots)
                slots.append((tg, mask, dist, ask_vec, tg_constr.size,
                              _net_plan_for(tg)))
            group_l.append(s)
            ni = index_of.get(missing.alloc.node_id, -1)
            if ni < 0:
                raise KeyError(
                    f"could not find node {missing.alloc.node_id!r}")
            ni_l.append(ni)
        prep = (slots, group_l, np.asarray(group_l, dtype=np.int64),
                np.asarray(ni_l, dtype=np.int64), [None])
        job.__dict__["_sys_prep"] = (job.modify_index, statics.gen, place,
                                     prep)
        return prep

    def _compute_placements(self, place: list) -> None:
        start = time.perf_counter()
        statics = fleet_cache.statics_for(self.state)
        view = mirror_for(statics).view_at(self.state, self.plan,
                                           self.job.id, self.device)
        if view is None:
            view = build_usage(statics, self._proposed_allocs_all(),
                               job_id=self.job.id)

        slots, group_l, group_arr, ni_arr, slots_c_holder = \
            self._prep_slots(place, statics)

        capacity = statics.capacity
        reserved = statics.reserved
        usage = view.usage.copy()       # accumulates as we place
        jc = view.job_counts.copy()
        nodes_arr = statics.nodes
        n_real = statics.n_real

        # --- stage 2: vector fit + ScoreFit per slot --------------------
        chosen = np.full(len(place), -1, dtype=np.int64)
        scores = np.zeros(len(place), dtype=np.float64)
        for s, (tg, mask, dist, ask_vec, size, net_plan) in \
                enumerate(slots):
            sel = np.nonzero(group_arr == s)[0] if len(slots) > 1 \
                else np.arange(len(place))
            nis = ni_arr[sel]
            if len(np.unique(nis)) != len(nis):
                # count > 1 system TG: a node appears several times in
                # one slot.  The batched fit would check every copy
                # against pre-accumulation usage (and the fancy-index
                # add collapses duplicate rows), so fall back to the
                # exact per-placement walk for this slot.
                self._fit_slot_sequential(sel, nis, mask, dist, ask_vec,
                                          usage, jc, capacity, reserved,
                                          n_real, chosen, scores)
                continue
            ok = mask[nis] & (nis < n_real)
            if dist:
                ok &= jc[nis] == 0
            util = reserved[nis] + usage[nis] + ask_vec
            ok &= (util <= capacity[nis]).all(axis=1)
            # ScoreFit (BestFit v3) from the one shared producer
            # (structs/funcs.score_fit_vec — device kernel parity).
            sc_all = score_fit_vec(
                util[:, 0], util[:, 1],
                capacity[nis, 0] - reserved[nis, 0],
                capacity[nis, 1] - reserved[nis, 1])
            sc = np.where(ok, sc_all, 0.0)
            okn = nis[ok]
            usage[okn] += ask_vec
            jc[okn] += 1
            chosen[sel[ok]] = okn
            scores[sel] = sc

        self._finish_vec(place, start, statics, slots, group_l,
                         slots_c_holder, chosen, scores)

    @staticmethod
    def _fit_slot_sequential(sel, nis, mask, dist, ask_vec, usage, jc,
                             capacity, reserved, n_real, chosen, scores):
        """Exact per-placement fit/score for a slot whose placements
        repeat nodes (system count > 1): each copy sees the usage the
        previous copy committed, exactly like the sequential walk."""
        for k in range(len(sel)):
            ni = int(nis[k])
            ok = bool(mask[ni]) and ni < n_real and \
                not (dist and jc[ni] > 0)
            if not ok:
                continue
            util = reserved[ni] + usage[ni] + ask_vec
            if not bool((util <= capacity[ni]).all()):
                continue
            sc = float(score_fit_vec(
                util[0], util[1],
                capacity[ni, 0] - reserved[ni, 0],
                capacity[ni, 1] - reserved[ni, 1]))
            usage[ni] += ask_vec
            jc[ni] += 1
            chosen[sel[k]] = ni
            scores[sel[k]] = sc

    def _finish_vec(self, place, start, statics, slots, group_l,
                    slots_c_holder, chosen, scores) -> None:
        # --- stage 3: finish (native prefix + Python resume) ------------
        nodes_arr = statics.nodes
        self._net_cache = {}
        self._node_net = {}
        self._statics = statics
        self._port_lcg = _randrange(1 << 30)

        plan = self.plan
        job = self.job
        uuids = generate_uuids(len(place))
        per_time = (time.perf_counter() - start) / max(1, len(place))
        metric_proto = dict(_METRIC_STATIC, nodes_evaluated=1,
                            allocation_time=per_time)
        alloc_proto = dict(_ALLOC_STATIC, eval_id=self.eval.id,
                           job_id=job.id, job=job)
        failed_tg: dict = {}
        # TG ids whose recorded failure came from the device mask
        # (chosen < 0) — the only failures _explain_failures may
        # re-narrate; network-assign failures keep their own story.
        mask_rejected: set = set()
        chosen_l = chosen.tolist()
        scores_l = scores.tolist()

        start_p = 0
        native = torch_binpack._native_bulk()
        if native is not None and all(s[5][0] for s in slots):
            slots_c = slots_c_holder[0]
            if slots_c is None:
                slots_c = build_slots_c(
                    (size, plan_tasks)
                    for _tg, _mask, _dist, _ask, size, (_f, plan_tasks)
                    in slots)
                slots_c_holder[0] = slots_c
            start_p, fmap = run_bulk_finish(
                native, self, place, group_l, chosen_l, scores_l,
                uuids, slots_c, alloc_proto, metric_proto,
                coalesce_all=0)  # node-pinned: coalesce chosen-less only
            failed_tg.update(fmap)
            # Native fmap entries are created only for chosen-less
            # placements (coalesce_all=0 semantics).
            mask_rejected.update(fmap.keys())
            for failed in fmap.values():
                failed.metrics.nodes_filtered = 1

        for p in range(start_p, len(place)):
            missing = place[p]
            tg = missing.task_group
            prior_fail = failed_tg.get(id(tg))
            if prior_fail is not None and chosen_l[p] < 0:
                prior_fail.metrics.coalesced_failures += 1
                continue

            s = group_l[p]
            _tg, mask, dist, ask_vec, size, net_plan = slots[s]
            ni = chosen_l[p]
            ok = ni >= 0
            task_resources = None
            if ok:
                node = nodes_arr[ni]
                fast_ok, plan_tasks = net_plan
                if fast_ok:
                    task_resources = self._assign_networks_fast(
                        ni, node, plan_tasks)
                else:
                    task_resources = self._assign_networks(node, tg)
                ok = task_resources is not None

            if not ok:
                prior_fail = failed_tg.get(id(tg))
                if prior_fail is not None:
                    prior_fail.metrics.coalesced_failures += 1
                    continue

            m = AllocMetric.__new__(AllocMetric)
            md = dict(metric_proto)  # factory dicts materialize lazily
            alloc = Allocation.__new__(Allocation)
            d = dict(alloc_proto)
            d["id"] = uuids[p]
            d["name"] = missing.name
            d["task_group"] = tg.name
            d["resources"] = size
            d["metrics"] = m
            d["task_states"] = {}
            if ok:
                md["_lazy_score_key"] = node.id + ".binpack"
                md["_lazy_score_val"] = float(scores_l[p])
                d["node_id"] = node.id
                d["task_resources"] = task_resources
                d["desired_status"] = ALLOC_DESIRED_STATUS_RUN
                d["client_status"] = ALLOC_CLIENT_STATUS_PENDING
                m.__dict__ = md
                alloc.__dict__ = d
                plan.append_alloc(alloc)
            else:
                md["nodes_filtered"] = 1
                d["task_resources"] = {}
                d["desired_status"] = ALLOC_DESIRED_STATUS_FAILED
                d["desired_description"] = \
                    "failed to find a node for placement"
                d["client_status"] = ALLOC_CLIENT_STATUS_FAILED
                m.__dict__ = md
                alloc.__dict__ = d
                plan.append_failed(alloc)
                failed_tg[id(tg)] = alloc
                if ni < 0:
                    mask_rejected.add(id(tg))

        self._explain_failures(mask_rejected, failed_tg, place, chosen_l,
                               nodes_arr, statics)

    def _explain_failures(self, mask_rejected, failed_tg, place, chosen_l,
                          nodes_arr, statics) -> None:
        """Upgrade each task group's first mask-rejected placement to
        the sequential chain's explanation.  System placements are
        node-pinned, so the failure story is that node's
        constraint/fit verdict — run the stack against just that node
        and take its ctx metrics (what the reference system scheduler
        records per failed alloc; later failures stay coalesced onto
        this one).  Only allocs whose ORIGINAL failure was the device
        mask qualify (``mask_rejected``) — a network-assign failure on
        a chosen node keeps its own story."""
        if not failed_tg:
            return
        index_of = statics.index_of
        pending = {k: v for k, v in failed_tg.items()
                   if k in mask_rejected}
        for p, missing in enumerate(place):
            if not pending:
                break
            if chosen_l[p] >= 0:
                continue
            failed = pending.pop(id(missing.task_group), None)
            if failed is None:
                continue
            ni = index_of.get(missing.alloc.node_id, -1)
            if ni < 0:
                continue
            self.stack.set_nodes([nodes_arr[ni]])
            option, _size = self.stack.select(missing.task_group)
            if option is not None:
                # Exact chain would place here (mask over-approximation
                # disagreement): keep the shallow metric rather than
                # invent a story.
                continue
            explained = self.ctx.metrics()
            if not (explained.constraint_filtered or
                    explained.class_filtered):
                # Only constraint/class verdicts are usage-independent;
                # an exhaustion story computed against the FINISHED
                # plan could blame usage that accumulated after this
                # placement's decision point — keep the shallow metric.
                continue
            explained.coalesced_failures = \
                failed.metrics.coalesced_failures
            explained.allocation_time = failed.metrics.allocation_time
            failed.metrics = explained


def new_vector_system_scheduler(state, planner) -> VectorSystemScheduler:
    """``system``: the vectorized scheduler, on the planner's device
    (``planner.device`` when it has one, else the default)."""
    return VectorSystemScheduler(state, planner,
                                 device=getattr(planner, "device", None))
