"""Batched optimistic scheduling: many evaluations, one kernel launch.

Counterpart of ``nomad_tpu/scheduler/batch.py`` on the card.  This is
the replacement for the reference's worker-pool concurrency (reference
nomad/worker.go:50-437 — NumCPU goroutines each processing one eval at
a time against its own snapshot).  Here a batch of evaluations is
reconciled on the host, their placement problems are stacked along a
lane axis, and ONE launch of the batch kernel (K4, ops/binpack.py
``place_rounds_batch`` / ``place_sequence_batch``) plans all of them
against the same state snapshot.  Exactly like the reference's
optimistic concurrency, plans may conflict; the plan applier
serializes commits, and rejected plans are retried (reference
nomad/plan_apply.go).

Fast-path contract: an eval joins the fused launch only if its plan has
no deltas yet (no migrations/in-place updates), so every lane shares the
same base usage tensor — lanes diverge only through their own
placements.  Evals with plan deltas fall back to their own dispatch
(still on the device).

The runner's device is ``cuda`` by default (``RuntimeError`` without
one), ``cpu`` only when the caller passes it, and then the kernels'
plain versions run.  The executor policy (scheduler/executor.py) keeps
a storm whose fused cost (lanes x steps x real nodes) is at most
``TorchBinPackScheduler.HOST_SINGLE_SHOT_COST`` on the numpy twins, one
lane at a time (``_dispatch_fused_host``), or forces either side.  A
window's lanes finish through ONE native call (``bulk_finish_many`` of
the port's C extension, csrc/port_alloc.cpp), then each lane's Python
tail.  Where a mesh resolves (parallel/mesh.dispatch_mesh: two or more
devices, or a ``mesh_override`` device list) the fused launch runs
node-axis-sharded (K7), on the 2-D ``(lanes, fleet)`` storm layout when
the lanes split, against the resident sharded capacity, reserved and
usage.

The stragglers a runner with ``state_refresh`` still holds after its
fused rounds are planned as ONE chained window: each lane's own walk
(K3, or K2 for a lane that is not rounds-eligible) in lane order on the
usage the lane before it left, from one upload of the stacked lanes and
one fetch, so every lane sees the claims of the lanes before it, as if
the evals had run one after another, each on the state the one before
it committed.  The window finishes and submits like a fused round, each
lane's host finish seeing the placements of the lanes before it; a plan
it still rejects (a dynamic port an earlier lane took on the same node,
a concurrent commit) takes the per-eval retry.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from nomad_tpu_torch.obs import trace as trace_mod
from nomad_tpu_torch.parallel.devices import put_counted, resolve_device
from nomad_tpu_torch.structs import (
    EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED,
    Evaluation,
    generate_uuids,
)

from .generic import VALID_GENERIC_TRIGGERS
from .interfaces import SetStatusError
from . import torch_binpack
from .torch_binpack import (
    TorchBinPackScheduler,
    fetch_results,
    rounds_to_placements,
)
from .util import set_status


# Tracer-epoch now, 0.0 when tracing is off; a phase span [t0, now] of
# the calling thread under its open ``worker.batch``; and where its next
# phase starts, so the top-level phases tile the batch (obs/trace.py).
# Phases nested in another start at now.
_tnow = trace_mod.now
_phase = trace_mod.phase
_phase_start = trace_mod.phase_start


def _lane_spans(name: str, scheds, t0: float, t1: float, **tags) -> None:
    """One span per lane sharing the window's [t0, t1] — fused stages
    (dispatch, finish, submit) run once for the whole window, and every
    member eval's tree records the window it rode (the shared
    timestamps make the fusion visible in the exported trace)."""
    tracer = trace_mod.tracer() if trace_mod.ENABLED else None
    if tracer is None:
        # Includes a concurrent disable() racing the ENABLED check:
        # degrade to untraced, never fail the lane.
        return
    for sched in scheds:
        ev = sched.eval
        if ev is not None and ev.trace:
            tracer.record(name, t0, t1 - t0, parent_ctx=ev.trace,
                          eval_id=ev.id, **tags)


def fused_cost(pending: list) -> int:
    """The executor policy's size of a fused storm: lanes x steps (the
    most rounds x the most groups when every lane is rounds-eligible,
    else the longest placement list) x real node rows, as the JAX
    package's batch runner counts it."""
    statics = pending[0][2].statics
    if all(a.rounds_eligible for _, _, a in pending):
        steps = max(a.rounds for _, _, a in pending) * \
            max(a.g_pad for _, _, a in pending)
    else:
        steps = max(a.p_pad for _, _, a in pending)
    return len(pending) * steps * statics.n_real


def _stack_lanes(pending: list, n_lanes: int) -> tuple:
    """The lanes' host inputs stacked along a lane axis of ``n_lanes``,
    each padded to the widest lane: (feasible, asks, distinct,
    group_idx, valid, job_counts, counts).  Rows past the lanes are
    all-invalid (nothing feasible, no valid step, counts 0)."""
    statics = pending[0][2].statics
    g_max = max(a.g_pad for _, _, a in pending)
    p_max = max(a.p_pad for _, _, a in pending)
    feasible = np.zeros((n_lanes, g_max, statics.n_pad), dtype=bool)
    asks = np.zeros((n_lanes, g_max, pending[0][2].asks.shape[1]),
                    dtype=np.float32)
    distinct = np.zeros((n_lanes, g_max), dtype=bool)
    group_idx = np.zeros((n_lanes, p_max), dtype=np.int32)
    valid = np.zeros((n_lanes, p_max), dtype=bool)
    job_counts = np.zeros((n_lanes, statics.n_pad), dtype=np.int32)
    counts = np.zeros((n_lanes, g_max), dtype=np.int32)
    for b, (_s, _p, a) in enumerate(pending):
        feasible[b, :a.g_pad] = a.feasible_h
        asks[b, :a.g_pad] = a.asks
        distinct[b, :a.g_pad] = a.distinct
        group_idx[b, :a.p_pad] = a.group_idx
        valid[b, :a.p_pad] = a.valid
        job_counts[b] = a.view.job_counts
        counts[b, :a.g_pad] = a.counts
    return feasible, asks, distinct, group_idx, valid, job_counts, counts


def pad_lanes(n: int) -> int:
    """Next power of two >= n (>= 1): the lane-axis bucket of the fused
    launch, bucketed like the group and placement axes
    (models/fleet._pad_to) so the lane count of a drifting storm takes
    few distinct shapes.  Pad lanes are all-invalid and place
    nothing."""
    return 1 << max(0, (n - 1).bit_length())


class BatchEvalRunner:
    """Fuses a batch of evaluations into one kernel launch.

    Per-job serialization: the eval broker guarantees at most one
    in-flight eval per job, so batches it hands out never collide.  When
    called directly with several evals for the SAME job, only the first
    joins each round; the rest run in follow-up rounds against a
    refreshed snapshot (``state_refresh``) so they see the earlier
    round's commits — without a refresh hook the leftovers would
    double-place, so they are then failed rather than silently
    over-scheduled.

    ``device`` is where every scheduler of the runner computes: ``None``
    means ``cuda`` (``RuntimeError`` when no CUDA device is present).
    """

    # Fused retry rounds before the chained tail: 1 = collect-then-serial
    # (each straggler sees every earlier straggler's claims).
    FUSED_RETRY_ROUNDS = 2

    def __init__(self, state, planner,
                 state_refresh: Optional[Callable] = None,
                 device=None) -> None:
        self.state = state
        self.planner = planner
        self.state_refresh = state_refresh
        self.device = resolve_device(device)
        # Evals that left the fused launches for the per-eval sequential
        # retry (a scheduler of their own: K3, not K4a).
        self.solo_evals = 0
        # Lanes planned in the chained tail (after the fused rounds).
        self.chained_evals = 0
        # Fused rounds run, and the round under way (the ``round`` tag
        # of the sched.* spans; the chained tail and the solo retries
        # come after round FUSED_RETRY_ROUNDS - 1).
        self.rounds_run = 0
        self._round = 0

    def _scheduler(self, state, ev: Evaluation) -> TorchBinPackScheduler:
        return TorchBinPackScheduler(state, self.planner,
                                     batch=(ev.type == "batch"),
                                     device=self.device)

    def _split_rounds(self, evals: list[Evaluation]
                      ) -> tuple[list, list]:
        """Serialize by job: one eval per job per round; the rest run in
        follow-up rounds against a refreshed snapshot."""
        seen_jobs: set = set()
        this_round, leftovers = [], []
        for ev in evals:
            if ev.job_id in seen_jobs:
                leftovers.append(ev)
            else:
                seen_jobs.add(ev.job_id)
                this_round.append(ev)
        return this_round, leftovers

    def _begin_eval(self, ev: Evaluation, finish_noop: bool = True):
        """Instantiate and reconcile one eval up to its deferred device
        args.  Returns the scheduler ready to dispatch, or None when the
        eval finished without needing a device dispatch (bad trigger,
        status error, or a plan with no placements, which is submitted
        here).

        ``finish_noop=False`` returns the scheduler of a placement-less
        plan instead of submitting it here (deferred is None): the
        pipelined runner routes those submits through its drain stage
        too, so plans commit in eval order."""
        tracer = trace_mod.tracer() if trace_mod.ENABLED else None
        if tracer is not None:
            if not ev.trace:
                # Harness/bench evals arrive without a server-stamped
                # anchor: root their tree here so scheduler stages
                # still form one tree per eval.
                ev.trace = tracer.anchor("eval.created",
                                         eval_id=ev.id,
                                         eval_type=ev.type)
            t0 = tracer.now()
            try:
                return self._begin_eval_inner(ev, finish_noop)
            finally:
                tracer.record("sched.begin", t0, tracer.now() - t0,
                              parent_ctx=ev.trace, eval_id=ev.id,
                              round=self._round)
        return self._begin_eval_inner(ev, finish_noop)

    def _begin_eval_inner(self, ev: Evaluation, finish_noop: bool = True):
        sched = self._scheduler(self.state, ev)
        sched.eval = ev
        if ev.triggered_by not in VALID_GENERIC_TRIGGERS:
            set_status(self.planner, ev, None, EVAL_STATUS_FAILED,
                       f"scheduler cannot handle '{ev.triggered_by}' "
                       "evaluation reason")
            return None
        sched.defer_device = True
        try:
            sched._begin()
        except SetStatusError as e:
            set_status(self.planner, ev, None, e.eval_status, str(e))
            return None
        sched.defer_device = False
        if sched.deferred is None:
            if not finish_noop:
                return sched
            # No placements needed: submit stops/updates directly.
            self._finish(sched)
            return None
        return sched

    def process(self, evals: list[Evaluation]) -> None:
        from nomad_tpu_torch.utils.gctune import gc_pause

        with gc_pause():
            self._process_rounds(evals)
            t_resume = _phase_start()
        # The collections the batch deferred run as the collector comes
        # back, on this thread: one ``sched.gc`` span.
        _phase("sched.gc", t_resume)

    def _process_rounds(self, evals: list[Evaluation]) -> None:
        """The fused rounds, then the chained tail."""
        pending = list(evals)
        # Fused retry rounds: lanes whose plans came back partial or
        # rejected re-plan TOGETHER against a refreshed snapshot —
        # under contention the applier's serialized conflicts, not
        # planning, dominate, and one fused round retries them all
        # for one launch.  Without a refresh hook the exact per-eval
        # sequential retry gives the same terminal guarantee as the
        # single-eval worker path.
        rounds = self.FUSED_RETRY_ROUNDS \
            if self.state_refresh is not None else 1
        for rnd in range(rounds):
            self._round = rnd
            self.rounds_run += 1
            retries = [] if self.state_refresh is not None else None
            self._process(pending, retries)
            if not retries:
                return
            pending = retries
            t_refresh = _phase_start()
            self.state = self.state_refresh()
            _phase("sched.refresh", t_refresh, round=rnd + 1)
        # The stragglers, on the snapshot just refreshed: one chained
        # window, then the per-eval retry for a plan it still rejects.
        self._round = rounds
        self._process(pending, chained=True)

    def _solo(self, state, ev: Evaluation, t_solo: float) -> None:
        """The exact per-eval sequential retry: a scheduler of its own,
        the whole process (one ``sched.solo`` span from ``t_solo``)."""
        self._scheduler(state, ev).process(ev)
        _phase("sched.solo", t_solo, round=self._round)

    def _process(self, evals: list[Evaluation],
                 retries: Optional[list] = None,
                 chained: bool = False) -> None:
        """One round: begin every lane, plan the lanes without plan
        deltas in one fused launch (``chained``: one chained window),
        finish and submit them as one window."""
        this_round, leftovers = self._split_rounds(evals)

        t_lanes = _phase_start()
        pending = []  # (scheduler, place, DeviceArgs)
        for ev in this_round:
            sched = self._begin_eval(ev)
            if sched is None:
                continue
            place, args = sched.deferred
            if sched.plan.node_update or sched.plan.node_allocation:
                # Plan already carries deltas (migrations, in-place
                # updates): base usage differs, run its own dispatch.
                self._run_single(sched, place, args, retries)
                continue
            pending.append((sched, place, args))
        if this_round:
            # The round's lanes begun one by one (each eval's own
            # sched.begin lies inside).
            _phase("sched.lanes", t_lanes, round=self._round)

        if pending and chained:
            done = self._dispatch_chained(pending)
            if done is None:
                self.solo_evals += len(pending)
                for sched, _p, _a in pending:
                    self._solo(self.state, sched.eval, _phase_start())
            else:
                self.chained_evals += len(done)
                self._finish_window(done, chained=True)
        elif pending:
            if self._fused_on_host(pending):
                self._finish_window(self._dispatch_fused_host(pending),
                                    retries)
            else:
                self._finish_window(self._dispatch_fused(pending), retries)
        if leftovers:
            self._process_leftovers(leftovers)

    @staticmethod
    def _fused_on_host(pending: list) -> bool:
        """The storm's executor policy (the JAX package's, with the same
        NOMAD_TPU_EXECUTOR lever): ``host`` forces the numpy twins,
        ``device`` the fused launch, and ``auto`` prices the storm as
        one single shot of its fused cost (lanes x steps x real nodes):
        TorchBinPackScheduler.host_for_cost."""
        return TorchBinPackScheduler.host_for_cost(fused_cost(pending),
                                                   pipelined=False)

    def _dispatch_fused_host(self, pending: list,
                             chained: bool = False) -> list:
        """Host-executor twin of the fused launch: every lane plans
        against the same snapshot base usage with the numpy twins, one
        lane at a time (each lane's walk is vectorized over nodes),
        reading the lanes' own arrays: no [B, G, N] stacking.  Lanes are
        harmonized to the widest top-k and the most rounds, as on the
        card.  ``chained``: the twin of the chained window instead, each
        lane at its own top-k and rounds (or the sequence walk) on the
        usage the lane before it left.  Returns ``[(sched, place, args,
        chosen, scores), ...]`` in lane order."""
        from nomad_tpu_torch.ops.binpack_host import (place_rounds_host,
                                                      place_sequence_host)

        statics = pending[0][2].statics
        usage = pending[0][2].view.usage  # host array
        n_real = statics.n_real
        rounds_ok = all(a.rounds_eligible for _, _, a in pending)
        k_cap = max(a.k_cap for _, _, a in pending)
        rounds = max(a.rounds for _, _, a in pending)
        tags = dict(chained=len(pending)) if chained else {}
        done = []
        t_launch = _phase_start()
        for sched, place, args in pending:
            t_disp = _tnow()
            if chained:
                rounds_ok, k_cap, rounds = \
                    args.rounds_eligible, args.k_cap, args.rounds
            if rounds_ok:
                chosen_s, score_s, lane_usage = place_rounds_host(
                    statics.capacity, statics.reserved, usage,
                    args.view.job_counts, args.feasible_h, args.asks,
                    args.distinct, args.counts, float(args.penalty),
                    k_cap=k_cap, rounds=rounds, n_real=n_real)
                chosen, scores = rounds_to_placements(
                    args, chosen_s, score_s)
            else:
                chosen, scores, lane_usage = place_sequence_host(
                    statics.capacity, statics.reserved, usage,
                    args.view.job_counts, args.feasible_h, args.asks,
                    args.distinct, args.group_idx, args.valid,
                    float(args.penalty), n_real=n_real)
            if chained:
                usage = lane_usage
            _lane_spans("sched.dispatch", [sched], t_disp, _tnow(),
                        host=True, round=self._round, **tags)
            done.append((sched, place, args, chosen, scores))
        _phase("dispatch.launch", t_launch)
        return done

    def _dispatch_chained(self, pending: list) -> Optional[list]:
        """The chained window: each lane planned exactly as a scheduler
        of its own would plan it on the state the lanes before it
        committed — its own walk (K3 at its own top-k and rounds, or K2
        for a lane that is not rounds-eligible) on the usage the walk
        before it returned, the first on the snapshot's.  The lanes'
        inputs are stacked and uploaded once, the walks launched in lane
        order with nothing fetched between them, and every result
        fetched in one copy.  A lane's rounds are its own estimate on
        the snapshot; copies its walk leaves unplaced take the finish's
        host fallback, which sees the earlier lanes' placements
        (``_finish_lanes``, ``chained``).  The executor policy prices
        the window as a fused storm (the numpy twins carry the usage
        alike).  Returns
        ``[(sched, place, args, chosen, scores), ...]`` in lane order,
        or None where a mesh resolves (the per-eval retry then takes
        the lanes)."""
        from nomad_tpu_torch.ops import binpack
        from nomad_tpu_torch.parallel.mesh import dispatch_mesh

        if self._fused_on_host(pending):
            return self._dispatch_fused_host(pending, chained=True)
        statics = pending[0][2].statics
        device = self.device
        if dispatch_mesh(1, statics.n_pad, device=device) is not None:
            return None
        t_disp, t_stack = _tnow(), _phase_start()
        B = len(pending)
        any_rounds = any(a.rounds_eligible for _, _, a in pending)
        any_seq = not all(a.rounds_eligible for _, _, a in pending)
        feasible, asks, distinct, group_idx, valid, job_counts, counts = \
            _stack_lanes(pending, B)
        t_phase = _phase("dispatch.stack", t_stack)
        capacity_d, reserved_d = statics.device_capacity_reserved(device)
        usage = put_counted(pending[0][2].view.dispatch_usage(), device)
        job_counts, feasible, asks, distinct = (
            put_counted(x, device)
            for x in (job_counts, feasible, asks, distinct))
        if any_rounds:
            counts = put_counted(counts, device)
        if any_seq:
            group_idx = put_counted(group_idx, device)
            valid = put_counted(valid, device)
        t_phase = _phase("dispatch.upload", t_phase)
        tracer = trace_mod.tracer() if trace_mod.ENABLED else None
        outs = []
        for b, (_s, _p, a) in enumerate(pending):
            g = a.g_pad
            with tracer.device_tags(chain=b) if tracer is not None \
                    else contextlib.nullcontext():
                if a.rounds_eligible:
                    chosen, scores, usage = binpack.place_rounds(
                        capacity_d, reserved_d, usage, job_counts[b],
                        feasible[b, :g], asks[b, :g], distinct[b, :g],
                        counts[b, :g], a.penalty, k_cap=a.k_cap,
                        rounds=a.rounds)
                else:
                    chosen, scores, usage = binpack.place_sequence(
                        capacity_d, reserved_d, usage, job_counts[b],
                        feasible[b, :g], asks[b, :g], distinct[b, :g],
                        group_idx[b, :a.p_pad], valid[b, :a.p_pad],
                        a.penalty)
            outs += (chosen, scores.view(torch.int32))
        t_phase = _phase("dispatch.launch", t_phase)
        (flat,) = fetch_results(torch.cat([t.reshape(-1) for t in outs]))
        t_phase = _phase("dispatch.fetch", t_phase)
        _lane_spans("sched.dispatch", [s for s, _p, _a in pending], t_disp,
                    _tnow(), chained=B, round=self._round)
        done, off = [], 0
        for b, (sched, place, args) in enumerate(pending):
            lane = []
            for t in outs[2 * b:2 * b + 2]:
                lane.append(flat[off:off + t.numel()].reshape(t.shape))
                off += t.numel()
            chosen, scores = lane[0], lane[1].view(np.float32)
            if args.rounds_eligible:
                chosen, scores = rounds_to_placements(args, chosen, scores)
            done.append((sched, place, args, chosen, scores))
        _phase("dispatch.unstack", t_phase)
        return done

    def _dispatch_fused(self, pending: list) -> list:
        """Stack the lanes, launch the batch kernel once, fetch its
        results and map them back per lane.  Returns
        ``[(sched, place, args, chosen, scores), ...]`` in lane order."""
        from nomad_tpu_torch.ops import binpack

        t_disp, t_stack = _tnow(), _phase_start()
        device = self.device
        statics = pending[0][2].statics
        B = len(pending)
        # Pad lanes are all-invalid (feasible/valid False, counts 0)
        # and place nothing; results are consumed per real lane only.
        B_pad = pad_lanes(B)
        rounds_ok = all(a.rounds_eligible for _, _, a in pending)
        # Lanes are harmonized to the widest top-k and the most rounds;
        # a lane's surplus slots come back -1 and rounds_to_placements
        # maps each lane's streams back through its own placements.
        k_cap = max(a.k_cap for _, _, a in pending)
        rounds = max(a.rounds for _, _, a in pending)
        feasible, asks, distinct, group_idx, valid, job_counts, counts = \
            _stack_lanes(pending, B_pad)
        penalty = np.zeros(B_pad, dtype=np.float32)
        penalty[:B] = [a.penalty for _, _, a in pending]

        # Mesh resolution rides the ONE authority (parallel/mesh.py):
        # several devices get the 2-D (lanes, fleet) storm layout when
        # the shape splits; NOMAD_TPU_MESH overrides.
        from nomad_tpu_torch.parallel.mesh import dispatch_mesh

        mesh = dispatch_mesh(B_pad, statics.n_pad, device=device)
        t_phase = _phase("dispatch.stack", t_stack)
        if mesh is not None:
            return self._dispatch_fused_sharded(
                pending, mesh, t_disp, t_phase, rounds_ok, k_cap, rounds,
                feasible, asks, distinct, group_idx, valid, job_counts,
                counts, penalty)
        # All fused lanes share the same snapshot base usage (fast-path
        # contract above): the mirror's resident device copy when it has
        # one, so the fleet tensors are not re-uploaded per launch.  The
        # per-launch lane stacks are fresh host arrays, placed
        # explicitly (counted).
        capacity_d, reserved_d = statics.device_capacity_reserved(device)
        base_usage = put_counted(pending[0][2].view.dispatch_usage(), device)
        job_counts, feasible, asks, distinct, penalty = (
            put_counted(x, device)
            for x in (job_counts, feasible, asks, distinct, penalty))
        if rounds_ok:
            counts = put_counted(counts, device)
            t_phase = _phase("dispatch.upload", t_phase)
            # Top-k rounds: device steps scale with unique groups x
            # rounds, not with placements.
            chosen_s, score_s, _u = binpack.place_rounds_batch(
                capacity_d, reserved_d, base_usage, job_counts, feasible,
                asks, distinct, counts, penalty, k_cap=k_cap, rounds=rounds)
            t_phase = _phase("dispatch.launch", t_phase)
            chosen_s, score_s = fetch_results(chosen_s, score_s)
            t_phase = _phase("dispatch.fetch", t_phase)
            _lane_spans("sched.dispatch", [s for s, _p, _a in pending],
                        t_disp, _tnow(), fused=B, round=self._round)
            done = []
            for b, (sched, place, args) in enumerate(pending):
                chosen, scores = rounds_to_placements(
                    args, chosen_s[b], score_s[b])
                done.append((sched, place, args, chosen, scores))
            _phase("dispatch.unstack", t_phase)
            return done
        group_idx = put_counted(group_idx, device)
        valid = put_counted(valid, device)
        t_phase = _phase("dispatch.upload", t_phase)
        chosen, scores, _u = binpack.place_sequence_batch(
            capacity_d, reserved_d, base_usage, job_counts, feasible, asks,
            distinct, group_idx, valid, penalty)
        t_phase = _phase("dispatch.launch", t_phase)
        chosen, scores = fetch_results(chosen, scores)
        _phase("dispatch.fetch", t_phase)
        _lane_spans("sched.dispatch", [s for s, _p, _a in pending],
                    t_disp, _tnow(), fused=B, round=self._round)
        return [(sched, place, args, chosen[b], scores[b])
                for b, (sched, place, args) in enumerate(pending)]

    def _dispatch_fused_sharded(self, pending, mesh, t_disp, t_phase,
                                rounds_ok, k_cap, rounds, feasible, asks,
                                distinct, group_idx, valid, job_counts,
                                counts, penalty) -> list:
        """The fused launch with the node axis (and on a storm mesh the
        lanes) sharded over ``mesh`` (K7), against the mesh-resident
        capacity/reserved and the mirror's sharded usage twin when the
        lanes' view rides it; the lane stacks are placed by the sharded
        wrappers (counted).  Results as :meth:`_dispatch_fused`."""
        from nomad_tpu_torch.parallel.mesh import (
            place_rounds_batch_sharded,
            place_sequence_batch_sharded,
        )

        statics = pending[0][2].statics
        view0 = pending[0][2].view
        capacity_d, reserved_d = \
            statics.device_capacity_reserved_sharded(mesh)
        base_usage = None
        if view0.usage_device is not None and statics.mirror is not None:
            base_usage = statics.mirror.device_usage_sharded(
                mesh, view0.usage)
        if base_usage is None:
            base_usage = view0.usage  # the mirror moved on: host upload
        # The lane stacks go up inside the sharded wrappers: the upload
        # phase holds the resident fleet's lookup, the launch the rest.
        t_phase = _phase("dispatch.upload", t_phase)
        if rounds_ok:
            chosen_s, score_s, _u = place_rounds_batch_sharded(
                mesh, capacity_d, reserved_d, base_usage, job_counts,
                feasible, asks, distinct, counts, penalty, k_cap=k_cap,
                rounds=rounds)
            t_phase = _phase("dispatch.launch", t_phase)
            chosen_s, score_s = fetch_results(chosen_s, score_s)
            t_phase = _phase("dispatch.fetch", t_phase)
            _lane_spans("sched.dispatch", [s for s, _p, _a in pending],
                        t_disp, _tnow(), fused=len(pending),
                        round=self._round)
            done = []
            for b, (sched, place, args) in enumerate(pending):
                chosen, scores = rounds_to_placements(
                    args, chosen_s[b], score_s[b])
                done.append((sched, place, args, chosen, scores))
            _phase("dispatch.unstack", t_phase)
            return done
        chosen, scores, _u = place_sequence_batch_sharded(
            mesh, capacity_d, reserved_d, base_usage, job_counts, feasible,
            asks, distinct, group_idx, valid, penalty)
        t_phase = _phase("dispatch.launch", t_phase)
        chosen, scores = fetch_results(chosen, scores)
        _phase("dispatch.fetch", t_phase)
        _lane_spans("sched.dispatch", [s for s, _p, _a in pending],
                    t_disp, _tnow(), fused=len(pending), round=self._round)
        return [(sched, place, args, chosen[b], scores[b])
                for b, (sched, place, args) in enumerate(pending)]

    def _process_leftovers(self, leftovers: list) -> None:
        if self.state_refresh is None:
            for ev in leftovers:
                set_status(self.planner, ev, None, EVAL_STATUS_FAILED,
                           "duplicate eval for job in one batch and no "
                           "state refresh available")
            return
        t_refresh = _phase_start()
        self.state = self.state_refresh()
        _phase("sched.refresh", t_refresh, round=self._round)
        self.process(leftovers)

    def _run_single(self, sched, place, args, retries=None) -> None:
        t0 = _tnow()
        handles = sched.dispatch_device(args)
        t_fetch = _phase("dispatch.launch", t0)
        # faultlint-ok(uninjectable-io): batch-lane device round-trip;
        # fault rehearsal (and the recovery path it needs) rides the
        # pipelined lane's device.dispatch/collect seam — a documented
        # gap, not an oversight.
        chosen, scores = sched.collect_device(args, handles)
        _phase("dispatch.fetch", t_fetch)
        t1 = _tnow()
        _lane_spans("sched.dispatch", [sched], t0, t1, round=self._round)
        sched.finish_deferred(place, args, chosen, scores)
        _lane_spans("sched.finish", [sched], t1, _tnow(),
                    round=self._round)
        self._finish(sched, retries)

    @staticmethod
    def _finish_lanes(lanes: list, round_: int = 0,
                      chained: bool = False) -> None:
        """Windowed finish for a list of lanes in lane order — ONE
        shared uuid slab (structs.generate_uuids) and ONE native call
        (csrc/port_alloc.cpp bulk_finish_many) cover every lane's
        happy-path prefix, then each lane's Python tail runs.
        ``lanes`` is [(sched, place, args, chosen, scores), ...];
        semantics per lane are identical to ``finish_deferred``.
        ``chained``: each lane's tail (its exact re-checks, network
        assignment and host fallback) also sees the placements of the
        lanes before it (``EvalContext.claims``), as its walk saw their
        usage.  ``round_`` tags the lanes' ``sched.finish`` spans."""
        t_fin, t_prep = _tnow(), _phase_start()
        uuid_slab = generate_uuids(
            sum(len(place) for _, place, *_ in lanes))
        states = []
        nargs = []
        off = 0
        for sched, place, args, chosen, scores in lanes:
            fs = sched._finish_prepare(place, args, chosen, scores,
                                       uuid_slab[off:off + len(place)])
            off += len(place)
            states.append(fs)
            nargs.append(sched._finish_native_args(fs))
        t_phase = _phase("finish.prepare", t_prep)
        native = torch_binpack._native_bulk()
        # Columnar lanes (fs.slab set) batch through ONE
        # bulk_finish_many call; object lanes (columnar contract
        # disabled) and mixed windows take per-lane calls.
        if native is not None and len(lanes) > 1 \
                and all(a is not None for a in nargs) \
                and all(fs.slab is not None for fs in states):
            outs = native.bulk_finish_many(nargs)
            for (sched, *_rest), fs, out in zip(lanes, states, outs):
                sched._finish_consume_native(fs, out)
        else:
            for (sched, *_rest), fs, a in zip(lanes, states, nargs):
                if a is not None:
                    if fs.slab is not None:
                        sched._finish_consume_native(
                            fs, native.bulk_finish_cols(*a))
                    else:
                        sched._finish_consume_native(
                            fs, native.bulk_finish(*a))
        t_phase = _phase("finish.native", t_phase)
        claims: dict = {}
        for (sched, *_rest), fs in zip(lanes, states):
            if chained:
                sched.ctx.claims = claims
            sched._finish_python_tail(fs)
            if chained:
                claims = dict(claims)
                for node_id, allocs in sched.plan.node_allocation.items():
                    claims[node_id] = claims.get(node_id, []) + allocs
        _phase("finish.tail", t_phase)
        _lane_spans("sched.finish", [s for s, *_r in lanes],
                    t_fin, _tnow(), window=len(lanes), round=round_)

    def _finish_window(self, done: list, retries=None,
                       chained: bool = False) -> None:
        """Windowed finish + group submit for fused lanes
        (``_finish_lanes``), then every lane's plan submits as one group
        through the planner's window path (``submit_plans``) so the
        commit point is paid once per window, not per lane."""
        if not done:
            return
        self._finish_lanes(done, round_=self._round, chained=chained)
        self._submit_window([sched for sched, *_rest in done], retries)

    def _submit_window(self, scheds: list, retries=None) -> None:
        """Submit a window of finished lanes' plans, preserving lane
        order and per-lane status semantics (see ``_finish``).  Uses the
        planner's group path when it has one; per-plan submits
        otherwise."""
        t_sub, t_first = _tnow(), _phase_start()
        submitters = []
        set_any = False
        for sched in scheds:
            ev = sched.eval
            try:
                done = sched._submit_begin()
            except SetStatusError as e:  # pragma: no cover - defensive
                set_status(self.planner, ev, sched.next_eval,
                           e.eval_status, str(e))
                set_any = True
                continue
            if done is not None:
                set_status(self.planner, ev, sched.next_eval,
                           EVAL_STATUS_COMPLETE)
                set_any = True
                continue
            submitters.append(sched)
        if set_any:
            _phase("submit.status", t_first)
        if not submitters:
            _lane_spans("sched.submit", scheds, t_sub, _tnow(),
                        window=len(scheds), round=self._round)
            return
        t_wait = _phase_start()
        group = getattr(self.planner, "submit_plans", None)
        if group is not None and len(submitters) > 1:
            outs = group([s.plan for s in submitters])
        else:
            outs = [self.planner.submit_plan(s.plan)
                    for s in submitters]
        t_status = _phase("submit.wait", t_wait)
        # Each lane's outcome first, then its status applies in lane
        # order (one submit.status span), then the sequential retries.
        statuses, solo = [], []
        for sched, (result, state) in zip(submitters, outs):
            ev = sched.eval
            try:
                ok = sched._submit_finish(result, state)
            except SetStatusError as e:  # pragma: no cover - defensive
                statuses.append((sched, e.eval_status, str(e)))
                continue
            if ok:
                statuses.append((sched, EVAL_STATUS_COMPLETE, ""))
            elif retries is not None:
                retries.append(ev)  # no status yet: a later round owns it
            else:
                solo.append(sched)
        for sched, status, description in statuses:
            set_status(self.planner, sched.eval, sched.next_eval, status,
                       description)
        if statuses:
            _phase("submit.status", t_status)
        for sched in solo:
            self.solo_evals += 1
            self._solo(sched.state, sched.eval, _phase_start())
        _lane_spans("sched.submit", scheds, t_sub, _tnow(),
                    window=len(scheds), round=self._round)

    def _finish(self, sched, retries=None) -> None:
        """Submit the plan; on rejection/partial commit either queue the
        eval for the next FUSED retry round (``retries`` list supplied)
        or fall back to the sequential retry loop (fresh scheduler,
        full process)."""
        ev = sched.eval
        t_wait = _tnow()
        try:
            ok = sched._submit()
        except SetStatusError as e:  # pragma: no cover - defensive
            set_status(self.planner, ev, sched.next_eval, e.eval_status,
                       str(e))
            return
        t_status = _phase("submit.wait", t_wait)
        if ok:
            set_status(self.planner, ev, sched.next_eval,
                       EVAL_STATUS_COMPLETE)
            _phase("submit.status", t_status)
        elif retries is not None:
            retries.append(ev)  # no status yet: a later round owns it
        else:
            self.solo_evals += 1
            self._solo(sched.state, ev, _tnow())
