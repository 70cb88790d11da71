"""Standard knob sets: which gauge drives which tunable, with rails.

One place declares the whole control surface (the README's knob table
renders from the same facts):

| knob | law | rails | driving gauges |
|---|---|---|---|
| ``pipeline.depth`` | AIMD | [1, 64] | ``nomad.runner.rtt_ms_ewma`` vs its learned floor |
| ``applier.max_inflight_commits`` | AIMD | [1, 16] | ``nomad.applier.commit_backpressure_s`` / ``dispatch_failures`` |
| ``applier.max_window`` | gradient | [8, 512] | recent window occupancy vs the cap, ``nomad.plan.evaluate_window.p99`` |
| ``applier.gather_s`` | gradient | [2ms, 250ms] | ``nomad.applier.gather_wall_s`` fraction vs occupancy bought, commit rate |
| ``broker.depth_limit`` | gradient (slow) | [16, 8192] | shed deltas + queue residence (depth / ack rate) |
| ``overload.overload_ratio`` | gradient (slow) | [0.5, 1.0] | ``nomad.overload.shed.service`` + residence |
| ``overload.brownout_ratio`` | gradient (slow) | [0.2, 0.95] | ``nomad.overload.shed.batch``, ``nomad.heartbeat.pending_expiries``, residence |

Hysteresis lives in the drivers as hold bands (grow below one
threshold, shrink above another, hold between), so a gauge hovering at
a boundary cannot flap a knob; the overload state machine's own
enter/exit hysteresis is untouched — the controller moves thresholds,
``OverloadController.set_ratios`` preserves the invariant and the
asymmetry.

Queue *residence* is the portable congestion signal: ``broker depth /
ack rate`` estimates how long an admitted eval waits.  Sheds while
residence is short mean admission is tighter than the machine
(thresholds too low / limit too small — grow); residence past a couple
of seconds means the queue outruns the machine (shrink).  This is the
Tail-at-Scale move: adapt the limit to observed latency, not to the
bench box the constant was tuned on.
"""
from __future__ import annotations

from typing import Optional

from .controller import AIMD, Actuator, Controller, GradientStep

# Queue-residence hold band (seconds): grow below GROW, shrink above
# SHRINK, hold between — the drivers' hysteresis.
RESIDENCE_GROW_S = 0.5
RESIDENCE_SHRINK_S = 2.0
# Ratio knobs use a wider shrink bound: lowering an admission threshold
# sheds real work, so demand stronger evidence.
RESIDENCE_RATIO_SHRINK_S = 3.0
# Window-verify latency past this fraction of a typical plan deadline
# means windows grew too fat to verify promptly.
VERIFY_P99_SHRINK_S = 0.25
# Pipeline-depth AIMD: RTT EWMA vs its learned floor; retreat past
# RETREAT x floor, probe deeper below PROBE x floor, hold between.
RTT_RETREAT_X = 4.0
RTT_PROBE_X = 2.0


def registry_gauges(registry, inmem: bool = True):
    """A ``gauges_fn`` over a MetricsRegistry snapshot, optionally
    merged with the in-mem sink's sample summaries (that is where
    timer gauges like ``nomad.plan.evaluate_window.p99`` live)."""
    def gauges() -> dict:
        out = registry.snapshot()
        if inmem:
            from nomad_tpu_torch.obs.registry import flatten
            from nomad_tpu_torch.utils.metrics import metrics
            out.update(flatten(
                metrics.inmem.snapshot().get("samples") or {}))
        return out
    return gauges


def _residence(view) -> Optional[float]:
    """Estimated broker queue residence (seconds): tracked evals over
    the ack rate.  None when no acks landed this tick (no signal)."""
    acks = view.rate("nomad.broker.acks")
    if acks <= 0:
        return None
    return view.get("nomad.broker.depth") / acks


def _recent_occupancy(view) -> Optional[float]:
    """Mean window occupancy over THIS tick's commits (the cumulative
    ``batch_occupancy`` gauge averages the whole leader tenure — a
    controller needs the current operating point)."""
    commits = view.delta("nomad.applier.commits")
    if commits <= 0:
        return None
    return view.delta("nomad.applier.plans_committed") / commits


# -- drivers ----------------------------------------------------------------

def _max_window_driver(view) -> int:
    occ = _recent_occupancy(view)
    if occ is None:
        return 0
    if view.get("nomad.plan.evaluate_window.p99") > VERIFY_P99_SHRINK_S:
        return -1  # windows too fat to verify promptly
    mw = view.get("nomad.applier.max_window", 1.0)
    if occ >= 0.85 * mw:
        return +1  # occupancy tracks the cap: the cap is the binding
        #            constraint, not the offered stream
    if occ < 0.25 * mw and mw > 64:
        return -1  # cap far above the observed stream: drift back
    return 0


def _inflight_driver(view) -> int:
    if view.delta("nomad.applier.dispatch_failures") > 0:
        return -1  # raft dispatch faulting: shrink the run-ahead
    if view.delta("nomad.applier.commit_backpressure_s") > 0.05 * view.dt:
        return +1  # the applier blocked on a full commit pipeline
    return 0


def _gather_driver(view) -> int:
    occ = _recent_occupancy(view)
    if occ is None:
        return 0
    mw = view.get("nomad.applier.max_window", 1.0)
    # Gather wall the applier actually paid this tick, as a fraction
    # of the tick: the horizon's COST.  Its BENEFIT is occupancy —
    # a horizon burning wall while windows stay thin is pure latency
    # (every in-flight submitter is already parked on a future; no
    # deeper window is coming), so it shrinks aggressively.
    gather_frac = view.delta("nomad.applier.gather_wall_s") / view.dt
    if gather_frac > 0.3 and occ < 0.5 * mw:
        return -1
    # Growing helps only when commits are small AND frequent — the
    # amortization opportunity: many commit cycles per second each
    # carrying a thin window — and only while the gather wall is still
    # NEGLIGIBLE (< 0.05): the wide gap between the grow and shrink
    # bands is the hold band that stops the knob flapping at a
    # boundary (gather_frac responds ~linearly to the knob, so a 1.5x
    # step cannot jump the 6x band in one move).
    if gather_frac < 0.05 \
            and view.delta("nomad.applier.commits") / view.dt > 20.0 \
            and occ < 0.3 * mw:
        return +1
    return 0


def _depth_limit_driver(view) -> int:
    res = _residence(view)
    if res is None:
        return 0
    if res > RESIDENCE_SHRINK_S:
        return -1
    shed = (view.delta("nomad.overload.shed.service")
            + view.delta("nomad.overload.shed.batch")
            + view.delta("nomad.broker.depth_sheds"))
    if shed > 0 and res < RESIDENCE_GROW_S:
        return +1
    return 0


def _overload_ratio_driver(view) -> int:
    res = _residence(view)
    if res is None:
        return 0
    if res > RESIDENCE_RATIO_SHRINK_S:
        return -1
    if view.delta("nomad.overload.shed.service") > 0 and res < 1.0:
        return +1
    return 0


def _brownout_ratio_driver(view) -> int:
    # Heartbeat wheel pressure first: a backlog of paced expiries means
    # the server is digesting a mass event — keep brownout engaged
    # (expiry deferral) rather than raising its entry bar.
    if view.get("nomad.heartbeat.pending_expiries") > 0:
        return -1
    res = _residence(view)
    if res is None:
        return 0
    if res > RESIDENCE_RATIO_SHRINK_S:
        return -1
    if view.delta("nomad.overload.shed.batch") > 0 and res < 1.0:
        return +1
    return 0


def _make_depth_driver():
    """Pipeline-depth AIMD driver with a learned RTT floor: the EWMA's
    minimum observed value is the healthy baseline; RETREAT x floor is
    congestion (multiplicative retreat), below PROBE x floor is healthy
    (additive probe), between is the hold band that stops oscillation."""
    mem = {"floor": None}

    def driver(view) -> int:
        rtt = view.get("nomad.runner.rtt_ms_ewma")
        if rtt <= 0:
            return 0
        floor = mem["floor"]
        if floor is None or rtt < floor:
            mem["floor"] = floor = rtt
        if rtt > RTT_RETREAT_X * floor:
            return -1
        if rtt < RTT_PROBE_X * floor:
            return +1
        return 0
    return driver


# -- knob sets --------------------------------------------------------------

def wire_applier(ctl: Controller, applier) -> None:
    """The applier's three knobs: window cap (gradient), commit
    run-ahead (AIMD), window-gather horizon (gradient).  All three
    attributes are re-read by the applier loop every iteration, so the
    actuator's plain attribute write takes effect on the next window."""
    ctl.add_knob(
        Actuator("applier.max_window",
                 get=lambda: applier.max_window,
                 set=lambda v: setattr(applier, "max_window",
                                       max(1, int(v))),
                 lo=8, hi=512, integer=True,
                 gauge="nomad.applier.batch_occupancy"),
        law=GradientStep(up=1.5, down=0.67), driver=_max_window_driver)
    ctl.add_knob(
        Actuator("applier.max_inflight_commits",
                 get=lambda: applier.max_inflight_commits,
                 set=lambda v: setattr(applier, "max_inflight_commits",
                                       max(1, int(v))),
                 lo=1, hi=16, integer=True,
                 gauge="nomad.applier.commit_backpressure_s"),
        law=AIMD(add=1.0, mult=0.5), driver=_inflight_driver)
    # Aggressive down-step (0.4): a gather horizon that burns wall
    # without buying occupancy is pure submit latency, and a 4x-large
    # mis-set must converge within a fraction of a bench window.
    # Slow lane (every=4): the gather-wall fraction is lumpy over one
    # tick (a 50 ms tick may hold zero gathers); the per-knob delta
    # window smooths it to the knob's own cadence.
    ctl.add_knob(
        Actuator("applier.gather_s",
                 get=lambda: applier.gather_s,
                 set=lambda v: setattr(applier, "gather_s", float(v)),
                 lo=0.002, hi=0.25,
                 gauge="nomad.applier.gather_wall_s"),
        law=GradientStep(up=1.5, down=0.4), driver=_gather_driver,
        every=4)


def wire_overload(ctl: Controller, overload, broker=None, config=None,
                  every: int = 2) -> None:
    """The admission thresholds, on the slow lane (``every`` ticks):
    the broker depth limit (skipped for unbounded brokers) and the
    brownout/overload ratios through ``set_ratios`` (which preserves
    ``0 < brownout <= overload`` and the state machine's hysteresis).
    The liveness lane and ``force=True`` committed-state enqueues sit
    BEFORE these thresholds and stay out of reach by construction."""
    if broker is not None and broker.max_depth is not None:
        def _set_limit(v: float) -> None:
            limit = max(1, int(v))
            broker.max_depth = limit
            if config is not None:
                config.broker_depth_limit = limit
        ctl.add_knob(
            Actuator("broker.depth_limit",
                     get=lambda: broker.max_depth,
                     set=_set_limit, lo=16, hi=8192, integer=True,
                     gauge="nomad.broker.depth"),
            law=GradientStep(up=1.5, down=0.67),
            driver=_depth_limit_driver, every=every)
    ctl.add_knob(
        Actuator("overload.overload_ratio",
                 get=lambda: overload.ratios()[1],
                 set=lambda v: overload.set_ratios(overload=v),
                 lo=0.5, hi=1.0,
                 gauge="nomad.overload.shed.service"),
        law=GradientStep(up=1.3, down=0.85),
        driver=_overload_ratio_driver, every=every)
    ctl.add_knob(
        Actuator("overload.brownout_ratio",
                 get=lambda: overload.ratios()[0],
                 set=lambda v: overload.set_ratios(brownout=v),
                 lo=0.2, hi=0.95,
                 gauge="nomad.overload.shed.batch"),
        law=GradientStep(up=1.3, down=0.85),
        driver=_brownout_ratio_driver, every=every)


def wire_runner(ctl: Controller, runner, lo: int = 1,
                hi: int = 64) -> None:
    """AIMD on the pipelined runner's in-flight dispatch depth, driven
    by the dispatch/collect RTT EWMA vs its learned floor — injected
    ``device.dispatch`` delay (or a genuinely slow chip) forces a
    retreat; recovery probes back up additively."""
    ctl.add_knob(
        Actuator("pipeline.depth",
                 get=lambda: runner.depth,
                 set=lambda v: setattr(runner, "depth", max(1, int(v))),
                 lo=lo, hi=hi, integer=True,
                 gauge="nomad.runner.rtt_ms_ewma"),
        law=AIMD(add=1.0, mult=0.5), driver=_make_depth_driver())


# -- assembled controllers ---------------------------------------------------

def server_controller(server, interval: Optional[float] = None,
                      seed: Optional[int] = None) -> Controller:
    """The per-Server controller: admission thresholds + applier knobs,
    gauges read from the server's own registry (plus the in-mem sink's
    timer summaries).  The Server starts/stops it with its lifecycle
    and registers ``controller`` as a provider, so every decision
    surfaces in /v1/agent/metrics."""
    ctl = Controller(
        registry_gauges(server.obs_registry),
        interval=server.config.control_interval
        if interval is None else interval,
        seed=server.config.control_seed if seed is None else seed,
        name="control-tick")
    wire_overload(ctl, server.overload, broker=server.eval_broker,
                  config=server.config)
    wire_applier(ctl, server.plan_applier)
    return ctl


def applier_controller(applier, plan_queue, broker=None,
                       interval: float = 0.1, seed: int = 0
                       ) -> Controller:
    """A standalone commit-pipeline controller (bench 5f's convergence
    rig and applier-only test harnesses): same knobs and drivers as the
    server wiring, gauges from a private registry over the applier/
    queue/broker stats providers."""
    from nomad_tpu_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    reg.register("applier", applier.stats)
    reg.register("plan_queue", plan_queue.stats)
    if broker is not None:
        reg.register("broker", broker.stats)
    ctl = Controller(registry_gauges(reg), interval=interval, seed=seed,
                     name="control-tick-applier")
    wire_applier(ctl, applier)
    return ctl


def runner_controller(runner, interval: float = 0.05, seed: int = 0,
                      lo: int = 1, hi: int = 64) -> Controller:
    """A standalone pipeline-depth controller (the chaos rig): AIMD
    depth over the live runner's RTT gauge."""
    from nomad_tpu_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    reg.register("runner", runner.stats)
    ctl = Controller(registry_gauges(reg, inmem=False),
                     interval=interval, seed=seed,
                     name="control-tick-runner")
    wire_runner(ctl, runner, lo=lo, hi=hi)
    return ctl
