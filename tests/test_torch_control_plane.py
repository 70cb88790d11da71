"""The port's feedback control plane against the JAX package's.

Twins of tests/test_control_plane.py on ``nomad_tpu_torch.control``:
actuators (rails, reversals, pins), the two laws, the controller
(determinism, isolation, spans, flight dumps, its thread), the drivers,
the server wiring (``control_enabled``, the ``controller`` registry
provider), the applier's knobs under a live plan stream, the operator
pin, and the depth retreat under an injected ``device.dispatch`` delay.

Where the result is data it is held against the JAX package: the same
gauge stream drives a port controller and a JAX controller to the same
decisions and knob trajectories, and each driver gives the JAX
driver's signal on the same tick view.

The depth-retreat twin does not rely on wall time (the JAX test's
wall-clock bars fail under load): the port's pipelined runner streams
evals on the CPU under the injected delay with its controller ticked
by hand, and must place every eval as an uncontrolled run of the same
stream does; the retreat and recovery are then proven over a recorded
RTT stream ticked by hand through both packages' ``wire_runner``.
"""
from __future__ import annotations

import random
import threading

import pytest

import nomad_tpu.control as jcontrol
import nomad_tpu.control.wiring as jwiring
from nomad_tpu.control.controller import TickView as JTickView
from nomad_tpu_torch import faultinject, mock
from nomad_tpu_torch.control import (
    AIMD,
    Actuator,
    Controller,
    GradientStep,
    applier_controller,
    runner_controller,
    wire_runner,
)
from nomad_tpu_torch.control import wiring
from nomad_tpu_torch.control.controller import TickView
from nomad_tpu_torch.faultinject import FaultPlan
from nomad_tpu_torch.obs import flight, trace

from tests.conftest import wait_until


def _box(value):
    state = {"v": value}
    return state, (lambda: state["v"]), \
        (lambda v: state.__setitem__("v", v))


def _actuator(value=8, lo=1, hi=16, integer=True, name="k",
              cls=Actuator):
    state, get, set_ = _box(value)
    return state, cls(name, get=get, set=set_, lo=lo, hi=hi,
                      integer=integer, gauge="g")


# ---------------------------------------------------------------------------
# 1. actuators: rails, reversals, pin
# ---------------------------------------------------------------------------

class TestActuator:
    def test_clamps_into_rails_and_counts_saturation_once(self):
        state, act = _actuator(8, lo=1, hi=10)
        old, new, ev = act.apply(50)
        assert (old, new, state["v"]) == (8, 10, 10)
        assert ev["rail"] is True and act.rail_hits == 1
        _old, _new, ev2 = act.apply(50)
        assert ev2["rail"] is False and act.rail_hits == 1
        act.apply(5)
        act.apply(50)
        assert act.rail_hits == 2

    def test_reversals_count_direction_flips(self):
        stats = []
        for cls in (Actuator, jcontrol.Actuator):
            _state, act = _actuator(8, cls=cls)
            for target in (9, 10, 5, 7):
                act.apply(target)
            stats.append(act.stats())
        assert stats[0]["reversals"] == 2
        assert stats[0]["trajectory"] == [8, 9, 10, 5, 7]
        assert stats[0] == stats[1]

    def test_integer_knob_rounds(self):
        state, act = _actuator(3, integer=True)
        act.apply(4.6)
        assert state["v"] == 5

    def test_pin_takes_knob_out_of_the_loop(self):
        state, act = _actuator(8)
        ctl = Controller(lambda: {"g": 1.0}, interval=0.05)
        ctl.add_knob(act, law=AIMD(), driver=lambda v: +1)
        ctl.tick()
        assert ctl.tick()
        act.pin(4)
        assert state["v"] == 4
        assert ctl.tick() == []
        assert state["v"] == 4
        act.pin(None)
        assert ctl.tick()
        assert act.stats()["pinned"] is False

    def test_pin_clamps_to_rails(self):
        state, act = _actuator(8, lo=2, hi=10)
        act.pin(100)
        assert state["v"] == 10

    def test_rejects_inverted_rails(self):
        with pytest.raises(ValueError):
            Actuator("bad", get=lambda: 1, set=lambda v: None,
                     lo=5, hi=5)


class TestLaws:
    def test_aimd_shape(self):
        law = AIMD(add=2.0, mult=0.5)
        jlaw = jcontrol.AIMD(add=2.0, mult=0.5)
        for value, signal, want in ((8, +1, 10), (8, -1, 4), (8, 0, 8)):
            assert law.step(value, signal) == jlaw.step(value, signal) \
                == want
        with pytest.raises(ValueError):
            AIMD(add=0)
        with pytest.raises(ValueError):
            AIMD(mult=1.5)

    def test_gradient_shape(self):
        law = GradientStep(up=1.5, down=0.5)
        assert law.step(8, +1) == 12
        assert law.step(8, -1) == 4
        assert law.step(8, 0) == 8
        assert law.step(0.0, +1) > 0
        assert law.step(0.0, +1) == \
            jcontrol.GradientStep(up=1.5, down=0.5).step(0.0, +1)
        with pytest.raises(ValueError):
            GradientStep(up=0.9)


# ---------------------------------------------------------------------------
# 2. the controller: determinism, isolation, spans, flight, lifecycle
# ---------------------------------------------------------------------------

def _scripted_controller(script, seed=7, pkg="torch"):
    """A controller over a scripted gauge stream (one dict per tick)."""
    ctl_cls, act_cls, aimd = (
        (Controller, Actuator, AIMD) if pkg == "torch" else
        (jcontrol.Controller, jcontrol.Actuator, jcontrol.AIMD))
    feed = {"i": -1}

    def gauges():
        feed["i"] = min(feed["i"] + 1, len(script) - 1)
        return dict(script[feed["i"]])

    ctl = ctl_cls(gauges, interval=0.05, seed=seed)
    _state, act = _actuator(8, lo=1, hi=64, cls=act_cls)
    ctl.add_knob(act, law=aimd(add=1, mult=0.5),
                 driver=lambda v: +1 if v.get("g") > 0
                 else (-1 if v.get("g") < 0 else 0))
    return ctl


class TestController:
    SCRIPT = [{"g": 0}, {"g": 1}, {"g": 1}, {"g": -1}, {"g": 0},
              {"g": 1}]

    def test_deterministic_over_a_gauge_stream(self):
        """Two port runs and a JAX run over one gauge stream make the
        same decisions and end in the same stats."""
        runs = []
        for pkg in ("torch", "torch", "jax"):
            ctl = _scripted_controller(self.SCRIPT, pkg=pkg)
            decisions = [ctl.tick() for _ in self.SCRIPT]
            stats = ctl.stats()
            stats.pop("interval_s")
            runs.append((decisions, stats))
        assert runs[0] == runs[1] == runs[2]
        flat = [d for tick in runs[0][0] for d in tick]
        assert [d["new"] for d in flat] == [9, 10, 5, 6]
        assert [d["reversal"] for d in flat] == [False, False, True,
                                                 True]

    def test_first_tick_only_seeds_the_baseline(self):
        ctl = _scripted_controller([{"g": 1}, {"g": 1}])
        assert ctl.tick() == []
        assert ctl.tick() != []

    def test_every_n_slow_lane(self):
        gauges = {"g": 1.0}
        ctl = Controller(lambda: dict(gauges), interval=0.05)
        _state, act = _actuator(8, name="slow")
        ctl.add_knob(act, law=AIMD(), driver=lambda v: +1, every=3)
        moved = [bool(ctl.tick()) for _ in range(10)]
        assert moved == [False, False, False, False, False, True,
                         False, False, True, False]

    def test_broken_driver_is_isolated(self):
        gauges = {"g": 1.0}
        ctl = Controller(lambda: dict(gauges), interval=0.05)
        _s1, bad = _actuator(8, name="bad")

        def boom(view):
            raise RuntimeError("driver bug")
        ctl.add_knob(bad, law=AIMD(), driver=boom)
        s2, good = _actuator(8, name="good")
        ctl.add_knob(good, law=AIMD(), driver=lambda v: +1)
        ctl.tick()
        ctl.tick()
        assert s2["v"] == 9
        assert ctl.stats()["driver_errors"] == 1

    def test_broken_gauges_fn_is_isolated(self):
        def boom():
            raise RuntimeError("gauge bug")
        ctl = Controller(boom, interval=0.05)
        assert ctl.tick() == []
        assert ctl.stats()["tick_errors"] == 1

    def test_decision_spans(self):
        with trace.tracing(seed=3) as tracer:
            ctl = _scripted_controller(self.SCRIPT)
            for _ in range(3):
                ctl.tick()
            spans = tracer.snapshot()
        ticks = [s for s in spans if s["name"] == "control.tick"]
        adjusts = [s for s in spans if s["name"] == "control.adjust"]
        assert len(ticks) == 3 and len(adjusts) == 2
        by_id = {s["span_id"]: s for s in spans}
        for adj in adjusts:
            parent = by_id[adj["parent_id"]]
            assert parent["name"] == "control.tick"
            tags = adj["tags"]
            assert tags["knob"] == "k" and tags["gauge"] == "g"
            assert tags["new"] == tags["old"] + 1
            assert tags["direction"] == 1

    def test_reversal_and_rail_trip_the_flight_recorder(self, tmp_path):
        with flight.installed(str(tmp_path), min_interval=0.0) as rec:
            gauges = {"g": 1.0}
            ctl = Controller(lambda: dict(gauges), interval=0.05,
                             name="ctl-test")
            _state, act = _actuator(8, lo=1, hi=9)
            ctl.add_knob(act, law=AIMD(), driver=lambda v: +1
                         if v.get("g") > 0 else -1)
            ctl.tick()
            ctl.tick()
            ctl.tick()
            gauges["g"] = -1.0
            ctl.tick()
            names = [n.split("-", 2)[2] for n in rec.incidents()]
            assert any("control.rail" in n for n in names)
            assert any("control.reversal" in n for n in names)

    def test_tick_thread_starts_and_joins(self):
        gauges = {"g": 0.0}
        ctl = Controller(lambda: dict(gauges), interval=0.01,
                         seed=5, name="control-tick-t")
        ctl.start()
        wait_until(lambda: ctl.stats()["ticks"] >= 2, timeout=30,
                   msg="controller ticking")
        ctl.stop()
        assert not ctl.running()
        assert not any(t.name == "control-tick-t"
                       for t in threading.enumerate())

    def test_duplicate_knob_rejected(self):
        ctl = Controller(lambda: {}, interval=0.05)
        _s, act = _actuator(8)
        ctl.add_knob(act, law=AIMD(), driver=lambda v: 0)
        _s2, act2 = _actuator(9)
        with pytest.raises(ValueError):
            ctl.add_knob(act2, law=AIMD(), driver=lambda v: 0)


# ---------------------------------------------------------------------------
# 3. wiring: drivers, server assembly, invariants out of reach
# ---------------------------------------------------------------------------

def _views(cur, prev=None, dt=1.0):
    prev = prev if prev is not None else {k: 0 for k in cur}
    return TickView(cur, prev, dt, None), JTickView(cur, prev, dt, None)


def _signal(name, cur, prev=None):
    """The port driver's signal, held equal to the JAX driver's."""
    view, jview = _views(cur, prev)
    got = getattr(wiring, name)(view)
    assert got == getattr(jwiring, name)(jview), (name, cur)
    return got


class TestDrivers:
    def test_max_window_driver(self):
        base = {"nomad.applier.commits": 0,
                "nomad.applier.plans_committed": 0}
        drv = "_max_window_driver"
        assert _signal(drv, {"nomad.applier.commits": 10,
                             "nomad.applier.plans_committed": 150,
                             "nomad.applier.max_window": 16}, base) == 1
        assert _signal(drv, {"nomad.applier.commits": 10,
                             "nomad.applier.plans_committed": 100,
                             "nomad.applier.max_window": 256},
                       base) == -1
        assert _signal(drv, {"nomad.applier.commits": 10,
                             "nomad.applier.plans_committed": 150,
                             "nomad.applier.max_window": 16,
                             "nomad.plan.evaluate_window.p99": 0.5},
                       base) == -1
        assert _signal(drv, {"nomad.applier.commits": 0,
                             "nomad.applier.plans_committed": 0,
                             "nomad.applier.max_window": 16}, base) == 0

    def test_gather_driver_cost_vs_benefit(self):
        base = {"nomad.applier.commits": 0,
                "nomad.applier.plans_committed": 0,
                "nomad.applier.gather_wall_s": 0.0}
        drv = "_gather_driver"
        assert _signal(drv, {"nomad.applier.commits": 2,
                             "nomad.applier.plans_committed": 40,
                             "nomad.applier.max_window": 256,
                             "nomad.applier.gather_wall_s": 0.8},
                       base) == -1
        assert _signal(drv, {"nomad.applier.commits": 40,
                             "nomad.applier.plans_committed": 120,
                             "nomad.applier.max_window": 64,
                             "nomad.applier.gather_wall_s": 0.01},
                       base) == 1
        assert _signal(drv, {"nomad.applier.commits": 40,
                             "nomad.applier.plans_committed": 2500,
                             "nomad.applier.max_window": 64,
                             "nomad.applier.gather_wall_s": 0.8},
                       base) == 0

    def test_inflight_driver(self):
        base = {"nomad.applier.commit_backpressure_s": 0,
                "nomad.applier.dispatch_failures": 0}
        drv = "_inflight_driver"
        assert _signal(drv, {"nomad.applier.commit_backpressure_s": 0.5,
                             "nomad.applier.dispatch_failures": 0},
                       base) == 1
        assert _signal(drv, {"nomad.applier.commit_backpressure_s": 0.5,
                             "nomad.applier.dispatch_failures": 1},
                       base) == -1
        assert _signal(drv, {"nomad.applier.commit_backpressure_s": 0.0,
                             "nomad.applier.dispatch_failures": 0},
                       base) == 0

    def test_depth_limit_driver_residence_band(self):
        base = {"nomad.broker.acks": 0,
                "nomad.overload.shed.service": 0,
                "nomad.overload.shed.batch": 0,
                "nomad.broker.depth_sheds": 0}
        drv = "_depth_limit_driver"
        assert _signal(drv, {"nomad.broker.acks": 100,
                             "nomad.broker.depth": 10,
                             "nomad.overload.shed.service": 5,
                             "nomad.overload.shed.batch": 0,
                             "nomad.broker.depth_sheds": 0}, base) == 1
        assert _signal(drv, {"nomad.broker.acks": 10,
                             "nomad.broker.depth": 100,
                             "nomad.overload.shed.service": 5,
                             "nomad.overload.shed.batch": 0,
                             "nomad.broker.depth_sheds": 0}, base) == -1
        assert _signal(drv, {"nomad.broker.acks": 0,
                             "nomad.broker.depth": 100}, base) == 0

    def test_brownout_driver_reads_wheel_pressure(self):
        base = {"nomad.broker.acks": 0,
                "nomad.overload.shed.batch": 0}
        assert _signal("_brownout_ratio_driver",
                       {"nomad.heartbeat.pending_expiries": 12,
                        "nomad.broker.acks": 100,
                        "nomad.broker.depth": 1}, base) == -1

    def test_runner_depth_driver_learned_floor(self):
        drv = wiring._make_depth_driver()
        jdrv = jwiring._make_depth_driver()
        for rtt, want in ((2.0, 1), (5.0, 0), (20.0, -1), (0.0, 0)):
            view, jview = _views({"nomad.runner.rtt_ms_ewma": rtt}, {})
            assert drv(view) == jdrv(jview) == want, rtt


def _port_server(**kw):
    from nomad_tpu_torch.server import Server, ServerConfig

    kw.setdefault("device", "cpu")
    kw.setdefault("tune_gc", False)
    return Server(ServerConfig(**kw))


class TestServerWiring:
    def test_server_controller_knobs_and_registry(self):
        srv = _port_server(num_schedulers=0, control_enabled=True,
                           control_interval=0.02, control_seed=11)
        try:
            assert srv.controller is not None
            knobs = srv.controller.stats()["knobs"]
            assert set(knobs) == {
                "broker.depth_limit", "overload.overload_ratio",
                "overload.brownout_ratio", "applier.max_window",
                "applier.max_inflight_commits", "applier.gather_s"}
            snap = srv.obs_registry.snapshot()
            assert "nomad.controller.ticks" in snap
            assert "nomad.controller.knobs.broker.depth_limit.value" \
                in snap
            wait_until(lambda:
                       srv.obs_registry.snapshot()
                       ["nomad.controller.ticks"] >= 2,
                       timeout=30, msg="server controller ticking")
        finally:
            srv.shutdown()
        assert not srv.controller.running()

    def test_depth_limit_actuator_moves_broker_and_pressure_source(self):
        srv = _port_server(num_schedulers=0, control_enabled=True,
                           broker_depth_limit=64)
        try:
            act = srv.controller.knob("broker.depth_limit")
            act.apply(128)
            assert srv.eval_broker.max_depth == 128
            assert srv.config.broker_depth_limit == 128
        finally:
            srv.shutdown()

    def test_set_ratios_preserves_the_invariant(self):
        from nomad_tpu_torch.server.overload import OverloadController

        ctl = OverloadController(brownout_ratio=0.5, overload_ratio=1.0)
        ctl.set_ratios(overload=0.4)
        brown, over = ctl.ratios()
        assert over == 0.4 and brown <= over
        ctl.set_ratios(brownout=0.9)
        brown, over = ctl.ratios()
        assert brown <= over
        assert ctl.hysteresis == 0.9

    def test_liveness_lane_is_out_of_the_controllers_reach(self):
        """However low the controller drives the thresholds,
        Node.Heartbeat bypasses admission and force=True enqueues bypass
        the depth bound."""
        from nomad_tpu_torch.server.eval_broker import EvalBroker
        from nomad_tpu_torch.server.overload import (OVERLOAD,
                                                     ErrOverloaded,
                                                     OverloadController)
        from nomad_tpu_torch.structs import Evaluation, generate_uuid

        ctl = OverloadController(brownout_ratio=0.5, overload_ratio=1.0)
        ctl.set_ratios(brownout=1e-6, overload=1e-6)
        ctl.add_source("stuck", lambda: (1, 1))
        assert ctl.state() == OVERLOAD
        ctl.admit_rpc("Node.Heartbeat", {})
        with pytest.raises(ErrOverloaded):
            ctl.admit_rpc("Job.Register", {"job": {"type": "service"}})

        broker = EvalBroker(admission=ctl, max_depth=1)
        broker.set_enabled(True)
        try:
            for _ in range(3):
                broker.enqueue(Evaluation(
                    id=generate_uuid(), priority=1, type="service",
                    triggered_by="test", job_id=generate_uuid()),
                    force=True)
            assert broker.stats()["depth"] == 3
        finally:
            broker.shutdown()

    def test_an_abandoned_server_only_signals_its_controller(self):
        """``abandon`` signals the controller's thread and joins
        nothing; ``shutdown`` (the reap) joins it."""
        srv = _port_server(num_schedulers=0, control_enabled=True,
                           control_interval=0.01)
        try:
            wait_until(lambda: srv.controller.running(), timeout=10,
                       msg="controller running")
            srv.abandon()
            assert srv.controller._stop.is_set()
        finally:
            srv.shutdown()
        assert not srv.controller.running()


# ---------------------------------------------------------------------------
# 4. live commit pipeline: applier knobs move under a real stream
# ---------------------------------------------------------------------------

class TestApplierControl:
    def test_applier_controller_relieves_commit_backpressure(self):
        """A mis-set max_inflight_commits=1 under a live plan stream:
        the AIMD knob grows the commit pipeline when the applier books
        backpressure wall."""
        from nomad_tpu_torch.server.eval_broker import EvalBroker
        from nomad_tpu_torch.server.fsm import NomadFSM
        from nomad_tpu_torch.server.plan_apply import PlanApplier
        from nomad_tpu_torch.server.plan_queue import PlanQueue
        from nomad_tpu_torch.server.raft import InmemRaft
        from nomad_tpu_torch.structs import (ALLOC_CLIENT_STATUS_PENDING,
                                             ALLOC_DESIRED_STATUS_RUN,
                                             EVAL_TRIGGER_JOB_REGISTER,
                                             Allocation, Evaluation, Plan,
                                             Resources, codec,
                                             generate_uuid)

        broker = EvalBroker(nack_timeout=60.0)
        fsm = NomadFSM(eval_broker=broker)
        raft = InmemRaft(fsm)
        queue = PlanQueue()
        applier = PlanApplier(queue, broker, raft,
                              state_fn=lambda: fsm.state,
                              max_window=8, gather_s=0.002, device="cpu")
        applier.max_inflight_commits = 1
        broker.set_enabled(True)
        queue.set_enabled(True)
        applier.start()
        ctl = applier_controller(applier, queue, broker=broker, seed=3)
        try:
            raft.apply(codec.encode(
                codec.NODE_REGISTER_REQUEST,
                {"node": mock.node(0).to_dict()})).wait()
            node_id = fsm.state.nodes()[0].id
            ctl.tick()
            for _burst in range(6):
                futures = []
                for _ in range(8):
                    ev = Evaluation(
                        id=generate_uuid(), priority=50,
                        type="service",
                        triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                        job_id=generate_uuid())
                    broker.enqueue(ev, force=True)
                    got, token = broker.dequeue(["service"],
                                                timeout=10)
                    plan = Plan(eval_id=got.id, eval_token=token,
                                priority=50)
                    plan.node_allocation[node_id] = [Allocation(
                        id=generate_uuid(), node_id=node_id,
                        job_id=ev.job_id, task_group="web",
                        resources=Resources(cpu=1, memory_mb=1),
                        desired_status=ALLOC_DESIRED_STATUS_RUN,
                        client_status=ALLOC_CLIENT_STATUS_PENDING)]
                    futures.append((got, token, queue.enqueue(plan)))
                for got, token, fut in futures:
                    fut.wait(30)
                    broker.ack(got.id, token)
                ctl.tick()
            knob = ctl.stats()["knobs"]["applier.max_inflight_commits"]
            stats = applier.stats()
            assert stats["plans_committed"] == 48
            if stats["commit_backpressure_s"] > 0.01:
                assert knob["value"] > 1
        finally:
            ctl.stop()
            queue.set_enabled(False)
            broker.set_enabled(False)
            applier.shutdown(5.0)
            broker.shutdown()


# ---------------------------------------------------------------------------
# 5. the depth retreat under an injected dispatch delay
# ---------------------------------------------------------------------------

def _pipeline_world(n_nodes, n_jobs):
    from nomad_tpu_torch.scheduler import Harness

    h = Harness(device="cpu")
    for i in range(n_nodes):
        h.state.upsert_node(h.next_index(), mock.node(i))
    jobs = []
    for k in range(n_jobs):
        j = mock.job()
        j.id = f"chaos-{k}"
        h.state.upsert_job(h.next_index(), j)
        jobs.append(j)
    return h, jobs


def _mk_eval(job):
    from nomad_tpu_torch.structs import (EVAL_TRIGGER_JOB_REGISTER,
                                         Evaluation, generate_uuid)

    return Evaluation(id=generate_uuid(), priority=job.priority,
                      type=job.type,
                      triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                      job_id=job.id)


def _placements(h):
    names = {n.id: n.name for n in h.state.nodes()}
    return sorted((a.job_id, a.name, names[a.node_id])
                  for a in h.state.allocs() if not a.terminal_status())


def _stream(controlled: bool):
    """The JAX rig's stream on the port's CPU runner: 4 warm-up evals,
    8 healthy, 6 under a seeded 50 ms ``device.dispatch`` delay (one a
    dispatch, six in all), 20 clean; the controller ticked by hand after
    each round trip.  Returns the placements, the RTT gauge after each
    round trip and the depth the runner ran each round trip at."""
    from nomad_tpu_torch.scheduler.executor import executor_override
    from nomad_tpu_torch.scheduler.pipeline import PipelinedEvalRunner

    h, jobs = _pipeline_world(8, 38)
    rtts, depths = [], []
    random.seed(17)
    with executor_override("device"):
        runner = PipelinedEvalRunner(
            h.state.snapshot(), h, depth=8,
            state_refresh=lambda: h.state.snapshot(), device="cpu")
        runner.process([_mk_eval(j) for j in jobs[:4]])
        with runner._count_lock:
            runner._rtt_ewma = 0.0
        ctl = runner_controller(runner, seed=7, lo=1, hi=8) \
            if controlled else None

        def round_trip(batch):
            depths.append(runner.depth)
            runner.process([_mk_eval(j) for j in batch])
            rtts.append(runner.stats()["rtt_ms_ewma"])
            if ctl is not None:
                ctl.tick()

        round_trip(jobs[4:8])
        round_trip(jobs[8:12])
        plan = FaultPlan(seed=5).add("device.dispatch", "delay",
                                     secs=0.05, count=6)
        with faultinject.injected(plan):
            round_trip(jobs[12:15])
            round_trip(jobs[15:18])
        assert plan.fire_count("device.dispatch") == 6
        for lo in range(18, 38, 4):
            round_trip(jobs[lo:lo + 4])
    assert runner.device_dispatches == 38
    assert runner.breaker_reruns == 0
    assert all(e.status == "complete" for e in h.evals)
    return _placements(h), rtts, depths


class _GaugeRunner:
    """A runner stand-in for ``wire_runner``: a ``depth`` knob and a
    ``stats()`` that replays a recorded RTT stream, one value a tick."""

    def __init__(self, rtts, depth=8) -> None:
        self.depth = depth
        self._rtts = list(rtts)
        self._i = -1

    def stats(self) -> dict:
        self._i = min(self._i + 1, len(self._rtts) - 1)
        return {"rtt_ms_ewma": self._rtts[self._i], "depth": self.depth}


def _replay(rtts, pkg):
    """Tick a ``wire_runner`` controller over ``rtts`` by hand, in
    ``pkg``; the knob's trajectory and its counters."""
    ctl_cls, wire = (Controller, wire_runner) if pkg == "torch" else \
        (jcontrol.Controller, jcontrol.wire_runner)
    runner = _GaugeRunner(rtts)
    ctl = ctl_cls(lambda: {"nomad.runner." + k: v
                           for k, v in runner.stats().items()},
                  interval=0.05, seed=7)
    wire(ctl, runner, lo=1, hi=8)
    seen = []
    for _ in rtts:
        ctl.tick()
        seen.append(runner.depth)
    knob = ctl.stats()["knobs"]["pipeline.depth"]
    return seen, knob["trajectory"], knob["reversals"], knob["rail_hits"]


# A recorded RTT EWMA stream (ms, one value a round trip) with the
# JAX rig's shape: a healthy floor, a delay window, a decay back.
RECORDED_RTT_MS = [3.1, 2.9, 2.8, 56.0, 98.0, 130.0, 104.0, 83.0, 66.5,
                   53.2, 42.6, 34.1, 27.3, 21.8, 17.5, 14.0, 11.2, 9.0,
                   7.2, 5.8, 4.6, 3.7, 3.2, 3.0]


class TestChaosDepthRetreat:
    def test_injected_dispatch_delay_forces_retreat_then_recovery(self):
        """The depth knob retreats multiplicatively while the delayed
        dispatches inflate the RTT and climbs back additively once it
        decays under the probe band, without oscillating — on the
        recorded stream, ticked by hand through the port's and the JAX
        package's ``wire_runner`` alike; and the port's runner, streaming
        under the injected delay with its controller ticked by hand,
        places every eval exactly as an uncontrolled run of the same
        stream does, and its recorded stream drives both packages'
        controllers to one trajectory."""
        seen, traj, reversals, rails = _replay(RECORDED_RTT_MS, "torch")
        assert (seen, traj, reversals, rails) == \
            _replay(RECORDED_RTT_MS, "jax")
        retreated_to = min(seen)
        low = seen.index(retreated_to)
        assert retreated_to < 8 and seen[low:] != [retreated_to] * len(
            seen[low:]), seen
        assert seen[-1] > retreated_to, seen
        assert reversals <= 2 and rails <= 2, (traj, reversals, rails)

        placed, rtts, depths = _stream(controlled=True)
        want, _rtts, plain_depths = _stream(controlled=False)
        assert placed == want
        assert len(placed) == 38 * 10
        assert plain_depths == [8] * len(plain_depths)
        assert len(rtts) == len(depths) == 9
        assert _replay(rtts, "torch") == _replay(rtts, "jax")


# ---------------------------------------------------------------------------
# 6. the operator drill: pin via the controller
# ---------------------------------------------------------------------------

class TestOperatorPin:
    def test_controller_pin_by_name(self):
        gauges = {"g": 1.0}
        ctl = Controller(lambda: dict(gauges), interval=0.05)
        state, act = _actuator(8)
        ctl.add_knob(act, law=AIMD(), driver=lambda v: +1)
        ctl.pin("k", 3)
        assert state["v"] == 3
        ctl.tick()
        ctl.tick()
        assert state["v"] == 3
        ctl.pin("k", None)
        ctl.tick()
        assert state["v"] == 4
