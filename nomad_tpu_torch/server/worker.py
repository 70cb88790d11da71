"""Scheduler workers: dequeue evals, invoke schedulers, submit plans.

Capability parity with reference nomad/worker.go:50-437: each worker
loops dequeue -> wait for raft catch-up -> snapshot -> instantiate scheduler
by eval type -> Process -> Ack/Nack.  The worker implements the scheduler's
``Planner`` seam: SubmitPlan stamps the eval token, enqueues on the plan
queue, blocks on the future, and hands back a refreshed state snapshot when
the applier signals stale data (RefreshIndex).

Device extension: ``BatchWorker`` drains a batch of ready evals in one
call and fuses them through BatchEvalRunner into a single kernel launch on
the server's device — the device replaces the reference's NumCPU-goroutine
worker pool as the source of scheduling throughput.

Counterpart of ``nomad_tpu/server/worker.py``.  Every worker
carries its server's ``device``: the batch runner launches there, and the
``system`` scheduler reads it off its planner (``planner.device``).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from nomad_tpu_torch.obs import trace as trace_mod
from nomad_tpu_torch.scheduler import new_scheduler
from nomad_tpu_torch.utils.metrics import metrics
from nomad_tpu_torch.utils.retry import Backoff
from nomad_tpu_torch.structs import Evaluation, Plan, PlanResult

logger = logging.getLogger("nomad_tpu_torch.server.worker")

RAFT_SYNC_LIMIT = 5.0  # reference worker.go:34-37
BACKOFF_BASE = 0.05
BACKOFF_LIMIT = 1.0    # dequeue supervision cap: stay leadership-responsive
PLAN_WAIT_POLL = 2.0   # liveness probe interval while awaiting a plan


class Worker:
    """One scheduling worker thread."""

    def __init__(self, server, scheduler_override: Optional[str] = None,
                 queues: Optional[list] = None) -> None:
        self.server = server
        self.scheduler_override = scheduler_override
        self.queues = queues  # None = all enabled schedulers
        # The server's device: the planner seam hands it to schedulers
        # that launch kernels (``system`` reads ``planner.device``).
        self.device = server.device
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._pause_cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self.eval_token: str = ""
        # Deadline propagation (server/overload.py): a delivery is only
        # useful until the broker's nack timer redelivers the eval —
        # past that, any plan this worker submits will be token-fenced
        # anyway.  Stamped at dequeue, propagated onto submitted plans,
        # and checked after potentially-long waits.
        self._delivery_deadline: float = 0.0
        self.expired_drops = 0  # deliveries abandoned past deadline
        # Deliveries nacked after an exception (a scheduler fault, or a
        # kernel that failed to build, launch or fetch): recorded, never
        # retried elsewhere — the eval redelivers to the same device.
        self.failures = 0
        self.last_error: Optional[BaseException] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="scheduler-worker")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        """Reap the worker thread after ``stop()``; bounded — the loop
        re-checks the stop event at least every dequeue timeout."""
        if self._thread is not None:
            self._thread.join(timeout)

    def set_pause(self, paused: bool) -> None:
        """Leader reserves a worker's CPU for its own duties
        (worker.go:77-93)."""
        with self._pause_cond:
            if paused:
                self._paused.set()
            else:
                self._paused.clear()
                self._pause_cond.notify_all()

    def _check_paused(self) -> None:
        with self._pause_cond:
            while self._paused.is_set() and not self._stop.is_set():
                self._pause_cond.wait(0.1)

    # -- main loop --------------------------------------------------------
    def run(self) -> None:
        # Jittered growth while the broker is disabled (follower /
        # leadership transition) so N workers don't poll in lockstep;
        # reset the moment a dequeue succeeds (utils/retry.py).
        backoff = Backoff(base=BACKOFF_BASE, max_delay=BACKOFF_LIMIT,
                          jitter=0.5)
        while not self._stop.is_set():
            self._check_paused()
            queues = self.queues or self.server.enabled_schedulers()
            try:
                ev, token = self.server.eval_broker.dequeue(
                    queues, timeout=0.25)
            except RuntimeError:
                if backoff.sleep(self._stop):
                    return
                continue
            backoff.reset()
            if ev is None:
                continue
            self.eval_token = token
            self._delivery_deadline = time.monotonic() + \
                self.server.eval_broker.nack_timeout
            try:
                self._wait_for_index(ev.modify_index, RAFT_SYNC_LIMIT)
                self._check_delivery_live(ev)
                self._invoke_scheduler(ev)
            except Exception as e:
                from .overload import ErrDeadlineExceeded
                if isinstance(e, ErrDeadlineExceeded):
                    # Expected overload behavior, not a failure: the
                    # broker redelivers; no traceback spam.
                    logger.warning("worker: dropped expired eval %s: %s",
                                   ev.id, e)
                else:
                    logger.exception("worker: failed to process eval %s",
                                     ev.id)
                    self.failures += 1
                    self.last_error = e
                try:
                    self.server.eval_broker.nack(ev.id, token)
                except ValueError:
                    pass
                continue
            try:
                self.server.eval_broker.ack(ev.id, token)
            except ValueError:
                pass

    def _check_delivery_live(self, ev: Evaluation) -> None:
        """Drop work whose delivery deadline passed (a long raft
        catch-up or pause outlived the nack window): the broker has
        redelivered the eval, so scheduling it here only races the
        retry toward a token-fenced plan."""
        from .overload import ErrDeadlineExceeded

        if self._delivery_deadline and \
                time.monotonic() > self._delivery_deadline:
            # One producer per number: the struct counter is what the
            # server's ``_worker_stats`` sums (the JAX package's
            # metrics registry exports it as nomad.workers.expired_drops).
            self.expired_drops += 1
            raise ErrDeadlineExceeded(
                f"delivery of eval {ev.id} outlived the nack window")

    def _wait_for_index(self, index: int, timeout: float) -> None:
        """Block until the local FSM has applied at least `index`
        (worker.go:209-230)."""
        deadline = time.monotonic() + timeout
        while self.server.raft.applied_index() < index:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"timed out waiting for raft index {index}")
            time.sleep(0.005)

    def _invoke_scheduler(self, ev: Evaluation) -> None:
        # tracer() re-checked for None behind the gate: a concurrent
        # disable() degrades this invoke to untraced, never fails it.
        tracer = trace_mod.tracer() if trace_mod.ENABLED else None
        if tracer is not None and ev.trace:
            # The eval's scheduling span, rooted under its anchor; the
            # context is ambient for the whole invoke so plan submits
            # and follow-up eval creations nest into the same tree.
            with tracer.attach(ev.trace):
                with tracer.span("worker.invoke", eval_id=ev.id,
                                 eval_type=ev.type):
                    self._invoke_scheduler_inner(ev)
            return
        self._invoke_scheduler_inner(ev)

    def _invoke_scheduler_inner(self, ev: Evaluation) -> None:
        start = time.perf_counter()
        state = self.server.fsm.state.snapshot()
        name = self.scheduler_override or ev.type
        if name == "_core":
            from .core_sched import CoreScheduler
            CoreScheduler(self.server, state).process(ev)
            return
        sched = new_scheduler(name, state, self)
        sched.process(ev)
        metrics.measure_since("nomad.worker.invoke_scheduler." + name,
                              start)

    def _wait_plan(self, future):
        """Bounded future wait with a liveness probe: the applier always
        responds while the leader is alive, but leadership loss (or a
        test teardown) can orphan an already-submitted plan — a worker
        blocked forever here pins its whole dispatch (including the
        gc_pause the fused path runs under) for the process lifetime."""
        while True:
            try:
                return future.wait(PLAN_WAIT_POLL)
            except TimeoutError:
                # The future may have been responded since (or DURING)
                # the poll: re-read it rather than trusting this
                # TimeoutError, which is ambiguous between our poll
                # expiring, a respond() racing the poll's expiry, and a
                # RESPONDED result whose stored error is itself a
                # TimeoutError (re-raised instantly — treating that as
                # the poll would zero-sleep spin here forever).
                if future.done():
                    return future.wait(0)
                if not self.server.plan_queue.enabled():
                    raise RuntimeError(
                        "plan queue closed while awaiting plan result")

    # -- Planner seam ------------------------------------------------------
    def submit_plan(self, plan: Plan) -> tuple[PlanResult, Optional[object]]:
        plan.eval_token = self.eval_token
        if self._delivery_deadline and not plan.deadline:
            # Propagate: the applier drops this plan unverified once
            # the delivery's nack window has passed (expired_drops).
            plan.deadline = self._delivery_deadline
        future = self.server.plan_queue.enqueue(plan)
        result = self._wait_plan(future)
        state = None
        if result is not None and result.refresh_index > 0:
            # Stale scheduler data: catch up and hand back a fresh view.
            self._wait_for_index(result.refresh_index, RAFT_SYNC_LIMIT)
            state = self.server.fsm.state.snapshot()
        return result, state

    def update_eval(self, ev: Evaluation) -> None:
        self.server.apply_eval_update([ev], self.eval_token)

    def create_eval(self, ev: Evaluation) -> None:
        self.server.apply_eval_update([ev], self.eval_token)


class BatchWorker(Worker):
    """Drains ready evals in batches and fuses them on device."""

    def __init__(self, server, max_batch: int = 64) -> None:
        super().__init__(server, scheduler_override=None)
        self.max_batch = max_batch
        self._tokens: dict = {}
        # Evals its runners took one at a time after the fused rounds,
        # and the lanes they planned in a chained tail.
        self.solo_evals = 0
        self.chained_evals = 0

    # The fused device runner implements generic (service/batch) semantics;
    # system and _core evals go to the plain workers.
    DEVICE_QUEUES = ("service", "batch")

    def run(self) -> None:
        backoff = Backoff(base=BACKOFF_BASE, max_delay=BACKOFF_LIMIT,
                          jitter=0.5)
        while not self._stop.is_set():
            self._check_paused()
            queues = [q for q in self.server.enabled_schedulers()
                      if q in self.DEVICE_QUEUES]
            try:
                batch = self.server.eval_broker.dequeue_batch(
                    queues, self.max_batch,
                    timeout=0.25)
            except RuntimeError:
                if backoff.sleep(self._stop):
                    return
                continue
            backoff.reset()
            if not batch:
                continue
            tracer = trace_mod.tracer() if trace_mod.ENABLED else None
            if tracer is None:
                self._run_batch(batch, None)
                continue
            # One worker.batch span, dequeue to the last ack, parents
            # this thread's phase spans (obs/trace.py).
            window = tracer.open_window()
            runner = None
            try:
                runner = self._run_batch(batch, tracer, window["t0"])
            finally:
                tracer.close_window(
                    window, "worker.batch", lanes=len(batch),
                    rounds=runner.rounds_run if runner is not None else 0,
                    solo=runner.solo_evals if runner is not None else 0,
                    chained=runner.chained_evals
                    if runner is not None else 0)

    def _run_batch(self, batch: list, tracer, t_sync: float = 0.0):
        """Catch up, snapshot, run the fused batch and ack (or nack) it;
        traced, its ``worker.sync`` phase starts at ``t_sync`` and
        ``worker.ack`` covers the acks.  Returns the runner, None when
        the batch was nacked before it."""
        from nomad_tpu_torch.scheduler.batch import BatchEvalRunner

        self._delivery_deadline = time.monotonic() + \
            self.server.eval_broker.nack_timeout
        max_index = max(ev.modify_index for ev, _ in batch)
        try:
            self._wait_for_index(max_index, RAFT_SYNC_LIMIT)
            # ErrDeadlineExceeded is a TimeoutError: an expired
            # delivery nacks the batch below instead of burning a
            # whole fused device dispatch on redelivered work.
            self._check_delivery_live(batch[0][0])
        except TimeoutError:
            for ev, token in batch:
                try:
                    self.server.eval_broker.nack(ev.id, token)
                except ValueError:
                    pass
            if tracer is not None:
                tracer.phase("worker.sync", t_sync)
            return None

        self._tokens = {ev.id: token for ev, token in batch}
        state = self.server.fsm.state.snapshot()
        if tracer is not None:
            tracer.phase("worker.sync", t_sync)
        runner = BatchEvalRunner(
            state, _BatchPlanner(self),
            state_refresh=lambda: self.server.fsm.state.snapshot(),
            device=self.device)
        t_invoke = tracer.now() if tracer is not None else 0.0
        settle = self.server.eval_broker.ack
        try:
            runner.process([ev for ev, _ in batch])
        except Exception as e:
            logger.exception("batch worker: dispatch failed")
            self.failures += 1
            self.last_error = e
            settle = self.server.eval_broker.nack
        t_ack = tracer.phase_start() if tracer is not None else 0.0
        self.solo_evals += runner.solo_evals
        self.chained_evals += runner.chained_evals
        if tracer is not None:
            self._invoke_spans(tracer, batch, t_invoke)
        for ev, token in batch:
            try:
                settle(ev.id, token)
            except ValueError:
                pass
        if tracer is not None:
            tracer.phase("worker.ack", t_ack)
        return runner

    @staticmethod
    def _invoke_spans(tracer, batch: list, t0: float) -> None:
        """One ``worker.invoke`` span per eval of the fused batch, each
        sharing the batch's [t0, now] under the eval's anchor.  The JAX
        package's batch worker records none (only its plain worker
        does); here every eval's tree names the worker's share of it,
        whichever worker ran it."""
        dur = tracer.now() - t0
        for ev, _token in batch:
            if ev.trace:
                tracer.record("worker.invoke", t0, dur,
                              parent_ctx=ev.trace, eval_id=ev.id,
                              eval_type=ev.type, fused=len(batch))


class _BatchPlanner:
    """Planner seam for the batch runner: per-eval token stamping."""

    def __init__(self, worker: BatchWorker) -> None:
        self.worker = worker

    def submit_plan(self, plan: Plan):
        plan.eval_token = self.worker._tokens.get(plan.eval_id, "")
        self._stamp_deadline(plan)
        future = self.worker.server.plan_queue.enqueue(plan)
        return self._await(future)

    def _stamp_deadline(self, plan: Plan) -> None:
        deadline = self.worker._delivery_deadline
        if deadline and not plan.deadline:
            plan.deadline = deadline

    def submit_plans(self, plans: list) -> list:
        """Group submit: enqueue the whole window BEFORE waiting any
        future, so the leader's group-commit applier sees the window at
        once (one vectorized conflict pass + one raft apply) instead of
        one plan per pop.  Results come back in plan order.  EVERY
        enqueued future is drained before any error is re-raised: an
        abandoned in-flight future's plan can still commit, and raising
        early would hand the batch worker evals to nack whose plans are
        committing underneath it — the retries would double-place."""
        futures = []
        for plan in plans:
            plan.eval_token = self.worker._tokens.get(plan.eval_id, "")
            self._stamp_deadline(plan)
            try:
                futures.append(
                    self.worker.server.plan_queue.enqueue(plan))
            except Exception as e:
                futures.append(e)
        out = []
        first_err = None
        for future in futures:
            if isinstance(future, Exception):
                first_err = first_err or future
                continue
            try:
                out.append(self._await(future))
            except Exception as e:
                first_err = first_err or e
        if first_err is not None:
            # Same failure shape as the sequential path: the whole
            # batch surfaces one error (the worker nacks and the evals
            # re-reconcile) — but only after every submitted plan has
            # settled.
            raise first_err
        return out

    def _await(self, future):
        result = self.worker._wait_plan(future)
        state = None
        if result is not None and result.refresh_index > 0:
            self.worker._wait_for_index(result.refresh_index,
                                        RAFT_SYNC_LIMIT)
            state = self.worker.server.fsm.state.snapshot()
        return result, state

    def update_eval(self, ev: Evaluation) -> None:
        self.worker.server.apply_eval_update(
            [ev], self.worker._tokens.get(ev.id, ""))

    def create_eval(self, ev: Evaluation) -> None:
        self.worker.server.apply_eval_update(
            [ev], self.worker._tokens.get(ev.previous_eval, ""))
