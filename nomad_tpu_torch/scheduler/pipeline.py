"""Staged eval pipeline: overlap the card's work with both host stages.

Counterpart of ``nomad_tpu/scheduler/pipeline.py``.  A strictly
sequential eval loop pays, per eval, prep -> uploads + launch -> wait
for the kernel and the result copy -> finish -> submit.  This runner
splits the eval into two host stages on two threads, with up to
``depth`` dispatches in flight between them:

  front stage (caller thread)   drain stage (worker thread)
  ---------------------------   ------------------------------------
  reconcile + prep (begin)      collect results (waits on each
  dispatch (non-blocking:         dispatch's CUDA event, GIL released)
    launch + async d2h copy)    native bulk finish + Python tail
  enqueue -> bounded window --> plan submit (FIFO = eval order)

While eval N's kernel runs and its results come back, and while its
finish and submit run, evals N+1..N+depth are reconciled, prepped and
dispatched, so throughput is bound by the slower host stage, not by
the sum of the stages.

Both threads launch on the device's default stream (a new thread
starts on it, and nothing here switches streams), so their work is
ordered on the card: a K5 scatter of the mirror (models/fleet.py,
launched under the mirror lock by whichever thread syncs it) can never
overtake a K2/K3 launch that still reads the old usage buffer, and K5
writes a NEW buffer anyway.  The pinned staging buffers
(parallel/devices.py ``PinnedStaging``) are per thread; each result
fetch (``copy_to_host_async``) has its own pinned tensor and event.

Host-floor amortization: the drain stage pulls EVERY queued eval it can
and finishes them as one window: one uuid slab and one native call
(csrc/port_alloc.cpp ``bulk_finish_many``) cover the whole window
(BatchEvalRunner._finish_lanes).  Dispatch constants (asks, feasibility,
the mirror's usage copy) stay resident across the window
(DeviceArgs.dev_const and the statics' device cache).

Ordering guarantees, as in the single-threaded runner: per-job
serialization (one in-flight eval per job per round, leftovers run
after a ``state_refresh``) and plan-commit ordering (the drain stage
submits strictly in eval order; placement-less plans route through it
too).

Executor and failures: every dispatch goes through the executor policy
(``choose_host_executor(args, pipelined=True)``, a cost decision made
before the dispatch) and then the device circuit breaker
(scheduler/breaker.py).  The CUDA kernels are built when a runner is
constructed on a CUDA device, so a failed build raises there and never
reaches the breaker.  The ``device.dispatch`` and ``device.collect``
fault sites (nomad_tpu_torch/faultinject) fire where the JAX runner
fires them: just before each device dispatch and inside each device
collect.  On a CUDA device a dispatch or collect that fails
at run time is recorded with the breaker and raised: the stream fails,
and no walk meant for the card moves to the host (an open breaker
raises too).  On the CPU, where the "device" walks are the kernels'
plain versions, the reference's recovery stays: the failure is logged
at warning, counted in ``breaker_reruns`` and the eval re-run on the
host twin, and an open breaker holds later evals on the host.  The
half-open probe runs on the device, is checked against the host twin
and raises on a mismatch.

Use BatchEvalRunner (scheduler/batch.py) when a whole batch is
available up front and shapes are homogeneous: one fused launch beats
a pipeline.  Use PipelinedEvalRunner for streams: heterogeneous shapes,
latency-sensitive arrivals, or plans that must commit between evals.
"""
from __future__ import annotations

import logging
import queue
import threading
import time

import numpy as np

from nomad_tpu_torch import faultinject

from .batch import BatchEvalRunner, _lane_spans, _tnow
from .breaker import ADMIT_HOST, ADMIT_PROBE, GLOBAL_BREAKER, HALF_OPEN

logger = logging.getLogger("nomad_tpu_torch.scheduler.pipeline")

_STOP = object()

# The CUDA libraries a pipelined stream launches: K2/K3 (binpack) from
# the front stage, K5 (scatter_rows) wherever the mirror syncs.
PIPELINE_LIBRARIES = ("binpack", "scatter_rows")


def same_walk(a: tuple, b: tuple) -> bool:
    """Do two collected walks ((chosen, scores) per placement) plan the
    same?  Chosen nodes exactly; scores (allclose) where a node was
    chosen.  A step that places nothing is not part of a plan, and its
    score differs by design: the kernels score every step (as the JAX
    scans do), the host twins leave 0 there."""
    chosen_a, chosen_b = np.asarray(a[0]), np.asarray(b[0])
    if not np.array_equal(chosen_a, chosen_b):
        return False
    placed = chosen_a >= 0
    return bool(np.allclose(
        np.asarray(a[1], dtype=np.float64)[placed],
        np.asarray(b[1], dtype=np.float64)[placed]))


class _CollectWorker:
    """Long-lived watchdog worker for deadline-bounded collects.

    The drain stage feeds it one callable at a time via ``inq`` and
    waits on ``outq`` with the deadline; a ``None`` on ``inq`` exits
    the thread.  The runner replaces the worker after a timeout: a hung
    wait cannot be interrupted, so the old worker keeps its references
    only until that call returns, then sees the sentinel and ends.
    """

    def __init__(self) -> None:
        self.inq: queue.Queue = queue.Queue()
        self.outq: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="device-collect")
        self.thread.start()

    def _run(self) -> None:
        while True:
            # faultlint-ok(unbounded-wait): idle watchdog-worker
            # parking — exit rides the None sentinel; the collect
            # DEADLINE lives on the outq.get in
            # _collect_device_bounded, not here.
            fn = self.inq.get()
            if fn is None:
                return
            try:
                self.outq.put((True, fn()))
            except BaseException as e:
                self.outq.put((False, e))

    def join(self, timeout: "float | None" = None) -> None:
        """Reap after the exit sentinel.  Only the clean shutdown joins;
        an abandoned (hung) worker ends on its own when its call
        returns."""
        self.thread.join(timeout)


class _Item:
    """One eval moving front -> drain.  ``handles`` is None for
    placement-less plans (submit-only).  ``probe`` marks the breaker's
    half-open probe: the drain stage re-runs it on the host twin and
    checks parity before closing the breaker."""

    __slots__ = ("sched", "place", "args", "handles", "start", "probe")

    def __init__(self, sched, place, args, handles, start,
                 probe: bool = False) -> None:
        self.sched = sched
        self.place = place
        self.args = args
        self.handles = handles
        self.start = start
        self.probe = probe


class PipelinedEvalRunner(BatchEvalRunner):
    """Processes a list of evaluations with up to ``depth`` dispatches in
    flight and the two host stages overlapped.

    Inherits the batch runner's per-job serialization, status handling
    and submit/retry logic.  Unlike the batch runner, every eval gets
    its own dispatch, so evals whose plans already carry deltas
    (migrations, in-place updates) pipeline like any other.

    ``latencies`` records per-eval wall seconds (begin -> plan
    submitted).  ``stage_times`` accumulates per-stage wall seconds
    (begin/dispatch/collect/finish/submit) across the run.
    ``host_dispatches`` / ``device_dispatches`` count which executor
    each dispatch used (scheduler/executor.py), ``sharded_dispatches``
    the device dispatches that ran on a mesh; ``windows`` lists the
    drained window sizes.

    ``device`` is where the schedulers compute: ``None`` means ``cuda``
    (``RuntimeError`` when no CUDA device is present, whatever the
    executor policy).  On a CUDA device the kernels are built here, so
    a failed build raises from the constructor, and a device failure at
    run time raises from ``process`` (``host_reruns`` is False).
    """

    def __init__(self, state, planner, depth: int = 4,
                 state_refresh=None, breaker=None,
                 device_deadline: "float | None" = None,
                 device=None) -> None:
        super().__init__(state, planner, state_refresh=state_refresh,
                         device=device)
        if self.device.type == "cuda":
            from nomad_tpu_torch.ops import kernels

            for name in PIPELINE_LIBRARIES:
                kernels.library(name)
        self.depth = max(1, depth)
        self.latencies: list[float] = []
        self.stage_times = {"begin": 0.0, "dispatch": 0.0, "collect": 0.0,
                            "finish": 0.0, "submit": 0.0}
        self.host_dispatches = 0
        self.device_dispatches = 0
        # Device dispatches that ran node-axis-sharded over a mesh
        # (parallel/mesh.dispatch_mesh resolved one).
        self.sharded_dispatches = 0
        self.windows: list[int] = []  # drained-window sizes
        # Device-executor circuit breaker (scheduler/breaker.py), shared
        # process-wide by default: device health is a machine property.
        self.breaker = breaker if breaker is not None else GLOBAL_BREAKER
        # Optional per-collect watchdog (seconds): None = no watchdog
        # thread (only raised errors trip the breaker).
        self.device_deadline = device_deadline
        # Evals re-run on the host after a device failure.  One
        # producer (_record_rerun, called from both stages under
        # _count_lock).
        self.breaker_reruns = 0
        # Whether a device failure may re-run its eval on the host twin:
        # only where the device walks are the plain versions (CPU).
        self.host_reruns = self.device.type != "cuda"
        self._count_lock = threading.Lock()
        # Dispatch/collect wall EWMA (seconds; device dispatches only),
        # fed by both threads under _count_lock.
        self._rtt_ewma = 0.0
        # Live in-flight gate: ``depth`` may change mid-stream, so the
        # bound is this counter + condition rather than a queue's
        # fixed maxsize.
        self._inflight = 0
        self._inflight_cond = threading.Condition(threading.Lock())
        self.parity_checks = 0    # probe evals checked host vs device
        # Lazy watchdog worker for deadline-bounded collects (drain
        # thread only; replaced after a timeout).
        self._collect_worker: "_CollectWorker | None" = None
        self._err_lock = threading.Lock()
        self._drain_err: BaseException | None = None
        # Registry provider (obs/registry.py): the LIVE runner's stats
        # under nomad.runner.* — replace-on-name keeps exactly one, and
        # the weakref means a retired runner is never pinned (its state
        # snapshot is a whole store generation) just to serve metrics.
        import weakref

        from nomad_tpu_torch.obs import REGISTRY
        ref = weakref.ref(self)
        REGISTRY.register(
            "runner",
            lambda: (lambda r: r.stats() if r is not None else {})(
                ref()))

    def process(self, evals: list) -> None:
        from nomad_tpu_torch.utils.gctune import gc_pause

        with gc_pause():
            self._process_staged(evals)

    # -- front stage ------------------------------------------------------
    def _process_staged(self, evals: list) -> None:
        this_round, leftovers = self._split_rounds(evals)
        q: queue.Queue = queue.Queue()
        drain = threading.Thread(target=self._drain_loop, args=(q,),
                                 name="eval-pipeline-drain", daemon=True)
        drain.start()
        times = self.stage_times
        try:
            for ev in this_round:
                if self._failed():
                    break
                start = time.perf_counter()
                sched = self._begin_eval(ev, finish_noop=False)
                t_begin = time.perf_counter()
                times["begin"] += t_begin - start
                if sched is None:
                    # Terminal without a plan (bad trigger/status error):
                    # nothing to submit, latency is begin time alone.
                    self.latencies.append(t_begin - start)
                    continue
                if sched.deferred is None:
                    # Placement-less plan: submit-only item, routed
                    # through the drain stage to keep commit order.
                    self._admit_inflight()
                    q.put(_Item(sched, None, None, None, start))
                    continue
                # The permit is held until the drain consumes the item;
                # if anything raises before the put, release it (a
                # leaked permit would shrink every later stream's
                # effective depth).
                self._admit_inflight()
                try:
                    place, args = sched.deferred
                    t_disp = _tnow()
                    handles, probe = self._dispatch(sched, args)
                    if sched.dispatched_host:
                        self.host_dispatches += 1
                    else:
                        self.device_dispatches += 1
                        if sched.dispatched_sharded:
                            self.sharded_dispatches += 1
                        self._note_rtt(time.perf_counter() - t_begin)
                    _lane_spans("sched.dispatch", [sched], t_disp,
                                _tnow(), host=sched.dispatched_host)
                    times["dispatch"] += time.perf_counter() - t_begin
                    q.put(_Item(sched, place, args, handles, start,
                                probe=probe))
                except BaseException:
                    self._release_inflight()
                    raise
        finally:
            q.put(_STOP)
            drain.join()
            self._stop_collect_worker()
        with self._err_lock:
            err = self._drain_err
        if err is not None:
            raise err
        if leftovers:
            self._process_leftovers(leftovers)

    def _failed(self) -> bool:
        with self._err_lock:
            return self._drain_err is not None

    def _dispatch(self, sched, args) -> tuple:
        """Route one eval's dispatch through the executor policy AND the
        circuit breaker.  Returns (handles, probe): evals the policy
        keeps on the host run the host twin (identical plans by
        construction); a half-open probe runs on the device and is
        parity-checked in the drain stage.  A dispatch that raises, or
        an open breaker, raises on a card (evals behind a card's probe
        go to the card); on the CPU the eval runs on the host twin
        instead (logged and counted)."""
        if sched.choose_host_executor(args, pipelined=True):
            sched.dispatched_host = True
            return sched.dispatch_host(args), False
        admit = self.breaker.admit()
        if admit == ADMIT_HOST:
            if self.host_reruns:
                sched.dispatched_host = True
                return sched.dispatch_host(args), False
            if self.breaker.state != HALF_OPEN:
                raise RuntimeError(
                    f"device circuit breaker is {self.breaker.state} after "
                    f"a device failure: {self.breaker.stats()}")
            # On a card, evals behind an in-flight probe ride the card.
        probe = admit == ADMIT_PROBE
        try:
            if faultinject.ACTIVE:
                faultinject.fire("device.dispatch")
            # force=True: the executor decision was made above (policy
            # + breaker); re-deciding it inside dispatch_device could
            # route a half-open probe to the host twin and orphan it.
            return sched.dispatch_device(args, pipelined=True,
                                         force=True), probe
        except Exception:
            self.breaker.record_failure(probe=probe)
            if not self.host_reruns:
                raise
            logger.warning("device dispatch failed; re-running eval on "
                           "the host twin", exc_info=True)
            self._record_rerun()
            sched.dispatched_host = True
            return sched.dispatch_host(args), False

    def _record_rerun(self) -> None:
        """The single producer of ``breaker_reruns`` (front stage on
        dispatch faults, drain stage on collect faults)."""
        with self._count_lock:
            self.breaker_reruns += 1

    def _note_rtt(self, seconds: float) -> None:
        """Feed one device dispatch/collect wall sample into the EWMA."""
        with self._count_lock:
            prev = self._rtt_ewma
            self._rtt_ewma = seconds if prev <= 0.0 \
                else 0.8 * prev + 0.2 * seconds

    def _admit_inflight(self) -> None:
        """Block until the in-flight window has room under the live
        ``depth`` (re-read each pass).  A dead drain stage still admits:
        the front loop notices ``_failed()`` and stops, and the teardown
        put must never deadlock behind a gate nobody will drain."""
        while True:
            bound = max(1, int(self.depth))
            with self._inflight_cond:
                if self._inflight < bound:
                    self._inflight += 1
                    return
                self._inflight_cond.wait(0.05)
            if self._failed():
                with self._inflight_cond:
                    self._inflight += 1
                return

    def _release_inflight(self) -> None:
        with self._inflight_cond:
            self._inflight -= 1
            self._inflight_cond.notify_all()

    def stats(self) -> dict:
        """The runner's dispatch mix, stage walls, windows and breaker
        interactions."""
        with self._count_lock:
            reruns = self.breaker_reruns
            rtt_ewma = self._rtt_ewma
        dispatches = self.host_dispatches + self.device_dispatches
        return {
            "host_dispatches": self.host_dispatches,
            "device_dispatches": self.device_dispatches,
            "sharded_dispatches": self.sharded_dispatches,
            "depth": self.depth,
            "device_fraction": self.device_dispatches / dispatches
            if dispatches else 0.0,
            "rtt_ms_ewma": rtt_ewma * 1000.0,
            "breaker_reruns": reruns,
            "parity_checks": self.parity_checks,
            "evals": len(self.latencies),
            "windows": len(self.windows),
            "stage_times_ms": {k: v * 1000.0
                               for k, v in self.stage_times.items()},
        }

    # -- drain stage ------------------------------------------------------
    def _drain_loop(self, q: queue.Queue) -> None:
        stop_seen = False
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    return
                self._release_inflight()
                window = [item]
                # Opportunistic window: everything already queued drains
                # as ONE batch (shared uuid slab, one native call).
                while True:
                    try:
                        nxt = q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _STOP:
                        stop_seen = True
                        break
                    self._release_inflight()
                    window.append(nxt)
                self._drain_window(window)
                if stop_seen:
                    return
        except BaseException as e:
            with self._err_lock:
                self._drain_err = e
            # Keep consuming so the front stage never deadlocks on a
            # full window; items are discarded (their evals get no
            # status: the front stops and the error propagates).  If
            # the window gather already took the sentinel there is
            # nothing left to wait for.
            if not stop_seen:
                while q.get() is not _STOP:
                    self._release_inflight()

    def _drain_window(self, window: list) -> None:
        times = self.stage_times
        self.windows.append(len(window))

        # 1) collect: wait on each dispatch's results, FIFO.  The result
        # copies were started at dispatch (copy_to_host_async), so
        # waiting on eval N overlaps N+1's kernel and copy too.  A
        # collect that fails or blows the deadline trips the breaker and
        # raises on a card; on the CPU it re-runs on the host twin (the
        # window keeps draining).
        t0 = time.perf_counter()
        work = [it for it in window if it.handles is not None]
        results = {}
        for it in work:
            t_col = _tnow()
            results[id(it)] = self._collect_item(it)
            _lane_spans("sched.collect", [it.sched], t_col, _tnow())
        t1 = time.perf_counter()
        times["collect"] += t1 - t0

        # 2) finish: the shared windowed finish (one uuid slab + one
        # native call + Python tails; BatchEvalRunner._finish_lanes).
        self._finish_lanes([(it.sched, it.place, it.args)
                            + tuple(results[id(it)]) for it in work])
        t2 = time.perf_counter()
        times["finish"] += t2 - t1

        # 3) submit, strictly in eval order (noop items at their own
        # position), as ONE group through the planner's window path
        # when it has one.
        self._submit_window([it.sched for it in window])
        now = time.perf_counter()
        for it in window:
            self.latencies.append(now - it.start)
        times["submit"] += now - t2

    # -- device failure handling (breaker) ---------------------------------
    def _collect_item(self, it: _Item) -> tuple:
        """Collect one item's results, routing device outcomes through
        the circuit breaker.  Probe items also run the host twin and
        must match it before the breaker closes."""
        sched = it.sched
        if sched.dispatched_host:
            # faultlint-ok(uninjectable-io): host-lane collect (the
            # work never went to the device: its results are ready numpy
            # arrays); the device seam consults device.collect in
            # _collect_device_bounded.
            return sched.collect_device(it.args, it.handles)
        try:
            t_col = time.perf_counter()
            res = self._collect_device_bounded(it)
            self._note_rtt(time.perf_counter() - t_col)
        except Exception as e:
            self.breaker.record_failure(probe=it.probe)
            if not self.host_reruns:
                raise
            logger.warning("device collect failed (%s); re-running eval "
                           "on the host twin", e)
            self._record_rerun()
            return self._host_rerun(it)
        if it.probe:
            # Identical by construction (tests/test_torch_executor.py);
            # a mismatch means the device path corrupts plans and MUST
            # fail loudly: an explicit raise (not an assert, which -O
            # strips), so the probe never closes the breaker unverified.
            if not same_walk(res, self._host_rerun(it)):
                self.breaker.record_failure(probe=it.probe)
                raise RuntimeError(
                    "device/host parity violation on breaker probe")
            self.parity_checks += 1
            self.breaker.record_success(probe=True)
            return res
        self.breaker.record_success()
        return res

    def _collect_device_bounded(self, it: _Item) -> tuple:
        """Device collect with the optional watchdog deadline: a hung
        collect raises TimeoutError.  One long-lived worker is reused
        across collects and replaced only after a timeout; the abandoned
        worker finishes its hung call whenever the device returns, then
        exits via the sentinel."""
        def _collect():
            if faultinject.ACTIVE:
                faultinject.fire("device.collect")
            return it.sched.collect_device(it.args, it.handles)

        if self.device_deadline is None:
            return _collect()
        worker = self._collect_worker
        if worker is None:
            worker = self._collect_worker = _CollectWorker()
        worker.inq.put(_collect)
        try:
            ok, val = worker.outq.get(timeout=self.device_deadline)
        except queue.Empty:
            # Hung: abandon this worker (its queues go with it, so the
            # stale result can never be taken for a later eval's) and
            # tell it to exit once the call finally returns.
            self._collect_worker = None
            worker.inq.put(None)
            raise TimeoutError(
                f"device collect exceeded deadline "
                f"({self.device_deadline}s)") from None
        if not ok:
            raise val
        return val

    def _stop_collect_worker(self) -> None:
        worker = self._collect_worker
        if worker is not None:
            self._collect_worker = None
            worker.inq.put(None)
            worker.join(2.0)

    def _host_rerun(self, it: _Item) -> tuple:
        """Run one eval's placement walk on the host twin (a CPU
        runner's recovery, and the probe's parity check)."""
        handles = it.sched.dispatch_host(it.args)
        # faultlint-ok(uninjectable-io): host-twin rerun AFTER a device
        # fault — injecting here would fault the very fallback the
        # breaker depends on.
        return it.sched.collect_device(it.args, handles)
