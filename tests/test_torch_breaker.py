"""The port's device circuit breaker (nomad_tpu_torch/scheduler/breaker.py)
through its pipelined runner.

Twins of the breaker tests in tests/test_faultinject.py on
device="cpu", twice: faults injected by replacing
TorchBinPackScheduler.dispatch_device / collect_device for a counted
number of calls, and faults fired at the runner's ``device.dispatch``
and ``device.collect`` sites by a nomad_tpu_torch.faultinject plan, as
the JAX tests fire them.  Then what the port adds:
a kernel that fails to build raises from the runner's constructor and
never reaches the breaker, a run-time re-run (CPU only) is logged at
warning, and on a CUDA device a run-time failure or an open breaker
raises instead of moving the eval to the host.
Both packages read NOMAD_TPU_EXECUTOR; every test here sets it.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import pytest
import torch

import nomad_tpu.mock as jmock
from nomad_tpu_torch import convert, faultinject
from nomad_tpu_torch.faultinject import FaultInjected, FaultPlan
from nomad_tpu_torch.scheduler import Harness, TorchBinPackScheduler
from nomad_tpu_torch.scheduler.breaker import (
    ADMIT_DEVICE,
    ADMIT_HOST,
    ADMIT_PROBE,
    CLOSED,
    GLOBAL_BREAKER,
    HALF_OPEN,
    OPEN,
    DeviceCircuitBreaker,
)
from nomad_tpu_torch.scheduler.executor import executor_override
from nomad_tpu_torch.scheduler.pipeline import PipelinedEvalRunner, _Item
from nomad_tpu_torch.structs import (
    EVAL_TRIGGER_JOB_REGISTER,
    Evaluation,
    generate_uuid,
)

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)

CLEAN = {"opens": 0, "closes": 0, "probes": 0, "host_holds": 0,
         "failures": 0, "state": "closed"}


def _cluster(n_nodes: int, n_jobs: int):
    h = Harness(device="cpu")
    for n in convert.nodes_from_reference([jmock.node(i)
                                           for i in range(n_nodes)]):
        h.state.upsert_node(h.next_index(), n)
    jobs = convert.jobs_from_reference([jmock.job()
                                        for _ in range(n_jobs)])
    for j in jobs:
        h.state.upsert_job(h.next_index(), j)
    return h, jobs


def _make_eval(job):
    return Evaluation(id=generate_uuid(), priority=job.priority,
                      type=job.type,
                      triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                      job_id=job.id)


def _fault(monkeypatch, method: str, count: int = 1, hang: float = 0.0):
    """Make the next ``count`` calls of TorchBinPackScheduler.``method``
    fail (or, with ``hang``, sleep that long and then run).  Returns
    the call counter."""
    real = getattr(TorchBinPackScheduler, method)
    calls = {"n": 0, "faults": 0}

    def faulty(self, *a, **kw):
        calls["n"] += 1
        if calls["faults"] < count:
            calls["faults"] += 1
            if hang:
                time.sleep(hang)
            else:
                raise RuntimeError(f"injected {method} fault")
        return real(self, *a, **kw)
    monkeypatch.setattr(TorchBinPackScheduler, method, faulty)
    return calls


def _window(runner, jobs):
    """The front stage's steps inline for ``jobs``: one _Item each."""
    window = []
    for j in jobs:
        start = time.perf_counter()
        sched = runner._begin_eval(_make_eval(j), finish_noop=False)
        place, args = sched.deferred
        handles, probe = runner._dispatch(sched, args)
        window.append(_Item(sched, place, args, handles, start,
                            probe=probe))
    return window


class TestDeviceBreakerAtTheFaultSites:
    """The same cases with the fault fired at the runner's sites."""

    def test_dispatch_fault_trips_breaker_then_probe_closes(self):
        h, jobs = _cluster(8, 3)
        breaker = DeviceCircuitBreaker(failure_threshold=1, cooldown=30.0)
        plan = FaultPlan().add("device.dispatch", "error", count=1)
        with faultinject.injected(plan), executor_override("device"):
            r1 = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                     breaker=breaker, device="cpu")
            r1.process([_make_eval(j) for j in jobs[:2]])
            assert breaker.state == OPEN
            assert r1.breaker_reruns == 1
            assert breaker.stats()["opens"] == 1
            assert breaker.stats()["host_holds"] >= 1
            with breaker._lock:
                breaker._opened_at = -1e9
            r2 = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                     breaker=breaker,
                                     state_refresh=lambda:
                                     h.state.snapshot(), device="cpu")
            r2.process([_make_eval(jobs[2])])
            assert breaker.state == CLOSED
            assert breaker.stats()["probes"] == 1
            assert breaker.stats()["closes"] == 1
            assert r2.parity_checks == 1
        assert plan.fire_count("device.dispatch") == 1
        assert all(e.status == "complete" for e in h.evals)
        assert len(h.plans) == 3

    def test_collect_fault_reruns_on_host(self):
        h, jobs = _cluster(8, 3)
        breaker = DeviceCircuitBreaker(failure_threshold=2, cooldown=30.0)
        plan = FaultPlan().add("device.collect", "error", count=1)
        with executor_override("device"):
            runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=8,
                                         breaker=breaker, device="cpu")
            window = _window(runner, jobs)
            with faultinject.injected(plan):
                runner._drain_window(window)
        assert plan.fire_count("device.collect") == 1
        assert runner.breaker_reruns == 1
        assert breaker.stats()["failures"] == 1
        assert breaker.state == CLOSED
        assert all(e.status == "complete" for e in h.evals)
        assert len(h.plans) == 3

    def test_collect_deadline_breaks_hang(self):
        h, jobs = _cluster(8, 1)
        breaker = DeviceCircuitBreaker(failure_threshold=1, cooldown=30.0)
        plan = FaultPlan().add("device.collect", "hang", secs=1.5,
                               count=1)
        t0 = time.monotonic()
        with executor_override("device"):
            runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                         breaker=breaker,
                                         device_deadline=0.2,
                                         device="cpu")
            window = _window(runner, jobs)
            with faultinject.injected(plan):
                runner._drain_window(window)
            runner._stop_collect_worker()
        assert time.monotonic() - t0 < 1.2
        assert runner.breaker_reruns == 1
        assert breaker.state == OPEN
        assert all(e.status == "complete" for e in h.evals)

    @pytest.mark.parametrize("site", ["device.dispatch", "device.collect"])
    def test_on_a_card_a_device_failure_raises(self, site):
        """With ``host_reruns`` False (a CUDA runner's setting) a fault
        at either site is recorded with the breaker and raised; nothing
        moves to the host and no plan is submitted."""
        h, jobs = _cluster(8, 2)
        breaker = DeviceCircuitBreaker(failure_threshold=1, cooldown=30.0)
        plan = FaultPlan().add(site, "error", count=1)
        with faultinject.injected(plan), executor_override("device"):
            runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                         breaker=breaker, device="cpu")
            runner.host_reruns = False
            with pytest.raises(FaultInjected):
                runner.process([_make_eval(j) for j in jobs])
        assert breaker.stats()["failures"] == 1
        assert breaker.state == OPEN
        assert runner.breaker_reruns == 0
        assert runner.host_dispatches == 0
        assert h.plans == []


class TestDeviceBreaker:
    def test_dispatch_fault_trips_breaker_then_probe_closes(
            self, monkeypatch, caplog):
        """A dispatch fault: the eval re-runs on the host twin (and
        completes), the breaker opens and holds the next evals on the
        host, then a half-open probe is parity-checked and closes it.
        The re-run is logged at warning."""
        h, jobs = _cluster(8, 3)
        breaker = DeviceCircuitBreaker(failure_threshold=1, cooldown=30.0)
        _fault(monkeypatch, "dispatch_device")
        caplog.set_level(logging.WARNING,
                         logger="nomad_tpu_torch.scheduler.pipeline")
        with executor_override("device"):
            r1 = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                     breaker=breaker, device="cpu")
            r1.process([_make_eval(j) for j in jobs[:2]])
            assert breaker.state == OPEN
            assert r1.breaker_reruns == 1
            assert r1.host_dispatches == 2 and r1.device_dispatches == 0
            assert breaker.stats()["opens"] == 1
            assert breaker.stats()["host_holds"] >= 1
            assert any("device dispatch failed" in r.message
                       and r.levelno == logging.WARNING
                       for r in caplog.records)

            # The cooldown elapsed (faked): probe, parity, closed.
            with breaker._lock:
                breaker._opened_at = -1e9
            r2 = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                     breaker=breaker,
                                     state_refresh=lambda:
                                     h.state.snapshot(), device="cpu")
            r2.process([_make_eval(jobs[2])])
            assert breaker.state == CLOSED
            assert breaker.stats()["probes"] == 1
            assert breaker.stats()["closes"] == 1
            assert r2.parity_checks == 1
        assert all(e.status == "complete" for e in h.evals)
        assert len(h.plans) == 3

    def test_collect_fault_reruns_on_host(self, monkeypatch):
        """A collect fault mid-window: the drain re-runs that eval on
        the host twin; plans still land, the breaker records it."""
        h, jobs = _cluster(8, 3)
        breaker = DeviceCircuitBreaker(failure_threshold=2, cooldown=30.0)
        with executor_override("device"):
            runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=8,
                                         breaker=breaker, device="cpu")
            window = _window(runner, jobs)
            calls = _fault(monkeypatch, "collect_device")
            runner._drain_window(window)
        assert calls["faults"] == 1
        assert runner.breaker_reruns == 1
        assert breaker.stats()["failures"] == 1
        assert breaker.state == CLOSED  # threshold 2, one failure
        assert all(e.status == "complete" for e in h.evals)
        assert len(h.plans) == 3

    def test_collect_deadline_breaks_hang(self, monkeypatch):
        """A hung collect is cut off by the watchdog deadline and re-run
        on the host."""
        h, jobs = _cluster(8, 1)
        breaker = DeviceCircuitBreaker(failure_threshold=1, cooldown=30.0)
        t0 = time.monotonic()
        with executor_override("device"):
            runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                         breaker=breaker,
                                         device_deadline=0.2,
                                         device="cpu")
            window = _window(runner, jobs)
            _fault(monkeypatch, "collect_device", hang=1.5)
            runner._drain_window(window)
            runner._stop_collect_worker()
        # The watchdog cut the hang off well before its 1.5 s.
        assert time.monotonic() - t0 < 1.2
        assert runner.breaker_reruns == 1
        assert breaker.state == OPEN
        assert all(e.status == "complete" for e in h.evals)

    @pytest.mark.parametrize("method", ["dispatch_device",
                                        "collect_device"])
    def test_on_a_card_a_device_failure_raises(self, monkeypatch, method):
        """On a CUDA device (``host_reruns`` False, as the constructor
        sets it there) a failed dispatch or collect is recorded with the
        breaker and raised from process: nothing re-runs on the host
        and no plan is submitted."""
        h, jobs = _cluster(8, 2)
        breaker = DeviceCircuitBreaker(failure_threshold=1, cooldown=30.0)
        with executor_override("device"):
            runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                         breaker=breaker, device="cpu")
            runner.host_reruns = False
            _fault(monkeypatch, method)
            with pytest.raises(RuntimeError,
                               match=f"injected {method} fault"):
                runner.process([_make_eval(j) for j in jobs])
        assert breaker.stats()["failures"] == 1
        assert breaker.state == OPEN
        assert runner.breaker_reruns == 0
        assert runner.host_dispatches == 0
        assert h.plans == []

    def test_on_a_card_an_open_breaker_raises(self):
        """An open breaker holds nothing on the host for a runner on a
        CUDA device: its next dispatch raises."""
        h, jobs = _cluster(8, 1)
        breaker = DeviceCircuitBreaker(failure_threshold=1, cooldown=30.0)
        breaker.record_failure()
        with executor_override("device"):
            runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                         breaker=breaker, device="cpu")
            runner.host_reruns = False
            with pytest.raises(RuntimeError,
                               match="circuit breaker is open"):
                runner.process([_make_eval(jobs[0])])
        assert runner.host_dispatches == 0
        assert h.plans == []

    def test_on_a_card_evals_behind_a_probe_ride_the_card(self):
        """Half-open on a CUDA device: the probe and the evals admitted
        while it is in flight all go to the card; the probe's parity
        check closes the breaker."""
        h, jobs = _cluster(8, 3)
        breaker = DeviceCircuitBreaker(failure_threshold=1, cooldown=0.0)
        breaker.record_failure()  # open; the next admission is a probe
        with executor_override("device"):
            runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=8,
                                         breaker=breaker, device="cpu")
            runner.host_reruns = False
            window = _window(runner, jobs)
            assert [it.probe for it in window] == [True, False, False]
            assert breaker.state == HALF_OPEN
            assert not any(it.sched.dispatched_host for it in window)
            runner._drain_window(window)
        assert breaker.state == CLOSED
        assert runner.parity_checks == 1
        assert all(e.status == "complete" for e in h.evals)

    def test_breaker_state_machine_with_fake_clock(self):
        now = [0.0]
        b = DeviceCircuitBreaker(failure_threshold=2, cooldown=10.0,
                                 clock=lambda: now[0])
        assert b.admit() == ADMIT_DEVICE
        b.record_failure()
        assert b.state == CLOSED          # below threshold
        b.record_success()                # success resets the streak
        b.record_failure()
        b.record_failure()
        assert b.state == OPEN            # threshold consecutive
        assert b.admit() == ADMIT_HOST    # held during cooldown
        now[0] += 10.0
        assert b.admit() == ADMIT_PROBE   # cooldown elapsed
        assert b.state == HALF_OPEN
        assert b.admit() == ADMIT_HOST    # one probe in flight at a time
        b.record_failure(probe=True)      # probe failed: re-open
        assert b.state == OPEN
        now[0] += 10.0
        assert b.admit() == ADMIT_PROBE
        b.record_success(probe=True)
        assert b.state == CLOSED
        stats = b.stats()
        assert stats["opens"] == 2 and stats["closes"] == 1
        assert stats["probes"] == 2 and stats["host_holds"] == 2
        b.reset()
        assert b.stats() == CLEAN
        with pytest.raises(ValueError):
            DeviceCircuitBreaker(failure_threshold=0)

    def test_lost_probe_outcome_reprobes_after_timeout(self):
        """A probe whose outcome is never recorded must not pin the
        breaker half-open-on-host forever: past probe_timeout a fresh
        probe is issued."""
        now = [0.0]
        b = DeviceCircuitBreaker(failure_threshold=1, cooldown=1.0,
                                 probe_timeout=5.0,
                                 clock=lambda: now[0])
        b.record_failure()           # open
        now[0] += 1.0
        assert b.admit() == ADMIT_PROBE
        # ... the probe item is lost: no outcome ever recorded ...
        now[0] += 4.0
        assert b.admit() == ADMIT_HOST    # not yet presumed lost
        now[0] += 1.5
        assert b.admit() == ADMIT_PROBE   # presumed lost: re-probe
        b.record_success(probe=True)
        assert b.state == CLOSED

    def test_probe_parity_mismatch_fails_loudly_and_reopens(self):
        """A probe whose device result disagrees with the host twin
        raises (never silently closes the breaker) and re-opens it."""
        h, jobs = _cluster(8, 1)
        breaker = DeviceCircuitBreaker(failure_threshold=1, cooldown=0.0)
        breaker.record_failure()  # open; the next admission is a probe

        class _CorruptHostTwin(PipelinedEvalRunner):
            def _host_rerun(self, it):
                chosen, scores = super()._host_rerun(it)
                return np.asarray(chosen) + 1, scores  # disagree

        with executor_override("device"):
            runner = _CorruptHostTwin(h.state.snapshot(), h, depth=2,
                                      breaker=breaker, device="cpu")
            with pytest.raises(RuntimeError, match="parity violation"):
                runner.process([_make_eval(jobs[0])])
        assert breaker.state == OPEN  # the probe's failure re-opened it
        assert runner.parity_checks == 0

    def test_pipeline_unaffected_without_faults(self):
        """No fault, forced device: the breaker stays closed and the
        counts stay clean."""
        h, jobs = _cluster(8, 3)
        breaker = DeviceCircuitBreaker()
        with executor_override("device"):
            runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                         breaker=breaker, device="cpu")
            runner.process([_make_eval(j) for j in jobs])
        assert breaker.stats() == CLEAN
        assert runner.breaker_reruns == 0
        assert runner.device_dispatches == len(jobs)
        assert runner.host_dispatches == 0
        assert all(e.status == "complete" for e in h.evals)

    def test_host_decisions_never_touch_the_breaker(self):
        """auto/host keeping an eval on the host is a cost decision made
        before the dispatch: the breaker is never asked, nothing is
        re-run."""
        h, jobs = _cluster(8, 3)
        breaker = DeviceCircuitBreaker()
        with executor_override("host"):
            runner = PipelinedEvalRunner(h.state.snapshot(), h, depth=2,
                                         breaker=breaker, device="cpu")
            runner.process([_make_eval(j) for j in jobs])
        assert breaker.stats() == CLEAN
        assert runner.host_dispatches == len(jobs)
        assert runner.breaker_reruns == 0

    def test_runners_share_the_global_breaker_by_default(self):
        h, _ = _cluster(4, 0)
        runner = PipelinedEvalRunner(h.state.snapshot(), h, device="cpu")
        assert runner.breaker is GLOBAL_BREAKER


def _fake_card(monkeypatch):
    """torch on the CPU made to resolve ``cuda`` (no tensor ever goes
    there: the constructor fails first)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def test_a_failed_kernel_build_raises_from_the_constructor(monkeypatch,
                                                           tmp_path):
    """On a CUDA device the runner builds the kernels it launches: a
    compiler that fails raises there, before any dispatch, and the
    breaker never sees it."""
    from nomad_tpu_torch.ops import kernels

    h, _ = _cluster(4, 0)
    snap = h.state.snapshot()
    _fake_card(monkeypatch)
    failing = tmp_path / "nvcc"
    failing.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\n"
                       "exit 1\n")
    failing.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD", tmp_path / "build")
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(failing))
    breaker = DeviceCircuitBreaker()
    for executor in ("host", "device", "auto"):
        with executor_override(executor):
            with pytest.raises(RuntimeError,
                               match="CUDA kernel build failed"):
                PipelinedEvalRunner(snap, h, breaker=breaker,
                                    device="cuda")
    assert breaker.stats() == CLEAN


def test_the_constructor_builds_only_on_a_card(monkeypatch):
    from nomad_tpu_torch.ops import kernels

    built = []
    monkeypatch.setattr(kernels, "library", lambda name: built.append(name))
    h, _ = _cluster(4, 0)
    assert PipelinedEvalRunner(h.state.snapshot(), h,
                               device="cpu").host_reruns
    assert built == []
    _fake_card(monkeypatch)
    assert not PipelinedEvalRunner(h.state.snapshot(), h,
                                   device="cuda").host_reruns
    assert built == ["binpack", "scatter_rows"]
