"""Each per-layer metric reader computes its number from a recorded
span list and counters; a reader with nothing to read returns None."""
import pytest

import spec

BENCH = spec.benchmark()
N_REAL = 1000


def span(name, t0, dur, **tags):
    s = {"name": name, "t0": t0, "dur": dur}
    if tags:
        s["tags"] = tags
    return s


def recorded():
    # Two evals in one fused batch: the batch's dispatch and finish and
    # the group commit record one span a lane with shared times.
    spans = [
        span("rpc.serve.Job.Register", 0.0, 0.004),
        span("rpc.serve.Job.Register", 0.1, 0.006),
        span("broker.wait", 0.01, 0.2), span("broker.wait", 0.11, 0.1),
        span("sched.begin", 0.3, 0.01), span("sched.begin", 0.31, 0.01),
        span("sched.dispatch", 0.32, 0.02),
        span("sched.dispatch", 0.32, 0.02),
        span("sched.finish", 0.34, 0.04), span("sched.finish", 0.34, 0.04),
        span("applier.verify", 0.4, 0.002),
        span("applier.verify", 0.4, 0.002),
        span("raft.apply", 0.41, 0.05), span("raft.apply", 0.41, 0.05),
        span("fsm.decode", 0.42, 0.01), span("fsm.decode", 0.42, 0.01),
        span("store.upsert", 0.43, 0.02, n_allocs=40),
        span("store.upsert", 0.43, 0.02, n_allocs=40),
    ]
    shapes = dict(kernel="K4a", n=1024, lanes=2, g=16, k_cap=64, rounds=1)
    device = [("put_counted", "seam", 0.32, 0.3201, None),
              ("K4a", "kernel", 0.3202, 0.3203, shapes),
              ("copy_to_host_async", "seam", 0.3203, 0.3204, None)]
    return dict(
        spans=spans, dropped=0, evals=2, window_s=1.0, device=device,
        n_real=N_REAL, hbm_bytes_per_s=3.35e12, latencies=[0.5, 0.6],
        kernel_bytes={k: spec.kernel_bytes(k) for k in spec.kernel_names()},
        counters={"batches": 1, "batch_evals": 2, "h2d": 5,
                  "applier": {"conflict_fallbacks": 1}})


def k4a_bytes():
    n, lanes, g, out_len = N_REAL, 2, 16, 16 * 64
    lane = 4 + 4 * n + g * (24 + 1 + 4 + n) + 8 * out_len + n * 24
    return 3 * n * 24 + lanes * lane


EXPECTED = {
    "rpc_register_ms": 5.0,
    "broker_wait_ms": 150.0,
    "sched_ms_per_eval": (0.01 + 0.01 + 0.02 + 0.04) * 1e3 / 2,
    "lanes_per_batch": 2.0,
    "verify_ms_per_plan": 0.002 * 1e3 / 2,
    "fallbacks_per_eval": 0.5,
    "commit_ms_per_plan": 0.05 * 1e3 / 2,
    "fsm_ms_per_alloc": 0.03 * 1e3 / 80,
    "kernel_roofline_pct": 100 * k4a_bytes() / 3.35e12 / 0.0001,
    "kernel_ms_per_eval": 0.1 / 2,
    "device_idle_pct": 100 * (1 - 0.0003),
    "uploads_per_eval": 2.5,
    "eval_p95_ms.host": 595.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_computes_from_recorded_spans(name):
    got = spec.metric_reader(name)(recorded())
    assert got == pytest.approx(EXPECTED[name], rel=1e-6)


def test_every_listed_metric_has_a_reader():
    assert {m["name"] for m in BENCH["per_layer"]} <= set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_with_nothing_to_read_returns_none(name):
    ctx = dict(recorded(), spans=[], device=[], evals=0, latencies=[],
               counters={"batches": 0, "batch_evals": 0, "h2d": None,
                         "applier": {}})
    assert spec.metric_reader(name)(ctx) is None


def test_span_metrics_go_silent_when_the_tracer_dropped_spans():
    ctx = dict(recorded(), dropped=3)
    for name in ("rpc_register_ms", "broker_wait_ms", "sched_ms_per_eval",
                 "verify_ms_per_plan", "commit_ms_per_plan",
                 "fsm_ms_per_alloc"):
        assert spec.metric_reader(name)(ctx) is None
