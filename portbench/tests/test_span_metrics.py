"""The readers of the port's own spans (the batch worker's phases, raft,
the watch, the device spans) compute each metric from a synthetic span
list; each returns None where the program records none of its spans,
as the parent of these spans does, and when the tracer dropped spans."""
import pytest

import spec

N_REAL = 1000
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def span(name, t0, dur, **tags):
    s = {"name": name, "t0": t0, "dur": dur}
    if tags:
        s["tags"] = tags
    return s


def k4a_bytes():
    n, lanes, g, out_len = N_REAL, 2, 16, 16 * 64
    lane = 4 + 4 * n + g * (24 + 1 + 4 + n) + 8 * out_len + n * 24
    return 3 * n * 24 + lanes * lane


def k2_bytes(named, p=8):
    n = N_REAL
    return 3 * n * 24 + (4 * n + p + 4 * p + named * (n + 24 + 1) + 8 * p
                         + n * 24)


def recorded():
    # The window opens at 10.0 and lasts 1 s.  One batch of two evals:
    # round 0 fused, one lane retried in round 1 after a refresh, and
    # one eval retried alone; a second batch runs past the close.
    spans = [
        span("rpc.serve.Job.Register", 10.0, 0.004),
        span("worker.batch", 10.1, 0.5, lanes=2, rounds=2, solo=1),
        span("worker.sync", 10.1, 0.01),
        span("sched.begin", 10.11, 0.02, round=0),
        span("sched.begin", 10.13, 0.02, round=0),
        span("dispatch.stack", 10.15, 0.01),
        span("sched.dispatch", 10.15, 0.05, round=0, fused=2),
        span("sched.dispatch", 10.15, 0.05, round=0, fused=2),
        span("sched.refresh", 10.3, 0.01, round=1),
        span("sched.lanes", 10.31, 0.02, round=1),
        span("sched.begin", 10.31, 0.02, round=1),
        span("sched.dispatch", 10.33, 0.03, round=1),
        span("sched.solo", 10.4, 0.1, round=2),
        span("worker.batch", 10.9, 0.5, lanes=4, rounds=1, solo=0),
        span("raft.wait", 10.2, 0.002, msg_type=1, bytes=100),
        span("raft.entry", 10.202, 0.01, msg_type=1, bytes=100),
        span("raft.wait", 10.3, 0.004, msg_type=3, bytes=50),
        span("watch.notify", 10.21, 0.001, woken=3, table="evals"),
        span("watch.notify", 10.5, 0.001, woken=5, table="allocs"),
        # device spans: two uploads, a fetch, K4a and a K2 whose lane
        # names 3 groups, one upload running past the close
        span("device.put_counted", 10.16, 0.001, bytes=2_000_000,
             kind="h2d"),
        span("device.K4a", 10.17, 0.0001, n=1024, lanes=2, g=16, k_cap=64,
             rounds=1),
        span("device.copy_to_host_async", 10.171, 0.0001, bytes=500,
             kind="d2h"),
        span("device.K2", 10.18, 0.0002, n=1024, lanes=1, p=8, named=[3]),
        span("device.ensure_on_default", 10.999, 0.002, bytes=1_000_000,
             kind="h2d"),
    ]
    return dict(
        spans=spans, dropped=0, evals=4, window_s=1.0, device=[],
        n_real=N_REAL, hbm_bytes_per_s=3.35e12, latencies=[0.5],
        kernel_bytes={k: spec.kernel_bytes(k) for k in spec.kernel_names()},
        counters={"batches": 1, "batch_evals": 2, "h2d": 3,
                  "applier": {}})


EXPECTED = {
    # [10.1, 10.6] and [10.9, 11.0] of the window's second
    "worker_busy_pct": 100 * (0.5 + 0.1),
    # round 1's refresh, begin (its lanes stage and the eval's own
    # span, one interval) and dispatch, and the solo retry
    "retry_ms_per_eval": (0.01 + 0.02 + 0.03 + 0.1) * 1e3 / 4,
    "lanes_per_batch.spans": 3.0,
    "raft_wait_ms": 3.0,
    "wakes_per_eval": 8 / 4,
    "h2d_mb_per_eval": 3.0 / 4,
    # the last upload counts up to the close
    "device_idle_pct.spans": 100 * (1 - (0.001 + 0.0001 + 0.0001 + 0.0002
                                         + 0.001)),
    "kernel_ms_per_eval.spans": (0.0001 + 0.0002) * 1e3 / 4,
    "kernel_roofline_pct.spans": 100 * (k4a_bytes() + k2_bytes(3))
    / 3.35e12 / 0.0003,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_computes_from_the_ports_spans(name):
    got = spec.metric_reader(name)(recorded())
    assert got == pytest.approx(EXPECTED[name], rel=1e-6)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_of_a_program_without_the_spans_returns_none(name):
    ctx = recorded()
    ctx["spans"] = [s for s in ctx["spans"]
                    if s["name"].startswith(("rpc.", "sched.dispatch"))]
    for s in ctx["spans"]:
        s.pop("tags", None)
    assert spec.metric_reader(name)(ctx) is None
    assert spec.metric_reader(name)(dict(ctx, spans=[])) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_goes_silent_when_the_tracer_dropped_spans(name):
    assert spec.metric_reader(name)(dict(recorded(), dropped=1)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_is_listed_for_every_cell(name):
    (entry,) = [m for m in spec.benchmark()["per_layer"]
                if m["name"] == name]
    assert entry["moves"] == "evals_per_s"
    assert entry["workloads"] == CELLS
    assert entry["source"] == ("device_trace" if name.endswith(".spans")
                               and name.startswith(("device", "kernel"))
                               else "program_span")


def test_a_window_with_no_waiter_woken_reads_no_wakes():
    ctx = recorded()
    ctx["spans"] = [s for s in ctx["spans"] if s["name"] != "watch.notify"]
    assert spec.metric_reader("wakes_per_eval")(ctx) == 0.0
