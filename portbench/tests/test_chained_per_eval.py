"""The ``chained_per_eval`` reader (the scheduler's chained tail): the
sum of the ``chained`` tags of the batch worker's ``worker.batch`` spans
over the window's completed evals, computed from a synthetic span list;
None where the program tags no ``worker.batch`` with ``chained``, as
the parent of the tail does, and when the tracer dropped spans."""
import pytest

import spec

NAME = "chained_per_eval"
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def span(name, t0, dur, **tags):
    s = {"name": name, "t0": t0, "dur": dur}
    if tags:
        s["tags"] = tags
    return s


def recorded(chained=(3, 0, 5)):
    # Three batches in the window's second: the first chained three of
    # its stragglers, the second had none, the third five.
    tags = [dict(lanes=40, rounds=2, solo=0), dict(lanes=12, rounds=1,
                                                  solo=0),
            dict(lanes=50, rounds=2, solo=1)]
    spans = [span("rpc.serve.Job.Register", 10.0, 0.004),
             span("sched.dispatch", 10.2, 0.01, round=2, chained=3)]
    for i, (t, c) in enumerate(zip(tags, chained)):
        if c is not None:
            t = dict(t, chained=c)
        spans.append(span("worker.batch", 10.1 + 0.3 * i, 0.25, **t))
    return dict(spans=spans, dropped=0, evals=16, window_s=1.0, device=[],
                counters={"batches": 3, "batch_evals": 102, "h2d": 3,
                          "applier": {}})


def test_reader_sums_the_chained_tags_over_the_evals():
    assert spec.metric_reader(NAME)(recorded()) == pytest.approx(8 / 16)


def test_a_window_whose_tails_chained_nothing_reads_zero():
    assert spec.metric_reader(NAME)(recorded((0, 0, 0))) == 0.0


def test_reader_of_a_program_without_the_tag_returns_none():
    read = spec.metric_reader(NAME)
    assert read(recorded((None, None, None))) is None
    assert read(dict(recorded(), spans=[])) is None
    assert read(dict(recorded(), evals=0)) is None


def test_reader_goes_silent_when_the_tracer_dropped_spans():
    assert spec.metric_reader(NAME)(dict(recorded(), dropped=1)) is None


def test_the_metric_is_listed_for_every_cell():
    (entry,) = [m for m in spec.benchmark()["per_layer"]
                if m["name"] == NAME]
    assert entry == dict(name=NAME, unit="evals/eval", better="higher",
                         source="program_counter", layer="scheduler",
                         moves="evals_per_s", workloads=CELLS)
