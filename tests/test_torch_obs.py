"""The port's trace & telemetry plane against the JAX package's obs/.

Units first, each on the same inputs through both packages: the span
recorder (ring bound and overflow accounting, seeded ids, ambient
nesting, the ``_trace`` envelope), the Chrome-trace export, ``flatten``,
the metrics registry, the flight recorder's incident file and its trips
(breaker open, overload entry, a stalled section), the port's
``utils/profiling`` on ``torch.profiler`` and its windowed in-memory
sink.  Then the servers: the same small jobs registered over the wire
to a JAX ``Server`` and a port ``Server(device="cpu")``, both with
``enable_rpc`` and tracing on, record the same span names and the same
parent-name edges per eval (the port's batch worker adds one
``worker.invoke`` per eval, which the JAX batch worker does not record:
ROADMAP Queue 3), and the two servers' registries expose the same
flattened keys apart from the named differences below.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import random
import threading

import pytest
import torch

import nomad_tpu.mock as jmock
from nomad_tpu.obs import flight as jflight
from nomad_tpu.obs import registry as jregistry
from nomad_tpu.obs import trace as jtrace
from nomad_tpu.parallel.mesh import mesh_override
from nomad_tpu.scheduler.executor import executor_override as j_executor
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.server.rpc import ConnPool as JConnPool
from nomad_tpu_torch import convert
from nomad_tpu_torch.obs import flight, registry, trace
from nomad_tpu_torch.scheduler.executor import executor_override as \
    t_executor
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.rpc import ConnPool
from nomad_tpu_torch.utils import metrics as tmetrics
from nomad_tpu_torch.utils import profiling

torch.set_num_threads(1)

WAIT_S = 60.0

# Keys one server's registry has and the other's lacks, by design:
# the port's worker pool also counts the evals a worker caught an
# exception on (``Worker.failures``; ROADMAP Queue 3).
PORT_ONLY_KEYS = {"nomad.workers.failures"}
JAX_ONLY_KEYS: set = set()


def _both(fn):
    """``fn(module_pair)`` for the JAX then the port module set."""
    return (fn(jtrace, jregistry, jflight), fn(trace, registry, flight))


# ---------------------------------------------------------------------------
# the span recorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring,spans", [(1, 70), (8, 200), (100, 130)])
def test_ring_bound_and_overflow_accounting_match(ring, spans):
    def run(tr, _reg, _fl):
        t = tr.Tracer(seed=1, ring=ring)
        for i in range(spans):
            t.record("s", float(i), 0.0, k=i)
        st = t.stats()
        kept = [s["tags"]["k"] for s in t.snapshot()]
        return st, kept
    (jst, jkept), (tst, tkept) = _both(run)
    assert tst == jst
    assert tkept == jkept
    assert tst["ring"] <= ring and tst["recorded"] == spans


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 + 5])
def test_seeded_ids_equal_the_jax_tracer(seed):
    jt, tt = jtrace.Tracer(seed=seed), trace.Tracer(seed=seed)
    assert [tt.new_id() for _ in range(6)] == \
        [jt.new_id() for _ in range(6)]


def _structure(t):
    """Each span as (name, parent name, same trace as parent, tags)."""
    spans = t.snapshot()
    by_id = {s["span_id"]: s for s in spans}
    out = []
    for s in spans:
        parent = by_id.get(s["parent_id"])
        out.append((s["name"], parent["name"] if parent else None,
                    parent is None or parent["trace_id"] == s["trace_id"],
                    s["span_id"], s["parent_id"], s["trace_id"],
                    s.get("tags")))
    return out


def test_nesting_attach_and_anchors_record_the_same_tree():
    def run(tr, _reg, _fl):
        t = tr.Tracer(seed=3)
        with t.span("outer", a=1) as outer:
            with t.span("inner"):
                t.record("leaf", t.now(), 0.0, parent_ctx=t.ctx())
            assert t.ctx() == outer
        assert t.ctx() is None
        anchor = t.anchor("eval.created", eval_id="e1")
        th = threading.Thread(target=lambda: _attached(t, anchor))
        th.start()
        th.join(5.0)
        return _structure(t)
    jstruct, tstruct = _both(run)
    assert sorted(tstruct, key=str) == sorted(jstruct, key=str)


def _attached(t, ctx):
    with t.attach(ctx):
        with t.span("work"):
            pass


def test_envelope_inject_extract_and_client_call_match():
    def run(tr, _reg, _fl):
        with tr.tracing(seed=5) as t:
            original = {"x": 1}
            assert tr.inject(original) is original  # no ambient ctx
            with t.span("outer"):
                stamped = tr.inject(original)
                assert stamped is not original
                assert tr.TRACE_KEY not in original
                kept = tr.inject(dict(stamped))
                assert kept[tr.TRACE_KEY] == stamped[tr.TRACE_KEY]
                got = tr.extract(stamped)
                with tr.client_call("Job.Register", {"y": 2}) as sent:
                    env = sent[tr.TRACE_KEY]
            return (stamped, got, env, tr.extract({"x": 1}),
                    tr.extract({tr.TRACE_KEY: {"span_id": "s"}}),
                    [(s["name"], s.get("tags")) for s in t.snapshot()])
    jout, tout = _both(run)
    assert tout == jout
    assert trace.ENABLED is False and trace.tracer() is None


def test_disabled_api_is_a_no_op():
    args = {"a": 1}
    assert trace.ENABLED is False
    assert trace.inject(args) is args and trace.ctx() is None
    with trace.client_call("Job.Register", args) as out:
        assert out is args


def test_chrome_trace_has_the_jax_keys(tmp_path):
    def run(tr, _reg, _fl):
        t = tr.Tracer(seed=1)
        with t.span("rpc.serve.Job.Register", method="Job.Register"):
            t.anchor("eval.created", eval_id="e1")
        t.record("applier.window", 0.5, 0.25,
                 parent_ctx={"trace_id": "t", "span_id": "s"}, window=2)
        path = str(tmp_path / f"{tr.__name__}.json")
        n = t.export_chrome(path)
        with open(path) as fh:
            doc = json.load(fh)
        assert n == len(doc["traceEvents"]) == 3
        return doc
    jdoc, tdoc = _both(run)
    assert sorted(tdoc) == sorted(jdoc)
    assert sorted(tdoc["otherData"]) == sorted(jdoc["otherData"])
    for tev, jev in zip(tdoc["traceEvents"], jdoc["traceEvents"]):
        assert sorted(tev) == sorted(jev)
        assert sorted(tev["args"]) == sorted(jev["args"])
        for key in ("name", "cat", "ph", "pid", "tid"):
            assert tev[key] == jev[key]
        for key in ("span_id", "parent_id", "trace_id"):
            assert tev["args"][key] == jev["args"][key]
    assert tdoc["traceEvents"][2]["ts"] == 500000.0
    assert tdoc["traceEvents"][2]["dur"] == 250000.0


# ---------------------------------------------------------------------------
# the metrics registry
# ---------------------------------------------------------------------------

TREES = [
    {"a": 1, "b": {"c": 2.5, "d": {"e": True}}, "f": [1, 2, 3]},
    {"state": "closed", "opens": 0, "lanes": (4, 4), "x": None},
    {1: {"nested": {"deep": {"deeper": -3}}}, "s": b"raw", "z": 0.0},
]


@pytest.mark.parametrize("tree", TREES)
def test_flatten_equals_the_jax_flatten(tree):
    assert registry.flatten(tree, "nomad.p") == \
        jregistry.flatten(tree, "nomad.p")
    assert registry.flatten(tree) == jregistry.flatten(tree)


def test_registry_snapshot_collect_and_publish_match():
    def run(_tr, reg, _fl):
        clock = [100.0]
        r = reg.MetricsRegistry(clock=lambda: clock[0])
        r.register("broker", lambda: {"ready": 2, "by": {"q": 1}})
        r.register("bad", lambda: 1 / 0)
        token = r.register("gone", lambda: {"x": 1})
        r.register("notdict", lambda: [1])
        r.register("broker", lambda: {"ready": 3, "by": {"q": 1}})
        assert r.deregister(token) and not r.deregister(token)
        extra = reg.MetricsRegistry()
        extra.register("swarm", lambda: {"agents": 50})
        snap = r.snapshot(extra=[extra])
        first = r.collect()
        clock[0] += 2.0
        second = r.collect()
        sink = _GaugeSink()
        n = r.publish(sink, extra=[extra])
        return (sorted(r.providers()), snap, first, second, n,
                sink.gauges)
    jout, tout = _both(run)
    assert tout == jout
    assert tout[1]["nomad.bad.error"].startswith("ZeroDivisionError")
    assert tout[3]["nomad.broker.age_s"] == 2.0


class _GaugeSink:
    def __init__(self):
        self.gauges = {}

    def set_gauge(self, key, value):
        self.gauges[key] = value


def test_collect_isolates_a_hung_provider_under_a_timeout():
    gate = threading.Event()
    r = registry.MetricsRegistry()
    r.register("hung", lambda: gate.wait(5.0) and {})
    r.register("ok", lambda: {"v": 1})
    try:
        out = r.collect(timeout=0.05)
        assert out["nomad.hung.error"].startswith("sample timeout")
        assert out["nomad.ok.v"] == 1
    finally:
        gate.set()
        r.clear()


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

def test_incident_file_has_the_jax_fields(tmp_path):
    def run(tr, reg, fl):
        r = reg.MetricsRegistry()
        r.register("broker", lambda: {"ready": 2})
        with tr.tracing(seed=5) as t:
            t.anchor("eval.created", eval_id="e1")
            with fl.installed(str(tmp_path / tr.__name__),
                              registries=[r],
                              extra_fn=lambda: {"knob": 1}):
                path = fl.trip("breaker.open", {"opens": 1})
        with open(path) as fh:
            return os.path.basename(path), json.load(fh)
    (jname, jdoc), (tname, tdoc) = _both(run)
    assert tname == jname == "incident-0001-breaker.open.json"
    assert sorted(tdoc) == sorted(jdoc)
    assert sorted(tdoc["metrics"]) == sorted(jdoc["metrics"])
    assert sorted(tdoc["metrics"]["inmem"]) == \
        sorted(jdoc["metrics"]["inmem"])
    for key in ("reason", "seq", "extra"):
        assert tdoc[key] == jdoc[key]
    assert tdoc["metrics"]["providers"] == jdoc["metrics"]["providers"]
    assert [(s["name"], s["span_id"]) for s in tdoc["spans"]] == \
        [(s["name"], s["span_id"]) for s in jdoc["spans"]]
    assert any("MainThread" in k for k in tdoc["thread_stacks"])


def test_rate_limit_and_on_disk_bound_match(tmp_path):
    def run(tr, _reg, fl):
        d = str(tmp_path / tr.__name__)
        with fl.installed(d, max_files=3, min_interval=60.0) as rec:
            got = [fl.trip(r) is not None
                   for r in ("a", "a", "b", "c", "d", "b")]
            return got, rec.stats(), rec.incidents()
    assert _both(run)[1] == _both(run)[0]
    got, stats, names = _both(run)[1]
    assert got == [True, False, True, True, True, False]
    assert stats == {"trips": 4, "suppressed": 2, "on_disk": 3}
    assert names[-1].startswith("incident-0004")


def test_a_stalled_section_trips_once_and_a_prompt_one_does_not(tmp_path):
    with flight.installed(str(tmp_path), min_interval=0.0) as rec:
        with flight.guard("prompt", 30.0):
            pass
        tripped = threading.Event()
        real = rec.record

        def record(reason, extra=None):
            out = real(reason, extra)
            tripped.set()
            return out
        rec.record = record
        with flight.guard("applier.window", 0.01,
                          extra_fn=lambda: {"component": 3}):
            assert tripped.wait(10.0)
        names = rec.incidents()
    assert len(names) == 1 and "stall.applier.window" in names[0]
    with open(os.path.join(str(tmp_path), names[0])) as fh:
        doc = json.load(fh)
    assert doc["extra"]["component"] == 3
    assert "stalled_for_s" in doc["extra"]
    assert flight.INSTALLED is False


def test_breaker_open_trips_the_recorder(tmp_path):
    from nomad_tpu_torch.scheduler.breaker import DeviceCircuitBreaker

    breaker = DeviceCircuitBreaker(failure_threshold=2)
    with flight.installed(str(tmp_path)) as rec:
        breaker.record_failure()
        assert rec.incidents() == []
        breaker.record_failure()
        names = rec.incidents()
    assert len(names) == 1 and "breaker.open" in names[0]


def test_overload_entry_trips_the_recorder_once(tmp_path):
    from nomad_tpu_torch.server.overload import OverloadController

    depth = [0]
    ctrl = OverloadController(brownout_ratio=0.5, overload_ratio=0.9)
    ctrl.add_source("q", lambda: (depth[0], 10))
    with flight.installed(str(tmp_path)) as rec:
        assert ctrl.state() == "normal" and rec.incidents() == []
        depth[0] = 10
        assert ctrl.state() == "overload"
        assert ctrl.state() == "overload"
        names = rec.incidents()
    assert len(names) == 1 and "overload.enter" in names[0]


def test_the_process_registry_carries_the_breaker():
    from nomad_tpu_torch.scheduler import breaker

    assert "breaker" in registry.REGISTRY.providers()
    snap = registry.REGISTRY.snapshot()
    assert snap["nomad.breaker.state"] == breaker.GLOBAL_BREAKER.state


# ---------------------------------------------------------------------------
# profiling and the in-memory sink
# ---------------------------------------------------------------------------

def test_thread_stacks_name_every_live_thread():
    stacks = profiling.thread_stacks()
    assert any(k.startswith("MainThread") for k in stacks)
    frame = next(v for k, v in stacks.items() if k.startswith("MainThread"))
    assert {"file", "line", "func", "code"} <= set(frame[-1])


def test_cpu_device_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.device_trace(d, device="cpu"):
        assert profiling.active_trace_dir() == d
        torch.ones(64).mul(2.0).sum()
    assert profiling.active_trace_dir() is None
    path = os.path.join(d, profiling.TRACE_FILE)
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["traceEvents"]


def test_device_trace_means_the_card_and_raises_without_one(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.start_device_trace(str(tmp_path))
    assert profiling.active_trace_dir() is None
    with pytest.raises(RuntimeError, match="no device trace active"):
        profiling.stop_device_trace()
    profiling.start_device_trace(str(tmp_path), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already active"):
            profiling.start_device_trace(str(tmp_path), device="cpu")
    finally:
        profiling.stop_device_trace()


def test_inmem_sink_matches_the_jax_sink():
    from nomad_tpu.utils.metrics import InmemSink as JSink

    clock = [0.0]
    sinks = [JSink(interval=1.0, retain=2, clock=lambda: clock[0]),
             tmetrics.InmemSink(interval=1.0, retain=2,
                                clock=lambda: clock[0])]
    for sink in sinks:
        for i in range(10):
            clock[0] = i * 0.5
            sink.add_sample("lat", float(i))
            sink.incr_counter("c", 1.0)
        sink.set_gauge("g", 7.0)
    clock[0] = 5.0
    assert sinks[1].snapshot() == sinks[0].snapshot()
    before = tmetrics.metrics.inmem.snapshot()["samples"].get(
        "nomad.test.span", {"count": 0})["count"]
    tmetrics.metrics.measure_since("nomad.test.span", 0.0)
    after = tmetrics.metrics.inmem.snapshot()["samples"]["nomad.test.span"]
    assert after["count"] == before + 1


# ---------------------------------------------------------------------------
# a JAX server and a port server, both traced, over the wire
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _seeded(seed):
    saved = random.getstate()
    random.seed(seed)
    try:
        yield
    finally:
        random.setstate(saved)


def _jobs():
    jobs = []
    for count in (3, 2, 4):
        j = jmock.job()
        j.task_groups[0].count = count
        jobs.append(j)
    return jobs


def _drive_wire(srv, pool_cls, nodes, jobs, tracer):
    """Nodes and then jobs, one at a time, over the wire: each job's
    eval completes before the next is registered, so no two evals share
    a window or conflict."""
    pool = pool_cls()
    try:
        addr = srv.rpc_address()
        for n in nodes:
            pool.call(addr, "Node.Register", {"node": n.to_dict()},
                      timeout=30)
        eval_ids = []
        for job in jobs:
            out = pool.call(addr, "Job.Register", {"job": job.to_dict()},
                            timeout=30)
            srv.wait_for_evals([out["eval_id"]], timeout=WAIT_S)
            eval_ids.append(out["eval_id"])
        # the last eval's raft apply span lands after its status
        _wait_spans(tracer, eval_ids)
        return eval_ids, srv.obs_registry.snapshot()
    finally:
        pool.shutdown()


def _wait_spans(tracer, eval_ids):
    done = threading.Event()
    for _ in range(200):
        names = collections.Counter(
            (s.get("tags") or {}).get("eval_id") for s in tracer.snapshot()
            if s["name"] in ("raft.apply", "store.upsert"))
        if all(names[e] >= 2 for e in eval_ids):
            return
        done.wait(0.05)


def _per_eval(tracer, eval_ids):
    """eval id -> (span-name multiset, parent-name edge multiset)."""
    spans = tracer.snapshot()
    by_id = {s["span_id"]: s for s in spans}
    out = {}
    for eid in eval_ids:
        mine = [s for s in spans
                if (s.get("tags") or {}).get("eval_id") == eid]
        names = collections.Counter(s["name"] for s in mine)
        edges = collections.Counter(
            (by_id[s["parent_id"]]["name"]
             if s["parent_id"] in by_id else None, s["name"])
            for s in mine)
        out[eid] = (names, edges)
    return out


@pytest.fixture(scope="module")
def traced_twins():
    nodes = [jmock.node(i) for i in range(6)]
    jobs = _jobs()
    with jtrace.tracing(seed=21) as jt, mesh_override("off"), \
            j_executor("device"), _seeded(5):
        jsrv = JServer(JServerConfig(num_schedulers=2, enable_rpc=True,
                                     tune_gc=False))
        try:
            jsrv.establish_leadership()
            jids, jsnap = _drive_wire(jsrv, JConnPool, nodes, jobs, jt)
            jspans = _per_eval(jt, jids)
        finally:
            jsrv.shutdown()
    with trace.tracing(seed=21) as tt, t_executor("device"), _seeded(5):
        tsrv = _port_server(num_schedulers=2, enable_rpc=True)
        try:
            tsrv.establish_leadership()
            tids, tsnap = _drive_wire(
                tsrv, ConnPool, convert.nodes_from_reference(nodes),
                convert.jobs_from_reference(jobs), tt)
            tspans = _per_eval(tt, tids)
        finally:
            tsrv.shutdown()
    return ([jspans[e] for e in jids], [tspans[e] for e in tids],
            jsnap, tsnap)


def _port_server(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("tune_gc", False)
    return Server(ServerConfig(**kw))


@pytest.mark.parametrize("k", range(3))
def test_each_eval_records_the_jax_span_names(traced_twins, k):
    jspans, tspans, _j, _t = traced_twins
    jnames, _ = jspans[k]
    tnames, _ = tspans[k]
    # the port's batch worker names its share of each fused batch
    assert tnames - jnames == collections.Counter({"worker.invoke": 1})
    assert jnames - tnames == collections.Counter()
    for name in ("eval.created", "broker.wait", "sched.begin",
                 "sched.dispatch", "sched.finish", "sched.submit",
                 "plan.queued", "applier.window", "applier.verify",
                 "raft.apply", "fsm.decode", "store.upsert"):
        assert tnames[name] == 1, name


@pytest.mark.parametrize("k", range(3))
def test_each_eval_records_the_jax_parent_edges(traced_twins, k):
    jspans, tspans, _j, _t = traced_twins
    _, jedges = jspans[k]
    _, tedges = tspans[k]
    assert tedges - jedges == collections.Counter(
        {("eval.created", "worker.invoke"): 1})
    assert jedges - tedges == collections.Counter()
    # the eval hangs off the serving RPC; every plan span off its eval
    assert tedges[("rpc.serve.Job.Register", "eval.created")] == 1
    assert tedges[("applier.window", "applier.verify")] == 1
    assert tedges[("eval.created", "store.upsert")] == 1


def test_the_registries_expose_the_jax_keys(traced_twins):
    _j, _t, jsnap, tsnap = traced_twins
    jkeys, tkeys = set(jsnap), set(tsnap)
    assert tkeys - jkeys == PORT_ONLY_KEYS
    assert jkeys - tkeys == JAX_ONLY_KEYS
    providers = {k.split(".")[1] for k in tkeys}
    assert providers == {"broker", "plan_queue", "applier",
                         "applier_components", "overload", "heartbeat",
                         "store", "workers", "rpc"}
