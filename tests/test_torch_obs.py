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
flattened keys apart from the named differences below.  Last the
port's own spans, which carry no ``eval_id``: the phase spans under
each ``worker.batch`` cover it, a forced conflict records its refresh,
its chained tail and its solo retries with their round, raft records one ``raft.wait`` and
one ``raft.entry`` per apply, ``watch.notify`` counts every waiter it
wakes, device spans resolve onto the tracer's clock (a stand-in CUDA
event on the CPU), and with tracing off nothing is recorded and no
CUDA event made.
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


# ---------------------------------------------------------------------------
# the port's own spans: the batch worker's phases, raft, the watch, the card
# ---------------------------------------------------------------------------

# The worker thread's phase spans under each ``worker.batch``.
PHASES = {"worker.sync", "sched.lanes", "dispatch.stack", "dispatch.upload",
          "dispatch.launch", "dispatch.fetch", "dispatch.unstack",
          "finish.prepare", "finish.native", "finish.tail", "submit.wait",
          "submit.status", "sched.refresh", "sched.solo", "sched.gc",
          "worker.ack"}


def _union_s(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _port_eval(job):
    from nomad_tpu_torch.structs import Evaluation, generate_uuid

    return Evaluation(id=generate_uuid(), priority=job.priority,
                      type=job.type, triggered_by="job-register",
                      job_id=job.id, status="pending")


@pytest.fixture(scope="module")
def traced_port_run():
    """A port server on the CPU with tracing on: 20 nodes and a burst of
    12 jobs of 8 copies, whose fused lanes conflict and retry; every
    entry handed to raft is counted by its message type."""
    from nomad_tpu_torch import mock as tmock

    applied = collections.Counter()
    with trace.tracing(seed=9) as t, t_executor("device"), _seeded(3):
        srv = _port_server()
        raft_apply = srv.raft.apply

        def counted(entry):
            applied[entry[0] & 0x7F] += 1
            return raft_apply(entry)

        srv.raft.apply = counted
        try:
            for i in range(20):
                srv.node_register(tmock.node(i))
            srv.establish_leadership()
            ids = []
            for _ in range(12):
                job = tmock.job()
                job.task_groups[0].count = 8
                ids.append(srv.job_register(job)[1])
            assert srv.wait_for_evals(ids, timeout=WAIT_S)
        finally:
            srv.shutdown()
        spans = t.snapshot()
        stats = t.stats()
    return spans, applied, stats


def test_the_phases_of_each_batch_cover_it(traced_port_run):
    spans, _applied, stats = traced_port_run
    assert stats["dropped"] == 0
    batches = [s for s in spans if s["name"] == "worker.batch"]
    assert batches and sum(b["tags"]["lanes"] for b in batches) >= 12
    for b in batches:
        assert {"lanes", "rounds", "solo", "chained"} <= set(b["tags"])
        a0, a1 = b["t0"], b["t0"] + b["dur"]
        kids = [s for s in spans if s["parent_id"] == b["span_id"]]
        assert {s["name"] for s in kids} <= PHASES
        assert not any("eval_id" in (s.get("tags") or {}) for s in kids)
        # with the lanes' own sched.begin spans on the worker's thread
        kids += [s for s in spans if s["name"] == "sched.begin"
                 and s["thread"] == b["thread"] and a0 <= s["t0"] <= a1]
        covered = _union_s((max(a0, s["t0"]), min(a1, s["t0"] + s["dur"]))
                           for s in kids)
        assert covered >= 0.95 * b["dur"], (b["tags"], covered, b["dur"])
        assert {"worker.sync", "dispatch.launch", "finish.tail",
                "submit.wait"} <= {s["name"] for s in kids}
    rounds = collections.Counter(
        s["tags"].get("round") for s in spans
        if s["name"] in ("sched.begin", "sched.dispatch", "sched.finish",
                         "sched.submit"))
    assert rounds[0] > 0 and None not in rounds


def test_raft_records_one_wait_and_one_entry_per_apply(traced_port_run):
    spans, applied, _stats = traced_port_run
    for name in ("raft.wait", "raft.entry"):
        mine = [s for s in spans if s["name"] == name]
        assert collections.Counter(s["tags"]["msg_type"] for s in mine) \
            == applied, name
        assert all(s["tags"]["bytes"] > 1 and s["dur"] >= 0 for s in mine)
    assert len(applied) >= 3  # node, job, eval and plan entries
    commits = [s for s in spans if s["name"] == "commit.encode"]
    assert commits and all(s["tags"]["bytes"] > 1 for s in commits)
    assert len([s for s in spans if s["name"] == "commit.respond"]) == \
        len(commits)


def _stale_run(stale_windows: int):
    """Three evals through a planner that answers the first
    ``stale_windows`` windows with a refresh (the applier's stale-data
    answer), traced: (runner, spans, harness, jobs)."""
    from nomad_tpu_torch import mock as tmock
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.scheduler.batch import BatchEvalRunner

    h = Harness(device="cpu")
    for i in range(8):
        h.state.upsert_node(h.next_index(), tmock.node(i))
    jobs = []
    for _ in range(3):
        job = tmock.job()
        job.task_groups[0].count = 2
        h.state.upsert_job(h.next_index(), job)
        jobs.append(job)

    class Stale:
        windows = stale_windows

        def submit_plans(self, plans):
            if self.windows:
                self.windows -= 1
                return [(None, h.snapshot()) for _ in plans]
            return h.submit_plans(plans)

        def submit_plan(self, plan):
            return h.submit_plan(plan)

        def update_eval(self, ev):
            h.update_eval(ev)

        def create_eval(self, ev):
            h.create_eval(ev)

    with trace.tracing(seed=4) as t, t_executor("device"):
        runner = BatchEvalRunner(h.snapshot(), Stale(),
                                 state_refresh=h.snapshot, device="cpu")
        runner.process([_port_eval(j) for j in jobs])
        spans = t.snapshot()
    return runner, spans, h, jobs


def test_a_forced_conflict_records_the_refresh_and_the_solo_retries():
    """A planner that answers the first three windows with a refresh:
    every lane retries in fused round 1, then in the chained tail, then
    alone."""
    runner, spans, h, jobs = _stale_run(3)
    assert runner.rounds_run == 2 and runner.solo_evals == 3
    assert runner.chained_evals == 3
    refresh = [s["tags"]["round"] for s in spans
               if s["name"] == "sched.refresh"]
    solo = [s["tags"]["round"] for s in spans if s["name"] == "sched.solo"]
    assert refresh == [1, 2]
    assert solo == [2, 2, 2]
    begins = collections.Counter(s["tags"]["round"] for s in spans
                                 if s["name"] == "sched.begin")
    assert begins == collections.Counter({0: 3, 1: 3, 2: 3})
    assert all(h.state.allocs_by_job(j.id) for j in jobs)


def test_a_forced_conflict_records_the_chained_tail():
    """A planner that answers the first two windows with a refresh:
    every lane retries in fused round 1, then in one chained window
    tagged ``round`` 2, which commits them all with none alone."""
    runner, spans, h, jobs = _stale_run(2)
    assert runner.rounds_run == 2 and runner.solo_evals == 0
    assert runner.chained_evals == 3
    assert not [s for s in spans if s["name"] == "sched.solo"]
    begins = collections.Counter(s["tags"]["round"] for s in spans
                                 if s["name"] == "sched.begin")
    assert begins == collections.Counter({0: 3, 1: 3, 2: 3})
    tail = [s["tags"] for s in spans if s["name"] == "sched.dispatch"
            and s["tags"]["round"] == 2]
    assert [t.get("chained") for t in tail] == [3, 3, 3]
    assert all(h.state.allocs_by_job(j.id) for j in jobs)
    assert {e.status for e in h.evals} == {"complete"}


def test_watch_notify_counts_every_waiter_it_wakes():
    from nomad_tpu_torch import mock as tmock
    from nomad_tpu_torch.state.store import StateStore

    store = StateStore()
    watch = store.watch
    index = 10
    with trace.tracing(seed=6) as t:
        before = watch.delivered
        for key, n in ((("nodes",), 3), (("evals",), 2), (("jobs",), 4)):
            for _ in range(n):
                watch.subscribe(key, lambda timed_out: None,
                                min_index=index)
        # a waiter whose key no write touches is never woken
        watch.subscribe(("allocs",), lambda timed_out: None,
                        min_index=index)
        for i in range(2):
            index += 1
            store.upsert_node(index, tmock.node(i))
        index += 1
        store.upsert_job(index, tmock.job())
        index += 1
        store.upsert_evals(index, [tmock.eval()])
        spans = [s for s in t.snapshot() if s["name"] == "watch.notify"]
    woken = sum(s["tags"]["woken"] for s in spans)
    assert woken == watch.delivered - before == 9
    assert {s["tags"]["table"] for s in spans} == {"nodes", "jobs", "evals"}
    assert watch.live_waiters() == 1
    watch.shutdown()


class _FakeEvent:
    """A CUDA event on the host's clock: records the time it is
    recorded at, complete at once."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.at = None

    def record(self, stream=None):
        import time

        self.at = time.perf_counter()

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


def _fake_card(monkeypatch):
    _FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: "stream")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def test_device_spans_resolve_on_the_tracers_clock(monkeypatch):
    import time

    _fake_card(monkeypatch)
    card = torch.device("cuda", 0)
    with trace.tracing(seed=2) as t:
        assert _FakeEvent.made == 1  # the card's base
        t_start = t.now()
        started = trace.device_span(card)
        time.sleep(0.02)  # sleep-ok: the stand-in launch's known length
        gi = torch.tensor([[0, 0, 1, 1], [2, 2, 2, 2]], dtype=torch.int32)
        started.end("device.K4b", lazy=lambda: {"named": [
            len(set(r)) for r in gi.tolist()]}, n=16, lanes=2, p=4)
        assert trace.device_span(torch.device("cpu")) is None
        assert t.stats()["recorded"] == 1
        (got,) = t.snapshot()
    assert got["name"] == "device.K4b" and "_device" not in got
    assert got["tags"] == dict(n=16, lanes=2, p=4, named=[2, 1])
    assert abs(got["t0"] - t_start) < 0.01
    assert 0.015 < got["dur"] < 0.5
    assert _FakeEvent.made == 3


def test_device_tags_mark_the_spans_a_thread_ends_inside(monkeypatch):
    """A chained walk's ``chain`` tag: added to every device span the
    thread ends inside ``device_tags``, beside the wrapper's own tags,
    and to none after it or on another thread."""
    import threading

    _fake_card(monkeypatch)
    card = torch.device("cuda", 0)
    with trace.tracing(seed=2) as t:
        with t.device_tags(chain=1):
            trace.device_span(card).end("device.K3", n=16, lanes=1)
            other = threading.Thread(target=lambda: trace.device_span(
                card).end("device.K3", n=16, lanes=1))
            other.start()
            other.join()
        trace.device_span(card).end("device.K3", n=16, lanes=1)
        spans = t.snapshot()
    assert sorted(s["tags"].get("chain", -1) for s in spans) == [-1, -1, 1]
    assert all(s["tags"]["n"] == 16 for s in spans)


def test_pending_device_spans_count_against_the_ring(monkeypatch):
    _fake_card(monkeypatch)
    monkeypatch.setattr(trace, "FLUSH_AT", 1)
    card = torch.device("cuda", 0)
    with trace.tracing(seed=2, ring=3) as t:
        for _ in range(4):
            trace.device_span(card).end("device.put_counted", bytes=8,
                                        kind="h2d")
        stats = t.stats()
        spans = t.snapshot()
    assert (stats["ring"], stats["dropped"], stats["recorded"]) == (3, 1, 4)
    assert [s["name"] for s in spans] == ["device.put_counted"] * 3
    assert all(s["dur"] >= 0 and s["tags"]["bytes"] == 8 for s in spans)


def test_tracing_off_records_nothing_and_makes_no_cuda_event(monkeypatch):
    from nomad_tpu_torch import mock as tmock

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    assert not trace.ENABLED and trace.tracer() is None
    with t_executor("device"), _seeded(3):
        srv = _port_server()
        try:
            for i in range(6):
                srv.node_register(tmock.node(i))
            srv.establish_leadership()
            job = tmock.job()
            job.task_groups[0].count = 4
            assert srv.wait_for_evals([srv.job_register(job)[1]],
                                      timeout=WAIT_S)
        finally:
            srv.shutdown()
    assert trace.tracer() is None
    assert trace.device_span(torch.device("cuda", 0)) is None
    assert trace.phase("worker.sync", 0.0) == 0.0
    assert _FakeEvent.made == 0
