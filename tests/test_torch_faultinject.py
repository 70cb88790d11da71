"""The port's fault injection (nomad_tpu_torch/faultinject) against the
JAX package's: the spec grammar, seeded determinism, the shared
``NOMAD_TPU_FAULTS`` lever, and every site the port wires — broker
enqueue, raft apply, the raft storage sites, heartbeat delivery and the
store's watch delivery — each alone and all together under a live port
server, which must still place exactly once.  Last, ``raft.apply=error``
under a live port server: the batch worker's commit fails once, the
evals redeliver, and every placement lands exactly once.
"""
from __future__ import annotations

import os
import subprocess
import sys

import pytest

import nomad_tpu.mock as jmock
from nomad_tpu import faultinject as jfault
from nomad_tpu_torch import convert, faultinject
from nomad_tpu_torch.faultinject import (
    FaultDropped,
    FaultInjected,
    FaultPlan,
    FaultSpecError,
)
from nomad_tpu_torch.scheduler.executor import executor_override
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs import Evaluation, generate_uuid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SITES = ("broker.enqueue", "raft.apply", "log.append", "log.fsync",
              "snapshot.persist", "meta.persist", "heartbeat.deliver",
              "watch.deliver")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faultinject.clear_plan()
    yield
    faultinject.clear_plan()


def test_sites_and_actions_are_the_jax_packages():
    from nomad_tpu.faultinject import plan as jplan
    from nomad_tpu_torch.faultinject import plan as tplan

    assert tplan.SITES == jplan.SITES
    assert tplan.STORAGE_SITES == jplan.STORAGE_SITES
    assert tplan.SITE_CONTEXT == jplan.SITE_CONTEXT
    assert tplan.ACTIONS == jplan.ACTIONS
    assert set(PORT_SITES) <= set(tplan.SITES)


SPECS = [
    "seed=7;rpc.send=drop(p=0.5,count=3,method=Node.*);"
    "heartbeat.deliver=drop(node=n-1);device.collect=hang(secs=0.01);"
    "raft.apply=delay(secs=0.02,after=2)",
    "seed=3;log.append=crash(count=1,after=2);"
    "snapshot.persist=crash(method=/tmp/cluster/s1*)",
    "broker.enqueue=error(method=batch,count=2);watch.deliver=drop(p=0.3)",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_like_jax(spec):
    got = FaultPlan.parse(spec)
    want = jfault.FaultPlan.parse(spec)
    assert got.seed == want.seed
    assert [repr(r) for r in got.rules()] == [repr(r) for r in want.rules()]


@pytest.mark.parametrize("bad", [
    "nope.site=error", "rpc.send=explode", "rpc.send=error(p=oops)",
    "rpc.send=error(count=1.5)", "rpc.send=error(zap=1)", "rpc.send",
    "seed=abc", "rpc.send=error(p=0.5", "rpc.send=error(p=2)",
    "raft.apply=error(method=X)", "device.collect=error(node=n)",
    "heartbeat.deliver=drop(method=Node.Heartbeat)",
    "watch.deliver=drop(node=n-1)", "rpc.send=crash",
    "raft.apply=crash(count=1)", "log.append=crash(node=n-1)",
])
def test_parse_rejects_what_jax_rejects(bad):
    with pytest.raises(FaultSpecError):
        FaultPlan.parse(bad)
    with pytest.raises(jfault.FaultSpecError):
        jfault.FaultPlan.parse(bad)


def test_seeded_firing_is_the_jax_sequence():
    def run(module):
        out = []
        plan = module.FaultPlan.parse("seed=11;broker.enqueue=drop(p=0.5)")
        for _ in range(64):
            try:
                plan.fire("broker.enqueue")
                out.append(0)
            except ConnectionError:
                out.append(1)
        return out

    first = run(faultinject)
    assert first == run(faultinject) == run(jfault)
    assert 0 < sum(first) < 64


def test_install_fire_clear_is_airtight():
    assert not faultinject.ACTIVE
    faultinject.fire("raft.apply")  # no plan: no-op
    plan = FaultPlan().add("raft.apply", "error", count=1)
    with faultinject.injected(plan):
        assert faultinject.ACTIVE
        with pytest.raises(FaultInjected):
            faultinject.fire("raft.apply")
        faultinject.fire("raft.apply")  # budget spent
        assert plan.exhausted()
    assert not faultinject.ACTIVE
    assert plan.fire_count() == 1
    assert not jfault.ACTIVE, "the two packages keep separate plans"


def test_env_spec_is_read_at_import_in_a_fresh_interpreter():
    """``NOMAD_TPU_FAULTS`` is one lever for both packages: the port
    parses it at import, and a malformed spec fails the import."""
    code = ("from nomad_tpu_torch import faultinject as f\n"
            "p = f.active_plan()\n"
            "print(f.ACTIVE, p.seed, [repr(r) for r in p.rules()])\n")
    env = dict(os.environ, PYTHONPATH=REPO,
               NOMAD_TPU_FAULTS="seed=5;raft.apply=error(count=2)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "5", "['raft.apply=error(count=2)']"]
    env["NOMAD_TPU_FAULTS"] = "raft.apply=explode"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "FaultSpecError" in out.stderr


# -- the sites, one at a time ------------------------------------------------


def test_broker_enqueue_site():
    from nomad_tpu_torch.server.eval_broker import EvalBroker

    broker = EvalBroker(nack_timeout=5)
    broker.set_enabled(True)
    try:
        ev = Evaluation(id=generate_uuid(), type="batch", job_id="j",
                        status="pending")
        plan = FaultPlan().add("broker.enqueue", "error", method="batch")
        with faultinject.injected(plan):
            with pytest.raises(FaultInjected):
                broker.enqueue(ev)
            svc = Evaluation(id=generate_uuid(), type="service",
                             job_id="k", status="pending")
            broker.enqueue(svc)  # predicate: service passes
        assert broker.stats()["total_ready"] == 1
    finally:
        broker.shutdown()


def test_raft_apply_site():
    from nomad_tpu_torch.server.raft import InmemRaft

    class _FSM:
        def apply(self, index, entry):
            return None

    raft = InmemRaft(_FSM())
    with faultinject.injected(
            FaultPlan().add("raft.apply", "error", count=1)):
        with pytest.raises(FaultInjected):
            raft.apply(b"entry")
        raft.apply(b"entry").wait(1.0)
    assert raft.applied_index() == 1


@pytest.mark.parametrize("site", ["log.append", "log.fsync"])
def test_log_crash_is_seeded_and_latches(tmp_path, site):
    """A ``crash`` at a log site tears the in-flight record by the
    plan's seed (same seed, same bytes — the JAX package's layout) and
    latches: the store refuses every later write."""
    from nomad_tpu.server.raft import FileLogStore as JLog
    from nomad_tpu_torch.server.raft import FileLogStore, StorageDead

    def torn(module, log_c, seed):
        path = str(tmp_path / f"{module.__name__}-{site}-{seed}.bin")
        store = log_c(path)
        store.append(1, b"committed-record")
        plan = module.FaultPlan(seed=seed).add(site, "crash", count=1)
        with module.injected(plan):
            with pytest.raises(module.FaultCrash):
                store.append(2, b"payload-payload-payload")
            assert module.crashed()
            with pytest.raises(Exception) as err:
                store.append(3, b"more")
            assert type(err.value).__name__ == "StorageDead"
        store.close()
        with open(path, "rb") as fh:
            return fh.read()

    for seed in (1, 42):
        assert torn(faultinject, FileLogStore, seed) == \
            torn(jfault, JLog, seed)
    assert StorageDead.__name__ == "StorageDead"


def test_snapshot_and_meta_persist_sites(tmp_path):
    from nomad_tpu_torch.server.raft import MetaStore, SnapshotStore

    snaps = SnapshotStore(str(tmp_path / "snaps"))
    meta = MetaStore(str(tmp_path / "meta.json"))
    plan = (FaultPlan().add("snapshot.persist", "error", count=1)
            .add("meta.persist", "error", count=1))
    with faultinject.injected(plan):
        with pytest.raises(FaultInjected):
            snaps.save(5, b"blob")
        with pytest.raises(FaultInjected):
            meta.save({"term": 3})
        snaps.save(6, b"blob")
        meta.save({"term": 4})
    assert snaps.latest() == (6, b"blob")
    assert meta.load()["term"] == 4


def test_snapshot_crash_is_seeded_like_jax(tmp_path):
    """A ``crash`` at ``snapshot.persist`` cuts the power at the instant
    the plan's seed draws: mid-way through the temporary file (the
    older snapshot stays the newest) or after the rename (the new one
    is durable).  The same seed gives the same survivor in both
    packages, and a torn temporary file never wins."""
    from nomad_tpu.server.raft import SnapshotStore as JSnaps
    from nomad_tpu_torch.server.raft import SnapshotStore

    survivors = set()
    for seed in range(8):
        got = []
        for module, store_c in ((faultinject, SnapshotStore),
                                (jfault, JSnaps)):
            d = str(tmp_path / f"{module.__name__}-{seed}")
            store_c(d).save(6, b"older")
            with module.injected(module.FaultPlan(seed=seed).add(
                    "snapshot.persist", "crash", count=1)):
                with pytest.raises(module.FaultCrash):
                    store_c(d).save(7, b"newer")
            got.append(store_c(d).latest())
        assert got[0] == got[1], seed
        assert got[0] in ((6, b"older"), (7, b"newer"))
        survivors.add(got[0][0])
    assert survivors == {6, 7}, "both cut instants are drawn"


def test_heartbeat_deliver_site():
    from nomad_tpu_torch.server.heartbeat import HeartbeatManager

    class _Timer:
        def __init__(self, ttl, fn, args):
            pass

        def start(self):
            pass

        def cancel(self):
            pass

    hb = HeartbeatManager(server=None, timer_factory=_Timer)
    try:
        plan = FaultPlan().add("heartbeat.deliver", "drop", node="n-victim")
        with faultinject.injected(plan):
            assert hb.reset_heartbeat_timer("n-ok") > 0
            with pytest.raises(FaultDropped):
                hb.reset_heartbeat_timer("n-victim")
        with hb._lock:
            assert "n-ok" in hb._timers and "n-victim" not in hb._timers
    finally:
        hb.shutdown()


def test_watch_deliver_site_drops_a_wakeup_to_its_timeout():
    """A dropped watch wakeup re-parks the waiter: its timeout still
    delivers it (as timed out), so loss is latency, never a stuck or
    leaked waiter."""
    import threading

    from nomad_tpu_torch.state.store import StateStore

    store = StateStore()
    got: list = []
    done = threading.Event()

    def deliver(timed_out):
        got.append(timed_out)
        done.set()

    try:
        with faultinject.injected(
                FaultPlan().add("watch.deliver", "drop", method="nodes")):
            store.watch.subscribe(("nodes",), deliver, min_index=0,
                                  ttl=0.2)
            store.upsert_node(1, convert.nodes_from_reference(
                [jmock.node()])[0])
            assert done.wait(5.0)
        assert got == [True]
        assert store.watch.stats()["dropped_wakeups"] == 1
        assert store.watch.live_waiters() == 0
    finally:
        store.watch.shutdown()


# -- the sites together, under a live port server ---------------------------


def _placed_once(srv, jobs):
    state = srv.fsm.state
    for job in jobs:
        live = [a for a in state.allocs_by_job(job.id)
                if not a.terminal_status()]
        want = sum(tg.count for tg in job.task_groups)
        assert len(live) == want, (job.id, len(live), want)
        assert len({a.name for a in live}) == want


def _server_world(srv, n_nodes=6):
    nodes = convert.nodes_from_reference(
        [jmock.node(i) for i in range(n_nodes)])
    for n in nodes:
        srv.node_register(n)
    jobs = convert.jobs_from_reference([jmock.job() for _ in range(3)])
    for job in jobs:
        job.task_groups[0].count = 2
    ids = [srv.job_register(j)[1] for j in jobs]
    return nodes, jobs, ids


def test_every_port_site_fires_under_a_live_server(tmp_path):
    """One seeded plan with a 1 ms delay at every site the port wires,
    through a live port server with a durable raft log and snapshots,
    its heartbeats, a parked watch and the meta store: every site fires,
    and placement still lands exactly once."""
    import threading

    from nomad_tpu_torch.server.raft import MetaStore

    plan = FaultPlan(seed=19)
    for site in PORT_SITES:
        plan.add(site, "delay", secs=0.001)
    with faultinject.injected(plan), executor_override("device"):
        srv = Server(ServerConfig(
            device="cpu", num_schedulers=2, tune_gc=False,
            data_dir=str(tmp_path / "data"), raft_snapshot_threshold=4))
        try:
            srv.establish_leadership()
            woke = threading.Event()
            srv.fsm.state.watch.subscribe(("jobs",), lambda t: woke.set(),
                                          ttl=5.0)
            nodes, jobs, ids = _server_world(srv)
            for n in nodes:
                srv.node_heartbeat(n.id)
            assert set(srv.wait_for_evals(ids, timeout=60).values()) == \
                {"complete"}
            assert woke.wait(5.0)
            _placed_once(srv, jobs)
        finally:
            srv.shutdown()
        MetaStore(str(tmp_path / "meta.json")).save({"term": 1})
    silent = [s for s in PORT_SITES if plan.fire_count(s) == 0]
    assert not silent, f"wired sites that never fired: {silent}"


def test_raft_apply_error_under_a_live_server_places_exactly_once():
    """The first commit after leadership (the batch worker's window)
    fails at ``raft.apply``: every member plan is answered with the
    error, no state moves, the worker nacks and records it, the evals
    redeliver, and the retry places every copy exactly once."""
    with executor_override("device"):
        srv = Server(ServerConfig(device="cpu", num_schedulers=2,
                                  tune_gc=False))
        try:
            _nodes, jobs, ids = _server_world(srv)
            plan = FaultPlan().add("raft.apply", "error", count=1)
            with faultinject.injected(plan):
                srv.establish_leadership()
                assert set(srv.wait_for_evals(ids, timeout=60).values()) \
                    == {"complete"}
            assert plan.fire_count("raft.apply") == 1
            _placed_once(srv, jobs)
            assert srv.plan_applier.stats()["dispatch_failures"] == 1
            assert srv._worker_stats()["failures"] == 1
        finally:
            srv.shutdown()
