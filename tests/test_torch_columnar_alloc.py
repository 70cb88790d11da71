"""The port's columnar alloc contract (nomad_tpu_torch/structs/
alloc_slab.py): byte parity between the slab path and the object path,
lazy SlabAlloc materialization through verify and commit, slab cache
invalidation, and the fused storm's one-call native finish against the
JAX package's.

Twins of tests/test_columnar_alloc.py's TestSchedulerParity,
TestContendedStormParity, TestLazyMaterialization and
TestCacheInvalidation, run through the port's torch-binpack scheduler,
BatchEvalRunner and VerifyingPlanner on the CPU.  The invariant: a world
that evolved through columnar slabs digests (store fingerprint, per-alloc
to_dict) EXACTLY like one that evolved through the object contract.
"""
from __future__ import annotations

import contextlib
import gc
import random
import weakref

import msgpack
import numpy as np
import pytest
import torch

import nomad_tpu.mock as jmock
from nomad_tpu.parallel.mesh import mesh_override
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.scheduler.batch import BatchEvalRunner as JRunner
from nomad_tpu.scheduler.executor import executor_override
from nomad_tpu_torch import convert
import nomad_tpu_torch.mock as mock
import nomad_tpu_torch.scheduler.batch as tbatch
import nomad_tpu_torch.scheduler.stack as tstack
import nomad_tpu_torch.scheduler.torch_binpack as tb
import nomad_tpu_torch.structs.alloc_slab as alloc_slab
from nomad_tpu_torch.ops.verify_policy import verify_override
from nomad_tpu_torch.scheduler import BatchEvalRunner, Harness
from nomad_tpu_torch.scheduler import VerifyingPlanner
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.structs import (
    ALLOC_DESIRED_STATUS_STOP,
    EVAL_TRIGGER_JOB_REGISTER,
    Allocation,
    Evaluation,
    NetworkResource,
    Resources,
    SlabAlloc,
    Task,
    TaskGroup,
)
from nomad_tpu_torch.structs.alloc_slab import (
    AllocSlab,
    decode_slabs,
    encode_alloc_update,
    slab_ref,
)

# The tensors here are tiny: one thread each keeps the xdist workers
# from contending for the CPU.
torch.set_num_threads(1)


def make_eval(job):
    return Evaluation(id=f"ev-{job.id}", priority=job.priority,
                      type="service",
                      triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                      job_id=job.id)


def _job(n_groups=6, count=2):
    job = mock.job()
    job.task_groups = [
        TaskGroup(
            name=f"tg-{g}", count=count,
            tasks=[
                Task(name="web", driver="exec",
                     resources=Resources(
                         cpu=100, memory_mb=64,
                         networks=[NetworkResource(
                             mbits=5, dynamic_ports=["http", "admin"])])),
                Task(name="sidecar", driver="exec",
                     resources=Resources(cpu=50, memory_mb=32)),
            ])
        for g in range(n_groups)]
    return job


def _deterministic(monkeypatch):
    counter = {"n": 0}

    def fake_uuids(n):
        base = counter["n"]
        counter["n"] += n
        return [f"u-{base + i:08d}" for i in range(n)]

    monkeypatch.setattr(tb, "generate_uuids", fake_uuids)
    monkeypatch.setattr(tbatch, "generate_uuids", fake_uuids)
    monkeypatch.setattr(tb, "_randrange", lambda n: 987654321 % n)

    # Frozen clock: metrics.allocation_time is wall-clock-derived and
    # would differ between the two contract runs (the fingerprint
    # digests it); the failed-alloc path stamps it through the stack.
    class _FrozenTime:
        perf_counter = staticmethod(lambda: 0.0)

    monkeypatch.setattr(tb, "time", _FrozenTime)
    monkeypatch.setattr(tstack, "time", _FrozenTime)


_WORLD_CACHE: dict = {}


def _world(n_nodes=12, n_jobs=3):
    """One shared node/job prototype set per shape — both contract runs
    must see the SAME world (mock ids are random per construction)."""
    key = (n_nodes, n_jobs)
    world = _WORLD_CACHE.get(key)
    if world is None:
        nodes = [mock.node(i) for i in range(n_nodes)]
        jobs = []
        for j in range(n_jobs):
            job = _job()
            job.id = f"job-{j}"
            job.name = f"job-{j}"
            jobs.append(job)
        world = _WORLD_CACHE[key] = (nodes, jobs)
    return world


def _run_storm(monkeypatch, columnar: bool, n_nodes=12, n_jobs=3):
    """One deterministic eval stream through the port's torch-binpack
    scheduler on the CPU; returns (harness, plans)."""
    _deterministic(monkeypatch)
    monkeypatch.setattr(alloc_slab, "COLUMNAR", columnar)
    nodes, jobs = _world(n_nodes, n_jobs)
    h = Harness(device="cpu")
    for n in nodes:
        h.state.upsert_node(h.next_index(), n.copy())
    plans = []
    for job in jobs:
        h.state.upsert_job(h.next_index(), job.copy())
        h.process("torch-binpack", make_eval(job))
        plans.append(h.plans[-1])
    return h, plans


def _norm(plan):
    out = {}
    for node_id, allocs in plan.node_allocation.items():
        rows = []
        for a in allocs:
            d = a.to_dict()
            d["metrics"]["allocation_time"] = 0.0
            rows.append(d)
        out[node_id] = rows
    return out


def _plan_allocs(plan):
    return [a for allocs in plan.node_allocation.values()
            for a in allocs]


# ---------------------------------------------------------------------------
# 1. scheduler-level parity: columnar vs object contract
# ---------------------------------------------------------------------------

class TestSchedulerParity:
    def test_columnar_plans_byte_identical_to_object_path(
            self, monkeypatch):
        with monkeypatch.context() as m:
            _h1, obj_plans = _run_storm(m, columnar=False)
        with monkeypatch.context() as m:
            _h2, col_plans = _run_storm(m, columnar=True)
        assert [_norm(p) for p in obj_plans] == \
            [_norm(p) for p in col_plans]
        # The columnar run really rode slabs (not a silent fallback).
        assert all(type(a) is SlabAlloc
                   for p in col_plans for a in _plan_allocs(p))
        assert all(type(a) is Allocation
                   for p in obj_plans for a in _plan_allocs(p))

    def test_columnar_store_fingerprint_parity(self, monkeypatch):
        """Apply both recordings to fresh stores with identical
        indexes: alloc set, per-table indexes and the full store digest
        must be byte-identical."""
        with monkeypatch.context() as m:
            _h1, obj_plans = _run_storm(m, columnar=False)
        with monkeypatch.context() as m:
            _h2, col_plans = _run_storm(m, columnar=True)
        stores = []
        for plans in (obj_plans, col_plans):
            s = StateStore()
            s.upsert_allocs_batched(
                [(5000 + i, _plan_allocs(p))
                 for i, p in enumerate(plans)])
            stores.append(s)
        s_obj, s_col = stores
        assert s_obj.get_index("allocs") == s_col.get_index("allocs")
        assert sorted(a.id for a in s_obj.allocs()) == \
            sorted(a.id for a in s_col.allocs())
        # The commit kept the rows lazy (checked before the digest
        # below materializes them).
        assert all("task_resources" not in a.__dict__
                   for a in s_col.allocs())
        assert s_obj.fingerprint() == s_col.fingerprint()

    @pytest.mark.parametrize("engine", ["host", "device"])
    def test_verify_window_does_not_materialize_slab_rows(
            self, monkeypatch, engine):
        """The window verify consumes slab columns: after a full
        evaluate_window pass — the host engine, or K6's plain version
        under the device policy — the plan's slab allocs still have no
        heavy fields in their dicts."""
        from nomad_tpu_torch.ops.plan_conflict import evaluate_window

        with monkeypatch.context() as m:
            h, plans = _run_storm(m, columnar=True)
            snap = h.state.snapshot()
            with verify_override(engine):
                outcomes = evaluate_window(snap, plans, device="cpu")
                if engine == "device":
                    # The first window of a fresh fleet generation
                    # misses the lease; the second dispatches.
                    outcomes = evaluate_window(snap, plans, device="cpu")
                    assert outcomes.info["device"]["dispatched"]
        assert len(outcomes) == len(plans)
        assert all(o.result.node_allocation for o in outcomes)
        for p in plans:
            for a in _plan_allocs(p):
                for heavy in ("resources", "task_resources", "metrics"):
                    assert heavy not in a.__dict__, \
                        f"window verify materialized {heavy}"


class _RecordingPlanner:
    """VerifyingPlanner wrapper recording every plan verdict — the
    rejection/partial-accept stream the contended parity rig
    byte-compares between the two contracts."""

    def __init__(self, harness):
        self.inner = VerifyingPlanner(harness)
        self.verdicts: list = []

    @property
    def device(self):
        return self.inner.device

    def _record(self, plan, result):
        self.verdicts.append((
            plan.eval_id,
            _norm_result(result),
            bool(result.refresh_index),
        ))

    def submit_plans(self, plans):
        out = self.inner.submit_plans(plans)
        for plan, (result, _state) in zip(plans, out):
            self._record(plan, result)
        return out

    def submit_plan(self, plan):
        result, state = self.inner.submit_plan(plan)
        self._record(plan, result)
        return result, state

    def update_eval(self, ev):
        self.inner.update_eval(ev)

    def create_eval(self, ev):
        self.inner.create_eval(ev)


def _norm_result(result):
    out = {}
    for node_id, allocs in result.node_allocation.items():
        rows = []
        for a in allocs:
            d = a.to_dict()
            d["metrics"]["allocation_time"] = 0.0
            rows.append(d)
        out[node_id] = rows
    return out


def _storm_jobs(prefix, n_jobs, cpu):
    jobs = []
    for j in range(n_jobs):
        job = mock.job()
        job.id = f"{prefix}-{j}"
        job.name = f"{prefix}-{j}"
        job.task_groups = [
            TaskGroup(
                name=f"tg-{g}", count=2,
                tasks=[Task(
                    name="web", driver="exec",
                    resources=Resources(
                        cpu=cpu, memory_mb=256,
                        networks=[NetworkResource(
                            mbits=5, dynamic_ports=["http"])]))])
            for g in range(4)]
        jobs.append(job)
    return jobs


class TestContendedStormParity:
    """A contended fused storm (the port's BatchEvalRunner through its
    VerifyingPlanner) replayed through both contracts — alloc set,
    rejections, per-table indexes, and the store fingerprint
    byte-compared."""

    def _storm(self, monkeypatch, columnar: bool):
        _deterministic(monkeypatch)
        monkeypatch.setattr(alloc_slab, "COLUMNAR", columnar)
        # 6 nodes under 8 jobs x 4 TGs x count 2 at cpu=600: the later
        # evals over-commit the fleet, so the verifying planner emits
        # the full verdict spectrum (accepts, partial accepts with a
        # refresh, rejections) — not just the happy path.
        key = ("contended", 6, 8)
        world = _WORLD_CACHE.get(key)
        if world is None:
            world = _WORLD_CACHE[key] = (
                [mock.node(i) for i in range(6)],
                _storm_jobs("storm-job", 8, 600))
        nodes, jobs = world
        h = Harness(device="cpu")
        for n in nodes:
            h.state.upsert_node(h.next_index(), n.copy())
        for job in jobs:
            h.state.upsert_job(h.next_index(), job.copy())
        h.planner = _RecordingPlanner(h)
        evals = [Evaluation(id=f"storm-ev-{j.id}", priority=50,
                            type=j.type,
                            triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                            job_id=j.id) for j in jobs]
        BatchEvalRunner(h.state.snapshot(), h, state_refresh=h.snapshot,
                        device="cpu").process(evals)
        return h

    def test_storm_replay_byte_parity(self, monkeypatch):
        with monkeypatch.context() as m:
            h_obj = self._storm(m, columnar=False)
        with monkeypatch.context() as m:
            h_col = self._storm(m, columnar=True)

        # The verdict stream: same plans, same accepted portions, same
        # rejections/refreshes, in the same order.
        v_obj = h_obj.planner.verdicts
        v_col = h_col.planner.verdicts
        assert len(v_obj) == len(v_col)
        assert v_obj == v_col
        assert any(refresh for _e, _n, refresh in v_obj), \
            "storm produced no contention — the rig lost its teeth"
        assert h_obj.planner.inner.conflicts == \
            h_col.planner.inner.conflicts

        # Alloc set + per-table indexes + full store digest.
        assert sorted(a.id for a in h_obj.state.allocs()) == \
            sorted(a.id for a in h_col.state.allocs())
        for table in ("allocs", "nodes", "jobs", "evals"):
            assert h_obj.state.get_index(table) == \
                h_col.state.get_index(table), table
        assert h_obj.state.fingerprint() == h_col.state.fingerprint()
        # And the columnar run genuinely rode slabs.
        assert any(type(a) is SlabAlloc for a in h_col.state.allocs())


# ---------------------------------------------------------------------------
# 2. lazy materialization semantics
# ---------------------------------------------------------------------------

class TestLazyMaterialization:
    def _one_alloc(self, monkeypatch):
        h, plans = _run_storm(monkeypatch, columnar=True, n_jobs=1)
        allocs = _plan_allocs(plans[0])
        assert allocs
        return allocs[0]

    def test_fields_materialize_on_read_and_round_trip(
            self, monkeypatch):
        a = self._one_alloc(monkeypatch)
        assert "task_resources" not in a.__dict__
        d = a.to_dict()  # materializes through the properties
        assert "task_resources" in a.__dict__
        twin = Allocation.from_dict(d)
        assert twin.to_dict() == d
        # Ports in the offer match the slab's column slice.
        slab, r = a.__dict__["_slab"], a.__dict__["_srow"]
        ports = [p for tr in a.task_resources.values()
                 for n in tr.networks for p in n.reserved_ports]
        o0, o1 = int(slab.port_off[r]), int(slab.port_off[r + 1])
        assert ports == slab.ports[o0:o1].tolist()

    def test_slab_vec_and_net_row_match_materialized_truth(
            self, monkeypatch):
        from nomad_tpu_torch.models.fleet import (_net_row,
                                                  _net_row_build,
                                                  _res_vector, alloc_vec)

        a = self._one_alloc(monkeypatch)
        vec = alloc_vec(a)          # columnar fast path (unmaterialized)
        row = _net_row(a)
        assert "task_resources" not in a.__dict__
        assert "resources" not in a.__dict__
        # Materialize and recompute the object truth.
        assert list(vec) == list(_res_vector(a.resources))
        assert row == _net_row_build(a)

    def test_copy_preserves_slab_backing(self, monkeypatch):
        a = self._one_alloc(monkeypatch)
        c = a.copy()
        assert type(c) is SlabAlloc
        assert c.__dict__["_slab"] is a.__dict__["_slab"]
        assert "task_resources" not in c.__dict__
        assert c.to_dict() == a.to_dict()

    def test_heavy_assignment_flags_row_off_the_columnar_wire(
            self, monkeypatch):
        a = self._one_alloc(monkeypatch)
        assert slab_ref(a) is not None
        c = a.copy()
        c.task_resources = {}
        assert slab_ref(c) is None, \
            "a mutated heavy field must disable slab-reference encoding"
        assert slab_ref(a) is not None, "flag must not leak to siblings"

    def test_eviction_copy_rides_wire_as_scalar_delta(self, monkeypatch):
        a = self._one_alloc(monkeypatch)
        ev = a.copy()
        ev.desired_status = ALLOC_DESIRED_STATUS_STOP
        ev.desired_description = "alloc not needed"
        ref = slab_ref(ev)
        assert ref is not None
        _slab, _r, delta = ref
        assert delta == {"desired_status": ALLOC_DESIRED_STATUS_STOP,
                         "desired_description": "alloc not needed"}

    def test_refcount_reclaims_materialized_family(self, monkeypatch):
        """No cycles: dropping the plan frees allocs AND slab with gc
        disabled, even after materialization and the row cache."""
        h, plans = _run_storm(monkeypatch, columnar=True, n_jobs=1)
        allocs = _plan_allocs(plans[0])
        allocs[0].to_dict()  # materialize one row
        slab = allocs[0].__dict__["_slab"]
        slab.alloc(0)  # populate the row cache too
        refs = [weakref.ref(a) for a in allocs] + [weakref.ref(slab)]
        was = gc.isenabled()
        gc.disable()
        try:
            del allocs, slab
            h.plans.clear()
            for p in plans:
                p.node_allocation.clear()
            del plans, h
            assert all(r() is None for r in refs), \
                "slab family survived refcount-only teardown"
        finally:
            if was:
                gc.enable()

    def test_committed_rows_stay_lazy_and_carry_task_states(
            self, monkeypatch):
        """The store's upsert of a slab row over a slab row skips the
        task_states carry-over (both canonically empty) and leaves the
        row lazy; a row that carries task_states keeps them."""
        a = self._one_alloc(monkeypatch)
        s = StateStore()
        s.upsert_allocs_batched([(10, [a])])
        s.upsert_allocs_batched([(11, [a])])
        stored = s.alloc_by_id(a.id)
        assert type(stored) is SlabAlloc
        assert stored.create_index == 10 and stored.modify_index == 11
        for heavy in ("task_states", "task_resources", "metrics"):
            assert heavy not in stored.__dict__, heavy
        assert slab_ref(stored) is not None
        upd = stored.copy()
        upd.task_states = {"web": {"state": "running"}}
        s.upsert_allocs_batched([(12, [upd])])
        s.upsert_allocs_batched([(13, [a])])
        assert s.alloc_by_id(a.id).task_states == \
            {"web": {"state": "running"}}


# ---------------------------------------------------------------------------
# 3. slab cache invalidation
# ---------------------------------------------------------------------------

class TestCacheInvalidation:
    def _slab(self, monkeypatch):
        h, plans = _run_storm(monkeypatch, columnar=True, n_jobs=1)
        payload = msgpack.unpackb(
            msgpack.packb(
                encode_alloc_update(_plan_allocs(plans[0])),
                use_bin_type=True),
            raw=False, strict_map_key=False)
        return decode_slabs(payload)[0]

    def test_alloc_cached_then_invalidated_by_patch_row(
            self, monkeypatch):
        slab = self._slab(monkeypatch)
        a1 = slab.alloc(0)
        assert slab.alloc(0) is a1, "canonical row objects are cached"
        old_node = a1.node_id
        slab.patch_row(0, node_id="moved-node")
        a2 = slab.alloc(0)
        assert a2 is not a1, \
            "a patched row must not serve the stale cached object"
        assert a2.node_id == "moved-node"
        # The already-handed-out object keeps its snapshot (store
        # immutability semantics), it just stops being served.
        assert a1.node_id == old_node

    def test_alloc_with_is_never_cached(self, monkeypatch):
        slab = self._slab(monkeypatch)
        a = slab.alloc_with(0, create_index=9, modify_index=9)
        assert a.create_index == 9
        assert slab.alloc(0) is not a
        assert slab.alloc(0).create_index == 0

    def test_patch_row_rejects_non_scalar_columns(self, monkeypatch):
        slab = self._slab(monkeypatch)
        with pytest.raises(KeyError):
            slab.patch_row(0, task_resources={})

    def test_patch_row_does_not_leak_into_sibling_slabs(
            self, monkeypatch):
        """Scheduler-built slabs alias names/tgs (and groups) to the
        per-job-version col_meta cache, shared read-only with every
        sibling slab of the same job version — patch_row must
        copy-on-write, not rewrite a sibling's canonical rows through
        the shared list."""
        h, plans = _run_storm(monkeypatch, columnar=True, n_jobs=1)
        proto = _plan_allocs(plans[0])[0].__dict__["_slab"]

        def sibling():
            s = AllocSlab(
                eval_id=proto.eval_id, job=proto.job,
                slots=proto.slots, metric_proto=proto.metric_proto,
                groups=proto.groups,        # shared, like col_meta
                ids=list(proto.ids), names=proto.names,   # shared
                tgs=proto.tgs,              # shared
                scores=list(proto.scores),
                port_off=np.asarray(proto.port_off), n_rows=proto.n)
            s.node_ids = list(proto.node_ids)
            s.ips = list(proto.ips)
            s.devs = list(proto.devs)
            s.seal(proto.n)
            return s
        slab_a, slab_b = sibling(), sibling()
        assert slab_a.names is slab_b.names, \
            "precondition: siblings share the col_meta names column"
        before = slab_b.names[0]
        slab_a.patch_row(0, name="patched-name", task_group="patched-tg")
        assert slab_a.names[0] == "patched-name"
        assert slab_b.names[0] == before, \
            "patch_row leaked through the shared col_meta column"
        assert slab_b.alloc(0).name == before
        assert slab_a.alloc(0).name == "patched-name"
        # Second patch mutates the now-private columns in place.
        slab_a.patch_row(1, name="second-patch")
        assert slab_b.names[1] == proto.names[1]


# ---------------------------------------------------------------------------
# 4. the fused storm's one-call native finish against the JAX package
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _seeded(seed=7):
    """Python's ``random`` seeded for one run (each plan's port LCG is
    seeded from it), restored after."""
    saved = random.getstate()
    random.seed(seed)
    try:
        yield
    finally:
        random.setstate(saved)


class _RecordOnly:
    """Accepts every plan without applying it (bench.py's record-only
    planner), so every lane sees one snapshot."""

    def __init__(self, plan_result, device=None):
        self.plan_result = plan_result
        self.device = device
        self.plans = []

    def submit_plan(self, plan):
        self.plans.append(plan)
        return self.plan_result(
            node_update=plan.node_update,
            node_allocation=plan.node_allocation,
            failed_allocs=plan.failed_allocs), None

    def update_eval(self, ev):
        pass

    def create_eval(self, ev):
        pass


def _lane_placements(plans):
    return [{a.name: (node_id, tuple(
        p for tr in a.task_resources.values() for n in tr.networks
        for p in n.reserved_ports))
        for node_id, allocs in plan.node_allocation.items()
        for a in allocs} for plan in plans]


def test_storm_finish_is_one_native_call_and_equals_jax(monkeypatch):
    """A fused storm of 6 lanes: the port's _finish_lanes makes ONE
    bulk_finish_many call, every lane finishes all its placements in C,
    and every lane's plan equals the JAX package's (its own
    _finish_lanes, under mesh_override("off") and
    executor_override("device")) in nodes and ports; the same storm
    through the Python tails alone equals it too."""
    from nomad_tpu.structs import PlanResult as JPlanResult
    from nomad_tpu_torch.structs import PlanResult

    nodes = [jmock.node(i) for i in range(16)]
    jobs = []
    for j in range(6):
        job = jmock.job()
        job.id = f"lane-job-{j}"
        job.task_groups[0].count = 5
        jobs.append(job)
    evals = [Evaluation(id=f"lane-ev-{j}", priority=50, type="service",
                        triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                        job_id=f"lane-job-{j}") for j in range(6)]

    from nomad_tpu.structs import Evaluation as JEvaluation
    jh = JHarness()
    for n in nodes:
        jh.state.upsert_node(jh.next_index(), n)
    for job in jobs:
        jh.state.upsert_job(jh.next_index(), job)
    jplanner = _RecordOnly(JPlanResult)
    with mesh_override("off"), executor_override("device"), _seeded():
        JRunner(jh.state.snapshot(), jplanner).process(
            [JEvaluation.from_dict(e.to_dict()) for e in evals])

    def port_storm(native_on):
        th = Harness(device="cpu")
        for n in convert.nodes_from_reference(nodes):
            th.state.upsert_node(th.next_index(), n)
        for job in convert.jobs_from_reference(jobs):
            th.state.upsert_job(th.next_index(), job)
        planner = _RecordOnly(PlanResult, "cpu")
        with _seeded():
            BatchEvalRunner(th.state.snapshot(), planner,
                            device="cpu").process(evals)
        return planner.plans

    real = tb._native_bulk
    calls = {"many": 0, "lanes": []}

    class Counting:
        def __getattr__(self, name):
            return getattr(real(), name)

        def bulk_finish_many(self, items):
            calls["many"] += 1
            out = real().bulk_finish_many(items)
            # (resume index, placements): a[2] is the lane's uuids
            calls["lanes"] += [(r[0], len(a[2]))
                               for r, a in zip(out, items)]
            return out

    with monkeypatch.context() as m:
        m.setattr(tb, "_native_bulk", Counting)
        nat = port_storm(True)
    with monkeypatch.context() as m:
        m.setattr(tb, "_native_bulk", lambda: None)
        py = port_storm(False)
    assert calls["many"] == 1
    assert len(calls["lanes"]) == 6
    assert all(done == n == 5 for done, n in calls["lanes"]), calls
    want = _lane_placements(jplanner.plans)
    assert _lane_placements(nat) == want
    assert _lane_placements(py) == want
    assert all(type(a) is SlabAlloc
               for p in nat for a in _plan_allocs(p))
