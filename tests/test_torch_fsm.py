"""The port's FSM and codec against the JAX package's, entry for entry.

The twin of tests/test_fsm_port.py: the same codec-encoded raft entries
— every message type, ``PLAN_BATCH_APPLY_REQUEST`` with columnar slab
references included — are applied to the JAX package's ``NomadFSM`` and
to the port's; the two stores must digest equal
(``fingerprint()``, changelog included, and
``fingerprint(changelog_since=10**9)``).  The port's codec must give
the JAX codec's bytes for every entry, and the port's slab wire must
re-encode a JAX payload it decoded to the same bytes.  Snapshots
round-trip within the port and across the two packages (one snapshot
format).

The slab allocs come from the JAX package's own scheduler on a small
mock cluster, under its host executor (no jit), so the wire carries
what a scheduler emits: shared job and slot templates, dynamic ports.
"""
from __future__ import annotations

import pytest

import nomad_tpu.mock as jmock
from nomad_tpu.parallel.mesh import mesh_override
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.scheduler.executor import executor_override
from nomad_tpu.server.eval_broker import EvalBroker as JBroker
from nomad_tpu.server.fsm import NomadFSM as JFSM
from nomad_tpu.structs import Evaluation as JEvaluation
from nomad_tpu.structs import codec as jcodec
from nomad_tpu.structs import generate_uuid
from nomad_tpu.structs.alloc_slab import encode_alloc_update as j_encode_update
from nomad_tpu.structs.alloc_slab import encode_plan_batch as j_encode_batch
from nomad_tpu_torch.server.eval_broker import EvalBroker as TBroker
from nomad_tpu_torch.server.fsm import NomadFSM as TFSM
from nomad_tpu_torch.structs import codec as tcodec
from nomad_tpu_torch.structs.alloc_slab import (
    decode_alloc_list as t_decode_alloc_list,
)
from nomad_tpu_torch.structs.alloc_slab import decode_slabs as t_decode_slabs
from nomad_tpu_torch.structs.alloc_slab import (
    encode_alloc_update as t_encode_update,
)
from nomad_tpu_torch.structs.alloc_slab import (
    encode_plan_batch as t_encode_batch,
)

MSG_TYPES = ("NODE_REGISTER_REQUEST", "NODE_DEREGISTER_REQUEST",
             "NODE_UPDATE_STATUS_REQUEST", "NODE_UPDATE_DRAIN_REQUEST",
             "JOB_REGISTER_REQUEST", "JOB_DEREGISTER_REQUEST",
             "EVAL_UPDATE_REQUEST", "EVAL_DELETE_REQUEST",
             "ALLOC_UPDATE_REQUEST", "ALLOC_CLIENT_UPDATE_REQUEST",
             "PLAN_BATCH_APPLY_REQUEST", "IGNORE_UNKNOWN_TYPE_FLAG")


def _scheduled_plans(nodes, jobs):
    """Each job's placements (SlabAllocs) from the JAX scheduler, one
    eval per job on a harness holding ``nodes``."""
    h = JHarness()
    for n in nodes:
        h.state.upsert_node(h.next_index(), n)
    out = []
    for job in jobs:
        h.state.upsert_job(h.next_index(), job)
        ev = JEvaluation(id=generate_uuid(), priority=job.priority,
                         type=job.type, triggered_by="job-register",
                         job_id=job.id)
        with executor_override("host"), mesh_override("off"):
            h.process("jax-binpack", ev)
        out.append([a for v in h.plans[-1].node_allocation.values()
                    for a in v])
    return out


@pytest.fixture(scope="module")
def world():
    nodes = [jmock.node(i) for i in range(6)]
    jobs = [jmock.job() for _ in range(3)]
    for k, job in enumerate(jobs):
        job.task_groups[0].count = 3 + k
    evals = [jmock.eval() for _ in range(3)]
    for ev, job in zip(evals, jobs):
        ev.job_id = job.id
    plans = _scheduled_plans(nodes, jobs[:2])
    for allocs in plans:
        assert allocs and all(type(a).__name__ == "SlabAlloc"
                              for a in allocs)
    dict_allocs = [jmock.alloc() for _ in range(2)]
    return dict(nodes=nodes, jobs=jobs, evals=evals, plans=plans,
                dict_allocs=dict_allocs)


def _entries(world, case):
    """(msg_type, payload) entries: the setup a case needs, then the
    entry under test last."""
    n, j, e = world["nodes"], world["jobs"], world["evals"]
    reg_nodes = [(jcodec.NODE_REGISTER_REQUEST, {"node": x.to_dict()})
                 for x in n]
    reg_jobs = [(jcodec.JOB_REGISTER_REQUEST, {"job": x.to_dict()})
                for x in j]
    evals = [(jcodec.EVAL_UPDATE_REQUEST,
              {"evals": [x.to_dict() for x in e]})]
    plans = world["plans"]
    batch = [(jcodec.PLAN_BATCH_APPLY_REQUEST, j_encode_batch(plans))]
    if case == "NODE_REGISTER_REQUEST":
        return reg_nodes
    if case == "NODE_DEREGISTER_REQUEST":
        return reg_nodes + [(jcodec.NODE_DEREGISTER_REQUEST,
                             {"node_id": n[0].id})]
    if case == "NODE_UPDATE_STATUS_REQUEST":
        return reg_nodes + [(jcodec.NODE_UPDATE_STATUS_REQUEST,
                             {"node_id": n[1].id, "status": "down"})]
    if case == "NODE_UPDATE_DRAIN_REQUEST":
        return reg_nodes + [(jcodec.NODE_UPDATE_DRAIN_REQUEST,
                             {"node_id": n[2].id, "drain": True})]
    if case == "JOB_REGISTER_REQUEST":
        return reg_jobs
    if case == "JOB_DEREGISTER_REQUEST":
        return reg_jobs + [(jcodec.JOB_DEREGISTER_REQUEST,
                            {"job_id": j[0].id})]
    if case == "EVAL_UPDATE_REQUEST":
        return reg_jobs + evals
    if case == "EVAL_DELETE_REQUEST":
        return reg_jobs + evals + batch + [
            (jcodec.EVAL_DELETE_REQUEST,
             {"evals": [e[0].id],
              "allocs": [a.id for a in plans[0][:2]]})]
    if case == "ALLOC_UPDATE_REQUEST":
        # the per-alloc dict wire, then one eval's columnar references
        return reg_nodes + [
            (jcodec.ALLOC_UPDATE_REQUEST,
             {"alloc": [a.to_dict() for a in world["dict_allocs"]]}),
            (jcodec.ALLOC_UPDATE_REQUEST, j_encode_update(plans[0]))]
    if case == "ALLOC_CLIENT_UPDATE_REQUEST":
        update = plans[0][0].copy()
        update.client_status = "failed"
        update.job = None  # the client strips the job payload
        return reg_nodes + batch + [(jcodec.ALLOC_CLIENT_UPDATE_REQUEST,
                                     {"alloc": [update.to_dict()]})]
    if case == "PLAN_BATCH_APPLY_REQUEST":
        return reg_nodes + reg_jobs + evals + batch
    if case == "IGNORE_UNKNOWN_TYPE_FLAG":
        return reg_nodes + [(jcodec.IGNORE_UNKNOWN_TYPE_FLAG | 101, {})]
    raise AssertionError(case)


def _apply_both(entries, jfsm=None, tfsm=None):
    jfsm = jfsm or JFSM()
    tfsm = tfsm or TFSM()
    for index, (msg_type, payload) in enumerate(entries, start=1):
        jbytes = jcodec.encode(msg_type, payload)
        tbytes = tcodec.encode(msg_type, payload)
        assert tbytes == jbytes, f"codec bytes differ at entry {index}"
        assert tcodec.decode(jbytes) == jcodec.decode(jbytes)
        assert jfsm.apply(index, jbytes) == tfsm.apply(index, jbytes)
    return jfsm, tfsm


def _assert_same_store(jfsm, tfsm):
    assert tfsm.state.fingerprint() == jfsm.state.fingerprint()
    assert tfsm.state.fingerprint(changelog_since=10**9) == \
        jfsm.state.fingerprint(changelog_since=10**9)


@pytest.mark.parametrize("case", MSG_TYPES)
def test_entry_applies_like_jax(world, case):
    jfsm, tfsm = _apply_both(_entries(world, case))
    _assert_same_store(jfsm, tfsm)
    assert tfsm.timetable.serialize()[:1] and \
        [i for i, _t in tfsm.timetable.serialize()] == \
        [i for i, _t in jfsm.timetable.serialize()]


def test_codec_constants_are_the_jax_codec(world):
    for name in MSG_TYPES:
        assert getattr(tcodec, name) == getattr(jcodec, name), name
    with pytest.raises(ValueError):
        tcodec.decode(b"")


def test_unknown_type_errors_unless_flagged_ignorable_like_jax():
    for fsm in (JFSM(), TFSM()):
        with pytest.raises(ValueError, match="unknown type"):
            fsm.apply(1, jcodec.encode(101, {}))
        assert fsm.apply(
            2, jcodec.encode(jcodec.IGNORE_UNKNOWN_TYPE_FLAG | 101,
                             {})) is None


@pytest.mark.parametrize("enabled", [True, False])
def test_pending_evals_enter_the_broker_like_jax(world, enabled):
    """fsm.go:243-250: pending evals (re-)enter an enabled broker on
    apply; a disabled one takes nothing."""
    jb = JBroker(nack_timeout=5, delivery_limit=2)
    tb = TBroker(nack_timeout=5, delivery_limit=2)
    try:
        jb.set_enabled(enabled)
        tb.set_enabled(enabled)
        _apply_both(_entries(world, "EVAL_UPDATE_REQUEST"),
                    JFSM(eval_broker=jb), TFSM(eval_broker=tb))
        assert tb.stats() == jb.stats()
        assert tb.stats()["total_ready"] == (3 if enabled else 0)
    finally:
        jb.shutdown()
        tb.shutdown()


def test_port_reencodes_a_jax_plan_batch_byte_for_byte(world):
    """The slab wire both ways: the port decodes the JAX payload into
    lazy slab rows and its encoder gives back the same bytes."""
    payload = j_encode_batch(world["plans"])
    slabs = t_decode_slabs(payload)
    lists = [t_decode_alloc_list(sub["alloc"], slabs)
             for sub in payload["plans"]]
    assert [type(a).__name__ for a in lists[0]] == \
        ["SlabAlloc"] * len(lists[0])
    assert tcodec.encode(tcodec.PLAN_BATCH_APPLY_REQUEST,
                         t_encode_batch(lists)) == \
        jcodec.encode(jcodec.PLAN_BATCH_APPLY_REQUEST, payload)
    assert tcodec.encode(tcodec.ALLOC_UPDATE_REQUEST,
                         t_encode_update(lists[1])) == \
        jcodec.encode(jcodec.ALLOC_UPDATE_REQUEST,
                      j_encode_update(world["plans"][1]))


def test_apply_hook_fires_per_entry():
    seen = []
    fsm = TFSM(on_apply=lambda idx, t, payload: seen.append((idx, t)))
    node = jmock.node()
    fsm.apply(7, jcodec.encode(jcodec.NODE_REGISTER_REQUEST,
                               {"node": node.to_dict()}))
    assert seen == [(7, jcodec.NODE_REGISTER_REQUEST)]


def _full(world):
    return _entries(world, "PLAN_BATCH_APPLY_REQUEST") + [
        (jcodec.ALLOC_UPDATE_REQUEST,
         {"alloc": [a.to_dict() for a in world["dict_allocs"]]})]


def test_snapshot_round_trip_restores_an_equal_store(world):
    _jfsm, tfsm = _apply_both(_full(world))
    blob = tfsm.snapshot()
    fresh = TFSM()
    fresh.restore(blob)
    assert fresh.state.fingerprint(changelog_since=10**9) == \
        tfsm.state.fingerprint(changelog_since=10**9)
    assert fresh.timetable.serialize() == tfsm.timetable.serialize()
    for table in ("nodes", "jobs", "evals", "allocs"):
        assert fresh.state.get_index(table) == tfsm.state.get_index(table)
    slab_rows = [a for a in fresh.state.allocs()
                 if type(a).__name__ == "SlabAlloc"]
    assert len(slab_rows) == sum(len(p) for p in world["plans"]), \
        "slab rows must restore from SNAP_ALLOC_SLAB records"
    assert tfsm.snapshot() == blob


def test_snapshots_restore_across_the_two_packages(world):
    """One snapshot format: a JAX snapshot restores into the port and a
    port snapshot into the JAX package, to equal stores."""
    jfsm, tfsm = _apply_both(_full(world))
    want = jfsm.state.fingerprint(changelog_since=10**9)
    into_port = TFSM()
    into_port.restore(jfsm.snapshot())
    into_jax = JFSM()
    into_jax.restore(tfsm.snapshot())
    assert into_port.state.fingerprint(changelog_since=10**9) == want
    assert into_jax.state.fingerprint(changelog_since=10**9) == want


def test_restore_replaces_not_merges(world):
    _jfsm, tfsm = _apply_both(_full(world))
    blob = tfsm.snapshot()
    dirty = TFSM()
    stray = jmock.node()
    dirty.apply(1, jcodec.encode(jcodec.NODE_REGISTER_REQUEST,
                                 {"node": stray.to_dict()}))
    dirty.restore(blob)
    assert dirty.state.node_by_id(stray.id) is None
    assert len(list(dirty.state.nodes())) == len(world["nodes"])
