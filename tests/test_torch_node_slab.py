"""The port's columnar node table (nomad_tpu_torch/structs/node_slab.py and
its store, fleet and constraint paths), twins of tests/test_node_slab.py
held against the JAX package.

Slabs are built in the JAX package (``mock.node_slab``) and carried over
with ``convert.node_slab_from_reference``, so both stores hold the same
node ids and the fleet tensors, masks and placements can be compared
directly.
"""
import numpy as np
import torch

import nomad_tpu.mock as jmock
from nomad_tpu.models.constraints import compile_constraint_mask as j_cmask
from nomad_tpu.models.constraints import compile_group_mask as j_gmask
from nomad_tpu.models.fleet import build_fleet as j_build_fleet
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.scheduler.util import task_group_constraints as j_tgc
from nomad_tpu.state.store import StateStore as JStore
from nomad_tpu.structs import Constraint as JConstraint
from nomad_tpu_torch import convert
from nomad_tpu_torch.scheduler.executor import executor_override as \
    t_executor_override
from nomad_tpu_torch import mock
from nomad_tpu_torch.models.constraints import (compile_constraint_mask,
                                                compile_group_mask)
from nomad_tpu_torch.models.fleet import build_fleet, fleet_cache
from nomad_tpu_torch.scheduler import Harness
from nomad_tpu_torch.scheduler.util import task_group_constraints
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import (EVAL_TRIGGER_JOB_REGISTER, Constraint,
                                     Evaluation, Node, generate_uuid,
                                     node_slab_of)

torch.set_num_threads(1)


def _norm(d: dict) -> dict:
    d = dict(d)
    d["id"] = "X"
    d["create_index"] = 0
    d["modify_index"] = 0
    return d


def _twin_slabs(n):
    jslab = jmock.node_slab(n)
    return jslab, convert.node_slab_from_reference(jslab)


def _stores(n, index=7):
    jslab, tslab = _twin_slabs(n)
    js, ts = JStore(), StateStore()
    js.upsert_node_slab(index, jslab)
    ts.upsert_node_slab(index, tslab)
    return jslab, tslab, js, ts


def _object_twin(slab) -> list:
    """Plain Node objects with the SAME ids/content as the slab rows —
    the object-path control."""
    return [Node.from_dict(slab.node(r).to_dict()) for r in range(slab.n)]


def test_slab_row_materializes_like_mock_node():
    slab = mock.node_slab(8)
    jslab, tslab = _twin_slabs(8)
    for r in (0, 3, 7):
        assert _norm(slab.node(r).to_dict()) == \
            _norm(mock.node(r).to_dict())
        assert tslab.node(r).to_dict() == jslab.node(r).to_dict()


def test_store_bulk_upsert_semantics():
    _jslab, slab, js, st = _stores(6, index=42)
    assert st.get_index("nodes") == js.get_index("nodes") == 42
    nodes = list(st.nodes())
    assert [n.id for n in nodes] == [n.id for n in js.nodes()]
    assert node_slab_of(nodes) is slab
    for n in nodes:
        assert st.node_by_id(n.id) is n
        assert n.create_index == n.modify_index == 42
    # A later object-path write rides the normal upsert contract and
    # detaches that row from the slab fast path.
    st.update_node_status(43, nodes[2].id, "down")
    assert node_slab_of(list(st.nodes())) is None
    assert st.node_by_id(nodes[2].id).status == "down"
    assert st.node_by_id(nodes[3].id).resources.cpu == 4000


def test_bulk_upsert_is_one_notification():
    slab = mock.node_slab(5)
    st = StateStore()
    seen = []
    orig = st.watch.notify
    st.watch.notify = lambda *k, **kw: (seen.append(k), orig(*k, **kw))
    st.upsert_node_slab(3, slab)
    assert seen == [(("nodes",),)]


def test_slab_copy_honors_node_copy_contract():
    slab = mock.node_slab(3)
    row = slab.node(1)
    c = row.copy()
    c.attributes["kernel.name"] = "plan9"
    assert row.attributes["kernel.name"] == "linux"
    assert slab.node(2).attributes["kernel.name"] == "linux"
    c2 = slab.node(2).copy()
    c2.drain = True
    assert "_hmut" in c2.__dict__
    assert "_hmut" not in slab.node(2).__dict__


def test_bulk_upsert_stamps_pre_materialized_rows():
    slab = mock.node_slab(4)
    early = slab.node(2)  # materialized pre-upsert, index still 0
    assert early.modify_index == 0
    st = StateStore()
    st.upsert_node_slab(42, slab)
    assert st.node_by_id(slab.ids[2]) is early
    assert early.create_index == early.modify_index == 42
    assert node_slab_of(list(st.nodes())) is slab


def test_fleet_statics_from_a_slab_equal_jax():
    """The port's slab fast path against the JAX package's
    _build_fleet_slab on the same slab, and against the port's own
    object path."""
    jslab, tslab, js, ts = _stores(24)
    fast = build_fleet(list(ts.nodes()))
    ref = j_build_fleet(list(js.nodes()))
    obj = build_fleet(_object_twin(tslab))
    assert fast.uniform and ref.uniform and not obj.uniform
    for other in (ref, obj):
        np.testing.assert_array_equal(fast.capacity, other.capacity)
        np.testing.assert_array_equal(fast.reserved, other.reserved)
        np.testing.assert_array_equal(fast.ready, other.ready)
        assert list(fast.datacenters) == list(other.datacenters)
        assert fast.node_ids == other.node_ids
        assert fast.index_of == other.index_of
        assert fast.n_real == other.n_real and fast.n_pad == other.n_pad
        assert fast.attr_rows[23] == other.attr_rows[23]
        assert len(fast.attr_rows) == len(other.attr_rows) == 24
        assert fast.meta_rows[0] == other.meta_rows[0]


def test_mutated_row_falls_back_to_exact_object_build():
    slab = mock.node_slab(4)
    st = StateStore()
    st.upsert_node_slab(5, slab)
    drained = list(st.nodes())[1]
    st.update_node_drain(6, drained.id, True)
    statics = fleet_cache.statics_for(st)
    assert not statics.uniform
    assert not statics.ready[statics.index_of[drained.id]]
    assert statics.ready[statics.index_of[list(st.nodes())[0].id]]


def test_uniform_constraint_masks_equal_object_walk_and_jax():
    jslab, tslab, js, ts = _stores(16)
    fast = build_fleet(list(ts.nodes()))
    obj = build_fleet(_object_twin(tslab))
    jfast = j_build_fleet(list(js.nodes()))
    jjob = jmock.job()
    job = convert.jobs_from_reference([jjob])[0]
    tgc = task_group_constraints(job.task_groups[0])
    jtgc = j_tgc(jjob.task_groups[0])
    m_fast, d_fast = compile_group_mask(
        fast, job.datacenters, job.constraints, tgc.constraints,
        tgc.drivers)
    m_obj, d_obj = compile_group_mask(
        obj, job.datacenters, job.constraints, tgc.constraints,
        tgc.drivers)
    m_jax, d_jax = j_gmask(jfast, jjob.datacenters, jjob.constraints,
                           jtgc.constraints, jtgc.drivers)
    assert d_fast == d_obj == d_jax
    np.testing.assert_array_equal(m_fast, m_obj)
    np.testing.assert_array_equal(m_fast, m_jax)
    assert m_fast[:16].all()
    bad = Constraint(hard=True, l_target="$attr.kernel.name",
                     r_target="plan9", operand="=")
    m2, _ = compile_group_mask(fast, job.datacenters, [bad], [], set())
    assert not m2.any()
    # A datacenter the fleet is not in.
    m3, _ = compile_group_mask(fast, ["dc2"], [], [], set())
    assert not m3.any()


def test_per_row_constraint_targets_skip_the_uniform_fast_path():
    """$node.id / $node.name resolve per ROW (dense slab columns): the
    one-representative-row compilation must not broadcast them."""
    jslab, tslab, js, ts = _stores(8)
    fast = build_fleet(list(ts.nodes()))
    assert fast.uniform
    obj = build_fleet(_object_twin(tslab))
    jfast = j_build_fleet(list(js.nodes()))
    for l_t, r_t, op in (("$node.name", "node-5", "="),
                         ("$node.name", "node-5", "!="),
                         ("$node.id", tslab.ids[3], "="),
                         ("$node.datacenter", "dc1", "=")):
        c = Constraint(hard=True, l_target=l_t, r_target=r_t, operand=op)
        jc = JConstraint(hard=True, l_target=l_t, r_target=r_t, operand=op)
        m = compile_constraint_mask(fast, c)
        np.testing.assert_array_equal(m, compile_constraint_mask(obj, c))
        np.testing.assert_array_equal(m, j_cmask(jfast, jc))
    m = compile_constraint_mask(fast, Constraint(
        hard=True, l_target="$node.name", r_target="node-5", operand="="))
    assert m[:8].tolist() == [False] * 5 + [True] + [False] * 2


def test_torch_binpack_on_a_slab_places_like_jax_binpack():
    """The same job stream against twin slab-backed stores: the port's
    torch-binpack places every copy where the JAX package's jax-binpack
    does."""
    from nomad_tpu.structs import Evaluation as JEvaluation

    jslab, tslab = _twin_slabs(16)
    jobs = []
    for _ in range(3):
        job = jmock.job()
        job.task_groups[0].count = 6
        jobs.append(job)

    def run(h, slab, scheduler, evaluation, job_objs):
        h.state.upsert_node_slab(h.next_index(), slab)
        rows = []
        for job in job_objs:
            h.state.upsert_job(h.next_index(), job)
            h.process(scheduler, evaluation(
                id=generate_uuid(), priority=job.priority, type=job.type,
                triggered_by=EVAL_TRIGGER_JOB_REGISTER, job_id=job.id))
            rows.append(sorted(
                (a.node_id, a.name) for a in h.state.allocs_by_job(job.id)
                if not a.terminal_status()))
        return rows

    j_rows = run(JHarness(), jslab, "jax-binpack", JEvaluation, jobs)
    with t_executor_override("device"):
        t_rows = run(Harness(device="cpu"), tslab, "torch-binpack",
                     Evaluation, convert.jobs_from_reference(jobs))
    assert t_rows == j_rows
    assert sum(len(r) for r in t_rows) == 18
