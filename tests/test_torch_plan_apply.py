"""The plan-apply table of tests/test_plan_apply_port.py (the
reference's plan_apply_test.go scenarios) against the port's
server/plan_apply.py.

The same three blocks as the JAX package's table: ``evaluate_plan``
(full and partial accept, all-at-once rejection), the per-node verdicts
of ``_evaluate_node_plan``, and the applier end to end on a port server
on the CPU with the snapshot-vs-commit window and the optimistic
verify/apply overlay.

Fleet arithmetic: mock nodes expose 4000 cpu / 8192 MB with 100 cpu /
256 MB reserved, so a 3900-cpu alloc fills a node exactly and a
4000-cpu ask can never fit.
"""
from __future__ import annotations

import pytest

import nomad_tpu_torch.mock as mock
from nomad_tpu_torch.server.plan_apply import (
    OptimisticSnapshot,
    _evaluate_node_plan,
    evaluate_plan,
)
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    ALLOC_DESIRED_STATUS_STOP,
    NODE_STATUS_DOWN,
    NODE_STATUS_INIT,
    Allocation,
    Plan,
    Resources,
    generate_uuid,
)

FREE_CPU = 3900  # mock node capacity 4000 minus 100 reserved


def make_alloc(node, *, cpu=1000, mem=1024, job_id="j1",
               desired=ALLOC_DESIRED_STATUS_RUN) -> Allocation:
    return Allocation(
        id=generate_uuid(),
        node_id=node.id,
        job_id=job_id,
        task_group="web",
        resources=Resources(cpu=cpu, memory_mb=mem),
        desired_status=desired,
        client_status=ALLOC_CLIENT_STATUS_PENDING,
    )


def place_plan(*allocs) -> Plan:
    plan = Plan(eval_id=generate_uuid())
    for a in allocs:
        plan.append_alloc(a)
    return plan


@pytest.fixture
def store():
    return StateStore()


# ---------------------------------------------------------------------------
# 1. evaluate_plan (TestPlanApply_EvalPlan_Simple / _Partial /
#    _Partial_AllAtOnce)
# ---------------------------------------------------------------------------

class TestEvalPlan:
    def test_simple_full_accept(self, store):
        node = mock.node()
        store.upsert_node(1000, node)
        plan = place_plan(make_alloc(node))
        result = evaluate_plan(store.snapshot(), plan)
        assert result.node_allocation == plan.node_allocation
        assert result.refresh_index == 0
        assert result.full_commit(plan)[0]

    def test_partial_accept_sets_refresh(self, store):
        """One fitting node, one over-committed: the fitting node's
        placements commit, the other's are dropped, and RefreshIndex
        forces the scheduler onto fresh state."""
        good, full = mock.node(), mock.node(1)
        store.upsert_node(1000, good)
        store.upsert_node(1001, full)
        store.upsert_allocs(1002, [make_alloc(full, cpu=FREE_CPU)])
        plan = place_plan(make_alloc(good), make_alloc(full, cpu=1000))
        result = evaluate_plan(store.snapshot(), plan)
        assert list(result.node_allocation) == [good.id]
        assert result.refresh_index >= 1002
        ok, expected, actual = result.full_commit(plan)
        assert not ok and expected == 2 and actual == 1

    def test_partial_all_at_once_rejects_whole_plan(self, store):
        good, full = mock.node(), mock.node(1)
        store.upsert_node(1000, good)
        store.upsert_node(1001, full)
        store.upsert_allocs(1002, [make_alloc(full, cpu=FREE_CPU)])
        plan = place_plan(make_alloc(good), make_alloc(full, cpu=1000))
        plan.all_at_once = True
        result = evaluate_plan(store.snapshot(), plan)
        assert result.node_allocation == {}
        assert result.node_update == {}
        assert result.refresh_index > 0

    def test_failed_allocs_always_ride_along(self, store):
        """failedAllocs carry scheduler verdicts, not node state — they
        commit even when every placement is rejected."""
        full = mock.node()
        store.upsert_node(1000, full)
        store.upsert_allocs(1001, [make_alloc(full, cpu=FREE_CPU)])
        plan = place_plan(make_alloc(full, cpu=1000))
        failed = make_alloc(full, cpu=1)
        failed.node_id = ""
        plan.append_failed(failed)
        result = evaluate_plan(store.snapshot(), plan)
        assert result.node_allocation == {}
        assert result.failed_allocs == [failed]


# ---------------------------------------------------------------------------
# 2. _evaluate_node_plan (TestPlanApply_EvalNodePlan_* table)
# ---------------------------------------------------------------------------

class TestEvalNodePlan:
    def _verdict(self, store, plan, node_id) -> bool:
        return _evaluate_node_plan(store.snapshot(), plan, node_id)

    def test_simple_fit(self, store):
        node = mock.node()
        store.upsert_node(1000, node)
        plan = place_plan(make_alloc(node))
        assert self._verdict(store, plan, node.id)

    def test_missing_node(self, store):
        node = mock.node()  # never upserted
        plan = place_plan(make_alloc(node))
        assert not self._verdict(store, plan, node.id)

    def test_node_not_ready(self, store):
        node = mock.node()
        node.status = NODE_STATUS_INIT
        store.upsert_node(1000, node)
        plan = place_plan(make_alloc(node))
        assert not self._verdict(store, plan, node.id)

    def test_node_drain(self, store):
        node = mock.node()
        node.drain = True
        store.upsert_node(1000, node)
        plan = place_plan(make_alloc(node))
        assert not self._verdict(store, plan, node.id)

    def test_node_full(self, store):
        node = mock.node()
        store.upsert_node(1000, node)
        store.upsert_allocs(1001, [make_alloc(node, cpu=FREE_CPU)])
        plan = place_plan(make_alloc(node, cpu=1000))
        assert not self._verdict(store, plan, node.id)

    def test_update_existing_in_place(self, store):
        """A plan REPLACING the alloc that fills the node fits: the
        proposed set removes the old copy first (in-place update
        semantics, upstream _UpdateExisting)."""
        node = mock.node()
        store.upsert_node(1000, node)
        existing = make_alloc(node, cpu=FREE_CPU)
        store.upsert_allocs(1001, [existing])
        replacement = existing.copy()
        plan = place_plan(replacement)
        assert self._verdict(store, plan, node.id)

    def test_node_full_with_evict(self, store):
        """Eviction in the same plan frees the capacity the placement
        needs (upstream _NodeFull_Evict)."""
        node = mock.node()
        store.upsert_node(1000, node)
        existing = make_alloc(node, cpu=FREE_CPU)
        store.upsert_allocs(1001, [existing])
        plan = place_plan(make_alloc(node, cpu=1000))
        plan.append_update(existing, ALLOC_DESIRED_STATUS_STOP, "evict")
        assert self._verdict(store, plan, node.id)

    def test_node_full_terminal_alloc_ignored(self, store):
        """A terminal existing alloc no longer holds resources
        (upstream _NodeFull_AllocEvict)."""
        node = mock.node()
        store.upsert_node(1000, node)
        store.upsert_allocs(1001, [
            make_alloc(node, cpu=FREE_CPU,
                       desired=ALLOC_DESIRED_STATUS_STOP)])
        plan = place_plan(make_alloc(node, cpu=1000))
        assert self._verdict(store, plan, node.id)

    def test_evict_only_on_down_node(self, store):
        """Evictions need no node health — a down node's allocs must
        still be stoppable (upstream _NodeDown_EvictOnly)."""
        node = mock.node()
        store.upsert_node(1000, node)
        existing = make_alloc(node)
        store.upsert_allocs(1001, [existing])
        store.update_node_status(1002, node.id, NODE_STATUS_DOWN)
        plan = Plan(eval_id=generate_uuid())
        plan.append_update(existing, ALLOC_DESIRED_STATUS_STOP, "evict")
        assert self._verdict(store, plan, node.id)


# ---------------------------------------------------------------------------
# 3. applyPlan end to end, the snapshot-vs-commit drain window, and the
#    optimistic verify/apply overlay
# ---------------------------------------------------------------------------

class TestApplyPlan:
    def test_apply_plan_end_to_end(self):
        """TestPlanApply_applyPlan: a token-fenced plan flows queue ->
        applier -> raft -> FSM; the result carries the commit index and
        the allocs land in state."""
        from nomad_tpu_torch.server import Server, ServerConfig

        srv = Server(ServerConfig(device="cpu", num_schedulers=0,
                                  tune_gc=False))
        srv.establish_leadership()
        try:
            node = mock.node()
            srv.node_register(node)
            from nomad_tpu_torch.structs import Evaluation
            ev = Evaluation(id=generate_uuid(), priority=50,
                            type="service", job_id="j1",
                            status="pending",
                            triggered_by="job-register")
            srv.apply_eval_update([ev])
            got, token = srv.eval_broker.dequeue(["service"], timeout=2)
            assert got.id == ev.id

            plan = place_plan(make_alloc(node))
            plan.eval_id = ev.id
            plan.eval_token = token
            result = srv.plan_queue.enqueue(plan).wait(5.0)
            assert result.alloc_index > 0
            placed = srv.fsm.state.allocs_by_node(node.id)
            assert [a.id for a in placed] == \
                [a.id for v in plan.node_allocation.values() for a in v]
        finally:
            srv.shutdown()

    def test_snapshot_vs_commit_drain_window(self, store):
        """The applier verifies against a SNAPSHOT: a drain landing
        between snapshot and commit is invisible to that verification
        (same window as the reference, plan_apply.go:238-284 — README
        Known limits) — but any verification on a post-drain snapshot
        rejects."""
        node = mock.node()
        store.upsert_node(1000, node)
        snap = store.snapshot()            # applier's view
        plan = place_plan(make_alloc(node))
        # Drain lands INSIDE the window (after snapshot, before apply).
        store.update_node_drain(1001, node.id, True)
        inside = evaluate_plan(snap, plan)
        assert inside.node_allocation == plan.node_allocation, \
            "the drain window is open by design: snapshot-time verdicts"
        after = evaluate_plan(store.snapshot(), plan)
        assert after.node_allocation == {}
        assert after.refresh_index > 0

    def test_optimistic_overlay_catches_uncommitted_conflicts(self, store):
        """Verify/apply overlap: plan N+1 must be checked against plan
        N's not-yet-committed allocs (OptimisticSnapshot), or two
        optimistic schedulers double-book the node."""
        node = mock.node()
        store.upsert_node(1000, node)
        snap = OptimisticSnapshot(store.snapshot())

        plan_n = place_plan(make_alloc(node, cpu=FREE_CPU))
        result_n = evaluate_plan(snap, plan_n)
        assert result_n.node_allocation == plan_n.node_allocation
        # Fold plan N's result into the overlay (raft apply in flight).
        snap.upsert_allocs(
            [a for v in result_n.node_allocation.values() for a in v])

        plan_n1 = place_plan(make_alloc(node, cpu=1000))
        overlay_verdict = evaluate_plan(snap, plan_n1)
        assert overlay_verdict.node_allocation == {}, \
            "overlay must reject the double-booked node"
        assert overlay_verdict.refresh_index > 0
        # Against the bare base snapshot the conflict is invisible —
        # which is exactly why the overlay exists.
        base_verdict = evaluate_plan(store.snapshot(), plan_n1)
        assert base_verdict.node_allocation == plan_n1.node_allocation

    def test_overlay_eviction_then_replacement_window(self, store):
        """Drain-window companion on the alloc axis: an eviction folded
        into the overlay frees capacity for the NEXT plan in the same
        apply window."""
        node = mock.node()
        store.upsert_node(1000, node)
        existing = make_alloc(node, cpu=FREE_CPU)
        store.upsert_allocs(1001, [existing])
        snap = OptimisticSnapshot(store.snapshot())

        evict = Plan(eval_id=generate_uuid())
        evict.append_update(existing, ALLOC_DESIRED_STATUS_STOP, "gone")
        result = evaluate_plan(snap, evict)
        assert result.node_update == evict.node_update
        snap.upsert_allocs(
            [a for v in result.node_update.values() for a in v])

        refill = place_plan(make_alloc(node, cpu=FREE_CPU))
        verdict = evaluate_plan(snap, refill)
        assert verdict.node_allocation == refill.node_allocation, \
            "overlay must see the eviction's freed capacity"
