"""Replicated-log state machine over the MVCC store.

Capability parity with reference nomad/fsm.go:47-594: each log entry is
a 1-byte MessageType + msgpack body; apply dispatches into the StateStore;
pending evaluations re-enter the broker on apply (leader only); snapshots
persist TimeTable + all tables as type-prefixed msgpack records and restore
rebuilds a fresh store.

This is also where the state->device bridge hangs: alloc/node applies
invalidate the fleet-tensor caches (table-generation identity changes do it
implicitly — see nomad_tpu_torch/models/fleet.py FleetCache).

Counterpart of ``nomad_tpu/server/fsm.py``.
"""
from __future__ import annotations

import io
import time
from typing import Callable, Optional

import msgpack

from nomad_tpu_torch.obs import trace as trace_mod
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import (
    Allocation,
    Evaluation,
    Job,
    Node,
    codec,
)
from nomad_tpu_torch.structs.alloc_slab import (
    AllocSlab,
    SlabWireEncoder,
    decode_alloc_list,
    decode_slabs,
)
from nomad_tpu_torch.structs.codec import (
    ALLOC_CLIENT_UPDATE_REQUEST,
    ALLOC_UPDATE_REQUEST,
    PLAN_BATCH_APPLY_REQUEST,
    EVAL_DELETE_REQUEST,
    EVAL_UPDATE_REQUEST,
    JOB_DEREGISTER_REQUEST,
    JOB_REGISTER_REQUEST,
    NODE_DEREGISTER_REQUEST,
    NODE_REGISTER_REQUEST,
    NODE_UPDATE_DRAIN_REQUEST,
    NODE_UPDATE_STATUS_REQUEST,
)

from .timetable import TimeTable

# Snapshot record types (reference fsm.go:33-42).
SNAP_TIME_TABLE = 0
SNAP_NODE = 1
SNAP_JOB = 2
SNAP_EVAL = 3
SNAP_ALLOC = 4
SNAP_INDEX = 5
# Columnar extension (no reference analogue): one record carrying a
# whole AllocSlab family — shared job/slot templates encoded once, per-
# row scalar deltas (indexes, client merges) riding alongside.  Restore
# rebuilds lazy SlabAllocs that digest byte-identically to the object
# encoding (structs/alloc_slab.py).
SNAP_ALLOC_SLAB = 6


class NomadFSM:
    """Applies replicated log entries to the state store."""

    def __init__(self, eval_broker=None,
                 on_apply: Optional[Callable] = None) -> None:
        self.state = StateStore()
        self.timetable = TimeTable()
        self.eval_broker = eval_broker
        self.on_apply = on_apply  # hook: (index, msg_type, payload)
        # Raw-entry hook: (index, entry_bytes) BEFORE decode/apply.
        # The crash-recovery proofs record the applied history through
        # it and byte-compare a rebooted store against a replay of the
        # recorded committed prefix (tests/test_crash_recovery.py).
        self.on_entry: Optional[Callable] = None
        self._handlers = {
            NODE_REGISTER_REQUEST: self._apply_node_register,
            NODE_DEREGISTER_REQUEST: self._apply_node_deregister,
            NODE_UPDATE_STATUS_REQUEST: self._apply_node_status,
            NODE_UPDATE_DRAIN_REQUEST: self._apply_node_drain,
            JOB_REGISTER_REQUEST: self._apply_job_register,
            JOB_DEREGISTER_REQUEST: self._apply_job_deregister,
            EVAL_UPDATE_REQUEST: self._apply_eval_update,
            EVAL_DELETE_REQUEST: self._apply_eval_delete,
            ALLOC_UPDATE_REQUEST: self._apply_alloc_update,
            ALLOC_CLIENT_UPDATE_REQUEST: self._apply_alloc_client_update,
            PLAN_BATCH_APPLY_REQUEST: self._apply_plan_batch,
        }

    # -- apply ------------------------------------------------------------
    def apply(self, index: int, entry: bytes):
        if self.on_entry is not None:
            self.on_entry(index, bytes(entry))
        msg_type, payload, ignorable = codec.decode(entry)
        # consensus-ok(apply-wall-clock): reference parity (fsm.go
        # witnesses each entry's LOCAL arrival time for index<->time
        # lookups); the timetable is per-replica observability, outside
        # the replicated tables and the fingerprint() contract.
        self.timetable.witness(index, time.time())
        handler = self._handlers.get(msg_type)
        if handler is None:
            if ignorable:
                return None
            raise ValueError(f"failed to apply request: unknown type "
                             f"{msg_type}")
        result = handler(index, payload)
        if self.on_apply is not None:
            self.on_apply(index, msg_type, payload)
        return result

    def _apply_node_register(self, index: int, payload: dict):
        node = Node.from_dict(payload["node"])
        self.state.upsert_node(index, node)
        return None

    def _apply_node_deregister(self, index: int, payload: dict):
        self.state.delete_node(index, payload["node_id"])
        return None

    def _apply_node_status(self, index: int, payload: dict):
        self.state.update_node_status(index, payload["node_id"],
                                      payload["status"])
        return None

    def _apply_node_drain(self, index: int, payload: dict):
        self.state.update_node_drain(index, payload["node_id"],
                                     payload["drain"])
        return None

    def _apply_job_register(self, index: int, payload: dict):
        self.state.upsert_job(index, Job.from_dict(payload["job"]))
        return None

    def _apply_job_deregister(self, index: int, payload: dict):
        self.state.delete_job(index, payload["job_id"])
        return None

    def _apply_eval_update(self, index: int, payload: dict):
        evals = [Evaluation.from_dict(e) for e in payload["evals"]]
        self.state.upsert_evals(index, evals)
        # Pending evals (re-)enter the broker on apply (fsm.go:243-250);
        # the broker no-ops unless enabled (leader only).  ``force``:
        # admission control already ran at the RPC plane — an eval that
        # reached the replicated log is committed state, and shedding it
        # HERE would diverge the broker from state (and, on a real raft
        # apply path, fail the FSM).
        if self.eval_broker is not None:
            for ev in evals:
                if ev.should_enqueue():
                    # consensus-ok(leader-fence): the broker itself is
                    # the fence — enqueue no-ops unless enabled, and
                    # enabled flips only inside establish/revoke
                    # leadership, so a follower FSM applying this entry
                    # drops the enqueue on the floor by design.
                    self.eval_broker.enqueue(ev, force=True)
        return None

    def _apply_eval_delete(self, index: int, payload: dict):
        self.state.delete_eval(index, payload.get("evals", []),
                               payload.get("allocs", []))
        return None

    def _apply_alloc_update(self, index: int, payload: dict):
        """Scheduler-authoritative upsert.  Entries are per-alloc dicts
        or columnar [slab, row, delta] references (the group-commit
        applier's columnar wire, structs/alloc_slab.py); either way the
        store receives Allocation objects — slab rows as lazy
        SlabAllocs whose heavy fields never materialize on this path."""
        tracer = trace_mod.tracer() if trace_mod.ENABLED else None
        t0 = tracer.now() if tracer is not None else 0.0
        slabs = decode_slabs(payload)
        allocs = decode_alloc_list(payload["alloc"], slabs)
        t1 = tracer.now() if tracer is not None else 0.0
        self.state.upsert_allocs(index, allocs)
        if tracer is not None:
            self._record_apply_spans(tracer, payload.get("_trace"),
                                     [allocs], index, t0, t1,
                                     tracer.now())
        return None

    def _apply_plan_batch(self, index: int, payload: dict):
        """Group commit: one log entry carrying a whole plan window's
        accepted alloc sets, upserted in eval order under one store
        lock (state/store.py upsert_allocs_batched) — final state is
        byte-identical to one ALLOC_UPDATE_REQUEST per plan in order.
        Sub-plans share one columnar slab table (an eval's placements
        decode as lazy SlabAllocs straight from the columns — no object
        materialization between the wire and the store).  All allocs
        are constructed BEFORE any state moves so a malformed sub-plan
        rejects the entry with the store untouched."""
        tracer = trace_mod.tracer() if trace_mod.ENABLED else None
        t0 = tracer.now() if tracer is not None else 0.0
        slabs = decode_slabs(payload)
        items = [(index, decode_alloc_list(sub["alloc"], slabs))
                 for sub in payload["plans"]]
        t1 = tracer.now() if tracer is not None else 0.0
        self.state.upsert_allocs_batched(items)
        if tracer is not None:
            self._record_apply_spans(tracer, payload.get("_trace"),
                                     [allocs for _i, allocs in items],
                                     index, t0, t1, tracer.now())
        return None

    @staticmethod
    def _record_apply_spans(tracer, env, alloc_lists, index: int,
                            t0: float, t1: float, t2: float) -> None:
        """Per-sub-plan ``fsm.decode`` + ``store.upsert`` spans from the
        contexts the applier shipped inside the entry (``_trace`` —
        obs/trace.py): the raft thread has no ambient context, so the
        entry itself carries each eval's tree membership.  One upsert
        span per COMMITTED sub-plan, tagged with its alloc count — the
        exactly-once proof reads these (tests/test_obs.py)."""
        if not env:
            return
        for ctx, allocs in zip(env, alloc_lists):
            if not ctx:
                continue
            eval_id = ctx.get("eval_id", "")
            tracer.record("fsm.decode", t0, t1 - t0, parent_ctx=ctx,
                          eval_id=eval_id, index=index)
            tracer.record("store.upsert", t1, t2 - t1, parent_ctx=ctx,
                          eval_id=eval_id, index=index,
                          n_allocs=len(allocs))

    def _apply_alloc_client_update(self, index: int, payload: dict):
        allocs = [Allocation.from_dict(a) for a in payload["alloc"]]
        for a in allocs:
            self.state.update_alloc_from_client(index, a)
        return None

    # -- snapshot / restore -----------------------------------------------
    def snapshot(self) -> bytes:
        """Serialize the full state as a stream of (kind, payload) records
        (type-prefixed records, fsm.go:412-453)."""
        snap = self.state.snapshot()
        buf = io.BytesIO()

        def rec(kind: int, payload) -> None:
            buf.write(msgpack.packb((kind, payload), use_bin_type=True))

        rec(SNAP_TIME_TABLE, self.timetable.serialize())
        rec(SNAP_INDEX, {t: snap.get_index(t)
                         for t in ("nodes", "jobs", "evals", "allocs")})
        for node in snap.nodes():
            rec(SNAP_NODE, node.to_dict())
        for job in snap.jobs():
            rec(SNAP_JOB, job.to_dict())
        for ev in snap.evals():
            rec(SNAP_EVAL, ev.to_dict())
        # Allocs: slab-backed rows serialize as COLUMNS — one shared
        # record per slab family (job + slot templates once) plus the
        # per-row scalar deltas the store stamped (indexes, client
        # merges).  Everything else keeps the per-alloc dict record.
        enc = SlabWireEncoder()
        by_slab: dict = {}  # slab table index -> [[row_pos, delta], ...]
        for entry in enc.encode_list(list(snap.allocs())):
            if isinstance(entry, dict):
                rec(SNAP_ALLOC, entry)
            else:
                delta = entry[2] if len(entry) > 2 else {}
                by_slab.setdefault(entry[0], []).append(
                    [entry[1], delta])
        for si, wire in enumerate(enc.slabs_wire()):
            rec(SNAP_ALLOC_SLAB, {"slab": wire,
                                  "rows": by_slab.get(si, [])})
        return buf.getvalue()

    def restore(self, blob: bytes) -> None:
        """Rebuild a fresh store from a snapshot blob (one big txn,
        fsm.go:313-410 / state_store.go:104-112)."""
        store = StateStore()
        timetable = TimeTable()
        restore = store.restore()
        indexes: dict = {}
        unpacker = msgpack.Unpacker(raw=False, strict_map_key=False)
        unpacker.feed(blob)
        for kind, payload in unpacker:
            if kind == SNAP_TIME_TABLE:
                timetable.deserialize(payload)
            elif kind == SNAP_INDEX:
                indexes = payload
            elif kind == SNAP_NODE:
                restore.node_restore(Node.from_dict(payload))
            elif kind == SNAP_JOB:
                restore.job_restore(Job.from_dict(payload))
            elif kind == SNAP_EVAL:
                restore.eval_restore(Evaluation.from_dict(payload))
            elif kind == SNAP_ALLOC:
                restore.alloc_restore(Allocation.from_dict(payload))
            elif kind == SNAP_ALLOC_SLAB:
                slab = AllocSlab.from_wire(payload["slab"])
                for row, delta in payload["rows"]:
                    restore.alloc_restore(
                        slab.alloc_with(row, **delta) if delta
                        else slab.alloc(row))
            else:
                raise ValueError(f"unrecognized snapshot record {kind}")
        for table, index in indexes.items():
            restore.index_restore(table, index)
        restore.commit()
        self.state = store
        self.timetable = timetable
