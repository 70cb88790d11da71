"""The port's blocking queries on both of its serving paths: twins of
tests/test_blocking_query_port.py on ``nomad_tpu_torch`` (CPU servers),
each case's answers also byte-identical to the JAX package's in-proc
path.

Blocking-query semantics port, run against BOTH serving paths.

The reference's blocking-query contract (nomad/rpc.go:269-338 block,
nomad/http_test.go TestParseWait/blocking tables, node_endpoint_test.go
Node.GetAllocs blocking cases):

- ``min_query_index`` 0 (or absent) answers immediately with the
  current table index;
- ``min_query_index`` below the current index answers immediately;
- ``min_query_index`` at/above the current index blocks until a write
  moves the table past it, then answers with the NEW index;
- a wait that expires answers with the CURRENT data and index — a
  timeout is a normal response, never an error;
- waits are table-keyed: a write to another table must not wake the
  query;
- a query for an object that doesn't exist still honors the table
  semantics (blocks, then answers ``None``).

Every case runs twice — through the in-proc RPC path (the colocated
agent, synchronous fan-out waiter) and through the event-driven mux
wire path (parked fan-out callback) — on identically-driven fresh
servers, and the responses must be byte-identical: the serving-plane
refactor may change WHERE a query waits, never WHAT it answers.
"""
from __future__ import annotations

import json
import threading
import time

import pytest

import nomad_tpu.structs as jstructs
from nomad_tpu.agent.agent import InprocRPC as JInprocRPC
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
import nomad_tpu_torch.structs as structs
from nomad_tpu_torch.agent.agent import InprocRPC
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.rpc import ConnPool


class _Path:
    """A serving path's world: its package's structs build the fixed
    nodes and allocs every case writes."""
    structs = structs

    def node(self, i: int):
        return self.structs.Node(id=f"bq-n{i:03d}", name=f"bq-{i}",
                                 datacenter="dc1", status="ready")

    def alloc(self, i: int, node_id: str):
        return self.structs.Allocation(
            id=f"bq-a{i:03d}", node_id=node_id, job_id="bq-job",
            eval_id="bq-eval", name=f"bq[{i}]", desired_status="run",
            client_status="pending")


class _InprocPath(_Path):
    name = "inproc"

    def __enter__(self):
        self.srv = Server(ServerConfig(device="cpu", num_schedulers=0,
                                       tune_gc=False,
                                       use_device_scheduler=False))
        self.srv.establish_leadership()
        self.rpc = InprocRPC(self.srv)
        return self

    def call(self, method, args):
        return self.rpc.call(method, args)

    def __exit__(self, *exc):
        self.srv.shutdown()


class _MuxPath(_Path):
    name = "mux"

    def __enter__(self):
        self.srv = Server(ServerConfig(device="cpu", num_schedulers=0,
                                       tune_gc=False,
                                       use_device_scheduler=False,
                                       enable_rpc=True))
        self.srv.establish_leadership()
        self.pool = ConnPool()
        return self

    def call(self, method, args):
        return self.pool.call(self.srv.rpc_address(), method,
                              dict(args), timeout=30.0)

    def __exit__(self, *exc):
        self.pool.shutdown()
        self.srv.shutdown()


class _JaxInprocPath(_Path):
    """The JAX package's colocated path, the reference answers."""
    name = "jax-inproc"
    structs = jstructs

    def __enter__(self):
        self.srv = JServer(JServerConfig(num_schedulers=0, tune_gc=False,
                                         use_device_scheduler=False))
        self.srv.establish_leadership()
        self.rpc = JInprocRPC(self.srv)
        return self

    def call(self, method, args):
        return self.rpc.call(method, args)

    def __exit__(self, *exc):
        self.srv.shutdown()


def _canon(resp) -> str:
    return json.dumps(resp, sort_keys=True)


# Each case: (name, run(path) -> response dict).  Writes are
# deterministic (fixed ids, raft-sequenced indexes) so both fresh
# servers produce byte-identical state and responses.

def _case_min_index_zero_immediate(p):
    p.srv.node_register(p.node(0))
    return p.call("Node.List", {})


def _case_min_index_below_current_immediate(p):
    first = p.srv.node_register(p.node(0))
    p.srv.node_register(p.node(1))
    return p.call("Node.List", {"min_query_index": first,
                                "max_query_time": 5.0})


def _case_blocks_until_change(p):
    p.srv.node_register(p.node(0))
    cur = p.srv.fsm.state.get_index("nodes")

    def write():
        time.sleep(0.3)  # sleep-ok: park the query before the wake write
        p.srv.node_register(p.node(1))

    t = threading.Thread(target=write)
    t.start()
    resp = p.call("Node.List", {"min_query_index": cur,
                                "max_query_time": 10.0})
    t.join(5)
    assert resp["index"] > cur, "must answer with the post-write index"
    return resp


def _case_timeout_returns_current(p):
    p.srv.node_register(p.node(0))
    cur = p.srv.fsm.state.get_index("nodes")
    t0 = time.monotonic()
    resp = p.call("Node.List", {"min_query_index": cur,
                                "max_query_time": 0.3})
    assert 0.2 <= time.monotonic() - t0 < 5.0
    assert resp["index"] == cur, "timeout answers with the CURRENT index"
    return resp


def _case_unknown_object_blocks_then_none(p):
    p.srv.node_register(p.node(0))  # nonzero world
    cur = p.srv.fsm.state.get_index("evals")
    resp = p.call("Eval.GetEval", {"eval_id": "no-such-eval",
                                   "min_query_index": cur or 0,
                                   "max_query_time": 0.3})
    assert resp["eval"] is None
    return resp


def _case_get_allocs_wakes_on_alloc_write(p):
    p.srv.node_register(p.node(0))
    # Seed the table: a pre-first-write index of 0 takes the immediate
    # path by contract (min_query_index 0 never blocks).
    p.srv.fsm.state.upsert_allocs(999, [])
    cur = p.srv.fsm.state.get_index("allocs")

    def write():
        time.sleep(0.3)  # sleep-ok: park the long-poll before the alloc lands
        p.srv.fsm.state.upsert_allocs(1000, [p.alloc(0, "bq-n000")])

    t = threading.Thread(target=write)
    t.start()
    resp = p.call("Node.GetAllocs", {"node_id": "bq-n000",
                                     "min_query_index": cur,
                                     "max_query_time": 10.0})
    t.join(5)
    assert len(resp["allocs"]) == 1 and resp["index"] == 1000
    return resp


def _case_waits_are_table_keyed(p):
    p.srv.node_register(p.node(0))
    jobs_cur = p.srv.fsm.state.get_index("jobs")

    def write_other_table():
        time.sleep(0.15)  # sleep-ok: the cross-table write lands mid-wait
        p.srv.node_register(p.node(1))

    t = threading.Thread(target=write_other_table)
    t.start()
    t0 = time.monotonic()
    resp = p.call("Job.List", {"min_query_index": jobs_cur or 0,
                               "max_query_time": 0.6})
    t.join(5)
    took = time.monotonic() - t0
    if jobs_cur > 0:
        assert took >= 0.5, "a nodes write must not wake a jobs query"
    assert resp["jobs"] == []
    return resp


CASES = [
    _case_min_index_zero_immediate,
    _case_min_index_below_current_immediate,
    _case_blocks_until_change,
    _case_timeout_returns_current,
    _case_unknown_object_blocks_then_none,
    _case_get_allocs_wakes_on_alloc_write,
    _case_waits_are_table_keyed,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[6:])
def test_blocking_query_semantics_byte_identical_on_both_paths(case):
    responses = {}
    for path_cls in (_InprocPath, _MuxPath, _JaxInprocPath):
        with path_cls() as p:
            resp = case(p)
            assert resp.get("known_leader") is True
            responses[path_cls.name] = _canon(resp)
    assert responses["inproc"] == responses["mux"], \
        "the two serving paths answered differently:\n" \
        f"inproc: {responses['inproc']}\nmux:    {responses['mux']}"
    assert responses["inproc"] == responses["jax-inproc"], \
        "the port answered differently from the JAX package:\n" \
        f"port: {responses['inproc']}\njax:  {responses['jax-inproc']}"


def test_parked_path_actually_parks_while_inproc_blocks_a_thread():
    """Structural sanity for the comparison above: over the wire the
    waiting query is a fan-out waiter with NO dispatch worker pinned;
    in-proc it is the caller's own thread."""
    with _MuxPath() as p:
        p.srv.node_register(p.node(0))
        cur = p.srv.fsm.state.get_index("nodes")
        got = []
        t = threading.Thread(target=lambda: got.append(
            p.call("Node.List", {"min_query_index": cur,
                                 "max_query_time": 10.0})))
        t.start()
        from tests.conftest import wait_until
        wait_until(lambda: p.srv.fsm.state.watch.live_waiters() == 1,
                   msg="wire query parked in the fan-out")
        # The worker that parked the waiter lowers ``busy`` only once its
        # handler has returned, a moment after the park: wait for that
        # while the waiter is still parked (its max_query_time is 10 s).
        # A query that pins its worker until it is answered never gets
        # there.
        wait_until(lambda: p.srv.rpc_server._pool.stats()["busy"] == 0
                   and p.srv.fsm.state.watch.live_waiters() == 1,
                   timeout=5.0,
                   msg="a parked blocking query must not pin a dispatch "
                       "worker")
        p.srv.node_register(p.node(1))
        t.join(10)
        assert got and got[0]["index"] > cur
