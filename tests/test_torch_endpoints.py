"""The port's endpoints over the wire against the JAX package's.

A JAX ``Server`` and a port ``Server(device="cpu")``, both with
``enable_rpc``, take one sequence of RPC calls from their own package's
``ConnPool``: ``Status.*``; ``Node.Register`` of the same mock nodes;
a blocking ``Node.GetAllocs`` parked before any job exists; two
``Job.Register`` calls whose commit wakes it; then every read and write
service of ``Endpoints.install`` (Node, Job, Eval, Plan, Alloc,
System).  Each reply (or error) must be equal to the JAX server's once
the eval and alloc ids, raft indexes, the heartbeat TTL's jitter and
the listener's address are masked; node and job ids are the same in
both worlds (the port's copies are converted from the JAX objects).
Placements must be equal under the repo's parity contract: the same
(job, alloc name, node, ports) for every live alloc.

Determinism is the server twin rig's (tests/test_torch_server.py): the
servers take leadership with no workers, the jobs register over the
wire, and the workers start inside one ``random`` seed, JAX side under
``mesh_override("off")`` + ``executor_override("device")``, the port
under its own ``executor_override("device")``.
"""
from __future__ import annotations

import contextlib
import random
import re
import threading

import pytest
import torch

import nomad_tpu.mock as jmock
from nomad_tpu.parallel.mesh import mesh_override
from nomad_tpu.scheduler.executor import executor_override as j_executor
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.server.rpc import ConnPool as JConnPool
from nomad_tpu_torch import convert
from nomad_tpu_torch.scheduler.executor import executor_override as \
    t_executor
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.rpc import ConnPool
from tests.conftest import wait_until

torch.set_num_threads(1)

WAIT_S = 60.0
UUID = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}$")
INDEX_KEYS = {"index", "create_index", "modify_index", "job_modify_index",
              "alloc_index", "node_modify_index", "snapshot_index",
              "alloc_modify_index"}

# The calls after the jobs commit, in order: (label, method, args);
# args may name "node0", "job0", "eval0" or "alloc0", filled per world.
CALLS = [
    ("status-ping", "Status.Ping", {}),
    ("status-version", "Status.Version", {}),
    ("status-leader", "Status.Leader", {}),
    ("status-peers", "Status.Peers", {}),
    ("node-get", "Node.GetNode", {"node_id": "node0"}),
    ("node-list", "Node.List", {}),
    ("node-allocs", "Node.GetAllocs", {"node_id": "node0"}),
    ("node-heartbeat", "Node.Heartbeat", {"node_id": "node0"}),
    ("node-status", "Node.UpdateStatus",
     {"node_id": "node1", "status": "ready"}),
    ("job-get", "Job.GetJob", {"job_id": "job0"}),
    ("job-list", "Job.List", {}),
    ("job-allocs", "Job.Allocations", {"job_id": "job0"}),
    ("job-evals", "Job.Evaluations", {"job_id": "job0"}),
    ("eval-get", "Eval.GetEval", {"eval_id": "eval0"}),
    ("eval-list", "Eval.List", {}),
    ("eval-allocs", "Eval.Allocations", {"eval_id": "eval0"}),
    ("eval-dequeue-empty", "Eval.Dequeue",
     {"schedulers": ["no-such-queue"], "timeout": 0.05}),
    ("eval-ack-unknown", "Eval.Ack", {"eval_id": "eval0", "token": "x"}),
    ("eval-nack-unknown", "Eval.Nack", {"eval_id": "eval0", "token": "x"}),
    ("plan-submit-fenced", "Plan.Submit", {"plan": "plan0"}),
    ("alloc-list", "Alloc.List", {}),
    ("alloc-get", "Alloc.GetAlloc", {"alloc_id": "alloc0"}),
    ("node-update-alloc", "Node.UpdateAlloc", {"alloc": "alloc0-running"}),
    ("alloc-get-after-update", "Alloc.GetAlloc", {"alloc_id": "alloc0"}),
    ("eval-create-terminal", "Eval.Create", {"evals": "eval-done"}),
    ("eval-reap", "Eval.Reap", {"evals": "eval-done-id", "allocs": []}),
    ("system-gc", "System.GarbageCollect", {}),
    ("wrong-region", "Status.Ping", {"region": "elsewhere"}),
    ("unknown-job", "Job.Evaluate", {"job_id": "no-such-job"}),
    ("node-drain", "Node.UpdateDrain", {"node_id": "node3", "drain": False}),
    ("node-deregister", "Node.Deregister", {"node_id": "node3"}),
    ("node-list-after", "Node.List", {}),
]


@contextlib.contextmanager
def _seeded(seed):
    saved = random.getstate()
    random.seed(seed)
    try:
        yield
    finally:
        random.setstate(saved)


def _jobs():
    out = []
    for count in (3, 2):
        j = jmock.job()
        j.task_groups[0].count = count
        out.append(j)
    return out


def _call(pool, addr, method, args):
    try:
        return ("ok", pool.call(addr, method, args, timeout=30))
    except Exception as e:
        return ("error", type(e).__name__, str(e))


def _fill(args, world):
    out = {}
    for key, val in args.items():
        if val == "alloc0-running":
            alloc = dict(world["alloc0"])
            alloc["client_status"] = "running"
            out[key] = [alloc]
        elif val == "eval-done":
            out[key] = [world["eval_done"]]
        elif val == "eval-done-id":
            out[key] = [world["eval_done"]["id"]]
        elif val == "plan0":
            out[key] = world["plan0"]
        elif isinstance(val, str) and val in world:
            out[key] = world[val]
        else:
            out[key] = val
    return out


def _run(srv, pool, nodes, jobs, seed_ctx):
    """The whole sequence on one server; returns {label: reply},
    placements."""
    addr = srv.rpc_address()
    got = {}
    for n in nodes:
        got.setdefault("node-register", []).append(
            _call(pool, addr, "Node.Register", {"node": n.to_dict()}))
    # A table no write has touched answers a blocking query at once
    # (index 0): seed the allocs table, as bench.py's swarm row does.
    srv.fsm.state.upsert_allocs(srv.raft.applied_index() + 1, [])
    base = pool.call(addr, "Node.GetAllocs",
                     {"node_id": nodes[0].id}, timeout=30)["index"]
    assert base > 0
    blocked = {}
    waiter = threading.Thread(target=lambda: blocked.update(pool.call(
        addr, "Node.GetAllocs",
        {"node_id": nodes[0].id, "min_query_index": base,
         "max_query_time": 30.0}, timeout=60)))
    waiter.start()
    try:
        wait_until(lambda: srv.fsm.state.watch.live_waiters() >= 1,
                   msg="the long-poll parked")
        got["job-register"] = [
            _call(pool, addr, "Job.Register", {"job": j.to_dict()})
            for j in jobs]
        eval_ids = [r[1]["eval_id"] for r in got["job-register"]]
        with seed_ctx:
            srv.config.num_schedulers = 2
            srv._setup_workers()
            srv.wait_for_evals(eval_ids, timeout=WAIT_S)
    finally:
        waiter.join(60)
    got["blocked-wake"] = ("ok", blocked)
    state = srv.fsm.state
    allocs = sorted(state.allocs_by_job(jobs[0].id), key=lambda a: a.name)
    ev = state.eval_by_id(eval_ids[0])
    done = ev.to_dict()
    done.update(id="00000000-0000-0000-0000-0000000000ee",
                status="complete", trace={})
    plan = {"eval_id": eval_ids[0], "eval_token": "stale",
            "priority": 50, "all_at_once": False,
            "node_update": {}, "node_allocation": {}}
    world = {"node0": nodes[0].id, "node1": nodes[1].id,
             "node3": nodes[3].id, "job0": jobs[0].id,
             "eval0": eval_ids[0], "alloc0": allocs[0].id,
             "eval_done": done, "plan0": plan}
    world_alloc = allocs[0].to_dict()
    for label, method, args in CALLS:
        filled = _fill(args, dict(world, alloc0=world_alloc)
                       if label == "node-update-alloc" else world)
        got[label] = _call(pool, addr, method, filled)
    placed = sorted((a.job_id, a.name, a.node_id, tuple(
        p for tr in a.task_resources.values() for n in tr.networks
        for p in n.reserved_ports))
        for a in state.allocs() if not a.terminal_status())
    return got, placed, {n.id for n in nodes} | {j.id for j in jobs}


def _mask(obj, keep):
    """Mask what differs between the worlds by construction."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in INDEX_KEYS:
                out[k] = "<index>"
            elif k == "allocation_time":
                out[k] = "<wall>"
            elif k == "heartbeat_ttl":
                out[k] = "<ttl>" if v else v
            elif k in ("leader", "peers"):
                out[k] = "<addr>" if v else v
            elif k == "trace":
                out[k] = "<trace>" if v else v
            else:
                out[k] = _mask(v, keep)
        return out
    if isinstance(obj, (list, tuple)):
        items = [_mask(v, keep) for v in obj]
        return sorted(items, key=repr) if isinstance(obj, list) else \
            tuple(items)
    if isinstance(obj, str):
        if UUID.match(obj) and obj not in keep:
            return "<id>"
        return UUID.sub("<id>", obj) if obj not in keep else obj
    return obj


@pytest.fixture(scope="module")
def twin_replies():
    nodes = [jmock.node(i) for i in range(4)]
    jobs = _jobs()
    with mesh_override("off"), j_executor("device"):
        jsrv = JServer(JServerConfig(num_schedulers=0, enable_rpc=True,
                                     tune_gc=False, heartbeat_seed=3))
        jpool = JConnPool()
        try:
            jsrv.establish_leadership()
            jgot, jplaced, keep = _run(jsrv, jpool, nodes, jobs,
                                       _seeded(11))
        finally:
            jpool.shutdown()
            jsrv.shutdown()
    with t_executor("device"):
        tsrv = Server(ServerConfig(device="cpu", num_schedulers=0,
                                   enable_rpc=True, tune_gc=False,
                                   heartbeat_seed=3))
        tpool = ConnPool()
        try:
            tsrv.establish_leadership()
            tgot, tplaced, _ = _run(
                tsrv, tpool, convert.nodes_from_reference(nodes),
                convert.jobs_from_reference(jobs), _seeded(11))
        finally:
            tpool.shutdown()
            tsrv.shutdown()
    return jgot, tgot, jplaced, tplaced, keep


@pytest.mark.parametrize("label", ["node-register", "job-register",
                                   "blocked-wake"]
                         + [c[0] for c in CALLS])
def test_reply_equals_the_jax_servers(twin_replies, label):
    jgot, tgot, _jp, _tp, keep = twin_replies
    assert _mask(tgot[label], keep) == _mask(jgot[label], keep)


def test_the_blocking_get_allocs_was_woken_by_the_commit(twin_replies):
    _j, tgot, _jp, _tp, _keep = twin_replies
    status, reply = tgot["blocked-wake"]
    assert status == "ok" and reply["allocs"]
    assert reply["index"] > 0 and reply["known_leader"] is True


def test_placements_equal_the_jax_servers(twin_replies):
    _j, _t, jplaced, tplaced, _keep = twin_replies
    assert len(tplaced) == 5
    assert tplaced == jplaced


def test_every_call_was_answered_as_the_jax_server_answered(twin_replies):
    """Errors and successes line up call by call (the masked replies
    are compared one by one above); the fenced plan, the unknown
    token, the other region and the unknown job are errors."""
    jgot, tgot, _jp, _tp, _keep = twin_replies
    kinds = {label: (tgot[label][0]
                     if not isinstance(tgot[label], list) else "ok")
             for label in tgot}
    assert kinds == {label: (jgot[label][0]
                             if not isinstance(jgot[label], list)
                             else "ok")
                     for label in jgot}
    after = tgot["alloc-get-after-update"][1]["alloc"]
    assert after["client_status"] == "running"
    assert {label for label, k in kinds.items() if k == "error"} == {
        "eval-ack-unknown", "eval-nack-unknown", "plan-submit-fenced",
        "wrong-region", "unknown-job"}


@pytest.mark.parametrize("method,args", [
    ("Status.Ping", {}),
    ("Job.List", {}),
    ("Job.GetJob", {"job_id": "job0"}),
], ids=["status-ping", "job-list", "job-get"])
def test_known_region_forwards_on_both_packages(method, args):
    """A request for a region the server knows (``add_region_server``)
    goes to a server there and comes back with its answer, on both
    packages; the reply equals the JAX pair's once masked."""
    jobs = _jobs()
    replies = {}
    for name in ("jax", "port"):
        if name == "jax":
            make = lambda region: JServer(JServerConfig(  # noqa: E731
                region=region, num_schedulers=0, enable_rpc=True,
                tune_gc=False))
            pool, world = JConnPool(), jobs
        else:
            make = lambda region: Server(ServerConfig(  # noqa: E731
                region=region, device="cpu", num_schedulers=0,
                enable_rpc=True, tune_gc=False))
            pool, world = ConnPool(), convert.jobs_from_reference(jobs)
        servers = []
        try:
            for region in ("global", "r2"):
                servers.append(make(region))
                servers[-1].establish_leadership()
            first, second = servers
            first.add_region_server("r2", second.rpc_address())
            second.job_register(world[0])
            first.job_register(world[1])
            filled = {k: world[0].id if v == "job0" else v
                      for k, v in args.items()}
            replies[name] = (
                _call(pool, first.rpc_address(), method,
                      dict(filled, region="r2")),
                _call(pool, first.rpc_address(), method, filled),
                first.regions())
        finally:
            pool.shutdown()
            for srv in servers:
                srv.shutdown()
    keep = {j.id for j in jobs}
    assert _mask(replies["port"], keep) == _mask(replies["jax"], keep)
    remote, local, regions = replies["port"]
    assert remote[0] == local[0] == "ok" and regions == ["global", "r2"]
    if method == "Job.List":
        assert [j["id"] for j in remote[1]["jobs"]] == [jobs[0].id]
        assert [j["id"] for j in local[1]["jobs"]] == [jobs[1].id]
    if method == "Job.GetJob":
        assert remote[1]["job"]["id"] == jobs[0].id
        assert local[1]["job"] is None
