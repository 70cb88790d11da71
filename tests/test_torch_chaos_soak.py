"""Chaos soaks on the port's networked server path.

Twins of tests/test_chaos_soak.py on ``nomad_tpu_torch`` servers
(``device="cpu"``): a multi-worker eval storm over the RPC plane while
nodes heartbeat-expire (or drain) mid-storm, and a leader that dies
mid-storm on a three-server networked-raft cluster.  After the dust
settles the invariants hold: no node oversubscribed, no port on a node
twice, the incremental usage mirror equal to a rebuild, every eval
terminal, and after the failover every survivor's replica agreeing on
the allocations.

The storms' jobs and topology are seeded; the interleaving of workers,
raft and heartbeats is whatever runs, and the invariants hold for every
interleaving, so nothing here is compared with the JAX package run for
run.  Every wait has its own bound.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

import nomad_tpu_torch.mock as mock
from nomad_tpu_torch.models.fleet import (
    UsageMirror,
    build_usage,
    fleet_cache,
    mirror_for,
)
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.rpc import ConnPool
from nomad_tpu_torch.structs import (
    NODE_STATUS_DOWN,
    NODE_STATUS_READY,
    NetworkResource,
    Resources,
    Task,
    TaskGroup,
    allocs_fit,
)

from tests.conftest import wait_until
from tests.test_torch_raft_net import make_cluster, wait_for_stable_leader

TERMINAL = ("complete", "failed", "canceled")


def _storm_job(rng, n_groups: int):
    job = mock.job()
    job.task_groups = [
        TaskGroup(name=f"tg-{g}", count=int(rng.integers(1, 3)),
                  tasks=[Task(
                      name="web", driver="exec",
                      resources=Resources(
                          cpu=int(rng.integers(100, 700)),
                          memory_mb=int(rng.integers(32, 256)),
                          networks=[NetworkResource(
                              mbits=int(rng.integers(1, 10)),
                              dynamic_ports=["http"])]),
                  )])
        for g in range(n_groups)]
    return job


def _server(**kw) -> Server:
    return Server(ServerConfig(device="cpu", tune_gc=False, **kw))


def _quiesce(srv, pool, addr, beat_ids, n_evals, timeout, after=0):
    """Wait until every eval is terminal (and more than ``after`` exist),
    heartbeating ``beat_ids`` every 4 s meanwhile so the real TTL
    cannot expire them under a slow run."""
    deadline = time.monotonic() + timeout
    last_beat = 0.0
    while time.monotonic() < deadline:
        if time.monotonic() - last_beat > 4.0:
            for nid in beat_ids:
                pool.call(addr, "Node.Heartbeat", {"node_id": nid},
                          timeout=10)
            last_beat = time.monotonic()
        evals = srv.fsm.state.evals()
        if evals and all(e.status in TERMINAL for e in evals) and \
                len(evals) >= n_evals and len(evals) > after:
            return
        time.sleep(0.2)  # sleep-ok: poll cadence


@pytest.mark.parametrize("seed", [7, 23])
def test_chaos_storm_with_heartbeat_expiry(seed):
    rng = np.random.default_rng(seed)
    srv = _server(num_schedulers=4, enable_rpc=True)
    srv.establish_leadership()
    pool = ConnPool()
    try:
        addr = srv.rpc_address()
        n_nodes = 40
        node_ids = []
        for i in range(n_nodes):
            node = mock.node(i)
            out = pool.call(addr, "Node.Register",
                            {"node": node.to_dict()}, timeout=10)
            assert out["heartbeat_ttl"] > 0
            node_ids.append(node.id)

        eval_ids = []
        job_ids = []
        for _ in range(18):
            job = _storm_job(rng, 12)
            resp = pool.call(addr, "Job.Register",
                             {"job": job.to_dict()}, timeout=30)
            eval_ids.append(resp["eval_id"])
            job_ids.append(job.id)

        # Mid-storm chaos: a seeded subset of nodes misses its
        # heartbeats; the real expiry path marks them down and spawns
        # node-update evals that race the storm.
        time.sleep(0.15)  # sleep-ok: mid-storm pacing
        expire = [node_ids[int(i)] for i in
                  rng.choice(n_nodes, size=10, replace=False)]
        for node_id in expire:
            srv.heartbeats._invalidate(node_id)

        survivors = [nid for nid in node_ids if nid not in set(expire)]
        _quiesce(srv, pool, addr, survivors, len(eval_ids), 55)
        state = srv.fsm.state

        stuck = [(e.id, e.status) for e in state.evals()
                 if e.status not in TERMINAL]
        assert not stuck, f"non-terminal evals after soak: {stuck[:5]}"

        downed = set(expire)
        for nid in node_ids:
            want = NODE_STATUS_DOWN if nid in downed else NODE_STATUS_READY
            assert state.node_by_id(nid).status == want, nid

        total_live = 0
        for nid in node_ids:
            live = [a for a in state.allocs_by_node(nid)
                    if not a.terminal_status() and a.node_id]
            total_live += len(live)
            fit, dim, _util = allocs_fit(state.node_by_id(nid), live)
            assert fit, f"node {nid} oversubscribed on {dim}"
            ports = [p for a in live
                     for tr in a.task_resources.values()
                     for net in tr.networks for p in net.reserved_ports]
            assert len(ports) == len(set(ports)), f"port collision {nid}"
        assert total_live > 0, "storm placed nothing"

        snap = state.snapshot()
        statics = fleet_cache.statics_for(snap)
        mirror = mirror_for(statics)
        mirror.sync(snap)
        live = [a for a in snap.allocs() if not a.terminal_status()]
        scratch = build_usage(statics, live, job_id=job_ids[0])
        np.testing.assert_allclose(mirror.usage, scratch.usage,
                                   rtol=0, atol=0)
    finally:
        pool.shutdown()
        srv.shutdown()


def test_chaos_storm_with_drain():
    """Nodes drain over the RPC plane while the workers place; at
    quiescence drained nodes hold no live alloc, nothing is
    oversubscribed, and the mirror's incremental port and bandwidth
    tracking equals a rebuild."""
    rng = np.random.default_rng(11)
    srv = _server(num_schedulers=4, enable_rpc=True)
    srv.establish_leadership()
    pool = ConnPool()
    try:
        addr = srv.rpc_address()
        n_nodes = 30
        node_ids = []
        for i in range(n_nodes):
            node = mock.node(i)
            pool.call(addr, "Node.Register", {"node": node.to_dict()},
                      timeout=10)
            node_ids.append(node.id)

        eval_ids = []
        for _ in range(14):
            job = _storm_job(rng, 10)
            resp = pool.call(addr, "Job.Register",
                             {"job": job.to_dict()}, timeout=30)
            eval_ids.append(resp["eval_id"])

        time.sleep(0.1)  # sleep-ok: mid-storm pacing
        drained = [node_ids[int(i)] for i in
                   rng.choice(n_nodes, size=8, replace=False)]
        for nid in drained:
            pool.call(addr, "Node.UpdateDrain",
                      {"node_id": nid, "drain": True}, timeout=10)

        _quiesce(srv, pool, addr, node_ids, len(eval_ids), 55)
        state = srv.fsm.state
        stuck = [(e.id, e.status) for e in state.evals()
                 if e.status not in TERMINAL]
        assert not stuck, f"non-terminal evals after soak: {stuck[:5]}"

        # A placement can slip onto a draining node inside the
        # applier's optimistic verify window; drain is enforced by node
        # evals, so a follow-up node evaluation clears any straggler.
        n_evals = len(srv.fsm.state.evals())
        for nid in drained:
            pool.call(addr, "Node.Evaluate", {"node_id": nid}, timeout=10)
        _quiesce(srv, pool, addr, node_ids, n_evals, 30, after=n_evals)
        state = srv.fsm.state

        total_live = 0
        for nid in node_ids:
            live = [a for a in state.allocs_by_node(nid)
                    if not a.terminal_status() and a.node_id]
            if nid in set(drained):
                assert not live, f"drained node {nid} still has allocs"
                continue
            total_live += len(live)
            fit, dim, _util = allocs_fit(state.node_by_id(nid), live)
            assert fit, f"node {nid} oversubscribed on {dim}"
        assert total_live > 0, "storm placed nothing on survivors"

        snap = state.snapshot()
        statics = fleet_cache.statics_for(snap)
        mirror = mirror_for(statics)
        assert mirror.sync_net(snap)
        fresh = UsageMirror(statics)
        fresh.sync_net(snap)
        assert mirror.net_rows == fresh.net_rows
        assert mirror.node_ports == fresh.node_ports
        assert mirror.node_bw == fresh.node_bw
        assert mirror.node_dup == fresh.node_dup
        np.testing.assert_allclose(mirror.usage, fresh.usage,
                                   rtol=0, atol=0)
    finally:
        pool.shutdown()
        srv.shutdown()


def test_leader_failover_mid_storm():
    """The leader dies while a storm is in flight; the new leader
    restores the broker from replicated state, finishes every eval,
    and the committed allocations satisfy exact fit on every survivor's
    replica, which agree on the allocation set."""
    servers = make_cluster(3)
    try:
        leader = wait_for_stable_leader(servers)
        nodes = [mock.node(i) for i in range(10)]
        for node in nodes:
            leader.node_register(node)

        rng = np.random.default_rng(11)
        eval_ids = []
        for _ in range(8):
            job = _storm_job(rng, 6)
            _, eid = leader.job_register(job)
            eval_ids.append(eid)

        survivors = [s for s in servers if s is not leader]
        leader.shutdown()
        for s in survivors:
            s.raft.remove_peer(leader.rpc_address())
        wait_for_stable_leader(survivors, timeout=60)

        def all_terminal():
            for s in survivors:
                state = s.fsm.state
                evs = [state.eval_by_id(eid) for eid in eval_ids]
                if all(e is not None and e.status in TERMINAL
                       for e in evs):
                    return True
            return False
        wait_until(all_terminal, timeout=90,
                   msg="storm evals terminal on a survivor")

        for s in survivors:
            state = s.fsm.state
            for node in nodes:
                live = [a for a in state.allocs_by_node(node.id)
                        if not a.terminal_status() and a.node_id]
                fit, dim, _ = allocs_fit(state.node_by_id(node.id), live)
                assert fit, f"node {node.id} oversubscribed on {dim}"

        def alloc_ids(s):
            return frozenset(a.id for a in s.fsm.state.allocs())
        wait_until(lambda: alloc_ids(survivors[0]) == alloc_ids(
            survivors[1]), timeout=60, msg="replicas agree on allocs")
    finally:
        for s in servers:
            try:
                s.shutdown()
            except Exception:
                pass
