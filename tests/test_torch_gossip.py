"""The port's gossip membership against the JAX package's.

Twins of tests/test_gossip.py's gossip-only cases on
``nomad_tpu_torch.server.gossip``; a JAX ``Gossip`` and a port
``Gossip`` joining each other (the wire is the same msgpack); two port
servers with ``enable_gossip`` in two regions finding each other,
knowing the regions a JAX pair knows and forwarding a request for the
other region; and twins of tests/test_gossip.py's raft cases: gossip
joins reconciling networked-raft peers, ``bootstrap_expect`` deferring
elections until quorum (on servers and on agents with ``retry_join``)
and not deferring after a restart, and an agent with static
``raft_peers``.
"""
from __future__ import annotations

import threading
import time

import pytest

import nomad_tpu.mock as jmock
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu.server.gossip import Gossip as JGossip
from nomad_tpu.server.rpc import ConnPool as JConnPool
from nomad_tpu_torch import convert
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.gossip import ALIVE, DEAD, Gossip
from nomad_tpu_torch.server.rpc import ConnPool

from tests.conftest import wait_until


FAST_GOSSIP = dict(probe_interval=0.05, probe_timeout=0.05,
                   suspect_timeout=0.3)


def test_join_merges_membership():
    g1 = Gossip({"name": "a"}, **FAST_GOSSIP)
    g2 = Gossip({"name": "b"}, **FAST_GOSSIP)
    g3 = Gossip({"name": "c"}, **FAST_GOSSIP)
    try:
        g2.join(g1.addr)
        g3.join(g1.addr)  # learns about g2 transitively
        wait_until(lambda: len(g1.alive_addrs()) == 3, msg="g1 sees 3")
        wait_until(lambda: len(g3.alive_addrs()) == 3, msg="g3 sees 3")
    finally:
        for g in (g1, g2, g3):
            g.shutdown()


def test_failure_detection():
    g1 = Gossip({"name": "a"}, **FAST_GOSSIP)
    g2 = Gossip({"name": "b"}, **FAST_GOSSIP)
    failed = []
    g1.on_fail = lambda m: failed.append(m.addr)
    try:
        g2.join(g1.addr)
        wait_until(lambda: len(g1.alive_addrs()) == 2, msg="join")
        g2._stop.set()
        g2.sock.close()
        wait_until(lambda: g2.addr in failed, msg="failure detection")
        members = {tuple(m["addr"]): m["status"]
                   for m in g1.members(status=None)}
        assert members[g2.addr] == DEAD
    finally:
        g1.shutdown()
        g2.shutdown()


def test_join_events_fire():
    joined = []
    g1 = Gossip({"name": "a"}, on_join=lambda m: joined.append(
        m.tags.get("name")), **FAST_GOSSIP)
    g2 = Gossip({"name": "b"}, **FAST_GOSSIP)
    try:
        g2.join(g1.addr)
        wait_until(lambda: "b" in joined, msg="join event")
    finally:
        g1.shutdown()
        g2.shutdown()


@pytest.mark.parametrize("joiner", ["port", "jax"])
def test_jax_and_port_gossip_join_each_other(joiner):
    """One wire: whichever side joins, both see both alive with the
    other's tags, and each fires its join event for the other."""
    joined = {"jax": [], "port": []}
    jg = JGossip({"name": "jax-side"}, on_join=lambda m: joined[
        "jax"].append(m.tags.get("name")), **FAST_GOSSIP)
    tg = Gossip({"name": "port-side"}, on_join=lambda m: joined[
        "port"].append(m.tags.get("name")), **FAST_GOSSIP)
    try:
        if joiner == "port":
            tg.join(jg.addr)
        else:
            jg.join(tg.addr)
        wait_until(lambda: len(jg.alive_addrs()) == 2
                   and len(tg.alive_addrs()) == 2, msg="mutual join")
        wait_until(lambda: joined == {"jax": ["port-side"],
                                      "port": ["jax-side"]},
                   msg="join events")
        names = [sorted(m["tags"]["name"] for m in g.members())
                 for g in (jg, tg)]
        assert names == [["jax-side", "port-side"]] * 2
        assert {m["status"] for m in tg.members(status=None)} == {ALIVE}
    finally:
        tg.shutdown()
        jg.shutdown()


def _pair(server_cls, config_cls, **extra):
    """Two servers with gossip and RPC in regions ``global`` and
    ``r2``, the second joined to the first; each leads itself."""
    out = []
    try:
        for region in ("global", "r2"):
            srv = server_cls(config_cls(
                region=region, enable_gossip=True, enable_rpc=True,
                num_schedulers=0, tune_gc=False, **extra))
            out.append(srv)
            srv.establish_leadership()
        out[1].gossip.join(out[0].gossip.addr)
        wait_until(lambda: all(s.regions() == ["global", "r2"]
                               for s in out), msg="regions via gossip")
    except BaseException:
        for srv in out:
            srv.shutdown()
        raise
    return out


def test_servers_in_two_regions_find_and_forward():
    """Port servers in ``global`` and ``r2`` find each other over
    gossip as a JAX pair does: the same region lists, each region
    mapped to the other's RPC address, and ``Job.List`` addressed to
    ``r2`` answered by the ``r2`` server on both packages."""
    jobs = [jmock.job(), jmock.job()]
    got = {}
    for name in ("jax", "port"):
        if name == "jax":
            pair = _pair(JServer, JServerConfig)
            pool, world = JConnPool(), jobs
        else:
            pair = _pair(Server, ServerConfig, device="cpu")
            pool, world = ConnPool(), convert.jobs_from_reference(jobs)
        try:
            first, second = pair
            assert first.region_server("r2") == second.rpc_address()
            assert second.region_server("global") == first.rpc_address()
            with pytest.raises(RuntimeError, match="no path to region"):
                first.region_server("mars")
            second.job_register(world[0])
            first.job_register(world[1])
            listed = pool.call(first.rpc_address(), "Job.List",
                               {"region": "r2"}, timeout=30)
            local = pool.call(first.rpc_address(), "Job.List", {},
                              timeout=30)
            rpc = {s.config.region: s.rpc_address() for s in pair}
            members = sorted(
                (m["tags"]["region"],
                 tuple(m["tags"]["rpc"]) == rpc[m["tags"]["region"]])
                for m in first.gossip.members())
            got[name] = dict(
                regions=[s.regions() for s in pair],
                remote=[j["id"] for j in listed["jobs"]],
                local=[j["id"] for j in local["jobs"]],
                members=members)
        finally:
            pool.shutdown()
            for srv in pair:
                srv.shutdown()
    assert got["port"] == got["jax"]
    assert got["port"]["remote"] == [jobs[0].id]
    assert got["port"]["local"] == [jobs[1].id]
    assert got["port"]["regions"] == [["global", "r2"]] * 2
    assert got["port"]["members"] == [("global", True), ("r2", True)]


def test_server_failure_drops_its_region():
    """A server that leaves takes its region out of the other's table
    (the fail/leave events), as on the JAX server."""
    first, second = _pair(Server, ServerConfig, device="cpu")
    try:
        second.shutdown()
        wait_until(lambda: first.regions() == ["global"],
                   msg="r2 dropped on leave")
        with pytest.raises(RuntimeError, match="no path to region"):
            first.region_server("r2")
    finally:
        first.shutdown()
        second.shutdown()


RAFT_GOSSIP = dict(raft_mode="net", raft_election_timeout=(0.05, 0.10),
                   raft_heartbeat_interval=0.02, num_schedulers=1,
                   enable_gossip=True, device="cpu", tune_gc=False)


def _leaders(servers) -> int:
    return sum(1 for s in servers if s.raft.is_leader())


def test_gossip_reconciles_raft_peers():
    """Servers discover each other through gossip and converge on one
    raft cluster with a single leader (tests/test_gossip.py's case)."""
    servers = [Server(ServerConfig(**RAFT_GOSSIP)) for _ in range(3)]
    try:
        for s in servers[1:]:
            s.gossip.join(servers[0].gossip.addr)
        wait_until(lambda: all(len(s.raft.peer_addresses()) == 3
                               for s in servers),
                   timeout=20, msg="raft peers from gossip")
        wait_until(lambda: _leaders(servers) == 1, timeout=20,
                   msg="single leader")
        leader = next(s for s in servers if s.raft.is_leader())
        node = convert.nodes_from_reference([jmock.node()])[0]
        leader.node_register(node)
        wait_until(lambda: all(
            s.fsm.state.node_by_id(node.id) is not None
            for s in servers), timeout=20, msg="replication")
        # Every server knows every raft peer by its RPC address.
        rpc = sorted(s.rpc_address() for s in servers)
        assert all(sorted(s.peers()) == rpc for s in servers)
    finally:
        for s in servers:
            s.shutdown()


def test_bootstrap_expect_defers_elections_until_quorum():
    """``bootstrap_expect > 1``: no server elects itself before gossip
    shows the expected count; the third arrival arms elections and the
    cluster elects one leader and replicates."""
    cfg = dict(RAFT_GOSSIP, bootstrap_expect=3)
    servers = [Server(ServerConfig(**cfg)) for _ in range(2)]
    try:
        servers[1].gossip.join(servers[0].gossip.addr)
        wait_until(lambda: all(len(s.raft.peer_addresses()) == 2
                               for s in servers),
                   timeout=20, msg="two of three in gossip")
        time.sleep(0.8)  # sleep-ok: nobody elects
        assert not any(s.raft.is_leader() for s in servers)
        assert not any(s.raft.elections_enabled() for s in servers)

        servers.append(Server(ServerConfig(**cfg)))
        servers[2].gossip.join(servers[0].gossip.addr)
        wait_until(lambda: _leaders(servers) == 1, timeout=20,
                   msg="single leader after bootstrap quorum")
        leader = next(s for s in servers if s.raft.is_leader())
        node = convert.nodes_from_reference([jmock.node()])[0]
        leader.node_register(node)
        wait_until(lambda: all(
            s.fsm.state.node_by_id(node.id) is not None
            for s in servers), timeout=20,
            msg="replication after bootstrap")
    finally:
        for s in servers:
            s.shutdown()


def test_agent_bootstrap_expect_cluster():
    """Three server agents with ``bootstrap_expect=3`` and
    ``retry_join`` form one raft cluster through the agent layer
    (reference ``nomad agent -server -bootstrap-expect 3
    -retry-join``); leaving nothing running once shut down."""
    before = set(threading.enumerate())
    agents = []
    try:
        first = Agent(AgentConfig(
            server_enabled=True, dev_mode=False, bootstrap_expect=3,
            http_port=0, rpc_port=0, serf_port=0, num_schedulers=1,
            device="cpu"))
        agents.append(first)
        seed = first.server.gossip.addr
        for _ in range(2):
            agents.append(Agent(AgentConfig(
                server_enabled=True, dev_mode=False, bootstrap_expect=3,
                http_port=0, rpc_port=0, serf_port=0, num_schedulers=1,
                retry_join=[seed], device="cpu")))
        assert all(a.server.config.raft_mode == "net" for a in agents)
        wait_until(lambda: all(
            len(a.server.raft.peer_addresses()) == 3 for a in agents),
            timeout=30, msg="full gossip->raft membership")
        wait_until(lambda: sum(
            1 for a in agents if a.server.raft.is_leader()) == 1,
            timeout=30, msg="agent cluster leader")
    finally:
        for a in agents:
            a.shutdown()
    wait_until(lambda: not [t for t in threading.enumerate()
                            if t not in before and t.is_alive()],
               timeout=15, msg="no thread outlives the agents")


def test_bootstrap_deferral_skipped_after_restart(tmp_path):
    """A restarted server with persisted raft state does not defer
    elections (reference maybeBootstrap skips when LastIndex != 0); a
    fresh one does."""
    import json
    import os

    def mk(data_dir):
        return ServerConfig(**dict(RAFT_GOSSIP, bootstrap_expect=3,
                                   data_dir=str(data_dir)))

    fresh = Server(mk(tmp_path / "fresh"))
    try:
        assert not fresh.raft.elections_enabled()
    finally:
        fresh.shutdown()

    veteran_dir = tmp_path / "veteran"
    os.makedirs(veteran_dir / "raft")
    with open(veteran_dir / "raft" / "meta.json", "w") as fh:
        json.dump({"term": 3, "voted_for": None}, fh)
    veteran = Server(mk(veteran_dir))
    try:
        assert veteran.raft.elections_enabled()
    finally:
        veteran.shutdown()


def test_agent_with_raft_peers_runs_networked_raft():
    """An agent with static ``raft_peers`` runs networked raft with
    those peers and elections armed (no bootstrap deferral), as the JAX
    agent does."""
    import socket

    spare = socket.socket()
    spare.bind(("127.0.0.1", 0))
    peer = spare.getsockname()
    spare.close()
    agent = Agent(AgentConfig(server_enabled=True, http_port=0,
                              rpc_port=0, serf_port=0, device="cpu",
                              raft_peers=[peer]))
    try:
        assert agent.server.config.raft_mode == "net"
        assert agent.server.raft.elections_enabled()
        assert tuple(peer) in agent.server.raft.peer_addresses()
        assert not agent.server.raft.is_leader()  # one of two: no quorum
    finally:
        agent.shutdown()
