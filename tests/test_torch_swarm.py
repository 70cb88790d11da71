"""The port's agent swarm (agent/swarm.py) against the port's server.

A swarm of 50 agents registers mock nodes (``node_factory``) over the
wire, heartbeats on its own sessions and parks one ``Node.GetAllocs``
long-poll per agent; a job registered over a ``ConnPool`` lands, its
commit wakes every poll, and each node that received allocations sees
them in its last poll answer; teardown leaves no thread.  The port's
swarm and the JAX package's speak the same wire: each drives the other
package's server, and both report the same ``stats()`` keys.
"""
from __future__ import annotations

import threading

import pytest
import torch

from nomad_tpu.agent.swarm import AgentSwarm as JSwarm
from nomad_tpu.agent.swarm import default_node as j_default_node
from nomad_tpu.server import Server as JServer
from nomad_tpu.server import ServerConfig as JServerConfig
from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import AgentSwarm
from nomad_tpu_torch.agent.swarm import default_node
from nomad_tpu_torch.obs import REGISTRY
from nomad_tpu_torch.scheduler.executor import executor_override
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.rpc import ConnPool
from tests.conftest import wait_until

torch.set_num_threads(1)

N = 50


def _mock_node(i):
    node = mock.node()
    node.id = f"swarm-{i:06d}"
    node.name = f"swarm-{i}"
    return node


def _port_server():
    return Server(ServerConfig(device="cpu", tune_gc=False, enable_rpc=True,
                               num_schedulers=2, heartbeat_seed=9))


@pytest.fixture(scope="module")
def swarm_run():
    """One swarm's life: register, park, beat, a job lands, teardown."""
    before = set(threading.enumerate())
    out = {}
    with executor_override("device"):
        srv = _port_server()
        srv.establish_leadership()
        swarm = AgentSwarm(srv.rpc_address(), N, conns=4, hb_conns=2,
                           beat_interval=0.3, poll_wait=10.0, seed=9,
                           node_factory=_mock_node)
        pool = ConnPool()
        try:
            out["provider_live"] = "swarm" in REGISTRY.providers()
            swarm.start(register_timeout=60)
            state = srv.fsm.state
            out["registered"] = sorted(n.id for n in state.nodes())
            state.upsert_allocs(srv.raft.applied_index() + 1, [])
            wait_until(lambda: state.watch.live_waiters() == N,
                       timeout=15, msg="every long-poll parked")
            wait_until(lambda: swarm.stats()["beats_ok"] >= 2 * N,
                       timeout=20, msg="heartbeats flowing")
            job = mock.job()
            job.task_groups[0].count = 12
            eid = pool.call(srv.rpc_address(), "Job.Register",
                            {"job": job.to_dict()}, timeout=30)["eval_id"]
            srv.wait_for_evals([eid], timeout=60)
            placed = {}
            for a in state.allocs_by_job(job.id):
                placed[a.node_id] = max(placed.get(a.node_id, 0),
                                        a.modify_index)
            index = {n.id: i for i, n in enumerate(swarm._nodes)}
            wait_until(lambda: all(
                swarm._poll_index[index[nid]] >= ix
                for nid, ix in placed.items()),
                timeout=15, msg="every placed node's poll saw its allocs")
            out["placed"] = placed
            out["stats"] = swarm.stats()
            out["snapshot"] = REGISTRY.snapshot()
            out["not_ready"] = [n.id for n in state.nodes()
                                if n.status != "ready"]
            out["expiries"] = srv.heartbeats.stats()["expiries"]
            out["resources"] = {n.resources.cpu for n in state.nodes()}
        finally:
            pool.shutdown()
            swarm.stop()
            srv.shutdown()
    out["provider_after"] = "swarm" in REGISTRY.providers()
    out["left"] = [t.name for t in threading.enumerate()
                   if t not in before and t.is_alive()]
    return out


def test_every_agent_registers_its_factory_node(swarm_run):
    assert swarm_run["registered"] == [f"swarm-{i:06d}" for i in range(N)]
    # mock nodes, not the resource-less default
    assert swarm_run["resources"] == {mock.node().resources.cpu}
    assert swarm_run["stats"]["register_errors"] == 0


def test_heartbeats_flow_and_no_node_expires(swarm_run):
    st = swarm_run["stats"]
    assert st["beats_ok"] >= 2 * N and st["beat_errors"] == 0
    assert swarm_run["not_ready"] == [] and swarm_run["expiries"] == 0


def test_the_job_commit_wakes_every_long_poll(swarm_run):
    st = swarm_run["stats"]
    assert swarm_run["placed"]
    assert st["poll_wakeups"] >= N
    assert st["polls_issued"] >= 2 * N


def test_the_swarm_provider_lives_and_dies_with_the_swarm(swarm_run):
    assert swarm_run["provider_live"] is True
    assert swarm_run["provider_after"] is False
    assert swarm_run["snapshot"]["nomad.swarm.agents"] == N


def test_teardown_leaves_no_thread(swarm_run):
    assert swarm_run["left"] == []


def test_default_node_equals_the_jax_default_node():
    for i in (0, 7, 123456):
        assert default_node(i).to_dict() == j_default_node(i).to_dict()


@pytest.mark.parametrize("direction", ["port-swarm-jax-server",
                                       "jax-swarm-port-server"])
def test_the_swarms_cross_the_packages(direction):
    if direction == "port-swarm-jax-server":
        srv = JServer(JServerConfig(num_schedulers=0, enable_rpc=True,
                                    tune_gc=False,
                                    use_device_scheduler=False))
        swarm_cls = AgentSwarm
    else:
        srv = Server(ServerConfig(device="cpu", num_schedulers=0,
                                  enable_rpc=True, tune_gc=False))
        swarm_cls = JSwarm
    srv.establish_leadership()
    swarm = swarm_cls(srv.rpc_address(), 10, conns=2, hb_conns=1,
                      beat_interval=0.3, poll_wait=5.0, seed=3)
    try:
        swarm.start(register_timeout=30)
        srv.fsm.state.upsert_allocs(srv.raft.applied_index() + 1, [])
        wait_until(lambda: srv.fsm.state.watch.live_waiters() == 10,
                   timeout=15, msg="the other package's polls parked")
        wait_until(lambda: swarm.stats()["beats_ok"] >= 10, timeout=20,
                   msg="beats answered")
        srv.fsm.state.upsert_allocs(srv.raft.applied_index() + 2, [])
        wait_until(lambda: swarm.stats()["poll_wakeups"] >= 20,
                   timeout=15, msg="both writes woke every poll")
        assert sorted(n.id for n in srv.fsm.state.nodes()) == \
            [f"swarm-{i:06d}" for i in range(10)]
        assert swarm.stats()["beat_errors"] == 0
    finally:
        swarm.stop()
        srv.shutdown()


def test_stats_have_the_jax_swarms_keys():
    srv = _port_server()
    ports, jaxs = None, None
    try:
        ports = AgentSwarm(srv.rpc_address(), 2, long_polls=False)
        jaxs = JSwarm(srv.rpc_address(), 2, long_polls=False)
        assert sorted(ports.stats()) == sorted(jaxs.stats())
    finally:
        for s in (ports, jaxs):
            if s is not None:
                s.stop()
        srv.shutdown()
