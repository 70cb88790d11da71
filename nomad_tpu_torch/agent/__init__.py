"""Agents: the client side of the serving plane.

Counterpart of ``nomad_tpu/agent``.  Only the simulated agent swarm
(:mod:`nomad_tpu_torch.agent.swarm`) is ported; the agent process, its
config and its HTTP server come with the client in a later slice.
"""
from .swarm import AgentSwarm  # noqa: F401
