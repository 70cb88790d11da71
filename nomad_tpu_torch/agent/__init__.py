"""Agent: server and/or client in one process + the HTTP API.

Capability parity with reference command/agent/: the deployable unit.
A colocated client short-circuits RPC in-process (reference
agent.go:176-178); the HTTP server exposes the /v1 REST surface with
blocking-query support.  The simulated agent swarm
(:mod:`nomad_tpu_torch.agent.swarm`) drives a server over the wire.

Counterpart of ``nomad_tpu/agent``.
"""
from .agent import Agent, AgentConfig  # noqa: F401
from .http_server import HTTPServer  # noqa: F401
from .swarm import AgentSwarm  # noqa: F401
