"""Client agent: fingerprinting, task execution, alloc lifecycle.

Capability parity with reference client/: the node-side daemon that
registers with servers, heartbeats, long-polls its allocations, and runs
them through pluggable task drivers with filesystem + resource isolation.
"""
from .client import Client  # noqa: F401
from .config import ClientConfig  # noqa: F401
