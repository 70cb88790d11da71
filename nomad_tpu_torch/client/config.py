"""Client configuration (reference client/config/config.go)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from nomad_tpu_torch.structs import Node


def read_bool_option(options: dict, key: str, default: bool = False) -> bool:
    """One truthy-string rule for the options kv namespace, shared by
    ClientConfig and driver ExecContext readers."""
    v = options.get(key)
    if v is None:
        return default
    return str(v).strip().lower() in ("1", "t", "true", "yes")


@dataclass
class ClientConfig:
    state_dir: str = ""
    alloc_dir: str = ""
    servers: list = field(default_factory=list)   # [(host, port)]
    node: Optional[Node] = None
    region: str = "global"
    # Free-form kv namespace consumed by drivers + fingerprints
    # (reference config.go:51-75 Options + Read/ReadBool helpers).
    options: dict = field(default_factory=dict)
    # In-proc RPC shortcut: an object with .call(method, args) used instead
    # of the network (reference config.go RPCHandler; agent.go:176-178).
    rpc_handler: Any = None
    dev_mode: bool = False

    def read(self, key: str, default: str = "") -> str:
        return str(self.options.get(key, default))

    def read_bool(self, key: str, default: bool = False) -> bool:
        return read_bool_option(self.options, key, default)
