"""Agent configuration files: HCL or JSON, merged in order, reloadable.

Capability parity with reference command/agent/config.go
(LoadConfig/LoadConfigFile/LoadConfigDir/Merge, 490-620) and the SIGHUP
reload path in command.go:403-463.  A config source is a file (.hcl or
.json, sniffed by content when the extension is ambiguous) or a directory
(every .hcl/.json file inside, sorted by name).  Multiple ``-config``
flags merge in order, later sources winning per key; block sections
(client/server/ports/telemetry/...) merge key-wise rather than wholesale,
matching the reference's per-field Merge methods.

Counterpart of ``nomad_tpu/agent/config.py``: the same file schema,
read by the port's ``jobspec.hcl``; ``server.executor`` is checked by
the port's ``scheduler/executor.py``.
"""
from __future__ import annotations

import json
import os
from typing import Any, List

from nomad_tpu_torch.jobspec.hcl import HCLError, loads as hcl_loads

# Keys that take effect on SIGHUP without restarting the agent
# (reference handleReload only re-applies the log filter; we also allow
# the debug-endpoint gate and telemetry sinks, which are side-effect-free
# to swap at runtime).
RELOADABLE_KEYS = ("log_level", "enable_debug", "telemetry")

class ConfigError(ValueError):
    pass


def _normalize(tree: dict) -> dict:
    """Collapse HCL block lists: ``client { .. }`` parses as
    ``{"client": [{..}]}`` and so do nested blocks (meta/options/ports);
    the agent schema wants one dict per section.  Repeated blocks of the
    same section merge in file order.  Value lists (e.g. ``servers``)
    hold scalars and pass through untouched."""
    out: dict = {}
    for key, value in tree.items():
        if isinstance(value, list) and value and \
                all(isinstance(item, dict) for item in value):
            merged: dict = {}
            for item in value:
                item = {k: v for k, v in item.items() if k != "__label__"}
                merged = merge_config(merged, _normalize(item))
            out[key] = merged
        else:
            out[key] = value
    return out


def parse_config_string(text: str, hint: str = "") -> dict:
    """Parse one config document.  JSON when the hint says so or the text
    starts with '{'; HCL otherwise (reference LoadConfigString relies on
    hcl accepting both — we sniff instead)."""
    stripped = text.lstrip()
    if hint.endswith(".json") or stripped.startswith("{"):
        try:
            tree = json.loads(text)
        except json.JSONDecodeError as e:
            raise ConfigError(f"invalid JSON config: {e}") from e
    else:
        try:
            tree = hcl_loads(text)
        except HCLError as e:
            raise ConfigError(f"invalid HCL config: {e}") from e
    if not isinstance(tree, dict):
        raise ConfigError("config root must be an object")
    return _normalize(tree)


def load_config_file(path: str) -> dict:
    with open(path) as fh:
        return parse_config_string(fh.read(), hint=path)


def load_config(path: str) -> dict:
    """File or directory (reference LoadConfig, config.go:490-503)."""
    if os.path.isdir(path):
        names = sorted(
            n for n in os.listdir(path)
            if n.endswith(".hcl") or n.endswith(".json"))
        merged: dict = {}
        for name in names:
            merged = merge_config(merged,
                                  load_config_file(os.path.join(path, name)))
        return merged
    return load_config_file(path)


def load_config_sources(paths: List[str]) -> dict:
    """Merge several -config sources in flag order, later wins."""
    merged: dict = {}
    for path in paths:
        merged = merge_config(merged, load_config(path))
    return merged


def merge_config(base: dict, over: dict) -> dict:
    """Recursive merge: dict sections merge key-wise, scalars and lists
    from ``over`` replace (reference Config.Merge semantics: zero values
    don't override, set values do — in dict form, absence is the zero)."""
    out = dict(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merge_config(out[key], value)
        else:
            out[key] = value
    return out


def apply_to_agent_config(cfg: "AgentConfig", tree: dict) -> "AgentConfig":
    """Map the file schema onto AgentConfig fields.  Unknown keys are an
    error (the reference's hcl decode is strict about section shapes)."""
    def _set(attr: str, value: Any) -> None:
        setattr(cfg, attr, value)

    scalar_map = {
        "region": "region", "datacenter": "datacenter", "name": "name",
        "data_dir": "data_dir", "bind_addr": "bind_addr",
        "log_level": "log_level", "enable_debug": "enable_debug",
        "leave_on_interrupt": "leave_on_int",
        "leave_on_terminate": "leave_on_term",
    }
    for key, value in tree.items():
        if key in scalar_map:
            _set(scalar_map[key], value)
        elif key == "ports":
            if "http" in value:
                cfg.http_port = _int("ports.http", value["http"])
            if "rpc" in value:
                cfg.rpc_port = _int("ports.rpc", value["rpc"])
            if "serf" in value:
                cfg.serf_port = _int("ports.serf", value["serf"])
        elif key in ("addresses", "advertise"):
            # Bind/advertise overrides default to bind_addr; carried for
            # parity, applied where the planes read them.
            getattr(cfg, key).update(value)
        elif key == "client":
            if "enabled" in value:
                cfg.client_enabled = bool(value["enabled"])
            if "servers" in value:
                cfg.servers = [_addr(s) for s in _as_list(value["servers"])]
            if "node_class" in value:
                cfg.node_class = value["node_class"]
            if "meta" in value:
                cfg.meta.update(value["meta"])
            if "options" in value:
                cfg.client_options.update(value["options"])
            if "state_dir" in value:
                cfg.client_state_dir = value["state_dir"]
            if "alloc_dir" in value:
                cfg.client_alloc_dir = value["alloc_dir"]
            if "node_id" in value:
                cfg.client_node_id = value["node_id"]
            if "network_speed" in value:
                cfg.network_speed = _int("client.network_speed", value["network_speed"])
        elif key == "server":
            if "enabled" in value:
                cfg.server_enabled = bool(value["enabled"])
            if "bootstrap_expect" in value:
                cfg.bootstrap_expect = _int("server.bootstrap_expect", value["bootstrap_expect"])
            if "num_schedulers" in value:
                cfg.num_schedulers = _int("server.num_schedulers", value["num_schedulers"])
            if "enabled_schedulers" in value:
                cfg.enabled_schedulers = _as_list(
                    value["enabled_schedulers"])
            if "data_dir" in value:
                cfg.server_data_dir = value["data_dir"]
            if "retry_join" in value:
                cfg.retry_join = [_addr(s)
                                  for s in _as_list(value["retry_join"])]
            if "executor" in value:
                # Validated here so a typo'd config file fails the boot
                # with the file's vocabulary, not at first dispatch.
                from nomad_tpu_torch.scheduler.executor import (
                    ExecutorPolicyError, validate_executor)
                try:
                    cfg.executor = validate_executor(value["executor"],
                                                     "server.executor")
                except ExecutorPolicyError as e:
                    raise ConfigError(str(e)) from None
        elif key == "telemetry":
            cfg.telemetry = dict(value)
        elif key == "atlas":
            pass  # defunct external service; accepted, ignored (README)
        else:
            raise ConfigError(f"unknown config key {key!r}")
    return cfg


def _as_list(value: Any) -> list:
    return value if isinstance(value, list) else [value]


def _int(key: str, value: Any) -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        raise ConfigError(f"config key {key!r} wants an integer, "
                          f"got {value!r}") from None


def _addr(spec: str) -> tuple:
    host, _, port = str(spec).rpartition(":")
    if not host:
        raise ConfigError(f"server address {spec!r} needs host:port")
    return (host, _int("server address port", port))
