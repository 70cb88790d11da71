"""The port's agent config files: twins of tests/test_agent_config.py
on ``nomad_tpu_torch`` (the reload case on a CPU dev agent).

Agent config files: HCL/JSON parse, multi-file merge, SIGHUP reload
(reference command/agent/config.go LoadConfig/Merge, command.go:463)."""
from __future__ import annotations

import json
import logging

import pytest

from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.agent.config import (ConfigError, apply_to_agent_config,
                                    load_config, load_config_sources,
                                    merge_config, parse_config_string)

BASE_HCL = """
# base agent config
region = "global"
datacenter = "dc1"
name = "node-a"
data_dir = "/tmp/nomad-a"
log_level = "INFO"
bind_addr = "0.0.0.0"
enable_debug = false
leave_on_terminate = true

ports {
    http = 5646
    rpc = 5647
    serf = 5648
}

client {
    enabled = true
    servers = ["10.0.0.1:4647", "10.0.0.2:4647"]
    node_class = "edge"
    meta {
        rack = "r1"
    }
    options {
        "driver.raw_exec.enable" = "true"
    }
}

telemetry {
    statsd_address = "127.0.0.1:8125"
}
"""

OVERRIDE_HCL = """
# second file: later wins, sections merge key-wise
log_level = "DEBUG"
enable_debug = true

ports {
    http = 6646
}

client {
    node_class = "core"
    meta {
        rack = "r2"
        zone = "z1"
    }
}

server {
    enabled = true
    num_schedulers = 4
    enabled_schedulers = ["service", "batch"]
    bootstrap_expect = 3
}
"""


def test_parse_hcl_config():
    tree = parse_config_string(BASE_HCL)
    assert tree["region"] == "global"
    assert tree["ports"] == {"http": 5646, "rpc": 5647, "serf": 5648}
    assert tree["client"]["enabled"] is True
    assert tree["client"]["meta"] == {"rack": "r1"}
    assert tree["client"]["servers"] == ["10.0.0.1:4647", "10.0.0.2:4647"]
    assert tree["telemetry"]["statsd_address"] == "127.0.0.1:8125"
    assert tree["leave_on_terminate"] is True


def test_parse_json_config():
    tree = parse_config_string(json.dumps(
        {"region": "eu", "ports": {"http": 7000},
         "server": {"enabled": True}}), hint="agent.json")
    assert tree["region"] == "eu"
    assert tree["ports"]["http"] == 7000
    assert tree["server"]["enabled"] is True


def test_merge_two_files(tmp_path):
    a = tmp_path / "a.hcl"
    b = tmp_path / "b.hcl"
    a.write_text(BASE_HCL)
    b.write_text(OVERRIDE_HCL)
    tree = load_config_sources([str(a), str(b)])
    # Later file wins per key ...
    assert tree["log_level"] == "DEBUG"
    assert tree["enable_debug"] is True
    assert tree["ports"]["http"] == 6646
    # ... but untouched keys in the same section survive.
    assert tree["ports"]["rpc"] == 5647
    assert tree["client"]["enabled"] is True
    assert tree["client"]["node_class"] == "core"
    assert tree["client"]["meta"] == {"rack": "r2", "zone": "z1"}
    assert tree["server"]["num_schedulers"] == 4


def test_load_config_dir(tmp_path):
    d = tmp_path / "conf.d"
    d.mkdir()
    (d / "10-base.hcl").write_text('region = "a"\nlog_level = "INFO"\n')
    (d / "20-over.json").write_text('{"region": "b"}')
    (d / "ignored.txt").write_text("not config")
    tree = load_config(str(d))
    assert tree["region"] == "b"          # sorted order: 20 over 10
    assert tree["log_level"] == "INFO"


def test_apply_to_agent_config(tmp_path):
    a = tmp_path / "a.hcl"
    b = tmp_path / "b.hcl"
    a.write_text(BASE_HCL)
    b.write_text(OVERRIDE_HCL)
    cfg = AgentConfig()
    apply_to_agent_config(cfg, load_config_sources([str(a), str(b)]))
    assert cfg.region == "global"
    assert cfg.name == "node-a"
    assert cfg.http_port == 6646 and cfg.rpc_port == 5647
    assert cfg.client_enabled and cfg.server_enabled
    assert cfg.servers == [("10.0.0.1", 4647), ("10.0.0.2", 4647)]
    assert cfg.node_class == "core"
    assert cfg.meta == {"rack": "r2", "zone": "z1"}
    assert cfg.client_options["driver.raw_exec.enable"] == "true"
    assert cfg.num_schedulers == 4
    assert cfg.enabled_schedulers == ["service", "batch"]
    assert cfg.bootstrap_expect == 3
    assert cfg.log_level == "DEBUG"
    assert cfg.enable_debug is True
    assert cfg.leave_on_term is True
    assert cfg.telemetry["statsd_address"] == "127.0.0.1:8125"


def test_unknown_key_rejected():
    with pytest.raises(ConfigError):
        apply_to_agent_config(AgentConfig(), {"bogus_key": 1})


def test_server_executor_parsed_and_validated():
    """server { executor = ... } plumbs the placement-kernel executor
    override (scheduler/executor.py) into AgentConfig; a typo fails the
    config load, not the first dispatch."""
    cfg = AgentConfig()
    apply_to_agent_config(cfg, parse_config_string(
        'server {\n  enabled = true\n  executor = "device"\n}\n'))
    assert cfg.executor == "device"
    with pytest.raises(ConfigError):
        apply_to_agent_config(AgentConfig(), parse_config_string(
            'server {\n  executor = "tpu"\n}\n'))


def test_merge_config_scalars_and_sections():
    merged = merge_config(
        {"x": 1, "s": {"a": 1, "b": 2}, "l": [1, 2]},
        {"x": 9, "s": {"b": 3}, "l": [7]})
    assert merged == {"x": 9, "s": {"a": 1, "b": 3}, "l": [7]}


def test_agent_reload_applies_reloadable_fields():
    cfg = AgentConfig.dev()
    cfg.device = "cpu"
    agent = Agent(cfg)
    try:
        applied = agent.reload({
            "log_level": "WARNING",
            "enable_debug": True,
            "region": "other",          # not reloadable: ignored
        })
        assert sorted(applied) == ["enable_debug", "log_level"]
        assert agent.config.log_level == "WARNING"
        assert agent.config.enable_debug is True
        assert agent.config.region == "global"
        assert logging.getLogger("nomad_tpu_torch").level == logging.WARNING
    finally:
        agent.shutdown()
        logging.getLogger("nomad_tpu_torch").setLevel(logging.NOTSET)


# ---------------------------------------------------------------------------
# the port's loader against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text,hint", [
    (BASE_HCL, "a.hcl"),
    (OVERRIDE_HCL, "b.hcl"),
    (json.dumps({"region": "eu", "ports": {"http": 7000},
                 "server": {"enabled": True, "executor": "host"}}),
     "agent.json"),
], ids=["base-hcl", "override-hcl", "json"])
def test_parsed_tree_equals_the_jax_packages(text, hint):
    from nomad_tpu.agent import config as jconfig

    assert parse_config_string(text, hint=hint) == \
        jconfig.parse_config_string(text, hint=hint)


def test_applied_config_equals_the_jax_packages(tmp_path):
    """The same two files make the same AgentConfig on both packages;
    the port's has one key more, ``device`` (None: the card)."""
    from nomad_tpu.agent import AgentConfig as JAgentConfig
    from nomad_tpu.agent import config as jconfig

    a = tmp_path / "a.hcl"
    b = tmp_path / "b.hcl"
    a.write_text(BASE_HCL)
    b.write_text(OVERRIDE_HCL)
    paths = [str(a), str(b)]
    got = vars(apply_to_agent_config(AgentConfig(),
                                     load_config_sources(paths)))
    want = vars(jconfig.apply_to_agent_config(
        JAgentConfig(), jconfig.load_config_sources(paths)))
    assert got.pop("device") is None
    assert got == want
    assert vars(AgentConfig.dev()) == dict(vars(JAgentConfig.dev()),
                                           device=None)
