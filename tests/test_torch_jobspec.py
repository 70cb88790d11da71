"""The port's jobspec parser (nomad_tpu_torch/jobspec) and duration
strings (nomad_tpu_torch/utils/duration.py).

First the JAX package's scenario suite (tests/test_jobspec.py) and its
duration cases (tests/test_utils.py), run against the port.  Then
parity with the JAX package on the same inputs: every scenario parsed
by both parsers gives an equal ``Job.to_dict()`` or the same
``ParseError`` text, the HCL layer gives equal trees, and
``parse_duration`` gives equal results (or both raise) over a table.
"""
from __future__ import annotations

import pytest

from nomad_tpu.jobspec import hcl_loads as jhcl_loads
from nomad_tpu.jobspec.parse import ParseError as JParseError
from nomad_tpu.jobspec.parse import parse as jparse
from nomad_tpu.utils.duration import parse_duration as jparse_duration
from nomad_tpu_torch.jobspec import hcl_loads
from nomad_tpu_torch.jobspec.parse import ParseError, parse
from nomad_tpu_torch.utils.duration import parse_duration

FULL = """
job "render-farm" {
    region = "emea"
    type = "service"
    priority = 70
    all_at_once = true
    datacenters = ["fr1", "de2"]

    meta {
        team = "render"
    }

    constraint {
        attribute = "kernel.os"
        value = "linux"
    }

    update {
        stagger = "45s"
        max_parallel = 3
    }

    task "janitor" {
        driver = "exec"
        config {
            command = "/usr/bin/cleanup"
        }
        meta {
            cadence = "hourly"
        }
    }

    group "tiles" {
        count = 4
        constraint {
            attribute = "kernel.arch"
            value = "amd64"
        }
        meta {
            tier = "gold"
            retries = 2
        }
        task "tiler" {
            driver = "docker"
            config {
                image = "example/tiler"
            }
            env {
                MODE = "fast"
                DEPTH = 8
            }
            resources {
                cpu = 750
                memory = 256
                network {
                    mbits = 25
                    reserved_ports = [8080, 8081]
                    dynamic_ports = ["metrics", "api"]
                }
            }
        }
        task "uploader" {
            driver = "exec"
            config {
                command = "/usr/bin/upload"
            }
            resources {
                cpu = 200
                memory = 64
            }
            constraint {
                attribute = "driver.exec"
                value = "1"
            }
        }
    }
}
"""


def test_full_featured_job():
    job = parse(FULL)
    assert job.id == job.name == "render-farm"
    assert job.region == "emea"
    assert job.type == "service"
    assert job.priority == 70
    assert job.all_at_once is True
    assert job.datacenters == ["fr1", "de2"]
    assert job.meta == {"team": "render"}
    (c,) = job.constraints
    assert (c.l_target, c.r_target, c.operand, c.hard) == \
        ("kernel.os", "linux", "=", True)
    assert job.update.stagger == 45.0
    assert job.update.max_parallel == 3

    # Group order: declared groups first, then bare-task wrappers?
    # The reference appends bare tasks as single-task groups after
    # groups are collected in declaration order (parse.go:128-141);
    # we preserve file semantics: look them up by name.
    by_name = {tg.name: tg for tg in job.task_groups}
    assert set(by_name) == {"janitor", "tiles"}

    jan = by_name["janitor"]
    assert jan.count == 1 and len(jan.tasks) == 1
    assert jan.tasks[0].driver == "exec"
    assert jan.tasks[0].meta == {"cadence": "hourly"}
    assert jan.tasks[0].config["command"] == "/usr/bin/cleanup"

    tiles = by_name["tiles"]
    assert tiles.count == 4
    assert tiles.meta == {"tier": "gold", "retries": "2"}  # stringified
    (gc,) = tiles.constraints
    assert (gc.l_target, gc.r_target) == ("kernel.arch", "amd64")
    tiler, uploader = tiles.tasks
    assert tiler.name == "tiler" and tiler.driver == "docker"
    assert tiler.env == {"MODE": "fast", "DEPTH": "8"}
    res = tiler.resources
    assert (res.cpu, res.memory_mb) == (750, 256)
    (net,) = res.networks
    assert net.mbits == 25
    assert net.reserved_ports == [8080, 8081]
    assert net.dynamic_ports == ["metrics", "api"]
    assert uploader.constraints[0].l_target == "driver.exec"


def test_default_job_fields():
    job = parse('job "tiny" { datacenters = ["dc1"] '
                'task "t" { driver = "exec" } }')
    assert job.id == job.name == "tiny"
    assert job.region == "global"          # parse.go defaults
    assert job.type == "service"
    assert job.priority == 50
    assert job.all_at_once is False
    assert job.update.stagger == 0 and job.update.max_parallel == 0
    # Bare task wraps into a single-task group named after it.
    (tg,) = job.task_groups
    assert tg.name == "t" and tg.count == 1


def test_job_label_is_id_name_may_differ():
    job = parse('job "job7" { name = "Pretty Name" '
                'datacenters = ["dc1"] '
                'task "t" { driver = "exec" } }')
    assert job.id == "job7"
    # The reference keeps ID from the label; name from the field when
    # present (specify-job.hcl).
    assert job.name == "Pretty Name"


def test_version_constraint_sugar():
    job = parse('job "v" { datacenters = ["dc1"] '
                'constraint { attribute = '
                '"$attr.kernel.version" version = "~> 3.2" } '
                'task "t" { driver = "exec" } }')
    (c,) = job.constraints
    assert c.operand == "version"
    assert c.r_target == "~> 3.2"


def test_regexp_constraint_sugar():
    job = parse('job "r" { datacenters = ["dc1"] '
                'constraint { attribute = '
                '"$attr.kernel.version" regexp = "[0-9.]+" } '
                'task "t" { driver = "exec" } }')
    (c,) = job.constraints
    assert c.operand == "regexp"
    assert c.r_target == "[0-9.]+"


def test_distinct_hosts_sugar():
    job = parse('job "d" { datacenters = ["dc1"] '
                'group "g" { constraint { distinct_hosts '
                '= true } task "t" { driver = "exec" } } }')
    (c,) = job.task_groups[0].constraints
    assert c.operand == "distinct_hosts"


def test_multi_network_rejected():
    bad = ('job "m" { task "t" { driver = "exec" resources { '
           'network { mbits = 10 } network { mbits = 20 } } } }')
    with pytest.raises(ParseError, match="one 'network'"):
        parse(bad)


def test_multi_resource_rejected():
    bad = ('job "m" { task "t" { driver = "exec" '
           'resources { cpu = 100 } resources { cpu = 200 } } }')
    with pytest.raises(ParseError, match="one 'resource'"):
        parse(bad)


def test_multi_update_rejected():
    bad = ('job "m" { update { stagger = "5s" } update { stagger = '
           '"6s" } task "t" { driver = "exec" } }')
    with pytest.raises(ParseError, match="one 'update'"):
        parse(bad)


def test_bad_dynamic_port_label_rejected():
    bad = ('job "m" { task "t" { driver = "exec" resources { '
           'network { dynamic_ports = ["ok_port", "bad#label!"] } '
           '} } }')
    with pytest.raises(ParseError, match="dynamic port label"):
        parse(bad)


def test_port_label_collision_case_insensitive():
    bad = ('job "m" { task "t" { driver = "exec" resources { '
           'network { dynamic_ports = ["Http", "http"] } } } }')
    with pytest.raises(ParseError,
                       match="port label collision"):
        parse(bad)


def test_no_job_block_rejected():
    with pytest.raises(ParseError, match="job"):
        parse('group "g" { }')


def test_two_job_blocks_rejected():
    with pytest.raises(ParseError, match="one 'job'"):
        parse('job "a" { task "t" { driver = "exec" } } '
              'job "b" { task "t" { driver = "exec" } }')


def test_bad_field_type_is_parse_error():
    with pytest.raises(ParseError):
        parse('job "x" { priority = "high" '
              'task "t" { driver = "exec" } }')


def test_stagger_duration_forms():
    for text, want in (('"90s"', 90.0), ('"2m"', 120.0),
                       ('"500ms"', 0.5)):
        job = parse(f'job "s" {{ datacenters = ["dc1"] '
                    f'update {{ stagger = {text} }} '
                    'task "t" { driver = "exec" } }')
        assert job.update.stagger == want, text


# -- duration strings (tests/test_utils.py's cases) --------------------------


def test_parse_duration_units():
    cases = [("500ms", 0.5), ("30s", 30.0), ("1m", 60.0), ("2h", 7200.0),
             ("1.5s", 1.5), ("90", 90.0), (15, 15.0), (0.25, 0.25)]
    for value, want in cases:
        assert parse_duration(value) == want, value


def test_parse_duration_rejects_garbage():
    for bad in ("", "fast", "10x", "s", "1d", "-5s"):
        with pytest.raises(ValueError):
            parse_duration(bad)


# -- parity with the JAX package ---------------------------------------------

DC = 'datacenters = ["dc1"]'
SCENARIOS = {
    "full": FULL,
    "defaults": 'job "tiny" { %s task "t" { driver = "exec" } }' % DC,
    "label-vs-name": ('job "job7" { name = "Pretty Name" %s '
                      'task "t" { driver = "exec" } }' % DC),
    "version": ('job "v" { %s constraint { attribute = '
                '"$attr.kernel.version" version = "~> 3.2" } '
                'task "t" { driver = "exec" } }' % DC),
    "regexp": ('job "r" { %s constraint { attribute = '
               '"$attr.kernel.version" regexp = "[0-9.]+" } '
               'task "t" { driver = "exec" } }' % DC),
    "distinct-hosts": ('job "d" { %s group "g" { constraint { '
                       'distinct_hosts = true } task "t" { '
                       'driver = "exec" } } }' % DC),
    "accel-gpu": ('job "a" { type = "batch" %s constraint { attribute = '
                  '"$attr.accel.platform" value = "gpu" } group "g" { '
                  'count = 32 constraint { distinct_hosts = true } '
                  'task "t" { driver = "raw_exec" config { command = '
                  '"/bin/sh" args = "-c \'echo hi\'" } resources { '
                  'cpu = 20 memory = 16 } } } }' % DC),
    "stagger-90s": ('job "s" { %s update { stagger = "90s" } '
                    'task "t" { driver = "exec" } }' % DC),
    "stagger-2m": ('job "s" { %s update { stagger = "2m" } '
                   'task "t" { driver = "exec" } }' % DC),
    "stagger-500ms": ('job "s" { %s update { stagger = "500ms" } '
                      'task "t" { driver = "exec" } }' % DC),
    "multi-network": ('job "m" { task "t" { driver = "exec" resources { '
                      'network { mbits = 10 } network { mbits = 20 } } } }'),
    "multi-resource": ('job "m" { task "t" { driver = "exec" '
                       'resources { cpu = 100 } resources { cpu = 200 } '
                       '} }'),
    "multi-update": ('job "m" { update { stagger = "5s" } update { '
                     'stagger = "6s" } task "t" { driver = "exec" } }'),
    "bad-port-label": ('job "m" { task "t" { driver = "exec" resources { '
                       'network { dynamic_ports = ["ok_port", '
                       '"bad#label!"] } } } }'),
    "port-collision": ('job "m" { task "t" { driver = "exec" resources { '
                       'network { dynamic_ports = ["Http", "http"] } } '
                       '} }'),
    "no-job": 'group "g" { }',
    "two-jobs": ('job "a" { task "t" { driver = "exec" } } '
                 'job "b" { task "t" { driver = "exec" } }'),
    "bad-field-type": ('job "x" { priority = "high" '
                       'task "t" { driver = "exec" } }'),
    "bad-stagger": ('job "s" { %s update { stagger = "soon" } '
                    'task "t" { driver = "exec" } }' % DC),
    "unterminated": 'job "x" { task "t" { driver = "exec" }',
}


OK = ("full", "defaults", "label-vs-name", "version", "regexp",
      "distinct-hosts", "accel-gpu", "stagger-90s", "stagger-2m",
      "stagger-500ms")


def _outcome(parse_fn, error, text):
    """The job's dict, the ParseError's text, or any other exception's
    type and text (an unterminated block raises IndexError in both
    packages' HCL layer)."""
    try:
        return "job", parse_fn(text).to_dict()
    except error as e:
        return "error", str(e)
    except Exception as e:
        return "raised", type(e).__name__, str(e)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_parse_equals_the_jax_parser(name):
    text = SCENARIOS[name]
    got = _outcome(parse, ParseError, text)
    assert got == _outcome(jparse, JParseError, text)
    assert got[0] == ("raised" if name == "unterminated" else
                      "job" if name in OK else "error")


@pytest.mark.parametrize("name", sorted(
    n for n in SCENARIOS if n not in ("unterminated",)))
def test_hcl_tree_equals_the_jax_one(name):
    assert hcl_loads(SCENARIOS[name]) == jhcl_loads(SCENARIOS[name])


DURATIONS = ("500ms", "30s", "1m", "2h", "1.5s", "90", 15, 0.25, "0",
             "0s", "1h30m", "100us", "2.5m", " 7s ", "", "fast", "10x",
             "s", "1d", "-5s", None, "1e3")


def _duration(fn, value):
    try:
        return "value", fn(value)
    except (ValueError, TypeError) as e:
        return "error", type(e).__name__, str(e)


@pytest.mark.parametrize("value", DURATIONS, ids=repr)
def test_parse_duration_equals_the_jax_one(value):
    assert _duration(parse_duration, value) == \
        _duration(jparse_duration, value)
