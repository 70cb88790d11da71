"""Jobspec -> structs.Job.

Capability parity with reference jobspec/parse.go: job/group/task/
constraint/resources/network/update/env/meta stanzas with the reference's
defaults (region=global, type=service, priority=50, count=1); job-level
bare tasks wrap into a group named after the task (parse.go:128-141);
constraint sugar keys (version=, regexp=) set the operand; duration strings
("30s", "1m") for update.stagger.
"""
from __future__ import annotations

import re
from typing import Optional

from nomad_tpu_torch.utils.duration import parse_duration
from nomad_tpu_torch.structs import (
    Constraint,
    Job,
    NetworkResource,
    Resources,
    Task,
    TaskGroup,
    UpdateStrategy,
)

from .hcl import HCLError, loads


class ParseError(ValueError):
    pass


_DYNAMIC_PORT_RE = re.compile(r"^[a-zA-Z0-9_]+$")


def parse(text: str) -> Job:
    try:
        root = loads(text)
    except HCLError as e:
        raise ParseError(str(e)) from e

    jobs = root.get("job")
    if not jobs:
        raise ParseError("exactly one 'job' block is required")
    if len(jobs) > 1:
        raise ParseError("only one 'job' block per file")
    try:
        return _parse_job(jobs[0])
    except ParseError:
        raise
    except (ValueError, TypeError) as e:
        # Bad field types (priority = "high", count = "x", ...) must
        # surface as ParseError so callers' validation paths catch them.
        raise ParseError(str(e)) from e


def parse_file(path: str) -> Job:
    with open(path) as fh:
        return parse(fh.read())


def _parse_job(obj: dict) -> Job:
    job = Job(
        id=obj.get("__label__", ""),
        # The label is the ID; an explicit ``name`` field may differ
        # (reference test-fixtures/specify-job.hcl).
        name=str(obj.get("name", obj.get("__label__", ""))),
        region=obj.get("region", "global"),
        type=obj.get("type", "service"),
        priority=int(obj.get("priority", 50)),
        all_at_once=bool(obj.get("all_at_once", False)),
        datacenters=list(obj.get("datacenters", [])),
        meta=_parse_meta(obj),
    )
    job.constraints = _parse_constraints(obj)
    updates = obj.get("update", [])
    if len(updates) > 1:
        raise ParseError("only one 'update' block allowed per job")
    for upd in updates:
        job.update = UpdateStrategy(
            stagger=_parse_duration(upd.get("stagger", 0)),
            max_parallel=int(upd.get("max_parallel", 0)),
        )

    for group in obj.get("group", []):
        job.task_groups.append(_parse_group(group))
    # Job-level bare tasks become single-task groups (parse.go:128-141).
    for task_obj in obj.get("task", []):
        task = _parse_task(task_obj)
        job.task_groups.append(TaskGroup(
            name=task.name, count=1, tasks=[task]))

    errs = job.validate()
    if errs:
        raise ParseError("; ".join(errs))
    return job


def _parse_group(obj: dict) -> TaskGroup:
    tg = TaskGroup(
        name=obj.get("__label__", ""),
        count=int(obj.get("count", 1)),
        meta=_parse_meta(obj),
        constraints=_parse_constraints(obj),
    )
    for task_obj in obj.get("task", []):
        tg.tasks.append(_parse_task(task_obj))
    return tg


def _parse_task(obj: dict) -> Task:
    task = Task(
        name=obj.get("__label__", ""),
        driver=obj.get("driver", ""),
        meta=_parse_meta(obj),
        constraints=_parse_constraints(obj),
    )
    for config in obj.get("config", []):
        task.config = {k: v for k, v in config.items()
                       if k != "__label__"}
    for env in obj.get("env", []):
        task.env = {k: str(v) for k, v in env.items()
                    if k != "__label__"}
    resources = obj.get("resources", [])
    if len(resources) > 1:
        # Message verbatim from the reference (parse.go parseResources),
        # singular 'resource' and all, so error-matching stays portable.
        raise ParseError("only one 'resource' block allowed per task")
    for res in resources:
        task.resources = _parse_resources(res)
    return task


def _parse_resources(obj: dict) -> Resources:
    res = Resources(
        cpu=int(obj.get("cpu", 100)),
        memory_mb=int(obj.get("memory", 10)),
        disk_mb=int(obj.get("disk", 0)),
        iops=int(obj.get("iops", 0)),
    )
    nets = obj.get("network", [])
    if len(nets) > 1:
        raise ParseError("only one 'network' resource allowed")
    for net in nets:
        n = NetworkResource(
            mbits=int(net.get("mbits", 10)),
            reserved_ports=[int(p) for p in
                            net.get("reserved_ports", [])],
        )
        # Labels become environment variables, so they must not collide
        # case-insensitively (parse.go:411-426).
        seen: dict = {}
        for label in net.get("dynamic_ports", []):
            label = str(label)
            if not _DYNAMIC_PORT_RE.match(label):
                raise ParseError(
                    f"invalid dynamic port label {label!r}")
            first = seen.get(label.lower())
            if first is not None:
                raise ParseError(
                    f"Found a port label collision: `{label}` "
                    f"overlaps with previous `{first}`")
            seen[label.lower()] = label
            n.dynamic_ports.append(label)
        res.networks.append(n)
    return res


def _parse_constraints(obj: dict) -> list:
    out = []
    for c in obj.get("constraint", []):
        constraint = Constraint(
            hard=bool(c.get("hard", True)),
            l_target=str(c.get("attribute", "")),
            r_target=str(c.get("value", "")),
            operand=str(c.get("operator", "=")),
            weight=int(c.get("weight", 0)),
        )
        # Sugar: version = ">= 1.0" / regexp = "..." set the operand
        # (parse.go:245-258).
        if "version" in c:
            constraint.operand = "version"
            constraint.r_target = str(c["version"])
        elif "regexp" in c:
            constraint.operand = "regexp"
            constraint.r_target = str(c["regexp"])
        elif "distinct_hosts" in c:
            constraint.operand = "distinct_hosts"
            constraint.r_target = ""
        out.append(constraint)
    return out


def _parse_meta(obj: dict) -> dict:
    meta: dict = {}
    for m in obj.get("meta", []):
        meta.update({k: str(v) for k, v in m.items()
                     if k != "__label__"})
    return meta


def _parse_duration(value) -> float:
    """'30s'/'1m'/'500ms' or a bare number of seconds."""
    try:
        return parse_duration(value)
    except ValueError as e:
        raise ParseError(str(e)) from e
