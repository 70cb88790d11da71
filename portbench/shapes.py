"""The benchmark's own inputs: node and job specs as plain dicts, in the
wire form the port's ``Node.from_dict`` / ``Job.from_dict`` read, built
from data alone.

A configuration's ``node_shape`` is one node in wire form without its
per-node fields; a traffic mix's ``job`` is one job in wire form without
its id, where a task group may carry ``copies`` (that many groups, each
named by formatting ``name`` with ``g``).  The files under ``configs/``
and ``workloads/`` copy the reference fixtures (``nomad/mock/mock.go``
``Node()`` and ``Job()``) and the north-star configs' bench task group
(100 MHz, 64 MB, 5 Mbit and one dynamic port); nothing here names one.
The seed sets only the ids, so every seed places the same work.
"""
from __future__ import annotations

import copy
import random

# Per-node fields the shape does not give: each node starts ready.
NODE_DEFAULTS = {"status": "ready", "status_description": "",
                 "drain": False, "create_index": 0, "modify_index": 0}


def uuid(rng: random.Random) -> str:
    h = f"{rng.getrandbits(128):032x}"
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def _fill(value, fields: dict):
    """``value`` with every string formatted by ``fields``."""
    if isinstance(value, str):
        return value.format(**fields)
    if isinstance(value, dict):
        return {k: _fill(v, fields) for k, v in value.items()}
    if isinstance(value, list):
        return [_fill(v, fields) for v in value]
    return value


def node(shape: dict, i: int, node_id: str) -> dict:
    """Node ``i`` of the shape: strings may name ``{i}`` and ``{octet}``
    (``i % 250 + 1``, for addresses); ``name`` defaults to
    ``node-{i}``."""
    out = dict(NODE_DEFAULTS, name="node-{i}")
    out.update(shape)
    out = _fill(out, {"i": i, "octet": i % 250 + 1})
    out["id"] = node_id
    return out


def fleet(cfg: dict, seed: int) -> list:
    """The configuration's ``fleet["nodes"]`` nodes of its
    ``node_shape``, ids from the seed."""
    rng = random.Random(f"fleet-{seed}")
    shape = cfg["node_shape"]
    return [node(shape, i, uuid(rng)) for i in range(cfg["fleet"]["nodes"])]


def job_template(job: dict) -> dict:
    """The job a traffic mix sends, without its id: ``job`` as given,
    each task group with ``copies`` expanded."""
    out = copy.deepcopy(job)
    groups = []
    for group in out["task_groups"]:
        copies = group.pop("copies", 1)
        for g in range(copies):
            one = copy.deepcopy(group) if copies > 1 else group
            one["name"] = group["name"].format(g=g)
            groups.append(one)
    out["task_groups"] = groups
    return out


def job_id(cell: str, seed: int, client: int, cycle: int) -> str:
    return f"{cell}-{seed}-c{client}-j{cycle}"


def with_id(template: dict, jid: str) -> dict:
    """The template as one job: a shallow copy with its own id (the
    groups are shared, never mutated)."""
    job = copy.copy(template)
    job["id"] = jid
    return job
