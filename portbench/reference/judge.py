"""The plain reference: judges the port's committed state against the
guarantees the configuration states, in NumPy.

It takes the inputs the harness made (node specs, the job template, the
requests each client had acknowledged) and the state read back from the
store after the window (evals, allocations, jobs and node statuses as
plain values), works out again what the inputs ask of every node, and
counts each broken guarantee.  It imports nothing of the program.

Each count is exact, with the limit 0:

- ``evals_incomplete``: an acknowledged request whose eval is missing,
  is not ``complete`` in the store, or was not seen complete by its
  client.
- ``evals_duplicated``: evals beyond one per acknowledged
  ``Job.Register`` / ``Job.Deregister`` of a job.
- ``groups_misplaced``: for each live job, each copy of each group that
  does not have exactly one running allocation, and each running
  allocation that is no copy of a live job's group.
- ``allocs_not_stopped``: running allocations of deregistered jobs.
- ``nodes_over_capacity``: nodes whose running allocations ask more than
  the node's resources less its reserved amount in CPU, memory, disk,
  IOPS or bandwidth.
- ``port_collisions``: a port held twice on a node (the node's reserved
  ports included), a dynamic port left unassigned, or one outside the
  dynamic range.
- ``constraint_violations``: running allocations on an unknown node or
  on a node whose attributes fail a constraint of the job or group.
- ``distinct_violations``: a group under ``distinct_hosts`` with two
  running allocations on one node.
- ``nodes_not_ready``: nodes that left ``ready``.

Those are exact counts, each with the limit 0.  One number is a ratio,
with the limit the configuration states (``limits``):

- ``packing_excess``: the nodes that hold running allocations beyond
  the fewest nodes whose room could hold the most jobs the run holds
  live at once, over that fewest: 0 for a packing as tight as the
  bound, below 0 where the close finds fewer jobs live.  The load is
  ``most_live_jobs`` copies of the job (for the closed loop, two a
  client: a client's previous job stays until its new one's eval is
  complete), or the jobs live at the close where more.  A
  deregistration leaves its nodes' other allocations in place, so the
  nodes held follow the most load, not the load at the close.  That
  fewest is a lower bound: for each dimension, the fewest nodes,
  roomiest first, whose room sums to the load's asks; no fewer than the
  copies of any group under ``distinct_hosts``, or than the nodes a
  system job runs on.  A bin-packing scheduler (ScoreFit prefers the
  fullest node that fits) reads near 0 once the fleet is busy; at a
  light load the job anti-affinity penalty spreads each job's
  placements and the reading rises.  One that spreads placements reads
  up to the allocations' count, or the fleet's size, over that fewest,
  less 1.

A ``system`` job wants one allocation of each copy of each group on
every ready node that meets its constraints; any other job wants each
copy of each group once.
"""
from __future__ import annotations

import re
from collections import Counter

import numpy as np

DIMS = ("cpu", "memory_mb", "disk_mb", "iops", "mbits")
MIN_DYNAMIC_PORT = 20000
MAX_DYNAMIC_PORT = 60000
NAME = re.compile(r"^(?P<job>.*)\.(?P<group>[^.\[]+)\[(?P<index>\d+)\]$")

CHECKS = ("evals_incomplete", "evals_duplicated", "groups_misplaced",
          "allocs_not_stopped", "nodes_over_capacity", "port_collisions",
          "constraint_violations", "distinct_violations", "nodes_not_ready",
          "packing_excess")



def limits(stated: dict) -> dict:
    """Each check's limit: 0 for a count, the configuration's stated
    one (``limits``) for a ratio; a ratio it does not state fails."""
    return {k: stated.get(k, 0) for k in CHECKS}


def broken(checks: dict, limit: dict) -> dict:
    """The checks whose value passes its limit."""
    return {k: v for k, v in checks.items() if v > limit.get(k, 0)}

def node_room(node: dict) -> np.ndarray:
    """Resources less reserved, in DIMS order."""
    res, rsv = node["resources"], node["reserved"]
    return np.array([
        res["cpu"] - rsv["cpu"], res["memory_mb"] - rsv["memory_mb"],
        res["disk_mb"] - rsv["disk_mb"], res["iops"] - rsv["iops"],
        sum(n["mbits"] for n in res["networks"])
        - sum(n["mbits"] for n in rsv["networks"])], dtype=np.int64)


def group_ask(group: dict) -> np.ndarray:
    out = np.zeros(len(DIMS), dtype=np.int64)
    for task in group["tasks"]:
        r = task["resources"]
        out += [r["cpu"], r["memory_mb"], r["disk_mb"], r["iops"],
                sum(n["mbits"] for n in r["networks"])]
    return out


def dynamic_ports(group: dict) -> int:
    return sum(len(n["dynamic_ports"]) for task in group["tasks"]
               for n in task["resources"]["networks"])


def attribute(node: dict, target: str):
    if target.startswith("$attr."):
        return node["attributes"].get(target[len("$attr."):])
    if target.startswith("$meta."):
        return node["meta"].get(target[len("$meta."):])
    if target == "$node.datacenter":
        return node["datacenter"]
    if target == "$node.name":
        return node["name"]
    if target == "$node.class":
        return node["node_class"]
    return target


def holds(node: dict, c: dict) -> bool:
    """A hard constraint other than ``distinct_hosts`` on one node."""
    left, right = attribute(node, c["l_target"]), attribute(node,
                                                            c["r_target"])
    op = c["operand"]
    if op in ("=", "==", "is"):
        return left is not None and left == right
    if op in ("!=", "not"):
        return left != right
    raise ValueError(f"operand {op!r} is not judged")


def judge(nodes: list, template: dict, ops: list, state: dict,
          most_live_jobs: int = 0) -> dict:
    """Count each broken guarantee.

    ``ops``: acknowledged requests as (kind, job_id, eval_id, status
    the client read).  ``state``: ``evals`` {id: (status, job_id,
    triggered_by)}; ``allocs``: a dict of equal-length lists ``node_id``,
    ``job_id``, ``name``, ``desired_status``, ``ports`` (each a list of
    ints); ``node_status`` {node_id: status}.  ``most_live_jobs``: the
    most jobs the traffic holds live at once, the packing's load."""
    out = dict.fromkeys(CHECKS, 0)
    groups = {g["name"]: g for g in template["task_groups"]}
    job_name = template["name"]

    # -- evals: each acknowledged request's eval, complete, once.
    evals = state["evals"]
    registered, deregistered = set(), set()
    per_job = Counter()
    for kind, job_id, eval_id, status in ops:
        (registered if kind == "register" else deregistered).add(job_id)
        ev = evals.get(eval_id)
        if ev is None or ev[0] != "complete" or status != "complete":
            out["evals_incomplete"] += 1
    for status, job_id, trigger in evals.values():
        if trigger in ("job-register", "job-deregister"):
            per_job[(job_id, trigger)] += 1
    acked = Counter((job_id, "job-" + kind)
                    for kind, job_id, _e, _s in ops)
    for key, n in per_job.items():
        out["evals_duplicated"] += max(0, n - acked.get(key, 0))
    live = registered - deregistered

    # -- allocations that run.
    a = state["allocs"]
    run = np.array([s == "run" for s in a["desired_status"]], dtype=bool)
    job_ids = np.array(a["job_id"], dtype=object)
    out["allocs_not_stopped"] = int(sum(
        1 for j, r in zip(job_ids, run) if r and j in deregistered))

    node_index = {n["id"]: i for i, n in enumerate(nodes)}
    rows = np.array([node_index.get(x, -1) for x in a["node_id"]],
                    dtype=np.int64)
    status = state["node_status"]
    ready = [status.get(n["id"]) == "ready" for n in nodes]

    # Hard constraints by group, and the groups under distinct_hosts.
    hard = [c for c in template["constraints"]
            if c["operand"] != "distinct_hosts"]
    by_group, distinct = {}, set()
    for name, g in groups.items():
        by_group[name] = hard + [c for c in g["constraints"]
                                 if c["operand"] != "distinct_hosts"]
        if any(c["operand"] == "distinct_hosts"
               for c in g["constraints"] + template["constraints"]):
            distinct.add(name)

    # Each copy of each live job's groups placed exactly once: a system
    # job's once on every ready node that meets its constraints.
    system = template["type"] == "system"
    eligible = {name: [n["id"] for n, ok in zip(nodes, ready)
                       if ok and all(holds(n, c) for c in by_group[name])]
                for name in groups} if system else {}
    want = set()
    for job_id in live:
        for name, g in groups.items():
            for i in range(g["count"]):
                if system:
                    want.update((job_id, name, i, nid)
                                for nid in eligible[name])
                else:
                    want.add((job_id, name, i))
    have = Counter()
    alloc_group = []
    for r, job_id, name, nid in zip(run, job_ids, a["name"], a["node_id"]):
        m = NAME.match(name or "")
        key = None
        if m is not None and m["job"] == job_name:
            key = (job_id, m["group"], int(m["index"]))
            if system:
                key += (nid,)
        alloc_group.append(key[1] if key else None)
        if r:
            have[key] += 1
    out["groups_misplaced"] = sum(abs(have.get(k, 0) - 1) for k in want) \
        + sum(n for k, n in have.items() if k not in want)

    # Capacity: every running allocation's ask, summed by node.
    known = run & (rows >= 0)
    out["constraint_violations"] += int((run & (rows < 0)).sum())
    ask = {name: group_ask(g) for name, g in groups.items()}
    ports_asked = {name: dynamic_ports(g) for name, g in groups.items()}
    asks = np.zeros((len(rows), len(DIMS)), dtype=np.int64)
    for k, gname in enumerate(alloc_group):
        if known[k] and gname in ask:
            asks[k] = ask[gname]
    used = np.zeros((len(nodes), len(DIMS)), dtype=np.int64)
    np.add.at(used, rows[known], asks[known])
    room = np.stack([node_room(n) for n in nodes]) if nodes else used
    out["nodes_over_capacity"] = int((used > room).any(axis=1).sum())

    # Ports: unique on each node, reserved ones included; every dynamic
    # port assigned inside the range.
    held = [Counter() for _ in nodes]
    for i, n in enumerate(nodes):
        for net in n["reserved"]["networks"]:
            held[i].update(net["reserved_ports"])
    for k in np.flatnonzero(known):
        ports = a["ports"][k]
        held[rows[k]].update(ports)
        gname = alloc_group[k]
        if gname in ports_asked:
            out["port_collisions"] += max(0, ports_asked[gname] - len(ports))
        out["port_collisions"] += sum(
            1 for p in ports
            if not MIN_DYNAMIC_PORT <= p <= MAX_DYNAMIC_PORT)
    out["port_collisions"] += sum(n - 1 for c in held
                                  for n in c.values() if n > 1)

    # Constraints, and distinct_hosts per (job, group).
    placed_on = Counter()
    for k in np.flatnonzero(known):
        gname = alloc_group[k]
        node = nodes[rows[k]]
        if gname in by_group and not all(holds(node, c)
                                         for c in by_group[gname]):
            out["constraint_violations"] += 1
        if gname in distinct:
            placed_on[(job_ids[k], gname, rows[k])] += 1
    out["distinct_violations"] = sum(n - 1 for n in placed_on.values()
                                     if n > 1)

    out["nodes_not_ready"] = sum(1 for ok in ready if not ok)

    # Packing: the nodes that hold running allocations beyond the fewest
    # that the most load could fit on.
    floor = max([1] + [groups[name]["count"] for name in distinct]
                + [len(ids) for ids in eligible.values()]) if live else 1
    per_job = sum((g["count"] * ask[name] for name, g in groups.items()),
                  np.zeros(len(DIMS), dtype=np.int64))
    load = per_job * max(len(live), most_live_jobs)
    holding = len(np.unique(rows[known]))
    fewest = max(floor, fewest_nodes(load, room))
    out["packing_excess"] = holding / fewest - 1 if holding else 0.0
    return out


def fewest_nodes(total: np.ndarray, room: np.ndarray) -> int:
    """The fewest nodes whose room sums to ``total`` in every dimension,
    each dimension's roomiest nodes first: a lower bound on the nodes
    any placement of those asks needs."""
    need = 0
    for d in range(len(total)):
        if total[d] <= 0:
            continue
        cum = np.cumsum(np.sort(room[:, d])[::-1])
        need = max(need, min(int(np.searchsorted(cum, total[d])) + 1,
                             len(cum)))
    return need
