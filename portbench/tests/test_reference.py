"""The plain reference flags each broken guarantee it is shown."""
import copy

import numpy as np

import shapes
import spec
from reference import judge


BENCH = spec.benchmark()
CFG = spec.config(BENCH, "fleet1k-batch")
LIMITS = judge.limits(CFG["limits"])


def small_world():
    """Two jobs of the batch mix cut to two groups of count 2 on four
    nodes of the configuration's shape; job a deregistered."""
    nodes = shapes.fleet(dict(CFG, fleet={"nodes": 4}), seed=7)
    job = copy.deepcopy(spec.traffic("batch-10x4")["job"])
    job["task_groups"][0]["copies"] = 2
    job["task_groups"][0]["count"] = 2
    template = shapes.job_template(job)
    ops = [("register", "a", "ea", "complete"),
           ("register", "b", "eb", "complete"),
           ("deregister", "a", "da", "complete")]
    evals = {"ea": ("complete", "a", "job-register"),
             "eb": ("complete", "b", "job-register"),
             "da": ("complete", "a", "job-deregister")}
    allocs = {"node_id": [], "job_id": [], "name": [], "desired_status": [],
              "ports": []}
    port = 20000
    for job, status in (("a", "stop"), ("b", "run")):
        for g in range(2):
            for i in range(2):
                allocs["node_id"].append(nodes[i]["id"])
                allocs["job_id"].append(job)
                allocs["name"].append(f"my-job.tg-{g}[{i}]")
                allocs["desired_status"].append(status)
                allocs["ports"].append([port])
                port += 1
    state = {"evals": evals, "allocs": allocs,
             "node_status": {n["id"]: "ready" for n in nodes}}
    return nodes, template, ops, state


def test_a_sound_state_breaks_nothing():
    out = judge.judge(*small_world())
    assert not judge.broken(out, LIMITS)
    # b's four allocations on two nodes, and distinct_hosts needs two.
    assert out["packing_excess"] == 0.0


def test_oversubscription_is_flagged():
    nodes, template, ops, state = small_world()
    nodes = copy.deepcopy(nodes)
    nodes[0]["resources"]["cpu"] = 250  # 150 MHz free, two allocs ask 200
    out = judge.judge(nodes, template, ops, state)
    assert out["nodes_over_capacity"] == 1


def test_double_placement_is_flagged():
    nodes, template, ops, state = small_world()
    a = state["allocs"]
    for key in a:
        a[key].append(a[key][-1] if key != "node_id" else nodes[3]["id"])
    a["ports"][-1] = [30000]
    out = judge.judge(nodes, template, ops, state)
    assert out["groups_misplaced"] == 1


def test_missing_stop_is_flagged():
    nodes, template, ops, state = small_world()
    state["allocs"]["desired_status"][0] = "run"
    out = judge.judge(nodes, template, ops, state)
    assert out["allocs_not_stopped"] == 1


def test_missing_placement_and_eval_are_flagged():
    nodes, template, ops, state = small_world()
    a = state["allocs"]
    for key in a:
        del a[key][-1]
    del state["evals"]["eb"]
    out = judge.judge(nodes, template, ops, state)
    assert out["groups_misplaced"] == 1
    assert out["evals_incomplete"] == 1


def test_port_collision_and_distinct_hosts_are_flagged():
    nodes, template, ops, state = small_world()
    a = state["allocs"]
    # b's tg-0[1] joins tg-0[0] on its node, holding the same port
    a["ports"][5] = list(a["ports"][4])
    a["node_id"][5] = a["node_id"][4]
    out = judge.judge(nodes, template, ops, state)
    assert out["port_collisions"] == 1
    assert out["distinct_violations"] == 1


def test_constraint_and_node_status_are_flagged():
    nodes, template, ops, state = small_world()
    nodes = copy.deepcopy(nodes)
    nodes[1]["attributes"]["kernel.name"] = "windows"
    state["node_status"][nodes[2]["id"]] = "down"
    out = judge.judge(nodes, template, ops, state)
    assert out["constraint_violations"] == 2  # both groups of b on node 1
    assert out["nodes_not_ready"] == 1


def test_the_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    src = (Path(judge.__file__)).read_text()
    tops = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
            else (n.module or "").split(".")[0]
            for n in ast.walk(ast.parse(src))
            if isinstance(n, (ast.Import, ast.ImportFrom))}
    assert tops <= {"__future__", "re", "collections", "numpy"}


def test_spread_placements_are_flagged():
    nodes, template, ops, state = small_world()
    a = state["allocs"]
    # b's four allocations each on a node of its own.
    for k, node in zip(range(4, 8), nodes):
        a["node_id"][k] = node["id"]
    out = judge.judge(nodes, template, ops, state)
    assert out["packing_excess"] == 1.0
    assert set(judge.broken(out, dict(LIMITS, packing_excess=0.5))) == {
        "packing_excess"}
    # A ratio the configuration states no limit for fails.
    assert "packing_excess" in judge.broken(out, judge.limits({}))


def test_the_fewest_nodes_is_a_lower_bound_in_every_dimension():
    room = np.array([[10, 4], [10, 4], [5, 8], [1, 1]])
    assert judge.fewest_nodes(np.array([0, 0]), room) == 0
    assert judge.fewest_nodes(np.array([20, 0]), room) == 2
    assert judge.fewest_nodes(np.array([21, 0]), room) == 3
    assert judge.fewest_nodes(np.array([1, 13]), room) == 3
    assert judge.fewest_nodes(np.array([99, 0]), room) == 4


def test_a_system_job_is_wanted_on_every_eligible_node():
    nodes, template, ops, state = small_world()
    nodes = copy.deepcopy(nodes)
    nodes[3]["attributes"]["kernel.name"] = "windows"
    template = dict(template, type="system",
                    task_groups=template["task_groups"][:1])
    for g in template["task_groups"]:
        g["count"] = 1
    a = {"node_id": [], "job_id": [], "name": [], "desired_status": [],
         "ports": []}
    for k, node in enumerate(nodes[:3]):
        a["node_id"].append(node["id"])
        a["job_id"].append("b")
        a["name"].append("my-job.tg-0[0]")
        a["desired_status"].append("run")
        a["ports"].append([20000 + k])
    state["allocs"] = a
    out = judge.judge(nodes, template, ops, state)
    assert not judge.broken(out, LIMITS)
    assert out["packing_excess"] == 0.0
    for key in a:
        del a[key][1]
    out = judge.judge(nodes, template, ops, state)
    assert out["groups_misplaced"] == 1
