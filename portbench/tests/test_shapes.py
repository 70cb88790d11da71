"""The benchmark's inputs come from its data files alone: the
configurations' node shapes and the mixes' jobs equal the fixtures they
copy, the seed sets only ids, and a configuration or mix dropped into a
copy of the tree changes what runs with no code edit."""
import ast
import copy
import filecmp
import json
import shutil

import pytest

import run
import shapes
import spec
from conftest import SMALL_PACKING_LIMIT
from reference import judge

BENCH = spec.benchmark()


def without_id(d):
    return {k: v for k, v in d.items() if k != "id"}


@pytest.mark.parametrize("config", ["fleet10k-service", "fleet1k-batch"])
def test_the_node_shape_is_the_ports_mock_node(config):
    from nomad_tpu_torch import mock

    shape = spec.config(BENCH, config)["node_shape"]
    for i in (0, 3, 249, 250, 9999):
        want = without_id(mock.node(i).to_dict())
        assert without_id(shapes.node(shape, i, "x")) == want


def test_the_mixes_jobs_are_the_ports_mock_job_and_bench_group():
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Job

    # Equal as the server reads them (an absent task meta reads as {}).
    job = shapes.with_id(shapes.job_template(
        spec.traffic("mock-job")["job"]), "j")
    got = Job.from_dict(job).to_dict()
    assert without_id(got) == without_id(mock.job().to_dict())
    job = shapes.with_id(shapes.job_template(
        spec.traffic("deploy-1000g")["job"]), "j")
    assert len(job["task_groups"]) == 1000
    group = Job.from_dict(job).to_dict()["task_groups"][7]
    resources = {"cpu": 100, "memory_mb": 64, "disk_mb": 0, "iops": 0,
                 "networks": [{"device": "", "cidr": "", "ip": "",
                               "mbits": 5, "reserved_ports": [],
                               "dynamic_ports": ["http"]}]}
    assert group == {"name": "tg-7", "count": 1, "constraints": [],
                     "tasks": [{"name": "web", "driver": "exec",
                                "config": {}, "env": {}, "constraints": [],
                                "resources": resources, "meta": {}}],
                     "meta": {}}


@pytest.mark.parametrize("mix", ["deploy-1000g", "batch-10x4", "mock-job"])
def test_every_mix_builds_a_valid_job(mix):
    from nomad_tpu_torch.structs import Job

    job = shapes.with_id(shapes.job_template(spec.traffic(mix)["job"]), "j")
    assert not Job.from_dict(job).validate()


def test_the_seed_sets_ids_and_nothing_else():
    cfg = dict(spec.config(BENCH, "fleet1k-batch"), fleet={"nodes": 50})
    a = shapes.fleet(cfg, seed=2**31 + 5)
    b = shapes.fleet(cfg, seed=2**31 + 5)
    c = shapes.fleet(cfg, seed=2**31 + 6)
    assert a == b
    assert [without_id(n) for n in a] == [without_id(n) for n in c]
    assert {n["id"] for n in a}.isdisjoint({n["id"] for n in c})


def copied_tree(tmp_path):
    """The benchmark's files in a fresh root, with one new configuration
    (a larger node with an attribute of its own) and two new mixes
    (large asks; a system job), each a new file and a new entry."""
    root = tmp_path / "tree"
    here = root / "portbench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = copy.deepcopy(BENCH)

    cfg = spec.config(BENCH, "fleet1k-batch")
    cfg["name"] = "fleet40-big"
    cfg["fleet"] = {"nodes": 40}
    cfg["limits"]["packing_excess"] = SMALL_PACKING_LIMIT[
        "fleet1k.batch-10x4"]
    shape = cfg["node_shape"]
    shape["resources"].update(cpu=8000, memory_mb=16384)
    shape["attributes"]["rack"] = "r{octet}"
    (here / "configs" / "fleet40-big.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][1], name="fleet40-big",
                                 file="portbench/configs/fleet40-big.json"))

    large = spec.traffic("batch-10x4")
    large["clients"] = 3
    group = large["job"]["task_groups"][0]
    group.update(copies=3, count=2, constraints=[])
    group["tasks"][0]["resources"].update(cpu=1500, memory_mb=3000)
    (here / "workloads" / "large-asks.json").write_text(json.dumps(large))

    system = spec.traffic("mock-job")
    system["clients"] = 2
    system["job"].update(type="system", priority=100)
    system["job"]["task_groups"][0].update(count=1, meta={})
    (here / "workloads" / "system.json").write_text(json.dumps(system))

    for traffic in ("large-asks", "system"):
        bench["workloads"].append(dict(
            bench["workloads"][1], name=f"fleet40-big.{traffic}",
            config="fleet40-big", traffic=traffic))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, here


def test_a_configuration_and_mixes_dropped_into_a_copy_change_what_runs(
        tmp_path, monkeypatch):
    root, here = copied_tree(tmp_path)
    # No code edit: every program file of the copy is the original's.
    for path in spec.HERE.rglob("*.py"):
        if "_cache" not in path.parts and "__pycache__" not in path.parts:
            assert filecmp.cmp(path, here / path.relative_to(spec.HERE),
                               shallow=False)
    bench = spec.benchmark(root)
    cfg = spec.config(bench, "fleet40-big", root=root)
    nodes = shapes.fleet(cfg, seed=2**31 + 3)
    assert len(nodes) == 40
    assert nodes[5]["resources"]["cpu"] == 8000
    assert nodes[5]["attributes"]["rack"] == "r6"
    assert list(judge.node_room(nodes[5])[:2]) == [7900, 16128]
    job = shapes.job_template(spec.traffic("large-asks", here=here)["job"])
    assert [g["name"] for g in job["task_groups"]] == ["tg-0", "tg-1",
                                                       "tg-2"]
    assert list(judge.group_ask(job["task_groups"][2])) == [1500, 3000, 0,
                                                            0, 5]

    # Whole runs of the new cells on the CPU, at the kernels' path.
    monkeypatch.setenv("NOMAD_TPU_EXECUTOR", "device")
    for traffic in ("large-asks", "system"):
        cell = spec.cell(bench, f"fleet40-big.{traffic}")
        result = run.run_cell(bench, cell, cfg,
                              here / "workloads" / f"{traffic}.json",
                              2**31 + 3, 2, 0, device="cpu")
        assert result["correct"], {
            k: c for k, c in result["checks"].items()
            if c["value"] > c["limit"]}
        assert result["attempted"] > 0 and result["failed"] == 0


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in spec.HERE.rglob("*.py"):
        if "_cache" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in spec.FORBIDDEN, (path, name)
