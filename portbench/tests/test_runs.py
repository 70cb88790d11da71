"""Whole runs on the CPU at a size a test run holds: the harness's look
for a chip is skipped, the rest of a run is driven (the port's server,
the load generator's process, the window, the reference), and
``correct`` comes out true for the program as it is and false for the
control and for each fault the cells can have (``faults.py``)."""
import json

import pytest

import faults
import run
import spec
from conftest import SMALL_PACKING_LIMIT

BENCH = spec.benchmark()


@pytest.fixture(autouse=True)
def kernel_path(monkeypatch):
    from nomad_tpu_torch.ops import binpack, plan_conflict

    # At the cells' sizes the executor sends every placement to the
    # kernels (their plain versions on the CPU); at 60 nodes it would
    # pick the host twins, which the plants do not reach.
    monkeypatch.setenv("NOMAD_TPU_EXECUTOR", "device")
    # A plant stays for the life of the process: undo it after the test.
    monkeypatch.setattr(plan_conflict, "evaluate_window",
                        plan_conflict.evaluate_window)
    for name in faults.KERNELS:
        monkeypatch.setattr(binpack, name, getattr(binpack, name))


def small_run(tmp_path, cell_name, *, nodes, clients, groups=None,
              plant=None, trace=0):
    cell = spec.cell(BENCH, cell_name)
    cfg = spec.config(BENCH, cell["config"])
    cfg["fleet"]["nodes"] = nodes
    cfg["limits"]["packing_excess"] = SMALL_PACKING_LIMIT[cell_name]
    mix = spec.traffic(cell["traffic"])
    mix["clients"] = clients
    if groups is not None:
        mix["job"]["task_groups"][0]["copies"] = groups
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(mix))
    return run.run_cell(BENCH, cell, cfg, path, 2**31 + 11, 2, trace,
                        device="cpu", plant=plant)


def broken(result):
    return {k: c["value"] for k, c in result["checks"].items()
            if c["value"] > c["limit"]}


def test_the_program_as_it_is_comes_out_correct(tmp_path):
    result = small_run(tmp_path, "fleet1k.batch-10x4", nodes=60, clients=4,
                       groups=5, trace=1)
    assert result["correct"], broken(result)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert {"sched_ms_per_eval", "lanes_per_batch",
            "fsm_ms_per_alloc"} <= set(result["metrics"])


def test_the_control_of_fleet10k_service_is_not_correct(tmp_path):
    # 16 clients' first jobs plan as one fused batch from one snapshot;
    # with no fit check at commit they land on the same nodes.
    result = small_run(tmp_path, "fleet10k.mock-job", nodes=60, clients=16,
                       plant="verify_off")
    assert not result["correct"]
    assert broken(result)["nodes_over_capacity"] > 0


@pytest.mark.parametrize("cell_name,nodes,clients,groups", [
    ("fleet1k.batch-10x4", 60, 4, 5),
    ("fleet10k.mock-job", 300, 8, None),
])
def test_the_spread_control_breaks_the_packing(tmp_path, cell_name, nodes,
                                                clients, groups):
    result = small_run(tmp_path, cell_name, nodes=nodes, clients=clients,
                       groups=groups, plant="spread")
    assert not result["correct"]
    assert "packing_excess" in broken(result)


@pytest.mark.parametrize("cell_name,plant", [
    ("fleet1k.batch-10x4", "stops_dropped"),  # the configuration's control
    ("fleet1k.batch-10x4", "state_unchanged"),
    ("fleet1k.batch-10x4", "half_batch"),
    ("fleet1k.batch-10x4", "answer_altered"),
    ("fleet10k.mock-job", "state_unchanged"),
    ("fleet10k.mock-job", "half_batch"),
    ("fleet10k.mock-job", "answer_altered"),
])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, cell_name,
                                                     plant):
    groups = 5 if cell_name == "fleet1k.batch-10x4" else None
    result = small_run(tmp_path, cell_name, nodes=60, clients=4,
                       groups=groups, plant=plant)
    assert not result["correct"]
    assert broken(result)


@pytest.mark.card
@pytest.mark.parametrize("cell_name,plant,check", [
    ("fleet10k.deploy-1000g", "verify_off", "nodes_over_capacity"),
    ("fleet10k.mock-job", "verify_off", "nodes_over_capacity"),
    ("fleet1k.batch-10x4", "stops_dropped", "allocs_not_stopped"),
    ("fleet10k.deploy-1000g", "spread", "packing_excess"),
    ("fleet10k.mock-job", "spread", "packing_excess"),
    ("fleet1k.batch-10x4", "spread", "packing_excess"),
])
def test_the_control_at_the_cells_size_is_not_correct(card, cell_name,
                                                      plant, check):
    cell = spec.cell(BENCH, cell_name)
    result = run.run_cell(
        BENCH, cell, spec.config(BENCH, cell["config"]),
        spec.HERE / "workloads" / f"{cell['traffic']}.json", 2**31 + 21,
        20, 0, plant=plant)
    print(cell_name, plant, json.dumps(
        {k: c["value"] for k, c in result["checks"].items()}))
    assert not result["correct"]
    assert check in broken(result), result["checks"]
