"""The harness finds every piece by name, keeps JAX and the JAX package
out, and its BENCHMARK.json keeps to the benchmark's contract."""
import json
import re
import shutil
from pathlib import Path

import pytest

import spec

ROOT = spec.ROOT
BENCH = spec.benchmark()
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.mark.parametrize("modules,hits", [
    ({"jax": 1, "os": 1}, ["jax"]),
    ({"jax.numpy": 1}, ["jax.numpy"]),
    ({"jaxlib.xla_client": 1}, ["jaxlib.xla_client"]),
    ({"flax": 1}, ["flax"]),
    ({"nomad_tpu": 1, "nomad_tpu.server": 1}, ["nomad_tpu",
                                               "nomad_tpu.server"]),
    ({"nomad_tpu_torch": 1, "nomad_tpu_torch.server": 1, "jaxtyping": 1},
     []),
])
def test_the_import_guard_compares_whole_top_level_names(modules, hits):
    assert spec.forbidden_modules(modules) == hits
    if hits:
        with pytest.raises(ImportError, match=hits[0]):
            spec.guard("here", modules)
    else:
        spec.guard("here", modules)


def test_a_mix_metric_and_kernel_dropped_into_a_copy_are_found(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(spec.HERE, copy,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    mix = dict(spec.traffic("mock-job"), clients=3)
    (copy / "workloads" / "fresh-mix.json").write_text(json.dumps(mix))
    (copy / "metrics" / "fresh_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (copy / "kernels" / "K9.py").write_text(
        "def nbytes(call):\n    return 7\n")
    assert spec.traffic("fresh-mix", here=copy)["clients"] == 3
    assert spec.metric_reader("fresh_metric", here=copy)({}) == 42.0
    assert "K9" in spec.kernel_names(here=copy)
    assert spec.kernel_bytes("K9", here=copy)({}) == 7


def test_the_file_keeps_to_its_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (ROOT / p).is_dir()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert (spec.HERE / "workloads" / f"{w['traffic']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_name_unit_and_line_uses_the_allowed_characters():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert spec.NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [x["why"] for key in ("configs", "workloads")
             for x in BENCH[key]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    texts += [c["source"] for c in BENCH["configs"]] + BENCH["command"]
    for text in texts:
        assert TEXT.match(text), text
    for path in spec.HERE.rglob("*"):
        if "__pycache__" in path.parts or "_cache" in path.parts:
            continue
        assert re.fullmatch(r"[A-Za-z0-9_.\-]+", path.name), path


def test_the_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline_" in m["name"]:
            assert m["unit"] == "%"
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        reported = {m["name"] for m in spec.end_to_end(BENCH, cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(BENCH, cell)
        for m in spec.per_layer(BENCH, cell):
            assert m["moves"] in reported
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_states_its_deployment(cfg):
    body = spec.load_json(ROOT / cfg["file"])
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    for key in ("fleet", "server", "guarantees", "assumed"):
        assert body[key]


def test_percentile_and_spread():
    assert spec.percentile([1, 2, 3, 4, 5], 50) == 3
    assert spec.percentile(list(range(101)), 95) == 95
    assert spec.spread([10, 10, 10, 10]) == 0
