"""What the benchmark reads by name: ``BENCHMARK.json`` at the root of
the checkout, and beside it in ``portbench/`` one file per
configuration, traffic mix, per-layer metric and kernel.

A new cell, configuration, metric or kernel is a new file plus a new
entry in ``BENCHMARK.json``: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Modules that no process of the benchmark may hold: JAX and the JAX
# package, compared by the whole top-level name (``nomad_tpu_torch``
# begins with ``nomad_tpu`` and is allowed).
FORBIDDEN = ("jax", "jaxlib", "flax", "nomad_tpu")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def guard(where: str, modules=None) -> None:
    """Raise if a forbidden module is loaded; says what and where."""
    found = forbidden_modules(modules)
    if found:
        raise ImportError(f"{where}: forbidden modules loaded: "
                          + ", ".join(found))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file, as run."""
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    """The traffic mix ``workloads/<name>.json``."""
    return load_json(here / "workloads" / f"{name}.json")


def _module(kind: str, name: str, here: Path):
    for p in (str(here), str(here / kind)):
        if p not in sys.path:
            sys.path.insert(0, p)
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, here: Path = HERE):
    """``metrics/<name>.py``'s ``read(ctx)``: a number, or None where
    the run gave it nothing to read."""
    return _module("metrics", name, here).read


def kernel_bytes(name: str, here: Path = HERE):
    """``kernels/<name>.py``'s ``nbytes(call)``: the bytes one launch's
    inputs and outputs need, from its logical shapes."""
    return _module("kernels", name, here).nbytes


def kernel_names(here: Path = HERE) -> list:
    return sorted(p.stem for p in (here / "kernels").glob("*.py")
                  if not p.stem.startswith("_"))


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics a traced run of the cell reports."""
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])]


def end_to_end(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def spread(values) -> float:
    """The distance between the first and third quartile as a share of
    the median (``statistics.quantiles``, the default method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100), linear between order
    statistics; a tail over every value, never over chunks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
