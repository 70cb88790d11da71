"""Tier-1 gate for the port's static analyzers (nomad_tpu_torch/analysis).

1. **The standing gate**: the whole-program pass over
   ``nomad_tpu_torch/`` is clean against ``LINT_ALLOWLIST_TORCH.txt``:
   zero unallowlisted findings, zero stale entries, every entry
   justified.  The tree is parsed and linted ONCE for the module; the
   checks below read that one result.
2. **The JAX suite's synthetic packages**: every package
   ``tests/test_static_analysis.py`` writes runs through the JAX
   package's five shared passes and the port's, which must report the
   same finding keys, severities and lines.
3. **torchlint** (the counterpart of jaxlint): each rule fires on a
   snippet and stays silent on its sanctioned twin.
"""
from __future__ import annotations

import ast
import os
import textwrap
import time
from types import SimpleNamespace

import pytest

from nomad_tpu_torch.analysis import (
    Finding,
    default_allowlist_path,
    default_package_root,
    load_allowlist,
    partition_findings,
    run_lint,
    torchlint,
)
from nomad_tpu_torch.analysis import callgraph, lockcheck

from tests import torch_lint_cases as cases


@pytest.fixture(scope="module")
def port_lint():
    """One parse and one whole-program pass over nomad_tpu_torch/, with
    the pass's CPU time."""
    root = default_package_root()
    scan = lockcheck.scan_package(root)
    graph = callgraph.CallGraph.build(root, parsed=scan[1])
    coverage: dict = {}
    t0 = time.process_time()
    findings = run_lint(root, strict=True, coverage_out=coverage,
                        scan=scan, graph=graph)
    cpu_s = time.process_time() - t0
    allowlist = load_allowlist(default_allowlist_path())
    gating, allowed, stale = partition_findings(findings, allowlist)
    return SimpleNamespace(findings=findings, coverage=coverage,
                           graph=graph, cpu_s=cpu_s, allowlist=allowlist,
                           gating=gating, allowed=allowed, stale=stale)


# ---------------------------------------------------------------------------
# 1. the standing gate
# ---------------------------------------------------------------------------

class TestLintGate:
    def test_package_is_clean(self, port_lint):
        """THE gate: every finding over nomad_tpu_torch/ is fixed or
        carries a justified allowlist line, and no line is stale."""
        assert not port_lint.gating, "unallowlisted findings:\n" + \
            "\n".join(f.render() for f in port_lint.gating)
        assert not port_lint.stale, \
            f"stale allowlist entries (remove them): {port_lint.stale}"

    def test_allowlist_is_the_ports_own(self, port_lint):
        """The port's ledger is LINT_ALLOWLIST_TORCH.txt (never the JAX
        package's), and it names only the port's files."""
        assert os.path.basename(default_allowlist_path()) == \
            "LINT_ALLOWLIST_TORCH.txt"
        assert os.path.basename(default_package_root()) == \
            "nomad_tpu_torch"
        for key in port_lint.allowlist:
            assert key.split(":")[1].startswith("nomad_tpu_torch/"), key

    def test_every_allowlist_entry_is_justified(self, port_lint):
        for key, why in port_lint.allowlist.items():
            assert len(why) > 10, f"throwaway justification for {key}"

    def test_unjustified_entry_rejected(self, tmp_path):
        p = tmp_path / "allow.txt"
        p.write_text("bare-write:a.py:C.x\n")
        with pytest.raises(ValueError, match="justification"):
            load_allowlist(str(p))

    def test_stale_allowlist_entry_gates(self):
        findings = [Finding("bare-write", "a.py", "C.x", "m")]
        gating, allowed, stale = partition_findings(
            findings, {"bare-write:a.py:C.x": "ok",
                       "bare-write:gone.py:D.y": "fixed long ago"})
        assert not gating and len(allowed) == 1
        assert stale == ["bare-write:gone.py:D.y"]

    def test_whole_program_pass_fits_cpu_budget(self, port_lint):
        """The pass runs on every tier-1 invocation; its CPU time (not
        the wall clock, which a busy machine stretches) stays well
        under 30 s."""
        assert port_lint.cpu_s < 30.0, \
            f"the port's whole-program lint took {port_lint.cpu_s:.1f} " \
            "s of CPU"

    def test_coverage_blocks_are_reported(self, port_lint):
        """The call graph's blind spots and the device-, consensus- and
        failure-plane coverage ride the pass's coverage (``lint
        -json``): the device plane sees the kernel wrappers, every
        fault boundary is covered or waived."""
        cov = port_lint.coverage
        assert cov["functions"] > 0 and cov["dynamic"] > 0
        assert 0 < cov["resolved_fraction"] <= 1.0
        assert cov["devlint"]["kernels"] >= 20
        assert cov["devlint"]["kernel_call_sites"] > 0
        assert cov["consensuslint"]["endpoint_contract"]
        assert cov["faultlint"]["covered_fraction"] == 1.0

    def test_no_markers_without_justification(self):
        """Every waiver marker in the port carries its reason (a bare
        marker waives nothing, so it would only mislead a reader)."""
        import re

        bare = re.compile(r"#\s*(devlint|torchlint|consensus|faultlint)"
                          r"-ok\([a-z-]+\)\s*:?\s*$")
        hits = []
        root = default_package_root()
        for base, _dirs, files in os.walk(root):
            for name in files:
                if name.endswith(".py"):
                    path = os.path.join(base, name)
                    with open(path) as fh:
                        for i, line in enumerate(fh, 1):
                            if bare.search(line):
                                hits.append(f"{path}:{i}")
        assert not hits, hits


# Planes of the port and the functions each must put in the graph;
# each must be gate-clean with no allowlist entry of its own.
PLANES = {
    "mesh": (("parallel/mesh",), (
        "nomad_tpu_torch.parallel.mesh:dispatch_mesh",
        "nomad_tpu_torch.parallel.mesh:_walk",
        "nomad_tpu_torch.parallel.mesh:_put",
        "nomad_tpu_torch.parallel.mesh:window_verify_sharded")),
    "raft_net": (("server/raft_net", "server/raft.py"), (
        "nomad_tpu_torch.server.raft_net:NetRaft.apply",
        "nomad_tpu_torch.server.raft_net:_PeerReplicator.run")),
    "control": (("control/",), (
        "nomad_tpu_torch.control.controller:Controller.tick",)),
    "serving": (("server/mux", "agent/swarm", "agent/http_server",
                 "state/store"), (
        "nomad_tpu_torch.server.mux:EdgeLoop._run",
        "nomad_tpu_torch.server.mux:DispatchPool.submit",
        "nomad_tpu_torch.server.rpc:RPCServer._execute",
        "nomad_tpu_torch.server.rpc:MuxConn.call_async",
        "nomad_tpu_torch.state.store:StateWatch.notify",
        "nomad_tpu_torch.agent.swarm:AgentSwarm._issue_poll",
        "nomad_tpu_torch.agent.http_server:HTTPServer._serve_one")),
    "group_commit": (("ops/plan_conflict", "server/fsm"), (
        "nomad_tpu_torch.ops.plan_conflict:evaluate_window",
        "nomad_tpu_torch.server.fsm:NomadFSM._apply_plan_batch")),
    "overload": (("server/overload", "server/ttlwheel",
                  "server/heartbeat"), (
        "nomad_tpu_torch.server.overload:OverloadController.admit",
        "nomad_tpu_torch.server.ttlwheel:TTLWheel.arm",
        "nomad_tpu_torch.server.heartbeat:"
        "HeartbeatManager._on_ttl_expire")),
    "device": (("models/fleet", "parallel/devices", "ops/binpack"), (
        "nomad_tpu_torch.models.fleet:UsageMirror.sync",
        "nomad_tpu_torch.parallel.devices:put_counted",
        "nomad_tpu_torch.ops.binpack:shard_walk")),
    "pipeline": (("scheduler/pipeline", "scheduler/breaker"), (
        "nomad_tpu_torch.scheduler.pipeline:PipelinedEvalRunner.process",)),
    "crash": (("faultinject/",), (
        "nomad_tpu_torch.faultinject.crash:CrashHarness.kill",)),
    "obs": (("obs/",), ("nomad_tpu_torch.obs.trace:Tracer.span",)),
}


@pytest.mark.parametrize("plane", sorted(PLANES))
def test_plane_rides_the_gates(plane, port_lint):
    """Each plane of the port is in every gate's scan set (its
    functions in the interprocedural graph), lint-clean, and needs no
    allowlist entry of its own."""
    paths, quals = PLANES[plane]
    for qual in quals:
        assert qual in port_lint.graph.functions, \
            f"{qual} missing from the interprocedural graph"
    touching = [f for f in port_lint.gating
                if any(p in f.path for p in paths)]
    assert touching == [], f"{plane} must lint clean:\n" + \
        "\n".join(f.render() for f in touching)
    assert not any(p in key for key in port_lint.allowlist
                   for p in paths), \
        f"{plane} must not need allowlist entries"


def test_sarif_log_shape(port_lint):
    from nomad_tpu_torch.cli.main import _sarif_log

    log = _sarif_log(port_lint.gating,
                     [f for f in port_lint.findings
                      if f.severity != "error"], port_lint.coverage)
    assert log["version"] == "2.1.0"
    run = log["runs"][0]
    assert run["tool"]["driver"]["name"] == "nomad-tpu-torch-lint"
    assert run["properties"]["coverage"] is port_lint.coverage
    assert all(r["level"] == "note" for r in run["results"])


# ---------------------------------------------------------------------------
# 2. the JAX suite's synthetic packages through both packages' passes
# ---------------------------------------------------------------------------

CASES = cases.harvest("test_static_analysis.py")


@pytest.mark.parametrize("files", [c[1] for c in CASES],
                         ids=[c[0].split("::")[1] for c in CASES])
def test_jax_suite_package_reads_alike(files, tmp_path):
    cases.assert_reads_alike(tmp_path, files)


# ---------------------------------------------------------------------------
# 3. torchlint: each rule fires, each sanctioned twin stays silent
# ---------------------------------------------------------------------------

def lint_wrapper(tmp_path, body: str) -> list:
    """torchlint over a package whose one module defines a kernel
    wrapper (it routes with ``kernels.route``) with ``body``."""
    pkg = tmp_path / "tl"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "ops" / "kernels.py").write_text(textwrap.dedent("""
        def route(tensors):
            return next(iter(tensors.values())).device

        def library(name):
            return None
        """))
    (pkg / "ops" / "wrap.py").write_text(textwrap.dedent("""
        import numpy as np
        import torch

        from tl.ops import kernels
        """) + textwrap.dedent(body))
    return torchlint.analyze_package(str(pkg))


TORCHLINT_CASES = {
    # rule fires
    "float-of-tensor": ("""
        def launch(x, y):
            device = kernels.route(dict(x=x))
            return float(y)
        """, ["concretize"]),
    "item": ("""
        def launch(x):
            device = kernels.route(dict(x=x))
            return x.sum().item()
        """, ["concretize"]),
    "tolist-cpu-numpy": ("""
        def launch(x):
            device = kernels.route(dict(x=x))
            a = x.tolist()
            b = x.cpu()
            return a, b, x.numpy()
        """, ["concretize"] * 3),
    "np-asarray": ("""
        def launch(x):
            device = kernels.route(dict(x=x))
            return np.asarray(x)
        """, ["concretize"]),
    "if-on-tensor": ("""
        def launch(x):
            device = kernels.route(dict(x=x))
            if x.max() > 0:
                return x
            return -x
        """, ["tensor-branch"]),
    "while-on-tensor": ("""
        def launch(x):
            device = kernels.route(dict(x=x))
            while x.any():
                x = x - 1
            return x
        """, ["tensor-branch"]),
    "torch-made-tensor": ("""
        def launch(x, n: int):
            device = kernels.route(dict(x=x))
            out = torch.empty(n, device=device)
            return int(out[0])
        """, ["concretize"]),
    "callee-walked-with-taint": ("""
        def _helper(t, k):
            if t.sum() > k:
                return t
            return k

        def launch(x):
            device = kernels.route(dict(x=x))
            return _helper(x, 3)
        """, ["tensor-branch"]),
    "another-wrappers-result": ("""
        def inner(x):
            lib = kernels.library("k")
            return x

        def launch(x, n: int):
            device = kernels.route(dict(x=x))
            y = inner(torch.zeros(n))
            return y.item()
        """, ["concretize"]),
    # sanctioned twins stay silent
    "static-metadata": ("""
        def launch(x, y):
            device = kernels.route(dict(x=x))
            n = x.shape[0]
            if n & (n - 1) or len(y) > 4 or x.dtype != y.dtype:
                raise ValueError("shape")
            if x.numel() and x.is_contiguous() and x.data_ptr():
                return int(x.size(0)) + x.dim()
            return device.index
        """, []),
    "cpu-branch-is-host-code": ("""
        def launch(x):
            device = kernels.route(dict(x=x))
            if device.type == "cpu":
                return float(x.sum()), x.tolist()
            return x
        """, []),
    "not-cpu-else-is-host-code": ("""
        def launch(x):
            device = kernels.route(dict(x=x))
            if device.type != "cpu":
                return x
            else:
                return x.item()
        """, []),
    "host-params": ("""
        def launch(x, penalty: float, k_cap: int = 4, *, rounds):
            device = kernels.route(dict(x=x))
            if k_cap > rounds:
                return float(penalty)
            return x
        """, []),
    "identity-tests": ("""
        def launch(x, scratch):
            device = kernels.route(dict(x=x))
            if scratch is None:
                return x
            return scratch
        """, []),
    "marker-waives": ("""
        def launch(x):
            device = kernels.route(dict(x=x))
            # torchlint-ok(concretize): the one count the launch needs,
            # read once per window by design.
            return int(x.sum())
        """, []),
    "bare-marker-waives-nothing": ("""
        def launch(x):
            device = kernels.route(dict(x=x))
            return int(x.sum())  # torchlint-ok(concretize)
        """, ["concretize"]),
    "not-a-wrapper": ("""
        def host_helper(x):
            return float(x.sum()), x.tolist()
        """, []),
}


@pytest.mark.parametrize("name", sorted(TORCHLINT_CASES))
def test_torchlint_rule(name, tmp_path):
    body, want = TORCHLINT_CASES[name]
    got = sorted(f.rule for f in lint_wrapper(tmp_path, body))
    assert got == sorted(want), got


def test_torchlint_finds_the_ports_wrappers(port_lint):
    """The wrappers live where the port launches: the K2-K4 and K7
    wrappers of ops/binpack.py, K5's models/fleet.scatter_rows and
    K6 / K7d's parallel/mesh.py."""
    wrappers = torchlint.find_wrappers(port_lint.graph)
    for key in ("nomad_tpu_torch.ops.binpack:place_sequence",
                "nomad_tpu_torch.ops.binpack:place_rounds",
                "nomad_tpu_torch.ops.binpack:place_rounds_batch",
                "nomad_tpu_torch.ops.binpack:place_sequence_batch",
                "nomad_tpu_torch.ops.binpack:shard_walk",
                "nomad_tpu_torch.ops.binpack:shard_step",
                "nomad_tpu_torch.ops.binpack:merge_select",
                "nomad_tpu_torch.models.fleet:scatter_rows",
                "nomad_tpu_torch.parallel.mesh:window_verify",
                "nomad_tpu_torch.parallel.mesh:shard_gather",
                "nomad_tpu_torch.parallel.mesh:window_verify_shards"):
        assert key in wrappers, key


def test_left_out_rules_are_named():
    """jaxlint's impure-call / attr-mutation / global-mutation and
    jaxlint/devlint's recompile-churn (and the RecompileSentinel) are
    left out by name, each with its reason, in the docstrings."""
    from nomad_tpu_torch import analysis
    from nomad_tpu_torch.analysis import devlint, sanitizers

    for mod, names in ((torchlint, ("impure-call", "attr-mutation",
                                    "global-mutation")),
                       (devlint, ("recompile-churn",)),
                       (sanitizers, ("RecompileSentinel",)),
                       (analysis, ("impure-call", "recompile-churn",
                                   "RecompileSentinel"))):
        doc = mod.__doc__
        for name in names:
            assert name in doc and "left out" in doc, (mod, name)


def test_ast_passes_import_no_torch():
    """The AST passes need no torch: only the sanitizers import it."""
    root = os.path.join(default_package_root(), "analysis")
    for name in sorted(os.listdir(root)):
        if not name.endswith(".py") or name == "sanitizers.py":
            continue
        with open(os.path.join(root, name)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert not any(m.split(".")[0] in ("torch", "jax", "nomad_tpu")
                           for m in mods), (name, mods)
