"""The synthetic packages of the JAX package's analyzer suites, for the
port's analyzer tests.

Each JAX suite (``tests/test_static_analysis.py``,
``test_interprocedural_lint.py``, ``test_devlint.py``,
``test_consensuslint.py``, ``test_faultlint.py``) writes small source
packages into ``tmp_path`` and runs its analyzer over them.  ``harvest``
reads those sources out of a suite's AST (the ``write_pkg`` /
``write_files`` / ``lint`` helpers and ``(path / "x.py").write_text``
with literal paths and sources), so the port's tests run every one of
them through both packages' analyzers without a copy that could drift.
``shared_findings`` runs the five passes the two packages share
(lockcheck, callgraph, blocking, consensuslint, faultlint) from either
package over one tree.
"""
from __future__ import annotations

import ast
import os
import textwrap

TESTS = os.path.dirname(os.path.abspath(__file__))

# The JAX suites whose synthetic packages the port's analyzers must read
# alike.
JAX_SUITES = ("test_static_analysis.py", "test_interprocedural_lint.py",
              "test_devlint.py", "test_consensuslint.py",
              "test_faultlint.py")


def _literal(node, consts: dict):
    """A str literal, ``textwrap.dedent(<literal>)``, or a name bound to
    one earlier in the test; else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.Call) and node.args and \
            ast.unparse(node.func).endswith("dedent"):
        return _literal(node.args[0], consts)
    return None


def _path_parts(node, dirs: dict) -> list | None:
    """``tmp_path / "pkg" / "a.py"`` -> ["pkg", "a.py"], through names
    bound to such paths (``dirs``); None when any part is not a
    literal or the base is not ``tmp_path``."""
    parts = []
    while isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        if not (isinstance(node.right, ast.Constant) and
                isinstance(node.right.value, str)):
            return None
        parts.append(node.right.value)
        node = node.left
    if not isinstance(node, ast.Name):
        return None
    if node.id == "tmp_path":
        base = []
    elif node.id in dirs:
        base = dirs[node.id]
    else:
        return None
    return base + list(reversed(parts))


def _writes(fn: ast.FunctionDef) -> list:
    """(path under tmp_path, source) of every literal write in a test,
    in order."""
    consts: dict = {}
    dirs: dict = {}     # name -> path parts of `d = tmp_path / "pkg"`
    out: list = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            lit = _literal(node.value, consts)
            if lit is not None:
                consts[name] = lit
            parts = _path_parts(node.value, dirs)
            if parts is not None:
                dirs[name] = parts
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        fname = func.id if isinstance(func, ast.Name) else None
        if fname == "write_pkg" and len(node.args) >= 3:
            name = _literal(node.args[1], consts)
            src = _literal(node.args[2], consts)
            if name is not None and src is not None:
                out.append((node.lineno, f"{name}/mod.py", src))
        elif fname == "lint" and len(node.args) >= 2:
            src = _literal(node.args[1], consts)
            name = "pkg"
            for kw in node.keywords:
                if kw.arg == "name":
                    name = _literal(kw.value, consts)
            if len(node.args) >= 3:
                name = _literal(node.args[2], consts)
            if src is not None and name is not None:
                out.append((node.lineno, f"{name}/mod.py", src))
        elif fname == "write_files" and len(node.args) >= 2 and \
                isinstance(node.args[1], ast.Dict):
            for k, v in zip(node.args[1].keys, node.args[1].values):
                key = _literal(k, consts) if k is not None else None
                src = _literal(v, consts)
                if key is not None and src is not None:
                    out.append((node.lineno, f"pkg/{key}", src))
        elif isinstance(func, ast.Attribute) and \
                func.attr == "write_text" and node.args:
            parts = _path_parts(func.value, dirs)
            src = _literal(node.args[0], consts)
            if parts and len(parts) >= 2 and src is not None and \
                    parts[-1].endswith(".py"):
                out.append((node.lineno, "/".join(parts), src))
    out.sort(key=lambda w: w[0])
    return [(path, src) for _line, path, src in out]


def harvest(suite: str) -> list:
    """[(case id, {package: {relpath: source}})] — one case per test of
    ``suite`` that writes a synthetic package; the last write of each
    path wins (a test that rewrites a file lints its final form)."""
    path = os.path.join(TESTS, suite)
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    cases = []

    def visit(body, prefix):
        for node in body:
            if isinstance(node, ast.ClassDef):
                visit(node.body, f"{prefix}{node.name}.")
            elif isinstance(node, ast.FunctionDef) and \
                    node.name.startswith("test"):
                files: dict = {}
                for rel, src in _writes(node):
                    pkg, _, rest = rel.partition("/")
                    files.setdefault(pkg, {})[rest] = \
                        textwrap.dedent(src)
                if files:
                    cases.append((f"{suite[:-3]}::{prefix}{node.name}",
                                  files))
    visit(tree.body, "")
    return cases


def all_cases() -> list:
    return [case for suite in JAX_SUITES for case in harvest(suite)]


def write_case(tmp_path, files: dict) -> list:
    """Write one case's packages under ``tmp_path``; returns their
    directories."""
    dirs = []
    for pkg, members in sorted(files.items()):
        root = tmp_path / pkg
        for rel, src in members.items():
            target = root / rel
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_text(src)
        dirs.append(str(root))
    return dirs


def shared_passes(package: str):
    """The five shared passes of ``package`` ("jax": nomad_tpu.analysis,
    "torch": nomad_tpu_torch.analysis) as a tuple of modules
    (lockcheck, callgraph, blocking, consensuslint, faultlint)."""
    import importlib

    base = "nomad_tpu.analysis" if package == "jax" else \
        "nomad_tpu_torch.analysis"
    return tuple(importlib.import_module(f"{base}.{m}") for m in (
        "lockcheck", "callgraph", "blocking", "consensuslint",
        "faultlint"))


def shared_findings(package: str, tree: str, scan=None,
                    coverage_out: dict | None = None) -> list:
    """Every finding of the five shared passes of ``package`` over the
    package directory ``tree`` (strict lockcheck), and in
    ``coverage_out`` the call graph's coverage and the consensus- and
    failure-plane coverage blocks."""
    lockcheck, callgraph, blocking, consensuslint, faultlint = \
        shared_passes(package)
    scan = scan or lockcheck.scan_package(tree)
    _pkg, trees, err = scan
    graph = callgraph.CallGraph.build(
        tree, parsed=trees if err is None else None)
    findings = list(lockcheck.analyze_package(tree, strict=True, scan=scan))
    findings += blocking.analyze_package(tree, graph=graph, scan=scan)
    cons: dict = {}
    findings += consensuslint.analyze_package(tree, graph=graph, scan=scan,
                                              coverage_out=cons)
    fault: dict = {}
    findings += faultlint.analyze_package(tree, graph=graph, scan=scan,
                                          coverage_out=fault)
    if coverage_out is not None:
        coverage_out.update(graph.coverage())
        coverage_out["consensuslint"] = cons
        coverage_out["faultlint"] = fault
    return findings


def keyed(findings) -> list:
    """Sorted (key, severity, line) of findings: what both packages'
    passes must agree on."""
    return sorted((f.key, f.severity, f.line) for f in findings)


def is_torch_round_trip(finding) -> bool:
    """A blocking-under-lock the port reports for one of its own device
    round trips (``_DEVICE_METHODS`` / ``_TENSOR_SYNC_METHODS`` of
    nomad_tpu_torch/analysis/blocking.py)."""
    from nomad_tpu_torch.analysis import blocking

    labels = set(blocking._TENSOR_SYNC_METHODS.values()) | {
        blocking._DEVICE_METHODS["fetch_host"],
        blocking._DEVICE_METHODS["synchronize"]}
    return finding.rule == "blocking-under-lock" and \
        any(label in finding.message for label in labels)


def assert_reads_alike(tmp_path, files: dict) -> None:
    """Every package of one case gives the same (key, severity, line)
    from the JAX package's five shared passes and the port's, the same
    call-graph coverage and the same consensus- and failure-plane
    coverage; the port may add only its own device round trips."""
    for tree in write_case(tmp_path, files):
        jax_cov: dict = {}
        torch_cov: dict = {}
        jax = shared_findings("jax", tree, coverage_out=jax_cov)
        port = shared_findings("torch", tree, coverage_out=torch_cov)
        jax_keys = {f.key for f in jax}
        port = [f for f in port
                if f.key in jax_keys or not is_torch_round_trip(f)]
        assert keyed(port) == keyed(jax), (tree, keyed(port), keyed(jax))
        assert torch_cov == jax_cov, tree
