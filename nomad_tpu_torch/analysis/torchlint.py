"""Kernel-wrapper sync lint: keep the launch path free of hidden syncs.

Counterpart of ``nomad_tpu/analysis/jaxlint.py``.  The JAX pass walks
every ``jax.jit`` body, where a concretization aborts tracing; the
port's kernels are hand-written CUDA behind eager Python wrappers, and
there the same shapes cost a device synchronization on every launch.
Every kernel wrapper — a function that reaches ``kernels.library(...)``
or ``kernels.check(...)``, or routes its tensors with ``kernels.route``
(``ops/binpack.py``, ``models/fleet.py`` ``scatter_rows``,
``parallel/mesh.py``) — is walked
together with the in-package functions it calls:

  - ``concretize``: ``float()`` / ``int()`` / ``bool()`` / ``.item()`` /
    ``.tolist()`` / ``np.asarray()`` / ``.cpu()`` / ``.numpy()`` on a
    value derived from a tensor: on the card each waits for the
    stream, once per launch;
  - ``tensor-branch`` (for ``traced-branch``): a Python ``if`` /
    ``while`` on such a value, which costs the same wait.

The taint model follows jaxlint's: a wrapper's tensor parameters are
tainted, and so is anything built from a tainted value, a ``torch.*``
constructor or another wrapper's result.  Static, as in jaxlint:
``.shape`` / ``.dtype`` / ``.device`` / ``.ndim`` / ``len()``, and the
metadata calls ``size()`` / ``dim()`` / ``numel()`` / ``data_ptr()`` /
``stride()`` / ``is_contiguous()``; an identity test (``is`` /
``is not``) reads no value.  A parameter is host (not tainted) when it
is keyword-only, has a constant default, or carries an annotation that
is not a tensor: the port spells its launch scalars that way.  Callees
are walked with the taint of the arguments each call passes.

The CPU branch is host code and is not linted: the body of ``if
<device>.type == "cpu":`` (the plain version a wrapper runs after
``kernels.route`` returns ``cpu``), and the ``else`` of ``!= "cpu"``.

``impure-call``, ``attr-mutation`` and ``global-mutation`` are left out
by name: under ``jit`` their effects happen once at trace time and then
freeze into the compiled kernel; an eager wrapper runs them on every
call, so the rules describe nothing here.

Deliberate syncs carry ``# torchlint-ok(<rule>): <why>`` on (or in the
comment block just above) the site, devlint's marker grammar; a marker
with no justification does not waive.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Optional

from . import Finding

CONCRETIZE_FUNCS = {"float", "int", "bool", "complex"}
CONCRETIZE_METHODS = {"item", "tolist", "cpu", "numpy", "__bool__",
                      "__float__"}
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "type", "index"}
# Tensor methods that read metadata only.
STATIC_METHODS = {"size", "dim", "numel", "nelement", "data_ptr",
                  "stride", "is_contiguous", "element_size", "get_device",
                  "is_pinned"}
# Calls whose result is host metadata whatever their arguments.
HOST_CALLS = {"len", "isinstance", "route", "stream_handle", "library",
              "check_args", "check", "device", "current_device",
              "device_count", "id", "type", "getattr", "hasattr"}
MAX_CALLEE_DEPTH = 3
# ``ops/kernels.py`` calls that make a function a kernel wrapper: it
# loads or checks a launch, or routes its tensors between the plain
# version and the kernel.
KERNEL_CALLS = ("library", "check", "route", "check_args")

_MARKER_TEMPLATE = r"#\s*{tag}-ok\((?P<rule>[a-z-]+)\)\s*:\s*\S"
MARKER_RE = re.compile(_MARKER_TEMPLATE.format(tag="torchlint"))


def _dotted(node: ast.expr) -> Optional[tuple]:
    """a.b.c -> ("a","b","c") for Name/Attribute chains."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


# -- markers (shared with devlint) -------------------------------------------

def load_markers(package_dir: str, rels, marker_re) -> dict:
    """(rel, line) -> {rule, ...} for every justified marker matching
    ``marker_re``.  An inline marker waives its own line; a comment-line
    marker waives the comment block below it and the first code line
    the block lands on (a blank line ends the block unattached)."""
    base = os.path.dirname(os.path.abspath(package_dir))
    out: dict = {}
    for rel in rels:
        path = os.path.join(base, rel)
        try:
            with open(path) as fh:
                lines = fh.read().splitlines()
        except OSError:
            continue
        for i, text in enumerate(lines, 1):
            for m in marker_re.finditer(text):
                rule = m.group("rule")
                out.setdefault((rel, i), set()).add(rule)
                if not text.lstrip().startswith("#"):
                    continue
                j = i + 1
                while j <= len(lines) and \
                        lines[j - 1].lstrip().startswith("#"):
                    out.setdefault((rel, j), set()).add(rule)
                    j += 1
                if j <= len(lines) and lines[j - 1].strip():
                    out.setdefault((rel, j), set()).add(rule)
    return out


def waived(markers: dict, rel: str, line: int, rule: str) -> bool:
    # Exact-line only: load_markers already carried each comment-block
    # marker down onto the first code line below it.
    return rule in markers.get((rel, line), ())


# -- wrapper discovery -------------------------------------------------------

def _is_kernel_call(node: ast.Call) -> bool:
    d = _dotted(node.func)
    return bool(d) and len(d) >= 2 and d[-2] == "kernels" and \
        d[-1] in KERNEL_CALLS


def _own_nodes(fn_node):
    """Every node of ``fn_node``'s body, nested defs excluded."""
    stack = list(fn_node.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                stack.append(child)


def find_wrappers(graph) -> dict:
    """FuncNode key -> FuncNode for every kernel wrapper: a function
    whose own body calls ``kernels.library`` / ``kernels.check`` (it
    launches) or ``kernels.route`` / ``kernels.check_args`` (it routes
    its tensors to the plain version or the kernel)."""
    out: dict = {}
    for key, fn in graph.functions.items():
        for node in _own_nodes(fn.node):
            if isinstance(node, ast.Call) and _is_kernel_call(node):
                out[key] = fn
                break
    return out


def host_params(fn_node) -> set:
    """Parameters the taint model treats as host values: keyword-only,
    a constant default, or a non-tensor annotation (and self/cls)."""
    args = fn_node.args
    host = {a.arg for a in args.kwonlyargs}
    positional = args.posonlyargs + args.args
    defaults = args.defaults
    for a, d in zip(positional[len(positional) - len(defaults):],
                    defaults):
        if isinstance(d, ast.Constant):
            host.add(a.arg)
    for a in positional:
        if a.annotation is not None and \
                "Tensor" not in ast.unparse(a.annotation):
            host.add(a.arg)
        if a.arg in ("self", "cls"):
            host.add(a.arg)
    return host


def _param_names(fn_node) -> list:
    args = fn_node.args
    return [a.arg for a in args.posonlyargs + args.args]


# -- the walk ----------------------------------------------------------------

def _cpu_branch(test: ast.expr) -> Optional[bool]:
    """True when ``test`` selects the CPU in its body (``x.type ==
    "cpu"``, ``x.type != "cuda"``), False when in its ``else``
    (``x.type != "cpu"``, ``x.type == "cuda"``), None otherwise."""
    if not isinstance(test, ast.Compare) or len(test.ops) != 1:
        return None
    left, op, right = test.left, test.ops[0], test.comparators[0]
    if not (isinstance(left, ast.Attribute) and left.attr == "type" and
            isinstance(right, ast.Constant) and
            right.value in ("cpu", "cuda")):
        return None
    eq = isinstance(op, ast.Eq)
    if not eq and not isinstance(op, ast.NotEq):
        return None
    return eq == (right.value == "cpu")


class _Walk(ast.NodeVisitor):
    """One function body, forward taint pass (run twice for loops)."""

    def __init__(self, lint: "_Lint", fn, tainted: set, chain: str,
                 depth: int) -> None:
        self.lint = lint
        self.fn = fn
        self.info = lint.graph.modules.get(fn.module)
        self.tainted = set(tainted)
        self.chain = chain
        self.depth = depth

    def is_tainted(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            return self._call_tainted(node)
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return self.is_tainted(node.left) or \
                any(self.is_tainted(c) for c in node.comparators)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tainted(el) for el in node.elts)
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or \
                self.is_tainted(node.orelse)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        return False

    def _call_tainted(self, node: ast.Call) -> bool:
        fn = node.func
        d = _dotted(fn)
        if isinstance(fn, ast.Attribute):
            if fn.attr in STATIC_METHODS or fn.attr in CONCRETIZE_METHODS:
                return False
            if fn.attr in HOST_CALLS:
                return False
            if self.is_tainted(fn.value):
                return True
        if d is not None:
            if d[-1] in HOST_CALLS or d[-1] in CONCRETIZE_FUNCS:
                return False
            if d[0] == "torch":
                # a new tensor, even from host inputs (torch.cuda.*
                # calls return devices, streams and counts)
                return not (len(d) > 2 and d[1] == "cuda")
            if d[0] in ("min", "max", "abs", "sum", "sorted"):
                return any(self.is_tainted(a) for a in node.args)
        # Another wrapper's result is device data.
        callee = self._resolve(fn)
        return callee is not None and callee in self.lint.wrappers

    def _resolve(self, fn_expr) -> Optional[str]:
        if self.info is None:
            return None
        cls_key = f"{self.fn.module}.{self.fn.cls}" if self.fn.cls else None
        callee, kind = self.lint.graph.resolve_call(
            self.info, cls_key, {}, fn_expr)
        return callee if kind == "intra" else None

    def _report(self, rule: str, line: int, msg: str) -> None:
        self.lint.report(rule, self.fn.rel, self.chain, line, msg)

    # -- statements --------------------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        tainted = self.is_tainted(node.value)
        for tgt in node.targets:
            self._bind(tgt, tainted)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            self._bind(node.target, self.is_tainted(node.value))

    def _bind(self, tgt, tainted: bool) -> None:
        if isinstance(tgt, ast.Name):
            if tainted:
                self.tainted.add(tgt.id)
            else:
                self.tainted.discard(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._bind(el, tainted)
        elif isinstance(tgt, ast.Starred):
            self._bind(tgt.value, tainted)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)
        if isinstance(node.target, ast.Name) and \
                self.is_tainted(node.value):
            self.tainted.add(node.target.id)

    def visit_If(self, node: ast.If) -> None:
        self.visit(node.test)
        cpu = _cpu_branch(node.test)
        if cpu is None and self.is_tainted(node.test):
            self._report(
                "tensor-branch", node.lineno,
                f"Python `if {ast.unparse(node.test)}` on a tensor value "
                "waits for the device on every launch")
        if cpu is not True:
            for stmt in node.body:
                self.visit(stmt)
        if cpu is not False:
            for stmt in node.orelse:
                self.visit(stmt)

    def visit_While(self, node: ast.While) -> None:
        self.visit(node.test)
        if self.is_tainted(node.test):
            self._report(
                "tensor-branch", node.lineno,
                f"Python `while {ast.unparse(node.test)}` on a tensor "
                "value waits for the device on every iteration")
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.iter)
        self._bind(node.target, self.is_tainted(node.iter))
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        line = node.lineno
        args_tainted = any(self.is_tainted(a) for a in node.args)
        if d is not None and len(d) == 1 and d[0] in CONCRETIZE_FUNCS \
                and args_tainted:
            self._report("concretize", line,
                         f"`{d[0]}()` of a tensor value waits for the "
                         "device")
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in CONCRETIZE_METHODS and \
                self.is_tainted(node.func.value):
            self._report("concretize", line,
                         f"`.{node.func.attr}()` on a tensor value copies "
                         "it to the host and waits for the device")
        elif d is not None and d[0] in ("np", "numpy") and \
                d[-1] in ("asarray", "array") and args_tainted:
            self._report("concretize", line,
                         f"`{'.'.join(d)}` of a tensor value copies it to "
                         "the host and waits for the device")
        else:
            callee = self._resolve(node.func)
            if callee is not None and self.depth < MAX_CALLEE_DEPTH:
                self.lint.walk_callee(self, callee, node)
        self.generic_visit(node)

    # nested defs and lambdas run elsewhere (another thread, a callback)
    def visit_FunctionDef(self, node) -> None:
        return None

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def run(self) -> None:
        for _ in range(2):
            for stmt in self.fn.node.body:
                self.visit(stmt)


class _Lint:
    def __init__(self, graph, wrappers: dict, markers: dict) -> None:
        self.graph = graph
        self.wrappers = wrappers
        self.markers = markers
        self.findings: list = []
        self.reported: set = set()
        self.waived: set = set()
        self._seen: set = set()

    def report(self, rule, rel, where, line, msg) -> None:
        if waived(self.markers, rel, line, rule):
            self.waived.add((rel, line, rule))
            return
        key = (rule, rel, line)
        if key in self.reported:
            return
        self.reported.add(key)
        self.findings.append(Finding(rule, rel, where, msg, line))

    def walk_root(self, fn) -> None:
        params = set(_param_names(fn.node)) | \
            {a.arg for a in fn.node.args.kwonlyargs}
        tainted = params - host_params(fn.node)
        self._walk(fn, tainted, fn.qual, 0)

    def walk_callee(self, caller: _Walk, callee_key: str,
                    call: ast.Call) -> None:
        fn = self.graph.functions.get(callee_key)
        if fn is None:
            return
        names = _param_names(fn.node)
        if names and names[0] in ("self", "cls") and fn.cls:
            names = names[1:]
        tainted = set()
        for name, arg in zip(names, call.args):
            if caller.is_tainted(arg):
                tainted.add(name)
        for kw in call.keywords:
            if kw.arg is not None and caller.is_tainted(kw.value):
                tainted.add(kw.arg)
        self._walk(fn, tainted, f"{caller.chain} -> {fn.qual}",
                   caller.depth + 1)

    def _walk(self, fn, tainted: set, chain: str, depth: int) -> None:
        key = (fn.key, frozenset(tainted))
        if key in self._seen:
            return
        self._seen.add(key)
        _Walk(self, fn, tainted, chain, depth).run()


def analyze_package(package_dir: str, graph=None,
                    coverage_out: Optional[dict] = None) -> list:
    from .callgraph import CallGraph

    if graph is None:
        graph = CallGraph.build(package_dir)
    wrappers = find_wrappers(graph)
    markers = load_markers(package_dir,
                           {fn.rel for fn in graph.functions.values()},
                           MARKER_RE)
    lint = _Lint(graph, wrappers, markers)
    for key in sorted(wrappers):
        lint.walk_root(wrappers[key])
    if coverage_out is not None:
        coverage_out.update(wrappers=len(wrappers),
                            walked=len(lint._seen),
                            waived=len(lint.waived))
    return lint.findings
