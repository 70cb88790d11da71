"""Device-plane lint: placement propagation and transfer discipline.

Counterpart of ``nomad_tpu/analysis/devlint.py``.  The port's failure
modes on the card are *placement* failures no behavioral test sees: a
dispatch that bypasses the one mesh authority, a host operand flowing
into a sharded wrapper (an upload on every dispatch), a raw device move
the transfer odometer never counts, or a transfer made while a lock is
held.  Two passes ride the interprocedural call graph:

**Placement propagation** — the kernels are the port's kernel wrappers
(``torchlint.find_wrappers``: a function that reaches
``kernels.library`` / ``kernels.check`` or routes with
``kernels.route``) and the module-level ``*_sharded`` family of
``parallel/mesh.py``, named as in the JAX pass.  At each resolved
kernel call site every operand is judged *placed* (derived from a
placement seam — ``devices.put_counted`` / ``ensure_on_default`` /
``PinnedStaging.upload`` / ``mesh._put`` / ``mesh.gather`` /
``shard_fleet_arrays`` / ``ShardedResidency`` / ``_scatter_rows`` /
the ``_dev_const`` holders and the fleet's device getters — or another
kernel's output) or *host*.  A wrapper's host parameters
(``torchlint.host_params``: keyword-only, constant default, scalar
annotation) are launch scalars, not operands.  Rules:

  - ``mesh-bypass``: an UNSHARDED kernel dispatched from a function
    that never consulted ``dispatch_mesh`` (kernel bodies and the
    kernel's own defining module are exempt: a wrapper calling a
    wrapper is launch plumbing, not a dispatch).
  - ``sharding-mix``: a host operand flowing into a SHARDED wrapper —
    it is cut and uploaded on every call instead of riding the
    resident shards.
  - ``resident-bypass``: a raw ``.to(<device>)`` / ``.cuda()`` /
    ``torch.as_tensor(..., device=)`` / ``torch.tensor(..., device=)``
    outside ``parallel/devices.py`` and the seams above — a device
    move the transfer odometer and the residency policy never see.

**Transfer discipline** — classifies transfer sites: explicit
placements (the seams above and raw moves), device->host
concretizations (``fetch_host`` / ``copy_to_host_async``, and
``np.asarray`` / ``float()`` / ``int()`` / ``bool()`` / ``.item()`` /
``.tolist()`` / ``.cpu()`` / ``.numpy()`` on device-tainted values),
and host operands flowing into kernels.  Two rules intersect them
with context:

  - ``transfer-under-lock``: a transfer site (or a call chain reaching
    one) inside a held-lock region — every other thread queues behind
    the copy (blocking.py's lock machinery, same ``Qual[Lock.site]``
    key grammar).
  - ``transfer-in-hot-loop``: an IMPLICIT transfer (a host kernel
    operand, or an unsanctioned tainted concretize) reachable from the
    pipeline/applier hot paths.  The collect seams (``fetch_results``
    / ``fetch_host`` / ``collect_device``) stay open; explicit counted
    placements are the fix, not a finding.

``recompile-churn`` is left out by name: the port compiles each
``.cu`` source once, under a digest of the source and the flags
(``ops/kernels.py``), and shapes are launch arguments, so no compile
cache grows with them.

Deliberate exceptions carry ``# devlint-ok(<rule>): <why>`` on (or in
the comment block just above) the site; markers with no justification
do not waive.  Waived sites are counted in the coverage block
(``python -m nomad_tpu_torch.cli lint -json`` → ``coverage.devlint``).
"""
from __future__ import annotations

import ast
import os
import re

from typing import Optional

from . import Finding
from .callgraph import CallGraph
from . import blocking, lockcheck
from .torchlint import (_dotted, find_wrappers, host_params, load_markers,
                        waived)

# -- placement seams --------------------------------------------------------

# Call names (function or method, last segment) whose RESULT is a
# device-resident value: the explicit placement seams plus the resident
# cache getters.  The abstract interpretation of "placed" starts here.
PRODUCERS = frozenset({
    "_put", "ensure_on_default", "put_counted", "upload", "gather",
    "shard_fleet_arrays", "_scatter_rows",
    "device_capacity_reserved", "device_capacity_reserved_sharded",
    "device_feasible_sharded", "device_usage", "device_usage_sharded",
    "dispatch_usage", "_dev_const", "_dev_const_repl",
})

# Receiver-qualified producers: `<something sharded>.prepare/install/
# lookup` (ShardedResidency) — "prepare"/"install" alone are too
# generic to trust on arbitrary receivers.
_SHARDED_RES_METHODS = frozenset({"prepare", "install", "lookup"})

# Explicit, counted placements (the transfer sites that are the design).
PUT_SEAMS = frozenset({"_put", "ensure_on_default", "put_counted",
                       "upload"})

# Functions allowed to move tensors to a device directly: the seams
# themselves.  Every function of parallel/devices.py and quals starting
# with "ShardedResidency." are also sanctioned.
RESIDENT_SEAMS = frozenset({
    "_put", "_shard", "ensure_on_default", "put_counted", "upload",
    "_scatter_rows",
})
SEAM_MODULE = "parallel/devices.py"
# The mesh authority: its own launches ARE the sharded dispatch.
MESH_MODULE = "parallel/mesh.py"

# Sanctioned device->host collect seams: the deliberate fetch points
# whose concretizations are the design, not a finding.
D2H_SEAMS = frozenset({"fetch_results", "fetch_host", "collect_device",
                       "copy_to_host_async"})

# Hot-path roots (qualname last segment): the pipeline/batch dispatch
# and drain stages plus the applier's window verify — the per-eval
# loops where an implicit transfer is paid per eval.
HOT_SUFFIXES = frozenset({
    "dispatch_device", "_dispatch_device_sharded", "_drain_window",
    "_collect_item", "_process_staged", "_drain_loop", "_finish_lanes",
    "_run_single", "_process", "_apply_window", "evaluate_window",
    "_prepare_device", "finish_deferred", "_submit_window",
})

_CONCRETIZE_FUNCS = frozenset({"float", "int", "bool"})
_CONCRETIZE_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# torch constructors that copy host data to ``device=``.
_FROM_HOST_CTORS = frozenset({"tensor", "as_tensor", "asarray"})

MARKER_RE = re.compile(r"#\s*devlint-ok\((?P<rule>[a-z-]+)\)\s*:\s*\S")


class Kernel:
    """One kernel wrapper discovered in the package."""

    __slots__ = ("fn_key", "names", "static", "sharded", "module",
                 "params", "line", "self_placing")

    def __init__(self, fn_key: str, module: str, params: list,
                 line: int) -> None:
        self.fn_key = fn_key          # FuncNode key of the wrapper
        self.names: set = set()       # names callers use
        self.static: set = set()      # host (launch-scalar) params
        self.sharded = False
        self.module = module
        self.params = params          # positional param names, in order
        self.line = line
        # A sharded wrapper that places its own operands (mesh._put /
        # shard_fleet_arrays in its body or a helper it calls): host
        # operands are its placement boundary, not a mix.
        self.self_placing = False


def _places(graph, fn, depth: int = 1) -> bool:
    """Does ``fn`` (or a function it calls, ``depth`` levels down) call
    a placement seam?"""
    for site in fn.calls:
        name = site.text.split(".")[-1]
        if name in PUT_SEAMS or name == "shard_fleet_arrays":
            return True
        if depth and site.kind == "intra" and site.callee in \
                graph.functions and _places(
                    graph, graph.functions[site.callee], depth - 1):
            return True
    return False


def _find_kernels(graph: CallGraph) -> dict:
    """fn_key -> Kernel for every kernel wrapper and every module-level
    ``*_sharded`` function."""
    found = dict(find_wrappers(graph))
    for key, fn in graph.functions.items():
        if fn.cls is None and "." not in fn.qual and \
                fn.qual.endswith("_sharded"):
            found[key] = fn
    kernels: dict = {}
    for key, fn in found.items():
        params = [a.arg for a in fn.node.args.posonlyargs +
                  fn.node.args.args]
        k = kernels[key] = Kernel(key, fn.module, params, fn.line)
        k.names.add(fn.node.name)
        k.static = host_params(fn.node)
        k.sharded = fn.node.name.endswith("_sharded")
        k.self_placing = k.sharded and _places(graph, fn)
    return kernels


def _is_device_arg(expr) -> bool:
    """Does this ``.to(...)`` argument name a device (not a dtype, not
    the CPU)?"""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value != "cpu"
    d = _dotted(expr)
    if d is not None:
        if d[0] == "torch" and len(d) == 2:
            return False          # torch.float32 et al.
        if "dtype" in d[-1]:
            return False
        return True
    if isinstance(expr, ast.Call):
        d = _dotted(expr.func)
        if d and d[-1] == "device" and expr.args and \
                isinstance(expr.args[0], ast.Constant):
            return expr.args[0].value != "cpu"
        return True
    return isinstance(expr, (ast.Subscript, ast.Attribute))


def _raw_move(node: ast.Call) -> Optional[str]:
    """The text of a raw host-or-device move, or None."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr == "cuda":
            return ".cuda()"
        if fn.attr == "to":
            target = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "device"),
                None)
            if target is not None and _is_device_arg(target):
                return f".to({ast.unparse(target)})"
            return None
    d = _dotted(fn)
    if d and d[0] == "torch" and len(d) == 2 and \
            d[1] in _FROM_HOST_CTORS:
        for kw in node.keywords:
            if kw.arg == "device" and _is_device_arg(kw.value):
                return f"torch.{d[1]}(..., device={ast.unparse(kw.value)})"
    return None


# -- per-function local classification --------------------------------------

class _Locals:
    """Best-effort forward classification of a function's locals: which
    names hold device-placed values and which hold device-tainted
    values.  Branch-insensitive by design (any producer assignment
    marks the name placed) — the misses are counted, not silent."""

    __slots__ = ("placed", "tainted")

    def __init__(self) -> None:
        self.placed: set = set()
        self.tainted: set = set()


def _producer_call(node: ast.Call, kernels_by_name: dict) -> bool:
    fn = node.func
    name = None
    if isinstance(fn, ast.Name):
        name = fn.id
    elif isinstance(fn, ast.Attribute):
        name = fn.attr
        if name in _SHARDED_RES_METHODS:
            try:
                owner = ast.unparse(fn.value)
            except Exception:
                owner = ""
            return "sharded" in owner
    if name is None:
        return False
    if name in PRODUCERS:
        return True
    return name in kernels_by_name


def _scan_locals(fn_node, kernels_by_name: dict) -> _Locals:
    st = _Locals()

    def classify(target, value) -> None:
        names = []
        if isinstance(target, ast.Name):
            names = [target.id]
        elif isinstance(target, (ast.Tuple, ast.List)):
            names = [el.id for el in target.elts
                     if isinstance(el, ast.Name)]
        elif isinstance(target, ast.Subscript) and \
                isinstance(target.value, ast.Name):
            # holder[i] = producer(...) marks the holder placed
            # (the dev_const / feasibility [host, device] patterns).
            if isinstance(value, ast.Call) and \
                    _producer_call(value, kernels_by_name):
                st.placed.add(target.value.id)
            return
        if not names:
            return
        if isinstance(value, ast.Call) and \
                _producer_call(value, kernels_by_name):
            for n in names:
                st.placed.add(n)
                st.tainted.add(n)
            return
        # Plain rebinding propagates placement/taint (x = holder[1],
        # y = x): the two-pass walk stabilizes chains.
        if _expr_placed(value, st, kernels_by_name):
            for n in names:
                st.placed.add(n)
        if _expr_tainted(value, st, kernels_by_name):
            for n in names:
                st.tainted.add(n)

    # Two passes so loop-carried classifications stabilize.
    for _ in range(2):
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    classify(tgt, node.value)
            elif isinstance(node, ast.AnnAssign) and \
                    node.value is not None:
                classify(node.target, node.value)
    return st


def _expr_placed(expr, st: _Locals, kernels_by_name: dict) -> bool:
    """Is this call-site operand derived from an explicit placement?"""
    if isinstance(expr, ast.Name):
        return expr.id in st.placed
    if isinstance(expr, ast.Attribute):
        if expr.attr.endswith("_d") or expr.attr.endswith("_device") or \
                expr.attr == "usage_device":
            return True
        return _expr_placed(expr.value, st, kernels_by_name)
    if isinstance(expr, ast.Subscript):
        return _expr_placed(expr.value, st, kernels_by_name)
    if isinstance(expr, ast.Call):
        return _producer_call(expr, kernels_by_name)
    if isinstance(expr, ast.Starred):
        return _expr_placed(expr.value, st, kernels_by_name)
    if isinstance(expr, (ast.GeneratorExp, ast.ListComp)):
        # (put_counted(x, device) for x in ...): each element placed
        return _expr_placed(expr.elt, st, kernels_by_name)
    return False


def _expr_tainted(expr, st: _Locals, kernels_by_name: dict) -> bool:
    """Does this expression carry a device value (a concretization of
    it is a device->host transfer)?"""
    if isinstance(expr, ast.Name):
        return expr.id in st.tainted
    if isinstance(expr, (ast.Attribute, ast.Subscript, ast.Starred)):
        return _expr_tainted(expr.value, st, kernels_by_name)
    if isinstance(expr, ast.Call):
        return _producer_call(expr, kernels_by_name)
    return False


# -- the region walk --------------------------------------------------------

class _DevRecord:
    __slots__ = ("key", "qual", "rel", "transfers", "kernel_calls",
                 "calls", "consults_mesh", "is_kernel", "d2h_sites")

    def __init__(self, key: str, qual: str, rel: str) -> None:
        self.key = key
        self.qual = qual
        self.rel = rel
        # (held, kind, line, text): kind in {"put", "implicit-h2d",
        # "d2h"} — the transfer sites, with held-lock context.
        self.transfers: list = []
        # (held, Kernel, ast.Call, line)
        self.kernel_calls: list = []
        # (held, callee_key, line, text) — resolved intra calls.
        self.calls: list = []
        self.consults_mesh = False
        self.is_kernel = False
        self.d2h_sites: list = []   # (held, line, text, implicit)


class _DevVisitor(blocking._RegionVisitor):
    """blocking's held-lock region walk, extended to record the
    device-plane events (kernel dispatches, placements, concretize
    sites) alongside the parent's lock bookkeeping."""

    def __init__(self, graph, pkg, info, cls_info, region, fn_node,
                 dev: _DevRecord, st: _Locals, kernels: dict,
                 kernels_by_name: dict) -> None:
        super().__init__(graph, pkg, info, cls_info, region, fn_node)
        self.dev = dev
        self.st = st
        self.kernels = kernels
        self.kernels_by_name = kernels_by_name

    def visit_Call(self, node: ast.Call) -> None:
        self._classify_dev(node)
        super().visit_Call(node)

    def _classify_dev(self, node: ast.Call) -> None:
        held = tuple(self.stack)
        dev = self.dev
        d = _dotted(node.func)
        text = ""
        try:
            text = ast.unparse(node.func)
        except Exception:
            pass

        if d and d[-1] == "dispatch_mesh":
            dev.consults_mesh = True

        # Explicit placement family: the counted seams, and raw moves.
        if d and d[-1] in PUT_SEAMS:
            dev.transfers.append((held, "put", node.lineno, text))
            return
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("prepare", "install"):
            try:
                owner = ast.unparse(node.func.value)
            except Exception:
                owner = ""
            if "sharded" in owner:
                dev.transfers.append((held, "put", node.lineno, text))
                return
        raw = _raw_move(node)
        if raw is not None:
            dev.transfers.append((held, "raw", node.lineno, raw))
            return

        # Device->host concretizations.
        if d and d[-1] in ("fetch_host", "copy_to_host_async"):
            dev.transfers.append((held, "d2h", node.lineno, text))
            dev.d2h_sites.append((held, node.lineno, text, False))
            return
        if d and len(d) >= 2 and d[0] in ("np", "numpy") and \
                d[-1] in ("asarray", "array") and node.args and \
                _expr_tainted(node.args[0], self.st,
                              self.kernels_by_name):
            dev.transfers.append((held, "d2h", node.lineno, text))
            dev.d2h_sites.append((held, node.lineno, text, True))
            return
        if d and len(d) == 1 and d[0] in _CONCRETIZE_FUNCS and \
                node.args and _expr_tainted(node.args[0], self.st,
                                            self.kernels_by_name):
            dev.transfers.append((held, "d2h", node.lineno, text))
            dev.d2h_sites.append((held, node.lineno, text, True))
            return
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _CONCRETIZE_METHODS and \
                _expr_tainted(node.func.value, self.st,
                              self.kernels_by_name):
            dev.transfers.append((held, "d2h", node.lineno, text))
            dev.d2h_sites.append((held, node.lineno, text, True))
            return

        # Kernel dispatches.
        callee, kind = self.graph.resolve_call(
            self.info, self.cls_key, self.local_types, node.func)
        if kind == "intra" and callee in self.kernels:
            dev.kernel_calls.append((held, self.kernels[callee], node,
                                     node.lineno))
            return
        # Unresolved bare-name kernel call (synthetic packages, local
        # aliases): fall back to the name table.
        name = d[-1] if d else None
        if name in self.kernels_by_name and (kind != "intra"):
            dev.kernel_calls.append(
                (held, self.kernels_by_name[name], node, node.lineno))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def analyze_package(package_dir: str, graph: Optional[CallGraph] = None,
                    scan=None, coverage_out: Optional[dict] = None
                    ) -> list:
    if graph is None:
        graph = CallGraph.build(package_dir)
    pkg, _trees, err = scan or lockcheck.scan_package(package_dir)
    if err is not None:
        return []  # lockcheck already reports the parse error
    kernels = _find_kernels(graph)
    kernels_by_name: dict = {}
    for k in kernels.values():
        for n in k.names:
            kernels_by_name[n] = k
    kernel_fn_keys = set(kernels)

    cls_infos = {}
    for info in pkg.classes:
        cls_infos[(info.module, info.name)] = info

    markers = load_markers(
        package_dir, {fn.rel for fn in graph.functions.values()},
        MARKER_RE)

    cov = {"kernels": len(kernels), "kernel_call_sites": 0,
           "placed_args": 0, "host_args": 0, "transfer_sites": 0,
           "hot_functions": 0, "waived": 0}

    records: dict = {}
    locals_of: dict = {}
    for key, fn in graph.functions.items():
        info = graph.modules.get(fn.module)
        if info is None:
            continue
        cls_info = cls_infos.get((fn.module, fn.cls)) if fn.cls else None
        dev = _DevRecord(key, fn.qual, fn.rel)
        dev.is_kernel = key in kernel_fn_keys
        st = _scan_locals(fn.node, kernels_by_name)
        region = blocking._Region(key, fn.qual, fn.rel)
        _DevVisitor(graph, pkg, info, cls_info, region, fn.node, dev,
                    st, kernels, kernels_by_name).run()
        dev.calls = region.calls
        records[key] = dev
        locals_of[key] = st

    findings: list = []
    # Waived SITES, deduped (rel, line, rule): one reviewed marker is
    # one ledger entry no matter how many passes or caller chains
    # touch it.
    waived_sites: set = set()

    def emit(rule, rel, where, msg, line):
        if waived(markers, rel, line, rule):
            waived_sites.add((rel, line, rule))
            return
        findings.append(Finding(rule, rel, where, msg, line))

    def judge_args(kernel: Kernel, call: ast.Call, st: _Locals) -> list:
        """[(param_name, arg_expr, placed)] for every non-static
        operand of one kernel call (positional by index, keyword by
        name)."""
        out = []
        for pos, arg in enumerate(call.args):
            pname = kernel.params[pos] if pos < len(kernel.params) \
                else f"arg{pos}"
            if pname in kernel.static:
                continue
            out.append((pname, arg,
                        _expr_placed(arg, st, kernels_by_name)))
        for kw in call.keywords:
            if kw.arg is None or kw.arg in kernel.static:
                continue
            out.append((kw.arg, kw.value,
                        _expr_placed(kw.value, st, kernels_by_name)))
        return out

    # -- pass 1: sharding propagation ----------------------------------
    for key, dev in records.items():
        if dev.is_kernel:
            continue  # a wrapper calling a wrapper: launch plumbing
        st = locals_of[key]
        for held, kernel, call, line in dev.kernel_calls:
            cov["kernel_call_sites"] += 1
            fn = graph.functions[key]
            in_def_module = fn.module == kernel.module
            # Per-operand placement judgment (skipping static args).
            host_args = []
            for pname, arg, placed in judge_args(kernel, call, st):
                if placed:
                    cov["placed_args"] += 1
                else:
                    cov["host_args"] += 1
                    host_args.append((pname, arg))

            if kernel.sharded:
                if kernel.self_placing:
                    continue
                for pname, arg in host_args:
                    try:
                        a_text = ast.unparse(arg)
                    except Exception:
                        a_text = pname
                    emit("sharding-mix", dev.rel,
                         f"{dev.qual}.{pname}",
                         f"host operand `{a_text}` flows into sharded "
                         f"wrapper call (param `{pname}`): it is cut and "
                         "uploaded on every call — route it through "
                         "mesh._put / the dev_const holders", line)
            elif not in_def_module and not dev.rel.replace(
                    os.sep, "/").endswith(MESH_MODULE):
                if not dev.consults_mesh:
                    kname = sorted(kernel.names)[0]
                    emit("mesh-bypass", dev.rel,
                         f"{dev.qual}.{kname}",
                         f"dispatches unsharded kernel `{kname}` "
                         "without consulting parallel/mesh."
                         "dispatch_mesh — on a multi-device platform "
                         "this silently pins the fleet to one device",
                         line)

    # resident-bypass: raw device moves outside the seams.
    for key, dev in records.items():
        qual_last = dev.qual.split(".")[-1]
        sanctioned = qual_last in RESIDENT_SEAMS or \
            dev.qual.startswith("ShardedResidency.") or \
            dev.rel.replace(os.sep, "/").endswith(SEAM_MODULE)
        if sanctioned:
            continue
        for held, kind, line, text in dev.transfers:
            if kind == "raw":
                emit("resident-bypass", dev.rel, dev.qual,
                     f"raw device move {text} outside the residency "
                     "seams (devices.put_counted / ensure_on_default / "
                     "PinnedStaging.upload / mesh._put / "
                     "ShardedResidency): the move bypasses the transfer "
                     "odometer and the residency policy", line)

    # -- pass 2: transfer discipline -----------------------------------
    # Count transfer sites; waive marker-justified roots out of the
    # may-transfer chains so a justified site doesn't flag its callers.
    chains: dict = {}
    for key, dev in records.items():
        cov["transfer_sites"] += len(dev.transfers)
        live_roots = []
        for held, kind, line, text in dev.transfers:
            if waived(markers, dev.rel, line, "transfer-under-lock"):
                waived_sites.add((dev.rel, line, "transfer-under-lock"))
            else:
                live_roots.append((held, kind, line, text))
        if live_roots:
            held, kind, line, text = live_roots[0]
            chains[key] = [(f"{text or kind} [{kind}]", dev.rel, line)]
    changed = True
    while changed:
        changed = False
        for key, dev in records.items():
            for held, callee, line, text in dev.calls:
                if callee is None or callee not in chains:
                    continue
                cand = [(text or callee, dev.rel, line)] + chains[callee]
                if key not in chains or len(cand) < len(chains[key]):
                    chains[key] = cand
                    changed = True

    seen: set = set()
    for key, dev in records.items():
        for held, kind, line, text in dev.transfers:
            if not held:
                continue
            innermost = held[-1]
            # Dedup is line-qualified: two same-shaped sites under one
            # lock are separate findings, so a marker waiving the first
            # can never swallow the second.
            fkey = (dev.qual, innermost, kind, text, line)
            if fkey in seen:
                continue
            seen.add(fkey)
            emit("transfer-under-lock", dev.rel,
                 f"{dev.qual}[{innermost}]",
                 f"holds {innermost} across a device transfer "
                 f"({text or kind}): every other thread queues behind "
                 "the copy — upload outside the lock and revalidate",
                 line)
        for held, callee, line, text in dev.calls:
            if not held or callee is None:
                continue
            chain = chains.get(callee)
            if chain is None:
                continue
            waived_step = next(
                ((rel, ln) for _txt, rel, ln in chain
                 if waived(markers, rel, ln, "transfer-under-lock")),
                None)
            if waived_step is not None:
                waived_sites.add(waived_step +
                                 ("transfer-under-lock",))
                continue
            innermost = held[-1]
            fkey = (dev.qual, innermost, callee)
            if fkey in seen:
                continue
            seen.add(fkey)
            emit("transfer-under-lock", dev.rel,
                 f"{dev.qual}[{innermost}]",
                 f"holds {innermost} across a call chain that "
                 f"transfers: {text or callee} -> " +
                 " -> ".join(s[0] for s in chain), line)

    # Hot-path reachability (BFS over resolved intra calls).
    hot: set = set()
    frontier = [key for key, dev in records.items()
                if dev.qual.split(".")[-1] in HOT_SUFFIXES]
    while frontier:
        key = frontier.pop()
        if key in hot:
            continue
        hot.add(key)
        dev = records.get(key)
        if dev is None:
            continue
        for _held, callee, _line, _text in dev.calls:
            if callee is not None and callee in records and \
                    callee not in hot:
                frontier.append(callee)
    cov["hot_functions"] = len(hot)

    for key in hot:
        dev = records[key]
        qual_last = dev.qual.split(".")[-1]
        st = locals_of[key]
        # Implicit host operands into kernels on the hot path.
        for held, kernel, call, line in dev.kernel_calls:
            if kernel.sharded:
                continue  # pass 1 owns the sharded family
            for pname, arg, placed in judge_args(kernel, call, st):
                if placed:
                    continue
                try:
                    a_text = ast.unparse(arg)
                except Exception:
                    a_text = pname
                emit("transfer-in-hot-loop", dev.rel,
                     f"{dev.qual}.{pname}",
                     f"host operand `{a_text}` reaches a kernel "
                     "wrapper on the per-eval hot path unplaced — "
                     "place it explicitly (devices.put_counted / "
                     "the dev_const holders) so the transfer is "
                     "counted and guard-safe", line)
        # Unsanctioned tainted concretizations on the hot path.
        if qual_last not in D2H_SEAMS:
            for held, line, text, implicit in dev.d2h_sites:
                if not implicit:
                    continue  # explicit fetch_host: disciplined
                emit("transfer-in-hot-loop", dev.rel,
                     f"{dev.qual}.{text or 'concretize'}",
                     f"implicit device->host concretization "
                     f"({text}) on the per-eval hot path — fetch "
                     "through the collect seams "
                     "(fetch_results/devices.fetch_host)", line)

    cov["waived"] = len(waived_sites)
    if coverage_out is not None:
        coverage_out.update(cov)
    return findings
