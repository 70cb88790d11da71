"""Consensus-plane lint: FSM determinism, leadership fencing, and the
read-consistency contract.

Counterpart of ``nomad_tpu/analysis/consensuslint.py`` (the same rules
and keys).  Every replica applying the same raft log must reach
byte-identical state — the store fingerprint tests sample that property
on a handful of recorded histories, but follower-served reads and a
multi-raft write plane need it *proven* over the whole apply surface.
Three passes ride the interprocedural call graph:

**Apply-determinism taint** — the closure reachable from the FSM apply
surface (``NomadFSM.apply`` / ``_apply_*`` / ``restore`` / ``snapshot``)
and the store write surface (``upsert_*`` / ``delete_*`` / ``update_*``
/ restore commit) is the replicated state machine; values arriving via
the log entry are the only clean inputs.  Inside that closure the pass
flags every source of replica divergence:

  - ``apply-wall-clock``: ``time.time``/``monotonic``/``perf_counter``
    and ``datetime.now`` family reads — two replicas apply the same
    entry at different wall times.
  - ``apply-rng``: unseeded randomness (``random.*`` module calls,
    ``uuid4``/``uuid1``, ``os.urandom``, ``secrets.*``).  Seeded
    instance generators (``self._rng``) are replayable and exempt; ids
    must be minted leader-side BEFORE the entry is logged.
  - ``apply-env``: environment/host identity reads (``os.environ`` /
    ``os.getenv`` / ``socket.gethostname`` / ``platform.node``) — per-
    host values that differ across replicas.
  - ``apply-iter-order``: set iteration whose order escapes into an
    ordered output (a list comprehension / ``list()`` / an appending
    loop) — set order depends on ``PYTHONHASHSEED``, so the escaped
    order differs per process.  Dict iteration is deliberately allowed:
    insertion order is deterministic under identical replay.
  - ``apply-float-accum``: float accumulation (``sum`` / ``+=`` loops)
    over an unordered collection — float addition is not associative,
    so the hash-order walk changes the result bits.

The notification/observability planes never feed replicated state and
are excluded as sinks (``obs.*`` modules, ``StateWatch``); exclusions
are counted in the coverage block, not silent.

**Leadership fencing** — leader-only machinery (broker ``force=True``
enqueues, HeartbeatManager arming, PlanApplier/_Committer dispatch,
controller actuation, GC core-eval creation) must be reachable only
through a leadership-fenced entry, so a future follower serving reads
can be proven never to mutate leader state.  A function is fenced if it
syntactically checks leadership (``is_leader()`` / ``self._leader`` /
``_forward()`` / ``_leading()``) or IS a leadership transition hook
(``establish_leadership`` and friends); fencing then propagates down
the call graph — a function is fenced when every resolved in-package
caller is fenced (``Thread(target=self.x)`` counts as a call from the
function that arms the thread).  Rule: ``leader-fence``.

**Read-consistency contract** — every RPC endpoint that reads the store
is classified (``stale-safe`` / ``leader-only`` / ``write`` /
``server-local``) from the handler's own shape: stale-safe reads must
flow through the blocking-query ``min_index`` discipline
(``_blocking``) AND be registered in ``CONSISTENT_READS``; any direct
store read must sit behind the ``_forward`` leader fence.  Rules:
``read-consistency`` (an unfenced direct store read) and
``stale-read-bypass`` (a blocking read outside ``CONSISTENT_READS``, or
a CONSISTENT_READS handler reading state outside the discipline).  The
classification table is emitted in ``lint -json``
(``coverage.consensuslint.endpoint_contract``) as the machine-readable
contract follower-served reads build on.

Deliberate exceptions carry an inline justification marker on (or one
line above) the site — ``# consensus-ok(<rule>): <why>`` — the devlint
marker grammar; markers with no justification text do not waive.
Waived sites are counted in the coverage block so the ledger stays
visible.
"""
from __future__ import annotations

import ast
import os
import re

from typing import Optional

from . import Finding
from .callgraph import CallGraph
from .torchlint import _dotted

_MARKER_RE = re.compile(r"#\s*consensus-ok\((?P<rule>[a-z-]+)\)\s*:\s*\S")

# -- pass 1: apply-determinism ----------------------------------------------

# Modules whose path contains one of these parts are observability /
# tracing planes: they never feed replicated state (fingerprint() covers
# tables + changelog only), so the taint walk treats them as sinks.
SINK_MODULE_PARTS = frozenset({"obs"})

# Classes excluded as sinks: the watch/notify plane fans events out to
# subscribers, it never writes a table.
SINK_CLASSES = frozenset({"StateWatch"})

_WALL_CLOCK_TIME = frozenset({
    "time", "time_ns", "monotonic", "monotonic_ns",
    "perf_counter", "perf_counter_ns", "clock_gettime",
})
_WALL_CLOCK_DT = frozenset({"now", "utcnow", "today"})
_HOST_SOCKET = frozenset({"gethostname", "getfqdn", "gethostbyname"})

# -- pass 2: leadership fencing ---------------------------------------------

# Leadership transition hooks: bodies that RUN the transition are the
# fence, by definition (plus teardown, which must be able to stop
# leader machinery regardless of the current flag).
FENCE_HOOKS = frozenset({
    "establish_leadership", "revoke_leadership", "_on_leadership_change",
    "abandon", "shutdown",
})

# Call names that read the leadership flag: seeing one in a function
# body makes it a syntactic fence.
_FENCE_CALLS = frozenset({"is_leader", "_forward", "_leading"})

# Receiver substrings that mark .start()/.submit() dispatch as
# leader-plane machinery (PlanApplier, the plan _Committer, the
# feedback controller).
_DISPATCH_RECEIVERS = ("applier", "controller", "committer")


def _snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


# -- markers (devlint grammar, consensus-ok spelling) ------------------------

def _load_markers(package_dir: str, rels) -> dict:
    """(rel, line) -> {rule, ...} for every justified consensus-ok
    marker (same propagation rules as devlint._load_markers)."""
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
            for m in _MARKER_RE.finditer(text):
                rule = m.group("rule")
                out.setdefault((rel, i), set()).add(rule)
                if not text.lstrip().startswith("#"):
                    # Inline marker: waives its own line only.
                    continue
                # Comment-block marker: waive the continuation comment
                # lines and the first code line the block lands on; a
                # blank line ends the block unattached.
                j = i + 1
                while j <= len(lines) and \
                        lines[j - 1].lstrip().startswith("#"):
                    out.setdefault((rel, j), set()).add(rule)
                    j += 1
                if j <= len(lines) and lines[j - 1].strip():
                    out.setdefault((rel, j), set()).add(rule)
    return out


def _waived(markers: dict, rel: str, line: int, rule: str) -> bool:
    return rule in markers.get((rel, line), ())


# -- pass 1 helpers ----------------------------------------------------------

def _is_apply_root(fn) -> bool:
    """The replicated-write surface: FSM apply/restore/snapshot and the
    store/restore write methods (name-driven so synthetic test packages
    participate)."""
    if fn.cls is None:
        return False
    last = fn.qual.split(".")[-1]
    if fn.qual.count(".") > 1:
        return False        # nested defs join via the call walk, not as roots
    if fn.cls.endswith("FSM"):
        return (last in ("apply", "restore", "snapshot") or
                last.startswith("_apply_"))
    if fn.cls.endswith("Store") or fn.cls.endswith("Restore"):
        return (last.startswith(("upsert_", "delete_", "update_")) or
                last.endswith("_restore") or last == "commit")
    return False


def _is_sink(fn) -> bool:
    if fn.cls in SINK_CLASSES:
        return True
    return bool(SINK_MODULE_PARTS & set(fn.module.split(".")))


def _banned_call(d: tuple) -> Optional[tuple]:
    """(rule, what) when the dotted call target is a nondeterminism
    source; None otherwise."""
    if len(d) == 2 and d[0] == "time" and d[1] in _WALL_CLOCK_TIME:
        return ("apply-wall-clock", f"wall-clock read {'.'.join(d)}()")
    if d[-1] in _WALL_CLOCK_DT and "datetime" in d[:-1]:
        return ("apply-wall-clock", f"wall-clock read {'.'.join(d)}()")
    if len(d) >= 2 and d[0] == "random":
        return ("apply-rng", f"unseeded RNG {'.'.join(d)}()")
    if d[-1] in ("uuid4", "uuid1") and (len(d) == 1 or d[0] == "uuid"):
        return ("apply-rng", f"RNG id mint {'.'.join(d)}()")
    if d[-1] == "urandom":
        return ("apply-rng", f"entropy read {'.'.join(d)}()")
    if d[0] == "secrets":
        return ("apply-rng", f"entropy read {'.'.join(d)}()")
    if d[:2] == ("os", "environ") or d == ("os", "getenv"):
        return ("apply-env", f"environment read {'.'.join(d)}")
    if d[0] == "socket" and d[-1] in _HOST_SOCKET:
        return ("apply-env", f"host identity read {'.'.join(d)}()")
    if d == ("platform", "node"):
        return ("apply-env", "host identity read platform.node()")
    return None


def _unordered_expr(e: ast.expr, names: set) -> bool:
    """True when the expression's value is an unordered (hash-ordered)
    collection: set/frozenset constructions, names bound to one, and
    set-algebra over them.  ``sorted(...)``/``list(...)`` launder the
    order and are NOT unordered."""
    if isinstance(e, (ast.Set, ast.SetComp)):
        return True
    if isinstance(e, ast.Call):
        d = _dotted(e.func)
        if d in (("set",), ("frozenset",)):
            return True
        if d and d[-1] in ("union", "intersection", "difference",
                           "symmetric_difference") and \
                isinstance(e.func, ast.Attribute) and \
                _unordered_expr(e.func.value, names):
            return True
        return False
    if isinstance(e, ast.Name):
        return e.id in names
    if isinstance(e, ast.BinOp) and isinstance(
            e.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _unordered_expr(e.left, names) or \
            _unordered_expr(e.right, names)
    return False


def _unordered_names(fn_node) -> set:
    """Names assigned from unordered expressions (two fixpoint rounds
    cover one level of chaining; branch-insensitive by design)."""
    names: set = set()
    for _ in range(2):
        for n in ast.walk(fn_node):
            if isinstance(n, ast.Assign) and \
                    _unordered_expr(n.value, names):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


def _scan_order_escapes(fn_node, emit) -> None:
    """Flag set-order escaping into ordered output / float accumulation
    over unordered collections.  ``emit(rule, what, line)``."""
    names = _unordered_names(fn_node)

    def unordered(e: ast.expr) -> bool:
        return _unordered_expr(e, names)

    for n in ast.walk(fn_node):
        if isinstance(n, ast.ListComp):
            if any(unordered(g.iter) for g in n.generators):
                emit("apply-iter-order",
                     "set iteration order escapes into a list",
                     n.lineno)
        elif isinstance(n, ast.Call):
            d = _dotted(n.func)
            if d is None or not n.args:
                continue
            arg = n.args[0]
            arg_unordered = unordered(arg) or (
                isinstance(arg, ast.GeneratorExp) and
                any(unordered(g.iter) for g in arg.generators))
            if not arg_unordered:
                continue
            if d == ("sum",):
                emit("apply-float-accum",
                     "accumulation over an unordered collection "
                     "(sum over a set)", n.lineno)
            elif d in (("list",), ("tuple",)):
                emit("apply-iter-order",
                     "set iteration order escapes into a sequence",
                     n.lineno)
        elif isinstance(n, ast.For) and unordered(n.iter):
            for b in ast.walk(n):
                if isinstance(b, ast.Call) and \
                        isinstance(b.func, ast.Attribute) and \
                        b.func.attr in ("append", "extend", "insert"):
                    emit("apply-iter-order",
                         "set iteration order escapes via "
                         f".{b.func.attr}()", b.lineno)
                    break
                if isinstance(b, ast.AugAssign) and \
                        isinstance(b.op, ast.Add):
                    emit("apply-float-accum",
                         "accumulation (+=) over an unordered "
                         "collection", b.lineno)
                    break


def _determinism_pass(graph: CallGraph, emit, cov: dict) -> None:
    roots = sorted(k for k, fn in graph.functions.items()
                   if _is_apply_root(fn))
    closure: set = set(roots)
    parents: dict = {}
    sinks_hit: set = set()
    frontier = list(roots)
    while frontier:
        key = frontier.pop()
        fn = graph.functions[key]
        for cs in fn.calls:
            if cs.kind != "intra" or cs.callee not in graph.functions:
                continue
            if cs.callee in closure:
                continue
            callee = graph.functions[cs.callee]
            if _is_sink(callee):
                sinks_hit.add(cs.callee)
                continue
            closure.add(cs.callee)
            parents[cs.callee] = key
            frontier.append(cs.callee)

    def chain(key: str) -> str:
        path = [key]
        while path[-1] in parents:
            path.append(parents[path[-1]])
        quals = [graph.functions[k].qual for k in reversed(path)]
        return " -> ".join(quals)

    banned = 0
    for key in sorted(closure):
        fn = graph.functions[key]
        via = chain(key)

        def emit_site(rule: str, what: str, line: int,
                      _fn=fn, _via=via) -> None:
            nonlocal banned
            banned += 1
            emit(rule, _fn.rel, f"{_fn.qual}[{what.split(' ')[-1]}]",
                 f"{what} on the replicated apply path ({_via}) — "
                 f"replicas applying the same log entry diverge",
                 line)

        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d is None:
                    continue
                hit = _banned_call(d)
                if hit is not None:
                    emit_site(hit[0], hit[1], node.lineno)
            elif isinstance(node, ast.Attribute):
                d = _dotted(node)
                if d is not None and d[:2] == ("os", "environ"):
                    emit_site("apply-env", "environment read os.environ",
                              node.lineno)
        _scan_order_escapes(fn.node, emit_site)

    cov["apply_roots"] = len(roots)
    cov["apply_closure"] = len(closure)
    cov["sinks_excluded"] = len(sinks_hit)
    cov["apply_banned_sites"] = banned


# -- pass 2 helpers ----------------------------------------------------------

def _leader_target(call: ast.Call) -> Optional[str]:
    """Short label when the call site is leader-only machinery."""
    fnode = call.func
    if isinstance(fnode, ast.Name):
        if fnode.id == "_enqueue_core_eval":
            return "core-eval-create"
        return None
    if not isinstance(fnode, ast.Attribute):
        return None
    meth = fnode.attr
    try:
        owner = ast.unparse(fnode.value).lower()
    except Exception:
        owner = ""
    if meth == "enqueue":
        for kw in call.keywords:
            if kw.arg == "force" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is True:
                return "broker-force-enqueue"
        return None
    if meth == "reset_heartbeat_timer":
        return "heartbeat-arm"
    if meth == "initialize" and "heartbeat" in owner:
        return "heartbeat-arm"
    if meth == "_enqueue_core_eval":
        return "core-eval-create"
    if meth == "set_enabled" and call.args and \
            isinstance(call.args[0], ast.Constant) and \
            call.args[0].value is True:
        return "leader-plane-enable"
    if meth in ("start", "submit") and \
            any(s in owner for s in _DISPATCH_RECEIVERS):
        return "leader-dispatch"
    return None


def _syntactic_fence(fn) -> bool:
    last = fn.qual.split(".")[-1]
    if last in FENCE_HOOKS:
        return True
    for n in ast.walk(fn.node):
        if isinstance(n, ast.Call):
            d = _dotted(n.func)
            if d and d[-1] in _FENCE_CALLS:
                return True
        elif isinstance(n, ast.Attribute) and n.attr == "_leader" and \
                isinstance(n.ctx, ast.Load):
            # A READ of the flag is a fence; `self._leader = False` in
            # an initializer is not.
            return True
    return False


def _fencing_pass(graph: CallGraph, emit, cov: dict) -> None:
    # Reverse edges over resolved intra calls, plus Thread(target=
    # self.x) arming edges: the thread body is "called by" the armer.
    callers: dict = {}
    for key, fn in graph.functions.items():
        for cs in fn.calls:
            if cs.kind == "intra" and cs.callee in graph.functions:
                callers.setdefault(cs.callee, set()).add(key)
        cls_node = graph.class_of(key)
        if cls_node is None:
            continue
        for n in ast.walk(fn.node):
            if not isinstance(n, ast.Call):
                continue
            for kw in n.keywords:
                if kw.arg != "target":
                    continue
                d = _dotted(kw.value)
                if d and len(d) == 2 and d[0] == "self":
                    callee = graph.resolve_method(cls_node.key, d[1])
                    if callee is not None:
                        callers.setdefault(callee, set()).add(key)

    fenced = {k for k, fn in graph.functions.items()
              if _syntactic_fence(fn)}
    changed = True
    while changed:
        changed = False
        for key in graph.functions:
            if key in fenced:
                continue
            cs = callers.get(key)
            if cs and cs <= fenced:
                fenced.add(key)
                changed = True

    sites = 0
    for key in sorted(graph.functions):
        fn = graph.functions[key]
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            target = _leader_target(node)
            if target is None:
                continue
            sites += 1
            if key in fenced:
                continue
            emit("leader-fence", fn.rel, f"{fn.qual}[{target}]",
                 f"leader-only machinery ({target}) reachable without a "
                 f"leadership fence — add an is_leader()/_leader check "
                 f"on the path or a consensus-ok waiver",
                 node.lineno)
    cov["fence_targets"] = sites
    cov["fenced_functions"] = len(fenced)


# -- pass 3: read-consistency contract ---------------------------------------

def _direct_body(fn_node):
    """Walk a function body WITHOUT descending into nested defs (the
    ``run`` closures handed to ``_blocking`` are the disciplined read,
    not a direct one)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _endpoint_tables(graph: CallGraph):
    """(module, service->methods dict, consistent_reads set) for the
    module defining class ``Endpoints``; None when absent."""
    for module, info in graph.modules.items():
        ck = info.classes.get("Endpoints")
        if ck is None:
            continue
        cls = graph.classes.get(ck)
        install_key = cls.methods.get("install") if cls else None
        if install_key is None:
            continue
        install = graph.functions[install_key]
        services: dict = {}
        for n in ast.walk(install.node):
            if not isinstance(n, ast.Dict):
                continue
            for k, v in zip(n.keys, n.values):
                if isinstance(k, ast.Constant) and \
                        isinstance(k.value, str) and \
                        isinstance(v, (ast.List, ast.Tuple)) and \
                        all(isinstance(e, ast.Constant) and
                            isinstance(e.value, str) for e in v.elts):
                    services[k.value] = [e.value for e in v.elts]
        consistent: set = set()
        for n in ast.walk(info.tree):
            if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "CONSISTENT_READS"
                    for t in n.targets):
                for c in ast.walk(n.value):
                    if isinstance(c, ast.Constant) and \
                            isinstance(c.value, str):
                        consistent.add(c.value)
        if services:
            return module, cls, services, consistent
    return None


def _contract_pass(graph: CallGraph, emit, cov: dict) -> None:
    found = _endpoint_tables(graph)
    if found is None:
        cov["endpoints"] = 0
        cov["endpoint_contract"] = {}
        return
    module, cls, services, consistent = found

    handler_names = {f"{svc.lower()}_{_snake(m)}": f"{svc}.{m}"
                     for svc, methods in services.items()
                     for m in methods}

    shapes: dict = {}     # full name -> (fn, blocking, forward, read, delegate)
    for hname, full in sorted(handler_names.items()):
        key = graph.resolve_method(cls.key, hname)
        fn = graph.functions.get(key) if key else None
        if fn is None:
            continue
        blocking = forward = reads = False
        delegate = None
        for n in _direct_body(fn.node):
            if not isinstance(n, ast.Call):
                continue
            d = _dotted(n.func)
            if d is None:
                continue
            if d[-1] == "_blocking":
                blocking = True
            elif d[-1] == "_forward":
                forward = True
            elif d[-1] == "_state" or d[-3:] == ("fsm", "state"):
                reads = True
            elif len(d) == 2 and d[0] == "self" and d[1] in handler_names:
                delegate = handler_names[d[1]]
        shapes[full] = (fn, blocking, forward, reads, delegate)

    contract: dict = {}

    def classify(full: str, seen=()) -> str:
        if full in contract:
            return contract[full]
        fn, blocking, forward, reads, delegate = shapes[full]
        if blocking and not reads:
            c = "stale-safe" if full in consistent else "local-read"
        elif reads:
            c = "leader-only" if forward else "unfenced-read"
        elif forward:
            c = "write"
        elif delegate and delegate in shapes and full not in seen:
            c = classify(delegate, seen + (full,))
        else:
            c = "server-local"
        contract[full] = c
        return c

    for full in sorted(shapes):
        c = classify(full)
        fn = shapes[full][0]
        if c == "unfenced-read":
            emit("read-consistency", fn.rel, full,
                 "endpoint reads the store directly with no _forward "
                 "leader fence — a follower would answer from "
                 "unreplicated-yet state with no stale opt-in",
                 fn.line)
        elif c == "local-read":
            emit("stale-read-bypass", fn.rel, full,
                 "blocking store read not registered in "
                 "CONSISTENT_READS — follower-local answers with no "
                 "leader default; add it to the contract table",
                 fn.line)
        elif full in consistent and not shapes[full][1]:
            emit("stale-read-bypass", fn.rel, full,
                 "CONSISTENT_READS endpoint reads outside the "
                 "_blocking min_index discipline — stale reads can't "
                 "be index-bounded", fn.line)
    cov["endpoints"] = len(shapes)
    cov["endpoint_contract"] = {k: v for k, v in sorted(contract.items())}
    cov["stale_safe_reads"] = sum(
        1 for v in contract.values() if v == "stale-safe")
    cov["leader_only_reads"] = sum(
        1 for v in contract.values() if v == "leader-only")


# -- entry -------------------------------------------------------------------

def analyze_package(package_dir: str, graph: Optional[CallGraph] = None,
                    scan=None, coverage_out: Optional[dict] = None
                    ) -> list:
    if graph is None:
        graph = CallGraph.build(package_dir)
    markers = _load_markers(
        package_dir, sorted({fn.rel for fn in graph.functions.values()}))
    findings: list = []
    waived_sites: set = set()
    emitted: set = set()
    cov: dict = {}

    def emit(rule: str, rel: str, where: str, message: str,
             line: int) -> None:
        if (rel, line, rule) in emitted:
            return
        emitted.add((rel, line, rule))
        if _waived(markers, rel, line, rule):
            waived_sites.add((rel, line, rule))
            return
        findings.append(Finding(rule=rule, path=rel, where=where,
                                message=message, line=line))

    _determinism_pass(graph, emit, cov)
    _fencing_pass(graph, emit, cov)
    _contract_pass(graph, emit, cov)
    cov["waived"] = len(waived_sites)
    if coverage_out is not None:
        coverage_out.update(cov)
    return findings
