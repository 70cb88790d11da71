"""Failure-plane lint: deadline propagation, fault-injectability
coverage, and retry safety.

Counterpart of ``nomad_tpu/analysis/faultlint.py`` (the same rules and
keys).  The disciplines this package bets its failure behaviour on
already exist in code — the sixteen ``faultinject`` sites +
``RetryPolicy``, the ``_deadline``/``_abs_deadline`` admission envelope
— but nothing
*proved* that new code keeps them: one unbounded wait on a request path
is how a recovery spike becomes a sustained congestion state
(metastable failure), and one uninjectable I/O edge is a failure mode
no chaos plan can ever rehearse.  Three passes ride the
interprocedural call graph, same shape as devlint/consensuslint:

**Deadline propagation** — from every RPC-serving entry (the
``Endpoints`` handler table, minus the heartbeat/liveness lane) and
every worker/applier/committer loop, the reachable closure is walked
and every blocking wait primitive (``Event``/``Condition`` ``wait`` /
``wait_for``, ``Future.result``/``.wait``, blocking ``queue.get``,
thread ``join``) must carry a timeout:

  - ``unbounded-wait``: a wait with no timeout (or an explicit
    ``timeout=None``) reachable from a request-serving entry.  The
    finding renders the entry→wait call chain.
  - ``deadline-drop``: a function that demonstrably *handles* the
    budget (calls ``restamp_forward`` / ``absolute_deadline`` /
    ``remaining`` / ``stamp_arrival``) and then blocks without clipping
    to it — including the forwarding-transport form: a body that
    re-bases the envelope with ``restamp_forward`` and then invokes a
    ``conn_pool``/``rpc`` ``.call(...)`` without a ``timeout=``, so the
    hop waits the transport default instead of the caller's remaining
    budget.

Socket/device primitives are deliberately NOT pass-1 roots: sockets are
``settimeout``-governed (the runtime ``BudgetWitnessSanitizer`` covers
that plane) and device round-trips are devlint's domain.

**Fault-injectability coverage** — the blocking/I-O root inventory
(socket ops, TLS handshake, dial, select, subprocess, device
dispatch/collect, fsync/replace) is intersected with ``faultinject``
consultation (``fire``/``fire_rpc`` with a literal site name):

  - ``uninjectable-io``: an I/O boundary function with no consulted
    site on its call path (itself, a caller — including the function
    that arms it as a thread target — or a callee).
  - ``dead-site``: a site registered in ``SITES`` that no live code
    consults.

The full boundary→site coverage table ships in ``lint
-json`` (``coverage.faultlint.boundaries``) and the gate asserts every
boundary is covered or carries a reviewed waiver.

**Retry safety** — closures handed to ``RetryPolicy.call`` (and the
queued-flush re-send paths) are taint-checked for non-idempotent state
mutation: accumulation (``+=`` / ``.append`` / ``.extend`` / ``.add`` /
``.insert``) on state that outlives the attempt, without a fencing
token (``token`` / ``fence`` / ``modify_index`` reference) and without
a newest-wins replacement (``.clear()`` + ``.update()`` on the same
receiver).  Rule ``retry-unsafe``.  The same rule covers the shed
discipline: a committed-state applier (consensuslint's apply surface)
must never reach a load-shed path — broker enqueues inside the apply
closure must pass ``force=True``, and no apply-closure function may
call a function that raises ``ErrOverloaded`` (a replayed log entry
that gets shed is a lost committed write).

Reachability is resolved-edges-only (the call graph's documented
approximation): dynamic attribute chains (``self.server.*`` on
unannotated params) do not propagate, which is why the loop surfaces
are classified as entries directly.  Deliberate exceptions carry
``# faultlint-ok(<rule>): <why>`` markers (devlint grammar: inline
waives the line, a comment block waives the block and the first code
line after it); markers with no justification text do not waive, and
waived sites are counted in the coverage block.
"""
from __future__ import annotations

import ast
import os
import re

from typing import Optional

from . import Finding
from .callgraph import CallGraph
from .torchlint import _dotted
from .blocking import _kwarg, _is_false, _QUEUE_RECEIVER_RE, \
    _THREAD_RECEIVER_RE
from .consensuslint import _snake, _direct_body, _endpoint_tables, \
    _is_apply_root

_MARKER_RE = re.compile(r"#\s*faultlint-ok\((?P<rule>[a-z-]+)\)\s*:\s*\S")

# -- pass 1: deadline propagation --------------------------------------------

# Loop surfaces that serve admitted work without going through the
# endpoint table: dequeue→schedule workers, the plan applier, and the
# commit pipeline.  Their run loops are entries in their own right.
_LOOP_CLASS_RE = re.compile(r"(worker|applier|committer)", re.IGNORECASE)

# Calls that mark a function as budget-handling: it touched the
# _deadline/_abs_deadline envelope, so an unbounded wait in the same
# body is a *drop*, not mere ignorance.
_BUDGET_CALLS = frozenset({
    "restamp_forward", "absolute_deadline", "remaining", "stamp_arrival",
})

# -- pass 2: fault-injectability ---------------------------------------------

# Attribute-call method names that ARE an I/O boundary.
_IO_METHOD_KINDS = {
    "sendall": "network", "recv": "network", "recvfrom": "network",
    "accept": "network", "connect": "network", "wrap_socket": "network",
    "communicate": "subprocess",
    "dispatch_device": "device", "collect_device": "device",
}
# External dotted callables that are boundaries.
_IO_EXTERNAL_KINDS = {
    ("socket", "create_connection"): "network",
    ("select", "select"): "network",
    ("subprocess", "run"): "subprocess",
    ("subprocess", "call"): "subprocess",
    ("subprocess", "check_call"): "subprocess",
    ("subprocess", "check_output"): "subprocess",
    ("subprocess", "Popen"): "subprocess",
    ("os", "fsync"): "disk",
    ("os", "replace"): "disk",
}

# -- pass 3: retry safety -----------------------------------------------------

_ACCUM_METHODS = frozenset({"append", "extend", "add", "insert"})
_FENCE_NAME_RE = re.compile(r"(token|fence|modify_index)", re.IGNORECASE)


# -- markers (devlint grammar, faultlint-ok spelling) -------------------------

def _load_markers(package_dir: str, rels) -> dict:
    """(rel, line) -> {rule, ...} for every justified faultlint-ok
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
                    continue
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


# -- shared helpers -----------------------------------------------------------

class _FnFacts:
    """One direct-body walk per function, shared by all three passes."""

    __slots__ = ("calls", "raises_overloaded")

    def __init__(self, fn) -> None:
        # [(ast.Call, dotted-or-None)]
        self.calls: list = []
        self.raises_overloaded = False
        for n in _direct_body(fn.node):
            if isinstance(n, ast.Call):
                self.calls.append((n, _dotted(n.func)))
            elif isinstance(n, ast.Raise) and n.exc is not None:
                d = _dotted(n.exc.func if isinstance(n.exc, ast.Call)
                            else n.exc)
                if d and "Overloaded" in d[-1]:
                    self.raises_overloaded = True


def _prepass(graph: CallGraph) -> dict:
    return {key: _FnFacts(fn) for key, fn in graph.functions.items()}


def _recv_text(call: ast.Call) -> str:
    if not isinstance(call.func, ast.Attribute):
        return ""
    try:
        return ast.unparse(call.func.value)
    except Exception:
        return ""


def _timeout_expr(call: ast.Call, pos: int):
    """The timeout argument: positional index ``pos`` or ``timeout=``."""
    if len(call.args) > pos:
        return call.args[pos]
    return _kwarg(call, "timeout")


def _is_none_expr(e) -> bool:
    return e is None or (isinstance(e, ast.Constant) and e.value is None)


def _wait_root(call: ast.Call) -> Optional[tuple]:
    """``(label, bounded)`` when the call is a pass-1 wait primitive.

    Boundedness is syntactic: a timeout expression that is present and
    not the ``None`` literal counts as bounded (the runtime witness
    catches a variable that evaluates to None).
    """
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    name = f.attr
    if name == "wait":
        return ("blocking wait", not _is_none_expr(_timeout_expr(call, 0)))
    if name == "wait_for":
        return ("blocking wait", not _is_none_expr(_timeout_expr(call, 1)))
    if name == "result":
        return ("Future.result", not _is_none_expr(_timeout_expr(call, 0)))
    recv = _recv_text(call).lower()
    base = recv.rsplit(".", 1)[-1]
    if name == "join":
        if not (_THREAD_RECEIVER_RE.search(base) or "thread" in recv):
            return None
        return ("Thread.join", not _is_none_expr(_timeout_expr(call, 0)))
    if name == "get":
        if not _QUEUE_RECEIVER_RE.search(base):
            return None
        block = call.args[0] if call.args else _kwarg(call, "block")
        if _is_false(block):
            return ("queue.get", True)
        t = call.args[1] if len(call.args) > 1 else _kwarg(call, "timeout")
        return ("queue.get", not _is_none_expr(t))
    return None


def _callers_map(graph: CallGraph, facts: dict) -> dict:
    """Reverse resolved-intra edges, plus ``Thread(target=self.x)``
    arming edges (the thread body is 'called by' the armer) — the
    consensuslint fencing-pass relation."""
    callers: dict = {}
    for key, fn in graph.functions.items():
        for cs in fn.calls:
            if cs.kind == "intra" and cs.callee in graph.functions:
                callers.setdefault(cs.callee, set()).add(key)
        cls_node = graph.class_of(key)
        if cls_node is None:
            continue
        for n, _d in facts[key].calls:
            for kw in n.keywords:
                if kw.arg != "target":
                    continue
                d = _dotted(kw.value)
                if d and len(d) == 2 and d[0] == "self":
                    callee = graph.resolve_method(cls_node.key, d[1])
                    if callee is not None:
                        callers.setdefault(callee, set()).add(key)
    return callers


def _budget_aware(ff: _FnFacts) -> bool:
    return any(d and d[-1] in _BUDGET_CALLS for _n, d in ff.calls)


def _heartbeat_lane(graph: CallGraph) -> set:
    """Full RPC names in the liveness lane: the ``HEARTBEAT_LANE``
    module constant (overload.py), string constants only.  Module
    constants are top-level statements, so only the tree's direct body
    is scanned."""
    lane: set = set()
    for info in graph.modules.values():
        for n in info.tree.body:
            if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "HEARTBEAT_LANE"
                    for t in n.targets):
                for c in ast.walk(n.value):
                    if isinstance(c, ast.Constant) and \
                            isinstance(c.value, str):
                        lane.add(c.value)
    return lane


def _serving_entries(graph: CallGraph) -> tuple:
    """``(entries dict key->label, exempt count)``: endpoint handlers
    (minus the heartbeat/liveness lane) plus worker/applier/committer
    run loops."""
    entries: dict = {}
    exempt = 0
    found = _endpoint_tables(graph)
    if found is not None:
        _module, cls, services, _consistent = found
        lane = _heartbeat_lane(graph)
        for svc, methods in sorted(services.items()):
            for m in methods:
                full = f"{svc}.{m}"
                if full in lane or "heartbeat" in full.lower():
                    exempt += 1
                    continue
                key = graph.resolve_method(cls.key, f"{svc.lower()}_{_snake(m)}")
                if key is not None:
                    entries[key] = f"rpc:{full}"
    for key, fn in sorted(graph.functions.items()):
        if fn.cls is None or fn.qual.count(".") > 1:
            continue
        last = fn.qual.split(".")[-1]
        if last in ("run", "_run") and _LOOP_CLASS_RE.search(fn.cls):
            entries.setdefault(key, f"loop:{fn.qual}")
    return entries, exempt


def _deadline_pass(graph: CallGraph, facts: dict, emit,
                   cov: dict) -> None:
    entries, exempt = _serving_entries(graph)
    closure: set = set(entries)
    parents: dict = {}
    frontier = list(entries)
    while frontier:
        key = frontier.pop()
        for cs in graph.functions[key].calls:
            if cs.kind != "intra" or cs.callee not in graph.functions:
                continue
            if cs.callee in closure:
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

    wait_sites = unbounded = 0
    for key in sorted(closure):
        fn = graph.functions[key]
        aware = _budget_aware(facts[key])
        for n, _d in facts[key].calls:
            hit = _wait_root(n)
            if hit is None:
                continue
            label, bounded = hit
            wait_sites += 1
            if bounded:
                continue
            unbounded += 1
            via = chain(key)
            if aware:
                emit("deadline-drop", fn.rel, f"{fn.qual}[{label}]",
                     f"function handles the deadline envelope but this "
                     f"{label} has no timeout ({via}) — the budget is "
                     f"dropped on the floor at the wait", n.lineno)
            else:
                emit("unbounded-wait", fn.rel, f"{fn.qual}[{label}]",
                     f"{label} with no timeout on a request-serving "
                     f"path ({via}) — one stuck wait pins the serving "
                     f"thread past every caller deadline", n.lineno)

    # Transport form of deadline-drop: a body that re-bases the
    # envelope (restamp_forward) and then forwards over the pool/rpc
    # transport without clipping the transport wait to the re-based
    # budget.  Package-wide: the conn-pool receiver is a dynamic
    # attribute chain, so closure membership can't see it.
    drops = 0
    for key in sorted(graph.functions):
        fn = graph.functions[key]
        ff = facts[key]
        if not any(d and d[-1] == "restamp_forward" for _n, d in ff.calls):
            continue
        for n, _d in ff.calls:
            if not isinstance(n.func, ast.Attribute) or \
                    n.func.attr != "call":
                continue
            recv = _recv_text(n).lower()
            if not ("pool" in recv or "rpc" in recv or "conn" in recv):
                continue
            if _kwarg(n, "timeout") is not None or len(n.args) >= 4:
                continue
            drops += 1
            emit("deadline-drop", fn.rel, f"{fn.qual}[forward]",
                 "forwarding hop re-bases the budget (restamp_forward) "
                 "but the transport call has no timeout= — the hop "
                 "waits the transport default, not the caller's "
                 "remaining envelope", n.lineno)

    cov["entries"] = len(entries)
    cov["entries_exempt_liveness"] = exempt
    cov["entry_closure"] = len(closure)
    cov["wait_sites"] = wait_sites
    cov["unbounded_waits"] = unbounded
    cov["transport_drops"] = drops


# -- pass 2 -------------------------------------------------------------------

def _registered_sites(graph: CallGraph) -> tuple:
    """``(ordered site names, rel, line)`` from the ``SITES = (...)``
    string-tuple assignment (a top-level module constant);
    ``([], None, 0)`` when absent."""
    for module, info in sorted(graph.modules.items()):
        for n in info.tree.body:
            if not (isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "SITES"
                    for t in n.targets)):
                continue
            if not isinstance(n.value, (ast.Tuple, ast.List)):
                continue
            elts = n.value.elts
            if elts and all(isinstance(e, ast.Constant) and
                            isinstance(e.value, str) for e in elts):
                rel = os.path.join(*module.split(".")) + ".py"
                return [e.value for e in elts], rel, n.lineno
    return [], None, 0


def _consults(ff: _FnFacts) -> set:
    """Site names this function consults (fire/fire_rpc with a literal
    site)."""
    out: set = set()
    for n, d in ff.calls:
        if d is None or d[-1] not in ("fire", "fire_rpc"):
            continue
        if n.args and isinstance(n.args[0], ast.Constant) and \
                isinstance(n.args[0].value, str):
            out.add(n.args[0].value)
    return out


def _io_roots(ff: _FnFacts) -> list:
    """``(kind, what, line)`` I/O boundary roots in the direct body."""
    roots: list = []
    for n, d in ff.calls:
        if isinstance(n.func, ast.Attribute):
            kind = _IO_METHOD_KINDS.get(n.func.attr)
            if kind is not None:
                roots.append((kind, f".{n.func.attr}()", n.lineno))
                continue
        if d is not None and len(d) >= 2:
            kind = _IO_EXTERNAL_KINDS.get(tuple(d[-2:]))
            if kind is not None:
                roots.append((kind, ".".join(d[-2:]) + "()", n.lineno))
    return roots


def _injectability_pass(graph: CallGraph, facts: dict, emit, cov: dict,
                        markers: dict, waived_sites: set) -> None:
    sites, sites_rel, sites_line = _registered_sites(graph)
    consults: dict = {k: _consults(ff) for k, ff in facts.items()}
    consults = {k: v for k, v in consults.items() if v}

    site_consults: dict = {s: 0 for s in sites}
    for v in consults.values():
        for s in v:
            if s in site_consults:
                site_consults[s] += 1
            else:
                site_consults[s] = site_consults.get(s, 0) + 1

    callers = _callers_map(graph, facts)
    callees: dict = {}
    for key, fn in graph.functions.items():
        for cs in fn.calls:
            if cs.kind == "intra" and cs.callee in graph.functions:
                callees.setdefault(key, set()).add(cs.callee)

    def reach(key: str, edges: dict) -> set:
        seen = {key}
        frontier = [key]
        while frontier:
            k = frontier.pop()
            for nxt in edges.get(k, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return seen

    boundaries: list = []
    covered = waived = 0
    for key in sorted(graph.functions):
        fn = graph.functions[key]
        roots = _io_roots(facts[key])
        if not roots:
            continue
        covered_by: Optional[str] = None
        own = consults.get(key)
        if own:
            covered_by = sorted(own)[0]
        else:
            related = reach(key, callers) | reach(key, callees)
            hits = sorted(s for k in related
                          for s in consults.get(k, ()))
            if hits:
                covered_by = hits[0]
        # One row (and at most one finding) per function+kind; the
        # first root line anchors it.
        seen_kinds: set = set()
        for kind, what, line in roots:
            if kind in seen_kinds:
                continue
            seen_kinds.add(kind)
            row_waived = covered_by is None and \
                _waived(markers, fn.rel, line, "uninjectable-io")
            boundaries.append({
                "function": fn.qual, "path": fn.rel, "line": line,
                "kind": kind, "root": what,
                "covered_by": covered_by, "waived": row_waived,
            })
            if covered_by is not None:
                covered += 1
                continue
            if row_waived:
                waived += 1
            emit("uninjectable-io", fn.rel, f"{fn.qual}[{kind}]",
                 f"{kind} boundary ({what}) with no consulted "
                 f"faultinject site on its call path — this edge's "
                 f"failure modes can never be rehearsed by a chaos "
                 f"plan", line)

    dead = []
    for s in sites:
        if site_consults.get(s, 0) == 0:
            dead.append(s)
            emit("dead-site", sites_rel or "", s,
                 f"fault site {s!r} is registered in SITES but no "
                 f"live code consults it — plans targeting it "
                 f"silently do nothing", sites_line)

    total = len(boundaries)
    cov["sites"] = {s: site_consults.get(s, 0) for s in sites}
    cov["dead_sites"] = dead
    cov["boundaries"] = boundaries
    cov["boundary_count"] = total
    cov["boundaries_covered"] = covered
    cov["boundaries_waived"] = waived
    cov["covered_fraction"] = (
        (covered + waived) / total if total else 1.0)


# -- pass 3 -------------------------------------------------------------------

def _resolve_closure_arg(graph: CallGraph, fn, call: ast.Call):
    """The FuncNode for the first argument of a RetryPolicy.call site:
    a local nested def or a ``self.method`` reference."""
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Name):
        key = f"{fn.key.split(':')[0]}:{fn.qual}.{arg.id}"
        return graph.functions.get(key)
    d = _dotted(arg)
    if d and len(d) == 2 and d[0] == "self":
        cls_node = graph.class_of(fn.key)
        if cls_node is not None:
            key = graph.resolve_method(cls_node.key, d[1])
            if key is not None:
                return graph.functions.get(key)
    return None


def _retry_call_sites(graph: CallGraph, fn, ff: _FnFacts) -> list:
    """Calls in ``fn`` that hand a closure to RetryPolicy.call: the
    resolved edge when the policy is a typed global/local, else the
    receiver-name heuristic (``*policy*``/``*retry*``)."""
    resolved_lines = {cs.line for cs in fn.calls
                      if cs.kind == "intra" and
                      cs.callee.endswith(":RetryPolicy.call")}
    out = []
    for n, _d in ff.calls:
        if not isinstance(n.func, ast.Attribute) or \
                n.func.attr != "call":
            continue
        recv = _recv_text(n).lower()
        if n.lineno in resolved_lines or \
                "policy" in recv or "retry" in recv:
            out.append(n)
    return out


def _closure_taint(closure_fn) -> list:
    """``(what, line)`` non-idempotent mutations in a retried closure."""
    node = closure_fn.node
    body_src = ast.unparse(node)
    if _FENCE_NAME_RE.search(body_src):
        return []        # fencing-token discipline present
    local_names: set = set()
    replaced: set = set()     # receivers with .clear() + .update()
    cleared: set = set()
    updated: set = set()
    for n in _direct_body(node):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    local_names.add(t.id)
        elif isinstance(n, ast.Call) and \
                isinstance(n.func, ast.Attribute):
            base = _recv_text(n)
            if n.func.attr == "clear":
                cleared.add(base)
            elif n.func.attr == "update":
                updated.add(base)
    replaced = cleared & updated
    taints: list = []
    for n in _direct_body(node):
        if isinstance(n, ast.AugAssign) and isinstance(n.op, ast.Add):
            if isinstance(n.target, ast.Name) and \
                    n.target.id in local_names:
                continue
            taints.append(("+= accumulation", n.lineno))
        elif isinstance(n, ast.Call) and \
                isinstance(n.func, ast.Attribute) and \
                n.func.attr in _ACCUM_METHODS:
            base = _recv_text(n)
            if base in replaced:
                continue
            root = base.split(".")[0].split("[")[0]
            if root in local_names:
                continue
            taints.append((f".{n.func.attr}() accumulation", n.lineno))
    return taints


def _sheds(facts: dict) -> set:
    """Functions that raise ErrOverloaded (a load-shed path)."""
    return {key for key, ff in facts.items() if ff.raises_overloaded}


def _retry_pass(graph: CallGraph, facts: dict, emit,
                cov: dict) -> None:
    closures = tainted = 0
    for key in sorted(graph.functions):
        fn = graph.functions[key]
        for call in _retry_call_sites(graph, fn, facts[key]):
            closure_fn = _resolve_closure_arg(graph, fn, call)
            if closure_fn is None:
                continue
            closures += 1
            for what, line in _closure_taint(closure_fn):
                tainted += 1
                emit("retry-unsafe", closure_fn.rel,
                     f"{closure_fn.qual}[{what.split()[0]}]",
                     f"closure retried by RetryPolicy.call mutates "
                     f"surviving state ({what}) with no fencing token "
                     f"and no newest-wins replacement — a retried "
                     f"attempt double-applies", line)

    # Shed discipline: the committed-state apply closure must never
    # reach ErrOverloaded.  Broker enqueues inside it need force=True;
    # resolved calls into shed-raising functions are flagged outright.
    sheds = _sheds(facts)
    roots = sorted(k for k, fn in graph.functions.items()
                   if _is_apply_root(fn))
    closure: set = set(roots)
    frontier = list(roots)
    while frontier:
        key = frontier.pop()
        for cs in graph.functions[key].calls:
            if cs.kind == "intra" and cs.callee in graph.functions \
                    and cs.callee not in closure:
                closure.add(cs.callee)
                frontier.append(cs.callee)
    shed_calls = 0
    for key in sorted(closure):
        fn = graph.functions[key]
        if key in sheds:
            continue        # the admission plane itself, not an applier
        resolved_shed_lines = {cs.line for cs in fn.calls
                               if cs.kind == "intra" and
                               cs.callee in sheds}
        for n, _d in facts[key].calls:
            if not isinstance(n.func, ast.Attribute):
                continue
            is_broker_enqueue = (n.func.attr == "enqueue" and
                                 "broker" in _recv_text(n).lower())
            if not is_broker_enqueue and \
                    n.lineno not in resolved_shed_lines:
                continue
            forced = _kwarg(n, "force")
            if forced is not None and \
                    isinstance(forced, ast.Constant) and \
                    forced.value is True:
                continue
            shed_calls += 1
            emit("retry-unsafe", fn.rel, f"{fn.qual}[shed-reachable]",
                 "committed-state applier reaches a load-shed path "
                 "without force=True — a replayed log entry could "
                 "raise ErrOverloaded and a committed write would be "
                 "lost", n.lineno)

    cov["retry_closures"] = closures
    cov["retry_tainted"] = tainted
    cov["shed_raisers"] = len(sheds)
    cov["apply_shed_calls"] = shed_calls


# -- entry --------------------------------------------------------------------

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

    facts = _prepass(graph)
    _deadline_pass(graph, facts, emit, cov)
    _injectability_pass(graph, facts, emit, cov, markers, waived_sites)
    _retry_pass(graph, facts, emit, cov)
    cov["waived"] = len(waived_sites)
    if coverage_out is not None:
        coverage_out.update(cov)
    return findings
