"""Interprocedural concurrency passes over the call graph.

Counterpart of ``nomad_tpu/analysis/blocking.py`` (the same rules and
keys); its device round trips add the port's (``_DEVICE_METHODS``,
``_TENSOR_SYNC_METHODS``).  Three passes, all riding ``callgraph.CallGraph`` + lockcheck's lock-site
naming (``Class.attr`` / ``module.NAME``), so one allowlist grammar
covers the whole analyzer family:

**blocking-under-lock** — a *blocking root* classification (``time.sleep``,
``Event.wait``/``Condition.wait``, ``Future.result``, blocking
``queue.get/put``, socket ops, subprocess waits, device
dispatch/collect, and the ``utils/retry.py`` sleep paths) is propagated
up the call graph to a ``may_block`` set, then intersected with each
function's held-lock regions: ``fn_a`` holding ``C._lock`` while calling
``fn_b → fn_c → sock.sendall`` is flagged with the full call chain.
``Condition.wait`` on the condition guarding the *innermost held* lock
is exempt (wait releases that lock); any other lock held across it still
flags.  Key grammar: ``blocking-under-lock:path:Qual[Site]``.

**cross-function lock-order** — interprocedurally-reachable acquisitions
(a transitive ``may_acquire`` fixpoint) feed the lock-order graph, so
cycles spanning modules (pipeline↔breaker, alloc_runner↔rpc) and
nested self-acquires three frames deep are detected statically, not just
by the runtime witness.  Cycles lockcheck's syntactic pass already
reports are suppressed here.  Key grammar: ``lock-cycle:path:a->b->a``
and ``nested-self-acquire:path:Qual->Site``.

**thread/future lifecycle** — every ``threading.Thread(...)`` creation
site must retain a joinable handle (``.join()`` reachable in the binding
scope), escape to a registry (returned / passed / appended), or carry a
justified allowlist line; ``Future``-shaped objects must reach a
``respond``/``set_result``/``set_exception`` in their binding scope; an
``Event`` someone waits on *untimed* must have a ``.set()`` reachable.
Key grammar: ``thread-leak:path:Qual.binding`` (same for
``future-leak`` / ``event-leak``).

A separate test-tree helper (``scan_test_sleeps``) flags fixed
``time.sleep(<const>)`` calls in test files that do not carry a
``# sleep-ok:`` justification comment — the wait-until conversion
ratchet.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Optional

from . import Finding
from .callgraph import CallGraph, _self_attr, _child_defs
from . import lockcheck

# -- blocking-root classification -------------------------------------------

# Attribute-call method names that block regardless of receiver type.
_ALWAYS_BLOCKING_METHODS = {
    "sendall": "socket send", "recv": "socket recv",
    "recvfrom": "socket recv", "accept": "socket accept",
    "connect": "socket connect", "wrap_socket": "TLS handshake",
    "communicate": "subprocess wait", "result": "Future.result",
    "wait": "blocking wait", "wait_for": "blocking wait",
}
# Device round-trips (the pipeline's dispatch/collect seam + jax sync),
# and the port's: the counted fetch, and a wait on the card
# (torch.cuda.synchronize, Event.synchronize, Stream.synchronize).
_DEVICE_METHODS = {
    "dispatch_device": "device dispatch",
    "collect_device": "device collect",
    "block_until_ready": "device sync",
    "fetch_host": "device fetch",
    "synchronize": "device sync",
}
# Tensor reads that wait for the card where a CUDA tensor reaches them
# (``_RegionVisitor._tensor_receiver`` says where one may).
_TENSOR_SYNC_METHODS = {
    "item": "device sync (.item())",
    "cpu": "device sync (.cpu())",
    "tolist": "device sync (.tolist())",
}
# Calls whose result is a tensor that may lie on the card.
_TENSOR_PRODUCERS = frozenset({
    "put_counted", "ensure_on_default", "_put", "gather", "upload",
    "to", "cuda", "contiguous",
})
# External (non-package) callables that block.
_BLOCKING_EXTERNALS = {
    "time.sleep": "time.sleep",
    "socket.create_connection": "socket dial",
    "select.select": "select",
    "subprocess.run": "subprocess", "subprocess.call": "subprocess",
    "subprocess.check_call": "subprocess",
    "subprocess.check_output": "subprocess",
}
_QUEUE_RECEIVER_RE = re.compile(r"(^|_)(q|queue|inq|outq|inbox|outbox)$")
_THREAD_RECEIVER_RE = re.compile(
    r"(thread|ticker|notifier|reader|drain|worker|repl)s?$")


def _kwarg(node: ast.Call, name: str):
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_false(expr) -> bool:
    return isinstance(expr, ast.Constant) and expr.value is False


class _Region:
    """Per-function record of held-lock context at every call site."""

    __slots__ = ("key", "qual", "rel", "roots", "calls", "acquires")

    def __init__(self, key: str, qual: str, rel: str) -> None:
        self.key = key
        self.qual = qual
        self.rel = rel
        # (held_sites_tuple, label, line, receiver_attr) — direct roots
        self.roots: list = []
        # (held_sites_tuple, callee_key, line, text) — resolved calls
        self.calls: list = []
        self.acquires: set = set()   # lock sites acquired directly


class _RegionVisitor(ast.NodeVisitor):
    """Walk ONE function body tracking the held-lock stack; record lock
    acquisitions, resolved intra-package calls, and direct blocking
    roots.  ``.acquire()/.release()`` calls on resolvable sites extend
    the held region to the end of the enclosing statement list (the
    try/finally and guarded-acquire patterns)."""

    def __init__(self, graph: CallGraph, pkg, info, cls_info,
                 region: _Region, fn_node) -> None:
        self.graph = graph
        self.pkg = pkg           # lockcheck._Package
        self.info = info         # callgraph.ModuleInfo
        self.cls_info = cls_info  # lockcheck._ClassInfo or None
        self.region = region
        self.fn_node = fn_node
        self.cls_key = None
        if cls_info is not None:
            self.cls_key = f"{cls_info.module}.{cls_info.name}"
        self.module = info.module
        self.stack: list = []
        self.local_types: dict = {}
        self.local_queues: set = set()   # locals holding queue objects
        self.local_bounded: set = set()  # ...with maxsize > 0
        self.local_tensors: set = set()  # locals a CUDA tensor may reach

    # -- lock-site naming (same rules as lockcheck._OrderVisitor) ----------
    def _site_of(self, expr: ast.expr) -> Optional[str]:
        if self.cls_info is not None:
            name = lockcheck._lock_name_of(self.cls_info, expr)
            if name:
                return f"{self.cls_info.name}.{name}"
        if isinstance(expr, ast.Name) and \
                expr.id in self.pkg.module_locks.get(self.module, ()):
            return f"{self.module}.{expr.id}"
        if isinstance(expr, ast.Attribute):
            owner_attr = _self_attr(expr.value)
            if owner_attr is not None and self.cls_info is not None:
                cls_name = self.cls_info.attr_types.get(owner_attr)
                if cls_name:
                    target = self.pkg.class_by_name(cls_name)
                    if target is not None:
                        alias = target.lock_aliases.get(expr.attr,
                                                        expr.attr)
                        if alias in target.locks:
                            return f"{target.name}.{alias}"
            if expr.attr == "lock" or expr.attr.endswith("_lock"):
                return f"?.{expr.attr}"
        return None

    def run(self) -> None:
        node = self.fn_node
        args = node.args
        for a in list(args.posonlyargs) + list(args.args) + \
                list(args.kwonlyargs):
            if a.annotation is not None:
                from .callgraph import _unquote
                hit = self.graph._class_key_of_expr(
                    self.info, _unquote(a.annotation))
                if hit is not None:
                    self.local_types[a.arg] = hit
        self._walk_body(node.body)

    # -- body walking with acquire()-extended regions ----------------------
    def _walk_body(self, body: list) -> None:
        pushed = 0
        for stmt in body:
            site = self._acquire_stmt_site(stmt)
            if site is not None:
                self._note_acquire(site, stmt.lineno)
                self.stack.append(site)
                pushed += 1
                continue
            if self._release_stmt_site(stmt) is not None and pushed:
                self.stack.pop()
                pushed -= 1
                continue
            self.visit(stmt)
        for _ in range(pushed):
            self.stack.pop()

    def _acquire_stmt_site(self, stmt) -> Optional[str]:
        """`x.acquire(...)` as a statement, `y = x.acquire(...)`, or the
        `if not x.acquire(blocking=False): return` guard — the held
        region runs to the end of the enclosing block."""
        call = None
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
        elif isinstance(stmt, ast.Assign) and \
                isinstance(stmt.value, ast.Call):
            call = stmt.value
        elif isinstance(stmt, ast.If) and \
                isinstance(stmt.test, ast.UnaryOp) and \
                isinstance(stmt.test.op, ast.Not) and \
                isinstance(stmt.test.operand, ast.Call):
            inner = stmt.test.operand
            if self._is_acquire(inner) and self._body_exits(stmt.body):
                # Failure arm runs WITHOUT the lock; an else arm (and
                # everything after the If, handled by the caller) runs
                # WITH it.
                self._walk_body(stmt.body)
                site = self._site_of(inner.func.value) or "?.acquire"
                if stmt.orelse:
                    self.stack.append(site)
                    self._walk_body(stmt.orelse)
                    self.stack.pop()
                return site
            return None
        if call is not None and self._is_acquire(call):
            return self._site_of(call.func.value) or "?.acquire"
        return None

    @staticmethod
    def _is_acquire(call: ast.Call) -> bool:
        return isinstance(call.func, ast.Attribute) and \
            call.func.attr == "acquire"

    def _release_stmt_site(self, stmt) -> Optional[str]:
        if isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Call) and \
                isinstance(stmt.value.func, ast.Attribute) and \
                stmt.value.func.attr == "release":
            return self._site_of(stmt.value.func.value) or "?.release"
        return None

    @staticmethod
    def _body_exits(body: list) -> bool:
        return bool(body) and isinstance(
            body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))

    def _note_acquire(self, site: str, line: int) -> None:
        self.region.acquires.add(site)
        if self.stack:
            self.region.calls.append(
                (tuple(self.stack), None, line, f"acquire {site}"))

    def visit_With(self, node: ast.With) -> None:
        sites = []
        for item in node.items:
            site = self._site_of(item.context_expr)
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
            if site is not None:
                self.region.acquires.add(site)
                self.stack.append(site)
                sites.append(site)
        self._walk_body(node.body)
        for _ in sites:
            self.stack.pop()

    # Nested defs / lambdas run elsewhere: not this function's context.
    def visit_FunctionDef(self, node) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node) -> None:
        pass

    def visit_If(self, node: ast.If) -> None:
        self.visit(node.test)
        self._walk_body(node.body)
        self._walk_body(node.orelse)

    def visit_Try(self, node: ast.Try) -> None:
        self._walk_body(node.body)
        for handler in node.handlers:
            self._walk_body(handler.body)
        self._walk_body(node.orelse)
        self._walk_body(node.finalbody)

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.iter)
        self._walk_body(node.body)
        self._walk_body(node.orelse)

    def visit_While(self, node: ast.While) -> None:
        self.visit(node.test)
        self._walk_body(node.body)
        self._walk_body(node.orelse)

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Call):
            hit = self.graph._class_key_of_expr(self.info,
                                                node.value.func)
            text = ""
            try:
                text = ast.unparse(node.value.func)
            except Exception:
                pass
            tensor = self._tensor_call(node.value)
            for tgt in node.targets:
                if tensor:
                    for el in (tgt.elts if isinstance(
                            tgt, (ast.Tuple, ast.List)) else (tgt,)):
                        if isinstance(el, ast.Name):
                            self.local_tensors.add(el.id)
                if not isinstance(tgt, ast.Name):
                    continue
                if hit is not None:
                    self.local_types[tgt.id] = hit
                if text.endswith("Queue") or text == "queue.Queue":
                    self.local_queues.add(tgt.id)
                    call = node.value
                    arg = call.args[0] if call.args else _kwarg(
                        call, "maxsize")
                    if arg is not None and not \
                            lockcheck.queue_maxsize_unbounded(arg):
                        self.local_bounded.add(tgt.id)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        label = self._root_label(node)
        held = tuple(self.stack)
        if label is not None:
            recv = None
            fn = node.func
            if isinstance(fn, ast.Attribute):
                recv = _self_attr(fn.value)
            self.region.roots.append((held, label, node.lineno, recv))
        else:
            callee, kind = self.graph.resolve_call(
                self.info, self.cls_key, self.local_types, node.func)
            if kind == "intra":
                text = ""
                try:
                    text = ast.unparse(node.func)
                except Exception:
                    pass
                self.region.calls.append((held, callee, node.lineno,
                                          text))
        self.generic_visit(node)

    # -- root classification ------------------------------------------------
    def _root_label(self, node: ast.Call) -> Optional[str]:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            meth = fn.attr
            if meth in _DEVICE_METHODS:
                return _DEVICE_METHODS[meth]
            if meth in _TENSOR_SYNC_METHODS and \
                    self._tensor_receiver(fn.value):
                return _TENSOR_SYNC_METHODS[meth]
            if meth in _ALWAYS_BLOCKING_METHODS:
                return _ALWAYS_BLOCKING_METHODS[meth]
            if meth == "sleep":
                owner = fn.value
                if isinstance(owner, ast.Name) and \
                        owner.id in ("time", "_time"):
                    return "time.sleep"
                # Backoff.sleep et al resolve through the call graph.
                return None
            if meth == "join":
                if self._receiver_is_thread(fn.value):
                    return "Thread.join"
                return None
            if meth in ("get", "put"):
                if _is_false(_kwarg(node, "block")):
                    return None
                if not self._receiver_is_queue(fn.value):
                    return None
                if meth == "put" and not self._receiver_is_bounded(
                        fn.value):
                    # put() on an unbounded queue never blocks; only
                    # known-bounded queues are roots (documented
                    # under-approximation).
                    return None
                return f"queue.{meth}"
            if meth == "acquire":
                if _is_false(_kwarg(node, "blocking")):
                    return None
                if self._site_of(fn.value) is None:
                    return "blocking acquire"
                return None  # resolvable site: order pass owns it
            return None
        # plain-name / external calls
        callee, kind = self.graph.resolve_call(
            self.info, self.cls_key, self.local_types, fn)
        if kind == "external" and callee in _BLOCKING_EXTERNALS:
            return _BLOCKING_EXTERNALS[callee]
        return None

    @staticmethod
    def _tensor_call(call: ast.Call) -> bool:
        """A ``torch.*`` call, or a placement/move whose result is a
        tensor that may lie on the card."""
        fn = call.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in _TENSOR_PRODUCERS:
                return True
            root = fn.value
            while isinstance(root, ast.Attribute):
                root = root.value
            return isinstance(root, ast.Name) and root.id == "torch"
        return isinstance(fn, ast.Name) and fn.id in _TENSOR_PRODUCERS

    def _tensor_receiver(self, owner: ast.expr) -> bool:
        """May a CUDA tensor reach this receiver?  A torch call or a
        move, a local bound from one, or a name in the port's device
        spelling (``*_d``)."""
        while isinstance(owner, ast.Subscript):
            owner = owner.value
        if isinstance(owner, ast.Call):
            # t.sum().item(): a method of a tensor gives a tensor
            return self._tensor_call(owner) or (
                isinstance(owner.func, ast.Attribute) and
                self._tensor_receiver(owner.func.value))
        name = owner.id if isinstance(owner, ast.Name) else (
            owner.attr if isinstance(owner, ast.Attribute) else None)
        if name is None:
            return False
        return name in self.local_tensors or name.endswith("_d")

    def _receiver_is_queue(self, owner: ast.expr) -> bool:
        attr = _self_attr(owner)
        if attr is not None:
            if self.cls_info is not None and attr in \
                    self.cls_info.sync_safe:
                return True
            return bool(_QUEUE_RECEIVER_RE.search(attr))
        if isinstance(owner, ast.Name):
            if owner.id in self.local_queues:
                return True
            return bool(_QUEUE_RECEIVER_RE.search(owner.id))
        if isinstance(owner, ast.Attribute):
            return bool(_QUEUE_RECEIVER_RE.search(owner.attr))
        return False

    def _receiver_is_bounded(self, owner: ast.expr) -> bool:
        attr = _self_attr(owner)
        if attr is not None and self.cls_info is not None:
            return attr in self.cls_info.bounded_queues
        if isinstance(owner, ast.Name):
            return owner.id in self.local_bounded
        return False

    def _receiver_is_thread(self, owner: ast.expr) -> bool:
        attr = _self_attr(owner)
        name = attr if attr is not None else (
            owner.id if isinstance(owner, ast.Name) else (
                owner.attr if isinstance(owner, ast.Attribute) else None))
        if name is None:
            return False
        if name in ("t", "tr", "thread"):
            return True
        return bool(_THREAD_RECEIVER_RE.search(name))


# ---------------------------------------------------------------------------
# pass drivers
# ---------------------------------------------------------------------------

def _build_regions(graph: CallGraph, pkg) -> dict:
    cls_infos = {}
    for info in pkg.classes:
        cls_infos[(info.module, info.name)] = info
    regions: dict = {}
    for key, fn in graph.functions.items():
        info = graph.modules.get(fn.module)
        if info is None:
            continue
        cls_info = cls_infos.get((fn.module, fn.cls)) if fn.cls else None
        region = _Region(key, fn.qual, fn.rel)
        _RegionVisitor(graph, pkg, info, cls_info, region,
                       fn.node).run()
        regions[key] = region
    return regions


def _may_block(regions: dict) -> dict:
    """key -> chain: [(description, rel, line), ...] ending at a root."""
    chains: dict = {}
    for key, region in regions.items():
        if region.roots:
            held, label, line, _recv = region.roots[0]
            chains[key] = [(label, region.rel, line)]
    changed = True
    while changed:
        changed = False
        for key, region in regions.items():
            for _held, callee, line, text in region.calls:
                if callee is None or callee not in chains:
                    continue
                cand = [(text or callee, region.rel, line)] + \
                    chains[callee]
                if key not in chains or len(cand) < len(chains[key]):
                    chains[key] = cand
                    changed = True
    return chains


def _may_acquire(regions: dict) -> dict:
    acq = {key: set(r.acquires) for key, r in regions.items()}
    changed = True
    while changed:
        changed = False
        for key, region in regions.items():
            mine = acq[key]
            for _held, callee, _line, _text in region.calls:
                if callee is None:
                    continue
                extra = acq.get(callee)
                if extra and not extra <= mine:
                    mine |= extra
                    changed = True
    return acq


def _cond_alias_exempt(pkg, region: _Region, graph: CallGraph,
                       recv: Optional[str], innermost: str) -> bool:
    """A ``.wait()`` on the Condition guarding the innermost held lock
    releases that lock while waiting — not a blocking-under-lock."""
    if recv is None or "." not in innermost:
        return False
    cls_name, lock_attr = innermost.split(".", 1)
    for info in pkg.classes:
        if info.name != cls_name:
            continue
        resolved = info.lock_aliases.get(recv, recv)
        if resolved == lock_attr:
            return True
    return False


def _chain_text(chain: list) -> str:
    return " -> ".join(step[0] for step in chain)


def blocking_under_lock(graph: CallGraph, pkg, regions: dict,
                        chains: dict) -> list:
    findings: list = []
    seen: set = set()
    for key, region in regions.items():
        for held, label, line, recv in region.roots:
            if not held:
                continue
            innermost = held[-1]
            if label == "blocking wait" and _cond_alias_exempt(
                    pkg, region, graph, recv, innermost):
                continue
            fkey = (region.qual, innermost, label)
            if fkey in seen:
                continue
            seen.add(fkey)
            findings.append(Finding(
                "blocking-under-lock", region.rel,
                f"{region.qual}[{innermost}]",
                f"holds {innermost} across {label}", line))
        for held, callee, line, text in region.calls:
            if not held or callee is None:
                continue
            chain = chains.get(callee)
            if chain is None:
                continue
            innermost = held[-1]
            fkey = (region.qual, innermost, callee)
            if fkey in seen:
                continue
            seen.add(fkey)
            findings.append(Finding(
                "blocking-under-lock", region.rel,
                f"{region.qual}[{innermost}]",
                f"holds {innermost} across a call chain that blocks: "
                f"{text or callee} -> {_chain_text(chain)}", line))
    return findings


def cross_function_lock_order(graph: CallGraph, pkg, regions: dict,
                              acq: dict) -> list:
    findings: list = []
    kind_of: dict = {}
    for info in pkg.classes:
        for attr, kind in info.locks.items():
            kind_of[f"{info.name}.{attr}"] = kind
    for module, locks in pkg.module_locks.items():
        for name, kind in locks.items():
            kind_of[f"{module}.{name}"] = kind

    edges: dict = {}
    self_edges: dict = {}
    for key, region in regions.items():
        for held, callee, line, text in region.calls:
            if not held or callee is None:
                continue
            outer = held[-1]
            for inner in acq.get(callee, ()):
                if inner in held:
                    if inner == outer:
                        self_edges.setdefault(
                            inner, (region, callee, line, text))
                    continue
                edges.setdefault((outer, inner),
                                 (region, callee, line, text))

    for site, (region, callee, line, text) in sorted(self_edges.items()):
        if kind_of.get(site) != "Lock":
            continue
        if site in pkg.self_sites:
            continue  # lockcheck's syntactic pass already reported it
        callee_fn = graph.functions.get(callee)
        callee_q = callee_fn.qual if callee_fn else callee
        findings.append(Finding(
            "nested-self-acquire", region.rel,
            f"{region.qual}->{callee_q}",
            f"non-reentrant {site} held while calling {text or callee_q},"
            f" which may re-acquire it (deadlock if the instances "
            "coincide)", line))

    order_graph: dict = {}
    for (a, b), meta in edges.items():
        order_graph.setdefault(a, {})[b] = meta
    for cycle in lockcheck.find_cycles(order_graph):
        if frozenset(cycle) in pkg.cycle_sets:
            continue  # already reported by the syntactic pass
        region, callee, line, text = order_graph[cycle[0]][cycle[1]]
        findings.append(Finding(
            "lock-cycle", region.rel,
            "->".join(cycle + (cycle[0],)),
            f"interprocedural lock-order cycle (witness: {region.qual} "
            f"-> {text or callee})", line))
    return findings


# ---------------------------------------------------------------------------
# thread/future/event lifecycle
# ---------------------------------------------------------------------------

_RESOLVING_METHODS = {"respond", "set_result", "set_exception", "cancel"}


def _calls_method_on(tree, binding: str, methods: set) -> bool:
    """Does any ``<binding>.m(...)`` / ``self.<binding>.m(...)`` with m in
    ``methods`` appear under ``tree``?"""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and
                isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr not in methods:
            continue
        owner = node.func.value
        name = _self_attr(owner)
        if name is None and isinstance(owner, ast.Name):
            name = owner.id
        if name is None and isinstance(owner, ast.Attribute):
            name = owner.attr
        if name == binding:
            return True
    return False


def _escapes(fn_node, binding: str, creation: ast.Call) -> bool:
    """The local handle leaves the function: returned, yielded, passed as
    a call argument, stored on an attribute/container, or put in a
    collection literal — somebody else owns its lifecycle then."""
    for node in ast.walk(fn_node):
        if isinstance(node, (ast.Return, ast.Yield)) and \
                node.value is not None:
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name) and sub.id == binding:
                    return True
        elif isinstance(node, ast.Call):
            for arg in list(node.args) + [kw.value
                                          for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Name) and sub.id == binding:
                        # a `binding.start()` receiver doesn't count,
                        # but `x.append(binding)` / `f(binding)` does
                        return True
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if not isinstance(tgt, ast.Name):
                    if isinstance(node.value, ast.Name) and \
                            node.value.id == binding:
                        return True
            for sub in ast.walk(node.value):
                if sub is not node.value and isinstance(sub, ast.Name) \
                        and sub.id == binding:
                    if isinstance(node.value, (ast.Dict, ast.List,
                                               ast.Tuple, ast.Set)):
                        return True
    return False


def _creation_kind(graph: CallGraph, info, cls_key, local_types,
                   call: ast.Call) -> Optional[str]:
    """'thread' | 'event' | 'future' for a creation call, else None."""
    callee, kind = graph.resolve_call(info, cls_key, local_types,
                                     call.func)
    if kind == "external":
        if callee in ("threading.Thread",):
            return "thread"
        if callee == "threading.Event":
            return "event"
        if callee in ("concurrent.futures.Future", "futures.Future"):
            return "future"
    if kind == "intra" and isinstance(callee, str) and \
            callee.endswith(".__init__"):
        cls_name = callee.rsplit(":", 1)[-1].split(".")[0]
        if cls_name.endswith("Future"):
            return "future"
    # Unresolved bare names still count when unambiguous.
    fn = call.func
    if isinstance(fn, ast.Name):
        if fn.id == "Thread":
            return "thread"
        if fn.id == "Event":
            return "event"
    if isinstance(fn, ast.Attribute) and fn.attr in ("Thread", "Event") \
            and isinstance(fn.value, ast.Name) and \
            fn.value.id == "threading":
        return {"Thread": "thread", "Event": "event"}[fn.attr]
    return None


def lifecycle(graph: CallGraph, pkg) -> list:
    findings: list = []
    cls_nodes = {}  # class key -> ClassDef node (search scope for attrs)
    for ckey, cnode in graph.classes.items():
        cls_nodes[ckey] = cnode.node

    for key, fn in graph.functions.items():
        info = graph.modules.get(fn.module)
        if info is None:
            continue
        cls_key = f"{fn.module}.{fn.cls}" if fn.cls else None
        scope_node = cls_nodes.get(cls_key, info.tree)
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            kind = _creation_kind(graph, info, cls_key, {}, node)
            if kind is None:
                continue
            binding, attr_bound, anonymous = _binding_of(fn.node, node)
            if kind == "thread":
                f = _check_thread(fn, scope_node, node, binding,
                                  attr_bound, anonymous)
            elif kind == "future":
                f = _check_future(fn, scope_node, node, binding,
                                  attr_bound, anonymous)
            else:
                f = _check_event(fn, scope_node, node, binding,
                                 attr_bound, anonymous)
            if f is not None:
                findings.append(f)
    return findings


def _binding_of(fn_node, creation: ast.Call):
    """(name, bound_to_self_attr, anonymous) for a creation call."""
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign) and node.value is creation:
            tgt = node.targets[0]
            attr = _self_attr(tgt)
            if attr is not None:
                return attr, True, False
            if isinstance(tgt, ast.Name):
                return tgt.id, False, False
            return None, False, False
        if isinstance(node, ast.AnnAssign) and node.value is creation:
            attr = _self_attr(node.target)
            if attr is not None:
                return attr, True, False
            if isinstance(node.target, ast.Name):
                return node.target.id, False, False
    # `threading.Thread(...).start()` or passed straight to a call
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Attribute) and node.value is creation:
            return None, False, True        # immediate method call
        if isinstance(node, ast.Call) and creation in node.args:
            return None, False, False       # passed: escapes
        if isinstance(node, (ast.Dict, ast.List, ast.Tuple)) and \
                any(el is creation for el in ast.walk(node)
                    if el is not node):
            return None, False, False
        if isinstance(node, ast.Return) and node.value is creation:
            return None, False, False
    return None, False, False


def _check_thread(fn, scope_node, creation, binding, attr_bound,
                  anonymous) -> Optional[Finding]:
    if anonymous:
        return Finding(
            "thread-leak", fn.rel, f"{fn.qual}.<anonymous>",
            "Thread started without retaining a handle: nothing can "
            "ever join it or observe its death", creation.lineno)
    if binding is None:
        return None  # escapes (passed/returned/collected)
    if attr_bound:
        if _calls_method_on(scope_node, binding, {"join"}):
            return None
        return Finding(
            "thread-leak", fn.rel, f"{fn.qual}.{binding}",
            f"Thread handle self.{binding} is never joined anywhere in "
            "its class: shutdown cannot wait it out", creation.lineno)
    if _calls_method_on(fn.node, binding, {"join"}) or \
            _escapes(fn.node, binding, creation):
        return None
    return Finding(
        "thread-leak", fn.rel, f"{fn.qual}.{binding}",
        f"Thread handle {binding!r} neither joined nor handed off "
        "before going out of scope", creation.lineno)


def _check_future(fn, scope_node, creation, binding, attr_bound,
                  anonymous) -> Optional[Finding]:
    if binding is None:
        return None  # escapes: consumer owns resolution
    scope = scope_node if attr_bound else fn.node
    if _calls_method_on(scope, binding, _RESOLVING_METHODS):
        return None
    if not attr_bound and _escapes(fn.node, binding, creation):
        return None
    where = f"self.{binding}" if attr_bound else repr(binding)
    return Finding(
        "future-leak", fn.rel, f"{fn.qual}.{binding}",
        f"future {where} is created but no "
        "respond/set_result/set_exception is reachable in its scope: "
        "a waiter would pend forever", creation.lineno)


def _check_event(fn, scope_node, creation, binding, attr_bound,
                 anonymous) -> Optional[Finding]:
    if binding is None:
        return None
    scope = scope_node if attr_bound else fn.node
    # Only events someone waits on UNTIMED can pend forever.
    untimed = False
    for node in ast.walk(scope):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "wait" and not node.args and \
                not node.keywords:
            owner = node.func.value
            name = _self_attr(owner) or (
                owner.id if isinstance(owner, ast.Name) else None)
            if name == binding:
                untimed = True
                break
    if not untimed:
        return None
    if _calls_method_on(scope, binding, {"set"}):
        return None
    if not attr_bound and _escapes(fn.node, binding, creation):
        return None
    return Finding(
        "event-leak", fn.rel, f"{fn.qual}.{binding}",
        f"event {binding!r} is waited on without a timeout but no "
        ".set() is reachable in its scope", creation.lineno)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def analyze_package(package_dir: str, graph: Optional[CallGraph] = None,
                    scan=None) -> list:
    """Run the three interprocedural passes.  ``scan`` is lockcheck's
    ``scan_package`` result (run lockcheck.analyze_package on it FIRST so
    its syntactic cycles are known and not double-reported)."""
    if graph is None:
        graph = CallGraph.build(package_dir)
    pkg, _trees, err = scan or lockcheck.scan_package(package_dir)
    if err is not None:
        return []  # lockcheck already reports the parse error
    regions = _build_regions(graph, pkg)
    chains = _may_block(regions)
    acq = _may_acquire(regions)
    findings: list = []
    findings.extend(blocking_under_lock(graph, pkg, regions, chains))
    findings.extend(cross_function_lock_order(graph, pkg, regions, acq))
    findings.extend(lifecycle(graph, pkg))
    return findings


# ---------------------------------------------------------------------------
# test-tree mode: the fixed-sleep ratchet
# ---------------------------------------------------------------------------

def scan_test_sleeps(tests_dir: str) -> list:
    """Flag ``time.sleep(<constant>)`` in test files.  A fixed sleep is
    either a disguised wait (convert to ``wait_until``) or an intentional
    race-window/pacing sleep — the latter carries a ``# sleep-ok: why``
    comment on the same line and is skipped.  Advisory severity; the
    tier-1 gate bounds the count so it ratchets down, not up."""
    findings: list = []
    for root, dirs, files in os.walk(tests_dir):
        dirs[:] = sorted(d for d in dirs if not d.startswith("__pycache"))
        for fname in sorted(files):
            if not (fname.startswith("test_") or fname == "conftest.py") \
                    or not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            with open(path) as fh:
                source = fh.read()
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError:
                continue
            lines = source.splitlines()
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and
                        isinstance(node.func, ast.Attribute) and
                        node.func.attr == "sleep" and
                        isinstance(node.func.value, ast.Name) and
                        node.func.value.id in ("time", "_time")):
                    continue
                if not (node.args and isinstance(node.args[0],
                                                 ast.Constant)):
                    continue
                line_text = lines[node.lineno - 1] if \
                    node.lineno <= len(lines) else ""
                if "sleep-ok:" in line_text:
                    continue
                findings.append(Finding(
                    "fixed-sleep", os.path.join(
                        os.path.basename(tests_dir.rstrip(os.sep)),
                        os.path.relpath(path, tests_dir)),
                    f"{fname}:{node.lineno}",
                    f"fixed time.sleep({ast.unparse(node.args[0])}) in a "
                    "test: convert to wait_until or justify with "
                    "'# sleep-ok: <why>'", node.lineno,
                    severity="info"))
    return findings
