"""Lock-discipline analyzer: the `-race` + `go vet -copylocks` analogue.

Counterpart of ``nomad_tpu/analysis/lockcheck.py`` (the same rules and
keys).

Two passes over the package AST:

1. **Guarded-attribute discipline.**  Per class, every ``self.X =
   threading.Lock()/RLock()/Condition()`` marks ``X`` as a lock.  Every
   other ``self.attr`` access in the class's methods is classified by
   whether it happens inside a ``with self.<lock>:`` region.  An attribute
   with at least one lock-guarded access is *guarded state*; mutating it
   outside any lock (outside ``__init__``, which runs before the object
   is published) is the classic data race the Go race detector exists to
   catch — reported as ``bare-write``.  ``strict`` mode also reports bare
   *reads* of guarded state (``bare-read``, advisory: on CPython many are
   benign snapshot reads, but each deserves a reviewed justification).

2. **Lock-order graph.**  Nested acquisitions — syntactic ``with`` nesting
   plus one level of call-graph propagation (self-methods, module
   functions, and attributes whose type is inferrable from ``self.attr =
   ClassName(...)`` in ``__init__``) — build a directed graph over lock
   *sites* (``Class.attr`` / ``module.NAME``).  Cycles are deadlock risks
   (``lock-cycle``); a nested re-acquisition of the same plain-``Lock``
   site is an instant self-deadlock when both frames hit one instance
   (``nested-self-acquire``).

Module-level locks (``_lock = threading.Lock()``) participate in both
passes; guarded module globals are classified the same way.
"""
from __future__ import annotations

import ast
import os
from typing import Optional

from . import Finding

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

# Method calls that mutate their receiver in place.
MUTATOR_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "add", "discard", "update", "setdefault", "sort", "reverse",
    "appendleft", "popleft", "set", "cancel", "put", "get_nowait",
}
# Receiver-mutating calls that are themselves synchronization points or
# thread-safe by contract: not evidence of guarded state.
SYNC_SAFE_METHODS = {"set", "cancel", "wait", "notify", "notify_all",
                     "acquire", "release", "join", "start", "is_set"}
# Constructors whose instances are internally synchronized — attributes
# holding one are exempt from the discipline pass entirely.  deque
# qualifies for its atomic append/pop ends (the outbox/work-list
# pattern); cross-end iteration still deserves a lock, which the pass
# cannot distinguish, so that risk is accepted here.
THREADSAFE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
                    "Event", "Semaphore", "BoundedSemaphore", "Barrier",
                    "local", "deque"}


def queue_maxsize_unbounded(arg: ast.expr) -> bool:
    """stdlib Queue semantics: any literal maxsize <= 0 (0, -1) means
    unbounded.  Negative literals parse as UnaryOp(USub, Constant)."""
    if isinstance(arg, ast.UnaryOp) and isinstance(arg.op, ast.USub) \
            and isinstance(arg.operand, ast.Constant) and \
            isinstance(arg.operand.value, (int, float)):
        return True  # any negative literal
    return isinstance(arg, ast.Constant) and \
        isinstance(arg.value, (int, float)) and arg.value <= 0


def _is_lock_ctor(node: ast.expr) -> Optional[str]:
    """threading.Lock() / Lock() / threading.Condition(x) -> kind."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = None
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "threading":
        name = fn.attr
    elif isinstance(fn, ast.Name):
        name = fn.id
    return name if name in LOCK_FACTORIES else None


def _self_attr(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _ClassInfo:
    def __init__(self, module: str, path: str, node: ast.ClassDef) -> None:
        self.module = module
        self.path = path
        self.node = node
        self.name = node.name
        self.locks: dict = {}        # attr -> kind (Lock/RLock/Condition)
        self.lock_aliases: dict = {} # property name -> lock attr
        self.sync_safe: set = set()  # attrs holding Queue/Event/... objects
        self.bounded_queues: set = set()  # Queue attrs with maxsize > 0
        self.attr_types: dict = {}   # attr -> ClassName (from __init__)
        self.methods: dict = {}      # name -> FunctionDef
        # Typed concurrency annotations (utils/sync.py):
        # Immutable attrs are bound once pre-publication (bare reads fine,
        # ANY later write is a finding); CopySwap attrs are atomically
        # rebound under a lock (bare reads fine, writes must stay locked).
        self.immutable: set = set()
        self.copy_swap: set = set()
        # attr -> [guarded_reads, guarded_writes, bare_reads, bare_writes]
        self.access: dict = {}
        self.first_access: dict = {} # (attr, kind) -> (method, line)


def _marker_of(ann: Optional[ast.expr]) -> Optional[str]:
    """The sync-annotation marker named by an annotation expression:
    ``Immutable`` / ``CopySwap``, bare, subscripted (``Immutable[str]``),
    dotted (``sync.Immutable``), or stringified by
    ``from __future__ import annotations``."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, ast.Subscript):
        ann = ann.value
    name = None
    if isinstance(ann, ast.Attribute):
        name = ann.attr
    elif isinstance(ann, ast.Name):
        name = ann.id
    return name if name in ("Immutable", "CopySwap") else None


def _scan_class(info: _ClassInfo) -> None:
    """Find lock attrs, lock-returning properties, and attr types."""
    for item in info.node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.methods[item.name] = item
        elif isinstance(item, ast.AnnAssign) and \
                isinstance(item.target, ast.Name):
            # Class-body declaration: `addr: Immutable`
            marker = _marker_of(item.annotation)
            if marker == "Immutable":
                info.immutable.add(item.target.id)
            elif marker == "CopySwap":
                info.copy_swap.add(item.target.id)
    for meth in info.methods.values():
        for node in ast.walk(meth):
            targets = value = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign):
                marker = _marker_of(node.annotation)
                attr = _self_attr(node.target)
                if marker and attr:
                    (info.immutable if marker == "Immutable"
                     else info.copy_swap).add(attr)
                if node.value is None:
                    continue
                targets, value = [node.target], node.value
            if targets is None:
                continue
            kind = _is_lock_ctor(value)
            ctor = None
            if isinstance(value, ast.Call):
                if isinstance(value.func, ast.Name):
                    ctor = value.func.id
                elif isinstance(value.func, ast.Attribute):
                    ctor = value.func.attr
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                if kind:
                    info.locks[attr] = kind
                elif ctor in THREADSAFE_CTORS:
                    info.sync_safe.add(attr)
                    if ctor.endswith("Queue") and (
                            value.args or any(
                                kw.arg == "maxsize"
                                for kw in value.keywords)):
                        # A variable maxsize must be assumed bounded.
                        arg = value.args[0] if value.args else next(
                            kw.value for kw in value.keywords
                            if kw.arg == "maxsize")
                        if not queue_maxsize_unbounded(arg):
                            info.bounded_queues.add(attr)
                elif isinstance(value, ast.Call) and \
                        isinstance(value.func, ast.Name):
                    info.attr_types[attr] = value.func.id
    # Conditions wrap their lock: Condition(self._lock) aliases both names
    # to one witness site so `with self._cond` guards `_lock` state too.
    for meth in info.methods.values():
        for node in ast.walk(meth):
            if isinstance(node, ast.Assign) and \
                    _is_lock_ctor(node.value) == "Condition" and \
                    node.value.args:
                inner = _self_attr(node.value.args[0])
                outer = _self_attr(node.targets[0])
                if inner and outer and inner in info.locks:
                    info.lock_aliases[outer] = inner
    # Properties returning a lock: `with obj.lock:` == `with obj._lock:`.
    for name, meth in info.methods.items():
        deco = {d.id for d in meth.decorator_list
                if isinstance(d, ast.Name)}
        if "property" not in deco:
            continue
        for stmt in meth.body:
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                attr = _self_attr(stmt.value)
                if attr in info.locks:
                    info.lock_aliases[name] = attr


def _lock_name_of(info: _ClassInfo, expr: ast.expr) -> Optional[str]:
    """The class lock attr acquired by `with <expr>:`, if any."""
    attr = _self_attr(expr)
    if attr is None:
        return None
    attr = info.lock_aliases.get(attr, attr)
    return attr if attr in info.locks else None


class _MethodVisitor(ast.NodeVisitor):
    """Record every self.attr access in one method with its syntactic
    lock context, plus intra-class call sites (for held-on-entry
    inference)."""

    def __init__(self, info: _ClassInfo, method: str) -> None:
        self.info = info
        self.method = method
        self.depth = 0          # with-lock nesting depth
        self.accesses: list = []  # (attr, write, locked_here, line, rebind)
        self.self_calls: list = []  # (callee, locked_here)

    def _record(self, attr: str, write: bool, line: int,
                rebind: bool = True) -> None:
        """``rebind`` distinguishes true rebinding (``self.x = ...``)
        from receiver mutation (``self.x.append(...)``): both are writes
        for the discipline pass, but only rebinding violates an
        ``Immutable`` annotation."""
        info = self.info
        if attr in info.locks or attr in info.lock_aliases or \
                attr in info.methods or attr in info.sync_safe:
            return
        self.accesses.append((attr, write, self.depth > 0, line,
                              rebind and write))

    # -- lock regions ------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        acquired = sum(1 for item in node.items
                       if _lock_name_of(self.info, item.context_expr))
        self.depth += acquired
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        self.depth -= acquired

    # -- accesses ----------------------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._target(tgt)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._target(node.target, aug=True)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._target(node.target)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            self._target(tgt)

    def _target(self, tgt: ast.expr, aug: bool = False) -> None:
        attr = _self_attr(tgt)
        if attr is not None:
            self._record(attr, True, tgt.lineno)
            if aug:
                self._record(attr, False, tgt.lineno)
            return
        if isinstance(tgt, ast.Subscript):
            attr = _self_attr(tgt.value)
            if attr is not None:
                self._record(attr, True, tgt.lineno)
                self.visit(tgt.slice)
                return
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._target(el)
            return
        self.visit(tgt)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        # self.method(...) — a call site for held-on-entry inference.
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and fn.value.id == "self" \
                and fn.attr in self.info.methods:
            self.self_calls.append((fn.attr, self.depth > 0))
            for arg in node.args:
                self.visit(arg)
            for kw in node.keywords:
                self.visit(kw.value)
            return
        # self.attr.mutator(...) counts as a write to self.attr.
        if isinstance(fn, ast.Attribute):
            attr = _self_attr(fn.value)
            if attr is not None:
                if fn.attr in MUTATOR_METHODS and \
                        fn.attr not in SYNC_SAFE_METHODS:
                    self._record(attr, True, node.lineno, rebind=False)
                else:
                    self._record(attr, False, node.lineno)
                for arg in node.args:
                    self.visit(arg)
                for kw in node.keywords:
                    self.visit(kw.value)
                return
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            self._record(attr, isinstance(node.ctx, (ast.Store, ast.Del)),
                         node.lineno)
            return
        self.generic_visit(node)

    # Nested defs run later / on other threads: their accesses are still
    # accesses of this class, but they do NOT inherit the lock context.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        saved = self.depth
        self.depth = 0
        for stmt in node.body:
            self.visit(stmt)
        self.depth = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        saved = self.depth
        self.depth = 0
        self.visit(node.body)
        self.depth = saved


# ---------------------------------------------------------------------------
# Lock-order graph
# ---------------------------------------------------------------------------

class _OrderVisitor(ast.NodeVisitor):
    """Collect (held-site -> acquired-site) edges and call sites per
    function, for one class method or module function."""

    def __init__(self, analyzer: "_Package", module: str,
                 cls: Optional[_ClassInfo], fn_qual: str) -> None:
        self.an = analyzer
        self.module = module
        self.cls = cls
        self.fn_qual = fn_qual
        self.stack: list = []    # held lock sites, innermost last
        self.direct: set = set() # sites this function acquires directly
        self.edges: list = []    # (outer_site, inner_site, line)
        self.calls: list = []    # (held_sites_tuple, callee_key, line)

    def _site_of(self, expr: ast.expr) -> Optional[str]:
        # with self._lock:
        if self.cls is not None:
            name = _lock_name_of(self.cls, expr)
            if name:
                return f"{self.cls.name}.{name}"
        # with MODULE_LOCK:
        if isinstance(expr, ast.Name) and \
                expr.id in self.an.module_locks.get(self.module, ()):
            return f"{self.module}.{expr.id}"
        # with self.attr.lock / obj.lock — resolve attr type if known.
        if isinstance(expr, ast.Attribute):
            owner = expr.value
            attr_name = expr.attr
            cls_name = None
            if self.cls is not None:
                owner_attr = _self_attr(owner)
                if owner_attr is not None:
                    cls_name = self.cls.attr_types.get(owner_attr)
            if cls_name is not None:
                target = self.an.class_by_name(cls_name)
                if target is not None:
                    alias = target.lock_aliases.get(attr_name, attr_name)
                    if alias in target.locks:
                        return f"{target.name}.{alias}"
            # Unresolvable foreign lock: site keyed by attr name only, so
            # `with mirror.lock:` still participates in ordering.
            if attr_name in ("lock",) or attr_name.endswith("_lock"):
                return f"?.{attr_name}"
        return None

    def visit_With(self, node: ast.With) -> None:
        sites = []
        for item in node.items:
            site = self._site_of(item.context_expr)
            if site is not None:
                if self.stack and self.stack[-1] != site:
                    self.edges.append((self.stack[-1], site,
                                       node.lineno))
                elif self.stack and self.stack[-1] == site:
                    self.edges.append((site, site, node.lineno))
                self.direct.add(site)
                self.stack.append(site)
                sites.append(site)
        for stmt in node.body:
            self.visit(stmt)
        for _ in sites:
            self.stack.pop()

    def visit_Call(self, node: ast.Call) -> None:
        key = self._callee_key(node.func)
        if key is not None and self.stack:
            self.calls.append((tuple(self.stack), key, node.lineno))
        self.generic_visit(node)

    def _callee_key(self, fn: ast.expr) -> Optional[str]:
        # self.method()
        if isinstance(fn, ast.Attribute):
            owner_attr = _self_attr(fn.value)
            if isinstance(fn.value, ast.Name) and fn.value.id == "self" \
                    and self.cls is not None:
                return f"{self.cls.name}.{fn.attr}"
            if owner_attr is not None and self.cls is not None:
                cls_name = self.cls.attr_types.get(owner_attr)
                if cls_name:
                    return f"{cls_name}.{fn.attr}"
            # Unknown receiver: devirtualize by method-name uniqueness
            # among lock-holding classes (cheap, and wrong edges only
            # ever ADD cycles for a human to review).  Names shared with
            # builtin container/sync methods are excluded — `d.clear()`
            # must not resolve to SomeClass.clear.
            if fn.attr in MUTATOR_METHODS or fn.attr in SYNC_SAFE_METHODS \
                    or fn.attr in ("get", "keys", "values", "items",
                                   "copy", "close", "run"):
                return None
            owners = self.an.method_owners.get(fn.attr)
            if owners and len(owners) == 1:
                return f"{owners[0]}.{fn.attr}"
            return None
        # module_function()
        if isinstance(fn, ast.Name):
            return f"{self.module}:{fn.id}"
        return None

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # Nested defs (thread targets, callbacks) run with NO lock held.
        saved, self.stack = self.stack, []
        for stmt in node.body:
            self.visit(stmt)
        self.stack = saved

    visit_AsyncFunctionDef = visit_FunctionDef


class _Package:
    def __init__(self) -> None:
        self.classes: list = []
        self.module_locks: dict = {}   # module -> {name: kind}
        self.functions: dict = {}      # callee key -> _OrderVisitor
        self._by_name: dict = {}
        self.method_owners: dict = {}  # method name -> [lock-class names]
        # Set by _order_graph: cycles/self-acquire sites this module's
        # syntactic pass already reported, so the interprocedural pass
        # (blocking.py) reports only what it alone can see.
        self.cycle_sets: set = set()
        self.self_sites: set = set()

    def class_by_name(self, name: str) -> Optional[_ClassInfo]:
        hits = self._by_name.get(name)
        return hits[0] if hits and len(hits) == 1 else None

    def index(self) -> None:
        for info in self.classes:
            self._by_name.setdefault(info.name, []).append(info)
            if info.locks:
                for m in info.methods:
                    owners = self.method_owners.setdefault(m, [])
                    if info.name not in owners:
                        owners.append(info.name)


def _iter_sources(package_dir: str):
    for root, dirs, files in os.walk(package_dir):
        dirs[:] = sorted(d for d in dirs if not d.startswith("__pycache"))
        for fname in sorted(files):
            if fname.endswith(".py"):
                yield os.path.join(root, fname)


def _relpath(path: str, package_dir: str) -> str:
    base = os.path.dirname(os.path.abspath(package_dir))
    return os.path.relpath(os.path.abspath(path), base)


def scan_package(package_dir: str):
    """Parse the tree and index locks/classes once.  Returns
    ``(pkg, trees, error_finding)`` — shared by this module's passes and
    the interprocedural passes in blocking.py, so the lock-site naming
    stays identical across both."""
    pkg = _Package()
    trees = []
    for path in _iter_sources(package_dir):
        with open(path) as fh:
            try:
                tree = ast.parse(fh.read(), filename=path)
            except SyntaxError as e:
                return pkg, trees, Finding(
                    "parse-error", _relpath(path, package_dir),
                    "<module>", str(e), e.lineno or 0)
        rel = _relpath(path, package_dir)
        # Dotted module path, not basename: the package has many
        # same-named files (__init__.py, client.py, config.py) whose
        # locks must stay distinct graph sites.
        parts = os.path.splitext(rel)[0].split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        module = ".".join(parts)
        trees.append((rel, module, tree))
        # Module-level locks.
        for node in tree.body:
            if isinstance(node, ast.Assign):
                kind = _is_lock_ctor(node.value)
                if kind:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            pkg.module_locks.setdefault(
                                module, {})[tgt.id] = kind
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                info = _ClassInfo(module, rel, node)
                _scan_class(info)
                pkg.classes.append(info)
    pkg.index()
    return pkg, trees, None


def analyze_package(package_dir: str, strict: bool = False,
                    scan=None) -> list:
    pkg, trees, err = scan or scan_package(package_dir)
    if err is not None:
        return [err]

    findings: list = []
    findings.extend(_attr_discipline(pkg, strict))
    findings.extend(_module_global_discipline(pkg, trees, strict))
    findings.extend(_order_graph(pkg, trees))
    return findings


def _infer_entry_context(info: _ClassInfo, visitors: dict) -> tuple:
    """Fixpoint inference of per-method entry context.

    ``held``: private methods whose every intra-class call site runs
    with the lock held (the ``_locked``-suffix convention, generalized —
    a suffixed name is trusted even without visible call sites).
    ``ctor_only``: methods reachable only from ``__init__`` — they run
    pre-publication, like ``__init__`` itself.
    """
    callers: dict = {}   # callee -> [(caller, locked_at_site)]
    for name, v in visitors.items():
        for callee, locked in v.self_calls:
            callers.setdefault(callee, []).append((name, locked))

    held: set = {m for m in info.methods
                 if m.endswith("_locked") or m.endswith("Locked")}
    ctor_only: set = set()
    for _ in range(len(info.methods) + 1):
        changed = False
        for m in info.methods:
            sites = callers.get(m, [])
            if m not in ctor_only and m != "__init__" and sites and all(
                    caller == "__init__" or caller in ctor_only
                    for caller, _ in sites):
                ctor_only.add(m)
                changed = True
            # Constructor call sites run pre-publication; they neither
            # satisfy nor veto the locked-on-entry requirement.
            live = [(c, lk) for c, lk in sites
                    if c != "__init__" and c not in ctor_only]
            if m not in held and m.startswith("_") and live and all(
                    locked or caller in held
                    for caller, locked in live):
                held.add(m)
                changed = True
        if not changed:
            break
    return held, ctor_only


def _attr_discipline(pkg: _Package, strict: bool) -> list:
    findings = []
    for info in pkg.classes:
        if not info.locks:
            continue
        visitors: dict = {}
        for meth_name, meth in info.methods.items():
            v = _MethodVisitor(info, meth_name)
            v.visit(meth)
            visitors[meth_name] = v
        held, ctor_only = _infer_entry_context(info, visitors)

        immutable_writes: dict = {}  # attr -> (method, line)
        for meth_name, v in visitors.items():
            entry_held = meth_name in held
            pre_pub = meth_name == "__init__" or meth_name in ctor_only
            for attr, write, locked_here, line, rebind in v.accesses:
                guarded = locked_here or entry_held
                if attr in info.immutable and rebind and not pre_pub:
                    # An Immutable attr is bound once pre-publication;
                    # ANY later write (locked or not) breaks the
                    # annotation's contract that readers may skip the
                    # lock.
                    immutable_writes.setdefault(attr, (meth_name, line))
                slot = info.access.setdefault(attr, [0, 0, 0, 0])
                if pre_pub and not guarded:
                    continue  # no other thread can see the object yet
                idx = (0 if guarded else 2) + (1 if write else 0)
                slot[idx] += 1
                kind = ("guarded" if guarded else "bare",
                        "write" if write else "read")
                info.first_access.setdefault((attr, kind),
                                             (meth_name, line))

        for attr, (meth, line) in sorted(immutable_writes.items()):
            findings.append(Finding(
                "immutable-write", info.path, f"{info.name}.{attr}",
                f"attribute annotated Immutable is written in {meth} "
                "after construction", line))
        for attr, (g_r, g_w, b_r, b_w) in sorted(info.access.items()):
            if g_r + g_w == 0:
                continue  # never guarded: plain attribute
            if attr in info.immutable:
                continue  # immutable-write pass owns this attr
            if b_w:
                meth, line = info.first_access[(attr, ("bare", "write"))]
                guard = info.first_access.get(
                    (attr, ("guarded", "write")),
                    info.first_access.get((attr, ("guarded", "read"))))
                findings.append(Finding(
                    "bare-write", info.path, f"{info.name}.{attr}",
                    f"guarded attribute (locked in {guard[0]}) "
                    f"mutated outside any lock in {meth}", line))
            if strict and b_r and attr not in info.copy_swap:
                meth, line = info.first_access[(attr, ("bare", "read"))]
                findings.append(Finding(
                    "bare-read", info.path, f"{info.name}.{attr}",
                    f"guarded attribute read outside any lock in {meth}",
                    line, severity="info"))
    return findings


def _module_global_discipline(pkg: _Package, trees, strict: bool) -> list:
    """Globals written both inside and outside `with MODULE_LOCK:`."""
    findings = []
    for rel, module, tree in trees:
        locks = pkg.module_locks.get(module)
        if not locks:
            continue
        guarded_writes: dict = {}
        bare_writes: dict = {}

        def walk_fn(fn, depth: int) -> None:
            declared_global: set = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Global):
                    declared_global.update(node.names)
            for stmt in fn.body:
                _walk_stmt(stmt, depth, declared_global)

        def _scan_expr(expr, depth: int, globals_: set) -> None:
            for sub in ast.walk(expr):
                if isinstance(sub, ast.Name) and \
                        isinstance(sub.ctx, (ast.Store, ast.Del)) and \
                        sub.id in globals_:
                    tgt = guarded_writes if depth else bare_writes
                    tgt.setdefault(sub.id, sub.lineno)

        def _walk_stmt(node, depth: int, globals_: set) -> None:
            # Field-aware recursion: nested statements are classified at
            # THEIR depth only — a blanket ast.walk here would rescan a
            # `with LOCK:` body at the enclosing (bare) depth and turn
            # every conditionally-guarded write into a false positive.
            if isinstance(node, ast.With):
                d = depth + sum(
                    1 for it in node.items
                    if isinstance(it.context_expr, ast.Name)
                    and it.context_expr.id in locks)
                for it in node.items:
                    _scan_expr(it.context_expr, depth, globals_)
                for stmt in node.body:
                    _walk_stmt(stmt, d, globals_)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk_fn(node, 0)
                return
            for _field, value in ast.iter_fields(node):
                if isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.stmt):
                            _walk_stmt(v, depth, globals_)
                        elif isinstance(v, ast.excepthandler):
                            for stmt in v.body:
                                _walk_stmt(stmt, depth, globals_)
                        elif isinstance(v, ast.expr):
                            _scan_expr(v, depth, globals_)
                elif isinstance(value, ast.stmt):
                    _walk_stmt(value, depth, globals_)
                elif isinstance(value, ast.expr):
                    _scan_expr(value, depth, globals_)

        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk_fn(node, 0)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        walk_fn(item, 0)
        for name in sorted(set(guarded_writes) & set(bare_writes)):
            findings.append(Finding(
                "bare-write", rel, f"{module}.{name}",
                "module global written both under and outside "
                f"{module}'s lock", bare_writes[name]))
    return findings


def _order_graph(pkg: _Package, trees) -> list:
    """Build the cross-module lock-order graph; report cycles."""
    visitors: dict = {}
    for rel, module, tree in trees:
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                v = _OrderVisitor(pkg, module, None, f"{module}:{node.name}")
                for stmt in node.body:
                    v.visit(stmt)
                v.rel = rel
                visitors[v.fn_qual] = v
        for cnode in ast.walk(tree):
            if not isinstance(cnode, ast.ClassDef):
                continue
            info = next((c for c in pkg.classes
                         if c.node is cnode), None)
            if info is None:
                continue
            for mname, meth in info.methods.items():
                v = _OrderVisitor(pkg, module, info,
                                  f"{info.name}.{mname}")
                for stmt in meth.body:
                    v.visit(stmt)
                v.rel = rel
                visitors[v.fn_qual] = v

    # Direct + one-level call-propagated edges, to a fixpoint over
    # "locks a function may acquire" (2 rounds covers helper->helper).
    may_acquire: dict = {q: set(v.direct) for q, v in visitors.items()}
    for _ in range(3):
        changed = False
        for q, v in visitors.items():
            for _held, callee, _line in v.calls:
                extra = may_acquire.get(callee)
                if extra and not extra <= may_acquire[q]:
                    may_acquire[q] |= extra
                    changed = True
        if not changed:
            break

    edges: dict = {}
    self_edges: dict = {}
    for q, v in visitors.items():
        for outer, inner, line in v.edges:
            if outer == inner:
                self_edges.setdefault(outer, (v.rel, q, line))
            else:
                edges.setdefault((outer, inner), (v.rel, q, line))
        for held, callee, line in v.calls:
            for inner in may_acquire.get(callee, ()):
                outer = held[-1]
                if outer == inner:
                    self_edges.setdefault(outer, (v.rel, q, line))
                else:
                    edges.setdefault((outer, inner), (v.rel, q, line))

    findings = []
    # Self-nesting of a plain (non-reentrant) Lock: deadlock if both
    # frames ever hit the same instance.
    kind_of: dict = {}
    for info in pkg.classes:
        for attr, kind in info.locks.items():
            kind_of[f"{info.name}.{attr}"] = kind
    for module, locks in pkg.module_locks.items():
        for name, kind in locks.items():
            kind_of[f"{module}.{name}"] = kind
    for site, (rel, q, line) in sorted(self_edges.items()):
        if kind_of.get(site) == "Lock":
            findings.append(Finding(
                "nested-self-acquire", rel, q,
                f"non-reentrant lock {site} may be acquired while "
                f"already held (deadlock if the instances coincide)",
                line))

    # Cycles among distinct sites.
    graph: dict = {}
    for (a, b), meta in edges.items():
        graph.setdefault(a, {})[b] = meta
    for cycle in find_cycles(graph):
        rel, q, line = graph[cycle[0]][cycle[1]]
        findings.append(Finding(
            "lock-cycle", rel, q,
            "lock-order cycle: " + " -> ".join(cycle + (cycle[0],)),
            line))
        pkg.cycle_sets.add(frozenset(cycle))
    pkg.self_sites.update(s for s in self_edges
                          if kind_of.get(s) == "Lock")
    return findings


def find_cycles(graph: dict) -> list:
    """Elementary cycles in a node -> iterable-of-neighbors mapping,
    deduplicated by node set (small graphs).  Shared between the static
    order-graph pass and the runtime LockOrderWitness."""
    cycles: list = []
    seen_sets: set = set()

    def dfs(start, node, path, visited):
        for nxt in sorted(graph.get(node, ())):
            if nxt == start and len(path) > 1:
                key = frozenset(path)
                if key not in seen_sets:
                    seen_sets.add(key)
                    cycles.append(tuple(path))
            elif nxt not in visited and nxt > start:
                visited.add(nxt)
                dfs(start, nxt, path + [nxt], visited)
                visited.discard(nxt)

    for start in sorted(graph):
        dfs(start, start, [start], {start})
    return cycles
