"""Interprocedural call graph over the package AST.

Counterpart of ``nomad_tpu/analysis/callgraph.py`` (the same resolution
rules, so both packages' passes read a tree alike).  Per-function
analyzers see a ``with self._lock:`` body
but not what the functions *called inside it* do.  This module gives the
other passes the missing edge set — a whole-program call graph with
enough name/attr resolution to follow the package's real call patterns:

  - ``self.method()`` resolved through the enclosing class AND its
    in-package bases (simple MRO walk — ``PipelinedEvalRunner`` calling
    ``self._begin_eval`` resolves into ``BatchEvalRunner``);
  - ``self.attr.method()`` through attribute types inferred from
    ``self.attr = ClassName(...)`` assignments (any method, not just
    ``__init__``) and from ``self.attr: ClassName`` annotations;
  - ``obj.method()`` through local-variable types (``x = ClassName(...)``),
    parameter annotations (``def f(x: ClassName)``), and module-level
    constants (``POLICY = RetryPolicy(...)`` → ``POLICY.call()``);
  - ``module.func()`` / ``from x import f; f()`` through the import
    table, including relative imports;
  - decorator-aware leaves: ``@jax.jit``-decorated functions keep their
    identity, and ``kernel = jax.jit(_impl)`` aliases ``kernel`` to
    ``_impl`` so callers of the wrapper reach the real body.

Nested ``def``s are indexed as their own nodes (``Outer.inner``) and do
NOT contribute their calls to the enclosing function: a thread target or
callback runs on another thread/at another time, so its blocking or
acquisitions are not the creator's.

Resolution is best-effort by design; what matters is that the *misses
are counted*.  ``CallGraph.coverage()`` reports resolved vs dynamic
call sites so the lint's blind spots are visible instead of silent
(surfaced in ``lint -json``).
"""
from __future__ import annotations

import ast
import builtins
import os
from typing import Iterable, Optional

_BUILTIN_NAMES = frozenset(dir(builtins))

# Wrappers whose call returns the wrapped function unchanged for
# call-graph purposes: `kernel = jax.jit(_impl, ...)` makes `kernel()`
# reach `_impl`.
_TRANSPARENT_WRAPPERS = {"jit", "partial", "lru_cache", "wraps"}


class CallSite:
    """One call expression inside a function body."""

    __slots__ = ("line", "callee", "kind", "text")

    def __init__(self, line: int, callee: Optional[str], kind: str,
                 text: str) -> None:
        self.line = line
        self.callee = callee   # FuncNode key ("mod:Qual") or dotted ext name
        self.kind = kind       # "intra" | "external" | "builtin" | "dynamic"
        self.text = text       # rendered call target, for messages


class FuncNode:
    __slots__ = ("key", "module", "rel", "cls", "qual", "node", "calls",
                 "line")

    def __init__(self, key: str, module: str, rel: str,
                 cls: Optional[str], qual: str, node) -> None:
        self.key = key         # "module:Qual"
        self.module = module
        self.rel = rel         # repo-relative path
        self.cls = cls         # simple class name or None
        self.qual = qual       # "name" / "Class.method" / "Class.m.inner"
        self.node = node
        self.line = node.lineno
        self.calls: list = []  # [CallSite]


class ClassNode:
    __slots__ = ("key", "module", "name", "node", "bases", "methods",
                 "attr_types")

    def __init__(self, key: str, module: str, name: str, node) -> None:
        self.key = key          # "module.Class"
        self.module = module
        self.name = name
        self.node = node
        self.bases: list = []   # base class keys (resolved, in order)
        self.methods: dict = {} # method name -> FuncNode key
        self.attr_types: dict = {}  # attr -> class key or external dotted


class ModuleInfo:
    __slots__ = ("module", "rel", "tree", "imports", "functions", "classes",
                 "global_types", "aliases")

    def __init__(self, module: str, rel: str, tree) -> None:
        self.module = module
        self.rel = rel
        self.tree = tree
        # name -> ("mod", dotted) | ("sym", dotted_module, symbol)
        self.imports: dict = {}
        self.functions: dict = {}    # name -> FuncNode key
        self.classes: dict = {}      # name -> ClassNode key
        self.global_types: dict = {} # NAME -> class key (module constants)
        self.aliases: dict = {}      # name -> FuncNode key (jit wrappers)


def _iter_sources(package_dir: str):
    for root, dirs, files in os.walk(package_dir):
        dirs[:] = sorted(d for d in dirs if not d.startswith("__pycache"))
        for fname in sorted(files):
            if fname.endswith(".py"):
                yield os.path.join(root, fname)


def _module_name(path: str, package_dir: str) -> tuple[str, str]:
    base = os.path.dirname(os.path.abspath(package_dir))
    rel = os.path.relpath(os.path.abspath(path), base)
    parts = os.path.splitext(rel)[0].split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts), rel


def _render(expr: ast.expr) -> str:
    try:
        return ast.unparse(expr)
    except Exception:
        return "<call>"


class CallGraph:
    def __init__(self) -> None:
        self.modules: dict = {}      # dotted -> ModuleInfo
        self.functions: dict = {}    # key -> FuncNode
        self.classes: dict = {}      # "module.Class" -> ClassNode
        self._class_by_name: dict = {}  # simple name -> [class keys]
        self._stats = {"functions": 0, "call_sites": 0, "resolved": 0,
                       "external": 0, "builtin": 0, "dynamic": 0}

    # -- queries -----------------------------------------------------------
    def coverage(self) -> dict:
        out = dict(self._stats)
        sites = out["call_sites"]
        out["resolved_fraction"] = round(
            (out["resolved"] + out["external"] + out["builtin"]) /
            sites, 4) if sites else 1.0
        return out

    def callees(self, key: str) -> Iterable[CallSite]:
        fn = self.functions.get(key)
        return fn.calls if fn is not None else ()

    def class_of(self, key: str) -> Optional[ClassNode]:
        fn = self.functions.get(key)
        if fn is None or fn.cls is None:
            return None
        return self.classes.get(f"{fn.module}.{fn.cls}")

    def resolve_method(self, class_key: str, name: str) -> Optional[str]:
        """Find ``name`` on the class or its in-package bases (MRO-ish
        depth-first, left-to-right)."""
        seen: set = set()
        stack = [class_key]
        while stack:
            ck = stack.pop(0)
            if ck in seen:
                continue
            seen.add(ck)
            cls = self.classes.get(ck)
            if cls is None:
                continue
            hit = cls.methods.get(name)
            if hit is not None:
                return hit
            stack = cls.bases + stack
        return None

    def unique_class(self, name: str) -> Optional[str]:
        hits = self._class_by_name.get(name)
        return hits[0] if hits and len(hits) == 1 else None

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, package_dir: str,
              parsed=None) -> "CallGraph":
        """``parsed`` is lockcheck.scan_package's ``trees`` —
        ``[(rel, module, tree)]`` — so one parse of the package serves
        both analyzers; omitted, the tree is read from disk."""
        graph = cls()
        trees = []
        if parsed is not None:
            for rel, module, tree in parsed:
                info = ModuleInfo(module, rel, tree)
                graph.modules[module] = info
                trees.append(info)
        else:
            for path in _iter_sources(package_dir):
                with open(path) as fh:
                    try:
                        tree = ast.parse(fh.read(), filename=path)
                    except SyntaxError:
                        continue  # lockcheck reports parse errors
                module, rel = _module_name(path, package_dir)
                info = ModuleInfo(module, rel, tree)
                graph.modules[module] = info
                trees.append(info)
        for info in trees:
            graph._index_module(info)
        for info in trees:
            graph._resolve_bases(info)
            graph._infer_attr_types(info)
        for info in trees:
            graph._resolve_module(info)
        return graph

    def _index_module(self, info: ModuleInfo) -> None:
        for node in info.tree.body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    info.imports[alias.asname or
                                 alias.name.split(".")[0]] = \
                        ("mod", alias.name)
            elif isinstance(node, ast.ImportFrom):
                target = self._resolve_from(info, node)
                if target is None:
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    info.imports[alias.asname or alias.name] = \
                        ("sym", target, alias.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._index_function(info, node, None, node.name)
            elif isinstance(node, ast.ClassDef):
                self._index_class(info, node)
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                self._index_global_assign(info, node)
        # Function-level imports (several modules defer heavy imports):
        # indexed flat — shadowing is not worth modeling.
        for node in ast.walk(info.tree):
            if isinstance(node, ast.ImportFrom) and node not in \
                    info.tree.body:
                target = self._resolve_from(info, node)
                if target is None:
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    info.imports.setdefault(
                        alias.asname or alias.name,
                        ("sym", target, alias.name))
            elif isinstance(node, ast.Import) and node not in \
                    info.tree.body:
                for alias in node.names:
                    info.imports.setdefault(
                        alias.asname or alias.name.split(".")[0],
                        ("mod", alias.name))

    def _resolve_from(self, info: ModuleInfo,
                      node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            return node.module
        parts = info.module.split(".")
        # level=1 from a module means its package; __init__ modules ARE
        # their package, so they drop one level less.
        is_pkg = info.rel.endswith("__init__.py")
        drop = node.level - (1 if is_pkg else 0)
        if drop > 0:
            parts = parts[:-drop] if drop < len(parts) else []
        base = ".".join(parts)
        if node.module:
            return f"{base}.{node.module}" if base else node.module
        return base or None

    def _index_function(self, info: ModuleInfo, node, cls: Optional[str],
                        qual: str) -> FuncNode:
        key = f"{info.module}:{qual}"
        fn = FuncNode(key, info.module, info.rel, cls, qual, node)
        self.functions[key] = fn
        self._stats["functions"] += 1
        if cls is None and "." not in qual:
            info.functions[node.name] = key
        # Nested defs become their own nodes (direct children only; each
        # recursion level indexes its own).
        for child in _child_defs(node):
            self._index_function(info, child, cls,
                                 f"{qual}.{child.name}")
        return fn

    def _index_class(self, info: ModuleInfo, node: ast.ClassDef) -> None:
        ckey = f"{info.module}.{node.name}"
        cnode = ClassNode(ckey, info.module, node.name, node)
        self.classes[ckey] = cnode
        self._class_by_name.setdefault(node.name, []).append(ckey)
        info.classes[node.name] = ckey
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = self._index_function(info, item, node.name,
                                          f"{node.name}.{item.name}")
                cnode.methods[item.name] = fn.key
            elif isinstance(item, ast.ClassDef):
                self._index_class(info, item)  # nested class: flat index

    def _index_global_assign(self, info: ModuleInfo,
                             node: ast.Assign) -> None:
        call = node.value
        fn = call.func
        # `kernel = jax.jit(_impl)` / `f = partial(g, ...)`: alias.
        wrapper = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if wrapper in _TRANSPARENT_WRAPPERS and call.args and \
                isinstance(call.args[0], ast.Name):
            inner = call.args[0].id
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    info.aliases[tgt.id] = f"{info.module}:{inner}"
            return
        # `POLICY = RetryPolicy(...)`: module constant with a known type.
        ctor = fn.id if isinstance(fn, ast.Name) else None
        if ctor:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    info.global_types[tgt.id] = ("name", ctor)

    def _resolve_bases(self, info: ModuleInfo) -> None:
        for name, ckey in info.classes.items():
            cnode = self.classes[ckey]
            for base in cnode.node.bases:
                bkey = self._class_key_of_expr(info, base)
                if bkey is not None:
                    cnode.bases.append(bkey)

    def _class_key_of_expr(self, info: ModuleInfo,
                           expr: ast.expr) -> Optional[str]:
        """Resolve a class-reference expression to a ClassNode key."""
        if isinstance(expr, ast.Name):
            return self._class_key_of_name(info, expr.id)
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            imp = info.imports.get(expr.value.id)
            if imp and imp[0] == "mod":
                return self._lookup_class(imp[1], expr.attr)
        return None

    def _class_key_of_name(self, info: ModuleInfo,
                           name: str) -> Optional[str]:
        if name in info.classes:
            return info.classes[name]
        imp = info.imports.get(name)
        if imp and imp[0] == "sym":
            hit = self._lookup_class(imp[1], imp[2])
            if hit is not None:
                return hit
        return self.unique_class(name)

    def _lookup_class(self, module: str, name: str) -> Optional[str]:
        target = self.modules.get(module)
        if target is not None and name in target.classes:
            return target.classes[name]
        # Re-export through a package __init__: chase one level.
        if target is not None:
            imp = target.imports.get(name)
            if imp and imp[0] == "sym":
                deeper = self.modules.get(imp[1])
                if deeper is not None and imp[2] in deeper.classes:
                    return deeper.classes[imp[2]]
        return None

    def _infer_attr_types(self, info: ModuleInfo) -> None:
        """self.attr = ClassName(...) / self.attr: ClassName /
        self.attr = annotated_param — from any method, so
        lazily-constructed and injected collaborators resolve too."""
        for ckey in info.classes.values():
            cnode = self.classes[ckey]
            for meth in cnode.node.body:
                if not isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                param_types: dict = {}
                margs = meth.args
                for a in list(margs.posonlyargs) + list(margs.args) + \
                        list(margs.kwonlyargs):
                    if a.annotation is not None:
                        hit = self._class_key_of_expr(
                            info, _unquote(a.annotation))
                        if hit is not None:
                            param_types[a.arg] = hit
                for node in ast.walk(meth):
                    target = value = ann = None
                    if isinstance(node, ast.Assign):
                        target, value = node.targets[0], node.value
                    elif isinstance(node, ast.AnnAssign):
                        target, value, ann = node.target, node.value, \
                            node.annotation
                    else:
                        continue
                    attr = _self_attr(target)
                    if attr is None:
                        continue
                    hit = self._value_type(info, value)
                    if hit is None and isinstance(value, ast.Name):
                        hit = param_types.get(value.id)
                    if hit is None and ann is not None:
                        hit = self._class_key_of_expr(info,
                                                      _unquote(ann))
                    if hit is not None:
                        cnode.attr_types.setdefault(attr, hit)

    def _value_type(self, info: ModuleInfo,
                    value: Optional[ast.expr]) -> Optional[str]:
        """The class key a value expression constructs or references:
        ``ClassName(...)``, ``x if c else GLOBAL`` (either arm), or a
        typed module constant (``GLOBAL_BREAKER`` imported from a module
        whose top level assigns it a known constructor)."""
        if value is None:
            return None
        if isinstance(value, ast.Call):
            return self._class_key_of_expr(info, value.func)
        if isinstance(value, ast.IfExp):
            return self._value_type(info, value.body) or \
                self._value_type(info, value.orelse)
        if isinstance(value, ast.Name):
            g = info.global_types.get(value.id)
            if g is not None:
                return self._class_key_of_name(info, g[1])
            imp = info.imports.get(value.id)
            if imp and imp[0] == "sym":
                target = self.modules.get(imp[1])
                if target is not None:
                    g = target.global_types.get(imp[2])
                    if g is not None:
                        return self._class_key_of_name(target, g[1])
        return None

    # -- call resolution ---------------------------------------------------
    def _resolve_module(self, info: ModuleInfo) -> None:
        for fn in list(self.functions.values()):
            if fn.module != info.module:
                continue
            _FunctionResolver(self, info, fn).run()

    def resolve_call(self, info: ModuleInfo, cls_key: Optional[str],
                     local_types: dict, fn_expr: ast.expr
                     ) -> tuple[Optional[str], str]:
        """Resolve one call's target.  Returns (callee, kind) where
        ``callee`` is a FuncNode key for kind="intra", a dotted name for
        "external"/"builtin", and None for "dynamic"."""
        # f(...)
        if isinstance(fn_expr, ast.Name):
            name = fn_expr.id
            if name in info.aliases:
                return info.aliases[name], "intra"
            if name in info.functions:
                return info.functions[name], "intra"
            if name in info.classes:
                ctor = self.resolve_method(info.classes[name], "__init__")
                return (ctor, "intra") if ctor else \
                    (info.classes[name], "intra-class")
            imp = info.imports.get(name)
            if imp is not None:
                if imp[0] == "sym":
                    target = self.modules.get(imp[1])
                    if target is not None:
                        if imp[2] in target.functions:
                            return target.functions[imp[2]], "intra"
                        if imp[2] in target.classes:
                            ck = target.classes[imp[2]]
                            ctor = self.resolve_method(ck, "__init__")
                            return (ctor, "intra") if ctor else \
                                (ck, "intra-class")
                        if imp[2] in target.aliases:
                            return target.aliases[imp[2]], "intra"
                        # chase one re-export level
                        deep = target.imports.get(imp[2])
                        if deep and deep[0] == "sym":
                            d = self.modules.get(deep[1])
                            if d is not None and deep[2] in d.functions:
                                return d.functions[deep[2]], "intra"
                    return f"{imp[1]}.{imp[2]}", "external"
                return f"{imp[1]}.{name}", "external"
            if name in _BUILTIN_NAMES:
                return name, "builtin"
            return None, "dynamic"

        if not isinstance(fn_expr, ast.Attribute):
            return None, "dynamic"
        owner = fn_expr.value
        meth = fn_expr.attr

        # self.method(...) / self.attr.method(...)
        s_attr = _self_attr(owner)
        if isinstance(owner, ast.Name) and owner.id == "self" and \
                cls_key is not None:
            hit = self.resolve_method(cls_key, meth)
            return (hit, "intra") if hit else (None, "dynamic")
        if s_attr is not None and cls_key is not None:
            cnode = self.classes.get(cls_key)
            tkey = self._attr_type(cls_key, s_attr) if cnode else None
            if tkey is not None:
                hit = self.resolve_method(tkey, meth)
                if hit is not None:
                    return hit, "intra"
            return None, "dynamic"

        if isinstance(owner, ast.Name):
            # module.func(...)
            imp = info.imports.get(owner.id)
            if imp is not None and imp[0] == "mod":
                target = self.modules.get(imp[1])
                if target is not None:
                    if meth in target.functions:
                        return target.functions[meth], "intra"
                    if meth in target.classes:
                        ck = target.classes[meth]
                        ctor = self.resolve_method(ck, "__init__")
                        return (ctor, "intra") if ctor else \
                            (ck, "intra-class")
                return f"{imp[1]}.{meth}", "external"
            # typed local / module constant
            tkey = local_types.get(owner.id)
            if tkey is None:
                g = info.global_types.get(owner.id)
                if g is not None:
                    tkey = self._class_key_of_name(info, g[1])
            if tkey is not None:
                if isinstance(tkey, str) and tkey in self.classes:
                    hit = self.resolve_method(tkey, meth)
                    if hit is not None:
                        return hit, "intra"
                elif isinstance(tkey, str):
                    return f"{tkey}.{meth}", "external"
            return None, "dynamic"
        # str constant receiver: ", ".join(...) et al.
        if isinstance(owner, ast.Constant):
            return f"{type(owner.value).__name__}.{meth}", "builtin"
        return None, "dynamic"

    def _attr_type(self, cls_key: str, attr: str) -> Optional[str]:
        """Attr type through the class and its bases."""
        seen: set = set()
        stack = [cls_key]
        while stack:
            ck = stack.pop(0)
            if ck in seen:
                continue
            seen.add(ck)
            cnode = self.classes.get(ck)
            if cnode is None:
                continue
            hit = cnode.attr_types.get(attr)
            if hit is not None:
                return hit
            stack = cnode.bases + stack
        return None


def _child_defs(fn_node) -> list:
    """Function defs nested DIRECTLY inside ``fn_node`` (not inside a
    deeper def)."""
    out: list = []

    def walk(node) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(child)
            elif not isinstance(child, (ast.Lambda, ast.ClassDef)):
                walk(child)

    walk(fn_node)
    return out


def _self_attr(node) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _unquote(ann: ast.expr) -> ast.expr:
    """Annotations may be strings under `from __future__ import
    annotations`, Optional[X] / X | None unions, or marker subscripts
    (Immutable[str]); peel down to the class-reference expression."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return ann
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        left, right = ann.left, ann.right
        pick = right if (isinstance(left, ast.Constant) and
                         left.value is None) else left
        return _unquote(pick)
    if isinstance(ann, ast.Subscript):
        if isinstance(ann.value, ast.Name) and \
                ann.value.id == "Optional":
            return _unquote(ann.slice)
        return ann.value
    return ann


class _FunctionResolver(ast.NodeVisitor):
    """Collect + resolve every call in ONE function body (nested defs
    excluded — they are their own nodes)."""

    def __init__(self, graph: CallGraph, info: ModuleInfo,
                 fn: FuncNode) -> None:
        self.graph = graph
        self.info = info
        self.fn = fn
        self.cls_key = f"{fn.module}.{fn.cls}" if fn.cls else None
        self.local_types: dict = {}

    def run(self) -> None:
        node = self.fn.node
        # Parameter annotations seed local types.
        args = node.args
        for a in list(args.posonlyargs) + list(args.args) + \
                list(args.kwonlyargs):
            if a.annotation is not None:
                hit = self.graph._class_key_of_expr(
                    self.info, _unquote(a.annotation))
                if hit is not None:
                    self.local_types[a.arg] = hit
        for stmt in node.body:
            self.visit(stmt)

    # Nested defs/lambdas: skip (indexed separately).
    def visit_FunctionDef(self, node) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node) -> None:
        pass

    def visit_Assign(self, node: ast.Assign) -> None:
        # x = ClassName(...)  →  local type
        if isinstance(node.value, ast.Call):
            hit = self.graph._class_key_of_expr(self.info,
                                                node.value.func)
            if hit is not None:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.local_types[tgt.id] = hit
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if isinstance(node.target, ast.Name):
            hit = self.graph._class_key_of_expr(
                self.info, _unquote(node.annotation))
            if hit is not None:
                self.local_types[node.target.id] = hit
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        callee, kind = self.graph.resolve_call(
            self.info, self.cls_key, self.local_types, node.func)
        stats = self.graph._stats
        stats["call_sites"] += 1
        if kind == "intra":
            stats["resolved"] += 1
        elif kind == "intra-class":
            # Constructor of an in-package class with no __init__ —
            # resolved for coverage purposes, nothing to walk into.
            stats["resolved"] += 1
            callee, kind = None, "dynamic"
        elif kind in ("external", "builtin"):
            stats[kind] += 1
        else:
            stats["dynamic"] += 1
        self.fn.calls.append(CallSite(node.lineno, callee, kind,
                                      _render(node.func)))
        self.generic_visit(node)
