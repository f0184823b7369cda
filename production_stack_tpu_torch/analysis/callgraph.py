"""stackcheck call graph: whole-program, module-qualified call resolution.

A per-function rule sees one function body at a time, so a blocking call
ONE level of indirection away from a ``# stackcheck: hot-path`` mark is
invisible to it. This module turns the scanned file set into a
``ProjectContext``: every top-level function and class method becomes a
``FunctionInfo`` node, and every resolvable call site becomes an edge, so
interprocedural rules
(analysis/rules/{hot_transitive,async_transitive,wall_clock,note_once}.py)
can propagate hot-path marks, async context, and wall-clock bans
transitively — and report the call chain in the finding.

Resolution is deliberately CONSERVATIVE (a linter must not invent edges):

- plain calls (``foo()``) resolve against the module's own top-level
  defs, then its import aliases (``from pkg.mod import foo [as f]``,
  ``import pkg.mod [as m]`` + ``m.foo()``);
- ``self.meth()`` / ``cls.meth()`` resolve against the enclosing class,
  then its statically-resolvable base classes (cycle-safe MRO walk);
- instantiation (``Foo()``) resolves to ``Foo.__init__`` when that is
  defined in the project — constructor work on a hot path counts;
- everything else — calls on arbitrary objects (``obj.meth()``),
  call results, subscripts, dynamic dispatch — stays UNRESOLVED: no
  edge, no propagation, no false chain. Function references passed as
  arguments (``run_in_executor(None, fn)``, ``Thread(target=fn)``) are
  references, not calls, so handing work to an executor or worker
  thread never drags the worker body onto the caller's context.

Module names are derived from the filesystem (walking up through
``__init__.py`` packages), so ``production_stack_tpu_torch/router/utils.py``
is addressable as ``production_stack_tpu_torch.router.utils`` no matter how
the scan was rooted.

Nested ``def``s are not part of their enclosing function's body, and a
top-level caller's ``step()`` never resolves to a closure: their
execution context is their own (an executor or thread body, or a
closure called each round). Under PyTorch a closure runs eagerly on the
host whenever it is called, so every nested def becomes a closure node
(``ProjectContext.closures``, kept apart from ``functions`` so the
async-context and wall-clock rules see the same graph as before). Its
own calls are linked, a plain ``name()`` inside it resolving first to a
closure of that name visible in its enclosing defs; ``self.meth()``
binds to the enclosing method's class. A hot-marked closure is an entry
point of the hot rules (analysis/rules/hot_transitive.py).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Callable, Iterator

from production_stack_tpu_torch.analysis.core import (
    ModuleContext,
    resolve_dotted,
)

#: transitive sweeps stop after this many hops — deep enough for any
#: real indirection in the tree, bounded so a pathological graph cannot
#: make the scan quadratic
MAX_CHAIN_DEPTH = 12


def module_name_for(path: str) -> str:
    """Dotted module name for a file, walking up through ``__init__.py``
    package dirs (``production_stack_tpu_torch/router/utils.py`` ->
    ``production_stack_tpu_torch.router.utils``). Files outside any package
    (fixtures, tmp files) get their bare stem."""
    p = Path(path)
    if p.stem == "__init__":
        parts: list[str] = []
    else:
        parts = [p.stem]
    d = p.parent
    try:
        while (d / "__init__.py").is_file():
            parts.insert(0, d.name)
            parent = d.parent
            if parent == d:
                break
            d = parent
    except OSError:
        pass
    return ".".join(parts) if parts else p.stem


class FunctionInfo:
    """One project function/method node in the call graph."""

    __slots__ = (
        "module", "cls", "name", "node", "ctx", "calls",
        "is_async", "is_hot", "is_not_hot", "is_slo_finish", "monotonic",
        "parent", "scope",
    )

    def __init__(
        self,
        module: str,
        cls: str | None,
        name: str,
        node: ast.FunctionDef | ast.AsyncFunctionDef,
        ctx: ModuleContext,
    ):
        self.module = module
        self.cls = cls
        self.name = name
        self.node = node
        self.ctx = ctx
        self.calls: list[CallSite] = []
        self.is_async = isinstance(node, ast.AsyncFunctionDef)
        self.is_hot = ctx.is_hot(node)
        self.is_not_hot = ctx.is_not_hot(node)
        self.is_slo_finish = ctx.is_slo_finish(node)
        self.monotonic = False  # set during collect from scope markers
        # closures: the enclosing FunctionInfo, and the nested defs a
        # plain call inside this closure may name (innermost first)
        self.parent: FunctionInfo | None = None
        self.scope: list[dict[str, FunctionInfo]] = []

    @property
    def qualname(self) -> str:
        if self.parent is not None:
            return f"{self.parent.qualname}.<locals>.{self.name}"
        if self.cls:
            return f"{self.module}.{self.cls}.{self.name}"
        return f"{self.module}.{self.name}"

    @property
    def short(self) -> str:
        """Chain-friendly label: qualname minus the root package."""
        q = self.qualname
        head, _, rest = q.partition(".")
        return rest if rest and head == "production_stack_tpu_torch" else q

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<FunctionInfo {self.qualname}>"


class CallSite:
    """One call expression inside a function body, with its resolution
    (``callee is None`` = unresolved / external / dynamic)."""

    __slots__ = ("node", "line", "col", "callee", "label")

    def __init__(
        self, node: ast.Call, callee: FunctionInfo | None, label: str
    ):
        self.node = node
        self.line = node.lineno
        self.col = node.col_offset
        self.callee = callee
        self.label = label


class _ClassSymbols:
    __slots__ = ("name", "node", "methods", "base_names", "monotonic")

    def __init__(self, name: str, node: ast.ClassDef):
        self.name = name
        self.node = node
        self.methods: dict[str, FunctionInfo] = {}
        self.base_names: list[str] = []
        self.monotonic = False


class _ModuleSymbols:
    __slots__ = ("name", "ctx", "functions", "classes", "monotonic")

    def __init__(self, name: str, ctx: ModuleContext):
        self.name = name
        self.ctx = ctx
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, _ClassSymbols] = {}
        self.monotonic = False


def _nested_defs(
    func: ast.FunctionDef | ast.AsyncFunctionDef,
) -> Iterator[ast.FunctionDef | ast.AsyncFunctionDef]:
    """The defs nested directly in a function body (at any statement
    depth, but not inside another nested def, class or lambda)."""
    stack: list[ast.AST] = list(func.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
            continue
        if isinstance(node, (ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def body_calls(
    func: ast.FunctionDef | ast.AsyncFunctionDef,
) -> Iterator[ast.Call]:
    """Calls lexically in a function body, NOT descending into nested
    def/class/lambda bodies (their own execution context — same contract
    as core.walk_function_body)."""
    stack: list[ast.AST] = list(func.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


class ProjectContext:
    """The whole scanned file set as one linked call graph."""

    def __init__(self, contexts: list[ModuleContext]):
        self.contexts = contexts
        self.by_path: dict[str, ModuleContext] = {
            ctx.path: ctx for ctx in contexts
        }
        self.modules: dict[str, _ModuleSymbols] = {}
        self.functions: list[FunctionInfo] = []
        self.closures: list[FunctionInfo] = []
        self._callers: dict[int, list[FunctionInfo]] | None = None
        for ctx in contexts:
            self._collect(ctx)
        for info in list(self.functions):
            self._collect_closures(info, [])
        for info in self.functions + self.closures:
            self._link(info)

    # -- collect: symbol tables + marker scopes ----------------------------
    def _collect(self, ctx: ModuleContext) -> None:
        mod = _ModuleSymbols(module_name_for(ctx.path), ctx)
        # a monotonic-only marker attaches to the class whose def it
        # sits on/above; any marker NOT attached to a class is
        # module-scope (the whole file is banned wall-clock territory)
        class_mono_lines: set[int] = set()
        for stmt in ctx.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = FunctionInfo(mod.name, None, stmt.name, stmt, ctx)
                mod.functions[stmt.name] = info
                self.functions.append(info)
            elif isinstance(stmt, ast.ClassDef):
                csym = _ClassSymbols(stmt.name, stmt)
                if ctx.marker_attaches(stmt, ctx.monotonic_lines):
                    csym.monotonic = True
                    for ln in ctx.monotonic_lines:
                        if (ln == stmt.lineno
                                or self._in_comment_block_above(
                                    ctx, stmt.lineno, ln)):
                            class_mono_lines.add(ln)
                for base in stmt.bases:
                    dotted = resolve_dotted(base, ctx.import_aliases)
                    if dotted:
                        csym.base_names.append(dotted)
                for sub in stmt.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        info = FunctionInfo(
                            mod.name, stmt.name, sub.name, sub, ctx
                        )
                        csym.methods[sub.name] = info
                        self.functions.append(info)
                mod.classes[stmt.name] = csym
        mod.monotonic = bool(ctx.monotonic_lines - class_mono_lines)
        for info in self.functions:
            if info.ctx is ctx:
                csym = (
                    mod.classes.get(info.cls) if info.cls else None
                )
                info.monotonic = mod.monotonic or (
                    csym.monotonic if csym else False
                )
        # keep the first module registered under a name (duplicate bare
        # stems outside packages): later files still get their own
        # per-module rule pass, they just can't be import targets
        self.modules.setdefault(mod.name, mod)

    def _collect_closures(
        self, outer: FunctionInfo, scope: list[dict[str, FunctionInfo]]
    ) -> None:
        """Every nested def of ``outer``'s body (not descending into a
        nested class) becomes a closure node; recursion gives a closure
        inside a closure its own node and scope."""
        local: dict[str, FunctionInfo] = {}
        for node in _nested_defs(outer.node):
            info = FunctionInfo(
                outer.module, outer.cls, node.name, node, outer.ctx
            )
            info.parent = outer
            local[node.name] = info
            self.closures.append(info)
        inner_scope = [local] + scope
        for info in local.values():
            info.scope = inner_scope
            self._collect_closures(info, inner_scope)

    @staticmethod
    def _in_comment_block_above(
        ctx: ModuleContext, def_line: int, marker_line: int
    ) -> bool:
        prev = def_line - 1
        while prev in ctx._comment_only:
            if prev == marker_line:
                return True
            prev -= 1
        return False

    # -- link: resolve call sites ------------------------------------------
    def _link(self, info: FunctionInfo) -> None:
        for call in body_calls(info.node):
            callee, label = self._resolve_call(call, info)
            info.calls.append(CallSite(call, callee, label))

    def _resolve_call(
        self, call: ast.Call, info: FunctionInfo
    ) -> tuple[FunctionInfo | None, str]:
        func = call.func
        mod = self.modules.get(info.module)
        if isinstance(func, ast.Name):
            name = func.id
            for local in info.scope:
                if name in local:
                    return local[name], name
            if mod is not None:
                fi = mod.functions.get(name)
                if fi is not None:
                    return fi, name
                csym = mod.classes.get(name)
                if csym is not None:
                    return self._method_of(csym, "__init__"), name
            dotted = info.ctx.import_aliases.get(name)
            if dotted is not None:
                return self._resolve_dotted_target(dotted), name
            return None, name
        if isinstance(func, ast.Attribute):
            base = func.value
            if (
                isinstance(base, ast.Name)
                and base.id in ("self", "cls")
                and info.cls is not None
                and mod is not None
            ):
                csym = mod.classes.get(info.cls)
                if csym is not None:
                    return (
                        self._method_of(csym, func.attr),
                        f"self.{func.attr}",
                    )
            dotted = resolve_dotted(func, info.ctx.import_aliases)
            if dotted is not None:
                return self._resolve_dotted_target(dotted), dotted
            # dynamic receiver (call result, subscript, ...): no edge
            return None, f"<dynamic>.{func.attr}"
        return None, "<call>"

    def _resolve_dotted_target(
        self, dotted: str
    ) -> FunctionInfo | None:
        """``pkg.mod.func`` / ``pkg.mod.Class[.method]`` -> FunctionInfo,
        matching the LONGEST known module prefix (so ``pkg.mod.sub.f``
        prefers module ``pkg.mod.sub`` over a ``sub`` attribute of
        ``pkg.mod``)."""
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = self.modules.get(".".join(parts[:i]))
            if mod is None:
                continue
            rest = parts[i:]
            if len(rest) == 1:
                fi = mod.functions.get(rest[0])
                if fi is not None:
                    return fi
                csym = mod.classes.get(rest[0])
                if csym is not None:
                    return self._method_of(csym, "__init__")
            elif len(rest) == 2:
                csym = mod.classes.get(rest[0])
                if csym is not None:
                    return self._method_of(csym, rest[1])
            return None
        return None

    def _method_of(
        self, csym: _ClassSymbols, name: str, _seen: set[int] | None = None
    ) -> FunctionInfo | None:
        """Method lookup through the statically-resolvable base chain;
        ``_seen`` guards against inheritance cycles in broken code."""
        if _seen is None:
            _seen = set()
        if id(csym) in _seen:
            return None
        _seen.add(id(csym))
        fi = csym.methods.get(name)
        if fi is not None:
            return fi
        for base_dotted in csym.base_names:
            base = self._class_for_dotted(base_dotted, csym)
            if base is not None:
                fi = self._method_of(base, name, _seen)
                if fi is not None:
                    return fi
        return None

    def _class_for_dotted(
        self, dotted: str, from_csym: _ClassSymbols
    ) -> _ClassSymbols | None:
        # a base is either a local class name or an imported dotted one
        for mod in self.modules.values():
            if from_csym.name in mod.classes and \
                    mod.classes[from_csym.name] is from_csym:
                local = mod.classes.get(dotted)
                if local is not None:
                    return local
                break
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = self.modules.get(".".join(parts[:i]))
            if mod is not None and len(parts) - i == 1:
                return mod.classes.get(parts[i])
        return None

    # -- queries -----------------------------------------------------------
    def function_at(
        self, ctx: ModuleContext,
        node: ast.FunctionDef | ast.AsyncFunctionDef,
    ) -> FunctionInfo | None:
        for info in self.functions + self.closures:
            if info.ctx is ctx and info.node is node:
                return info
        return None

    def transitive_callees(
        self,
        root: FunctionInfo,
        stop: Callable[[FunctionInfo], bool] | None = None,
        max_depth: int = MAX_CHAIN_DEPTH,
    ) -> dict[FunctionInfo, tuple[FunctionInfo, ...]]:
        """Every project function reachable from ``root`` through
        resolved call edges, mapped to its SHORTEST call chain
        (root, ..., callee). BFS with a visited set — call cycles are
        walked once and terminate. ``stop(fn)`` prunes: a stopped
        callee is neither reported nor descended into (the not-hot
        boundary semantics)."""
        out: dict[FunctionInfo, tuple[FunctionInfo, ...]] = {}
        frontier: list[tuple[FunctionInfo, tuple[FunctionInfo, ...]]] = [
            (root, (root,))
        ]
        seen: set[int] = {id(root)}
        depth = 0
        while frontier and depth < max_depth:
            depth += 1
            nxt: list[tuple[FunctionInfo, tuple[FunctionInfo, ...]]] = []
            for fn, chain in frontier:
                for site in fn.calls:
                    callee = site.callee
                    if callee is None or id(callee) in seen:
                        continue
                    seen.add(id(callee))
                    if stop is not None and stop(callee):
                        continue
                    cchain = chain + (callee,)
                    out[callee] = cchain
                    nxt.append((callee, cchain))
            frontier = nxt
        return out

    def callers_of(self) -> dict[int, list[FunctionInfo]]:
        """id(callee) -> list of distinct project callers (for the
        async-context fixed point). Built once, cached."""
        if self._callers is None:
            callers: dict[int, list[FunctionInfo]] = {}
            for info in self.functions:
                for site in info.calls:
                    if site.callee is None:
                        continue
                    lst = callers.setdefault(id(site.callee), [])
                    if all(c is not info for c in lst):
                        lst.append(info)
            self._callers = callers
        return self._callers


def format_chain(chain: tuple[FunctionInfo, ...]) -> str:
    """Human chain for finding messages: ``a.b -> c.d -> e``."""
    return " -> ".join(fn.short for fn in chain)
