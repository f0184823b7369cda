"""mutable-shared-state: mutable default args + module-level containers
mutated from async handlers.

Two classic hazards for a long-lived server process:

- A mutable default (``def f(x=[])``) is created ONCE at import and shared
  by every call — per-request state leaks across requests.
- A module-level dict/list/set mutated from inside ``async def`` handlers
  is cross-request shared state with no lock and no ownership story;
  interleaved handlers observe each other's partial updates. (Module
  singletons *re-bound* through an ``initialize_*()`` function are fine —
  rebinding is atomic; in-place mutation from handlers is the hazard.)
"""

from __future__ import annotations

import ast

from production_stack_tpu_torch.analysis.core import (
    ModuleContext,
    Rule,
    attr_tail,
    iter_functions,
    register,
    walk_function_body,
)

MUTABLE_FACTORIES = {
    "dict", "list", "set", "defaultdict", "deque", "Counter",
    "OrderedDict",
}

MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "update", "setdefault", "pop", "popitem", "popleft", "clear",
    "remove", "discard",
}

_CONTAINER_LITERALS = (ast.Dict, ast.List, ast.Set)


def _is_mutable_value(v: ast.expr) -> bool:
    if isinstance(v, _CONTAINER_LITERALS):
        return True
    return isinstance(v, ast.Call) and attr_tail(v.func) in \
        MUTABLE_FACTORIES


@register
class MutableSharedState(Rule):
    name = "mutable-shared-state"
    summary = (
        "mutable default argument, or module-level container mutated "
        "from an async handler"
    )

    def check(self, ctx: ModuleContext):
        yield from self._check_defaults(ctx)
        yield from self._check_module_state(ctx)

    def _check_defaults(self, ctx: ModuleContext):
        for func in iter_functions(ctx.tree):
            args = func.args
            defaults = list(args.defaults) + [
                d for d in args.kw_defaults if d is not None
            ]
            for d in defaults:
                if _is_mutable_value(d):
                    yield self.finding(
                        ctx, d,
                        f"mutable default argument in '{func.name}' is "
                        f"created once and shared across calls; default "
                        f"to None and construct inside the body",
                    )

    def _check_module_state(self, ctx: ModuleContext):
        module_mutables = {
            t.id
            for stmt in ctx.tree.body
            if isinstance(stmt, (ast.Assign, ast.AnnAssign))
            and getattr(stmt, "value", None) is not None
            and _is_mutable_value(stmt.value)
            for t in (stmt.targets if isinstance(stmt, ast.Assign)
                      else [stmt.target])
            if isinstance(t, ast.Name)
        }
        if not module_mutables:
            return
        for func in ast.walk(ctx.tree):
            if not isinstance(func, ast.AsyncFunctionDef):
                continue
            for node in walk_function_body(func):
                name = self._mutated_module_name(node, module_mutables)
                if name is not None:
                    yield self.finding(
                        ctx, node,
                        f"module-level mutable '{name}' is mutated from "
                        f"'async def {func.name}': cross-request shared "
                        f"state with no ownership; move it behind an "
                        f"initialized singleton or per-app state",
                    )

    @staticmethod
    def _mutated_module_name(node: ast.AST, names: set[str]) -> str | None:
        # CACHE.append(...) / CACHE.update(...) etc.
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATOR_METHODS and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in names:
            return node.func.value.id
        # CACHE[k] = v / CACHE[k] += v / del CACHE[k]
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = node.targets
        for t in targets:
            if isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Name) and \
                    t.value.id in names:
                return t.value.id
        # global CACHE (rebinding shared state from a handler)
        if isinstance(node, ast.Global):
            for n in node.names:
                if n in names:
                    return n
        return None
