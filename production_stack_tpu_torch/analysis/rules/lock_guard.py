"""guarded-by-lock: annotated attributes accessed outside their lock.

The engine crosses threads (asyncio event loop <-> the engine step thread),
so some instance state is only safe under a lock. Document the invariant
where the attribute is born::

    self._streams: dict[str, asyncio.Queue] = {}  # guarded by: self._lock

and stackcheck enforces it: every ``self._streams`` access in that class
must sit lexically inside a ``with self._lock:`` / ``async with`` block
whose context expression matches the annotation text. The method that
carries the annotation (normally ``__init__``) is exempt — the object is
not yet shared there.

The check is lexical: a nested def inside a ``with`` block is treated as
running under the lock (it usually does in this codebase); intentionally
lock-free accesses (immutable-after-init reads, post-join teardown) get a
per-line suppression with the justification.
"""

from __future__ import annotations

import ast

from production_stack_tpu_torch.analysis.core import (
    ModuleContext,
    Rule,
    register,
)


def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


@register
class GuardedByLock(Rule):
    name = "guarded-by-lock"
    summary = (
        "attribute annotated '# guarded by: <lock>' accessed outside a "
        "matching 'with <lock>:' block"
    )

    def check(self, ctx: ModuleContext):
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            yield from self._check_class(ctx, cls)

    def _check_class(self, ctx: ModuleContext, cls: ast.ClassDef):
        methods = [
            n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        # attr -> (lock expression, method defining/annotating it)
        guarded: dict[str, tuple[str, ast.AST]] = {}
        for m in methods:
            for node in ast.walk(m):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                lock = ctx.guarded_lines.get(node.lineno)
                if lock is None:
                    continue
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        guarded[attr] = (lock, m)
        if not guarded:
            return
        seen: set[tuple[int, str]] = set()
        for m in methods:
            exempt = {a for a, (_, dm) in guarded.items() if dm is m}
            yield from self._scan(
                ctx, cls, m, m.body, frozenset(), guarded, exempt, seen
            )

    def _scan(self, ctx, cls, method, nodes, active, guarded, exempt,
              seen):
        for node in nodes:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                held = active | {
                    ast.unparse(i.context_expr).strip()
                    for i in node.items
                }
                yield from self._scan(
                    ctx, cls, method, node.body, held, guarded, exempt,
                    seen,
                )
                continue
            attr = _self_attr(node)
            if attr in guarded and attr not in exempt:
                lock, _ = guarded[attr]
                key = (node.lineno, attr)
                if lock not in active and key not in seen:
                    seen.add(key)
                    yield self.finding(
                        ctx, node,
                        f"'self.{attr}' is guarded by '{lock}' but "
                        f"'{cls.name}.{method.name}' accesses it outside "
                        f"a 'with {lock}:' block",
                    )
            yield from self._scan(
                ctx, cls, method, ast.iter_child_nodes(node), active,
                guarded, exempt, seen,
            )
