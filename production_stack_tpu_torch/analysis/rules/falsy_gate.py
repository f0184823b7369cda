"""falsy-walrus-gate: ``if x := f(...)`` where f returns falsy-but-meaningful
objects.

The bug class: aiohttp's ``web.json_response(...)`` is an *empty
MutableMapping*, so every ``if err := self._check(...):`` gate in the server
was dead — the error response existed but the branch never fired. Truthiness
gating a call that can return an empty-container-like object must compare
``is not None`` instead.

Detection: an ``if``/``elif``/``while`` test that is a bare walrus (or
``not`` of one) over a call whose target is either (a) a known
falsy-but-meaningful constructor (aiohttp responses, stdlib containers), or
(b) a function/method defined in the same module any of whose ``return``
statements produces such a value.
"""

from __future__ import annotations

import ast

from production_stack_tpu_torch.analysis.core import (
    ModuleContext,
    Rule,
    attr_tail,
    iter_functions,
    register,
)

#: call targets that construct objects which are meaningful even when falsy
FALSY_CONSTRUCTORS = {
    # aiohttp response types: empty MutableMappings, hence falsy
    "json_response", "Response", "StreamResponse", "WebSocketResponse",
    "HTTPOk", "FileResponse",
    # stdlib containers: empty instances are falsy but not "absent"
    "dict", "list", "set", "tuple", "frozenset", "bytes", "bytearray",
    "Counter", "OrderedDict", "defaultdict", "deque",
}


def _returns_falsy_prone(func) -> bool:
    """True if any ``return`` in ``func`` yields a falsy-but-meaningful
    value: a FALSY_CONSTRUCTORS call or an empty container literal."""
    for node in ast.walk(func):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        v = node.value
        if isinstance(v, ast.Call) and attr_tail(v.func) in \
                FALSY_CONSTRUCTORS:
            return True
        if isinstance(v, (ast.Dict, ast.List, ast.Set, ast.Tuple)) and \
                not getattr(v, "elts", getattr(v, "keys", None)):
            return True
    return False


def _truthy_walruses(test: ast.expr):
    """NamedExprs whose VALUE is what the branch truth-tests: the bare
    test, `not` of it, and `and`/`or` operands — but not walruses inside
    explicit comparisons (`(x := f()) is not None` is the correct form)."""
    if isinstance(test, ast.NamedExpr):
        yield test
    elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        yield from _truthy_walruses(test.operand)
    elif isinstance(test, ast.BoolOp):
        for v in test.values:
            yield from _truthy_walruses(v)


def _called(walrus: ast.NamedExpr) -> ast.Call | None:
    value = walrus.value
    if isinstance(value, ast.Await):  # async validators are the common
        value = value.value           # shape in an aiohttp server
    return value if isinstance(value, ast.Call) else None


@register
class FalsyWalrusGate(Rule):
    name = "falsy-walrus-gate"
    summary = (
        "truthiness-gated walrus over a call returning falsy-but-"
        "meaningful objects (e.g. aiohttp responses); the branch is dead"
    )

    def check(self, ctx: ModuleContext):
        local_falsy = {
            f.name for f in iter_functions(ctx.tree)
            if _returns_falsy_prone(f)
        }
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            for walrus in _truthy_walruses(node.test):
                call = _called(walrus)
                if call is None:
                    continue
                tail = attr_tail(call.func)
                if tail is None:
                    continue
                if tail in FALSY_CONSTRUCTORS or tail in local_falsy:
                    target = ast.unparse(walrus.target)
                    yield self.finding(
                        ctx, node,
                        f"'{tail}(...)' can return a falsy-but-"
                        f"meaningful object, so this truthiness gate "
                        f"can silently skip; test '({target} := "
                        f"{tail}(...)) is not None' instead",
                    )
