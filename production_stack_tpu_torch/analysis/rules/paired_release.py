"""paired-release: admission admit() must pair with release in a finally.

The admission controller's concurrency/token accounting leaks a slot
forever if a request path admits and then raises before releasing — the
invariant is ``ticket = admission.admit(...)`` followed by a
``try: ... finally: admission.release(ticket)`` (or ``refund``) that
spans the request's lifetime.

Scope is deliberately precise to stay false-positive-free: only
``.admit(...)`` calls on a local that was bound from a known acquisition
factory (``get_admission_controller()``) IN THE SAME FUNCTION are
checked — ``.admit()`` on kv-tier reporters or on parameters is a
different protocol and is ignored. The pairing requirement is
structural, not path-sensitive: somewhere at-or-after the admit there
must be a ``try`` whose ``finally`` calls ``release``/``refund`` on the
same receiver (early returns on denied admits are fine; the leak this
catches is the missing finally, not the denial branch).
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

#: call targets whose result is an admission-style acquirer: a local
#: bound from one of these makes its ``.admit()`` calls contract-checked
ACQUIRE_FACTORIES = frozenset({"get_admission_controller"})
RELEASE_NAMES = frozenset({"release", "refund"})


@register
class PairedRelease(Rule):
    name = "paired-release"
    summary = (
        "admission admit() without a release()/refund() on the same "
        "controller in a finally spanning the call — a raise on the "
        "request path leaks the admission slot forever"
    )

    def check(self, ctx: ModuleContext):
        for func in iter_functions(ctx.tree):
            receivers: set[str] = set()
            admits: list[tuple[ast.Call, str]] = []
            tries: list[ast.Try] = []
            for node in walk_function_body(func):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call) and \
                        attr_tail(node.value.func) in ACQUIRE_FACTORIES:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            receivers.add(t.id)
                elif isinstance(node, ast.Try):
                    tries.append(node)
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "admit" and \
                        isinstance(node.func.value, ast.Name):
                    admits.append((node, node.func.value.id))
            for call, recv in admits:
                if recv not in receivers:
                    continue
                if any(
                    self._finally_releases(t, recv)
                    and (t.end_lineno or t.lineno) >= call.lineno
                    for t in tries
                ):
                    continue
                yield self.finding(
                    ctx, call,
                    f"'{recv}.admit(...)' has no "
                    f"'{recv}.release/refund(...)' in a finally "
                    f"spanning the call; wrap the admitted section in "
                    f"try/finally so an exception cannot leak the "
                    f"admission slot",
                )

    @staticmethod
    def _finally_releases(node: ast.Try, recv: str) -> bool:
        for stmt in node.finalbody:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in RELEASE_NAMES and \
                        isinstance(sub.func.value, ast.Name) and \
                        sub.func.value.id == recv:
                    return True
        return False
