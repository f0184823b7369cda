"""fire-and-forget-task: spawned asyncio tasks whose handle is dropped.

``asyncio.create_task(loop())`` as a bare statement has two failure modes:
the task can be garbage-collected mid-flight (the loop keeps only a weak
reference), and an exception inside it is reported only at interpreter
shutdown ("Task exception was never retrieved") — the background loop is
simply *gone* while the router keeps serving with stale state.

A spawn is fine when the handle is stored (assigned / awaited / returned /
passed to gather), best when it also gets a done-callback; this repo's
idiom is ``production_stack_tpu_torch.utils.tasks.spawn_watched`` which
does both.
"""

from __future__ import annotations

import ast

from production_stack_tpu_torch.analysis.core import (
    ModuleContext,
    Rule,
    attr_tail,
    register,
)

#: spawn_watched included: its done-callback logs the death, but a
#: dropped handle can still be GC'd mid-flight and cannot be cancelled
SPAWNER_TAILS = {"create_task", "ensure_future", "spawn_watched"}


def _spawner_call(value: ast.expr) -> ast.Call | None:
    if isinstance(value, ast.Call) and attr_tail(value.func) in \
            SPAWNER_TAILS:
        return value
    return None


@register
class FireAndForgetTask(Rule):
    name = "fire-and-forget-task"
    summary = (
        "asyncio.create_task/ensure_future result dropped: the task can "
        "be GC'd and its exceptions vanish"
    )

    def check(self, ctx: ModuleContext):
        for node in ast.walk(ctx.tree):
            call = None
            if isinstance(node, ast.Expr):
                call = _spawner_call(node.value)
            elif isinstance(node, ast.Assign) and all(
                isinstance(t, ast.Name) and t.id == "_"
                for t in node.targets
            ):
                call = _spawner_call(node.value)
            if call is None:
                continue
            tail = attr_tail(call.func)
            yield self.finding(
                ctx, node,
                f"'{tail}(...)' result is dropped: store the handle and "
                f"attach a done-callback that logs/surfaces exceptions "
                f"(use utils.tasks.spawn_watched)",
            )
