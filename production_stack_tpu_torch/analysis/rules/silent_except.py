"""silent-except: ``except Exception`` that neither logs, re-raises, nor
surfaces the error.

On router/engine request paths a swallowed exception turns a hard bug into
an unobservable routing/serving anomaly (the KV-aware router silently
degrading to its fallback, a probe failing forever without a line of log).
A broad handler must do at least one of: re-raise, call a logger, or use
the captured exception value (e.g. embed it in an error response).
"""

from __future__ import annotations

import ast

from production_stack_tpu_torch.analysis.core import (
    ModuleContext,
    Rule,
    register,
)

LOG_METHOD_NAMES = {
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "log", "print_exc", "print_exception",
}

BROAD_TYPES = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:  # bare except:
        return True
    if isinstance(t, ast.Name) and t.id in BROAD_TYPES:
        return True
    if isinstance(t, ast.Tuple):
        return any(
            isinstance(e, ast.Name) and e.id in BROAD_TYPES for e in t.elts
        )
    return False


def _handles_visibly(handler: ast.ExceptHandler) -> bool:
    """True if the handler raises, logs, or uses the captured exception."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in LOG_METHOD_NAMES:
                return True
            if isinstance(f, ast.Name) and f.id in ("print",):
                return True
        if handler.name and isinstance(node, ast.Name) and \
                node.id == handler.name and isinstance(node.ctx, ast.Load):
            return True
    return False


@register
class SilentBroadExcept(Rule):
    name = "silent-except"
    summary = (
        "broad 'except Exception' that neither logs, re-raises, nor "
        "uses the exception — failures become invisible"
    )

    def check(self, ctx: ModuleContext):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node):
                continue
            if _handles_visibly(node):
                continue
            what = "bare 'except:'" if node.type is None else \
                f"'except {ast.unparse(node.type)}'"
            yield self.finding(
                ctx, node,
                f"{what} swallows the error silently; log it, re-raise, "
                f"or surface the exception value",
            )
