"""exactly-once-note: every finish path notes SLO exactly once.

The SLO tracker double-counts a request if a finish path calls
``_note_slo`` twice, and silently drops it from burn-rate math if a
path returns without noting — both corrupt the per-tenant violation
ratios the autoscaler keys on. A function marked
``# stackcheck: slo-finish`` promises: every RETURN path reaches an
SLO note exactly once.

The check is an interval dataflow over the function body: each
statement contributes a [lo, hi] note-count delta, branches merge to
[min, max], ``finally`` deltas are added to every return that the
finally spans, loop bodies widen only the upper bound (zero iterations
is always possible), and exception exits (``raise``) are NOT finish
paths — a raise hands the noting obligation to the caller. A return is
flagged when lo == 0 (some path can finish un-noted) or lo >= 2 (every
path through it notes at least twice). lo == 1 with hi > 1 is left
alone: the conditional second note is almost always the violation
branch (intended), and flagging it would train people to suppress.

"Noting" counts direct calls to ``_note_slo`` /
``record_shed_observation`` AND delegation: a resolved callee that is
itself marked ``slo-finish`` (e.g. ``return await
self.process_request(...)``) or that reaches a note call in its own
transitive body (e.g. ``self._shed_response(...)``) counts as one note.
Intentional un-noted returns (client disconnects mid-stream, local
input-validation rejects that never entered the pipeline) carry a
``# stackcheck: disable=exactly-once-note — why`` on the return line.
"""

from __future__ import annotations

import ast

from production_stack_tpu_torch.analysis.callgraph import (
    FunctionInfo,
    ProjectContext,
)
from production_stack_tpu_torch.analysis.core import (
    Finding,
    ProjectRule,
    attr_tail,
    register,
)

NOTE_NAMES = frozenset({"_note_slo", "record_shed_observation"})

#: interval bound — loops and pathological nesting saturate here; only
#: the LOWER bound drives findings, so the cap is purely for termination
_CAP = 9

_Interval = "tuple[int, int] | None"  # None = unreachable


def _merge(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return (min(a[0], b[0]), max(a[1], b[1]))


def _add(a, delta):
    if a is None:
        return None
    return (min(a[0] + delta[0], _CAP), min(a[1] + delta[1], _CAP))


def _scoped_walk(node: ast.AST):
    """Walk a subtree without descending into nested def/class/lambda
    bodies (their notes belong to their own execution, not this path)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _body_notes_directly(fn: FunctionInfo) -> bool:
    return any(
        attr_tail(s.node.func) in NOTE_NAMES for s in fn.calls
    )


def _notes_reachable(
    fn: FunctionInfo, project: ProjectContext, cache: dict[int, bool]
) -> bool:
    """Does ``fn`` reach a note call through its own body or any
    resolved transitive callee? Cached; cycle-safe (BFS)."""
    key = id(fn)
    if key in cache:
        return cache[key]
    result = _body_notes_directly(fn) or any(
        _body_notes_directly(callee)
        for callee in project.transitive_callees(fn)
    )
    cache[key] = result
    return result


@register
class ExactlyOnceNote(ProjectRule):
    name = "exactly-once-note"
    summary = (
        "a finish path of a `# stackcheck: slo-finish` function "
        "returns without noting SLO, or notes it twice — either "
        "corrupts per-tenant burn-rate accounting"
    )

    def check_project(self, project: ProjectContext):
        reach_cache: dict[int, bool] = {}
        for fn in project.functions:
            if not fn.is_slo_finish:
                continue
            yield from _PathAnalyzer(
                self.name, fn, project, reach_cache
            ).run()


class _PathAnalyzer:
    """One slo-finish function's interval dataflow pass."""

    def __init__(
        self,
        rule: str,
        fn: FunctionInfo,
        project: ProjectContext,
        reach_cache: dict[int, bool],
    ):
        self.rule = rule
        self.fn = fn
        self.project = project
        self.reach_cache = reach_cache
        self.callmap = {id(s.node): s.callee for s in fn.calls}
        self.findings: list[Finding] = []

    def run(self):
        ft = self._block(self.fn.node.body, (0, 0), (), emit=True)
        if ft is not None and (ft[0] == 0 or ft[0] >= 2):
            node = self.fn.node
            self.findings.append(Finding(
                rule=self.rule,
                path=self.fn.ctx.path,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"'{self.fn.short}' can fall off the end with "
                    f"note count in [{ft[0]}, {ft[1]}]; every finish "
                    f"path of a slo-finish function must note SLO "
                    f"exactly once"
                ),
            ))
        return self.findings

    # -- noting predicate ---------------------------------------------------
    def _call_notes(self, call: ast.Call) -> bool:
        if attr_tail(call.func) in NOTE_NAMES:
            return True
        callee = self.callmap.get(id(call))
        if callee is None:
            return False
        return callee.is_slo_finish or _notes_reachable(
            callee, self.project, self.reach_cache
        )

    def _count(self, node: ast.AST | None) -> int:
        if node is None:
            return 0
        return sum(
            1 for n in _scoped_walk(node)
            if isinstance(n, ast.Call) and self._call_notes(n)
        )

    def _max_notes(self, stmts: list[ast.stmt]) -> int:
        return min(sum(self._count(s) for s in stmts), _CAP)

    # -- dataflow -----------------------------------------------------------
    def _block(self, stmts, cur, finallies, emit):
        for stmt in stmts:
            cur = self._stmt(stmt, cur, finallies, emit)
            if cur is None:
                break  # statements after return/raise are dead code
        return cur

    def _stmt(self, stmt, cur, finallies, emit):
        if isinstance(stmt, ast.Return):
            eff = _add(cur, (self._count(stmt.value),) * 2)
            for fstmts in reversed(finallies):
                delta = self._block(fstmts, (0, 0), (), emit=False)
                if delta is not None:
                    eff = _add(eff, delta)
            if emit and eff is not None and (eff[0] == 0 or eff[0] >= 2):
                self._flag_return(stmt, eff)
            return None
        if isinstance(stmt, (ast.Raise, ast.Break, ast.Continue)):
            # raise is not a finish path; break/continue approximated
            # as ending the linear walk of this block
            return None
        if isinstance(stmt, ast.If):
            cur = _add(cur, (self._count(stmt.test),) * 2)
            b = self._block(stmt.body, cur, finallies, emit)
            o = self._block(stmt.orelse, cur, finallies, emit)
            return _merge(b, o)
        if isinstance(stmt, ast.Try):
            fin = stmt.finalbody
            inner = finallies + (fin,) if fin else finallies
            body_ft = self._block(stmt.body, cur, inner, emit)
            if body_ft is not None and stmt.orelse:
                body_ft = self._block(
                    stmt.orelse, body_ft, inner, emit
                )
            out = body_ft
            if stmt.handlers:
                hentry = None if cur is None else (
                    cur[0],
                    min(cur[1] + self._max_notes(stmt.body), _CAP),
                )
                for h in stmt.handlers:
                    out = _merge(
                        out,
                        self._block(h.body, hentry, inner, emit),
                    )
            if fin:
                # the fall-through runs the finally once, for real:
                # analyze it HERE with emit so returns inside it are
                # judged against the merged entry
                out = self._block(fin, out, finallies, emit)
            return out
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            extra = self._max_notes(stmt.body)
            entry = None if cur is None else (
                cur[0], min(cur[1] + extra, _CAP)
            )
            self._block(stmt.body, entry, finallies, emit)
            after = entry  # zero iterations keeps lo at cur[0]
            if stmt.orelse:
                after = self._block(
                    stmt.orelse, after, finallies, emit
                )
            return after
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            n = sum(self._count(item) for item in stmt.items)
            return self._block(
                stmt.body, _add(cur, (n, n)), finallies, emit
            )
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return cur  # nested scope: its notes are its own
        # simple statement: count notes in the whole expression tree
        n = self._count(stmt)
        return _add(cur, (n, n))

    def _flag_return(self, stmt: ast.Return, eff):
        if eff[0] == 0:
            what = (
                f"finish path can return with ZERO SLO notes "
                f"(note count in [{eff[0]}, {eff[1]}])"
            )
            fix = (
                "note before returning, or suppress with why if this "
                "path deliberately never entered the pipeline"
            )
        else:
            what = (
                f"finish path notes SLO at least {eff[0]} times"
            )
            fix = "every finish path must note exactly once"
        self.findings.append(Finding(
            rule=self.rule,
            path=self.fn.ctx.path,
            line=stmt.lineno,
            col=stmt.col_offset,
            message=(
                f"{what} in slo-finish function "
                f"'{self.fn.short}'; {fix}"
            ),
        ))
