"""wall-clock-banned: monotonic-only scopes must not reach wall-clock.

Interval math in router stats, admission control, and SLO tracking MUST
use ``time.monotonic()`` — wall clock jumps under NTP slew and breaks
latency accounting (the router stats, admission and SLO invariant). The
``# stackcheck: monotonic-only`` marker on a module (any marker line not
attached to a class) or on a ``class`` def adopts this rule for that
scope:

- DIRECT: a banned wall-clock call inside a marked function/method, or
  at module level of a marked module, is flagged where it stands.
- TRANSITIVE: a banned call inside an UNMARKED project function that a
  marked function reaches through resolved call edges is flagged at the
  IN-SCOPE call site (the first hop out of the marked scope), with the
  full chain in the message — so the suppression/fix always lands in
  the file that owns the invariant.
- IMPORT BAN: a marked MODULE may not import ``datetime`` at all
  (timezone-aware timestamps belong to the edges, not the monotonic
  core) — this keeps test_slo's stricter historical pin.

``time.monotonic`` / ``perf_counter`` / ``process_time`` and
``time.monotonic_ns`` remain free; only absolute-epoch and calendar
sources are banned.
"""

from __future__ import annotations

import ast

from production_stack_tpu_torch.analysis.callgraph import (
    FunctionInfo,
    ProjectContext,
    format_chain,
)
from production_stack_tpu_torch.analysis.core import (
    Finding,
    ProjectRule,
    register,
    resolve_dotted,
)

BANNED_WALL_CLOCK = frozenset({
    "time.time",
    "time.time_ns",
    "time.localtime",
    "time.gmtime",
    "time.ctime",
    "time.strftime",
    "datetime.datetime.now",
    "datetime.datetime.today",
    "datetime.datetime.utcnow",
    "datetime.date.today",
})


def _banned_hits(fn: FunctionInfo) -> list[tuple[ast.Call, str]]:
    hits = []
    for site in fn.calls:
        dotted = resolve_dotted(site.node.func, fn.ctx.import_aliases)
        if dotted in BANNED_WALL_CLOCK:
            hits.append((site.node, dotted))
    return hits


@register
class WallClockBanned(ProjectRule):
    name = "wall-clock-banned"
    summary = (
        "wall-clock source (time.time / datetime.now) used in — or "
        "reachable from — a `# stackcheck: monotonic-only` scope; "
        "interval math must use time.monotonic()"
    )

    def check_project(self, project: ProjectContext):
        yield from self._module_scope(project)
        for fn in project.functions:
            if not fn.monotonic:
                continue
            for call, label in _banned_hits(fn):
                yield Finding(
                    rule=self.name,
                    path=fn.ctx.path,
                    line=call.lineno,
                    col=call.col_offset,
                    message=(
                        f"wall-clock call '{label}(...)' in "
                        f"monotonic-only scope '{fn.short}'; use "
                        f"time.monotonic() for intervals (wall clock "
                        f"jumps under NTP)"
                    ),
                )
            reach = project.transitive_callees(fn)
            for callee, chain in sorted(
                reach.items(), key=lambda kv: len(kv[1])
            ):
                if callee.monotonic:
                    # a marked callee is judged as its own root
                    continue
                hits = _banned_hits(callee)
                if not hits:
                    continue
                first_hop = chain[1]
                site = next(
                    (s for s in fn.calls if s.callee is first_hop), None
                )
                if site is None:  # pragma: no cover - defensive
                    continue
                labels = ", ".join(sorted({h[1] for h in hits}))
                yield Finding(
                    rule=self.name,
                    path=fn.ctx.path,
                    line=site.line,
                    col=site.col,
                    message=(
                        f"monotonic-only scope '{fn.short}' reaches "
                        f"wall-clock '{labels}' via "
                        f"{format_chain(chain)}; use time.monotonic() "
                        f"in the helper or stop calling it from "
                        f"monotonic-only code"
                    ),
                )

    def _module_scope(self, project: ProjectContext):
        """Module-level banned calls + the datetime import ban, for
        modules whose marker is module-scope."""
        for mod in project.modules.values():
            if not mod.monotonic:
                continue
            ctx = mod.ctx
            for stmt in ctx.tree.body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if isinstance(stmt, ast.Import):
                    for a in stmt.names:
                        if a.name.split(".")[0] == "datetime":
                            yield self._import_finding(ctx, stmt)
                    continue
                if isinstance(stmt, ast.ImportFrom):
                    if stmt.level == 0 and stmt.module and \
                            stmt.module.split(".")[0] == "datetime":
                        yield self._import_finding(ctx, stmt)
                    continue
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    dotted = resolve_dotted(
                        node.func, ctx.import_aliases
                    )
                    if dotted in BANNED_WALL_CLOCK:
                        yield Finding(
                            rule=self.name,
                            path=ctx.path,
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"wall-clock call '{dotted}(...)' at "
                                f"module level of monotonic-only "
                                f"module; use time.monotonic()"
                            ),
                        )

    def _import_finding(
        self, ctx, stmt: ast.Import | ast.ImportFrom
    ) -> Finding:
        return Finding(
            rule=self.name,
            path=ctx.path,
            line=stmt.lineno,
            col=stmt.col_offset,
            message=(
                "monotonic-only module imports datetime; calendar "
                "timestamps belong at the edges (logging/export), not "
                "in interval-math modules"
            ),
        )
