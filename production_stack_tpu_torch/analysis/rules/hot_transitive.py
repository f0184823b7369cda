"""Transitive hot-path propagation: device-sync-transitive + blocking-hot.

``device-sync-hot`` judges only the marked function's own body, so
``float(logits[0])`` moved into an unmarked helper one call away from the
mark became invisible — and BLOCKING calls (sleep / file IO / sockets) on
sync hot paths were never checked at all (``blocking-async`` only looks
inside ``async def``). These two rules close both gaps by walking the
project call graph from every hot-marked entry point:

- ``device-sync-transitive``: a host-device sync forcer inside an
  UNMARKED helper reachable from a hot entry (depth >= 1). Depth 0 — a
  forcer lexically inside the marked function — stays ``device-sync-hot``
  territory, which is also why the one-hop indirection fixture passes
  ``--select device-sync-hot`` but fails the default run.
- ``blocking-hot``: a blocking call (the blocking-async target set)
  inside a SYNC hot entry or any sync helper reachable from one. Async
  hot entries are excluded — their stalls are the ``blocking-async``
  family's finding, and one hazard must map to one rule name.

Propagation stops at ``# stackcheck: not-hot`` boundaries (worker
submission seams, sanctioned fetch points — the def's comment says why)
and at hot-marked callees (they are their own entry points). Entry
points are the hot-marked functions and methods and the hot-marked
closures (``ProjectContext.closures``): under PyTorch a closure that runs
every round is as hot as the method that defines it. Findings
carry the shortest call chain from the entry so the indirection is
auditable in the report.
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
from production_stack_tpu_torch.analysis.rules.blocking_async import (
    BLOCKING_BUILTINS,
    BLOCKING_CALLS,
)
from production_stack_tpu_torch.analysis.rules.device_sync import (
    sync_forcers,
)


def _hot_entries(project: ProjectContext) -> list[FunctionInfo]:
    return [
        fn for fn in project.functions + project.closures if fn.is_hot
    ]


def _stop(fn: FunctionInfo) -> bool:
    # marked-hot callees are their own entry points; not-hot callees are
    # declared boundaries (the blocking body belongs there by design)
    return fn.is_hot or fn.is_not_hot


def _blocking_hits(fn: FunctionInfo) -> list[tuple[ast.Call, str]]:
    hits = []
    for site in fn.calls:
        call = site.node
        dotted = resolve_dotted(call.func, fn.ctx.import_aliases)
        if dotted in BLOCKING_CALLS:
            hits.append((call, dotted))
        elif isinstance(call.func, ast.Name) and \
                call.func.id in BLOCKING_BUILTINS and \
                call.func.id not in fn.ctx.import_aliases:
            hits.append((call, call.func.id))
    return hits


@register
class DeviceSyncTransitive(ProjectRule):
    name = "device-sync-transitive"
    summary = (
        "host-device sync forcer inside an unmarked helper reachable "
        "from a hot-path entry point (call chain reported)"
    )

    def check_project(self, project: ProjectContext):
        for entry in _hot_entries(project):
            reach = project.transitive_callees(entry, stop=_stop)
            for callee, chain in sorted(
                reach.items(), key=lambda kv: len(kv[1])
            ):
                for node, hit in sync_forcers(callee.node, callee.ctx):
                    yield Finding(
                        rule=self.name,
                        path=callee.ctx.path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"'{hit}' in '{callee.short}' forces a "
                            f"host-device sync on the hot path "
                            f"'{entry.name}' (reached via "
                            f"{format_chain(chain)}); move it off the "
                            f"dispatch path, mark the boundary "
                            f"`# stackcheck: not-hot` with why, or "
                            f"suppress the intended fetch point"
                        ),
                    )


@register
class BlockingOnHotPath(ProjectRule):
    name = "blocking-hot"
    summary = (
        "blocking call (sleep / HTTP / subprocess / file IO) inside a "
        "sync hot path or a helper reachable from one (call chain "
        "reported)"
    )

    def check_project(self, project: ProjectContext):
        for entry in _hot_entries(project):
            if entry.is_async:
                # event-loop stalls are blocking-async('s transitive
                # sibling)'s finding — don't double-name the hazard
                continue
            targets: list[tuple[FunctionInfo, tuple[FunctionInfo, ...]]]
            targets = [(entry, (entry,))]
            reach = project.transitive_callees(entry, stop=_stop)
            targets += sorted(
                reach.items(), key=lambda kv: len(kv[1])
            )
            for fn, chain in targets:
                if fn.is_async:
                    continue
                for call, label in _blocking_hits(fn):
                    where = (
                        f"hot path '{entry.name}'" if fn is entry else
                        f"'{fn.short}' on the hot path "
                        f"'{entry.name}' (reached via "
                        f"{format_chain(chain)})"
                    )
                    yield Finding(
                        rule=self.name,
                        path=fn.ctx.path,
                        line=call.lineno,
                        col=call.col_offset,
                        message=(
                            f"blocking call '{label}(...)' inside "
                            f"{where}; move it to the offload worker/"
                            f"executor or mark the boundary "
                            f"`# stackcheck: not-hot` with why"
                        ),
                    )
