"""blocking-async-transitive: blocking calls in async-only sync helpers.

``blocking-async`` only inspects ``async def`` bodies, so a sync
helper that does ``time.sleep`` / ``open()`` and is ONLY ever called
from coroutine handlers stalls the event loop invisibly. This rule
propagates async context through the call graph: a sync function is
*async-only* when it has at least one project caller and EVERY caller is
either an ``async def`` or itself async-only (greatest fixed point, so
mutually-recursive helper pairs reached only from coroutines still
count). A sync function with any sync caller — or with no resolved
caller at all (it may be an external entry point, a thread body, or an
executor target) — is conservatively NOT async-only.

Findings land on the blocking call inside the helper, with one concrete
async caller chain in the message so the loop exposure is auditable.
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

_MAX_CALLER_CHAIN = 8


@register
class BlockingInAsyncOnlyHelper(ProjectRule):
    name = "blocking-async-transitive"
    summary = (
        "blocking call inside a sync helper that is only ever called "
        "from async context — it stalls the event loop exactly like a "
        "blocking call in the coroutine itself"
    )

    def check_project(self, project: ProjectContext):
        callers = project.callers_of()
        # greatest fixed point: start optimistic for every called sync
        # function, then strip any whose caller set includes a
        # non-async-context caller, until stable
        async_only: dict[int, bool] = {}
        sync_fns: dict[int, FunctionInfo] = {}
        for fn in project.functions:
            if not fn.is_async and callers.get(id(fn)):
                async_only[id(fn)] = True
                sync_fns[id(fn)] = fn
        changed = True
        while changed:
            changed = False
            for key, fn in sync_fns.items():
                if not async_only[key]:
                    continue
                for c in callers[key]:
                    if c.is_async or async_only.get(id(c), False):
                        continue
                    async_only[key] = False
                    changed = True
                    break
        for key, fn in sync_fns.items():
            if not async_only[key]:
                continue
            hits = self._blocking_hits(fn)
            if not hits:
                continue
            chain = self._async_chain(fn, callers, async_only)
            via = (
                f" (only called from async context: "
                f"{format_chain(chain)})" if chain else ""
            )
            for call, label in hits:
                yield Finding(
                    rule=self.name,
                    path=fn.ctx.path,
                    line=call.lineno,
                    col=call.col_offset,
                    message=(
                        f"blocking call '{label}(...)' inside sync "
                        f"helper '{fn.short}'{via}; it stalls the "
                        f"event loop — use the asyncio equivalent or "
                        f"run the helper in an executor"
                    ),
                )

    @staticmethod
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

    @staticmethod
    def _async_chain(
        fn: FunctionInfo,
        callers: dict[int, list[FunctionInfo]],
        async_only: dict[int, bool],
    ) -> tuple[FunctionInfo, ...]:
        """Walk caller links up to the nearest ``async def`` for the
        finding message; cycle-safe, bounded."""
        chain: list[FunctionInfo] = [fn]
        seen = {id(fn)}
        cur = fn
        for _ in range(_MAX_CALLER_CHAIN):
            nxt = None
            for c in callers.get(id(cur), []):
                if id(c) in seen:
                    continue
                if c.is_async:
                    return tuple(reversed(chain + [c]))
                if async_only.get(id(c), False):
                    nxt = c
                    break
            if nxt is None:
                break
            seen.add(id(nxt))
            chain.append(nxt)
            cur = nxt
        return tuple(reversed(chain))
