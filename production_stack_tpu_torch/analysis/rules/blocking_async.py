"""blocking-async: synchronous blocking calls inside ``async def`` bodies.

One blocked event loop stalls EVERY in-flight request: the serving-
bottleneck literature (FlowKV; "Understanding Bottlenecks for Efficiently
Serving LLM Inference with KV Offloading") shows host-side stalls like
these dominating tail latency. ``time.sleep``, sync HTTP (``requests``,
``urllib``), socket setup, ``subprocess`` and direct file ``open`` must
move to ``asyncio`` equivalents or ``loop.run_in_executor``.

Nested ``def``s inside the coroutine are skipped: they are typically the
very closures shipped to an executor.
"""

from __future__ import annotations

import ast

from production_stack_tpu_torch.analysis.core import (
    ModuleContext,
    Rule,
    register,
    resolve_dotted,
    walk_function_body,
)

#: dotted call targets that block the calling thread
BLOCKING_CALLS = {
    "time.sleep",
    "requests.get", "requests.post", "requests.put", "requests.delete",
    "requests.head", "requests.patch", "requests.request",
    "requests.Session",
    "urllib.request.urlopen", "urllib.request.urlretrieve",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.getoutput",
    "subprocess.getstatusoutput", "subprocess.Popen",
    "os.system", "os.popen", "os.wait", "os.waitpid",
    "socket.create_connection", "socket.getaddrinfo",
    "socket.gethostbyname", "socket.gethostbyaddr",
    "http.client.HTTPConnection", "http.client.HTTPSConnection",
    "shutil.copy", "shutil.copy2", "shutil.copytree", "shutil.rmtree",
}

#: bare builtins that hit the filesystem / tty synchronously
BLOCKING_BUILTINS = {"open", "input"}


@register
class BlockingCallInAsync(Rule):
    name = "blocking-async"
    summary = (
        "synchronous blocking call (sleep / HTTP / subprocess / file "
        "I/O) inside an async def stalls the whole event loop"
    )

    def check(self, ctx: ModuleContext):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for inner in walk_function_body(node):
                if not isinstance(inner, ast.Call):
                    continue
                dotted = resolve_dotted(inner.func, ctx.import_aliases)
                hit = None
                if dotted in BLOCKING_CALLS:
                    hit = dotted
                elif isinstance(inner.func, ast.Name) and \
                        inner.func.id in BLOCKING_BUILTINS and \
                        inner.func.id not in ctx.import_aliases:
                    hit = inner.func.id
                if hit is not None:
                    yield self.finding(
                        ctx, inner,
                        f"blocking call '{hit}(...)' inside 'async def "
                        f"{node.name}' stalls the event loop; use the "
                        f"asyncio equivalent or loop.run_in_executor",
                    )
