"""Watched asyncio task spawning.

A bare ``asyncio.create_task(loop())`` has two failure modes stackcheck's
fire-and-forget-task rule exists to catch: the event loop holds only a weak
reference (the task can be garbage-collected mid-flight), and an exception
inside it surfaces only at interpreter shutdown — the background loop is
silently gone while the router keeps serving with stale state.

``spawn_watched`` is the repo idiom for every background loop: it returns
the handle (caller stores it for cancellation on close) AND attaches a
done-callback that logs any exception at error level, so a dead scrape /
watch / poll loop shows up in the logs the moment it dies.
"""

from __future__ import annotations

import asyncio
from collections.abc import Coroutine

from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)


def _log_task_result(task: asyncio.Task) -> None:
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logger.error(
            "background task %r died: %r", task.get_name(), exc,
            exc_info=exc,
        )


def spawn_watched(
    coro: Coroutine, name: str | None = None
) -> asyncio.Task:
    """Create a task whose death is never silent.

    Returns the task handle — store it and cancel on close, exactly like a
    bare create_task — with a done-callback already attached that logs
    non-cancellation exceptions."""
    task = asyncio.ensure_future(coro)
    if name is not None:
        task.set_name(name)
    task.add_done_callback(_log_task_result)
    return task
