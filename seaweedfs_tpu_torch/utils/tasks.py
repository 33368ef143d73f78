"""Supervised background-task spawning.

Port of seaweedfs_tpu/utils/tasks.py minus the trace id (spans are
ROADMAP A7).  A bare `asyncio.create_task(...)` whose handle nobody holds
has two failure modes: the event loop only keeps a WEAK reference to
running tasks, so the GC may collect (and thereby cancel) it mid-flight,
and any exception it dies with is never observed.

`spawn_logged` returns a real handle, optionally retains it in a
caller-owned registry (discarded on completion), and attaches a
done-callback that logs failures, so a dead drain lane or handler loop is
attributable.
"""
from __future__ import annotations

import asyncio
import logging
from typing import Any, Coroutine, MutableSet


def spawn_logged(
    coro: Coroutine[Any, Any, Any],
    log: logging.Logger,
    what: str,
    registry: MutableSet[asyncio.Task] | None = None,
) -> asyncio.Task:
    """Spawn `coro`, retain the task (in `registry` when given — the
    strong reference the event loop itself does not keep), and log any
    exception it dies with.  Cancellation is not an error and is not
    logged."""
    task = asyncio.ensure_future(coro)
    if registry is not None:
        registry.add(task)

    def _done(t: asyncio.Task) -> None:
        if registry is not None:
            registry.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            log.warning("background task %s died: %r", what, exc)

    task.add_done_callback(_done)
    return task
