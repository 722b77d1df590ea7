"""Task guard for the serving path's background tasks.

The port's copy of ``guard_task`` from ``emqx_tpu/broker/supervise.py``
(:408). The supervision tree around it (fault injection, circuit
breakers, the window journal, watchdogs) is not part of the port.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Optional

log = logging.getLogger("emqx.supervise")


def guard_task(task: "asyncio.Task", name: str, metrics=None,
               on_error: Optional[Callable[[BaseException], None]] = None
               ) -> "asyncio.Task":
    """Attach the one done-callback every pipeline task must carry: a
    non-cancelled exception is logged and counted
    (``supervise.task_errors``) instead of vanishing into the loop's
    never-retrieved-exception limbo. ``on_error`` lets owners add
    recovery (e.g. restart a worker)."""
    def _done(t: "asyncio.Task") -> None:
        if t.cancelled():
            return
        exc = t.exception()     # marks the exception as retrieved
        if exc is None:
            return
        if metrics is not None:
            try:
                metrics.inc("supervise.task_errors")
            except Exception:  # noqa: BLE001 — accounting must not mask
                pass           # the original failure being logged below
        log.error("task %r died: %s: %s", name, type(exc).__name__, exc,
                  exc_info=exc)
        if on_error is not None:
            try:
                on_error(exc)
            except Exception:  # noqa: BLE001
                log.exception("task %r on_error recovery failed", name)

    task.add_done_callback(_done)
    return task
