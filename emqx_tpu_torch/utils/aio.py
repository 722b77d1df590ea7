"""Small asyncio compatibility helpers.

A copy of ``emqx_tpu/utils/aio.py`` (the port imports nothing from
``emqx_tpu``).

`timeout_after` is the Python 3.10-compatible stand-in for
``asyncio.timeout`` (3.11+): an async context manager that cancels the
enclosing task when the deadline passes and converts that cancellation
into ``asyncio.TimeoutError`` at the block's exit. cluster/rpc.py used
``asyncio.timeout`` directly, which made every cluster test fail at
import time on 3.10 boxes (AttributeError) — the "environmental"
failure set carried since the seed.

Semantics (the subset the repo needs, mirroring the stdlib manager):

- the block raises ``asyncio.TimeoutError`` when the deadline expires
  while the body is suspended at an await;
- a cancellation arriving from OUTSIDE the scope is NOT swallowed —
  only the scope's own deadline-cancel is converted (same idea as the
  stdlib's uncancel() accounting, implemented via the timed-out flag:
  when our handle never fired, the CancelledError propagates);
- the body finishing before the deadline cancels the timer and exits
  cleanly.

One nuance vs 3.11: if an external cancel races the deadline-cancel in
the same event-loop tick, the timeout wins (the stdlib would re-raise
CancelledError). The repo's two call sites (rpc connect/cast) treat
both outcomes as "give up on this channel", so the race is benign.
"""

from __future__ import annotations

import asyncio
from typing import Optional


class timeout_after:
    """``async with timeout_after(seconds): ...`` — 3.10-compatible
    ``asyncio.timeout``. ``seconds=None`` disables the deadline (the
    block runs unbounded, stdlib-compatible)."""

    def __init__(self, seconds: Optional[float]):
        self.seconds = seconds
        self._task: Optional[asyncio.Task] = None
        self._handle: Optional[asyncio.TimerHandle] = None
        self._timed_out = False

    def expired(self) -> bool:
        return self._timed_out

    async def __aenter__(self) -> "timeout_after":
        self._task = asyncio.current_task()
        if self.seconds is not None:
            loop = asyncio.get_running_loop()
            self._handle = loop.call_later(self.seconds,
                                           self._on_timeout)
        return self

    def _on_timeout(self) -> None:
        self._timed_out = True
        if self._task is not None:
            self._task.cancel()

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        if self._timed_out and exc_type is asyncio.CancelledError:
            raise asyncio.TimeoutError from exc
        return False
