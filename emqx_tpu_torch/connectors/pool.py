"""Fixed-size asyncio connection pool (the ecpool analog).

Parity: the reference gives every connector an ecpool of N workers, each
holding one client connection (apps/emqx_connector/src/*, `pool_size`
field in emqx_connector_schema_lib.erl). Here: N lazily-(re)connected
client objects behind an asyncio queue; `run()` borrows one, retries once
on a connection-level failure with a fresh connection, and drops the
connection (slot reconnects lazily) on any other failure since the
protocol state is then unknown.

The port's copy of ``emqx_tpu/connectors/pool.py``.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Optional

_IO_ERRORS = (ConnectionError, asyncio.IncompleteReadError, EOFError,
              OSError)


class ConnPool:
    def __init__(self, factory: Callable[[], object], size: int = 4):
        self._factory = factory
        self.size = size
        self._free: asyncio.Queue = asyncio.Queue()
        self._clients: list = []
        self._started = False

    async def start(self) -> None:
        """Open the first connection eagerly (health signal); the rest
        connect lazily on first use."""
        if self._started:
            return
        self._started = True
        first = self._factory()
        try:
            await first.connect()
        except BaseException:
            self._started = False
            raise
        self._clients.append(first)
        self._free.put_nowait(first)
        for _ in range(self.size - 1):
            self._free.put_nowait(None)     # lazy slot

    async def stop(self) -> None:
        self._started = False
        for c in self._clients:
            await _safe_close(c)
        self._clients.clear()
        while not self._free.empty():
            self._free.get_nowait()

    async def _acquire(self):
        if not self._started:
            raise ConnectionError("pool not started")
        client = await self._free.get()
        if client is None:
            client = self._factory()
            try:
                await client.connect()
            except BaseException:
                # ANY connect failure (auth rejection included) must give
                # the slot token back or the pool shrinks to a deadlock
                self._free.put_nowait(None)
                raise
            self._clients.append(client)
        return client

    def _drop(self, client) -> None:
        if client in self._clients:
            self._clients.remove(client)
        if self._started:
            self._free.put_nowait(None)

    async def run(self, op: Callable[[object], Awaitable],
                  timeout: Optional[float] = None):
        """Run op(client) on a pooled connection."""
        client = await self._acquire()   # restores its slot on failure
        try:
            result = await asyncio.wait_for(op(client), timeout)
        except _IO_ERRORS:
            await _safe_close(client)
            try:
                await client.connect()
                result = await asyncio.wait_for(op(client), timeout)
            except BaseException:
                await _safe_close(client)
                self._drop(client)
                raise
            if self._started:
                self._free.put_nowait(client)
            return result
        except BaseException:
            await _safe_close(client)
            self._drop(client)
            raise
        else:
            if self._started:
                self._free.put_nowait(client)
            return result


async def _safe_close(client) -> None:
    try:
        await client.close()
    except Exception:  # noqa: BLE001
        pass
