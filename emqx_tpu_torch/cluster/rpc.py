"""Data-plane RPC: the gen_rpc analog.

The port's copy of ``emqx_tpu/cluster/rpc.py`` (the port imports nothing
from ``emqx_tpu``). The frame format is the reference's byte for byte
(`encode_frame`, `read_frame`, ``$b`` and ``$set``), so a port node and a
reference node talk to each other.

Parity: emqx_rpc.erl:20-60 — per-peer pool of `tcp_client_num` TCP channels,
per-key channel pinning via hash to preserve per-topic ordering, sync `call`
vs async `cast`. Here: asyncio TCP with length-prefixed JSON frames and a
shared-cookie handshake (the Erlang-distribution cookie analog).

This is the host-side DCN path of the TPU design (SURVEY.md §5.8): intra-chip
fan-out happens on device via collectives; cross-host forwarding rides these
key-pinned streams so per-topic order is preserved end to end.

Wire frame: 4-byte big-endian length + JSON object. Bytes values are encoded
as {"$b": base64}. Messages:
  {"t":"hello","node":...,"cookie":...}      handshake (first frame)
  {"t":"call","id":N,"fn":...,"args":[...]}  sync request
  {"t":"reply","id":N,"ok":bool,"val":...}   response
  {"t":"cast","fn":...,"args":[...]}         async, no response
"""

from __future__ import annotations

import asyncio

from emqx_tpu_torch.broker.supervise import spawn
from emqx_tpu_torch.utils.aio import timeout_after
import base64
import json
import logging
from typing import Any, Awaitable, Callable, Optional

log = logging.getLogger("emqx_tpu_torch.cluster.rpc")

DEFAULT_CHANNELS = 4          # gen_rpc tcp_client_num default is 1; we pin 4
CALL_TIMEOUT = 10.0
CONNECT_TIMEOUT = 5.0         # TCP connect + hello handshake bound: a
# FROZEN peer (SIGSTOP — gray failure) accepts TCP and then never answers
# the hello; an unbounded handshake parked the heartbeat loop, so
# failure detection never fired and every caller waited its full budget


class RpcError(Exception):
    """badrpc analog (emqx_rpc.erl filters {badrpc,_} / {badtcp,_})."""


def _enc(obj: Any) -> Any:
    if isinstance(obj, (bytes, bytearray)):
        return {"$b": base64.b64encode(bytes(obj)).decode()}
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    if isinstance(obj, set):
        return {"$set": [_enc(v) for v in sorted(obj, key=repr)]}
    return obj


def _dec(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "$b" in obj and len(obj) == 1:
            return base64.b64decode(obj["$b"])
        if "$set" in obj and len(obj) == 1:
            return set(_dec(v) for v in obj["$set"])
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


def encode_frame(msg: dict) -> bytes:
    body = json.dumps(_enc(msg), separators=(",", ":")).encode()
    return len(body).to_bytes(4, "big") + body


async def read_frame(reader: asyncio.StreamReader,
                     max_len: int = 64 << 20) -> Optional[dict]:
    try:
        hdr = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    n = int.from_bytes(hdr, "big")
    if n > max_len:
        raise RpcError(f"frame too large: {n}")
    try:
        body = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    return _dec(json.loads(body))


class _Channel:
    """One outbound TCP connection to a peer; serialized writes keep
    per-channel ordering (the gen_rpc per-key stream)."""

    def __init__(self, host: str, port: int, node: str, cookie: str):
        self.host, self.port = host, port
        self.node, self.cookie = node, cookie
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self._pending: dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._lock = asyncio.Lock()
        self._reader_task: Optional[asyncio.Task] = None

    async def connect(self) -> None:
        if self._reader_task:      # stale reader from a dead connection must
            self._reader_task.cancel()   # not fail the new one's futures
            self._reader_task = None
        # abandoning the old connection means its in-flight calls can
        # never be answered: fail them NOW. (The cancelled stale reader
        # skips its own cleanup via the current-task guard, so without
        # this, a racing call whose send beat the reconnect would park
        # for its full timeout when this connect() fails.)
        self._fail_pending(RpcError("connection closed"))
        try:
            # 3.10-compatible deadline (asyncio.timeout is 3.11+;
            # utils.aio.timeout_after converts only OUR deadline
            # cancel into TimeoutError)
            async with timeout_after(CONNECT_TIMEOUT):
                self.reader, self.writer = await asyncio.open_connection(
                    self.host, self.port)
                self.writer.write(encode_frame(
                    {"t": "hello", "node": self.node,
                     "cookie": self.cookie}))
                await self.writer.drain()
                ack = await read_frame(self.reader)
            if not ack or ack.get("t") != "hello_ok":
                raise RpcError(
                    f"handshake rejected by {self.host}:{self.port}")
            self._reader_task = asyncio.create_task(self._read_loop())
        except BaseException:
            # timeout, reject, OR cancellation mid-handshake: never leave
            # the channel half-open (writer alive, no reader) — the NEXT
            # call would park for its full budget instead of failing fast
            if self.writer is not None:
                self.writer.close()
                self.writer = None
            raise

    async def _read_loop(self) -> None:
        # EVERY exit path — clean EOF (FIN), connection reset (RST: a
        # peer SIGKILLed with unread data), or any codec error — must
        # close OUR writer and fail the pending calls. An unhandled RST
        # used to kill this task silently, leaving the channel half-open:
        # `alive` still passed, the next call()'s write landed in a dead
        # socket, and its future parked for the full timeout — observed
        # as a CONNECT stalling ~35s on the clientid lock right after a
        # peer was killed (pre-nodedown-detection window).
        try:
            while True:
                msg = await read_frame(self.reader)
                if msg is None:
                    break
                if msg.get("t") == "reply":
                    fut = self._pending.pop(msg["id"], None)
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
        except Exception:  # noqa: BLE001 — reset/codec: same cleanup
            pass
        finally:
            # a STALE reader cancelled by a reconnect must not touch the
            # NEW connection's state. connect() cancels the old task and
            # nulls _reader_task with NO await between the two, so by the
            # time the cancelled reader's finally runs, this guard is
            # False exactly for it (do not insert an await there)
            if self._reader_task is asyncio.current_task():
                if self.writer is not None:
                    try:
                        self.writer.close()
                    except Exception:  # noqa: BLE001
                        pass
                self._fail_pending(RpcError("connection closed"))

    def _fail_pending(self, err: Exception) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()

    @property
    def alive(self) -> bool:
        return self.writer is not None and not self.writer.is_closing()

    async def send(self, msg: dict) -> None:
        async with self._lock:
            if not self.alive:
                await self.connect()
            self.writer.write(encode_frame(msg))
            await self.writer.drain()

    async def call(self, fn: str, args: list,
                   timeout: float = CALL_TIMEOUT) -> Any:
        self._next_id += 1
        rid = self._next_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        data = encode_frame({"t": "call", "id": rid, "fn": fn, "args": args})

        async def _go():
            # register the future only once the connection is up, under
            # the send lock: connect() fails every pending future (they
            # belong to the dead connection), so registering earlier
            # would let our own reconnect kill this call
            async with self._lock:
                if not self.alive:
                    await self.connect()
                self._pending[rid] = fut
                self.writer.write(data)
                await self.writer.drain()
            return await fut

        try:
            # the timeout covers the WHOLE call — including the connect/
            # handshake phase, which parks indefinitely against a frozen
            # peer (connect() cleans up its own state on cancellation)
            reply = await asyncio.wait_for(_go(), timeout)
        except (asyncio.TimeoutError, ConnectionError, OSError) as e:
            self._pending.pop(rid, None)
            raise RpcError(f"call {fn} failed: {e}") from e
        if not reply.get("ok"):
            raise RpcError(f"remote error in {fn}: {reply.get('val')}")
        return reply.get("val")

    async def cast(self, fn: str, args: list) -> None:
        try:
            # 3.10-compatible deadline (asyncio.timeout is 3.11+;
            # utils.aio.timeout_after converts only OUR deadline
            # cancel into TimeoutError)
            async with timeout_after(CONNECT_TIMEOUT):
                await self.send({"t": "cast", "fn": fn, "args": args})
        except asyncio.TimeoutError as e:
            # a FROZEN peer stops reading: once the TCP buffers fill,
            # drain() parks forever and would wedge the (single)
            # replication worker — nodedown can't interrupt an in-flight
            # drain. The cast is doomed anyway (anti-entropy heals);
            # close the channel so later sends reconnect or fail fast.
            if self.writer is not None:
                self.writer.close()
            raise RpcError(f"cast {fn}: send timed out") from e

    async def close(self) -> None:
        if self._reader_task:
            self._reader_task.cancel()
        if self.writer:
            self.writer.close()
        self._fail_pending(RpcError("closed"))


class Peer:
    """Channel pool to one remote node; key-pinned pick
    (emqx_rpc.erl:55-57 `phash2(Key) rem tcp_client_num`)."""

    def __init__(self, host: str, port: int, self_node: str, cookie: str,
                 n_channels: int = DEFAULT_CHANNELS):
        self.addr = (host, port)
        self.channels = [_Channel(host, port, self_node, cookie)
                         for _ in range(n_channels)]

    def pick(self, key: Optional[str]) -> _Channel:
        if key is None:
            import random
            return self.channels[random.randrange(len(self.channels))]
        import zlib
        return self.channels[zlib.crc32(key.encode()) % len(self.channels)]

    async def close(self) -> None:
        for ch in self.channels:
            await ch.close()


Handler = Callable[..., Awaitable[Any]]


class RpcNode:
    """One node's RPC endpoint: TCP server + peer channel pools + the
    registered handler table (the remote-callable surface)."""

    def __init__(self, node: str, host: str = "127.0.0.1", port: int = 0,
                 cookie: str = "emqxsecretcookie",
                 n_channels: int = DEFAULT_CHANNELS):
        self.node = node
        self.host, self.port = host, port
        self.cookie = cookie
        self.n_channels = n_channels
        self.handlers: dict[str, Handler] = {}
        self.peers: dict[str, Peer] = {}        # node name -> Peer
        self._server: Optional[asyncio.AbstractServer] = None
        self._inbound: set[asyncio.StreamWriter] = set()
        self.on_inbound_connect: Optional[Callable[[str], None]] = None

    def register(self, fn: str, handler: Handler) -> None:
        self.handlers[fn] = handler

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        hello = await read_frame(reader)
        if (not hello or hello.get("t") != "hello"
                or hello.get("cookie") != self.cookie):
            writer.close()
            return
        writer.write(encode_frame({"t": "hello_ok", "node": self.node}))
        await writer.drain()
        if self.on_inbound_connect:
            self.on_inbound_connect(hello.get("node", "?"))
        self._inbound.add(writer)
        try:
            while True:
                msg = await read_frame(reader)
                if msg is None:
                    break
                t = msg.get("t")
                if t == "call":
                    spawn(self._run_call(writer, msg), "rpc-call")
                elif t == "cast":
                    spawn(self._run_cast(msg), "rpc-cast")
        finally:
            self._inbound.discard(writer)
            try:
                writer.close()
            except RuntimeError:
                # loop already closed (interpreter teardown sweeping a
                # still-parked serve coroutine) — nothing left to close
                pass

    async def _run_call(self, writer: asyncio.StreamWriter,
                        msg: dict) -> None:
        fn, args = msg.get("fn"), msg.get("args", [])
        try:
            handler = self.handlers[fn]
            val = await handler(*args)
            reply = {"t": "reply", "id": msg["id"], "ok": True, "val": val}
        except Exception as e:  # noqa: BLE001 — remote gets the error text
            log.debug("rpc call %s failed", fn, exc_info=True)
            reply = {"t": "reply", "id": msg["id"], "ok": False,
                     "val": f"{type(e).__name__}: {e}"}
        try:
            data = encode_frame(reply)
        except (TypeError, ValueError) as e:
            # a handler returned something JSON-hostile: the caller must get
            # an error, not a 10s timeout
            data = encode_frame({"t": "reply", "id": msg["id"], "ok": False,
                                 "val": f"unserializable reply: {e}"})
        try:
            writer.write(data)
            await writer.drain()
        except (ConnectionError, OSError):
            pass

    async def _run_cast(self, msg: dict) -> None:
        fn, args = msg.get("fn"), msg.get("args", [])
        handler = self.handlers.get(fn)
        if handler is None:
            return
        try:
            await handler(*args)
        except Exception:  # noqa: BLE001 — cast errors are dropped like gen_rpc
            log.debug("rpc cast %s failed", fn, exc_info=True)

    # ---- outbound ----
    def add_peer(self, node: str, host: str, port: int) -> None:
        cur = self.peers.get(node)
        if cur is not None:
            if cur.addr == (host, port):
                return
            # the node came back at a NEW address (restart with dynamic
            # ports): the old pool points at a corpse and every call
            # through it would park — replace it, closing the stale
            # channels in the background
            del self.peers[node]
            try:
                asyncio.get_running_loop()
                spawn(cur.close(), "rpc-pool-close")
            except RuntimeError:          # no loop (sync test context)
                for ch in cur.channels:
                    if ch.writer is not None:
                        ch.writer.close()
        self.peers[node] = Peer(host, port, self.node, self.cookie,
                                self.n_channels)

    async def drop_peer(self, node: str) -> None:
        peer = self.peers.pop(node, None)
        if peer:
            await peer.close()

    async def call(self, node: str, fn: str, args: list,
                   key: Optional[str] = None,
                   timeout: float = CALL_TIMEOUT) -> Any:
        """Sync call; key pins the channel (per-topic ordering)."""
        if node == self.node:
            return await self.handlers[fn](*args)
        peer = self.peers.get(node)
        if peer is None:
            raise RpcError(f"unknown peer {node}")
        return await peer.pick(key).call(fn, args, timeout)

    async def cast(self, node: str, fn: str, args: list,
                   key: Optional[str] = None) -> None:
        """Async fire-and-forget; errors dropped (gen_rpc cast)."""
        if node == self.node:
            try:
                await self.handlers[fn](*args)
            except Exception:  # noqa: BLE001
                log.debug("local cast %s failed", fn, exc_info=True)
            return
        peer = self.peers.get(node)
        if peer is None:
            return
        try:
            await peer.pick(key).cast(fn, args)
        except (RpcError, ConnectionError, OSError):
            log.debug("cast to %s failed", node, exc_info=True)

    async def multicall(self, nodes: list[str], fn: str, args: list,
                        key: Optional[str] = None) -> dict[str, Any]:
        """Parity: emqx_rpc:multicall — gather per-node results; failures
        recorded as RpcError values instead of raising."""
        async def one(n):
            try:
                return await self.call(n, fn, args, key=key)
            except RpcError as e:
                return e
        vals = await asyncio.gather(*[one(n) for n in nodes])
        return dict(zip(nodes, vals))

    async def stop(self) -> None:
        for peer in list(self.peers.values()):
            await peer.close()
        self.peers.clear()
        for w in list(self._inbound):
            w.close()
        self._inbound.clear()
        if self._server:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2)
            except asyncio.TimeoutError:
                pass
