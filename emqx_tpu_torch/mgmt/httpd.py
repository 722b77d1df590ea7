"""Minimal asyncio HTTP/1.1 server for the management REST API.

Parity role: the minirest/cowboy HTTP listener (emqx_mgmt_http.erl). Routes
are (method, pattern) pairs where pattern segments starting with ':' bind
path params; handlers are sync or async callables
(request) -> (status, body_dict | bytes). JSON in/out; HTTP basic auth via a
pluggable checker (emqx_mgmt_auth analog). The port's copy of
``emqx_tpu/mgmt/httpd.py``: asyncio streams, no other dependency.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
from typing import Any, Awaitable, Callable, Optional
from urllib.parse import parse_qsl, unquote, urlsplit

log = logging.getLogger("emqx_tpu_torch.mgmt.httpd")

MAX_BODY = 8 << 20


class Request:
    def __init__(self, method: str, path: str, query: dict, headers: dict,
                 body: bytes, params: Optional[dict] = None):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.params = params or {}

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body)

    def qint(self, name: str, default: int) -> int:
        try:
            return int(self.query.get(name, default))
        except ValueError:
            return default


Handler = Callable[[Request], Any]


class HttpServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 auth_check: Optional[Callable[[str, str], bool]] = None,
                 auth_exempt: tuple = ("/status", "/api/v5/status")):
        self.host, self.port = host, port
        self.auth_check = auth_check
        self.auth_exempt = auth_exempt
        self._routes: list[tuple[str, list[str], Handler]] = []
        self._server: Optional[asyncio.AbstractServer] = None

    def route(self, method: str, pattern: str, handler: Handler) -> None:
        self._routes.append((method.upper(),
                             [s for s in pattern.split("/") if s != ""],
                             handler))

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._serve, self.host,
                                                  self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2)
            except asyncio.TimeoutError:
                pass

    def _match(self, method: str, path: str):
        segs = [unquote(s) for s in path.split("/") if s != ""]
        for m, pat, handler in self._routes:
            if m != method or len(pat) != len(segs):
                continue
            params = {}
            ok = True
            for p, s in zip(pat, segs):
                if p.startswith(":"):
                    params[p[1:]] = s
                elif p != s:
                    ok = False
                    break
            if ok:
                return handler, params
        return None, None

    def _authorized(self, path: str, headers: dict) -> bool:
        # normalize like route matching does, so "/dashboard/" and "//"
        # hit the same exemption as "/dashboard" and "/"
        norm = "/" + "/".join(s for s in path.split("/") if s)
        if self.auth_check is None or path in self.auth_exempt \
                or norm in self.auth_exempt:
            return True
        hdr = headers.get("authorization", "")
        if hdr.lower().startswith("basic "):
            try:
                user, _, pwd = base64.b64decode(
                    hdr[6:].strip()).decode().partition(":")
            except Exception:  # noqa: BLE001
                return False
            return self.auth_check(user, pwd)
        if hdr.lower().startswith("bearer "):
            return self.auth_check("__bearer__", hdr[7:].strip())
        return False

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    return
                try:
                    method, target, _ver = line.decode().split()
                except ValueError:
                    return
                headers: dict[str, str] = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                try:
                    clen = int(headers.get("content-length", 0))
                except ValueError:
                    writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                                 b"content-length: 0\r\n"
                                 b"connection: close\r\n\r\n")
                    await writer.drain()
                    return
                if clen > MAX_BODY:
                    # refuse oversized bodies and close: reading part of the
                    # body would desync the stream (request smuggling)
                    writer.write(b"HTTP/1.1 413 Payload Too Large\r\n"
                                 b"content-length: 0\r\n"
                                 b"connection: close\r\n\r\n")
                    await writer.drain()
                    return
                body = await reader.readexactly(clen) if clen else b""
                url = urlsplit(target)
                query = dict(parse_qsl(url.query))
                status, payload = await self._dispatch(
                    method.upper(), url.path, query, headers, body)
                try:
                    if isinstance(payload, tuple) and len(payload) == 2 \
                            and isinstance(payload[0], (bytes, bytearray)) \
                            and isinstance(payload[1], str):
                        data, ctype = bytes(payload[0]), payload[1]
                    elif isinstance(payload, (bytes, bytearray)):
                        data, ctype = payload, "application/octet-stream"
                    else:
                        data = json.dumps(
                            payload, default=_json_default).encode()
                        ctype = "application/json"
                except (TypeError, ValueError):
                    # a handler returned something unserializable: the
                    # client must still get a response, not a dead socket
                    status = 500
                    data = b'{"code":"INTERNAL_ERROR"}'
                    ctype = "application/json"
                writer.write(
                    f"HTTP/1.1 {status} {_reason(status)}\r\n"
                    f"content-type: {ctype}\r\n"
                    f"content-length: {len(data)}\r\n"
                    "connection: keep-alive\r\n\r\n".encode() + data)
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    return
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            pass
        finally:
            writer.close()

    async def _dispatch(self, method: str, path: str, query: dict,
                        headers: dict, body: bytes):
        if not self._authorized(path, headers):
            return 401, {"code": "UNAUTHORIZED",
                         "message": "bad credentials"}
        handler, params = self._match(method, path)
        if handler is None:
            return 404, {"code": "NOT_FOUND", "message": path}
        req = Request(method, path, query, headers, body, params)
        try:
            res = handler(req)
            if asyncio.iscoroutine(res) or isinstance(res, Awaitable):
                res = await res
        except json.JSONDecodeError:
            return 400, {"code": "BAD_REQUEST", "message": "invalid json"}
        except (KeyError, TypeError, ValueError) as e:
            # missing/mistyped body fields are client errors, not 500s
            return 400, {"code": "BAD_REQUEST",
                         "message": f"missing or invalid field: {e}"}
        except ApiError as e:
            return e.status, {"code": e.code, "message": e.message}
        except Exception as e:  # noqa: BLE001
            log.exception("handler error on %s %s", method, path)
            return 500, {"code": "INTERNAL_ERROR", "message": str(e)}
        if isinstance(res, tuple):
            return res
        return 200, res


class ApiError(Exception):
    def __init__(self, status: int, code: str, message: str = ""):
        self.status, self.code, self.message = status, code, message
        super().__init__(message)


def _json_default(o):
    if isinstance(o, bytes):
        try:
            return o.decode("utf-8")
        except UnicodeDecodeError:
            return base64.b64encode(o).decode()
    if isinstance(o, set):
        return sorted(o)
    return repr(o)


def _reason(status: int) -> str:
    return {200: "OK", 201: "Created", 204: "No Content",
            400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
            409: "Conflict", 500: "Internal Server Error"}.get(status, "OK")


def paginate(items: list, req: Request) -> dict:
    """_page/_limit pagination envelope (emqx_mgmt_api:paginate)."""
    page = max(1, req.qint("_page", 1))
    limit = max(1, min(1000, req.qint("_limit", 100)))
    total = len(items)
    start = (page - 1) * limit
    return {"data": items[start:start + limit],
            "meta": {"page": page, "limit": limit, "count": total}}
