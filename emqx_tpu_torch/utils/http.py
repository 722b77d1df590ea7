"""Minimal asyncio HTTP/1.1 client (no external deps).

A copy of ``emqx_tpu/utils/http.py`` (the port imports nothing from
``emqx_tpu``).

Role parity: the reference's `ehttpc` pool used by emqx_authn/authz HTTP
sources and the HTTP connector (apps/emqx_connector/src/emqx_connector_http.erl).
Supports GET/POST with JSON or form bodies over plain TCP; enough surface
for localhost auth/webhook backends and for the in-repo test servers.
"""

from __future__ import annotations

import asyncio
import json as _json
from typing import Optional
from urllib.parse import urlencode, urlsplit


class HttpResponse:
    def __init__(self, status: int, headers: dict[str, str], body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    def json(self):
        return _json.loads(self.body.decode())


async def request(method: str, url: str, *,
                  headers: Optional[dict] = None,
                  body: Optional[bytes] = None,
                  json: Optional[dict] = None,
                  form: Optional[dict] = None,
                  timeout: float = 5.0) -> HttpResponse:
    parts = urlsplit(url)
    if parts.scheme not in ("http", ""):
        raise ValueError(f"unsupported scheme {parts.scheme!r}")
    host = parts.hostname or "127.0.0.1"
    port = parts.port or 80
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    hdrs = {"host": f"{host}:{port}", "connection": "close"}
    if json is not None:
        body = _json.dumps(json).encode()
        hdrs["content-type"] = "application/json"
    elif form is not None:
        body = urlencode(form).encode()
        hdrs["content-type"] = "application/x-www-form-urlencoded"
    if body:
        hdrs["content-length"] = str(len(body))
    hdrs.update({k.lower(): v for k, v in (headers or {}).items()})

    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout)
    try:
        head = f"{method.upper()} {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n"
        writer.write(head.encode() + (body or b""))
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:  # noqa: BLE001 — best-effort close on a one-
            pass           # shot client socket; the response is in hand
    header_blob, _, rest = raw.partition(b"\r\n\r\n")
    lines = header_blob.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    rhdrs = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        rhdrs[k.strip().lower()] = v.strip()
    if rhdrs.get("transfer-encoding", "").lower() == "chunked":
        rest = _dechunk(rest)
    return HttpResponse(status, rhdrs, rest)


async def templated_request(method: str, url: str, body_template: dict,
                            subs: dict, *, headers: Optional[dict] = None,
                            timeout: float = 5.0,
                            transport=None) -> HttpResponse:
    """Fill %-placeholders in a body template and issue the request —
    GET encodes the body as a query string, everything else POSTs JSON.
    Shared by the HTTP authenticator and the HTTP ACL source (the
    reference's emqx_authn_http / emqx_authz_http both do exactly this
    placeholder-fill + request step)."""
    transport = transport or request
    payload = {k: subs.get(v, v) if isinstance(v, str) else v
               for k, v in body_template.items()}
    if method.lower() == "get":
        from urllib.parse import urlencode
        return await transport("GET", url + "?" + urlencode(payload),
                               headers=headers, timeout=timeout)
    return await transport("POST", url, json=payload, headers=headers,
                           timeout=timeout)


def _dechunk(data: bytes) -> bytes:
    out = bytearray()
    while data:
        size_s, _, data = data.partition(b"\r\n")
        try:
            size = int(size_s.strip(), 16)
        except ValueError:
            break
        if size == 0:
            break
        out += data[:size]
        data = data[size + 2:]
    return bytes(out)
