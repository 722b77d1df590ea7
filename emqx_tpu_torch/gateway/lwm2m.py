"""LwM2M 1.0 gateway: CoAP registration interface + MQTT command bridge.

Parity: apps/emqx_gateway/src/lwm2m — registration resource
(emqx_lwm2m_coap_resource.erl: POST/PUT/DELETE /rd), protocol bridge
(emqx_lwm2m_protocol.erl: mountpoint `lwm2m/%e/`, downlink commands from
`dn/#`, uplink events to `up/resp` / `up/notify`, command JSON with
reqID/msgType/data), command translation (emqx_lwm2m_cmd_handler.erl:
read->GET, write->PUT, execute->POST, discover->GET(link), observe->GET+
Observe), and the OMA-TLV codec (emqx_lwm2m_tlv.erl).
"""

from __future__ import annotations

import asyncio
import json
import struct
import time
from typing import Any, Optional

from emqx_tpu_torch.gateway import coap as C
from emqx_tpu_torch.gateway.ctx import GatewayCtx

CF_LINK = 40
CF_TEXT = 0
CF_OPAQUE = 42
CF_TLV = 11542
CF_JSON = 11543

# ---- OMA-TLV (emqx_lwm2m_tlv.erl) ----
T_OBJECT_INSTANCE = 0
T_RESOURCE_INSTANCE = 1
T_MULTIPLE_RESOURCE = 2
T_RESOURCE = 3

_KIND = {T_OBJECT_INSTANCE: "obj_inst", T_RESOURCE_INSTANCE: "res_inst",
         T_MULTIPLE_RESOURCE: "multi_res", T_RESOURCE: "resource"}
_KIND_R = {v: k for k, v in _KIND.items()}


def tlv_decode(data: bytes) -> list[dict]:
    out = []
    i = 0
    while i < len(data):
        t = data[i]
        kind = (t >> 6) & 3
        id_len = 2 if t & 0x20 else 1
        len_size = (t >> 3) & 3
        i += 1
        ident = int.from_bytes(data[i:i + id_len], "big")
        i += id_len
        if len_size == 0:
            length = t & 0x07
        else:
            length = int.from_bytes(data[i:i + len_size], "big")
            i += len_size
        value = data[i:i + length]
        i += length
        entry: dict[str, Any] = {"kind": _KIND[kind], "id": ident}
        if kind in (T_OBJECT_INSTANCE, T_MULTIPLE_RESOURCE):
            entry["value"] = tlv_decode(value)
        else:
            entry["value"] = value
        out.append(entry)
    return out


def tlv_encode(entries: list[dict]) -> bytes:
    out = bytearray()
    for e in entries:
        kind = _KIND_R[e["kind"]]
        value = e["value"]
        if isinstance(value, list):
            value = tlv_encode(value)
        elif isinstance(value, str):
            value = value.encode()
        elif isinstance(value, int):
            n = max(1, (value.bit_length() + 7) // 8)
            value = value.to_bytes(n, "big", signed=value < 0)
        ident = e["id"]
        t = kind << 6
        idb = struct.pack(">H", ident) if ident > 255 else bytes([ident])
        if ident > 255:
            t |= 0x20
        n = len(value)
        if n < 8:
            t |= n
            lenb = b""
        elif n < 256:
            t |= 0x08
            lenb = bytes([n])
        elif n < 65536:
            t |= 0x10
            lenb = struct.pack(">H", n)
        else:
            t |= 0x18
            lenb = n.to_bytes(3, "big")
        out += bytes([t]) + idb + lenb + value
    return bytes(out)


def _decode_content(cf: int, payload: bytes) -> Any:
    if cf == CF_TLV:
        return _tlv_jsonable(tlv_decode(payload))
    if cf in (CF_TEXT, CF_LINK):
        return payload.decode("utf-8", "replace")
    if cf == CF_JSON:
        try:
            return json.loads(payload)
        except ValueError:
            return payload.decode("utf-8", "replace")
    import base64
    return base64.b64encode(payload).decode()


def _tlv_jsonable(entries: list[dict]) -> list[dict]:
    out = []
    for e in entries:
        v = e["value"]
        if isinstance(v, list):
            v = _tlv_jsonable(v)
        elif isinstance(v, bytes):
            try:
                v = v.decode("utf-8")
            except UnicodeDecodeError:
                import base64
                v = base64.b64encode(v).decode()
        out.append({"kind": e["kind"], "id": e["id"], "value": v})
    return out


class Lwm2mSession:
    """One registered endpoint (emqx_lwm2m_protocol state)."""

    def __init__(self, gw: "Lwm2mGateway", ep: str, addr,
                 lifetime: int, objects: str):
        self.gw = gw
        self.ep = ep
        self.addr = addr
        self.lifetime = lifetime
        self.objects = objects
        self.location = f"{abs(hash(ep)) % 100000}"
        self.sid: Optional[int] = None
        self.last_update = time.monotonic()
        self.pending: dict[bytes, dict] = {}   # coap token -> command ctx
        self.observe_tokens: dict[str, bytes] = {}   # path -> token

    def mount(self, suffix: str) -> str:
        return f"lwm2m/{self.ep}/{suffix}"

    # ---- broker subscriber protocol: downlink commands arrive here ----
    def deliver(self, topic_filter: str, msg) -> bool:
        try:
            cmd = json.loads(msg.payload)
        except ValueError:
            return False
        from emqx_tpu_torch.broker.supervise import spawn
        spawn(self.gw.send_command(self, cmd), "lwm2m-send-command")
        return True


class Lwm2mGateway(asyncio.DatagramProtocol):
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        self.conf = conf or {}
        self.ctx = GatewayCtx(node, "lwm2m")
        self.bind = self.conf.get("bind", "127.0.0.1")
        self.port = self.conf.get("port", 5783)
        self.lifetime_max = self.conf.get("lifetime_max", 86400)
        self.transport = None
        self._mid = 0
        self._token_seq = 0
        self.sessions: dict[str, Lwm2mSession] = {}      # ep -> session
        self.by_location: dict[str, Lwm2mSession] = {}
        self.by_addr: dict[tuple, Lwm2mSession] = {}
        # OMA object registry (emqx_lwm2m_xml_object_db analog): core
        # objects compiled in, custom objects from DDF XML when configured
        from emqx_tpu_torch.gateway.lwm2m_objects import ObjectRegistry
        self.objects = ObjectRegistry.core()
        xml_dir = self.conf.get("xml_dir")
        if xml_dir:
            self.objects.load_xml_dir(xml_dir)

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self.transport, _ = await loop.create_datagram_endpoint(
            lambda: self, local_addr=(self.bind, self.port))
        if self.port == 0:
            self.port = self.transport.get_extra_info("sockname")[1]

    async def stop(self) -> None:
        for s in list(self.sessions.values()):
            self._deregister(s)
        if self.transport:
            self.transport.close()

    def info(self) -> dict:
        return {"listener": f"udp:{self.bind}:{self.port}",
                "endpoints": len(self.sessions)}

    def _next_mid(self) -> int:
        self._mid = (self._mid + 1) & 0xFFFF
        return self._mid

    def _next_token(self) -> bytes:
        self._token_seq += 1
        return struct.pack(">I", self._token_seq)

    def _send(self, addr, msg: C.CoapMessage) -> None:
        if self.transport:
            self.transport.sendto(C.encode(msg), addr)

    def datagram_received(self, data: bytes, addr) -> None:
        try:
            msg = C.decode(data)
        except C.CoapError:
            return
        from emqx_tpu_torch.broker.supervise import spawn
        spawn(self._handle(addr, msg), "lwm2m-handle")

    async def _handle(self, addr, msg: C.CoapMessage) -> None:
        cls = msg.code >> 5
        if cls == 0 and msg.code != 0:          # request from device
            await self._handle_request(addr, msg)
        elif cls in (2, 4, 5):                  # response to a command
            self._handle_response(addr, msg)

    # ---- registration interface (POST/PUT/DELETE /rd) ----
    async def _handle_request(self, addr, req: C.CoapMessage) -> None:
        path = req.uri_path
        if not path or path[0] != "rd":
            self._reply(addr, req, C.NOT_FOUND)
            return
        q = req.uri_query
        if req.code == C.POST and len(path) == 1:
            await self._register(addr, req, q)
        elif req.code == C.POST and len(path) == 2 or \
                req.code == C.PUT and len(path) == 2:
            s = self.by_location.get(path[1])
            if s is None:
                self._reply(addr, req, C.NOT_FOUND)
                return
            s.addr = addr
            self.by_addr[addr] = s
            s.last_update = time.monotonic()
            if "lt" in q:
                s.lifetime = int(q["lt"])
            self._uplink(s, "update", {"lifetime": s.lifetime,
                                       "objectList": s.objects})
            self._reply(addr, req, C.CHANGED)
        elif req.code == C.DELETE and len(path) == 2:
            s = self.by_location.get(path[1])
            if s is not None:
                self._uplink(s, "deregister", {})
                self._deregister(s)
            self._reply(addr, req, C.DELETED)
        else:
            self._reply(addr, req, C.METHOD_NOT_ALLOWED)

    async def _register(self, addr, req: C.CoapMessage, q: dict) -> None:
        ep = q.get("ep")
        if not ep:
            self._reply(addr, req, C.BAD_REQUEST)
            return
        clientinfo = {"clientid": f"lwm2m:{ep}", "username": None,
                      "protocol": "lwm2m", "peername": addr}
        if not await self.ctx.authenticate(clientinfo):
            self._reply(addr, req, C.UNAUTHORIZED)
            return
        old = self.sessions.get(ep)
        if old is not None:
            self._deregister(old)
        lifetime = min(int(q.get("lt", 86400)), self.lifetime_max)
        s = Lwm2mSession(self, ep, addr, lifetime,
                         req.payload.decode("utf-8", "replace"))
        self.sessions[ep] = s
        self.by_location[s.location] = s
        self.by_addr[addr] = s
        s.sid = self.ctx.register_subscriber(s, ep)
        self.ctx.subscribe(s.sid, s.mount("dn/#"), {"qos": 0})
        self.ctx.register_channel(ep, s, {"proto": "lwm2m",
                                          "lifetime": lifetime})
        self._uplink(s, "register", {
            "lt": lifetime, "lwm2m": q.get("lwm2m", "1.0"),
            "objectList": [o.strip().strip("<>")
                           for o in s.objects.split(",") if o.strip()]})
        self.node.hooks.run("client.connected",
                            (clientinfo, {"proto_name": "LwM2M"}))
        self._reply(addr, req, C.CREATED, options=[
            (C.OPT_LOCATION_PATH, b"rd"),
            (C.OPT_LOCATION_PATH, s.location.encode())])

    def _reply(self, addr, req: C.CoapMessage, rcode: int,
               options: Optional[list] = None,
               payload: bytes = b"") -> None:
        self._send(addr, C.CoapMessage(
            type=C.ACK if req.type == C.CON else C.NON, code=rcode,
            message_id=req.message_id, token=req.token,
            options=options or [], payload=payload))

    def _deregister(self, s: Lwm2mSession) -> None:
        if s.sid is not None:
            self.ctx.unregister_subscriber(s.sid)
            s.sid = None
        self.ctx.unregister_channel(s.ep, s)
        self.sessions.pop(s.ep, None)
        self.by_location.pop(s.location, None)
        self.by_addr.pop(s.addr, None)

    # ---- uplink publishing ----
    def _uplink(self, s: Lwm2mSession, msg_type: str, data: dict,
                req_id: Optional[int] = None) -> None:
        payload = {"msgType": msg_type, "data": data}
        if req_id is not None:
            payload["reqID"] = req_id
        suffix = "up/notify" if msg_type == "notify" else "up/resp"
        self.ctx.publish(s.ep, s.mount(suffix),
                         json.dumps(payload).encode(), qos=0)

    # ---- downlink commands (emqx_lwm2m_cmd_handler) ----
    async def send_command(self, s: Lwm2mSession, cmd: dict) -> None:
        msg_type = cmd.get("msgType")
        data = cmd.get("data") or {}
        path = data.get("path", "")
        try:
            # name paths ("/Device/0/Manufacturer") resolve through the
            # object registry; numeric paths pass through
            path = self.objects.resolve_path(path)
        except KeyError as e:
            self._uplink(s, msg_type or "unknown",
                         {"reqPath": str(data.get("path", "")),
                          "code": "4.04", "codeMsg": str(e)},
                         cmd.get("reqID"))
            return
        segs = [p for p in str(path).split("/") if p != ""]
        opts = [(C.OPT_URI_PATH, seg.encode()) for seg in segs]
        token = self._next_token()
        if msg_type == "read":
            code = C.GET
        elif msg_type == "discover":
            code = C.GET
            opts.append((C.OPT_CONTENT_FORMAT,
                         _cf_bytes(CF_LINK)))
        elif msg_type == "write":
            code = C.PUT
        elif msg_type == "execute":
            code = C.POST
        elif msg_type == "observe":
            code = C.GET
            opts.append((C.OPT_OBSERVE, b""))
            s.observe_tokens[path] = token
        elif msg_type == "cancel-observe":
            code = C.GET
            opts.append((C.OPT_OBSERVE, b"\x01"))
        else:
            self._uplink(s, msg_type or "unknown",
                         {"reqPath": path, "code": "4.00",
                          "codeMsg": "bad msgType"}, cmd.get("reqID"))
            return
        payload = b""
        if msg_type == "write":
            value = data.get("value", "")
            if isinstance(value, list):
                payload = tlv_encode(value)
                opts.append((C.OPT_CONTENT_FORMAT, _cf_bytes(CF_TLV)))
            else:
                payload = str(value).encode()
                opts.append((C.OPT_CONTENT_FORMAT, _cf_bytes(CF_TEXT)))
        elif msg_type == "execute":
            payload = str(data.get("args", "")).encode()
        s.pending[token] = {"cmd": cmd, "path": path}
        self._send(s.addr, C.CoapMessage(
            type=C.CON, code=code, message_id=self._next_mid(),
            token=token, options=opts, payload=payload))

    def _handle_response(self, addr, msg: C.CoapMessage) -> None:
        s = self.by_addr.get(addr)
        if s is None:
            return
        token = bytes(msg.token)
        cf_raw = msg.opt(C.OPT_CONTENT_FORMAT)
        cf = int.from_bytes(cf_raw, "big") if cf_raw else CF_TEXT
        obs = msg.opt(C.OPT_OBSERVE)
        ctxt = s.pending.get(token)
        code_str = f"{msg.code >> 5}.{msg.code & 0x1F:02d}"
        if obs is not None and ctxt is None:
            # notification on an observed path
            path = next((p for p, t in s.observe_tokens.items()
                         if t == token), "")
            self._uplink(s, "notify", {
                "reqPath": path, "code": code_str,
                "seqNum": int.from_bytes(obs, "big") if obs else 0,
                "content": _decode_content(cf, msg.payload)})
            return
        if ctxt is None:
            return
        if ctxt["cmd"].get("msgType") != "observe":
            s.pending.pop(token, None)
        data = {
            "reqPath": ctxt["path"], "code": code_str,
            "codeMsg": _code_msg(msg.code),
            "content": _decode_content(cf, msg.payload)}
        name = self.objects.path_name(ctxt["path"])
        if name:
            data["reqPathName"] = name   # resolved via the object registry
        self._uplink(s, ctxt["cmd"].get("msgType", "resp"), data,
                     ctxt["cmd"].get("reqID"))


def _cf_bytes(cf: int) -> bytes:
    return bytes([cf]) if cf < 256 else struct.pack(">H", cf)


def _code_msg(code: int) -> str:
    return {C.CONTENT: "content", C.CHANGED: "changed",
            C.CREATED: "created", C.DELETED: "deleted",
            C.BAD_REQUEST: "bad_request", C.UNAUTHORIZED: "unauthorized",
            C.NOT_FOUND: "not_found",
            C.METHOD_NOT_ALLOWED: "method_not_allowed"}.get(code, "unknown")
