"""Management facade: node-local operations.

Parity: emqx_mgmt.erl — lookup/list for nodes, brokers, clients,
subscriptions, routes; kick/clean ops; publish/subscribe on behalf of
clients. The port's copy of ``emqx_tpu/mgmt/mgmt.py`` for one node: every
list answers in the reference's single-node shape (one entry per node, the
counters per node or summed). The cluster fan-out (``_fanout`` over the
rpc plane) is ROADMAP.md Queue A item 20(c).
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

from emqx_tpu_torch.broker.message import make
from emqx_tpu_torch.utils import topic as T
from emqx_tpu_torch.version import __version__

_BOOT_TS = time.time()


class Mgmt:
    def __init__(self, node):
        self.node = node

    # ---- node / broker info (emqx_mgmt:node_info, broker_info) ----
    def node_info(self) -> dict:
        try:
            la = os.getloadavg()
            load = {"load1": la[0], "load5": la[1], "load15": la[2]}
        except OSError:
            load = {}
        return {"node": self.node.name, "version": __version__,
                "node_status": "running",
                "uptime": int(time.time() - _BOOT_TS),
                "connections": self.node.cm.count(),
                "otp_release": "python", **load}

    def broker_info(self) -> dict:
        return {"node": self.node.name, "version": __version__,
                "sysdescr": "EMQX-TPU broker",
                "uptime": int(time.time() - _BOOT_TS),
                "datetime": time.strftime("%Y-%m-%d %H:%M:%S")}

    # ---- public API used by REST/CLI ----
    async def list_nodes(self) -> list[dict]:
        return [self.node_info()]

    async def list_brokers(self) -> list[dict]:
        return [self.broker_info()]

    @staticmethod
    def _counters(name: str, vals: dict, aggregate: bool) -> Any:
        if not aggregate:
            return [{"node": name, **vals}]
        return {k: x for k, x in vals.items()
                if isinstance(x, (int, float))}

    async def stats(self, aggregate: bool = False) -> Any:
        return self._counters(self.node.name, self.node.stats.sample(),
                              aggregate)

    async def metrics(self, aggregate: bool = False) -> Any:
        return self._counters(self.node.name, self.node.metrics.all(),
                              aggregate)

    async def list_clients(self) -> list[dict]:
        out = []
        for cid, _chan in self.node.cm.all_channels():
            info = dict(self.node.cm.get_channel_info(cid) or {})
            info.update({"clientid": cid, "node": self.node.name,
                         "connected": True})
            out.append(info)
        for cid in getattr(self.node.cm, "_detached", {}):
            out.append({"clientid": cid, "node": self.node.name,
                        "connected": False})
        return out

    async def lookup_client(self, clientid: str) -> Optional[dict]:
        for c in await self.list_clients():
            if c["clientid"] == clientid:
                return c
        return None

    async def client_subscriptions(self, clientid: str) -> list[dict]:
        broker = self.node.broker
        out = []
        for sid, cid in list(broker._sub_meta.items()):
            if cid != clientid:
                continue
            for f, opts in broker.subscriptions(sid):
                out.append({"clientid": clientid, "topic": f,
                            "qos": opts.get("qos", 0),
                            "node": self.node.name})
        return out

    async def kick_client(self, clientid: str) -> bool:
        return await self.node.cm.kick_session(clientid)

    async def list_subscriptions(self) -> list[dict]:
        broker = self.node.broker
        out = []
        for f, members in broker.subs.items():
            for sid, opts in members.items():
                out.append({"clientid": broker._sub_meta.get(sid),
                            "topic": f, "qos": opts.get("qos", 0),
                            "node": self.node.name})
        for real, groups in broker.shared.items():
            for grp, g in groups.items():
                for sid, opts in g.members.items():
                    out.append({"clientid": broker._sub_meta.get(sid),
                                "topic": f"$share/{grp}/{real}",
                                "qos": opts.get("qos", 0),
                                "node": self.node.name})
        return out

    def list_routes(self) -> list[dict]:
        return [{"topic": t, "node": [self.node.name]}
                for t in self.node.router.topics()]

    def lookup_route(self, topic: str) -> Optional[dict]:
        for r in self.list_routes():
            if r["topic"] == topic:
                return r
        return None

    async def publish(self, topic: str, payload: bytes, qos: int = 0,
                      retain: bool = False, clientid: str = "http_api",
                      properties: Optional[dict] = None) -> int:
        try:
            # same topic-NAME validation the MQTT PUBLISH path enforces
            T.validate(topic, "name")
        except T.TopicError as e:
            raise ValueError(f"invalid topic name: {e}") from e
        msg = make(clientid, qos, topic, payload,
                   flags={"retain": retain},
                   headers={"properties": properties or {}})
        # the awaited host path, as the reference's: async extension
        # hooks see API publishes too
        return await self.node.broker.publish_async(msg)

    async def subscribe_client(self, clientid: str, topic: str,
                               qos: int = 0) -> Optional[int]:
        """Install a subscription on a connected client's channel
        (emqx_mgmt:subscribe → the client's session). Returns the MQTT
        reason code (0..2 granted), or None if the client isn't here."""
        chan = self.node.cm.lookup_channel(clientid)
        if chan is None or not hasattr(chan, "mgmt_subscribe"):
            return None
        return await chan.mgmt_subscribe(topic, qos)

    def unsubscribe_client(self, clientid: str, topic: str) -> bool:
        chan = self.node.cm.lookup_channel(clientid)
        if chan is None or not hasattr(chan, "mgmt_unsubscribe"):
            return False
        return chan.mgmt_unsubscribe(topic)
