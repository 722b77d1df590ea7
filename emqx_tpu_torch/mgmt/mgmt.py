"""Management facade: node-local operations + cluster-wide fan-out.

Parity: emqx_mgmt.erl — lookup/list for nodes, brokers, clients,
subscriptions, routes; kick/clean ops; publish/subscribe on behalf of
clients. Cross-node calls ride the cluster rpc plane (the reference's
rpc:call fan-out in emqx_mgmt list_* functions); without a cluster every
call is local. The port's copy of ``emqx_tpu/mgmt/mgmt.py``.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from emqx_tpu_torch.broker.message import make
from emqx_tpu_torch.version import __version__

_BOOT_TS = time.time()


class Mgmt:
    def __init__(self, node, cluster=None):
        self.node = node
        self.cluster = cluster
        if cluster is not None:
            rpc = cluster.rpc
            rpc.register("mgmt.node_info", self._h_node_info)
            rpc.register("mgmt.broker_info", self._h_broker_info)
            rpc.register("mgmt.stats", self._h_stats)
            rpc.register("mgmt.metrics", self._h_metrics)
            rpc.register("mgmt.clients", self._h_clients)
            rpc.register("mgmt.client", self._h_client)
            rpc.register("mgmt.client_subs", self._h_client_subs)
            rpc.register("mgmt.subscriptions", self._h_subscriptions)

    # ---- helpers ----
    def _nodes(self) -> list[str]:
        if self.cluster is None:
            return [self.node.name]
        return self.cluster.membership.running_nodes()

    async def _fanout(self, fn: str, args: list) -> dict[str, Any]:
        if self.cluster is None:
            local = await getattr(self, "_h_" + fn.split(".", 1)[1])(*args)
            return {self.node.name: local}
        res = await self.cluster.rpc.multicall(self._nodes(), fn, args)
        return {n: v for n, v in res.items() if not isinstance(v, Exception)}

    # ---- node / broker info (emqx_mgmt:node_info, broker_info) ----
    async def _h_node_info(self) -> dict:
        import os
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

    async def _h_broker_info(self) -> dict:
        return {"node": self.node.name, "version": __version__,
                "sysdescr": "EMQX-TPU broker",
                "uptime": int(time.time() - _BOOT_TS),
                "datetime": time.strftime("%Y-%m-%d %H:%M:%S")}

    async def _h_stats(self) -> dict:
        return self.node.stats.sample()

    async def _h_metrics(self) -> dict:
        return self.node.metrics.all()

    async def _h_clients(self) -> list[dict]:
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

    async def _h_client(self, clientid: str) -> Optional[dict]:
        for c in await self._h_clients():
            if c["clientid"] == clientid:
                return c
        return None

    async def _h_client_subs(self, clientid: str) -> list[dict]:
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

    async def _h_subscriptions(self) -> list[dict]:
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

    # ---- public API used by REST/CLI ----
    async def list_nodes(self) -> list[dict]:
        return list((await self._fanout("mgmt.node_info", [])).values())

    async def list_brokers(self) -> list[dict]:
        return list((await self._fanout("mgmt.broker_info", [])).values())

    async def _per_node_counters(self, fn: str, aggregate: bool) -> Any:
        per = await self._fanout(fn, [])
        if not aggregate:
            return [{"node": n, **v} for n, v in per.items()]
        agg: dict = {}
        for v in per.values():
            for k, x in v.items():
                if isinstance(x, (int, float)):
                    agg[k] = agg.get(k, 0) + x
        return agg

    async def stats(self, aggregate: bool = False) -> Any:
        return await self._per_node_counters("mgmt.stats", aggregate)

    async def metrics(self, aggregate: bool = False) -> Any:
        return await self._per_node_counters("mgmt.metrics", aggregate)

    async def list_clients(self) -> list[dict]:
        out: list[dict] = []
        for v in (await self._fanout("mgmt.clients", [])).values():
            out.extend(v)
        return out

    async def lookup_client(self, clientid: str) -> Optional[dict]:
        for v in (await self._fanout("mgmt.client", [clientid])).values():
            if v:
                return v
        return None

    async def client_subscriptions(self, clientid: str) -> list[dict]:
        out: list[dict] = []
        for v in (await self._fanout("mgmt.client_subs",
                                     [clientid])).values():
            out.extend(v)
        return out

    async def kick_client(self, clientid: str) -> bool:
        if self.cluster is not None:
            return await self.cluster.kick_session_global(clientid)
        return await self.node.cm.kick_session(clientid)

    async def list_subscriptions(self) -> list[dict]:
        out: list[dict] = []
        for v in (await self._fanout("mgmt.subscriptions", [])).values():
            out.extend(v)
        return out

    def list_routes(self) -> list[dict]:
        # the route table is fully replicated: local read is cluster truth
        if self.cluster is not None:
            tab = self.cluster.store.table("route")
            return [{"topic": t, "node": sorted(tab.origins(t))
                     or [self.node.name]}
                    for t in self.node.router.topics()]
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
        from emqx_tpu_torch.utils import topic as T
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
