"""Cluster membership: the ekka analog.

The port's copy of ``emqx_tpu/cluster/membership.py`` (the port imports nothing
from ``emqx_tpu``).

Parity: ekka (started at emqx_app.erl:51) + discovery/autoheal/autoclean
config (emqx_machine_schema.erl:66-111). Discovery strategies: `manual`
(explicit join/leave) and `static` (seed address list) — the dns/etcd/k8s
strategies of the reference are address providers feeding the same join path
and are pluggable via `seeds_fn`.

Failure detection: periodic heartbeats over the RPC plane; a peer missing
`max_missed` beats is declared down (nodedown event -> route cleanup in
cluster.py, the emqx_router_helper analog, §3.5). A downed node that beats
again is healed (autoheal analog); `autoclean_s` removes long-dead members.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Optional

from emqx_tpu_torch.cluster.rpc import RpcError, RpcNode

log = logging.getLogger("emqx_tpu_torch.cluster.membership")


class Membership:
    def __init__(self, rpc: RpcNode, *,
                 heartbeat_s: float = 1.0, max_missed: int = 3,
                 autoclean_s: float = 300.0,
                 seeds: Optional[list[tuple[str, int]]] = None):
        self.rpc = rpc
        self.heartbeat_s = heartbeat_s
        self.max_missed = max_missed
        self.autoclean_s = autoclean_s
        self.seeds = seeds or []
        # boot incarnation, gossiped with our address: lets receivers
        # (a) ignore STALE gossip that would re-point a working peer pool
        # back at a dead address, and (b) detect a restart even when it
        # happened inside the failure-detection window (nodedown never
        # fired) — the restart emits "healed" so the store resyncs the
        # fresh incarnation's state
        self.inc = time.time_ns()
        # node -> {"addr": (host,port), "status": running|down,
        #          "last": ts, "inc": peer boot incarnation or None}
        self.members: dict[str, dict] = {
            rpc.node: {"addr": rpc.address, "status": "running",
                       "last": time.time(), "inc": self.inc}}
        self._watchers: list[Callable[[str, str], None]] = []
        self._task: Optional[asyncio.Task] = None
        rpc.register("ekka.heartbeat", self._h_heartbeat)
        rpc.register("ekka.join", self._h_join)
        rpc.register("ekka.members", self._h_members)
        rpc.register("ekka.leave", self._h_leave)

    # ---- events ----
    def monitor(self, fn: Callable[[str, str], None]) -> None:
        """fn(event, node) with event in nodeup|nodedown|nodeleft|healed."""
        self._watchers.append(fn)

    def _emit(self, event: str, node: str) -> None:
        for fn in self._watchers:
            try:
                fn(event, node)
            except Exception:  # noqa: BLE001
                log.exception("membership watcher failed")

    # ---- local view ----
    def running_nodes(self) -> list[str]:
        return sorted(n for n, m in self.members.items()
                      if m["status"] == "running")

    def other_nodes(self) -> list[str]:
        return [n for n in self.running_nodes() if n != self.rpc.node]

    def is_running(self, node: str) -> bool:
        m = self.members.get(node)
        return bool(m and m["status"] == "running")

    def info(self) -> dict:
        return {n: {"status": m["status"],
                    "addr": list(m["addr"])} for n, m in self.members.items()}

    # ---- join/leave (emqx_mgmt_cli cluster join/leave analog) ----
    async def start(self) -> None:
        # re-read the address: port 0 resolves when the rpc server binds
        self.members[self.rpc.node]["addr"] = self.rpc.address
        self._task = asyncio.create_task(self._beat_loop())
        for host, port in self.seeds:
            if (host, port) == self.rpc.address:
                continue
            try:
                await self.join_addr(host, port)
            except RpcError:
                log.info("seed %s:%s unreachable at boot", host, port)

    async def join_addr(self, host: str, port: int) -> None:
        """Join the cluster a seed node belongs to."""
        probe = f"probe@{host}:{port}"
        self.rpc.add_peer(probe, host, port)
        try:
            view = await self.rpc.call(probe, "ekka.join", [
                self.rpc.node, list(self.rpc.address), self._view()])
        finally:
            await self.rpc.drop_peer(probe)
        self._merge_view(view)

    async def _h_join(self, node: str, addr: list, view: dict) -> dict:
        self._add_member(node, tuple(addr))
        self._merge_view(view)
        # gossip the new member to everyone we know
        for n in self.other_nodes():
            if n != node:
                await self.rpc.cast(n, "ekka.members", [self._view()])
        return self._view()

    async def _h_members(self, view: dict) -> None:
        self._merge_view(view)

    async def leave(self) -> None:
        """This node leaves the cluster."""
        for n in self.other_nodes():
            await self.rpc.cast(n, "ekka.leave", [self.rpc.node])
        self.members = {self.rpc.node: self.members[self.rpc.node]}

    async def _h_leave(self, node: str) -> None:
        if self.members.pop(node, None) is not None:
            await self.rpc.drop_peer(node)
            self._emit("nodeleft", node)

    async def force_leave(self, node: str) -> None:
        """Evict a member cluster-wide (cluster force-leave CLI)."""
        for n in self.other_nodes():
            await self.rpc.cast(n, "ekka.leave", [node])
        await self._h_leave(node)

    def _view(self) -> dict:
        self.members[self.rpc.node]["addr"] = self.rpc.address
        return {n: {"addr": list(m["addr"]), "status": m["status"],
                    "inc": m.get("inc")}
                for n, m in self.members.items()}

    def _merge_view(self, view: dict) -> None:
        for node, m in view.items():
            self._add_member(node, tuple(m["addr"]), m.get("inc"))

    def _add_member(self, node: str, addr: tuple,
                    inc: Optional[int] = None) -> None:
        if node == self.rpc.node:
            return
        known = self.members.get(node)
        known_inc = known.get("inc") if known else None
        if (inc is not None and known_inc is not None
                and inc < known_inc):
            # STALE gossip about a dead incarnation: acting on it would
            # re-point a working peer pool at the corpse address
            return
        restarted = (inc is not None and known_inc is not None
                     and inc > known_inc)
        self.rpc.add_peer(node, addr[0], addr[1])
        if known is None or known["status"] != "running" or restarted:
            self.members[node] = {"addr": addr, "status": "running",
                                  "last": time.time(),
                                  "inc": inc if inc is not None
                                  else known_inc}
            # a restart INSIDE the failure-detection window never fires
            # nodedown; the incarnation bump is the only restart signal,
            # and "healed" makes the store resync (purging the dead
            # incarnation's rows even if the fresh node stays idle)
            self._emit("healed" if known else "nodeup", node)
        else:
            if inc is not None:
                known["inc"] = inc
            if known["addr"] != addr:
                # same incarnation at a new address cannot really happen;
                # legacy/inc-less gossip keeps last-writer-wins behavior
                known["addr"] = addr

    # ---- heartbeat / failure detection ----
    async def _beat_loop(self) -> None:
        while True:
            await asyncio.sleep(self.heartbeat_s)
            now = time.time()
            # probe down members too: a mutual partition where both sides
            # marked each other down must still heal once the network does
            for node, m in list(self.members.items()):
                if node == self.rpc.node:
                    continue
                try:
                    # heartbeats carry the full view both ways: missed
                    # join-time gossip heals on the next beat
                    rview = await self.rpc.call(
                        node, "ekka.heartbeat",
                        [self.rpc.node, self._view()],
                        timeout=self.heartbeat_s * 2)
                    m["last"] = now
                    if m["status"] == "down":
                        m["status"] = "running"
                        self._emit("healed", node)
                    if isinstance(rview, dict):
                        self._merge_view(rview)
                except RpcError:
                    pass
            self._check_down(now)

    def _check_down(self, now: float) -> None:
        for node, m in list(self.members.items()):
            if node == self.rpc.node:
                continue
            silent = now - m["last"]
            if (m["status"] == "running"
                    and silent > self.heartbeat_s * self.max_missed):
                m["status"] = "down"
                self._emit("nodedown", node)
            elif m["status"] == "down" and silent > self.autoclean_s:
                del self.members[node]   # cluster_autoclean
                self._emit("nodeleft", node)

    async def _h_heartbeat(self, from_node: str,
                           view: Optional[dict] = None) -> dict:
        if view:
            self._merge_view(view)   # learns unknown senders/members too
        m = self.members.get(from_node)
        if m is not None:
            m["last"] = time.time()
            if m["status"] == "down":   # autoheal: it came back
                m["status"] = "running"
                self._emit("healed", from_node)
        return self._view()

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
