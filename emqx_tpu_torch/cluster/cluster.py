"""ClusterNode: joins one broker Node into a cluster.

Responsibilities (parity targets):
  - route replication: every node's trie holds ALL cluster filters; per-filter
    owner sets come from the replicated route table (emqx_router.erl:77-86
    ram_copies + copy_table — here ClusterStore origins)
  - cross-node PUBLISH forwarding over key-pinned channels, async cast like
    the default rpc.mode (emqx_broker.erl:262-280 forward/3)
  - cluster-wide shared-subscription dispatch: strategy pick over the
    replicated member table, directed remote delivery
    (emqx_shared_sub.erl:239-268 picks cluster-wide from mnesia)
  - cluster-wide clientid registry + session takeover/discard over rpc
    (emqx_cm_registry.erl + emqx_cm.erl:268-298 rpc takeover)
  - per-clientid distributed lock on the key's home node
    (emqx_cm_locker / ekka_locker analog)
  - nodedown route cleanup via store origin purge
    (emqx_router_helper, SURVEY.md §3.5)

The port's copy of ``emqx_tpu/cluster/cluster.py``. One departure: the
port's device consume can run off the event loop (the batcher's dispatch
thread, the mesh), so `_spawn_fwd` hands a forward made on another thread
to the loop the node started on, in the order it was made.

Replication writes go through a single-writer queue task — the analog of the
reference's pooled router workers serializing route ops
(emqx_broker.erl:427-428, SURVEY.md P2): the broker's sync data path enqueues,
one task drains in order.
"""

from __future__ import annotations

import asyncio
import logging
import random
import zlib
from typing import Optional

from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.broker.session import Session, SessionConf
from emqx_tpu_torch.cluster.membership import Membership
from emqx_tpu_torch.cluster.rpc import RpcError, RpcNode
from emqx_tpu_torch.cluster.store import ClusterStore

log = logging.getLogger("emqx_tpu_torch.cluster")

T_ROUTE = "route"        # filter -> origins (value: subscriber kind tag)
T_SHARED = "shared"      # (real, group) -> per-origin [sid, ...]
T_REGISTRY = "registry"  # clientid -> origins


def _crc(s: str) -> int:
    return zlib.crc32(s.encode())


class ClusterNode:
    def __init__(self, node, *, host: str = "127.0.0.1", port: int = 0,
                 cookie: str = "emqxsecretcookie",
                 seeds: Optional[list[tuple[str, int]]] = None,
                 heartbeat_s: float = 1.0,
                 rpc_mode: str = "async"):
        self.node = node                      # broker Node
        self.name = node.name
        self.rpc_mode = rpc_mode              # async=cast / sync=call forwards
        self.rpc = RpcNode(self.name, host, port, cookie)
        self.membership = Membership(self.rpc, heartbeat_s=heartbeat_s,
                                     seeds=seeds)
        self.store = ClusterStore(self.rpc, self.membership)
        self._repl_q: asyncio.Queue = asyncio.Queue()
        self._repl_task: Optional[asyncio.Task] = None
        self._fwd_tasks: set[asyncio.Task] = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._shared_cursors: dict[tuple[str, str], int] = {}
        self._shared_sticky: dict[tuple[str, str], tuple[str, int]] = {}
        self._lock_tab: dict[str, tuple] = {}   # clientid -> (token, deadline)
        # secondary index over T_SHARED: real topic -> live group names,
        # maintained from the table watcher (all origins) so the publish
        # hot path never scans the whole table
        self._groups_by_real: dict[str, set[str]] = {}

        self.rpc.register("broker.dispatch_fwd", self._h_dispatch_fwd)
        self.rpc.register("shared.deliver_fwd", self._h_shared_deliver)
        self.rpc.register("cm.takeover", self._h_cm_takeover)
        self.rpc.register("cm.discard", self._h_cm_discard)
        self.rpc.register("cm.kick", self._h_cm_kick)
        self.rpc.register("cm.lookup_info", self._h_cm_lookup_info)
        self.rpc.register("locker.acquire", self._h_lock_acquire)
        self.rpc.register("locker.release", self._h_lock_release)
        self.store.table(T_ROUTE).watchers.append(self._on_route_event)
        self.store.table(T_SHARED).watchers.append(self._on_shared_event)
        self.membership.monitor(self._on_membership)

    # ---- lifecycle ----
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        await self.rpc.start()
        self.node.broker.cluster = self
        self.node.cm.cluster = self
        self._repl_task = asyncio.create_task(self._repl_worker())
        await self.membership.start()
        self.store.start_anti_entropy(
            max(1.0, self.membership.heartbeat_s * 5))
        # pull existing state from every seed-known peer
        for n in self.membership.other_nodes():
            try:
                await self.store.sync_from(n)
            except RpcError:
                pass
        # publish our current local state (joined with live subscriptions,
        # connected channels, parked sessions)
        broker = self.node.broker
        for real in broker.subs:
            self.local_route_add(real)
        for real, groups in broker.shared.items():
            for group, g in groups.items():
                for sid in g.members:
                    self.shared_join(real, group, sid)
        for clientid, _chan in self.node.cm.all_channels():
            self.registry_register(clientid)
        for clientid in self.node.cm._detached:
            self.registry_register(clientid)

    async def stop(self) -> None:
        dt = getattr(self, "_discovery_task", None)
        if dt is not None:      # etcd lease keepalive (discovery.py)
            dt.cancel()
            self._discovery_task = None
        md = getattr(self, "_mcast_discovery", None)
        if md is not None:      # stop answering group probes for a dead
            md.stop_responder()  # RPC address (discovery.py mcast)
            self._mcast_discovery = None
        if self._repl_task:
            try:
                await asyncio.wait_for(self._repl_q.join(), 2)
            except asyncio.TimeoutError:
                pass
            self._repl_task.cancel()
        for t in list(self._fwd_tasks):
            t.cancel()
        if self.node.broker.cluster is self:
            self.node.broker.cluster = None
        if getattr(self.node.cm, "cluster", None) is self:
            self.node.cm.cluster = None
        self.store.stop_anti_entropy()
        await self.membership.stop()
        await self.rpc.stop()

    @property
    def address(self) -> tuple[str, int]:
        return self.rpc.address

    async def join(self, host: str, port: int) -> None:
        await self.membership.join_addr(host, port)
        for n in self.membership.other_nodes():
            try:
                await self.store.sync_from(n)
            except RpcError:
                pass

    async def leave(self) -> None:
        await self.membership.leave()

    # ---- replication queue (single-writer, P2 analog) ----
    def _enqueue(self, coro_fn, *args) -> None:
        self._repl_q.put_nowait((coro_fn, args))

    async def _repl_worker(self) -> None:
        """Single-writer drain with COALESCING: a backlog of plain
        store.add ops (bulk subscribe churn) folds same-table runs into
        one add_many — one RPC frame per ~4k routes instead of one per
        route. Order is preserved: items run in queue order, and a
        non-add op flushes the pending run before it executes."""
        while True:
            items = [await self._repl_q.get()]
            while len(items) < 8192:
                try:
                    items.append(self._repl_q.get_nowait())
                except asyncio.QueueEmpty:
                    break
            run_table = None
            run: list = []

            async def flush_run():
                nonlocal run, run_table
                if run:
                    r, t = run, run_table
                    run, run_table = [], None   # clear BEFORE the await:
                    # add_many applies locally in full before casting, so
                    # a cast failure must not re-run the local applies
                    await self.store.add_many(t, r)

            async def safely(coro):
                try:
                    await coro
                except Exception:  # noqa: BLE001 — log, keep draining:
                    # local applies precede casts, so a lost cast is
                    # healed by anti-entropy; aborting the rest of the
                    # drain would lose LOCAL applies too
                    log.exception("replication op failed")

            for coro_fn, args in items:
                # NOTE == not `is`: each `self.store.add` access builds a
                # fresh bound method; `is` would never match and silently
                # disable coalescing entirely
                if coro_fn == self.store.add:
                    table, key, value = args
                    if run and table != run_table:
                        await safely(flush_run())
                    run_table = table
                    run.append((key, value))
                else:
                    await safely(flush_run())
                    await safely(coro_fn(*args))
            await safely(flush_run())
            for _ in items:
                self._repl_q.task_done()

    async def flush(self) -> None:
        """Wait until queued replication ops have been broadcast (tests)."""
        await self._repl_q.join()

    # ---- route replication (Broker callbacks; sync entry) ----
    def local_route_add(self, real: str) -> None:
        self._enqueue(self.store.add, T_ROUTE, real, "sub")

    def local_route_del(self, real: str) -> None:
        self._enqueue(self._route_del_op, real)

    async def _route_del_op(self, real: str) -> None:
        await self.store.delete(T_ROUTE, real, "sub")
        self._gc_local_route(real)

    def _gc_local_route(self, real: str) -> None:
        """Drop the filter from the local trie once NO node routes it."""
        broker = self.node.broker
        if (not self.store.table(T_ROUTE).origins(real)
                and not self._groups_by_real.get(real)
                and not broker._has_any_sub(real)):
            broker.router.delete_route(real)

    def _on_route_event(self, op: str, key, value, origin: str) -> None:
        if origin == self.rpc.node:
            return
        if op == "add":
            self.node.broker.router.add_route(key)
        else:
            self._gc_local_route(key)

    # ---- shared membership replication ----
    def shared_join(self, real: str, group: str, sid: int) -> None:
        self._enqueue(self.store.add, T_SHARED, (real, group), sid)

    def shared_leave(self, real: str, group: str, sid: int) -> None:
        self._enqueue(self._shared_leave_op, real, group, sid)

    async def _shared_leave_op(self, real: str, group: str,
                               sid: int) -> None:
        await self.store.delete(T_SHARED, (real, group), sid)
        self._gc_local_route(real)

    def _on_shared_event(self, op: str, key, value, origin: str) -> None:
        if not isinstance(key, tuple):
            return
        real, group = key
        # keep the real->groups index current for every origin (self too)
        if op == "add":
            self._groups_by_real.setdefault(real, set()).add(group)
        elif not self.store.table(T_SHARED).rows.get(key):
            groups = self._groups_by_real.get(real)
            if groups:
                groups.discard(group)
                if not groups:
                    del self._groups_by_real[real]
        if origin == self.rpc.node:
            return
        # a REMOTE membership change can flip a group between
        # locally-homed (on-device pick) and cluster-wide (host pick):
        # the device snapshot must mark the slot stale either way
        engine = getattr(self.node.broker, "device_engine", None)
        if engine is not None:
            engine.note_member_change(real, group)
        if op == "add":
            self.node.broker.router.add_route(real)
        else:
            self._gc_local_route(real)

    # ---- publish forwarding (emqx_broker:forward/3) ----
    def forward(self, msg: Message, filters: list[str]) -> int:
        """Called synchronously from Broker._route; sends one async
        forward per remote node carrying that node's matched filters."""
        tab = self.store.table(T_ROUTE)
        me = self.rpc.node
        per_node: dict[str, list[str]] = {}
        for f in filters:
            for origin in tab.origins(f):
                if origin != me and self.membership.is_running(origin):
                    per_node.setdefault(origin, []).append(f)
        if not per_node:
            return 0
        wire = msg.to_wire()
        for target, fs in per_node.items():
            self._spawn_fwd(target, "broker.dispatch_fwd",
                            [msg.topic, fs, wire], key=msg.topic)
            self.node.metrics.inc("messages.forward")
        return len(per_node)

    def _spawn_fwd(self, target: str, fn: str, args: list,
                   key: Optional[str]) -> None:
        loop = self._loop
        if loop is not None:
            try:
                here = asyncio.get_running_loop()
            except RuntimeError:
                here = None
            if here is not loop:
                # a consume off the loop: the loop runs the handed-over
                # forwards in the order they were made
                loop.call_soon_threadsafe(self._spawn_fwd_now, target, fn,
                                          args, key)
                return
        self._spawn_fwd_now(target, fn, args, key)

    def _spawn_fwd_now(self, target: str, fn: str, args: list,
                       key: Optional[str]) -> None:
        if self.rpc_mode == "sync":
            coro = self.rpc.call(target, fn, args, key=key)
        else:
            coro = self.rpc.cast(target, fn, args, key=key)
        t = asyncio.create_task(self._guard(coro))
        self._fwd_tasks.add(t)
        t.add_done_callback(self._fwd_tasks.discard)

    @staticmethod
    async def _guard(coro) -> None:
        try:
            await coro
        except RpcError:
            pass

    async def _h_dispatch_fwd(self, topic: str, filters: list,
                              wire: dict) -> int:
        msg = Message.from_wire(wire)
        n = 0
        for f in filters:
            n += self.node.broker.dispatch(f, msg)
        return n

    # ---- cluster-wide shared dispatch ----
    def dispatch_shared(self, broker, msg: Message,
                        filters: list[str]) -> int:
        n = 0
        for real in filters:
            groups: set[str] = set(broker.shared.get(real, {}))
            groups |= self._groups_by_real.get(real, set())
            for group in groups:
                if self._dispatch_one_group(broker, real, group, msg):
                    n += 1
        return n

    def _members(self, broker, real: str, group: str) -> list[tuple[str, int]]:
        out = {(o, v) for o, v in
               self.store.table(T_SHARED).lookup((real, group))
               if self.membership.is_running(o)}
        # local members merged directly: a just-SUBACKed subscriber must be
        # eligible before the async replication queue drains
        me = self.rpc.node
        g = broker.shared.get(real, {}).get(group)
        if g:
            out |= {(me, sid) for sid in g.members}
        return sorted(out)

    def _dispatch_one_group(self, broker, real: str, group: str,
                            msg: Message) -> bool:
        members = self._members(broker, real, group)
        if not members:
            return False
        order = self._pick_order(broker, real, group, members, msg)
        me = self.rpc.node
        for origin, sid in order:
            if origin == me:
                g = broker.shared.get(real, {}).get(group)
                opts = g.members.get(sid) if g else None
                if opts is None:
                    continue
                if broker._deliver(sid, real, msg, dict(opts, share=group)):
                    if broker.shared_strategy == "sticky":
                        self._shared_sticky[(real, group)] = (origin, sid)
                    return True
                if not broker.shared_dispatch_ack:
                    return False
            else:
                # remote member: directed delivery, fire-and-forget (the
                # reference's cross-node SubPid ! send; ack protocol only
                # spans nodes when dispatch_ack is on — we treat remote
                # dispatch as accepted like rpc.mode=async forwards)
                self._spawn_fwd(origin, "shared.deliver_fwd",
                                [real, group, sid, msg.to_wire()],
                                key=msg.topic)
                if broker.shared_strategy == "sticky":
                    self._shared_sticky[(real, group)] = (origin, sid)
                return True
        return False

    def _pick_order(self, broker, real: str, group: str,
                    members: list[tuple[str, int]],
                    msg: Message) -> list[tuple[str, int]]:
        s = broker.shared_strategy
        key = (real, group)
        if s == "sticky" and self._shared_sticky.get(key) in members:
            first = self._shared_sticky[key]
        elif s == "round_robin":
            cur = self._shared_cursors.get(key, 0)
            first = members[cur % len(members)]
            self._shared_cursors[key] = (cur + 1) % len(members)
        elif s == "hash_clientid":
            first = members[_crc(msg.from_) % len(members)]
        elif s == "hash_topic":
            first = members[_crc(msg.topic) % len(members)]
        else:
            first = members[random.randrange(len(members))]
        rest = [m for m in members if m != first]
        random.shuffle(rest)
        return [first] + rest

    async def _h_shared_deliver(self, real: str, group: str, sid: int,
                                wire: dict) -> bool:
        broker = self.node.broker
        g = broker.shared.get(real, {}).get(group)
        opts = g.members.get(sid) if g else None
        if opts is None:
            return False
        return broker._deliver(sid, real, Message.from_wire(wire),
                               dict(opts, share=group))

    # ---- clientid registry + cross-node session ops (emqx_cm_registry) ----
    def registry_register(self, clientid: str) -> None:
        self._enqueue(self.store.add, T_REGISTRY, clientid, "chan")

    def registry_unregister(self, clientid: str) -> None:
        self._enqueue(self.store.delete, T_REGISTRY, clientid, "chan")

    def registry_lookup(self, clientid: str) -> list[str]:
        return [o for o in self.store.table(T_REGISTRY).origins(clientid)
                if self.membership.is_running(o)]

    # session wire maps are small; a FROZEN owner (gray failure) must
    # cost a reconnecting client one short timeout, not the 10s default —
    # an unanswered takeover means the session is lost to the corpse
    # either way (same as the owner having died)
    TAKEOVER_RPC_TIMEOUT_S = 3.0

    async def takeover_remote(self, clientid: str) -> Optional[dict]:
        """Pull a session (wire map) from whichever node owns the client."""
        me = self.rpc.node
        for origin in self.registry_lookup(clientid):
            if origin == me:
                continue
            try:
                wire = await self.rpc.call(
                    origin, "cm.takeover", [clientid], key=clientid,
                    timeout=self.TAKEOVER_RPC_TIMEOUT_S)
            except RpcError:
                continue
            if wire is not None:
                return wire
        return None

    async def discard_remote(self, clientid: str) -> None:
        me = self.rpc.node
        for origin in self.registry_lookup(clientid):
            if origin != me:
                try:
                    await self.rpc.call(
                        origin, "cm.discard", [clientid], key=clientid,
                        timeout=self.TAKEOVER_RPC_TIMEOUT_S)
                except RpcError:
                    pass

    async def _h_cm_takeover(self, clientid: str) -> Optional[dict]:
        cm = self.node.cm
        old = cm.lookup_channel(clientid)
        if old is not None:
            session = await old.takeover_begin()
            if session is None:
                return None
            pendings = await old.takeover_end()
            cm.unregister_channel(clientid, old)
            session.enqueue([(m, m.headers.get("subopts", {}))
                             for m in pendings])
            return session.to_wire()
        detached = cm._detached.pop(clientid, None)
        cm._parked_at.pop(clientid, None)
        if detached is not None:
            sid = getattr(detached, "parked_sid", None)
            if sid is not None:
                self.node.broker.subscriber_down(sid)
            self.registry_unregister(clientid)
            return detached.to_wire()
        return None

    async def _h_cm_discard(self, clientid: str) -> None:
        await self.node.cm.discard_session(clientid)

    async def _h_cm_kick(self, clientid: str) -> bool:
        return await self.node.cm.kick_session(clientid)

    async def _h_cm_lookup_info(self, clientid: str) -> Optional[dict]:
        return self.node.cm.get_channel_info(clientid)

    async def kick_session_global(self, clientid: str) -> bool:
        """Kick wherever the client lives (emqx_cm:kick_session rpc path)."""
        if await self.node.cm.kick_session(clientid):
            return True
        for origin in self.registry_lookup(clientid):
            if origin == self.rpc.node:
                continue
            try:
                if await self.rpc.call(origin, "cm.kick", [clientid],
                                       key=clientid):
                    return True
            except RpcError:
                pass
        return False

    # ---- distributed per-clientid lock (ekka_locker quorum analog) ----
    # Leased (a crashed holder frees itself at lease expiry) and taken on a
    # majority prefix of the sorted member list: nodes with transiently
    # divergent views still serialize on the first common node, and
    # sorted-order acquisition cannot deadlock.
    LOCK_LEASE_S = 15.0
    LOCK_DEADLINE_S = 30.0      # total acquire budget across all targets
    LOCK_RPC_TIMEOUT_S = 3.0    # per-call bound: a FROZEN target (gray
    # failure: TCP open, node unresponsive) must cost callers a short
    # timeout + retry until failure detection drops it from the target
    # list — not a 35s CONNECT stall (the old handler parked contended
    # acquires server-side for 30s, so calls needed a 35s timeout)

    def _lock_targets(self) -> list[str]:
        nodes = self.membership.running_nodes()   # sorted
        return nodes[:len(nodes) // 2 + 1]

    async def _h_lock_acquire(self, clientid: str, token: str,
                              lease_s: float) -> bool:
        import time
        cur = self._lock_tab.get(clientid)
        if cur is not None and cur[0] == token:
            # retry after a lost reply (or lease refresh): idempotent
            self._lock_tab[clientid] = (token, time.monotonic() + lease_s)
            return True
        # short grace for a release already in flight; sustained
        # contention reports False FAST — the caller owns retry policy
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline:
            cur = self._lock_tab.get(clientid)
            if cur is None or cur[1] < time.monotonic():
                self._lock_tab[clientid] = (token,
                                            time.monotonic() + lease_s)
                return True
            await asyncio.sleep(0.01)
        return False

    async def _h_lock_release(self, clientid: str, token: str) -> bool:
        cur = self._lock_tab.get(clientid)
        if cur is not None and cur[0] == token:
            del self._lock_tab[clientid]
            return True
        return False

    def lock(self, clientid: str):
        """Async ctx manager: leased lock on the responsive prefix.

        Exclusion model (and its limit): each contender acquires on every
        REACHABLE target and waits out contention on any reachable-but-held
        target; unreachable targets are skipped.  Under SYMMETRIC failure
        both contenders serialize on the common responsive prefix.  Under
        ASYMMETRIC reachability (A reaches X, B does not) the two contenders
        can hold disjoint target sets and both proceed — mutual exclusion
        then rests only on the LOCK_LEASE_S lease, so the overlap window is
        bounded but nonzero.  This mirrors the availability bias of the
        reference's per-client locker (ekka_locker via emqx_cm_locker.erl):
        a takeover that double-runs is recoverable (the session migrates
        twice), whereas requiring a strict quorum would block ALL takeovers
        for a clientid whenever half the lock targets are down — the wrong
        trade for a 2-node cluster.  If stricter exclusion is ever needed,
        raise the bar here to a majority of _lock_targets().
        """
        cluster = self

        class _Guard:
            async def __aenter__(self):
                import time
                import uuid
                self.token = uuid.uuid4().hex
                self.held: list[str] = []
                deadline = time.monotonic() + cluster.LOCK_DEADLINE_S
                ok_any = False
                for target in cluster._lock_targets():
                    while True:
                        try:
                            ok = await cluster.rpc.call(
                                target, "locker.acquire",
                                [clientid, self.token,
                                 cluster.LOCK_LEASE_S],
                                key=clientid,
                                timeout=cluster.LOCK_RPC_TIMEOUT_S)
                        except RpcError:
                            # unreachable (refused) or unresponsive
                            # (frozen — the bounded call/handshake turns
                            # gray failure into this same fast error):
                            # skip the target. Mutual exclusion holds on
                            # the common RESPONSIVE prefix — both
                            # contenders still serialize on it — and the
                            # lease covers the rest. The target may have
                            # processed the acquire with the reply lost
                            # (a ~3s stall, not a death): fire a
                            # best-effort release in the BACKGROUND so an
                            # orphaned lease doesn't block this
                            # clientid's next acquire for the full lease
                            # window — awaiting it here would park this
                            # acquire on the frozen target's connect
                            # timeout, the exact stall being avoided
                            t = asyncio.get_running_loop().create_task(
                                cluster.rpc.cast(
                                    target, "locker.release",
                                    [clientid, self.token],
                                    key=clientid))
                            cluster._fwd_tasks.add(t)
                            t.add_done_callback(cluster._fwd_tasks.discard)
                            break
                        if ok:
                            self.held.append(target)
                            ok_any = True
                            break
                        # REACHABLE but contended: wait for the holder's
                        # release (or lease expiry) — never skip it, or
                        # mutual exclusion breaks
                        if time.monotonic() > deadline:
                            await self._release_held()
                            raise RpcError(
                                f"lock {clientid}: contended on {target}")
                        await asyncio.sleep(0.05)
                if not ok_any:
                    raise RpcError(f"lock {clientid}: no target reachable")
                return self

            async def _release_held(self):
                for target in self.held:
                    try:
                        await cluster.rpc.call(target, "locker.release",
                                               [clientid, self.token],
                                               key=clientid)
                    except RpcError:
                        pass   # lease expiry reclaims it
                self.held = []

            async def __aexit__(self, *exc):
                await self._release_held()
                return False
        return _Guard()

    # ---- membership events ----
    def _on_membership(self, event: str, node: str) -> None:
        # store purge already handled by ClusterStore; after a purge the
        # local trie may hold dead filters — sweep them
        broker = self.node.broker
        if event in ("nodedown", "nodeleft"):
            tab = self.store.table(T_ROUTE)
            for f in list(broker.router.topics()):
                if (not tab.origins(f)
                        and not self._groups_by_real.get(f)
                        and not broker._has_any_sub(f)):
                    broker.router.delete_route(f)
        # device snapshots bake cluster-wide shared membership in as
        # remote-ref sids: a membership transition must dirty every
        # shared slot so the next rebuild re-captures running members
        # only — otherwise device picks keep forwarding into a corpse
        # (or exclude a healed member) until unrelated churn. The host
        # path is immune (it filters by is_running at pick time).
        eng = getattr(self.node, "device_engine", None)
        if eng is not None:
            for real in set(self._groups_by_real) | set(broker.shared):
                for group in (set(self._groups_by_real.get(real, ()))
                              | set(broker.shared.get(real, ()))):
                    eng.note_member_change(real, group)

    # ---- introspection (mgmt surface) ----
    def info(self) -> dict:
        return {"node": self.rpc.node, "address": list(self.address),
                "members": self.membership.info(),
                "routes": self.store.table(T_ROUTE).count(),
                "shared": self.store.table(T_SHARED).count(),
                "registry": self.store.table(T_REGISTRY).count()}
