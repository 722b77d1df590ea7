"""Replicated metadata store: the ekka_mnesia analog.

The port's copy of ``emqx_tpu/cluster/store.py`` (the port imports nothing
from ``emqx_tpu``).

Parity: the reference replicates routes/shared-subs/banned/etc. as mnesia
ram_copies tables with transactional writes (emqx_router.erl:77-86,
emqx_shared_sub.erl:89-97). SURVEY.md §7 re-derives this as a simpler,
stronger design: **each node is the single writer for its own entries**, and
publishes an ordered per-origin op log; every node applies every origin's log
in order, so all replicas converge without distributed transactions (the
reference's route-lock strategies emqx_router.erl:251-303 exist only because
multiple nodes mutate shared trie rows — here they never do).

Tables are bags keyed by (key, origin): an origin can only add/delete values
it owns, which makes nodedown cleanup (`purge_origin`, the emqx_router_helper
analog) exact. Late joiners get a full snapshot, then the live feed; a
per-origin sequence number discards out-of-order/duplicate casts.
"""

from __future__ import annotations

import asyncio

from emqx_tpu_torch.broker.supervise import spawn
import logging
import time
from typing import Any, Callable, Optional

from emqx_tpu_torch.cluster.membership import Membership
from emqx_tpu_torch.cluster.rpc import RpcNode

log = logging.getLogger("emqx_tpu_torch.cluster.store")


class Table:
    """One replicated bag table: key -> {origin -> [values]}."""

    def __init__(self, name: str):
        self.name = name
        self.rows: dict[Any, dict[str, list]] = {}
        self._count = 0       # live value count (count() is polled in
        #                       sync loops — O(n) scans there are O(n²))
        # fn(op, key, value, origin) on every applied mutation
        self.watchers: list[Callable[[str, Any, Any, str], None]] = []

    def _apply(self, op: str, key: Any, value: Any, origin: str) -> None:
        if op == "add":
            vals = self.rows.setdefault(key, {}).setdefault(origin, [])
            if value not in vals:
                vals.append(value)
                self._count += 1
        elif op == "del":
            per = self.rows.get(key)
            if per is None:
                return
            vals = per.get(origin)
            if vals is None:
                return
            try:
                vals.remove(value)
            except ValueError:
                return
            self._count -= 1
            if not vals:
                del per[origin]
            if not per:
                del self.rows[key]
        for w in self.watchers:
            try:
                w(op, key, value, origin)
            except Exception:  # noqa: BLE001
                log.exception("table %s watcher failed", self.name)

    # ---- reads (always local; ram_copies semantics) ----
    def lookup(self, key: Any) -> list[tuple[str, Any]]:
        """[(origin, value)] for key."""
        return [(o, v) for o, vals in self.rows.get(key, {}).items()
                for v in vals]

    def origins(self, key: Any) -> list[str]:
        return list(self.rows.get(key, {}))

    def keys(self) -> list:
        return list(self.rows)

    def count(self) -> int:
        return self._count


class ClusterStore:
    def __init__(self, rpc: RpcNode, membership: Membership):
        self.rpc = rpc
        self.membership = membership
        self.tables: dict[str, Table] = {}
        self._seq = 0                         # ops this origin has published
        # boot incarnation: a restarted origin restarts its seq at 0, and
        # a replica that kept the old origin's _applied would swallow every
        # new op as a "duplicate" (observed: a node rejoining before
        # nodedown fired was unreachable — its route ops were dropped).
        # Ops carry (incarnation, seq); a NEWER incarnation purges the
        # origin's old rows and resets its seq tracking (the analog of
        # mnesia recopying a restarted node's table). Wall-clock ns: restart
        # gaps are seconds, far above any cross-host skew that matters.
        self._inc = time.time_ns()
        self._origin_inc: dict[str, int] = {}  # origin -> its incarnation
        self._applied: dict[str, int] = {}    # origin -> last applied seq
        self._buffer: dict[str, dict[int, tuple]] = {}  # out-of-order holds
        self._lag_seen: dict[str, int] = {}   # origin -> applied at last check
        self._ae_task: Optional[asyncio.Task] = None
        rpc.register("store.op", self._h_op)
        rpc.register("store.op_batch", self._h_op_batch)
        rpc.register("store.snapshot", self._h_snapshot)
        rpc.register("store.seq", self._h_seq)
        membership.monitor(self._on_membership)

    def start_anti_entropy(self, interval_s: float = 5.0) -> None:
        """Heal replica divergence from lost casts: if an origin's applied
        seq stalls below its published seq across two checks, resync
        (mnesia would instead fall back to a full table copy on reconnect)."""
        self._ae_task = asyncio.get_running_loop().create_task(
            self._ae_loop(interval_s))

    def stop_anti_entropy(self) -> None:
        if self._ae_task:
            self._ae_task.cancel()

    async def _ae_loop(self, interval_s: float) -> None:
        from emqx_tpu_torch.cluster.rpc import RpcError
        while True:
            await asyncio.sleep(interval_s)
            for origin in self.membership.other_nodes():
                try:
                    rseq = await self.rpc.call(origin, "store.seq", [],
                                               timeout=2)
                except RpcError:
                    continue
                applied = self._applied.get(origin, 0)
                if applied < rseq and self._lag_seen.get(origin) == applied:
                    # no progress since last check: casts were lost
                    await self._safe_sync(origin)
                self._lag_seen[origin] = self._applied.get(origin, 0)

    async def _h_seq(self) -> int:
        return self._seq

    def table(self, name: str) -> Table:
        if name not in self.tables:
            self.tables[name] = Table(name)
        return self.tables[name]

    # ---- writes: local apply + ordered broadcast ----
    async def add(self, table: str, key: Any, value: Any) -> None:
        await self._publish("add", table, key, value)

    async def delete(self, table: str, key: Any, value: Any) -> None:
        await self._publish("del", table, key, value)

    async def _publish(self, op: str, table: str, key: Any,
                       value: Any) -> None:
        me = self.rpc.node
        self._seq += 1
        self.table(table)._apply(op, key, value, me)
        for node in self.membership.other_nodes():
            # key-pinned so one origin's ops for one route key stay ordered
            await self.rpc.cast(node, "store.op",
                                [me, self._inc, self._seq, op, table, key,
                                 value],
                                key=f"{table}:{key}")

    async def add_many(self, table: str, items: list) -> None:
        """Bulk add: [(key, value)] applied locally + broadcast as ONE
        `store.op_batch` cast per peer per chunk. Bulk route churn (a
        10M-sub boot, a mass resubscribe) is RPC-frame-bound, not
        trie-bound: per-op casts cost an encode/decode round per route
        AND starve the heartbeat loop into false nodedowns (observed: a
        200k-route burst triggered repeated full resyncs). Receiver-side
        ordering needs no channel pinning — the per-origin seq buffer
        already applies ops in seq order whatever channel they rode."""
        me = self.rpc.node
        tab = self.table(table)
        batch = []
        for i, (key, value) in enumerate(items):
            self._seq += 1
            tab._apply("add", key, value, me)
            batch.append([self._seq, "add", table, key, value])
            if i % 1024 == 1023:
                # watchers do trie/index work per apply: yield so a big
                # coalesced run can't hold the loop into heartbeat misses
                await asyncio.sleep(0)
        peers = self.membership.other_nodes()
        CHUNK = 4096
        for i in range(0, len(batch), CHUNK):
            chunk = batch[i:i + CHUNK]
            for node in peers:
                await self.rpc.cast(node, "store.op_batch",
                                    [me, self._inc, chunk],
                                    key=f"{table}:batch")

    def _check_incarnation(self, origin: str, inc: int) -> bool:
        """Track the origin's boot incarnation; False = stale straggler."""
        known_inc = self._origin_inc.get(origin)
        if known_inc is None or inc > known_inc:
            # first contact, or the origin RESTARTED: its old rows are a
            # dead incarnation's state and its seq restarted at 0 — purge
            # and track the new incarnation, or every fresh op would be
            # dropped as a duplicate of the old sequence
            if known_inc is not None:
                self.purge_origin(origin)
            self._origin_inc[origin] = inc
            self._applied[origin] = 0
            self._buffer.pop(origin, None)
        elif inc < known_inc:
            return False      # straggler from a dead incarnation: drop
        return True

    def _recv_op(self, origin: str, seq: int, op: str, table: str,
                 key: Any, value: Any) -> None:
        """Seq-ordered apply with out-of-order buffering."""
        if isinstance(key, list):        # tuple keys round-trip as JSON lists
            key = tuple(key)
        last = self._applied.get(origin, 0)
        if seq <= last:
            return                          # duplicate
        buf = self._buffer.setdefault(origin, {})
        buf[seq] = (op, table, key, value)
        while last + 1 in buf:
            last += 1
            o, t, k, v = buf.pop(last)
            self.table(t)._apply(o, k, v, origin)
        self._applied[origin] = last
        # a gap means casts raced ahead on different channels; the buffered
        # ops apply the moment the missing seq arrives

    async def _h_op(self, origin: str, inc: int, seq: int, op: str,
                    table: str, key: Any, value: Any) -> None:
        if self._check_incarnation(origin, inc):
            self._recv_op(origin, seq, op, table, key, value)

    async def _h_op_batch(self, origin: str, inc: int,
                          batch: list) -> None:
        if not self._check_incarnation(origin, inc):
            return
        for i, (seq, op, table, key, value) in enumerate(batch):
            self._recv_op(origin, seq, op, table, key, value)
            if i % 1024 == 1023:
                await asyncio.sleep(0)   # see add_many: loop liveness
                if self._origin_inc.get(origin) != inc:
                    return   # origin restarted during the yield: the
                    # rest of this batch is a dead incarnation's state

    # ---- snapshot sync (mnesia copy_table analog) ----
    def _snapshot(self) -> dict:
        me = self.rpc.node
        out: dict = {"seq": self._seq, "inc": self._inc, "tables": {}}
        for name, tab in self.tables.items():
            rows = []
            for key, per in tab.rows.items():
                for v in per.get(me, []):
                    rows.append([key, v])
            out["tables"][name] = rows
        return out

    async def _h_snapshot(self) -> dict:
        return self._snapshot()

    async def sync_from(self, node: str) -> None:
        """Pull `node`'s own entries (its single-writer set) wholesale."""
        snap = await self.rpc.call(node, "store.snapshot", [])
        self.purge_origin(node)
        for name, rows in snap["tables"].items():
            tab = self.table(name)
            for key, v in rows:
                if isinstance(key, list):
                    key = tuple(key)
                tab._apply("add", key, v, node)
        self._applied[node] = snap["seq"]
        if "inc" in snap:     # a live node's snapshot is authoritative
            self._origin_inc[node] = snap["inc"]
        self._buffer.pop(node, None)

    # ---- failure cleanup (emqx_router_helper:cleanup_routes, §3.5) ----
    def purge_origin(self, origin: str) -> None:
        for tab in self.tables.values():
            for key in list(tab.rows):
                per = tab.rows[key]
                for v in per.get(origin, [])[:]:
                    tab._apply("del", key, v, origin)

    def _on_membership(self, event: str, node: str) -> None:
        if event in ("nodedown", "nodeleft"):
            self.purge_origin(node)
        elif event in ("nodeup", "healed"):
            # resync that origin's current state (it may have mutated while
            # partitioned — the autoheal path)
            try:
                asyncio.get_running_loop()
                spawn(self._safe_sync(node), "store-resync")
            except RuntimeError:
                pass   # no loop (sync test context): peer syncs on join

    async def _safe_sync(self, node: str) -> None:
        try:
            await self.sync_from(node)
        except Exception:  # noqa: BLE001
            log.info("snapshot sync from %s failed (will heal on next beat)",
                     node)
