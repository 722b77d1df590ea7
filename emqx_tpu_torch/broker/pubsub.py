"""The pubsub engine: subscribe/unsubscribe/publish/dispatch.

Parity: emqx_broker.erl (publish/1 :199-209, dispatch/2 :282-308,
subscriber tables :96-109) + emqx_shared_sub.erl (group strategies :62-67,
pick :239-268). Host-side engine over the Router; the device fused path
(models.router_engine.route_step) serves the bulk micro-batch pipeline,
while this engine is the authoritative per-message semantics. The port's
copy of ``emqx_tpu/broker/pubsub.py``, with the latency observatory's hook
on the batcher-less host path (``latency_obs``) and the cluster hooks
(``cluster``: route and shared-member replication, cross-node forwarding,
cluster-wide shared dispatch).

Subscribers are registered as deliver callbacks keyed by an integer
subscriber id (the "session row" of the device tables); the reference's
`SubPid ! {deliver,...}` becomes `subscriber.deliver(filter, msg)`.
"""

from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass, field
from typing import Optional, Protocol

from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.broker.metrics import Metrics
from emqx_tpu_torch.broker.router import Router
from emqx_tpu_torch.utils import topic as T

SHARED_STRATEGIES = ("random", "round_robin", "sticky", "hash_clientid",
                     "hash_topic")


class Subscriber(Protocol):
    def deliver(self, topic_filter: str, msg: Message) -> bool:
        """Deliver one routed message; False = nack (shared redispatch).

        `msg` is either a full Message copy (the host/inline paths —
        `_deliver` below) or a `broker.deliver.DeliveryView` (the
        delivery lanes' fast path): a copy-on-write view sharing the
        routed message's payload/headers with `subopts` overlaid. Both
        quack the same; treat the delivered message's `subopts` as
        frozen (views share one 64-entry unpacked-subopts table).

        Subscribers MAY also implement
        `deliver_batch(items: list[tuple[str, Message]]) -> int`
        (all-or-none accept; returns len(items) or 0): the delivery
        lanes coalesce a same-session run of messages into one call so
        the session accept + socket drain amortize across the run, and
        count `messages.delivered` and run the `message.delivered` hook
        per lane slice. Without it, the lanes call deliver() per
        message."""


@dataclass
class SharedGroup:
    members: dict[int, dict] = field(default_factory=dict)  # sid -> subopts
    cursor: int = 0                 # round_robin position
    sticky: Optional[int] = None    # sticky member


def _hash(s: str) -> int:
    return zlib.crc32(s.encode())


class Broker:
    def __init__(self, router: Optional[Router] = None,
                 hooks: Optional[Hooks] = None,
                 metrics: Optional[Metrics] = None,
                 shared_strategy: str = "round_robin",
                 shared_dispatch_ack: bool = False):
        self.router = router or Router()
        self.hooks = hooks or Hooks()
        self.metrics = metrics or Metrics()
        self.shared_strategy = shared_strategy
        self.shared_dispatch_ack = shared_dispatch_ack

        # set by cluster.ClusterNode when this broker joins a cluster:
        # replicates routes/shared-members and forwards cross-node
        self.cluster = None
        # set by DeviceRouteEngine: membership-churn listener for the
        # compiled device snapshot
        self.device_engine = None
        # set by Node when the latency observatory is on: the
        # per-message host publish path (no batcher) records its
        # ingress→routed/delivered latency here; the batcher's paths
        # record at batch settle instead, never both for one message
        self.latency_obs = None

        self._subscribers: dict[int, Subscriber] = {}
        self._sub_meta: dict[int, str] = {}     # sid -> clientid
        self._pub_tasks: set = set()            # in-flight publish_soon
        # filter -> {sid -> subopts}  (emqx_subscriber + emqx_suboption)
        self.subs: dict[str, dict[int, dict]] = {}
        # real filter -> {group -> SharedGroup} (emqx_shared_subscription),
        # indexed by filter so dispatch only touches matched groups
        self.shared: dict[str, dict[str, SharedGroup]] = {}
        self._next_sid = 0

    # ---- subscriber registry ----
    def register(self, subscriber: Subscriber, clientid: str = "") -> int:
        sid = self._next_sid
        self._next_sid += 1
        self._subscribers[sid] = subscriber
        self._sub_meta[sid] = clientid
        return sid

    def unregister(self, sid: int) -> None:
        self._subscribers.pop(sid, None)
        self._sub_meta.pop(sid, None)

    def swap_subscriber(self, sid: int, subscriber: Subscriber) -> None:
        """Re-point an existing sid at a new deliver target (used when a
        connection detaches, leaving its persistent session parked, and
        when it re-attaches — the reference instead keeps the channel
        process alive in 'disconnected' state)."""
        self._subscribers[sid] = subscriber

    # ---- subscribe / unsubscribe (emqx_broker:subscribe/3 :115-162) ----
    def subscribe(self, sid: int, topic_filter: str,
                  subopts: Optional[dict] = None) -> None:
        real, opts = T.parse(topic_filter, dict(subopts or {}))
        group = opts.get("share")
        if group:
            g = self.shared.setdefault(real, {}).setdefault(
                group, SharedGroup())
            g.members[sid] = opts
            if len(g.members) == 1:
                self.router.add_route(real)
            if self.cluster:
                self.cluster.shared_join(real, group, sid)
            if self.device_engine:
                self.device_engine.note_member_change(real, group)
        else:
            fsubs = self.subs.setdefault(real, {})
            fsubs[sid] = opts
            if len(fsubs) == 1:
                self.router.add_route(real)
                if self.cluster:
                    self.cluster.local_route_add(real)
            if self.device_engine:
                self.device_engine.note_member_change(real, None)

    def unsubscribe(self, sid: int, topic_filter: str) -> bool:
        real, opts = T.parse(topic_filter)
        group = opts.get("share")
        if group:
            groups = self.shared.get(real)
            g = groups.get(group) if groups else None
            if not g or sid not in g.members:
                return False
            del g.members[sid]
            if g.sticky == sid:
                g.sticky = None
            if self.cluster:
                self.cluster.shared_leave(real, group, sid)
            if self.device_engine:
                self.device_engine.note_member_change(real, group)
            if not g.members:
                del groups[group]
                if not groups:
                    del self.shared[real]
                if not self._has_any_sub(real):
                    self._route_del(real)
            return True
        fsubs = self.subs.get(real)
        if not fsubs or sid not in fsubs:
            return False
        del fsubs[sid]
        if not fsubs:
            del self.subs[real]
            if not self._has_any_sub(real):
                self._route_del(real)
        if self.device_engine:
            self.device_engine.note_member_change(real, None)
        return True

    def _route_del(self, real: str) -> None:
        """Remove the local route; under a cluster the filter stays in the
        local trie while any remote node still routes it (the reference's
        per-node #route rows — emqx_router.erl:77-86)."""
        if self.cluster:
            self.cluster.local_route_del(real)
        else:
            self.router.delete_route(real)

    def _has_any_sub(self, real: str) -> bool:
        if self.subs.get(real):
            return True
        return any(g.members for g in self.shared.get(real, {}).values())

    def subscriber_down(self, sid: int) -> None:
        """Clean every subscription of a dead subscriber
        (emqx_broker_helper DOWN cleanup, emqx_broker.erl:330-347)."""
        for f in [f for f, m in self.subs.items() if sid in m]:
            self.unsubscribe(sid, f)
        for real, groups in list(self.shared.items()):
            for group in [gn for gn, g in groups.items()
                          if sid in g.members]:
                self.unsubscribe(sid, f"$share/{group}/{real}")
        self.unregister(sid)

    # ---- publish (emqx_broker:publish/1 :199-209) ----
    def publish(self, msg: Message) -> int:
        """Run message.publish hooks, route, dispatch. Returns deliveries.

        A hook setting allow_publish=false (delayed interception, rule-engine
        republish guards) stops routing quietly — the reference just returns
        [] without counting a drop (emqx_broker.erl:203-208).

        Async message.publish callbacks (exhook gRPC) are skipped on this
        sync path; client publishes go through publish_async which awaits
        them (the reference blocks the channel process there)."""
        msg = self.hooks.run_fold("message.publish", (), msg)
        if msg is None or msg.get_header("allow_publish") is False:
            return 0
        self.metrics.inc("messages.publish")
        return self._route(msg, self.router.match(msg.topic))

    async def publish_async(self, msg: Message) -> int:
        """publish/1 with awaited message.publish callbacks — the channel's
        per-client PUBLISH path, where a slow extension blocks only this
        client like the reference's channel process."""
        msg = await self.hooks.run_fold_async("message.publish", (), msg)
        if msg is None or msg.get_header("allow_publish") is False:
            return 0
        self.metrics.inc("messages.publish")
        n = self._route(msg, self.router.match(msg.topic))
        obs = self.latency_obs
        if obs is not None and msg.ingress_ns:
            # routing and delivery are one inline walk: both legs share
            # the settle clock
            s = (time.perf_counter_ns() - msg.ingress_ns) / 1e9
            obs.record_routed(msg, "host", s)
            obs.record_delivered(msg, "host", s)
        return n

    def publish_soon(self, msg: Message) -> None:
        """Fire-and-forget publish from sync code paths (will messages,
        gateway datagrams, rule republish): schedules publish_async so
        async extension hooks (exhook) still see the message; falls back
        to the sync path when no loop is running. Tasks are strongly held
        until done — the loop only keeps weak refs and GC could otherwise
        drop an in-flight publish."""
        import asyncio
        try:
            task = asyncio.get_running_loop().create_task(
                self.publish_async(msg))
        except RuntimeError:
            self.publish(msg)
            return
        self._pub_tasks.add(task)
        task.add_done_callback(self._pub_tasks.discard)
        from emqx_tpu_torch.broker.supervise import guard_task
        guard_task(task, "publish-soon", self.metrics)

    def publish_batch(self, msgs: list[Message]) -> list[int]:
        """Micro-batched publish: one device route step for the whole batch
        (the {active,N}-window analog, SURVEY.md P10)."""
        live: list[Message] = []
        for m in msgs:
            mm = self.hooks.run_fold("message.publish", (), m)
            if mm is None or mm.get_header("allow_publish") is False:
                live.append(None)
            else:
                self.metrics.inc("messages.publish")
                live.append(mm)
        idx = [i for i, m in enumerate(live) if m is not None]
        counts = [0] * len(msgs)
        routed = None
        if self.device_engine is not None and idx:
            routed = self.device_engine.route_batch([live[i] for i in idx])
        if routed is None:
            matched = self.router.match_batch([live[i].topic for i in idx])
            routed = [self._route(live[i], matched[j])
                      for j, i in enumerate(idx)]
        for j, i in enumerate(idx):
            counts[i] = routed[j]
        return counts

    def _route(self, msg: Message, filters: list[str]) -> int:
        n = 0
        for f in filters:
            n += self.dispatch(f, msg)
        n += self._dispatch_shared(msg, filters)
        if self.cluster:
            n += self.cluster.forward(msg, filters)
        if n == 0 and not msg.is_sys:
            self.metrics.inc("messages.dropped")
            self.metrics.inc("messages.dropped.no_subscribers")
            self.hooks.run("message.dropped", (msg, "no_subscribers"))
        return n

    # ---- dispatch (emqx_broker:dispatch/2 :282-308) ----
    def dispatch(self, topic_filter: str, msg: Message) -> int:
        n = 0
        for sid, subopts in list(self.subs.get(topic_filter, {}).items()):
            if self._deliver(sid, topic_filter, msg, subopts):
                n += 1
        return n

    def _deliver(self, sid: int, topic_filter: str, msg: Message,
                 subopts: dict) -> bool:
        sub = self._subscribers.get(sid)
        if sub is None:
            return False
        m = msg.copy()
        m.headers["subopts"] = subopts
        ok = sub.deliver(topic_filter, m)
        if ok:
            self.metrics.inc("messages.delivered")
            self.hooks.run("message.delivered", (self._sub_meta.get(sid), m))
        return bool(ok)

    # ---- shared dispatch (emqx_shared_sub:dispatch :120-135) ----
    def _dispatch_shared(self, msg: Message, filters: list[str]) -> int:
        if self.cluster:
            return self.cluster.dispatch_shared(self, msg, filters)
        n = 0
        for real in filters:
            for group, g in list(self.shared.get(real, {}).items()):
                if g.members and self._shared_pick_deliver(group, real, g,
                                                           msg):
                    n += 1
        return n

    def _shared_pick_deliver(self, group: str, real: str, g: SharedGroup,
                             msg: Message) -> bool:
        """Pick per strategy; on nack retry remaining members (failover,
        emqx_shared_sub.erl:120-135)."""
        order = self._pick_order(group, real, g, msg)
        for k, sid in enumerate(order):
            opts = g.members.get(sid)
            if opts is None:
                continue
            if self._deliver(sid, real, msg, dict(opts, share=group)):
                if self.shared_strategy == "sticky":
                    g.sticky = sid
                return True
            if not self.shared_dispatch_ack:
                return False   # without ack protocol, first pick is final
        return False

    def _pick_order(self, group: str, real: str, g: SharedGroup,
                    msg: Message) -> list[int]:
        sids = list(g.members)
        s = self.shared_strategy
        if s == "sticky" and g.sticky in g.members:
            first = g.sticky
        elif s == "round_robin":
            # pick-then-advance: first registered member gets the first
            # message, matching the device kernel (ops.shared.pick_members)
            # and the reference's counter start (emqx_shared_sub.erl:284-290)
            first = sids[g.cursor % len(sids)]
            g.cursor = (g.cursor + 1) % len(sids)
        elif s == "hash_clientid":
            first = sids[_hash(msg.from_) % len(sids)]
        elif s == "hash_topic":
            first = sids[_hash(msg.topic) % len(sids)]
        else:
            first = sids[random.randrange(len(sids))]
        rest = [x for x in sids if x != first]
        random.shuffle(rest)
        return [first] + rest

    # ---- introspection (emqx.erl facade: topics/subscriptions/subscribers) ----
    def subscriptions(self, sid: int) -> list[tuple[str, dict]]:
        out = [(f, m[sid]) for f, m in self.subs.items() if sid in m]
        out += [(f"$share/{grp}/{real}", g.members[sid])
                for real, groups in self.shared.items()
                for grp, g in groups.items() if sid in g.members]
        return out

    def subscribers(self, topic_filter: str) -> list[int]:
        return list(self.subs.get(topic_filter, {}))

    def subscription_count(self) -> int:
        return (sum(len(m) for m in self.subs.values()) +
                self.shared_subscription_count())

    def shared_subscription_count(self) -> int:
        return sum(len(g.members) for groups in self.shared.values()
                   for g in groups.values())

    def stats_fun(self, stats) -> None:
        """Parity: emqx_broker:stats_fun/0."""
        stats.setstat("topics.count", self.router.route_count(), "topics.max")
        stats.setstat("subscribers.count",
                      sum(len(m) for m in self.subs.values()),
                      "subscribers.max")
        stats.setstat("subscriptions.count", self.subscription_count(),
                      "subscriptions.max")
        stats.setstat("subscriptions.shared.count",
                      self.shared_subscription_count(),
                      "subscriptions.shared.max")
