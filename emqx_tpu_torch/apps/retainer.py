"""Retained-message store with wildcard read on subscribe.

Parity: apps/emqx_retainer — `message.publish` hook stores/clears retained
messages (emqx_retainer.erl on_message_publish), `session.subscribed` hook
dispatches matching retained messages to the new subscriber honoring the
MQTT5 Retain-Handling subopt (emqx_retainer.erl dispatch/2), expiry via the
v5 Message-Expiry-Interval property or the configured default
(emqx_retainer_mnesia.erl expiry scan), and max_retained_messages /
max_payload_size limits (emqx_retainer.erl:enabled checks).

The reference's mnesia index-read for wildcard subscribe becomes a host
nested-level trie over retained topic *names* (exact topics, so the walk is
filter-driven); the bulk device matcher is not involved because retained
reads are off the publish hot path.

The port's copy of ``emqx_tpu/apps/retainer.py``: the store runs on the
host in both packages. While the overload governor has ``defer_retained``
armed, a subscriber's replay is parked (at most ``_DEFER_CAP``) and the
first ``tick`` after recovery replays it; ``Node.sweep`` polls the
governor before it ticks the apps, so that is the same sweep.
"""

from __future__ import annotations

from typing import Iterator, Optional

from emqx_tpu_torch.broker.hooks import HP_RETAINER
from emqx_tpu_torch.broker.message import Message, now_ms
from emqx_tpu_torch.utils import topic as T


class TopicIndex:
    """Nested-dict trie over exact topic names; lookup by wildcard filter."""

    _LEAF = object()

    def __init__(self):
        self._root: dict = {}
        self._count = 0

    def insert(self, topic: str) -> bool:
        node = self._root
        for w in T.tokens(topic):
            node = node.setdefault(w, {})
        if TopicIndex._LEAF in node:
            return False
        node[TopicIndex._LEAF] = topic
        self._count += 1
        return True

    def delete(self, topic: str) -> bool:
        path = []
        node = self._root
        for w in T.tokens(topic):
            nxt = node.get(w)
            if nxt is None:
                return False
            path.append((node, w))
            node = nxt
        if node.pop(TopicIndex._LEAF, None) is None:
            return False
        self._count -= 1
        for parent, w in reversed(path):
            if parent[w]:
                break
            del parent[w]
        return True

    def __len__(self) -> int:
        return self._count

    def match(self, filt: str) -> Iterator[str]:
        """All stored topic names matching the filter (MQTT semantics incl.
        the `$`-topic root-wildcard exclusion, emqx_topic.erl:66-69)."""
        fw = T.tokens(filt)
        exclude_dollar = fw[0] in (T.PLUS, T.HASH)

        def walk(node: dict, i: int, depth: int):
            if i == len(fw):
                t = node.get(TopicIndex._LEAF)
                if t is not None:
                    yield t
                return
            w = fw[i]
            if w == T.HASH:
                # '#' matches remaining levels including zero
                yield from collect(node, depth)
                return
            if w == T.PLUS:
                for k, child in node.items():
                    if k is TopicIndex._LEAF:
                        continue
                    if depth == 0 and exclude_dollar and k.startswith("$"):
                        continue
                    yield from walk(child, i + 1, depth + 1)
                return
            child = node.get(w)
            if child is not None:
                yield from walk(child, i + 1, depth + 1)

        def collect(node: dict, depth: int):
            for k, child in node.items():
                if k is TopicIndex._LEAF:
                    yield child
                    continue
                if depth == 0 and exclude_dollar and k.startswith("$"):
                    continue
                yield from collect(child, depth + 1)

        yield from walk(self._root, 0, 0)


class RetainerStorage:
    """Pluggable retained-message store (emqx_retainer_mnesia.erl:49-55
    behaviour analog: the reference selects mnesia ram/disc/disc_only
    copies; here a backend object with this interface).

    Entries are (Message, expire_at_ms | None); expiry policy lives in
    Retainer — backends only store and match.
    """

    def insert(self, topic: str, msg: Message,
               expire_at: Optional[int]) -> None:
        raise NotImplementedError

    def delete(self, topic: str) -> bool:
        raise NotImplementedError

    def get(self, topic: str):
        """-> (Message, expire_at) or None."""
        raise NotImplementedError

    def match_topics(self, filt: str) -> list[str]:
        raise NotImplementedError

    def items(self):
        """-> iterable of (topic, Message, expire_at)."""
        raise NotImplementedError

    def expired(self, now: int) -> list[str]:
        """Topics whose expiry is past `now`, in store order."""
        return [t for t, _m, exp in self.items()
                if exp is not None and now > exp]

    def clear(self) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class RamStorage(RetainerStorage):
    """In-memory backend (the reference's ram_copies default).

    `_n_expiring` counts the entries that carry an expiry, so the sweep's
    `expired` returns at once while none does: the reference lists every
    entry on each sweep, and with 100,000 stored messages that never
    expire, those lists' full collections read as loop lag to the
    overload governor."""

    def __init__(self):
        self._store: dict[str, tuple[Message, Optional[int]]] = {}
        self._index = TopicIndex()
        self._n_expiring = 0

    def insert(self, topic, msg, expire_at):
        old = self._store.get(topic)
        if old is None:
            self._index.insert(topic)
        elif old[1] is not None:
            self._n_expiring -= 1
        self._store[topic] = (msg, expire_at)
        if expire_at is not None:
            self._n_expiring += 1

    def delete(self, topic):
        old = self._store.pop(topic, None)
        if old is None:
            return False
        self._index.delete(topic)
        if old[1] is not None:
            self._n_expiring -= 1
        return True

    def expired(self, now):
        if not self._n_expiring:
            return []
        return super().expired(now)

    def get(self, topic):
        return self._store.get(topic)

    def match_topics(self, filt):
        return list(self._index.match(filt))

    def items(self):
        return [(t, m, exp) for t, (m, exp) in self._store.items()]

    def clear(self):
        n = len(self._store)
        self._store.clear()
        self._index = TopicIndex()
        self._n_expiring = 0
        return n

    def __len__(self):
        return len(self._store)


class DiscStorage(RamStorage):
    """Write-through disk backend (the reference's disc_copies — ram reads
    + durable writes; `disc_only` maps here too, the distinction in mnesia
    is memory residency, not semantics). A JSONL journal of set/del
    records replays on open and compacts when it grows past 4x the live
    entry count."""

    def __init__(self, dirpath: str):
        super().__init__()
        import os
        os.makedirs(dirpath, exist_ok=True)
        self.path = os.path.join(dirpath, "retained.jsonl")
        self._journal_lines = 0
        self._fh = None
        self._load()
        self._fh = open(self.path, "a", encoding="utf-8")

    def _load(self) -> None:
        import json
        import os

        from emqx_tpu_torch.broker.persistence import _dec_deep
        if not os.path.exists(self.path):
            return
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ent = _dec_deep(json.loads(line))
                except ValueError:
                    continue        # torn tail write: ignore
                self._journal_lines += 1
                if ent.get("op") == "del":
                    super().delete(ent["topic"])
                elif ent.get("op") == "set":
                    msg = Message.from_wire(ent["msg"])
                    super().insert(msg.topic, msg, ent.get("expire_at"))

    def _append(self, ent: dict) -> None:
        import json

        from emqx_tpu_torch.broker.persistence import _enc
        self._fh.write(json.dumps(ent, default=_enc) + "\n")
        self._fh.flush()
        self._journal_lines += 1
        if self._journal_lines > max(64, 4 * len(self._store)):
            self._compact()

    def _compact(self) -> None:
        import json
        import os

        from emqx_tpu_torch.broker.persistence import _enc
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for t, (m, exp) in self._store.items():
                f.write(json.dumps({"op": "set", "msg": m.to_wire(),
                                    "expire_at": exp}, default=_enc) + "\n")
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._journal_lines = len(self._store)

    def insert(self, topic, msg, expire_at):
        super().insert(topic, msg, expire_at)
        self._append({"op": "set", "msg": msg.to_wire(),
                      "expire_at": expire_at})

    def delete(self, topic):
        if not super().delete(topic):
            return False
        self._append({"op": "del", "topic": topic})
        return True

    def clear(self):
        n = super().clear()
        self._compact()
        return n

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def make_storage(conf) -> RetainerStorage:
    """Config -> backend: "ram" (default) | {"type": "disc"|"disc_only",
    "dir": path}."""
    if isinstance(conf, RetainerStorage):
        return conf
    if conf in (None, "ram"):
        return RamStorage()
    if isinstance(conf, str):
        conf = {"type": conf}
    stype = conf.get("type", "ram")
    if stype == "ram":
        return RamStorage()
    if stype in ("disc", "disc_only"):
        return DiscStorage(conf.get("dir", "data/retainer"))
    raise ValueError(f"unknown retainer storage type {stype!r}")


class Retainer:
    def __init__(self, node, conf: Optional[dict] = None,
                 storage: Optional[RetainerStorage] = None):
        self.node = node
        c = dict(node.config.get("retainer") or {})
        c.update(conf or {})
        self.enable = c.get("enable", True)
        self.max_retained = int(c.get("max_retained_messages", 0))
        self.max_payload = int(c.get("max_payload_size", 1024 * 1024))
        self.default_expiry = int(c.get("msg_expiry_interval", 0))  # s, 0=∞
        self.storage = make_storage(storage
                                    if storage is not None
                                    else c.get("storage"))
        # replays parked by the overload governor's defer_retained
        # shed action, drained by tick() on recovery
        self._deferred: list = []

    # ---- app lifecycle ----
    def load(self) -> "Retainer":
        self.node.hooks.add("message.publish", self.on_message_publish,
                            priority=HP_RETAINER, tag="retainer")
        self.node.hooks.add("session.subscribed", self.on_session_subscribed,
                            tag="retainer")
        self.node.stats.register_stats_fun(self.stats_fun)
        return self

    def unload(self) -> None:
        self.node.hooks.delete("message.publish", "retainer")
        self.node.hooks.delete("session.subscribed", "retainer")

    # ---- hooks ----
    def on_message_publish(self, msg: Message):
        if not self.enable or not msg.retain or msg.topic.startswith("$SYS/"):
            return ("ok", msg)
        if not msg.payload:
            self.delete(msg.topic)
            # empty retained publish clears the store and is NOT routed
            # further with retain semantics; the message itself still
            # propagates (spec: treated as normal publish w/o retention)
            return ("ok", msg)
        self._insert(msg)
        return ("ok", msg)

    # overload defer_retained bound: replays parked while
    # the governor sheds; beyond this the OLDEST parked replays drop
    # (counted) — retained replay is best-effort convenience, and an
    # unbounded parking lot under a flood would be its own overload
    _DEFER_CAP = 1024

    def on_session_subscribed(self, clientinfo: dict, topic: str,
                              subopts: dict):
        if not self.enable:
            return
        rh = int(subopts.get("rh", 0))
        is_new = bool(subopts.get("is_new", True))
        if rh == 2 or (rh == 1 and not is_new):
            return
        if subopts.get("share"):
            return      # shared subscriptions get no retained replay (spec)
        gov = getattr(self.node, "overload_governor", None)
        if gov is not None and gov.retained_deferred:
            # overload defer_retained action: a wildcard
            # retained read + fan-out is pure extra load mid-flood —
            # park the replay (bounded) and run it on the first
            # housekeeping tick after the governor recovers
            self._deferred.append((dict(clientinfo), topic,
                                   dict(subopts)))
            gov.count_retained_deferred()
            while len(self._deferred) > self._DEFER_CAP:
                self._deferred.pop(0)
                self.node.metrics.inc("messages.retained.dropped")
            return
        self._dispatch_retained(clientinfo, topic, subopts)

    def _dispatch_retained(self, clientinfo: dict, topic: str,
                           subopts: dict) -> None:
        chan = self.node.cm.lookup_channel(clientinfo.get("clientid", ""))
        if chan is None:
            return
        opts = {k: v for k, v in subopts.items() if k != "is_new"}
        for m in self.match(topic):
            d = m.copy()
            d.set_flag("retained", True)
            d.headers["subopts"] = opts
            chan.deliver(topic, d)

    # ---- store ----
    def _expire_at(self, msg: Message) -> Optional[int]:
        exp = msg.expiry_interval()
        if exp is None:
            exp = self.default_expiry or None
        return None if exp is None else msg.ts + exp * 1000

    def _insert(self, msg: Message) -> bool:
        t = msg.topic
        if len(msg.payload) > self.max_payload:
            self.node.metrics.inc("messages.retained.dropped")
            return False
        if (self.max_retained and self.storage.get(t) is None
                and len(self.storage) >= self.max_retained):
            self.node.metrics.inc("messages.retained.dropped")
            return False
        self.storage.insert(t, msg.copy(), self._expire_at(msg))
        self.node.metrics.inc("messages.retained")
        return True

    def delete(self, topic: str) -> bool:
        return self.storage.delete(topic)

    def lookup(self, topic: str) -> Optional[Message]:
        ent = self.storage.get(topic)
        if ent is None:
            return None
        msg, exp = ent
        if exp is not None and now_ms() > exp:
            self.delete(topic)
            return None
        return msg

    def match(self, filt: str) -> list[Message]:
        """All live retained messages matching a filter (wildcard read)."""
        out = []
        for t in self.storage.match_topics(filt):
            m = self.lookup(t)
            if m is not None:
                out.append(m)
        return out

    def clean(self, filt: Optional[str] = None) -> int:
        """Purge retained messages (all, or those matching a filter) —
        emqx_retainer:clean/0, emqx_mgmt:clean_retained."""
        if filt is None:
            return self.storage.clear()
        gone = self.storage.match_topics(filt)
        for t in gone:
            self.delete(t)
        return len(gone)

    def clean_expired(self) -> int:
        stale = self.storage.expired(now_ms())
        for t in stale:
            self.delete(t)
        return len(stale)

    def tick(self) -> None:
        """Housekeeping hook (Node.sweep): expiry scan + replay of
        retained dispatches the overload governor deferred (runs after
        the governor's own poll in the sweep, so the first healthy
        tick drains the parking lot)."""
        self.clean_expired()
        if self._deferred:
            gov = getattr(self.node, "overload_governor", None)
            if gov is None or not gov.retained_deferred:
                parked, self._deferred = self._deferred, []
                for clientinfo, topic, subopts in parked:
                    self._dispatch_retained(clientinfo, topic, subopts)

    def retained_count(self) -> int:
        return len(self.storage)

    def stats_fun(self, stats) -> None:
        stats.setstat("retained.count", len(self.storage), "retained.max")
