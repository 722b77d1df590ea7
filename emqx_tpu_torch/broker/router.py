"""Host route table: topic-filter routes with device-accelerated matching.

Parity: emqx_router.erl (route add/delete + match_routes, :113-141) and
emqx_trie.erl (wildcard-filter trie). The port's copy of
``emqx_tpu/broker/router.py``: routes live host-side in an authoritative
`HostTrie` + exact-match dict (the reference also short-circuits exact
topics past the trie, emqx_router.erl:136-141), while wildcard matching for
publish micro-batches runs on the device (``ops/match.match_batch``)
against a compiled columnar `TrieTables` snapshot.

Snapshot protocol (the "mutable trie on immutable arrays" answer):
  - every wildcard route add/delete updates `HostTrie` immediately and is
    also recorded in a delta trie (adds) relative to the last device build;
  - device match = device fids (validated against the *current* route set,
    which subsumes deletions) ∪ delta-trie matches ∪ exact lookups;
  - when the delta exceeds `rebuild_threshold`, the columnar tables are
    rebuilt.

Single-writer: all mutations must come from one task, the analog of the
reference's pooled router workers serializing route ops
(emqx_broker.erl:427-428).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from emqx_tpu_torch.convert import trie_from_numpy
from emqx_tpu_torch.device import resolve_device
from emqx_tpu_torch.ops import intern as I
from emqx_tpu_torch.ops.trie import HostTrie, TrieTables, build_tables
from emqx_tpu_torch.utils import topic as T


class Router:
    def __init__(self, *, use_device: bool = True,
                 rebuild_threshold: int = 256,
                 max_levels: int = 16,
                 frontier_cap: int = 16, match_cap: int = 64,
                 device_min_batch: int = 4, device=None):
        self.intern = I.InternTable()
        self.use_device = use_device
        # the device batch match runs on `device` (cuda unless the caller
        # asks for the CPU); resolved only when the device path is on
        self.device = resolve_device(device) if use_device else None
        self.rebuild_threshold = rebuild_threshold
        self.max_levels = max_levels
        self.frontier_cap = frontier_cap
        self.match_cap = match_cap
        self.device_min_batch = device_min_batch

        # authoritative state
        self.exact: set[str] = set()                # non-wildcard routed topics
        self.wildcards: dict[str, int] = {}         # filter -> fid
        self._fid_words: dict[int, list[int]] = {}  # fid -> interned words
        self._fid_filter: dict[int, str] = {}       # fid -> filter string
        self._next_fid = 0
        self.host_trie = HostTrie()

        # filter-universe change listener (DeviceRouteEngine): called with
        # (topic_filter, added: bool) after every successful mutation
        self.on_route_change = None

        # device snapshot
        self._tables: Optional[TrieTables] = None
        self._built_row_to_filter: list[str] = []   # device row idx -> filter
        self._delta_trie = HostTrie()               # adds since last build
        self._delta_fids: dict[int, str] = {}       # fid in delta -> filter
        self._delta_count = 0                       # adds + deletes since build

    # ---- route table mutation (emqx_router:do_add_route/do_delete_route) ----
    def add_route(self, topic_filter: str) -> bool:
        """Install a route; returns True if new. Idempotent."""
        if not T.wildcard(topic_filter):
            if topic_filter in self.exact:
                return False
            self.exact.add(topic_filter)
            if self.on_route_change:
                self.on_route_change(topic_filter, True)
            return True
        if topic_filter in self.wildcards:
            return False
        words = self.intern.encode_filter(T.tokens(topic_filter))
        fid = self._next_fid
        self._next_fid += 1
        self.wildcards[topic_filter] = fid
        self._fid_words[fid] = words
        self._fid_filter[fid] = topic_filter
        self.host_trie.insert(words, fid)
        self._delta_trie.insert(words, fid)
        self._delta_fids[fid] = topic_filter
        self._delta_count += 1
        if self.on_route_change:
            self.on_route_change(topic_filter, True)
        return True

    def delete_route(self, topic_filter: str) -> bool:
        if not T.wildcard(topic_filter):
            if topic_filter not in self.exact:
                return False
            self.exact.discard(topic_filter)
            if self.on_route_change:
                self.on_route_change(topic_filter, False)
            return True
        fid = self.wildcards.pop(topic_filter, None)
        if fid is None:
            return False
        words = self._fid_words.pop(fid)
        self._fid_filter.pop(fid, None)
        self.host_trie.delete(words)
        if fid in self._delta_fids:
            self._delta_trie.delete(words)
            del self._delta_fids[fid]
        self._delta_count += 1
        if self.on_route_change:
            self.on_route_change(topic_filter, False)
        return True

    def has_route(self, topic_filter: str) -> bool:
        return topic_filter in self.exact or topic_filter in self.wildcards

    def topics(self) -> list[str]:
        """Parity: emqx_router:topics/0."""
        return sorted(self.exact) + sorted(self.wildcards)

    def route_count(self) -> int:
        return len(self.exact) + len(self.wildcards)

    # ---- matching ----
    def match(self, topic: str) -> list[str]:
        """All routed filters matching one publish topic
        (emqx_router:match_routes/1). Host path — always authoritative."""
        words = T.tokens(topic)
        out = [topic] if topic in self.exact else []
        ids = self.intern.encode_topic(words)
        dollar = words[0].startswith("$") if words else False
        for fid in self.host_trie.match(ids, dollar):
            f = self._fid_filter.get(fid)
            if f is not None:
                out.append(f)
        return out

    def match_batch(self, topics: list[str]) -> list[list[str]]:
        """Match a micro-batch; device-accelerated when profitable."""
        if (not self.use_device or len(topics) < self.device_min_batch
                or not self.wildcards):
            return [self.match(t) for t in topics]
        self._maybe_rebuild()
        if self._tables is None:
            return [self.match(t) for t in topics]
        return self._match_batch_device(topics)

    def _maybe_rebuild(self, force: bool = False) -> None:
        if self._tables is not None and not force and \
                self._delta_count < self.rebuild_threshold:
            return
        self.rebuild()

    def rebuild(self) -> None:
        """Compile the current wildcard set into fresh device tables."""
        n = len(self.wildcards)
        if n == 0:
            self._tables = None
            self._built_row_to_filter = []
        else:
            filters = list(self.wildcards.items())  # (filter, fid)
            L = max(self.max_levels,
                    max(len(self._fid_words[fid]) for _, fid in filters))
            rows = np.zeros((n, L), np.int32)
            lens = np.zeros(n, np.int64)
            for i, (_f, fid) in enumerate(filters):
                w = self._fid_words[fid]
                rows[i, :len(w)] = w
                lens[i] = len(w)
            node_cap = max(256, 2 * (int(lens.sum()) + 1))
            self._tables = trie_from_numpy(
                build_tables(rows, lens, node_capacity=node_cap,
                             slot_capacity=max(256, 4 * node_cap)),
                self.device)
            self._built_row_to_filter = [f for f, _fid in filters]
        self._delta_trie = HostTrie()
        self._delta_fids = {}
        self._delta_count = 0

    def _match_batch_device(self, topics: list[str]) -> list[list[str]]:
        from emqx_tpu_torch.ops.match import encode_topics, match_batch
        words_list = [T.tokens(t) for t in topics]
        # topics deeper than the built level budget fall back host-side
        deep = {i for i, w in enumerate(words_list) if len(w) > self.max_levels}
        enc, lens, dollar, _ = encode_topics(
            self.intern,
            [w[:self.max_levels] for w in words_list], self.max_levels)
        mr = match_batch(self._tables,
                         *(torch.from_numpy(a).to(self.device)
                           for a in (enc, lens, dollar)),
                         frontier_cap=self.frontier_cap,
                         match_cap=self.match_cap)
        matches = mr.matches.cpu().numpy()
        counts = mr.counts.cpu().numpy()
        overflow = mr.overflow.cpu().numpy()
        out: list[list[str]] = []
        for i, t in enumerate(topics):
            if i in deep or overflow[i]:
                out.append(self.match(t))
                continue
            res = [t] if t in self.exact else []
            seen = set()
            for fid in matches[i][:counts[i]]:
                if fid < 0:
                    continue
                f = self._built_row_to_filter[fid]
                # deletion since build → filter no longer active
                if f in self.wildcards and f not in seen:
                    seen.add(f)
                    res.append(f)
            ids = self.intern.encode_topic(words_list[i])
            dol = words_list[i][0].startswith("$") if words_list[i] else False
            for fid in self._delta_trie.match(ids, dol):
                f = self._delta_fids.get(fid)
                if f is not None and f not in seen:
                    seen.add(f)
                    res.append(f)
            out.append(res)
        return out

    def stats(self) -> dict:
        return {"routes": self.route_count(),
                "wildcard_routes": len(self.wildcards),
                "exact_routes": len(self.exact),
                "delta_since_build": self._delta_count,
                "built_filters": len(self._built_row_to_filter)}
