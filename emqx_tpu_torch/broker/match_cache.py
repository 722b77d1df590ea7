"""Snapshot-keyed host-side LRU of device match rows.

The port's copy of ``emqx_tpu/broker/match_cache.py`` (jax-free there
too): ``MatchCache`` with ``attach``, ``get_many``, ``count_lookups``,
``bump_delta_version``, ``drop_where``, ``put_many`` and ``stats``, and
``DEFAULT_CAPACITY``. LRU order, snapshot-id keying and the version-guarded
inserts are the reference's, line for line.

The wildcard match stage is a pure function of an immutable table
snapshot and the encoded topic: for one snapshot the same topic always
produces the same (matches row, count, overflow) triple. Publish traffic
is skewed to a small hot topic set, so paying the match once per
(snapshot, topic) instead of once per message removes most of the match
work from the route window. Keys are a 128-bit hash of the encoded level
words, the level count and the '$' flag
(``broker/device_engine._topic_keys``). Rows are numpy: matches [Mw]
int32, count, overflow, and under the delta overlay the overlay's triple
in delta-fid space plus the encoded topic (fields 3..8).

Rows populated from a CSR readback are hole-compacted (the valid filter
ids as a prefix, -1 beyond) where a dense readback keeps the shape-slot
holes; fan-out, shared expansion and consume see only the valid entries
in order, so both layouts route identically.

Consistency: mutations never edit the device tables in place (churn
marks filters dirty and serves them host-side against the pinned
snapshot), so ``attach()`` at snapshot swap is the only wholesale
invalidation. Under the delta overlay an overlay insert/delete drops
exactly the cached topics the changed filter matches (``drop_where``) and
bumps ``delta_version``, so a readback planned before the change cannot
insert rows that predate it (``put_many``).

Thread model: looked up on the event loop (prepare), populated from the
materialize executor threads, invalidated on the loop at swap — one plain
lock around the OrderedDict.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

DEFAULT_CAPACITY = 8192


class MatchCache:
    """LRU of per-(snapshot, topic) match rows with hit/miss accounting.

    `metrics` is a broker.metrics.Metrics (or None): hit/miss/evict/
    invalidation counters land there as `match_cache.*`, which is how the
    Prometheus/StatsD/$SYS/mgmt exporters and the telemetry snapshot see
    the cache with zero coupling to this module.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, metrics=None):
        self.capacity = max(1, int(capacity))
        self.metrics = metrics
        self._lock = threading.Lock()
        self._rows: OrderedDict = OrderedDict()   # key -> (m, c, o[, ...])
        self.snapshot_id: Optional[int] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        # delta-overlay coherence: bumped on every overlay
        # filter insert/delete. Rows under the overlay carry the delta
        # match triple + the encoded topic (fields 3..8); an overlay
        # change drops exactly the cached topics the changed filter
        # matches (drop_where) and invalidates in-flight readbacks that
        # predate it (the put-side version check) — the surgical
        # replacement for the pre-overlay wholesale flush.
        self.delta_version = 0
        self.delta_invalidated = 0
        # drop_where's columnar view of the stored topic encodings,
        # memoized on a content generation: row content only changes on
        # insert/evict/invalidate (LRU touches reorder, not mutate), so
        # consecutive overlay changes — the churn regime, several per
        # batch window — reuse one stack instead of re-copying the
        # whole cache per subscription change
        self._content_gen = 0
        self._stack = None      # (gen, keys, encs, lens, dollars)

    def _inc(self, name: str, n: int) -> None:
        if self.metrics is not None and n:
            self.metrics.inc(f"match_cache.{name}", n)

    def attach(self, snapshot_id: Optional[int]) -> None:
        """Bind the cache to a new snapshot, dropping every row of the
        previous one (wholesale invalidation at swap — see the module
        docstring for why this is the only invalidation point)."""
        with self._lock:
            if self._rows:
                self.invalidations += 1
                self._inc("invalidations", 1)
                self._inc("invalidated_rows", len(self._rows))
                self._rows.clear()
                self._content_gen += 1
                self._stack = None
            self.snapshot_id = snapshot_id

    def get_many(self, snapshot_id, keys: list) -> list:
        """Row per key (None = miss), LRU-touching hits. A snapshot-id
        mismatch (reader raced a swap) misses everything. Does NOT count
        hit/miss accounting — lookups also run for windows that end up
        dispatching the plain program, and counting those would inflate
        the exported hit rate with reuse that never fed a dispatch; the
        planner calls count_lookups() only for engaged plans."""
        with self._lock:
            if snapshot_id != self.snapshot_id:
                return [None] * len(keys)
            rows = self._rows
            out = []
            for k in keys:
                row = rows.get(k)
                if row is not None:
                    rows.move_to_end(k)
                out.append(row)
            return out

    def count_lookups(self, hits: int, misses: int) -> None:
        """Account one ENGAGED window's lookup outcome (see get_many)."""
        with self._lock:
            self.hits += hits
            self.misses += misses
        self._inc("hits", hits)
        self._inc("misses", misses)

    def bump_delta_version(self) -> None:
        """An overlay filter was inserted/deleted: in-flight readbacks
        computed before this moment describe a stale overlay — put_many
        batches pinned to an older version are dropped whole."""
        with self._lock:
            self.delta_version += 1

    def drop_where(self, snapshot_id, pred) -> int:
        """Drop every cached row whose TOPIC satisfies `pred(encs
        [N, L], lens [N], dollars [N]) -> bool [N]` — the delta-aware
        invalidation: an overlay insert/delete calls this with the
        changed filter's host-mirror matcher (ops/delta.np_filter_match,
        vectorized over ALL cached topics in one call — a per-row
        Python predicate measured ~50x slower at 8k rows), so only the
        topics whose delta match set actually changed pay, instead of
        the wholesale flush. Rows without a stored topic encoding
        (pre-overlay 3-tuples) are conservatively dropped too. Returns
        the count."""
        import numpy as np
        dropped = []
        with self._lock:
            if snapshot_id != self.snapshot_id:
                return 0
            st = self._stack
            if st is None or st[0] != self._content_gen:
                keys, encs, lens, dols = [], [], [], []
                for k, row in self._rows.items():
                    if len(row) < 9:
                        dropped.append(k)
                    else:
                        keys.append(k)
                        encs.append(row[6])
                        lens.append(row[7])
                        dols.append(row[8])
                st = (self._content_gen, keys,
                      np.stack(encs) if keys else None,
                      np.asarray(lens), np.asarray(dols, bool))
                self._stack = st
            _gen, keys, encs, lens, dols = st
            if keys:
                mask = pred(encs, lens, dols)
                dropped.extend(k for k, m in zip(keys, mask) if m)
            for k in dropped:
                self._rows.pop(k, None)
            if dropped:
                self._content_gen += 1
                self._stack = None
            self.delta_invalidated += len(dropped)
        self._inc("delta_invalidated", len(dropped))
        return len(dropped)

    def put_many(self, snapshot_id, items: list, version=None) -> None:
        """Insert (key, row) pairs read back from a finished dispatch.
        Dropped whole when the snapshot moved on while the batch was in
        flight — those rows describe tables that no longer serve — or,
        under the delta overlay, when `version` (the delta version at
        the batch's plan time) is stale: the rows predate an overlay
        filter change and their delta triples may be wrong."""
        n_evict = 0
        with self._lock:
            if snapshot_id != self.snapshot_id:
                return
            if version is not None and version != self.delta_version:
                return
            rows = self._rows
            for k, row in items:
                rows[k] = row
                rows.move_to_end(k)
            while len(rows) > self.capacity:
                rows.popitem(last=False)
                n_evict += 1
            if items:
                self._content_gen += 1      # drop_where stack is stale
                self._stack = None
            # instance counters stay lock-guarded (two materialize
            # threads may finish concurrently); the Metrics incs below
            # follow the registry's own repo-wide threading model
            self.evictions += n_evict
        self._inc("inserts", len(items))
        self._inc("evictions", n_evict)

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def stats(self) -> dict:
        with self._lock:
            size = len(self._rows)
            hits, misses = self.hits, self.misses
        total = hits + misses
        return {
            "size": size,
            "capacity": self.capacity,
            "snapshot_id": self.snapshot_id,
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / total, 4) if total else 0.0,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "delta_version": self.delta_version,
            "delta_invalidated": self.delta_invalidated,
        }
