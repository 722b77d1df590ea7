"""Broker metrics: named lock-free counters + periodic stats gauges.

Parity: emqx_metrics.erl (counters array behind persistent_term,
packets.* / messages.* / bytes.* / delivery.* names, :241-258) and
emqx_stats.erl (periodic gauge table fed by stats_funs).

Python ints under the GIL give the same practical property the reference
gets from `counters:add` — wait-free increments on the hot path.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

# canonical metric names (emqx_metrics.erl defines ~90; same families here)
BYTES_METRICS = ["bytes.received", "bytes.sent"]
PACKET_METRICS = [
    "packets.received", "packets.sent",
    "packets.connect.received", "packets.connack.sent",
    "packets.connack.error", "packets.connack.auth_error",
    "packets.publish.received", "packets.publish.sent",
    "packets.publish.error", "packets.publish.auth_error",
    "packets.publish.dropped",
    "packets.puback.received", "packets.puback.sent",
    "packets.puback.missed",
    "packets.pubrec.received", "packets.pubrec.sent",
    "packets.pubrec.missed",
    "packets.pubrel.received", "packets.pubrel.sent",
    "packets.pubrel.missed",
    "packets.pubcomp.received", "packets.pubcomp.sent",
    "packets.pubcomp.missed",
    "packets.subscribe.received", "packets.suback.sent",
    "packets.subscribe.error", "packets.subscribe.auth_error",
    "packets.unsubscribe.received", "packets.unsuback.sent",
    "packets.unsubscribe.error",
    "packets.pingreq.received", "packets.pingresp.sent",
    "packets.disconnect.received", "packets.disconnect.sent",
    "packets.auth.received", "packets.auth.sent",
]
MESSAGE_METRICS = [
    "messages.received", "messages.sent",
    "messages.qos0.received", "messages.qos0.sent",
    "messages.qos1.received", "messages.qos1.sent",
    "messages.qos2.received", "messages.qos2.sent",
    "messages.publish", "messages.dropped",
    "messages.dropped.await_pubrel_timeout",
    "messages.dropped.no_subscribers",
    "messages.forward", "messages.delayed", "messages.delivered",
    "messages.acked", "messages.retained",
]
DELIVERY_METRICS = [
    "delivery.dropped", "delivery.dropped.no_local",
    "delivery.dropped.too_large", "delivery.dropped.qos0_msg",
    "delivery.dropped.queue_full", "delivery.dropped.expired",
]
CLIENT_METRICS = [
    "client.connect", "client.connack", "client.connected",
    "client.authenticate", "client.auth.anonymous", "client.authorize",
    "client.subscribe", "client.unsubscribe", "client.disconnected",
]
SESSION_METRICS = [
    "session.created", "session.resumed", "session.takenover",
    "session.discarded", "session.terminated",
]
AUTHZ_METRICS = ["authorization.allow", "authorization.deny",
                 "authorization.cache_hit"]
ALL_METRICS = (BYTES_METRICS + PACKET_METRICS + MESSAGE_METRICS +
               DELIVERY_METRICS + CLIENT_METRICS + SESSION_METRICS +
               AUTHZ_METRICS)


class Histogram:
    """Fixed log2-bucket histogram with wait-free increments.

    Bucket bounds are `lo * 2**(i/substeps)` for i in [0, n_buckets); an
    observation lands in the first bucket whose bound is >= the value
    (values <= lo — including 0 — land in bucket 0; values beyond the
    last bound land in the overflow bucket, visible only as the +Inf
    series). Increments are a frexp + two int adds under the GIL — the
    same practical wait-free property as the plain counters
    (emqx_metrics' counters:add analog; the bucket layout mirrors
    prometheus.erl's default log-scale histogram support).

    ``substeps`` is the sub-millisecond fine mode:
    the default 1 keeps the classic one-bucket-per-octave ladder, while
    substeps=4 interleaves quarter-octave bounds (step 2^(1/4) ≈ 1.19x)
    so a µs-floored ladder can resolve a 2ms SLO objective — the plain
    ladder's neighbouring bounds sit at 1.024ms and 2.048ms, a factor-2
    ambiguity exactly where the north-star criterion lives. Percentiles
    then over-estimate by at most one sub-step instead of one octave.
    """

    __slots__ = ("name", "unit", "lo", "substeps", "bounds", "counts",
                 "sum", "count")

    def __init__(self, name: str, *, lo: float = 1e-6,
                 n_buckets: int = 28, unit: str = "seconds",
                 substeps: int = 1):
        self.name = name
        self.unit = unit
        self.lo = lo
        self.substeps = max(1, int(substeps))
        if self.substeps == 1:
            self.bounds = [lo * (1 << i) for i in range(n_buckets)]
        else:
            self.bounds = [lo * 2 ** (i / self.substeps)
                           for i in range(n_buckets)]
        self.counts = [0] * (n_buckets + 1)    # [-1] is overflow (+Inf)
        self.sum = 0.0
        self.count = 0

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        if self.substeps == 1:
            m, e = math.frexp(v / self.lo)  # v/lo = m * 2^e, m in [0.5,1)
            i = e - 1 if m == 0.5 else e    # smallest i with v <= lo*2^i
            return min(i, len(self.bounds))  # beyond last bound: overflow
        # fine mode: log2 gives the neighbourhood, a bounded forward
        # probe settles exact-bound float edges (never more than a
        # couple of steps — the exactness of frexp without trusting
        # log2 rounding at bucket boundaries)
        i = max(0, int(self.substeps * math.log2(v / self.lo)) - 1)
        b = self.bounds
        n = len(b)
        if i > n:                           # far beyond the last bound
            return n
        while i < n and b[i] < v:
            i += 1
        return i                            # i == n -> overflow

    def observe(self, v: float) -> None:
        self.counts[self._index(v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> list[tuple[float, int]]:
        """Prometheus-shaped (le, cumulative_count) pairs; the final
        entry is (+Inf, total count)."""
        out = []
        acc = 0
        for b, c in zip(self.bounds, self.counts):
            acc += c
            out.append((b, acc))
        out.append((math.inf, acc + self.counts[-1]))
        return out

    def percentile(self, p: float) -> float:
        """Upper bucket bound at quantile p (0..1) — an over-estimate by
        at most one bucket step (one octave at substeps=1, one
        quarter-octave ≈ 1.19x in the substeps=4 fine mode). Overflow
        observations clamp to twice the last finite bound (keeps
        snapshots JSON-finite)."""
        if self.count == 0:
            return 0.0
        want = p * self.count
        acc = 0
        for b, c in zip(self.bounds, self.counts):
            acc += c
            if acc >= want:
                return b
        return 2 * self.bounds[-1]

    def snapshot(self) -> dict:
        n = self.count
        return {
            "count": n,
            "sum": round(self.sum, 6),
            "mean": round(self.sum / n, 9) if n else 0.0,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class Metrics:
    def __init__(self):
        self._c: dict[str, int] = {name: 0 for name in ALL_METRICS}
        self._h: dict[str, Histogram] = {}

    def hist(self, name: str, **kw) -> Histogram:
        """Get-or-create a named histogram (exported by every exporter
        alongside the counters)."""
        h = self._h.get(name)
        if h is None:
            h = self._h[name] = Histogram(name, **kw)
        return h

    def histograms(self) -> dict[str, Histogram]:
        return dict(self._h)

    def inc(self, name: str, n: int = 1) -> None:
        try:
            self._c[name] += n
        except KeyError:
            self._c[name] = n

    def val(self, name: str) -> int:
        return self._c.get(name, 0)

    def all(self) -> dict[str, int]:
        return dict(self._c)

    # packet-type helpers (emqx_metrics:inc_recv/inc_sent)
    def inc_recv(self, type_name: str, nbytes: int = 0) -> None:
        self.inc("packets.received")
        self.inc(f"packets.{type_name.lower()}.received")
        if nbytes:
            self.inc("bytes.received", nbytes)

    def inc_sent(self, type_name: str, nbytes: int = 0) -> None:
        self.inc("packets.sent")
        self.inc(f"packets.{type_name.lower()}.sent")
        if nbytes:
            self.inc("bytes.sent", nbytes)

    def inc_msg_recv(self, qos: int) -> None:
        self.inc("messages.received")
        self.inc(f"messages.qos{min(qos,2)}.received")

    def inc_msg_sent(self, qos: int) -> None:
        self.inc("messages.sent")
        self.inc(f"messages.qos{min(qos,2)}.sent")


class Stats:
    """Gauge table + registered stats functions sampled periodically
    (emqx_stats.erl; emqx_broker:stats_fun/0 emqx_broker.erl:403-412)."""

    GAUGES = [
        "connections.count", "connections.max",
        "live_connections.count", "live_connections.max",
        "sessions.count", "sessions.max",
        "topics.count", "topics.max",
        "subscribers.count", "subscribers.max",
        "subscriptions.count", "subscriptions.max",
        "subscriptions.shared.count", "subscriptions.shared.max",
        "retained.count", "retained.max",
        "delayed.count", "delayed.max",
    ]

    def __init__(self):
        self._g: dict[str, int] = {n: 0 for n in self.GAUGES}
        self._funs: list[Callable[["Stats"], None]] = []

    def setstat(self, name: str, val: int, max_name: Optional[str] = None) -> None:
        self._g[name] = val
        if max_name:
            self._g[max_name] = max(self._g.get(max_name, 0), val)

    def getstat(self, name: str) -> int:
        return self._g.get(name, 0)

    def register_stats_fun(self, fn: Callable[["Stats"], None]) -> None:
        self._funs.append(fn)

    def sample(self) -> dict[str, int]:
        for fn in list(self._funs):
            fn(self)
        return dict(self._g)
