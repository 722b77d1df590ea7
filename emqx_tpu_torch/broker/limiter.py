"""Token-bucket rate limiting + force-shutdown overload policy.

Parity: apps/emqx/src/emqx_limiter.erl (conn/pub rate + quota buckets via
esockd_limiter, emqx_limiter.erl:62-87) and the force_shutdown policy
checked on the connection loop (emqx_connection.erl check_oom :463,
emqx_gc/emqx_oom). A depleted bucket answers with the pause needed until
refill — the `{active,N}`-off backpressure analog: the connection task
sleeps instead of reading more from the socket.
"""

from __future__ import annotations

import time
from typing import Optional


class TokenBucket:
    """rate tokens/sec, burst capacity.

    Two consumption modes:
    - `take(n)` always charges (balance may go negative — debt) and
      returns the pause (s) needed to repay it. Right for ingress
      batches whose size exceeds the capacity: the work already
      happened, so it must be charged or the limit is systematically
      exceeded.
    - `try_take(n)` charges only when affordable and returns bool.
      Right for quota checks where denied work is not performed.
    """

    def __init__(self, rate: float, burst: Optional[float] = None):
        self.rate = float(rate)
        self.capacity = float(burst if burst is not None else rate)
        self.tokens = self.capacity
        self._t = time.monotonic()

    def _refill(self, now: float) -> None:
        self.tokens = min(self.capacity,
                          self.tokens + (now - self._t) * self.rate)
        self._t = now

    def take(self, n: float = 1.0, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        self._refill(now)
        self.tokens -= n
        if self.tokens >= 0:
            return 0.0
        return -self.tokens / self.rate

    def try_take(self, n: float = 1.0,
                 now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def debt(self, now: Optional[float] = None) -> float:
        """Outstanding debt in tokens (0 when the balance is positive):
        how far `take()` has charged past capacity, refill applied.
        The overload governor ranks connections by this for
        the top-offender disconnect (force_shutdown parity) — the
        connection with the deepest unrepaid ingress debt is the one
        whose flood the limiter is already fighting."""
        now = time.monotonic() if now is None else now
        self._refill(now)
        return max(0.0, -self.tokens)

    # kept for compatibility with try_take semantics
    def consume(self, n: float = 1.0,
                now: Optional[float] = None) -> float:
        """try_take as a pause: 0.0 if granted, else seconds until n
        tokens accumulate (tokens NOT taken on failure)."""
        now = time.monotonic() if now is None else now
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate


class ConnectionLimiter:
    """Per-connection ingress limits: packets/sec and bytes/sec.

    Config (zone `rate_limit`): conn_messages_in "100/s"-style pairs in
    the reference schema; here plain numbers {msgs_rate, bytes_rate}.
    """

    def __init__(self, msgs_rate: Optional[float] = None,
                 bytes_rate: Optional[float] = None):
        self.msgs = TokenBucket(msgs_rate) if msgs_rate else None
        self.bytes = TokenBucket(bytes_rate) if bytes_rate else None

    def check(self, n_msgs: int, n_bytes: int) -> float:
        """Charge the already-done work; returns pause seconds (0 =
        proceed). Debt carries over so oversized batches still average
        out to the configured rate."""
        pause = 0.0
        if self.msgs is not None and n_msgs:
            pause = max(pause, self.msgs.take(n_msgs))
        if self.bytes is not None and n_bytes:
            pause = max(pause, self.bytes.take(n_bytes))
        return pause

    def debt(self) -> float:
        """Deepest per-bucket debt in seconds-to-repay units (tokens /
        rate) so msgs- and bytes-bucket debts compare on one scale.
        0.0 when no bucket is configured or none is in debt."""
        worst = 0.0
        for bucket in (self.msgs, self.bytes):
            if bucket is not None and bucket.rate > 0:
                worst = max(worst, bucket.debt() / bucket.rate)
        return worst


class QuotaLimiter:
    """Publish-quota buckets (conn_messages_routing in the reference):
    overall messages a client may publish per time unit."""

    def __init__(self, rate: Optional[float] = None,
                 burst: Optional[float] = None):
        self.bucket = TokenBucket(rate, burst) if rate else None

    def check_publish(self) -> bool:
        if self.bucket is None:
            return True
        return self.bucket.try_take(1.0)


class ForceShutdownPolicy:
    """Kill a connection whose session buffers blow past limits
    (force_shutdown zone config: max_mqueue_len / max_heap_size analog)."""

    def __init__(self, max_mqueue_len: int = 0, max_awaiting_rel: int = 0):
        self.max_mqueue_len = max_mqueue_len
        self.max_awaiting_rel = max_awaiting_rel

    def violated(self, session) -> Optional[str]:
        if session is None:
            return None
        if self.max_mqueue_len and len(session.mqueue) > self.max_mqueue_len:
            return "mqueue_overflow"
        if (self.max_awaiting_rel
                and len(session.awaiting_rel) > self.max_awaiting_rel):
            return "awaiting_rel_overflow"
        return None
