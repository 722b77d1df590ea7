"""In-flight (unacked outbound QoS1/2) send window.

Parity: emqx_inflight.erl — gb_trees send window keyed by packet id, with
a max size gating dequeue from the mqueue. Python dicts preserve insertion
order, giving the same oldest-first retry iteration the gb_tree provides.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Iterator, Optional


@dataclass
class InflightEntry:
    value: Any            # (phase, Message) — 'publish' awaiting PUBACK/PUBREC,
                          # 'pubrel' awaiting PUBCOMP
    ts: float             # last (re)send time, for retry


class Inflight:
    def __init__(self, max_size: int = 32):
        self.max_size = max_size          # 0 = unlimited
        self._d: dict[int, InflightEntry] = {}

    def __len__(self) -> int:
        return len(self._d)

    def is_full(self) -> bool:
        return self.max_size != 0 and len(self._d) >= self.max_size

    def is_empty(self) -> bool:
        return not self._d

    def contain(self, pid: int) -> bool:
        return pid in self._d

    def insert(self, pid: int, value: Any) -> None:
        if pid in self._d:
            raise KeyError(f"packet id {pid} already inflight")
        self._d[pid] = InflightEntry(value, time.monotonic())

    def update(self, pid: int, value: Any) -> None:
        self._d[pid] = InflightEntry(value, time.monotonic())

    def lookup(self, pid: int) -> Optional[Any]:
        e = self._d.get(pid)
        return e.value if e else None

    def delete(self, pid: int) -> Optional[Any]:
        e = self._d.pop(pid, None)
        return e.value if e else None

    def items(self) -> Iterator[tuple[int, InflightEntry]]:
        """Oldest-first (insertion order)."""
        return iter(list(self._d.items()))

    def clear(self) -> None:
        self._d.clear()
