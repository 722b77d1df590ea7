"""Disk-backed replay queue.

A copy of ``emqx_tpu/utils/replayq.py`` (the port imports nothing from
``emqx_tpu``): the same segment files, so a queue written by either
package reads in the other. One departure: a pop that reaches the end of
the segment being written keeps its place in that segment, where the
reference's moves to the next one, so that an ack deleted the segment
with every item appended to it after the pop (the MQTT bridge appends
while it drains: those forwards were lost and the queue's count never
reached 0 again).

Parity: the replayq dep used by emqx_bridge_mqtt
(emqx_bridge_worker.erl:142-143,211-217) — messages appended to segment
files survive restarts; consumers pop batches and ack, which advances a
durable commit marker; unacked items are replayed after a crash. A `dir` of
None gives a pure in-memory queue (replayq's mem-only mode).

Layout: <dir>/<segno>.q files of length-prefixed items; <dir>/COMMIT holds
"segno offset" of the first unacked item.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

DEFAULT_SEG_BYTES = 10 << 20


def _scan(data: bytes, max_items: int = 65536) -> list[tuple[int, int]]:
    """(offset, length) of each complete length-prefixed item; a torn
    tail is left out (the reference's ``native.replayq_scan`` fallback)."""
    out = []
    i = 0
    while i + 4 <= len(data) and len(out) < max_items:
        n = int.from_bytes(data[i:i + 4], "big")
        if i + 4 + n > len(data):
            break
        out.append((i + 4, n))
        i += 4 + n
    return out


class ReplayQ:
    def __init__(self, dir: Optional[str] = None,
                 seg_bytes: int = DEFAULT_SEG_BYTES,
                 fsync: bool = True):
        self.dir = dir
        self.seg_bytes = seg_bytes
        self.fsync = fsync
        self._mem: list[bytes] = []
        # reader position: (segno, item offset within segment)
        self._rseg = 0
        self._roff = 0
        self._wseg = 0
        self._count = 0                     # live (unacked) items
        self._cache_seg: Optional[int] = None   # parsed-segment read cache
        self._cache_items: list[bytes] = []
        if dir is not None:
            os.makedirs(dir, exist_ok=True)
            self._recover()

    # ---- disk helpers ----
    def _seg_path(self, segno: int) -> str:
        return os.path.join(self.dir, f"{segno:010d}.q")

    def _commit_path(self) -> str:
        return os.path.join(self.dir, "COMMIT")

    def _recover(self) -> None:
        segs = sorted(int(f[:-2]) for f in os.listdir(self.dir)
                      if f.endswith(".q"))
        self._wseg = segs[-1] if segs else 0
        try:
            with open(self._commit_path()) as f:
                seg, off = f.read().split()
                self._rseg, self._roff = int(seg), int(off)
        except (FileNotFoundError, ValueError):
            self._rseg = segs[0] if segs else 0
            self._roff = 0
        # drop fully-acked segments
        for s in segs:
            if s < self._rseg:
                os.unlink(self._seg_path(s))
        self._count = self._scan_count()

    def _scan_count(self) -> int:
        total = 0
        seg, off = self._rseg, self._roff
        while seg <= self._wseg:
            total += max(0, len(self._read_seg(seg)) - off)
            seg += 1
            off = 0
        return total

    def _read_seg(self, segno: int) -> list[bytes]:
        try:
            with open(self._seg_path(segno), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return []
        # torn tail writes are discarded by the scan; loop so dense
        # segments beyond one scan's max_items are never truncated
        items: list[bytes] = []
        base = 0
        while base < len(data):
            spans = _scan(data[base:])
            if not spans:
                break
            items.extend(data[base + o:base + o + n] for o, n in spans)
            base += spans[-1][0] + spans[-1][1]
        return items

    # ---- queue api ----
    def append(self, item: bytes) -> None:
        self._count += 1
        if self.dir is None:
            self._mem.append(item)
            return
        if self._wseg < self._rseg:
            # a full drain advanced the reader past the old write segment;
            # never write behind the read pointer or items become invisible
            self._wseg = self._rseg
        path = self._seg_path(self._wseg)
        if (os.path.exists(path)
                and os.path.getsize(path) >= self.seg_bytes):
            self._wseg += 1
            path = self._seg_path(self._wseg)
        with open(path, "ab") as f:
            f.write(struct.pack(">I", len(item)) + item)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self._cache_seg = None   # invalidate read cache

    def pop(self, n: int = 1) -> tuple[list[bytes], Optional[tuple]]:
        """Return up to n items and an ack ref (None when empty)."""
        if self.dir is None:
            items = self._mem[:n]
            return items, ("mem", len(items)) if items else None
        items: list[bytes] = []
        seg, off = self._rseg, self._roff
        while len(items) < n and seg <= self._wseg:
            seg_items = self._seg_items_cached(seg)
            take = seg_items[off:off + (n - len(items))]
            items.extend(take)
            off += len(take)
            if off < len(seg_items) or seg == self._wseg:
                # the write segment keeps its reader offset: an item
                # appended between this pop and its ack lands after it
                break
            seg += 1
            off = 0
        if not items:
            return [], None
        return items, (seg, off, len(items))

    def _seg_items_cached(self, seg: int) -> list[bytes]:
        if self._cache_seg != seg:
            self._cache_items = self._read_seg(seg)
            self._cache_seg = seg
        return self._cache_items

    def ack(self, ref: tuple) -> None:
        if self.dir is None:
            acked = ref[1]
            self._mem = self._mem[acked:]
            self._count = len(self._mem)
            return
        seg, off, n_items = ref
        with open(self._commit_path(), "w") as f:
            f.write(f"{seg} {off}")
            f.flush()
            os.fsync(f.fileno())
        for s in range(self._rseg, seg):
            try:
                os.unlink(self._seg_path(s))
            except FileNotFoundError:
                pass
        self._rseg, self._roff = seg, off
        # decrement by the popped batch — a full rescan here would make
        # every ack O(backlog bytes)
        self._count = max(0, self._count - n_items)

    def count(self) -> int:
        return self._count if self.dir is not None else len(self._mem)

    def is_empty(self) -> bool:
        return self.count() == 0
