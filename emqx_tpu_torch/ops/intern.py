"""Topic-level interning: level strings → dense int32 ids.

A copy of ``InternTable`` of ``emqx_tpu/ops/intern.py`` with its native
mirror: the word -> id map replicated into the port's host library
(``emqx_tpu_torch/native.py``) so that a batch of publish topics encodes in
one native call (``ops/match.encode_topics_str``). Reserved ids:

  PAD (0)      padding beyond a topic's level count
  PLUS (1)     the '+' wildcard word
  HASH (2)     the '#' wildcard word
  UNKNOWN (3)  a publish-topic word that appears in no filter — it can never
               match a concrete filter level, but still matches '+'/'#'

Dynamic ids start at FIRST_DYNAMIC and are assigned on first sight of a word
in a *filter* (publish topics use lookup(), which never allocates).
"""

from __future__ import annotations

import threading

PAD = 0
PLUS = 1
HASH = 2
UNKNOWN = 3
FIRST_DYNAMIC = 4


class InternTable:
    """Host-side word ↔ id map. Route mutations are serialized by the
    router's single-writer update task (the reference serializes them the
    same way via pooled workers, emqx_broker.erl:427-428), but background
    rebuild threads intern() concurrently with the publish-encode path's
    lazy mirror attach, so the mirror state itself is lock-guarded."""

    def __init__(self):
        self._to_id: dict[str, int] = {"+": PLUS, "#": HASH}
        self._to_word: list = [None, "+", "#", None]  # PAD/UNKNOWN unmapped
        # native mirror: word→id replicated into
        # the C library (hash-probed, word bytes confirmed by memcmp —
        # correctness never touches hash uniqueness) so publish batches
        # encode in one native call. None = not yet attached; False =
        # permanently retired (library absent, handles exhausted, or an
        # allocation failure). NOTE: bool is an int subclass, so handle
        # tests must be `type(m) is int`, never isinstance — the retired
        # sentinel False would otherwise coerce to native handle 0, which
        # is some OTHER table's live mirror.
        self._mirror: "int | None | bool" = None
        self._lock = threading.Lock()         # guards _to_id/_to_word tail
        self._attach_lock = threading.Lock()  # serializes attachers
        self._retired: list[int] = []         # parked handles (see below)

    def __len__(self) -> int:
        return len(self._to_word)

    def __del__(self):   # release the C-side handles with the table
        m = getattr(self, "_mirror", None)
        handles = list(getattr(self, "_retired", ()))
        if type(m) is int:
            handles.append(m)
        for h in handles:
            try:
                from emqx_tpu_torch import native
                native.intern_mirror_free(h)
            except Exception:   # noqa: BLE001 — interpreter teardown
                pass

    def _retire_mirror(self, h: int) -> None:
        """DEFERRED free: a concurrent encoder may still hold `h` from
        mirror_handle() inside a native encode call — freeing now would
        be a C-side use-after-free. The handle is parked and released
        with the table (retirement is an allocation-failure path, so the
        parked set stays tiny)."""
        self._retired.append(h)
        # every caller holds self._lock around this call (the three
        # call sites)
        self._mirror = False

    def _attach_mirror(self) -> "int | bool":
        """Build the C mirror without stalling concurrent intern()s: copy
        the id-dense word list in lock-free tail chunks, re-snapshotting
        until a pass finds nothing new, then publish the handle under the
        same lock intern() allocates under — a word interned after the
        final snapshot either lands in a later tail pass or sees the
        published handle and adds itself. No word can be lost."""
        from emqx_tpu_torch import native
        with self._attach_lock:
            if self._mirror is not None:      # another attacher won
                return self._mirror
            h = native.intern_mirror_new()
            if h is None:
                with self._lock:
                    self._mirror = False
                return False
            done = FIRST_DYNAMIC
            # seed the reserved words (stable ids, never mutated)
            for word, wid in (("+", PLUS), ("#", HASH)):
                if not native.intern_mirror_add(h, word, wid):
                    with self._lock:
                        self._retire_mirror(h)
                    return False
            while True:
                with self._lock:
                    tail = self._to_word[done:]
                    if not tail:
                        self._mirror = h      # publish: gap-free handoff
                        return h
                base, done = done, done + len(tail)
                for off, word in enumerate(tail):
                    if word is None:
                        continue
                    if not native.intern_mirror_add(h, word, base + off):
                        with self._lock:
                            self._retire_mirror(h)
                        return False

    def mirror_handle(self) -> "int | bool":
        """The native mirror handle (attached lazily), or False."""
        m = self._mirror
        if m is None:
            return self._attach_mirror()
        return m

    def intern(self, word: str) -> int:
        """Get-or-assign an id for a filter word."""
        wid = self._to_id.get(word)
        if wid is not None:
            return wid
        from emqx_tpu_torch import native
        with self._lock:
            wid = self._to_id.get(word)
            if wid is not None:
                return wid
            wid = len(self._to_word)
            self._to_id[word] = wid
            self._to_word.append(word)
            m = self._mirror
            if type(m) is int and \
                    not native.intern_mirror_add(m, word, wid):
                self._retire_mirror(m)
        return wid

    def lookup(self, word: str) -> int:
        """Id for a publish-topic word; UNKNOWN if never seen in a filter."""
        return self._to_id.get(word, UNKNOWN)

    def word(self, wid: int) -> str:
        w = self._to_word[wid]
        if w is None:
            raise KeyError(f"id {wid} has no word")
        return w

    def encode_filter(self, words: list[str]) -> list[int]:
        return [self.intern(w) for w in words]

    def encode_topic(self, words: list[str]) -> list[int]:
        return [self.lookup(w) for w in words]
