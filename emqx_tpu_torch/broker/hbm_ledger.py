"""HBM ledger: per-category accounting of persistent device allocations.

The port's copy of ``emqx_tpu/broker/hbm_ledger.py``. Every persistent
device allocation of the device engine routes through
``ledger.hold(category, tree, owner=...)`` — snapshot tables and cursors,
the subscription-covering CSR and its append versions, each delta-overlay
version, and the static buffers of every captured CUDA graph class
(``pipeline_buffers``, owner = the class label). ``hold`` walks the tree,
adds each tensor's storage bytes to the category's live gauge (and its
peak), attaches a ``weakref.finalize`` per tensor and returns the tree
unchanged: the bytes release when the tensors die, so a snapshot swap
that drops the old tables shows up as a release without any explicit
call, and the ledger can never wedge a swap.

Aliases count once: tensors are keyed by their storage (device and
``untyped_storage().data_ptr()``), not by identity — the views a CUDA
graph's outputs and the cover append regions are made of share one
storage. A storage releases when the last tensor held on it dies.

Pin sentinel: dispatch handles pin the snapshot they ran against (the
engine defers swaps while any handle is outstanding), so a leaked handle
blocks swaps and holds the old snapshot's memory. ``pin``/``unpin`` track
each in-flight handle against the window clock (``note_window``); a pin
older than ``broker.pin_warn_windows`` windows (default 64) fires once:
the ``pipeline.memory.pin_warnings`` counter and the
``pipeline.pin_stale`` hook.

``section()`` is the ``memory`` section of the telemetry snapshot:
per-category live bytes, peaks, holds, owners, the true global peak, pin
ages, and on a ``cuda`` device the card's own numbers
(``torch.cuda.memory_stats``) with ``accounted_fraction`` = the ledger's
live bytes on the card / ``torch.cuda.memory_allocated``. A fraction
above 1 would mean aliases counted twice; well below 1 under load means
allocations bypass the ledger. On the CPU there is no device section.
The reference's environment knobs are not ported: config only.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

SCHEMA = "emqx_tpu.memory/v1"

# the memory_stats keys the section carries (the allocator's totals)
_STAT_KEYS = ("allocated_bytes.all.current", "allocated_bytes.all.peak",
              "reserved_bytes.all.current", "reserved_bytes.all.peak",
              "active_bytes.all.current", "num_alloc_retries", "num_ooms")


def resolve_hbm_ledger(configured=None) -> bool:
    """``broker.hbm_ledger``, default on; off builds no ledger."""
    return True if configured is None else bool(configured)


def resolve_pin_warn_windows(configured=None) -> int:
    """``broker.pin_warn_windows``, default 64 (a healthy handle lives
    about pipeline-depth windows, i.e. single digits). Must be a positive
    integer — anything else is a deployment error worth failing loudly
    on."""
    if configured is None:
        return 64
    try:
        val = int(configured)
    except (TypeError, ValueError):
        raise ValueError(f"pin_warn_windows={configured!r} is not an "
                         f"integer")
    if val <= 0:
        raise ValueError(f"pin_warn_windows must be > 0, got {val}")
    return val


def device_memory_stats(device) -> Optional[dict]:
    """The allocator's totals on `device`: a dict on a ``cuda`` device
    (read from the card; an error raises), None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    ms = torch.cuda.memory_stats(dev)
    return {k: int(ms.get(k, 0)) for k in _STAT_KEYS}


def bytes_in_use(device) -> Optional[int]:
    """``torch.cuda.memory_allocated`` on a ``cuda`` device, None on the
    CPU: the accounted-fraction denominator."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.memory_allocated(dev))


def _leaves(tree):
    """The tensors of a tree of tuples/NamedTuples/lists/dicts."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)


def storage_key(t: torch.Tensor) -> tuple:
    """The identity a tensor's bytes are accounted under: its device and
    its storage's address (every view of one storage shares it)."""
    return (str(t.device), t.untyped_storage().data_ptr())


class _Cat:
    """One category's accounting row."""

    __slots__ = ("live_bytes", "peak_bytes", "holds", "releases",
                 "live_leaves", "owners")

    def __init__(self):
        self.live_bytes = 0
        self.peak_bytes = 0
        self.holds = 0
        self.releases = 0
        self.live_leaves = 0
        self.owners: dict[str, int] = {}


class _Entry:
    """One accounted storage: its category, bytes, owner, and the ids of
    the live tensors held on it."""

    __slots__ = ("category", "nbytes", "owner", "holders")

    def __init__(self, category, nbytes, owner):
        self.category = category
        self.nbytes = nbytes
        self.owner = owner
        self.holders: set[int] = set()


class HbmLedger:
    """Per-node device-memory ledger (see the module docstring).

    ``hold()`` runs on the loop and on executor threads (build, warm and
    capture threads), and the finalizers fire on whatever thread drops
    the last reference — all accounting is under one reentrant lock (a
    finalizer can run inside a locked region of the same thread)."""

    def __init__(self, metrics=None, *, device="cpu", pin_warn_windows=None,
                 hooks=None, recorder=None):
        self.metrics = metrics
        self.hooks = hooks
        # the flight recorder: a stale pin lands a `stale_pin` event on
        # the pinned window's trace
        self.recorder = recorder
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            # the tensors name their card by index ("cuda:0"): so does the
            # ledger, or its device's live bytes would match none of them
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.pin_warn_windows = resolve_pin_warn_windows(pin_warn_windows)
        self._lock = threading.RLock()
        self._cats: dict[str, _Cat] = {}
        # true global high-water mark of summed live bytes — NOT the sum
        # of per-category peaks (categories peak at different times)
        self._peak_bytes = 0
        self._live: dict[tuple, _Entry] = {}
        # pinned dispatch handles: key -> [start_window, weakref to the
        # handle or None, warned]
        self._pins: dict[int, list] = {}
        self._window_clock = 0
        self.pin_warnings = 0

    # ---- holds -----------------------------------------------------------
    def hold(self, category: str, tree, owner: Optional[str] = None):
        """Register the persistent device tensors of `tree` under
        `category` and return it unchanged. Every tensor gets a weakref
        finalizer, so the bytes release automatically when the storage's
        last held tensor dies — no explicit release call exists, by design
        (an unpaired release is exactly the leak this ledger hunts)."""
        total = 0
        new = 0
        with self._lock:
            cat = self._cats.setdefault(category, _Cat())
            for t in _leaves(tree):
                nb = t.untyped_storage().nbytes()
                if nb == 0:
                    continue
                key = storage_key(t)
                e = self._live.get(key)
                if e is not None and id(t) in e.holders:
                    continue        # this tensor is already held
                weakref.finalize(t, self._drop, key, id(t))
                if e is not None:
                    e.holders.add(id(t))    # an alias: no new bytes
                    continue
                e = self._live[key] = _Entry(category, nb, owner)
                e.holders.add(id(t))
                cat.live_bytes += nb
                cat.live_leaves += 1
                total += nb
                new += 1
                if owner is not None:
                    cat.owners[owner] = cat.owners.get(owner, 0) + nb
            cat.peak_bytes = max(cat.peak_bytes, cat.live_bytes)
            cat.holds += 1
            self._peak_bytes = max(
                self._peak_bytes,
                sum(c.live_bytes for c in self._cats.values()))
        # per storage, as the release count: holds - releases == live
        # storages (the category's `holds` counts hold() calls)
        if self.metrics is not None and new:
            self.metrics.inc("pipeline.memory.holds", new)
            self.metrics.inc("pipeline.memory.hold_bytes", total)
        return tree

    def _drop(self, key: tuple, tid: int) -> None:
        """Finalizer: one held tensor died; the storage's bytes return
        when its last held tensor has."""
        with self._lock:
            e = self._live.get(key)
            if e is None:
                return
            e.holders.discard(tid)
            if e.holders:
                return
            del self._live[key]
            cat = self._cats[e.category]
            cat.live_bytes -= e.nbytes
            cat.live_leaves -= 1
            cat.releases += 1
            if e.owner is not None:
                left = cat.owners.get(e.owner, 0) - e.nbytes
                if left > 0:
                    cat.owners[e.owner] = left
                else:
                    cat.owners.pop(e.owner, None)
        if self.metrics is not None:
            self.metrics.inc("pipeline.memory.releases")
            self.metrics.inc("pipeline.memory.release_bytes", e.nbytes)

    def live_bytes(self, category: Optional[str] = None) -> int:
        with self._lock:
            if category is not None:
                cat = self._cats.get(category)
                return cat.live_bytes if cat is not None else 0
            return sum(c.live_bytes for c in self._cats.values())

    def owner_bytes(self, category: str, owner: str) -> int:
        with self._lock:
            cat = self._cats.get(category)
            return cat.owners.get(owner, 0) if cat is not None else 0

    def live_leaves(self) -> int:
        """Live accounted storages — the leak probe the tests read."""
        with self._lock:
            return len(self._live)

    def holds_tensor(self, t: torch.Tensor) -> bool:
        """Whether `t`'s storage is accounted (the hygiene check)."""
        with self._lock:
            return storage_key(t) in self._live

    def device_live_bytes(self) -> int:
        """Live bytes of the storages on the ledger's device."""
        dev = str(self.device)
        with self._lock:
            return sum(e.nbytes for k, e in self._live.items()
                       if k[0] == dev)

    # ---- pin sentinel ------------------------------------------------------
    def note_window(self) -> None:
        """One prepared dispatch window: advance the pin clock and fire
        the stale-pin sentinel, once, for any handle pinned past the
        threshold."""
        self._window_clock += 1
        w = self._window_clock
        warn = self.pin_warn_windows
        for rec in list(self._pins.values()):
            if rec[2] or w - rec[0] <= warn:
                continue
            rec[2] = True
            self.pin_warnings += 1
            age = w - rec[0]
            handle = rec[1]() if rec[1] is not None else None
            trace = getattr(handle, "trace", 0) or 0
            if self.metrics is not None:
                self.metrics.inc("pipeline.memory.pin_warnings")
            if self.recorder is not None:
                self.recorder.event(
                    trace, "stale_pin", track="memory",
                    meta={"age_windows": age, "warn_windows": warn})
            if self.hooks is not None:
                self.hooks.run("pipeline.pin_stale",
                               ({"age_windows": age,
                                 "warn_windows": warn,
                                 "trace": trace},))

    def pin(self, key: int, handle=None) -> None:
        """A dispatch handle (keyed by its id) went in flight: it pins its
        snapshot. The ledger holds the handle by weakref only — a leaked
        one (the case the sentinel hunts) must stay collectable; the
        sentinel reads its window's trace id through it."""
        self._pins[key] = [self._window_clock,
                           weakref.ref(handle) if handle is not None
                           else None, False]

    def unpin(self, key: int) -> None:
        self._pins.pop(key, None)

    def pin_state(self) -> dict:
        w = self._window_clock
        ages = [w - rec[0] for rec in list(self._pins.values())]
        return {"outstanding": len(ages),
                "max_age_windows": max(ages) if ages else 0,
                "warn_windows": self.pin_warn_windows,
                "warnings": self.pin_warnings,
                "window_clock": w}

    # ---- export surfaces -------------------------------------------------
    def section(self) -> dict:
        """The `memory` section of `PipelineTelemetry.snapshot()`."""
        with self._lock:
            cats = {}
            for name in sorted(self._cats):
                c = self._cats[name]
                row = {"live_bytes": c.live_bytes,
                       "peak_bytes": c.peak_bytes,
                       "holds": c.holds, "releases": c.releases,
                       "live_leaves": c.live_leaves}
                if c.owners:
                    row["owners"] = dict(sorted(c.owners.items()))
                cats[name] = row
            live = sum(c.live_bytes for c in self._cats.values())
            peak = self._peak_bytes
        out = {"schema": SCHEMA, "live_bytes": live, "peak_bytes": peak,
               "categories": cats, "pins": self.pin_state()}
        dev = device_memory_stats(self.device)
        if dev is not None:
            out["device"] = dev
            in_use = bytes_in_use(self.device)
            if in_use:
                out["accounted_fraction"] = round(
                    self.device_live_bytes() / in_use, 4)
        return out

    def stats_fun(self, stats) -> None:
        """Point-in-time gauges for the Stats table."""
        with self._lock:
            live = sum(c.live_bytes for c in self._cats.values())
            peak = self._peak_bytes
        ps = self.pin_state()
        stats.setstat("pipeline.memory.live_bytes", live)
        stats.setstat("pipeline.memory.peak_bytes", peak)
        stats.setstat("pipeline.memory.pinned_handles", ps["outstanding"])
        stats.setstat("pipeline.memory.max_pin_age_windows",
                      ps["max_age_windows"])
