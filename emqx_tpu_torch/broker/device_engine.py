"""Device route engine: the route window wired into the serving path.

The port's ``DeviceRouteEngine`` (``emqx_tpu/broker/device_engine.py``
:561-3889) with the reference's default routing layers: in-window topic
dedup and the snapshot-keyed match cache (``_plan_window``,
``broker/match_cache.py``), and the device delta overlay
(``ops/delta.py``, ``_overlay_sync``), and subscription covering (the
snapshot's match tables hold the covering set only and the match stage
re-expands it, ``ops/cover.py``; a new filter a built root covers
becomes an append to the expansion CSR, ``_try_cover_append``), each
switchable as in the reference (``broker.topic_dedup``,
``broker.match_cache_size``, ``broker.delta_overlay``,
``broker.subscription_covering``); the node's pipeline telemetry
(``broker/telemetry.py``: stage spans, occupancy, dedup, readback bytes,
graph captures as its compile accounting), its HBM ledger
(``broker/hbm_ledger.py``: every persistent device allocation goes
through ``_hold``, every dispatch handle is pinned) and its delivery
lanes (``broker/deliver.py``: ``finish_sub`` builds a delivery plan that
the lanes run), and the columnar ingress's burst pre-encode
(``preencode_burst``: one native encode per read burst that
``prepare_window`` gathers from), and the flight recorder (``_rec_span``:
the dispatch, materialize and deliver spans of each window under its
trace id, the plans carrying their sub-batch's trace to the lanes; and
``start_device_trace`` / ``stop_device_trace`` on torch.profiler, each
dispatch inside ``record_function("route_step#<trace id>")``), and the
node's supervisor (``broker/supervise.py``: the ``dispatch``,
``materialize``, ``cache_insert``, ``overlay_apply`` and
``snapshot_swap`` fault domains with their injection points, the rung-1
plain dispatch, the off-path probes ``_probe_dispatch`` /
``_probe_materialize``). The CSR readback is on unless
``compact_readback`` is off (then every window reads its dense planes
back, the reference's A/B baseline). It
compiles the live routing state (Router filter universe + Broker
subscriber/shared-group membership) into device tables, runs the route
window over publish micro-batches and consumes the result into session
deliveries, replacing the per-message host publish path
(emqx_broker.erl:199-308: match_routes → dispatch fold → shared pick).

Serving is staged so the asyncio event loop never waits on the device:
``prepare_window()`` (loop: encode), ``dispatch()`` (the route window's
launches on the card — on the loop, since they only enqueue work and hold
the GIL throughout, where an executor thread would wait for the busy loop
at every GIL hand-off; on an executor thread when the device is the CPU),
``materialize()`` (executor thread: device→host readback),
``finish_sub()`` (loop: consume one sub-batch into deliveries, or into a
delivery plan for the lanes; the handle, and with it the snapshot, stays
pinned until the plan completes).
``route_batch()`` is the synchronous composition for callers without a
pipeline.

On the card: the shape-hash window is
``models/router_engine.route_window`` (kernels 1 and 2), the trie window
``route_step_compact`` (kernel 2); the choice of trie over shapes
follows the reference (more shapes than ``shape_cap``, or filters deeper
than 20 levels). Dispatches run on a CUDA stream of the engine's own and
the device cursors stay on the card between windows. Each shape-hash
window class — (W, Bp), with the dedup miss class Bm, the overlay row
class and the payload class as optional dimensions — is captured as a
CUDA graph by its warm dispatch (``_capture``), off the serving path and
only for the classes traffic asks for; a serving dispatch copies its
window into the graph's static inputs and replays it: one launch where
the eager window makes ~300. An overlay version is copied into a graph's
static overlay buffers on the engine stream, in order behind the
previous replay, so a window in flight keeps the version it was
dispatched with. A cover-set append writes its append region into the
snapshot's static cover buffers the same way, and keeps an immutable
copy per append version for the eager windows and for a recompute of a
window in flight. Every plane materialize will read is copied at dispatch
return into pinned host buffers (``non_blocking``) with an event
recorded behind it — materialize waits on that event only, so at the
batcher's ``dispatch_depth >= 2`` window W's readback crosses while
window W+1 dispatches.

On the card a failed dispatch, readback, warm-up, graph capture or
snapshot build is an error, never a quiet detour through the host trie:
the window's publishers get the exception, and a background failure is
kept (``failed``) and raised to every later batch. That covers the
cached and delta dispatches, overlay uploads and match-cache inserts
too. On the CPU the reference's behaviour stands: the window is routed
on the host and a failed warm leaves its class cold. Messages the window
flags overflow or too deep are completed on the host on both, as in the
reference. Under supervision the ladder contains on the card only the
faults ``supervise.contained`` names, those the injector caused
(injected faults, a stall while an injected hang sleeps, a corrupt
readback's consume): those replay on the host as in the reference. Any
other error, a real out of memory or stall included, keeps the
fail-fast, and one raised by the engine's own dispatch, readback or
probe, or a real stall, also sets ``failed``.

Snapshot/consistency model (as the reference):

- The compiled tables are an immutable snapshot; mutations keep flowing
  into the authoritative host dicts and are tracked relative to it:
  - a built filter whose subscriber membership changed is DIRTY — its
    deliveries come from the live host dict instead of the device rows;
  - a filter added since the build is a DELTA filter: with the overlay
    on it is a row of the device overlay, matched and delivered in the
    same window; filters the overlay cannot hold (class still cold, past
    the top row class, deeper than max_levels) and, with the overlay
    off, every delta filter match through the host delta ``HostTrie``
    (``routing.device.host_delta``) until the next rebuild;
  - a (filter, group) shared slot that changed is dirty likewise; a group
    added to a built filter is dispatched host-side until the next
    rebuild.
- The snapshot recompiles on a compaction trigger (``_compaction_reason``:
  with the overlay off, ``rebuild_threshold`` distinct stale entities;
  with it on, overlay overflow, the delete-tombstone ratio, or
  membership churn past the threshold) in the background,
  double-buffered: the state is captured in
  chunks on the loop, compiled, uploaded and warmed off the loop, and
  swapped in once no dispatched window is outstanding; mutations during
  the build are journaled and replayed against the new snapshot. With
  the overlay on, a compaction's capture is incremental: the previous
  capture with only the filters touched since, and every shared filter,
  re-read (``_capture_state_incremental``).

Delivery attribution: device fan-out rows for one message are the
concatenation of per-filter CSR segments in match order, so the host walks
the matched fids and slices the rows by the *built* segment lengths.
Messages flagged overflow/too-deep fall back to the full host path.
Shared subscriptions: device picks drive delivery for every strategy;
sticky rides the cursor as an affinity pointer seeded by the capture.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import itertools
import logging
import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from emqx_tpu_torch.broker.deliver import DEFERRED, OPT_TABLE, LaneCounts
from emqx_tpu_torch.broker.match_cache import DEFAULT_CAPACITY, MatchCache
from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.broker.supervise import contained, guard_task
from emqx_tpu_torch import device as D
from emqx_tpu_torch.convert import router_tables_from_numpy, tables_from_numpy
from emqx_tpu_torch.device import resolve_device
from emqx_tpu_torch.models import router_engine as RE
from emqx_tpu_torch.ops import cover as CV
from emqx_tpu_torch.ops import intern as I
from emqx_tpu_torch.ops.compact import csr_slices
from emqx_tpu_torch.ops.delta import (DeltaTables, build_delta_tables,
                                      empty_delta_tables, np_filter_match,
                                      to_device)
from emqx_tpu_torch.ops.fanout import build_subtable
from emqx_tpu_torch.ops.match import encode_topics_str
from emqx_tpu_torch.ops.shapes import ShapeCapacityError, build_shape_tables
from emqx_tpu_torch.ops.shared import (STRATEGIES, STRATEGY_HASH_CLIENT,
                                       STRATEGY_HASH_TOPIC,
                                       STRATEGY_ROUND_ROBIN)
from emqx_tpu_torch.ops.trie import HostTrie, build_tables
from emqx_tpu_torch.utils import topic as T

log = logging.getLogger("emqx.device")

_PACKED_KEYS = {"qos", "nl", "rap", "rh"}


def resolve_dedup(configured=None) -> bool:
    """``broker.topic_dedup``, default on: in-window unique-topic dedup
    and the cached dispatch that rides on it (the cross-batch cache has
    no vehicle without it)."""
    return True if configured is None else bool(configured)


def resolve_match_cache_size(configured=None) -> int:
    """``broker.match_cache_size`` in unique topics, default
    ``DEFAULT_CAPACITY``; 0 disables the cache only (in-window dedup
    still engages)."""
    return DEFAULT_CAPACITY if configured is None else int(configured)


def resolve_compact_readback(configured=None) -> bool:
    """``broker.compact_readback``, default on; off reads every window's
    dense planes back (no payload class is chosen, warmed or captured)."""
    return True if configured is None else bool(configured)


def resolve_delta_overlay(configured=None) -> bool:
    """``broker.delta_overlay``, default on; off restores the host-trie
    route of post-snapshot filters and the rebuild at the threshold."""
    return True if configured is None else bool(configured)


def resolve_subscription_covering(configured=None) -> bool:
    """``broker.subscription_covering``, default on: the snapshot matches
    the covering set and expands it; off builds the full set."""
    return True if configured is None else bool(configured)


def resolve_rebuild_threshold(configured=None) -> int:
    """``broker.rebuild_threshold``, default 256. It must be a positive
    integer — anything else is a deployment error worth failing loudly
    on."""
    if configured is None:
        return 256
    val = int(configured)
    if val <= 0:
        raise ValueError(f"rebuild_threshold must be > 0, got {val}")
    return val


_snapshot_ids = itertools.count(1)

_DEVICE_LOCKS: dict = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def _device_lock(dev: torch.device) -> threading.RLock:
    """The one lock around the device work of every engine on `dev`."""
    with _DEVICE_LOCKS_GUARD:
        return _DEVICE_LOCKS.setdefault(str(dev), threading.RLock())


# torch.cuda.Stream draws from a pool of 32 streams per priority level and
# hands each out again every 32 draws: a capture stream drawn at the
# engines' priority (0) was, every 32nd capture, an engine's serving or
# warm stream. Another thread's work on it could then land inside the
# capture (such as the host allocator's event records on a pinned block's
# streams when the block is freed), and from then on every pin_memory
# raised "CUDA error: invalid argument" (``chip_smoke.py --warm-stress``).
# Captures run on a stream of a level nothing else here draws from.
_CAPTURE_PRIORITY = -3
_CAPTURE_STREAMS: dict = {}


def _capture_stream(dev: torch.device):
    """The stream every graph capture on `dev` runs on, under the device
    lock."""
    with _DEVICE_LOCKS_GUARD:
        s = _CAPTURE_STREAMS.get(str(dev))
        if s is None:
            s = _CAPTURE_STREAMS[str(dev)] = torch.cuda.Stream(
                dev, priority=_CAPTURE_PRIORITY)
        return s

# delta-overlay row classes: pow2 classes keep the program shapes stable
# while the overlay grows; past the top class the oldest _OVERLAY_MAX
# delta filters keep their rows and the rest serve host-side until the
# compaction the overflow triggers. Fan-out is a fixed per-row budget; a
# delta filter with more subscribers (or rich subopts) keeps its match on
# the card and delivers through the host dict.
_DELTA_CLASSES = (16, 128, 512)
_OVERLAY_MAX = _DELTA_CLASSES[-1]
_DELTA_FAN_PER_ROW = 8
_DELTA_MATCH_CAP = 16
_DELTA_FANOUT_CAP = 64


def _topic_keys(enc: np.ndarray, lens: np.ndarray,
                dollar: np.ndarray) -> np.ndarray:
    """[N, L] interned rows + [N] lens + [N] is_dollar -> [N] void16 keys
    (``emqx_tpu/broker/device_engine.py:209``).

    Two independent 64-bit folds over the level ids, finalized with the
    lens and the '$' flag — 128 bits per topic, the dedup and cache
    identity. Interned ids only ever append, so equal keys mean equal
    device inputs; unseen words all encode to UNKNOWN and are identical to
    the device anyway."""
    n = enc.shape[0]
    h1 = np.full(n, 0x9E3779B97F4A7C15, np.uint64)
    h2 = np.full(n, 0xC2B2AE3D27D4EB4F, np.uint64)
    m1 = np.uint64(0x100000001B3)
    m2 = np.uint64(0xFF51AFD7ED558CCD)
    for level in range(enc.shape[1]):
        w = enc[:, level].astype(np.uint64)
        h1 = (h1 ^ (w + np.uint64(level * 0x9E3779B1 + 1))) * m1
        h2 = (h2 ^ (w * m1 + np.uint64(level + 1))) * m2
    fin = lens.astype(np.uint64) * np.uint64(2) + dollar.astype(np.uint64)
    h1 = (h1 ^ fin) * m2
    h2 = (h2 ^ (fin * m1)) * m1
    h1 ^= h1 >> np.uint64(29)
    h2 ^= h2 >> np.uint64(31)
    return np.ascontiguousarray(
        np.stack([h1, h2], axis=1)).view("V16").reshape(-1)


class _CachePlan:
    """Inputs of one deduplicated (optionally cache-backed) dispatch: the
    compacted miss lanes, the host-filled base rows, and the scatter and
    gather indexing that rebuilds full window width."""

    __slots__ = ("miss_topics", "miss_lens", "miss_dollar", "base_m",
                 "base_c", "base_o", "miss_pos", "inv", "Bm", "n_miss",
                 "n_hit", "base_dm", "base_dc", "base_do")

    def __init__(self, miss_topics, miss_lens, miss_dollar, base_m,
                 base_c, base_o, miss_pos, inv, Bm, n_miss, n_hit):
        self.miss_topics = miss_topics
        self.miss_lens = miss_lens
        self.miss_dollar = miss_dollar
        self.base_m = base_m
        self.base_c = base_c
        self.base_o = base_o
        self.miss_pos = miss_pos
        self.inv = inv
        self.Bm = Bm
        self.n_miss = n_miss
        self.n_hit = n_hit
        # overlay base rows (overlay row indices), when the window fuses
        # the overlay
        self.base_dm = None
        self.base_dc = None
        self.base_do = None


class _CacheInfo:
    """Post-materialize cache population: (key, flat lane) per unique
    topic the cache did not have, pinned to the dispatching snapshot and
    to the cache's delta version at plan time — an overlay change while
    the window flew makes its rows stale, and put_many drops them."""

    __slots__ = ("sid", "inserts", "version")

    def __init__(self, sid, inserts, version=None):
        self.sid = sid
        self.inserts = inserts
        self.version = version


class _Overlay:
    """One immutable VERSION of the delta overlay: its device tables and
    the host index consume and plan need. Handles pin the version they
    dispatched with, as they pin ``_Built``."""

    __slots__ = ("dev", "fid_set", "row_of", "seg_of", "hostfan",
                 "version", "cap", "n", "keep")

    def __init__(self, dev, fid_set, row_of, seg_of, hostfan, version,
                 cap, n, keep=None):
        self.dev = dev            # device DeltaTables (row class `cap`)
        self.fid_set = fid_set    # frozenset of delta fids in the table
        self.row_of = row_of      # fid -> overlay row index
        self.seg_of = seg_of      # fid -> device fan-row segment length
        self.hostfan = hostfan    # fids delivering host-side (rich/big)
        self.version = version    # overlay clock stamp at build
        self.cap = cap            # row class (a program dimension)
        self.n = n                # live rows
        self.keep = keep          # pinned staging of the upload


class _DeltaRes:
    """Dense host views of one window's overlay planes."""

    __slots__ = ("fids", "counts", "moverflow", "rows", "opts",
                 "overflow")

    def __init__(self, fids, counts, moverflow, rows, opts, overflow):
        self.fids = fids          # [W, B, Dm] delta fids
        self.counts = counts      # [W, B]
        self.moverflow = moverflow  # [W, B] match-capacity overflow
        self.rows = rows          # [W, B, Dc]
        self.opts = opts          # [W, B, Dc]
        self.overflow = overflow  # [W, B] combined (match | fan-out)


class _DeltaCsr:
    """CSR host views of one window's overlay planes (the main CSR's
    layout with an empty shared family), plus the dense count and
    overflow planes."""

    __slots__ = ("off", "c3", "pay", "counts", "moverflow", "overflow")

    def __init__(self, off, c3, pay, counts, moverflow, overflow):
        self.off = off
        self.c3 = c3
        self.pay = pay
        self.counts = counts
        self.moverflow = moverflow
        self.overflow = overflow


# windows whose pinned host buffers (inputs and readback) are alive at
# once: the batcher dispatches up to its pipeline depth (8) of windows
# ahead of their settle, each holding its readback until consumed
_PINNED_SETS = 8


class _CsrRes:
    """Host side of one compacted readback: the CSR planes plus the
    always-small dense overflow/occur planes consume needs anyway.
    finish_sub dispatches on this type vs the dense 8-tuple."""

    __slots__ = ("off", "c3", "pay", "overflow", "occur")

    def __init__(self, off, c3, pay, overflow, occur):
        self.off = off            # [W, B+1] combined payload offsets
        self.c3 = c3              # [W, B, 3] (match, fanout, shared)
        self.pay = pay            # [W, P] flat payload
        self.overflow = overflow  # [W, B] host-fallback lanes
        self.occur = occur        # [W, G] cursor writeback input


class _SlowRows:
    """One sub-batch's rows as its slow messages read them (the ones the
    vectorized consume cannot prove clean): the message's valid entries
    of every plane, as Python lists, built when the message is consumed.
    With the delivery lanes the planes are copies, taken once for the
    sub-batch: the slow messages are consumed behind the plan's barrier,
    after the readback's pinned buffers went back to the allocator."""

    __slots__ = ("csr", "planes", "dcsr", "delta", "too_long", "overflow",
                 "pay", "b", "dev_shared", "ov", "pending")

    def __init__(self, h, k: int, overflow_k, pending: bool, copy: bool):
        nr, nd = h.np_res, h.np_delta
        self.csr = isinstance(nr, _CsrRes)

        def own(a):
            return a.copy() if copy else a

        if self.csr:
            off = nr.off[k]
            self.planes = (own(off), own(nr.c3[k]),
                           own(nr.pay[k][:int(off[-1])]))
        else:
            self.planes = tuple(own(x[k]) for x in nr[:6])
        self.delta = None
        self.dcsr = isinstance(nd, _DeltaCsr)
        if nd is not None:
            self.delta = (own(nd.off[k]), own(nd.c3[k]), own(nd.pay[k])) \
                if self.dcsr else \
                (own(nd.fids[k]), own(nd.rows[k]), own(nd.opts[k]))
        self.too_long = h.subs[k][1]
        self.overflow = own(overflow_k)
        self.pay = None
        self.b, self.dev_shared, self.ov = h.built, h.dev_shared, h.delta
        self.pending = pending

    def rows(self, i: int) -> tuple:
        """(row6, drow) of message i: the six route planes' entries and
        the overlay's (delta fids, fan rows, fan opts), or None."""
        if self.csr:
            if self.pay is None:
                off, c3, pay = self.planes
                self.pay = (off.tolist(), c3.tolist(), pay.tolist())
            off_l, c3_l, pay = self.pay
            o = off_l[i]
            cm, cf, cs = c3_l[i]
            a, bb = o + cm, o + cm + cf
            c, d = bb + cf, bb + cf + cs
            row6 = (pay[o:a], pay[a:bb], pay[bb:c], pay[c:d],
                    pay[d:d + cs], pay[d + cs:d + 2 * cs])
        else:
            row6 = tuple(x[i].tolist() for x in self.planes)
        drow = None
        if self.delta is not None:
            if self.dcsr:
                drow = csr_slices(*self.delta, i)[:3]
            else:
                drow = tuple(x[i] for x in self.delta)
            drow = tuple(x.tolist() for x in drow)
        return row6, drow


def _pack_opts(opts: dict) -> int:
    return ((int(opts.get("qos", 0)) & 0x3)
            | ((1 if opts.get("nl") else 0) << 2)
            | ((1 if opts.get("rap") else 0) << 3)
            | ((int(opts.get("rh", 0)) & 0x3) << 4))


def _is_rich(opts: dict) -> bool:
    """Subopts that the packed byte cannot carry (v5 subscription ids etc.)
    force the filter onto the host dict path."""
    return any(k not in _PACKED_KEYS and k != "share" and v is not None
               for k, v in opts.items())


def _next_pow2(x: int) -> int:
    return 1 << max(2, (x - 1).bit_length())


# device member ids at/above this are remote refs: they index the built
# snapshot's remote_members list instead of a local session row (int32-safe;
# local sids are small dense ints)
_REMOTE_SID_BASE = 1 << 30


def capture_shared(broker, f: str) -> dict:
    """Per-filter shared-group capture for a device snapshot (the
    single-chip engine and the mesh's ShardedRouteServer).

    Standalone: the local SharedGroup members with their subopts, and each
    group's cursor. Clustered: the cluster-wide membership
    (`cluster._members`, the sorted (origin, sid) view the host pick
    uses), local members with their subopts and remote members as
    ((origin, sid), None) refs that the build turns into device sids of
    `_REMOTE_SID_BASE` and above. Groups known only through replication
    are captured too, so every device-supported strategy picks on the
    device wherever the members live.

    For the `sticky` strategy the returned cursor is the sticky member's
    INDEX in the members list (establishing affinity on the first capture
    if none exists) — the device pick reinterprets the cursor as the
    affinity pointer and never advances it. Establishing affinity is the
    one write this otherwise read-only capture performs, and it is
    idempotent: it only runs when no live member holds affinity and always
    picks members[0] of the insertion-ordered members dict standalone, or
    refs[0] of the sorted cluster view clustered."""
    cluster = broker.cluster
    sticky_mode = broker.shared_strategy == "sticky"
    local = broker.shared.get(f) or {}
    if cluster is None:
        out = {}
        for g, grp in local.items():
            if not grp.members:
                continue
            members = list(grp.members.items())
            cursor = grp.cursor
            if sticky_mode:
                if grp.sticky not in grp.members:
                    grp.sticky = members[0][0]   # establish affinity
                cursor = next(i for i, (sid, _) in enumerate(members)
                              if sid == grp.sticky)
            out[g] = (members, cursor)
        return out
    names = set(local) | cluster._groups_by_real.get(f, set())
    me = cluster.rpc.node
    out = {}
    for g in sorted(names):
        grp = local.get(g)
        members = []
        refs = []                      # (origin, sid) per kept member
        for origin, sid in cluster._members(broker, f, g):
            if origin == me:
                opts = grp.members.get(sid) if grp else None
                if opts is not None:
                    members.append((sid, opts))
                    refs.append((origin, sid))
            else:
                members.append(((origin, sid), None))
                refs.append((origin, sid))
        if not members:
            continue
        cursor = grp.cursor if grp else 0
        if sticky_mode:
            want = cluster._shared_sticky.get((f, g))
            if want not in refs:
                want = refs[0]         # establish cluster-wide affinity
                cluster._shared_sticky[(f, g)] = want
            cursor = refs.index(want)
        out[g] = (members, cursor)
    return out


class _Graph:
    """One shape-hash route window class captured as a CUDA graph on one
    snapshot: its static inputs (the window's arrays in program order,
    the cursors it starts from, and for an overlay class the overlay
    tables at the class's row capacity), its static output planes, and
    the kernel launches one replay makes. A dispatch copies its window
    into the inputs and replays: one launch of the graph instead of the
    window's hundreds of eager launches."""

    __slots__ = ("graph", "inputs", "cursors", "delta", "dver", "planes",
                 "launches", "label")

    def __init__(self, graph, inputs, cursors, delta, planes, launches,
                 label):
        self.graph = graph
        self.inputs = inputs      # static device inputs, program order
        self.cursors = cursors
        self.delta = delta        # static DeltaTables, or None
        self.dver = None          # the _Overlay last copied into `delta`
        self.planes = planes      # (res, compact, delta planes, d_compact)
        self.launches = launches  # [(kernel, shape)] per replay
        self.label = label        # the class label (_class_label)


class _CoverState:
    """Host side of one snapshot's subscription covering
    (``emqx_tpu/broker/device_engine.py:463``): the roots' HostTrie and
    encodings (built on the first append try) answer "is this new filter
    covered?", and the numpy CoverTables mirror backs the append region.
    ``dev_app`` is the device copy of the append region's current
    version (immutable: a window in flight keeps the one it dispatched
    with), ``keep`` the pinned staging of its upload."""

    __slots__ = ("trie", "root_words", "roots", "ct", "app_used",
                 "level_cap", "n_roots", "n_covered", "incomplete",
                 "dev_app", "keep")

    def __init__(self, roots, ct, level_cap, n_covered, incomplete):
        self.roots = roots            # root fid array (covering set)
        self.trie = None              # HostTrie over the roots, and
        self.root_words = None        # their encodings (lazy)
        self.ct = ct                  # numpy CoverTables (host mirror)
        self.app_used = 0             # append-region rows consumed
        self.level_cap = level_cap    # vwords width (append depth gate)
        self.n_roots = len(roots)
        self.n_covered = n_covered
        self.incomplete = incomplete  # detection-overflow filter count
        self.dev_app = None
        self.keep = None


class _Built:
    """One compiled snapshot (host-side indexes of the device tables)."""

    __slots__ = ("fid_of", "fid_filter", "seg_len", "slot_of", "slot_key",
                 "n_slots", "backend", "remote_members", "seg_np",
                 "fid_shared", "fid_rich", "sid", "match_width", "sig",
                 "cover")

    def __init__(self):
        self.fid_of: dict[str, int] = {}
        self.fid_filter: list[str] = []
        self.seg_len: list[int] = []
        self.slot_of: dict[tuple, int] = {}       # (filter, group) -> slot
        self.slot_key: list[tuple] = []           # slot -> (filter, group)
        self.n_slots = 0
        # remote shared members: device sid _REMOTE_SID_BASE+i -> (origin,
        # remote_sid); consume forwards picks for these over rpc
        self.remote_members: list[tuple] = []
        self.backend = "trie"
        # snapshot identity: the match-cache key space
        self.sid = next(_snapshot_ids)
        # width of one match row: shape capacity for the shapes backend,
        # match_cap for the trie NFA (the cache's row width)
        self.match_width = 0
        # the warm-class signature (DeviceRouteEngine._signature)
        self.sig: tuple = ()
        # vectorized-consume companions (set once at build):
        self.seg_np = np.zeros(0, np.int64)       # seg_len as an array
        self.fid_shared = np.zeros(0, bool)       # fid has shared groups
        self.fid_rich = np.zeros(0, bool)         # fid has rich subopts
        # subscription covering: _CoverState when the match tables hold
        # the covering set only; then seg_np/fid_shared/fid_rich are
        # padded to the filter capacity so appended fids index safely
        self.cover: Optional[_CoverState] = None


class _Handle:
    """One in-flight dispatched WINDOW of 1..W publish micro-batches
    (prepare → dispatch → materialize → finish_sub per batch). Host-side
    metadata pins the snapshot and the overlay version the dispatch ran
    against; the engine defers snapshot swaps until no handle is
    outstanding. `refs` counts the attached sub-batches: the handle
    releases when every sub has been finished or abandoned."""

    __slots__ = ("subs", "built", "dev_shared", "enc", "res", "cres",
                 "np_res", "refs", "pcap", "host", "ev_start", "event",
                 "launch_s", "cost_s", "cursors0", "graphed",
                 "n_msgs", "error", "plan", "cache_info", "delta", "dres",
                 "dcres", "np_delta", "arrays", "cls", "tables", "strat",
                 "consumed", "on_release", "trace", "sub_traces",
                 "abandoned", "corrupt", "__weakref__")

    def __init__(self, subs, built, dev_shared):
        self.subs = subs          # list of (msgs, too_long)
        self.built = built
        self.dev_shared = dev_shared
        self.enc = None       # (topics [Wp, Bp, L], lens, dollar) numpy
        self.res = None       # device RouteResult, fields [W, ...]
        self.cres = None      # device CompactPlanes (CSR readback)
        self.np_res = None    # host views: dense tuple OR _CsrRes
        self.refs = len(subs)
        self.n_msgs = sum(len(msgs) for msgs, _t in subs)
        self.pcap = None      # payload class: CSR-compact this dispatch
        self.plan = None      # _CachePlan: deduplicated dispatch inputs
        self.cache_info = None  # _CacheInfo: rows to insert at readback
        self.delta = None     # _Overlay this dispatch fused
        self.dres = None      # device DeltaPlanes
        self.dcres = None     # device delta CompactPlanes
        self.np_delta = None  # host views: _DeltaRes or _DeltaCsr
        self.arrays = None    # the program's host inputs, in order
        self.cls = None       # (Wp, Bp, Bm, dC, P)
        self.tables = None    # the device tables the dispatch used (with
        #                       its cover append version, when covered)
        self.strat = None
        self.host = None      # pinned host copies started at dispatch
        self.ev_start = None  # CUDA events around the window's device
        self.event = None     # work (and behind the pinned copies)
        self.cursors0 = None  # the device cursors the window started from
        self.graphed = False  # dispatched as a CUDA graph replay
        self.launch_s = 0.0   # host time of the dispatch's launches
        # what this window costs to serve: the host work of prepare,
        # dispatch and consume, plus the card's time past the launches
        # (the events) — the batcher's device/host chooser reads it
        self.cost_s = 0.0
        self.error = None     # why the window was abandoned, when fatal
        # abandoned while a stage thread may still be inside it: it serves
        # nothing more, and releases once the thread has left
        self.abandoned = False
        self.corrupt = False  # an injected corrupt readback truncated it
        self.consumed = 0     # sub-batches finish_sub has consumed
        self.on_release = None  # called once when the handle releases
        # flight-recorder trace id: the LEAD entry's window trace (host
        # side only: it names the dispatch's profiler range, never a
        # graph input), and each sub-batch's own (fused windows)
        self.trace = 0
        self.sub_traces = None


class DeviceRouteEngine:
    # window sub-batch count classes and the standard (W, Bp) ladder the
    # batcher's warm gate checks
    _W_CLASSES = (1, 8)
    _STD_CLASSES = ((1, 64), (1, 256), (1, 1024), (8, 1024))

    # payload classes are multiples of the batch class Bp (entries per
    # message budget): 8 covers trickle fan-out, 32 the fan-out ≤ ~10
    # regime, 128 heavy fan-out. Beyond 128 the compacted payload
    # approaches the dense planes and compaction stops paying — the
    # chooser returns None (dense readback).
    _PAYLOAD_MULTS = (8, 32, 128)

    def __init__(self, node, *, device=None,
                 rebuild_threshold: Optional[int] = None,
                 max_levels: int = 16, frontier_cap: int = 16,
                 match_cap: int = 64, fanout_cap: int = 128,
                 slot_cap: int = 16, shape_cap: int = 32,
                 match_cache_size: Optional[int] = None,
                 dedup: Optional[bool] = None,
                 compact_readback: Optional[bool] = None,
                 delta_overlay: Optional[bool] = None,
                 subscription_covering: Optional[bool] = None):
        self.node = node
        self.broker = node.broker
        self.router = node.broker.router
        self.device = resolve_device(device)
        self.rebuild_threshold = resolve_rebuild_threshold(
            rebuild_threshold)
        self.max_levels = max_levels
        self.frontier_cap = frontier_cap
        self.match_cap = match_cap
        self.fanout_cap = fanout_cap
        self.slot_cap = slot_cap
        self.shape_cap = shape_cap

        self.intern = I.InternTable()
        # the columnar-ingress burst pre-encode: one native encode of a
        # read burst's unique topics, which prepare_window's encode
        # gathers from. Used only while the intern table's length is
        # unchanged: ids are append-only, so an equal length proves the
        # cached rows are what a fresh encode gives (a filter word
        # interned between burst and window would turn a cached UNKNOWN
        # stale; the guard drops the whole memo then)
        self._burst_enc = None    # (idx: dict, enc, lens, dollar,
                                  #  too_long, intern_len)
        self._built: Optional[_Built] = None
        self._tables = None            # device RouterTables/ShapeRouterTables
        self._cursors = None           # device [G]
        self.dirty_filters: set[str] = set()
        self.dirty_slots: set[tuple] = set()
        self.new_slots_by_filter: dict[str, set[str]] = {}
        # hostside-mask memo: the mask only changes when the dirty set or
        # the snapshot does, so it is memoized on (snapshot id, dirty
        # version) — the version bumps on subscribe/unsubscribe churn
        self._dirty_ver = 0
        self._hostside_memo: Optional[tuple] = None
        self._delta_trie = HostTrie()
        self._delta_filter: dict[int, str] = {}
        self._delta_fid_of: dict[str, int] = {}
        self._next_delta_fid = 0
        self._enc_cache: dict[str, list] = {}  # filter -> interned words
        # per-filter cluster shared-group union, invalidated on membership
        # change (avoids per-message set unions on the consume path)
        self._cluster_groups_cache: dict[str, tuple] = {}

        # class readiness: the BATCHER routes a batch to the device only
        # when its (W, Bp) class is warm for the current snapshot
        # signature, and each optional program dimension (dedup miss
        # class, overlay row class, payload class) is gated on its own
        # class being warm. A class becomes warm after one dispatch at it
        # — the first one builds the kernels and fills the allocator, so
        # first use never stalls live traffic; background warm tasks run
        # that dispatch off the serving path for the classes the serving
        # path asked for.
        self._warm_classes: set = set()   # {(sig, W, Bp[, Bm][, dC][, cP])}
        self._extra_classes: set = set()     # non-standard (W, Bp) wanted
        self._wanted: set = set()            # (W, Bp, Bm, dC, P) asked for
        self._cur_sig: tuple = ()
        # on the card, shape-hash windows replay CUDA graphs captured by
        # the warm dispatches: {(snapshot, W, Bp, Bm, dC, P, strategy):
        # _Graph}; how many were captured and the seconds they took
        self._graphs: dict = {}
        self.captures = 0
        self.capture_s = 0.0
        # the graph-class registry: class label -> captures, capture
        # seconds, replays (the telemetry's program_costs)
        self._graph_rows: dict[str, dict] = {}
        self._fuse_warm_task = None
        # background rebuild machinery
        self._outstanding = 0          # dispatched-but-unfinished handles
        self._journal: Optional[list] = None   # churn while a build runs
        self._building = False
        self._pending_swap = None
        self._rebuild_task = None
        # CSR readback: payload capacity quantizes onto _PAYLOAD_MULTS * Bp
        # classes sized by a peak-biased EWMA of recent window totals, with
        # a dense-readback fallback when a window outgrows its class; off,
        # every window reads back dense
        self.compact_readback = resolve_compact_readback(compact_readback)
        self._pay_ewma: dict[int, float] = {}   # Bp -> peak entry total

        # reuse layers: in-window unique-topic dedup and the cross-batch
        # snapshot-keyed match cache (size 0 / dedup off disable a layer)
        self.dedup = resolve_dedup(dedup)
        size = resolve_match_cache_size(match_cache_size)
        self._match_cache: Optional[MatchCache] = \
            MatchCache(size, node.metrics) \
            if (self.dedup and size > 0) else None
        # delta overlay: post-snapshot filters match on the card through a
        # small linear overlay fused into the route window
        self.delta_overlay = resolve_delta_overlay(delta_overlay)
        self._overlay: Optional[_Overlay] = None  # current serving table
        self._overlay_stale = False     # churn not yet applied
        self._overlay_clock = 0         # monotonic overlay mutation clock
        self._overlay_uncovered = 0     # live delta filters NOT in it
        # fid -> clock of its last MEMBERSHIP change: an overlay version
        # older than that has stale fan rows for the fid, so consume
        # delivers it from the host dict
        self._fid_member_clock: dict[int, int] = {}
        self._built_deleted: set[str] = set()  # snapshot tombstones
        # incremental capture: the last build's capture and the filters
        # touched since it — with the overlay on a compaction re-walks
        # only those (and every shared filter) instead of the world
        self._last_capture = None
        self._touched: set[str] = set()
        # subscription covering: the snapshot matches the covering set
        # and expands it after the match stage (ops/cover). New filters
        # no built root covers erode the reduction; past a budget they
        # trigger the "covering" compaction
        self.subscription_covering = resolve_subscription_covering(
            subscription_covering)
        self._cover_churn = 0
        self.detect_s = 0.0      # the last build's cover detection seconds

        # one stream for serving dispatches, one for background warms (a
        # stream is never shared by two threads at once: kernel 2's
        # look-back words are per stream), and one lock around all of the
        # engine's device work, so windows never interleave and a graph
        # capture never runs beside another thread's device calls (those
        # can invalidate it). The lock is the device's, shared by every
        # engine on it: two engines' background warms, one capturing while
        # the other synchronized its warm stream, invalidated a capture
        # (phase 9's nodes A and B, PERF.md)
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._warm_stream = torch.cuda.Stream(self.device) if cuda else None
        self._cuda_lock = _device_lock(self.device)
        # on the card a dispatch only enqueues kernels and copies (no host
        # sync), so the batcher runs it on the loop; on the CPU the window
        # is the computation itself and keeps its executor thread
        self.dispatch_on_loop = cuda
        # on the card a device failure raises (see the module docstring);
        # a failure off the serving path is kept here and re-raised
        self.fail_on_device_error = cuda
        self.failed: Optional[BaseException] = None

        # the node's HBM ledger (None: no accounting), telemetry and
        # flight recorder (None: no spans)
        self.ledger = getattr(node, "hbm_ledger", None)
        self.tele = getattr(node, "pipeline_telemetry", None)
        self.rec = getattr(node, "flight_recorder", None)
        # an active torch.profiler device trace (start_device_trace), the
        # directory its Chrome trace goes to, and the step counter of
        # windows without a trace id
        self._profiler = None
        self._trace_dir: Optional[str] = None
        self._step_num = 0
        if self.tele is not None:
            self.tele.rebuild_state_fn = self.rebuild_state
            self.tele.graphs_fn = self.graph_registry
        # fault-domain supervision: injection points at every stage
        # boundary, breaker-gated degradation (the reuse layers stand down
        # at rung 1, the whole device path at rung 2 — the batcher reads
        # the rung), contained cache/overlay/swap faults, and the probes
        # the half-open breakers run off the serving path. None
        # (broker.supervise off) is the unsupervised unwind.
        self.sup = getattr(node, "supervisor", None)
        # the probes' kernel launches by kernel (counted, and kept here)
        self.probe_launches: dict[str, int] = {}
        if self.sup is not None:
            self.sup.register_probe("dispatch",
                                    self._probed(self._probe_dispatch))
            self.sup.register_probe("materialize",
                                    self._probed(self._probe_materialize))

        # wire change notifications
        self.router.on_route_change = self.note_route_change
        self.broker.device_engine = self

    # ---- churn tracking -------------------------------------------------
    def staleness(self) -> int:
        """Distinct stale entities vs the snapshot (filters/slots serving
        host-side) — the rebuild trigger. A set-size measure, so repeated
        churn on one filter counts once. With the overlay on,
        post-snapshot filters serve on the card and do not count (only
        those the overlay cannot hold do), and deleted built filters move
        to the tombstone trigger (``_compaction_reason``)."""
        base = (len(self.dirty_filters) + len(self.dirty_slots)
                + sum(len(v) for v in self.new_slots_by_filter.values()))
        if self.delta_overlay:
            base -= len(self._built_deleted)    # ⊆ dirty_filters
            base += self._overlay_uncovered
        else:
            base += len(self._delta_filter)
        return base

    def journal_depth(self) -> int:
        """Filters touched since the last capture: the incremental
        capture's pending work (the rebuild telemetry's gauge)."""
        return len(self._touched)

    def _mark_dirty(self, f: str) -> None:
        """dirty_filters.add with the hostside-memo version bump (only
        on actual growth — the subscribe path's double notification
        must not churn the memo key twice for one event)."""
        if f not in self.dirty_filters:
            self.dirty_filters.add(f)
            self._dirty_ver += 1

    def _hostside_mask(self, b) -> np.ndarray:
        """Per-fid host-side delivery mask of snapshot `b` (rich subopts
        OR dirty membership), memoized on (snapshot id, dirty version)."""
        if not self.dirty_filters:
            return b.fid_rich
        key = (b.sid, self._dirty_ver)
        memo = self._hostside_memo
        if memo is not None and memo[0] == key:
            return memo[1]
        hs = b.fid_rich.copy()
        for f in self.dirty_filters:
            fid = b.fid_of.get(f)
            if fid is not None:
                hs[fid] = True
        self._hostside_memo = (key, hs)
        return hs

    def _enc_filter(self, f: str) -> list:
        """Interned level ids of a filter, memoized across builds (word
        ids are append-only for the process lifetime)."""
        w = self._enc_cache.get(f)
        if w is None:
            w = self._enc_cache[f] = self.intern.encode_filter(
                T.tokens(f))
        return w

    def _overlay_changed(self, words, deleted_fid=None) -> None:
        """Bookkeeping shared by overlay insert and delete: bump the
        overlay clock, mark the table stale, and keep the match cache
        exact — drop the cached topics the changed filter matches and
        bump the cache's delta version, so readbacks planned before this
        change cannot insert stale rows."""
        self._overlay_clock += 1
        self._overlay_stale = True
        if deleted_fid is not None:
            self._fid_member_clock.pop(deleted_fid, None)
        cache = self._match_cache
        if cache is not None:
            cache.bump_delta_version()
            if len(cache):
                cache.drop_where(
                    self._built.sid if self._built else None,
                    lambda encs, lens, dols: np_filter_match(
                        words, encs, lens, dols))

    def note_route_change(self, topic_filter: str, added: bool) -> None:
        """Router filter-universe change."""
        if self._journal is not None:
            self._journal.append(("route", topic_filter, added))
        self._touched.add(topic_filter)
        removed_words = None
        if not added:
            removed_words = self._enc_cache.pop(topic_filter, None)
        if self._built is None:
            return
        if added:
            if topic_filter in self._built.fid_of:
                self._mark_dirty(topic_filter)
                self._built_deleted.discard(topic_filter)
            elif topic_filter not in self._delta_fid_of:
                words = self._enc_filter(topic_filter)
                if self._try_cover_append(topic_filter, words):
                    return
                fid = self._next_delta_fid
                self._next_delta_fid += 1
                self._delta_trie.insert(words, fid)
                self._delta_filter[fid] = topic_filter
                self._delta_fid_of[topic_filter] = fid
                if self.delta_overlay:
                    self._overlay_changed(words)
        else:
            if topic_filter in self._built.fid_of:
                self._mark_dirty(topic_filter)
                self._built_deleted.add(topic_filter)
            fid = self._delta_fid_of.pop(topic_filter, None)
            if fid is not None:
                words = removed_words if removed_words is not None \
                    else self.intern.encode_filter(T.tokens(topic_filter))
                self._delta_trie.delete(words)
                self._delta_filter.pop(fid, None)
                if self.delta_overlay:
                    self._overlay_changed(words, deleted_fid=fid)

    def note_member_change(self, real: str, group: Optional[str]) -> None:
        """Broker membership change (subscribe/unsubscribe/opts update)."""
        if self._journal is not None:
            self._journal.append(("member", real, group))
        self._touched.add(real)
        self._cluster_groups_cache.pop(real, None)
        if self._built is None:
            return
        if group is None:
            if real in self._built.fid_of:
                self._mark_dirty(real)
            elif self.delta_overlay:
                fid = self._delta_fid_of.get(real)
                if fid is not None:
                    # the overlay's fan rows for this fid are stale:
                    # versions at/below this clock deliver it from the
                    # host dict until the next overlay apply (match rows
                    # do not depend on membership: no cache action)
                    self._overlay_clock += 1
                    self._fid_member_clock[fid] = self._overlay_clock
                    self._overlay_stale = True
        else:
            if (real, group) in self._built.slot_of:
                self.dirty_slots.add((real, group))
            elif real in self._built.fid_of:
                self.new_slots_by_filter.setdefault(real, set()).add(group)
            # delta filters' shared groups dispatch host-side via the
            # consume sweep over live broker.shared — nothing to track

    # ---- subscription covering: cover-set churn ----------------------------
    def _cover_index(self, b) -> _CoverState:
        """The snapshot's host covering index (HostTrie over the roots and
        their encodings), built on the first append try."""
        cs = b.cover
        if cs.trie is None:
            t = HostTrie()
            rw: dict[int, list] = {}
            for fid in cs.roots.tolist():
                w = self._enc_filter(b.fid_filter[fid])
                t.insert(w, fid)
                rw[fid] = w
            cs.trie, cs.root_words = t, rw
        return cs

    def _try_cover_append(self, f: str, words: list) -> bool:
        """Cover-set churn (``emqx_tpu/broker/device_engine.py:932``): a
        NEW filter a built root covers becomes an expansion-CSR append —
        a spare padded fid and an upload of the append region — instead
        of an overlay row. It matches on the card from the next dispatch,
        sorted after every built filter (where the covering-off twin's
        overlay rows deliver), and delivers through the host dict (its
        padded fan-out segment is empty). False sends the filter down the
        overlay path and, on a covering snapshot, counts toward the
        "covering" compaction."""
        b = self._built
        if b is None or b.cover is None or self._tables is None \
                or not self.subscription_covering:
            return False
        m = self.node.metrics
        cs = b.cover
        ct = cs.ct
        if (len(words) > cs.level_cap
                or cs.app_used >= ct.app_root.shape[0]
                or len(b.fid_filter) >= len(b.seg_np)):
            self._cover_churn += 1
            m.inc("routing.cover.append_rejects")
            return False
        cs = self._cover_index(b)
        roots = CV.host_covering_roots(cs.trie, cs.root_words, words,
                                       f.startswith("$"))
        if not roots:
            self._cover_churn += 1
            m.inc("routing.cover.append_rejects")
            return False

        fid = len(b.fid_filter)
        k = cs.app_used
        ct.app_root[k] = min(roots)
        ct.app_fid[k] = fid
        # a rank past every built filter's: appends deliver in arrival
        # order after the snapshot set, as the off twin's overlay rows
        ct.app_key[k] = np.int32(CV.rank_base(ct) + k)
        ct.app_words[k, :len(words)] = words
        ct.app_lens[k] = len(words)
        cs.app_used += 1
        b.fid_of[f] = fid
        b.fid_filter.append(f)
        b.seg_len.append(0)
        b.fid_rich[fid] = True       # deliver via the live broker dict
        self._dirty_ver += 1         # the hostside-mask memo must refresh
        self._cover_upload(b)

        # match-cache invalidation over the EXPANDED set: cached topics
        # the new filter matches drop, and the delta version bump keeps
        # readbacks in flight from re-inserting pre-append rows
        cache = self._match_cache
        if cache is not None:
            cache.bump_delta_version()
            if len(cache):
                cache.drop_where(
                    b.sid, lambda encs, lens, dols: np_filter_match(
                        words, encs, lens, dols))
        m.inc("routing.cover.appends")
        return True

    def _cover_of(self, tables):
        return tables.shapes.cover if isinstance(
            tables, RE.ShapeRouterTables) else tables.trie.cover

    def _with_cover(self, tables, cover):
        if isinstance(tables, RE.ShapeRouterTables):
            return tables._replace(shapes=tables.shapes._replace(
                cover=cover))
        return tables._replace(trie=tables.trie._replace(cover=cover))

    def _cover_upload(self, b) -> None:
        """The append region's new version: an immutable device copy
        (``dev_app``), also written into the snapshot's static cover
        buffers that its CUDA graphs read — on the engine stream, under
        the lock, in order behind the previous replay, so a window in
        flight keeps the version it was dispatched with. A failed upload
        raises."""
        cs = b.cover
        planes = [getattr(cs.ct, k).copy() for k in CV.APPEND_FIELDS]
        static = [getattr(self._cover_of(self._tables), k)
                  for k in CV.APPEND_FIELDS]
        if self._stream is not None:
            with self._cuda_lock, self._on(self._stream):
                keep = [torch.from_numpy(a).pin_memory() for a in planes]
                new = tuple(t.to(self.device, non_blocking=True)
                            for t in keep)
                for dst, src in zip(static, new):
                    dst.copy_(src)
            cs.keep = keep
        else:
            new = tuple(torch.from_numpy(a) for a in planes)
            for dst, src in zip(static, new):
                dst.copy_(src)
        cs.dev_app = self._hold("cover_csr", new,
                                f"s{b.sid}a{cs.app_used}")

    def _versioned(self, b, tables):
        """`tables` with snapshot `b`'s current cover append version in
        place of the static append buffers (a dispatch pins it)."""
        if b.cover is None or b.cover.dev_app is None:
            return tables
        cov = self._cover_of(tables)._replace(
            **dict(zip(CV.APPEND_FIELDS, b.cover.dev_app)))
        return self._with_cover(tables, cov)

    # ---- snapshot compile ----------------------------------------------
    def _observe_rebuild(self, stage: str, t0: float) -> None:
        if self.tele is not None:
            self.tele.observe_rebuild(stage, time.perf_counter() - t0)

    def rebuild(self) -> None:
        """Compile router+broker state into fresh device tables and swap,
        synchronously (first build / callers without a loop). The
        background path is `maybe_background_rebuild`. With the overlay
        on and a previous capture, the capture is incremental
        (``_capture_state_incremental``)."""
        t0 = time.perf_counter()
        if self._can_capture_incremental():
            capture = self._capture_state_incremental()
        else:
            capture = self._capture_state_sync()
        self._observe_rebuild("capture", t0)
        t0 = time.perf_counter()
        result = self._build_from_capture(capture)
        self._observe_rebuild("build", t0)
        t0 = time.perf_counter()
        self._apply_build(result, journal=())
        self._observe_rebuild("swap", t0)

    def _note_captured(self, capture) -> None:
        """A capture just completed: with the overlay on it becomes the
        incremental baseline. Every capture path calls this before churn
        racing the build can land (that re-enters ``_touched``)."""
        if self.delta_overlay:
            self._last_capture = capture

    def _can_capture_incremental(self) -> bool:
        return self.delta_overlay and self._last_capture is not None

    def _incremental_refresh_set(self) -> set:
        """Filters an incremental capture re-walks: every filter touched
        since the last capture, and every shared-group filter, old and
        new — a group's cursor advances on every dispatch with no
        ``note_*`` call, so a stale shared capture would reset its
        round-robin rotation at each compaction."""
        refresh = set(self._touched)
        self._touched = set()     # touches during the capture re-add
        refresh |= set(self._last_capture[3])
        refresh |= set(self.broker.shared)
        return refresh

    def _apply_refresh(self, subs: dict, shared: dict, fs) -> None:
        """Re-read filters `fs` from the live state into the capture's
        dicts (dropping what is gone)."""
        broker = self.broker
        for f in fs:
            s = broker.subs.get(f)
            if s:
                subs[f] = list(s.items())
            else:
                subs.pop(f, None)
            cap = capture_shared(broker, f)
            if cap:
                shared[f] = cap
            else:
                shared.pop(f, None)

    def _capture_state_incremental(self):
        """The previous capture with only the refresh set re-walked
        (``emqx_tpu/broker/device_engine.py:1093``). The filter universe
        is re-listed live; ``_build_from_capture`` keys everything off
        it, so filters added or removed since are taken or dropped."""
        router = self.router
        exact, wild = list(router.exact), list(router.wildcards)
        _e, _w, subs0, shared0 = self._last_capture
        subs, shared = dict(subs0), dict(shared0)
        self._apply_refresh(subs, shared, self._incremental_refresh_set())
        capture = (exact, wild, subs, shared)
        self._note_captured(capture)
        return capture

    async def _capture_state_incremental_async(self, chunk: int = 1024):
        """The incremental capture in chunks, yielding between them;
        churn landing meanwhile re-enters ``_touched`` and the build
        journal, as the full capture's races do."""
        router = self.router
        exact, wild = list(router.exact), list(router.wildcards)
        _e, _w, subs0, shared0 = self._last_capture
        subs, shared = dict(subs0), dict(shared0)
        refresh = sorted(self._incremental_refresh_set())
        for i in range(0, len(refresh), chunk):
            self._apply_refresh(subs, shared, refresh[i:i + chunk])
            await asyncio.sleep(0)
        capture = (exact, wild, subs, shared)
        self._note_captured(capture)
        return capture

    def _capture_state_sync(self):
        """Point-in-time copy of the routing state (sync, may stall)."""
        broker, router = self.broker, self.router
        self._touched = set()
        exact, wild = list(router.exact), list(router.wildcards)
        filters = exact + wild
        subs = {f: list(broker.subs[f].items())
                for f in filters if broker.subs.get(f)}
        shared = {}
        for f in filters:
            cap = capture_shared(broker, f)
            if cap:
                shared[f] = cap
        capture = (exact, wild, subs, shared)
        self._note_captured(capture)
        return capture

    async def _capture_state_async(self, chunk: int = 1024):
        """Chunked capture: yields to the loop between chunks so serving
        continues; mutations landing mid-capture are journaled and
        replayed at swap, so a half-captured filter at worst serves
        host-side."""
        broker, router = self.broker, self.router
        self._touched = set()
        exact, wild = list(router.exact), list(router.wildcards)
        filters = exact + wild
        subs: dict = {}
        shared: dict = {}
        for i in range(0, len(filters), chunk):
            for f in filters[i:i + chunk]:
                s = broker.subs.get(f)
                if s:
                    subs[f] = list(s.items())
                cap = capture_shared(broker, f)
                if cap:
                    shared[f] = cap
            await asyncio.sleep(0)
        capture = (exact, wild, subs, shared)
        self._note_captured(capture)
        return capture

    def _build_from_capture(self, capture):
        """Compile a captured state into device tables (loop-free: safe on
        an executor thread). Returns (built, dev_tables, dev_cursors) or
        None when the filter set is empty."""
        exact, wild, subs_cap, shared_cap = capture
        filters = sorted(exact) + sorted(wild)
        if not filters:
            return None

        b = _Built()
        b.fid_of = {f: i for i, f in enumerate(filters)}
        b.fid_filter = filters
        n = len(filters)
        words = [self._enc_filter(f) for f in filters]
        L = max(1, max(len(w) for w in words))
        rows = np.zeros((n, L), np.int32)
        lens = np.zeros(n, np.int64)
        for i, w in enumerate(words):
            rows[i, :len(w)] = w
            lens[i] = len(w)

        normal: dict[int, list] = {}
        filter_slots: dict[int, list] = {}
        shared_members: dict[int, list] = {}
        cursors0: list[int] = []
        rich: set[str] = set()
        seg_len = [0] * n
        for f, fid in b.fid_of.items():
            subs = subs_cap.get(f)
            if subs:
                entries = []
                for sid, opts in subs:
                    if _is_rich(opts):
                        rich.add(f)
                    entries.append((sid, _pack_opts(opts)))
                normal[fid] = entries
                seg_len[fid] = len(entries)
            for g in sorted(shared_cap.get(f, {})):
                members_raw, cursor = shared_cap[f][g]
                slot = len(b.slot_key)
                b.slot_of[(f, g)] = slot
                b.slot_key.append((f, g))
                members = []
                for sid, opts in members_raw:
                    if isinstance(sid, tuple):
                        # remote member ref: reserve a device sid that
                        # indexes remote_members; opts live on its node
                        dev_sid = _REMOTE_SID_BASE + len(b.remote_members)
                        b.remote_members.append(sid)
                        members.append((dev_sid, 0))
                        continue
                    if _is_rich(opts):
                        rich.add(f)
                    members.append((sid, _pack_opts(opts)))
                shared_members[slot] = members
                filter_slots.setdefault(fid, []).append(slot)
                cursors0.append(cursor)
        b.seg_len = seg_len
        b.n_slots = len(b.slot_key)
        b.seg_np = np.asarray(seg_len, np.int64)
        b.fid_shared = np.zeros(max(1, n), bool)
        for fid in filter_slots:
            b.fid_shared[fid] = True
        b.fid_rich = np.zeros(max(1, n), bool)
        for f in rich:
            b.fid_rich[b.fid_of[f]] = True

        # pow2 capacity classes: a new signature only when a class grows
        filter_cap = _next_pow2(n)
        cover_np, cover_shapes = self._cover_build(b, filters, rows, lens,
                                                   filter_cap)
        total_subs = sum(seg_len)
        total_members = sum(len(m) for m in shared_members.values())
        subs_tbl = build_subtable(
            filter_cap, normal, filter_slots, shared_members,
            slot_cap=_next_pow2(max(1, b.n_slots)),
            sub_rows_cap=_next_pow2(max(1, total_subs)),
            fs_rows_cap=_next_pow2(max(1, b.n_slots)),
            member_rows_cap=_next_pow2(max(1, total_members)))

        st = trie = None
        if cover_np is not None:
            # the covering path: match tables over the ROOTS, keeping
            # their fids (the SubTable and consume indexing are the full
            # set's); the expansion CSR rides on the tables
            roots = b.cover.roots
            if cover_shapes:
                st = build_shape_tables(rows[roots], lens[roots],
                                        filter_ids=roots,
                                        shape_cap=self.shape_cap)
                st = st._replace(cover=cover_np)
            else:
                node_cap = _next_pow2(
                    max(256, 2 * (int(lens[roots].sum()) + 1)))
                trie = build_tables(rows[roots], lens[roots],
                                    filter_ids=roots,
                                    node_capacity=node_cap,
                                    slot_capacity=4 * node_cap)
                trie = trie._replace(cover=cover_np)
        elif L <= 20:
            try:
                st = build_shape_tables(rows, lens, shape_cap=self.shape_cap)
            except ShapeCapacityError:
                st = None
        cur = np.zeros(max(1, len(cursors0)), np.int32)
        if cursors0:
            cur[:len(cursors0)] = cursors0
        dev = self.device
        if st is not None:
            with self._cuda_lock:
                tables = tables_from_numpy(st, subs_tbl, dev)
            b.backend = "shapes"
            # a covered row is as wide as the full set's shape row
            b.match_width = int(cover_np.out_pad.shape[0]) \
                if cover_np is not None else int(st.shape_plus_mask.shape[0])
        else:
            if trie is None:
                node_cap = _next_pow2(max(256, 2 * (int(lens.sum()) + 1)))
                trie = build_tables(rows, lens, node_capacity=node_cap,
                                    slot_capacity=4 * node_cap)
            with self._cuda_lock:
                tables = router_tables_from_numpy(trie, subs_tbl, dev)
            b.backend = "trie"
            b.match_width = self.match_cap
        own = f"s{b.sid}"
        if b.cover is not None:
            # the expansion CSR rides in the tables; its own category,
            # held first (the tables' hold then skips its storages)
            self._hold("cover_csr", self._cover_of(tables), own)
            with self._cuda_lock:
                b.cover.dev_app = self._hold("cover_csr", tuple(
                    getattr(self._cover_of(tables), k).clone()
                    for k in CV.APPEND_FIELDS), f"{own}a0")
        self._hold("snapshot_tables", tables, own)
        b.sig = self._signature(b, tables)
        with self._cuda_lock:
            cursors = torch.from_numpy(cur).to(dev)
        return b, tables, self._hold("snapshot_cursors", cursors, own)

    def _hold(self, category: str, tree, owner: Optional[str] = None):
        """Register a persistent device allocation with the node's HBM
        ledger; identity passthrough when the ledger is off."""
        if self.ledger is not None:
            return self.ledger.hold(category, tree, owner=owner)
        return tree

    def _cover_build(self, b, filters, rows, lens, filter_cap):
        """The covering branch of the build
        (``emqx_tpu/broker/device_engine.py:1252-1314``): detect cover
        relations on the engine's device, pick one root per covered
        filter, and compile the expansion CSR into ``b.cover``. Returns
        (CoverTables or None, match the roots on the shape tables?).
        Nothing covered, one filter, or a filter deeper than the order
        key holds: no cover state (the full set builds as before).

        The backend follows the reference: the roots match on the shape
        tables whenever they fit the shape cap; the order keys and the
        row width are those of what the covering-off twin would run
        (shape keys and the full set's shape width iff the full set fits,
        else trie keys and match_cap)."""
        n, L = rows.shape
        if not (self.subscription_covering and n >= 2
                and L <= CV.MAX_KEY_LEVELS):
            return None, False
        dollar = np.fromiter((f.startswith("$") for f in filters), bool, n)
        t0 = time.perf_counter()
        covs, inc = CV.detect_covers(rows, lens, dollar, device=self.device,
                                     lock=self._cuda_lock)
        self.detect_s = time.perf_counter() - t0
        log.info("cover detection over %d filters: %.3f s", n,
                 self.detect_s)
        owner = CV.assign_owners(covs, inc)
        covered = np.flatnonzero(owner >= 0)
        if not len(covered):
            return None, False
        roots = np.flatnonzero(owner < 0)
        ns_full = CV.full_shape_count(rows, lens)
        ns_root = CV.full_shape_count(rows[roots], lens[roots])
        cover_shapes = L <= 20 and ns_root <= self.shape_cap
        if cover_shapes and ns_full <= self.shape_cap:
            keys = CV.shape_order_keys(rows, lens)
            out_w = 1 << max(0, (ns_full - 1).bit_length())
        else:
            keys = CV.trie_order_keys(rows, lens)
            out_w = self.match_cap
        cand_cap = min(4096, _next_pow2(max(256, 4 * out_w)))
        ct = CV.build_cover_tables(rows, lens, owner, keys,
                                   fid_cap=filter_cap, out_width=out_w,
                                   cand_cap=cand_cap)
        b.cover = _CoverState(roots, ct, L, len(covered), int(inc.sum()))
        # pad the consume companions to filter_cap: appends take fids
        # past n, and the consume walk indexes these arrays by fid
        pad = filter_cap - n
        b.seg_np = np.concatenate([b.seg_np, np.zeros(pad, np.int64)])
        b.fid_shared = np.concatenate([b.fid_shared[:n],
                                       np.zeros(pad, bool)])
        b.fid_rich = np.concatenate([b.fid_rich[:n], np.zeros(pad, bool)])
        return ct, cover_shapes

    def _signature(self, b, tables) -> tuple:
        """The warm-class signature of snapshot `b`: the reference keys
        warmth on the tables' shapes (a program compiled for one snapshot
        serves any other of the same shapes) and the trie backend on the
        empty signature. On the card a shape-hash class is warm only once
        its CUDA graph is captured, and a graph holds its snapshot's
        addresses, so there the signature is the snapshot itself."""
        if b.backend != "shapes":
            return ()
        if self.device.type == "cuda":
            return ("snapshot", b.sid)
        out = []

        def walk(t):
            if isinstance(t, torch.Tensor):
                out.append(tuple(t.shape))
            elif isinstance(t, tuple):
                for x in t:
                    walk(x)
        walk(tables)
        return tuple(out)

    def _apply_build(self, result, journal) -> None:
        """Swap a finished build in and rebase churn tracking onto it by
        replaying the journal of mutations that happened during the build."""
        if self.sup is not None:
            # the snapshot_swap injection point: a swap failure is
            # contained by _try_swap / poll_rebuild — serving stays on the
            # old snapshot + host deltas (its churn tracking ran live)
            self.sup.fire("snapshot_swap")
        if self.device.type == "cuda":
            # the old tables may still be read by finished-but-unreleased
            # stream work; the new ones were uploaded on another stream
            with self._cuda_lock:
                torch.cuda.synchronize(self.device)
        self._reset_deltas()
        sid = None
        if result is None:
            self._built = None
            self._tables = None
            self._cursors = None
            self._cur_sig = ()
        else:
            b, tables, cursors = result
            self._built = b
            self._tables = tables
            self._cursors = cursors
            self._cur_sig = b.sig
            sid = b.sid
            # warmth of other signatures goes; demand for the optional
            # classes resets with the snapshot (classes still in use
            # re-register on their next window)
            self._warm_classes = {e for e in self._warm_classes
                                  if e[0] == b.sig}
            self._wanted.clear()
        # graphs belong to one snapshot (a graph holds its tables'
        # addresses); a background build captured the new one's
        self._graphs = {k: g for k, g in self._graphs.items()
                        if k[0] == sid}
        # the match cache dies wholesale with its snapshot: within one
        # snapshot the main tables never change, and the overlay's rows
        # are kept exact by the selective drop + the delta version
        if self._match_cache is not None:
            self._match_cache.attach(sid)
        # replay churn that raced the build: journaled note_* calls are
        # idempotent against the fresh snapshot (worst case marks a filter
        # the build already captured as dirty — correct, just host-side
        # until the next rebuild)
        for entry in journal:
            if entry[0] == "route":
                self.note_route_change(entry[1], entry[2])
            else:
                self.note_member_change(entry[1], entry[2])
        self.node.metrics.inc("routing.device.rebuilds")

    def _reset_deltas(self) -> None:
        self._cluster_groups_cache = {}
        self.dirty_filters = set()
        self._dirty_ver += 1
        self._hostside_memo = None
        self.dirty_slots = set()
        self.new_slots_by_filter = {}
        self._delta_trie = HostTrie()
        self._delta_filter = {}
        self._delta_fid_of = {}
        self._next_delta_fid = 0
        self._built_deleted = set()
        # the fresh snapshot subsumes every overlay row (the clock is not
        # reset: handles pinned to an old version keep their view)
        self._overlay = None
        self._overlay_stale = False
        self._overlay_uncovered = 0
        self._fid_member_clock = {}
        self._cover_churn = 0   # the fresh snapshot re-detected covers

    def _compaction_reason(self) -> Optional[str]:
        """Why the current snapshot should recompile, or None. Overlay
        off: distinct stale entities (every delta filter included) past
        the threshold. Overlay on: delta filters serve on the card, so the
        rebuild is a rare compaction on overlay overflow, on the
        snapshot's delete-tombstone ratio, on new filters no built root
        covers past a budget (each erodes the covering reduction), or on
        membership churn of built filters and slots past the
        threshold."""
        if self._built is None:
            return None
        if not self.delta_overlay:
            return "churn" if self.staleness() >= self.rebuild_threshold \
                else None
        if len(self._delta_filter) > _OVERLAY_MAX:
            return "overflow"
        dead = len(self._built_deleted)
        if dead >= 64 and 2 * dead >= len(self._built.fid_filter):
            return "tombstones"
        if self._cover_churn >= 64:
            return "covering"
        if self.staleness() >= self.rebuild_threshold:
            return "churn"
        return None

    def _count_compaction(self, reason: str) -> None:
        m = self.node.metrics
        m.inc("routing.device.compactions")
        m.inc(f"routing.device.compaction.{reason}")

    # ---- background rebuild (double-buffered) ---------------------------
    def _fail(self, e: BaseException) -> None:
        """A device failure off the serving path (a background build,
        warm-up or graph capture): on the card it is kept and raised to
        every later batch; on the CPU the caller's fallback stands."""
        if self.fail_on_device_error and self.failed is None:
            self.failed = e

    def _check_failed(self) -> None:
        if self.failed is not None:
            raise RuntimeError("the device route engine failed") \
                from self.failed

    def poll_rebuild(self) -> None:
        """The one rebuild policy, called on the batch cadence: a small
        first build runs inline; a big first build or a compaction trigger
        runs double-buffered in the background. Under supervision the
        supervisor's tick rides the same cadence, an open snapshot_swap
        breaker holds the first build off, and a first build's contained
        failure is noted against that domain (serving stays on the host
        until the breaker's probe re-admits builds)."""
        self._check_failed()
        sup = self.sup
        if sup is not None:
            sup.poll()
        if self._building:
            return
        if self._built is None:
            n = len(self.router.exact) + len(self.router.wildcards)
            if n == 0:
                return
            if sup is not None and not sup.rebuild_enabled():
                return      # swap breaker open: host-route until probed
            if n <= 4096 or not self.maybe_background_rebuild():
                try:
                    self.rebuild()
                except Exception as e:
                    if sup is None \
                            or not contained(e, self.fail_on_device_error):
                        raise
                    sup.note_fault("snapshot_swap", e)
                    self.node.metrics.inc("routing.device.rebuild_failed")
        else:
            reason = self._compaction_reason()
            if reason is not None and self.maybe_background_rebuild():
                self._count_compaction(reason)

    def maybe_background_rebuild(self, executor=None) -> bool:
        """Kick a background rebuild when churn crossed the threshold (or
        no snapshot exists). Returns True when one is running/queued after
        the call. Requires a running loop; sync callers use rebuild()."""
        if self._building:
            return True
        if self.sup is not None and not self.sup.rebuild_enabled():
            # snapshot_swap breaker open: no rebuild attempts until the
            # half-open probe succeeds — the old snapshot and the host
            # deltas keep serving meanwhile
            return False
        if self._built is not None \
                and self._compaction_reason() is None:
            return False
        if self._built is None \
                and not (self.router.exact or self.router.wildcards):
            return False    # nothing to compile yet
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return False
        self._building = True
        self._journal = []
        self._rebuild_task = guard_task(
            loop.create_task(self._background_rebuild(executor)),
            "device-rebuild", self.node.metrics)
        return True

    async def _background_rebuild(self, executor=None) -> None:
        loop = asyncio.get_running_loop()
        try:
            t0 = time.perf_counter()
            if self._can_capture_incremental():
                capture = await self._capture_state_incremental_async()
            else:
                capture = await self._capture_state_async()
            self._observe_rebuild("capture", t0)
            t0 = time.perf_counter()
            result = await loop.run_in_executor(
                executor, self._build_from_capture, capture)
            self._observe_rebuild("build", t0)
            if result is not None:
                t0 = time.perf_counter()
                await loop.run_in_executor(executor, self._warm_compile,
                                           result)
                self._observe_rebuild("warm", t0)
            self._pending_swap = (result,)   # 1-tuple: result may be None
            self._try_swap()
        except Exception as e:
            log.exception("background snapshot rebuild failed")
            self._journal = None
            self._building = False
            self._pending_swap = None
            self.node.metrics.inc("routing.device.rebuild_failed")
            # on the CPU serving stays on the old snapshot + host deltas
            self._fail(e)

    @staticmethod
    def _class_key(sig, Wp, Bp, Bm=None, dC=None, P=None) -> tuple:
        """The one warm-class key layout: (sig, W, Bp[, Bm][, dN][, cP]) —
        the dedup miss class, the overlay row class and the payload class
        are each optional program dimensions."""
        return ((sig, Wp, Bp)
                + ((Bm,) if Bm is not None else ())
                + ((f"d{dC}",) if dC is not None else ())
                + ((f"c{P}",) if P is not None else ()))

    @staticmethod
    def _graph_key(b, cls, strat) -> tuple:
        """A captured window: (snapshot, W, Bp, Bm, dC, P, strategy)."""
        return (b.sid, *cls, strat)

    def _strategy(self) -> int:
        return STRATEGIES.get(self.broker.shared_strategy,
                              STRATEGY_ROUND_ROBIN)

    def _pad_arrays(self, b, cls) -> tuple:
        """All-pad host inputs of class `cls` = (Wp, Bp, Bm, dC, P), in the
        program's order: match nothing, advance nothing."""
        Wp, Bp, Bm, dC, _P = cls
        L = self.max_levels
        mh = np.zeros((Wp, Bp), np.int32)
        if Bm is None:
            return (np.zeros((Wp, Bp, L), np.int32),
                    np.zeros((Wp, Bp), np.int32),
                    np.zeros((Wp, Bp), bool), mh)
        out = (np.full((Bm, L), I.PAD, np.int32), np.zeros(Bm, np.int32),
               np.zeros(Bm, bool), np.full((Bp, b.match_width), -1, np.int32),
               np.zeros(Bp, np.int32), np.zeros(Bp, bool))
        if dC is not None:
            out += (np.full((Bp, _DELTA_MATCH_CAP), -1, np.int32),
                    np.zeros(Bp, np.int32), np.zeros(Bp, bool))
        return out + (np.full(Bm, Bp, np.int32),   # pad = Bp: the sink
                      np.zeros((Wp, Bp), np.int32), mh)

    def _warm_dispatch(self, b, tables, cursors, cls) -> None:
        """One dispatch of class `cls` = (Wp, Bp, Bm, dC, P) over an
        all-pad window with throwaway cursors (and an empty overlay of
        the class's row capacity), run to completion on the warm stream:
        it builds the kernels at first use and sizes the allocator for
        the class. A shape-hash window on the card is then captured as a
        CUDA graph for the serving dispatches. Its kernel launches are
        recorded, not counted: they serve no traffic."""
        with self._cuda_lock, D.recording_launches():
            self._warm_dispatch_locked(b, tables, cursors, cls)

    def _warm_dispatch_locked(self, b, tables, cursors, cls) -> None:
        dev = self.device
        dC = cls[3]
        arrays = self._pad_arrays(b, cls)
        ins = [torch.from_numpy(a).to(dev) for a in arrays]
        delta = None if dC is None else to_device(
            empty_delta_tables(dC, self.max_levels, _DELTA_FAN_PER_ROW), dev)
        cur = torch.zeros_like(cursors)
        strat = self._strategy()
        self._program(b.backend, tables, delta, cur, ins, strat, cls)
        if b.backend == "shapes" and self._warm_stream is not None:
            self._warm_stream.synchronize()
            t0 = time.perf_counter()
            gr = self._capture(b, tables, cur, ins, delta, cls, strat)
            # a graph's first replay (its upload to the card) and the
            # first pinned host blocks of a size are slow — 15.7 ms of
            # dispatch for the first window one run served (PERF.md):
            # paid here, not by a window that serves traffic, with as
            # many pinned sets of the inputs and readback as serving
            # keeps in flight (held together, so the host allocator
            # caches that many)
            self._replay(gr, arrays, cur, None)
            held = [self._pinned(t) for t in
                    (*self._plane_list(*gr.planes, counts=True), *gr.inputs)
                    for _ in range(_PINNED_SETS)]
            self._warm_stream.synchronize()
            del held
            self._note_capture(gr, time.perf_counter() - t0)
        if self._warm_stream is not None:
            self._warm_stream.synchronize()

    def _capture(self, b, tables, cursors, inputs, delta, cls,
                 strat: int) -> _Graph:
        """Capture the shape-hash window of class `cls` over the static
        `inputs`, `cursors` and overlay `delta` as a CUDA graph for the
        serving dispatches. A failed capture raises."""
        graph = torch.cuda.CUDAGraph()
        # a stream no other work is enqueued on (_capture_stream), and
        # the capture API rather than torch.cuda.graph, whose entry also
        # synchronizes the card and empties the memory caches under the
        # serving stream's feet
        stream = _capture_stream(self.device)
        if stream.cuda_stream in (self._stream.cuda_stream,
                                  self._warm_stream.cuda_stream):
            raise RuntimeError("the capture stream is the engine's own: "
                               "the card has one stream priority level")
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with D.recording_launches() as launches, torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = self._program("shapes", tables, delta, cursors,
                                    inputs, strat, cls)
            finally:
                graph.capture_end()
        gr = self._graphs[self._graph_key(b, cls, strat)] = _Graph(
            graph, inputs, cursors, delta, self._unwrap(out), launches,
            self._class_label(cls))
        return gr

    @staticmethod
    def _class_label(cls) -> str:
        """A window class (Wp, Bp, Bm, dC, P) as the telemetry labels it:
        W8xB1024, with mB{Bm}, d{dC} and c{P} where they apply."""
        Wp, Bp, Bm, dC, P = cls
        return (f"W{Wp}xB{Bp}" + (f"mB{Bm}" if Bm is not None else "")
                + (f"d{dC}" if dC is not None else "")
                + (f"c{P}" if P is not None else ""))

    def _note_capture(self, gr: _Graph, seconds: float) -> None:
        """Account one capture: the engine's counts, the graph-class
        registry, the graph's static buffers in the ledger
        (``pipeline_buffers``, owner = the class label) and the
        telemetry's capture accounting."""
        self.captures += 1
        self.capture_s += seconds
        row = self._graph_rows.setdefault(
            gr.label, {"captures": 0, "capture_s": 0.0, "replays": 0})
        row["captures"] += 1
        row["capture_s"] += seconds
        self._hold("pipeline_buffers",
                   (gr.inputs, gr.cursors, gr.delta, gr.planes), gr.label)
        if self.tele is not None:
            self.tele.note_capture(gr.label, seconds)

    def graph_registry(self) -> dict:
        """The graph-class registry the telemetry snapshot embeds: the
        graph classes held now and one row per class label ever captured
        (captures, capture seconds, replays, static-buffer bytes held
        now)."""
        led = self.ledger
        rows = {}
        for label, r in sorted(self._graph_rows.items()):
            rows[label] = {
                "captures": r["captures"],
                "capture_s": round(r["capture_s"], 4),
                "replays": r["replays"],
                "static_bytes": led.owner_bytes("pipeline_buffers", label)
                if led is not None else None}
        return {"graph_classes": len(self._graphs), "rows": rows}

    @staticmethod
    def _replay(gr, arrays, cursors, ov) -> None:
        """One replay of a captured window over `arrays` (the window's
        host inputs, staged through pinned memory), starting from
        `cursors`, with overlay version `ov` copied into the graph's
        overlay buffers when it is not already there — on the engine
        stream, behind the previous replay, so a window in flight keeps
        the version it ran with. The launches it makes are counted."""
        for dst, a in zip(gr.inputs, arrays):
            dst.copy_(torch.from_numpy(a).pin_memory(), non_blocking=True)
        gr.cursors.copy_(cursors)
        if ov is not None and gr.dver is not ov:
            for dst, src in zip(gr.delta, ov.dev):
                dst.copy_(src)
            gr.dver = ov
        gr.graph.replay()
        for name, shape in gr.launches:
            D.count_launch(name, shape)

    @staticmethod
    def _pinned(t: torch.Tensor) -> torch.Tensor:
        """`t` on its way into pinned host memory (in stream order)."""
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
            t, non_blocking=True)

    def _note_warm(self, b, cls) -> None:
        """Class `cls` of snapshot `b` has dispatched once. On the card a
        shape-hash class is warm only once its graph is captured: its
        eager window costs hundreds of launches where the replay costs
        one."""
        if b.backend == "shapes" and self._warm_stream is not None \
                and self._graph_key(b, cls, self._strategy()) \
                not in self._graphs:
            return
        self._warm_classes.add(self._class_key(b.sig, *cls))

    def _on(self, stream):
        return torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()

    def _payload_variants(self, b, cls) -> list:
        """Class `cls` with the dense readback and with each payload class
        the chooser can pick for its Bp (none with ``compact_readback``
        off)."""
        Wp, Bp, Bm, dC, _P = cls
        if not self.compact_readback:
            return [(Wp, Bp, Bm, dC, None)]
        dense = self._dense_msg_entries(b)
        return [(Wp, Bp, Bm, dC, None)] + [
            (Wp, Bp, Bm, dC, m * Bp) for m in self._PAYLOAD_MULTS
            if m < dense]

    def _std_classes(self, b) -> list:
        """The shape-hash classes warmed ahead of traffic: every standard
        (W, Bp) — and any oversized Bp the batcher asked for — with the
        dense readback and with each payload class."""
        out = []
        for Wp, Bp in self._STD_CLASSES + tuple(sorted(self._extra_classes)):
            out += self._payload_variants(b, (Wp, Bp, None, None, None))
        return out

    def _warm_compile(self, result) -> None:
        """Warm the standard window classes for a fresh snapshot before it
        swaps in, so neither the swap nor the first window at a class
        stalls serving."""
        b, tables, cursors = result
        if b.backend == "shapes":
            classes = self._std_classes(b)
        else:       # the trie backend never fuses, nor warms ahead
            classes = [(1, Bp, None, None, None)
                       for W, Bp in self._STD_CLASSES if W == 1]
        with self._on(self._warm_stream):
            for cls in classes:
                self._warm_dispatch(b, tables, cursors, cls)
                if b.backend == "shapes":
                    self._note_warm(b, cls)

    def _try_swap(self) -> None:
        """Apply a finished background build if no dispatch is in flight
        (handles pin the snapshot they were dispatched against)."""
        if not self._building or self._pending_swap is None \
                or self._outstanding > 0:
            return
        (result,) = self._pending_swap
        journal = self._journal or ()
        self._pending_swap = None
        self._journal = None
        self._building = False
        t0 = time.perf_counter()
        sup = self.sup
        try:
            self._apply_build(result, journal)
        except Exception as e:
            if sup is None or not contained(e, self.fail_on_device_error):
                raise
            # a contained swap fault: the old snapshot keeps serving (its
            # dirty/delta tracking ran live during the build, so dropping
            # the failed result loses nothing); the breaker gates further
            # rebuild attempts until a probe
            sup.note_fault("snapshot_swap", e)
            self.node.metrics.inc("routing.device.rebuild_failed")
        else:
            if sup is not None:
                sup.note_ok("snapshot_swap")
        self._observe_rebuild("swap", t0)

    # ---- supervision probes (run by a half-open breaker on an executor
    #      thread, off the serving path) ----------------------------------
    def _probed(self, probe: Callable[[], None]) -> Callable[[], None]:
        """A probe as the supervisor runs it: its failure keeps the
        breaker open, and one the ladder does not contain on the card also
        fails the engine, so a kernel broken while the ladder sat on the
        host raises to the next window instead of keeping it there."""
        def run() -> None:
            try:
                probe()
            except Exception as e:
                self._note_device_error(e)
                raise
        return run

    def _probe_dispatch(self) -> None:
        """End-to-end health check of the dispatch stage: the plain window
        of the smallest standard class over an all-pad batch against the
        live tables, eagerly on the engine stream under the device lock
        (never a graph's static inputs, never beside a capture), from a
        throwaway cursor buffer. It matches nothing and advances nothing.
        Its kernel launches are counted, and kept in
        ``probe_launches``."""
        b, tables, cursors = self._built, self._tables, self._cursors
        if b is None or tables is None:
            return      # nothing to probe: vacuous health
        cls = (1, self._STD_CLASSES[0][1], None, None, None)
        with self._cuda_lock, self._on(self._stream), \
                D.recording_launches() as calls:
            ins = [torch.from_numpy(a).to(self.device)
                   for a in self._pad_arrays(b, cls)]
            res = self._unwrap(self._program(
                b.backend, tables, None, torch.zeros_like(cursors), ins,
                self._strategy(), cls))[0]
            res.match_counts.cpu()
        for name, shape in calls:
            D.count_launch(name, shape)
            self.probe_launches[name] = self.probe_launches.get(name, 0) + 1

    def _probe_materialize(self) -> None:
        """Health check of the readback stage: one small device→host
        transfer on the engine stream proves the link."""
        with self._cuda_lock, self._on(self._stream):
            torch.zeros(8, dtype=torch.int32, device=self.device).cpu()

    # ---- the serving path ----------------------------------------------
    def device_shared_active(self) -> bool:
        """Device picks serve every device-supported strategy, clustered
        or standalone: the snapshot holds the cluster-wide membership with
        remote members as forwardable refs."""
        return self.broker.shared_strategy in STRATEGIES

    def _host_shared_dispatch(self, f: str, gname: str, msg) -> bool:
        """One group's host-side dispatch: cluster-wide pick under a
        cluster, local strategy pick standalone."""
        broker = self.broker
        if broker.cluster is not None:
            return broker.cluster._dispatch_one_group(broker, f, gname,
                                                      msg)
        g = broker.shared.get(f, {}).get(gname)
        return bool(g and g.members
                    and broker._shared_pick_deliver(gname, f, g, msg))

    def prepare(self, msgs: list[Message], gate_cold: bool = True):
        """Stage 1 (event loop): encode ONE micro-batch (window of 1)."""
        return self.prepare_window([msgs], gate_cold=gate_cold)

    def max_fuse(self) -> int:
        """How many batches the serving path may fuse per dispatch right
        now: 1 until the CURRENT snapshot's fused window class is warm,
        then the largest class. Trie-backend snapshots never fuse."""
        W, Bp = self._STD_CLASSES[-1]
        if self._built is None or self._built.backend != "shapes" \
                or (self._cur_sig, W, Bp) not in self._warm_classes:
            return 1
        return W

    def _batch_class(self, n_msgs: int) -> int:
        """Quantize a batch size onto the standard Bp ladder, or the next
        pow2 beyond it."""
        for _w, Bp in self._STD_CLASSES:
            if _w == 1 and n_msgs <= Bp:
                return Bp
        return _next_pow2(n_msgs)

    def batch_class_warm(self, n_msgs: int) -> bool:
        """True when a single batch of n_msgs would dispatch into an
        already-warm (1, Bp) class for the CURRENT snapshot — the batcher
        routes host-side (and kicks the background warm) otherwise."""
        self._check_failed()
        if self._built is None:
            return False
        if self._built.backend != "shapes":
            # the trie backend has no background warm of every class;
            # its first use warms in-path, as in the reference
            return True
        Bp = self._batch_class(n_msgs)
        if (self._cur_sig, 1, Bp) in self._warm_classes:
            return True
        if Bp > self._STD_CLASSES[-1][1]:
            # oversized batch class (max_publish_batch > 1024): queue it
            # for the background warm, or it would be locked out forever
            self._extra_classes.add((1, Bp))
        return False

    def _dense_msg_entries(self, b=None) -> int:
        """Dense readback cost per message lane in int32-equivalent
        entries: match plane + fan rows/opts + shared slot/row/opts."""
        b = b or self._built
        return b.match_width + 2 * self.fanout_cap + 3 * self.slot_cap

    def _choose_payload_cap(self, Bp: int) -> Optional[int]:
        """Payload class for a (·, Bp) dispatch, or None for dense: a
        peak-biased EWMA of recent per-window-row entry totals with 2x
        headroom, quantized onto the _PAYLOAD_MULTS * Bp ladder. A window
        that still outgrows its class reads the dense planes of the SAME
        dispatch (row_overflow), so an undershoot costs bytes, never
        correctness. None when ``compact_readback`` is off."""
        if not self.compact_readback or self._built is None:
            return None
        dense = self._dense_msg_entries()
        mults = [m for m in self._PAYLOAD_MULTS if m < dense]
        if not mults:
            return None         # tiny caps: nothing to compact away
        ew = self._pay_ewma.get(Bp)
        if ew is None:
            # no traffic measured at this class yet: start mid-ladder
            return mults[min(1, len(mults) - 1)] * Bp
        for m in mults:
            if m * Bp >= 2.0 * ew:
                return m * Bp
        return None             # sustained heavy fan-out: dense wins

    def _note_payload(self, Bp: int, totals: np.ndarray) -> None:
        """Feed the EWMA from one window's actual per-row entry totals:
        adopt growth immediately, decay shrinkage slowly."""
        s = float(totals.max()) if totals.size else 0.0
        ew = self._pay_ewma.get(Bp)
        self._pay_ewma[Bp] = s if (ew is None or s > ew) \
            else 0.8 * ew + 0.2 * s

    def _gate_compact(self, Wp: int, Bp: int, plan, gate_cold: bool,
                      ov: Optional[_Overlay] = None) -> Optional[int]:
        """Choose + warm-gate the payload class for one dispatch. Returns
        the class, or None to read back dense (unprofitable, or the class
        is cold on the serving path: it dispatches dense while the
        background warm brings the class online)."""
        pcap = self._choose_payload_cap(Bp)
        if pcap is None:
            return None
        Bm = plan.Bm if plan is not None else None
        dC = ov.cap if ov is not None else None
        if gate_cold and self._class_key(self._cur_sig, Wp, Bp, Bm, dC,
                                         pcap) not in self._warm_classes:
            self._wanted.add((Wp, Bp, Bm, dC, pcap))
            self._kick_class_warm()
            self.node.metrics.inc("routing.device.cold_compact_class")
            return None
        return pcap

    def _kick_class_warm(self) -> None:
        """Warm every standard (W, Bp) class and every class the serving
        path asked for (cached, overlay and compact) that the CURRENT
        snapshot is missing, off the serving path (an executor thread on
        the warm stream). On the card a wanted class is captured with
        each of its payload classes."""
        if self._fuse_warm_task is not None or self._built is None:
            return
        b = self._built
        wanted = set(self._wanted)
        if b.backend == "shapes":
            wanted.update(self._std_classes(b))
            if self._warm_stream is not None:
                for c in list(wanted):
                    if c[4] is None:
                        wanted.update(self._payload_variants(b, c))
        missing = [c for c in sorted(wanted, key=lambda c: tuple(
                       x or 0 for x in c))
                   if self._class_key(b.sig, *c) not in self._warm_classes]
        if not missing:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        tables, cursors = self._tables, self._cursors

        def warm():
            with self._on(self._warm_stream):
                for cls in missing:
                    if self._built is not b:
                        return      # a newer snapshot swapped in
                    self._warm_dispatch(b, tables, cursors, cls)
                    self._note_warm(b, cls)

        async def run():
            try:
                await loop.run_in_executor(None, warm)
            except Exception as e:  # noqa: BLE001 — on the CPU the
                # classes stay cold (host-routed) until the next attempt
                log.exception("class warm failed")
                self._fail(e)
            finally:
                self._fuse_warm_task = None

        self._fuse_warm_task = guard_task(loop.create_task(run()),
                                          "device-class-warm",
                                          self.node.metrics)

    # ---- delta overlay ---------------------------------------------------
    @staticmethod
    def _overlay_class(n: int) -> int:
        for c in _DELTA_CLASSES:
            if n <= c:
                return c
        return _DELTA_CLASSES[-1]

    @staticmethod
    def _delta_payload_cap(Bp: int) -> int:
        """The overlay CSR's payload class, a fixed multiple of Bp (no
        warm-class dimension of its own): most lanes match no
        post-snapshot filter, and a window that outgrows it reads the
        dense overlay planes instead."""
        return max(64, Bp)

    def _overlay_sync(self) -> None:
        """Rebuild the small overlay table from the live delta dicts and
        upload it as a fresh immutable version: a few hundred rows of
        numpy, safe on the loop. In-flight handles keep the version they
        dispatched with, and per-fid membership staleness is judged
        against the pinned version's clock stamp at consume. On the card
        the upload is a pinned copy on the engine stream, ordered before
        every later dispatch; a failed upload raises.

        Under supervision this is the overlay_apply fault domain: a
        contained failure leaves the overlay stale — its filters serve
        through the host delta trie (``routing.device.host_delta``) —
        while the breaker opens toward rung 1."""
        if not self.delta_overlay or not self._overlay_stale:
            return
        sup = self.sup
        try:
            if sup is not None:
                sup.fire("overlay_apply")
            self._overlay_sync_inner()
        except Exception as e:
            if sup is None or not contained(e, self.fail_on_device_error):
                raise
            sup.note_fault("overlay_apply", e)
        else:
            if sup is not None:
                sup.note_ok("overlay_apply")

    def _overlay_sync_inner(self) -> None:
        """The overlay's rebuild and upload (see ``_overlay_sync``)."""
        t0 = time.perf_counter()
        live = sorted(self._delta_filter.items())   # fid order = age
        entries = []
        fid_set = set()
        row_of: dict[int, int] = {}
        seg_of: dict[int, int] = {}
        hostfan: set[int] = set()
        for fid, f in live:
            if len(entries) >= _OVERLAY_MAX:
                break       # overflow: the rest route on the host until
                            # the compaction this state has triggered
            words = self._enc_filter(f)
            if len(words) > self.max_levels:
                continue    # too deep for the device planes: host path
            fan = []
            subs = self.broker.subs.get(f)
            host_side = False
            if subs:
                if len(subs) > _DELTA_FAN_PER_ROW:
                    host_side = True    # oversized fan-out: match on the
                else:                   # card, deliver via the host dict
                    for sid, opts in subs.items():
                        if _is_rich(opts):
                            host_side = True
                            break
                        fan.append((sid, _pack_opts(opts)))
            if host_side:
                fan = []
                hostfan.add(fid)
            row_of[fid] = len(entries)
            seg_of[fid] = len(fan)
            fid_set.add(fid)
            entries.append((words, fid, fan))
        self._overlay_uncovered = len(live) - len(fid_set)
        if not entries:
            self._overlay = None
            self._overlay_stale = False
            return
        cap = self._overlay_class(len(entries))
        dt = build_delta_tables(entries, row_cap=cap,
                                level_cap=self.max_levels,
                                fan_per_row=_DELTA_FAN_PER_ROW)
        keep = None
        if self._stream is not None:
            with self._cuda_lock, self._on(self._stream):
                keep = [torch.from_numpy(a).pin_memory() for a in dt]
                dev = DeltaTables(*[t.to(self.device, non_blocking=True)
                                    for t in keep])
        else:
            dev = to_device(dt, self.device)
        # each version is an allocation of its own: handles pin theirs
        self._hold("delta_overlay", dev, f"v{self._overlay_clock}")
        self._overlay = _Overlay(dev, frozenset(fid_set), row_of, seg_of,
                                 hostfan, self._overlay_clock, cap,
                                 len(entries), keep)
        self._overlay_stale = False
        self.node.metrics.inc("routing.device.delta_applies")
        self._observe_rebuild("delta_apply", t0)

    def _gate_delta(self, Wp: int, Bp: int,
                    gate_cold: bool) -> Optional[_Overlay]:
        """Choose + warm-gate the overlay for one dispatch. Returns the
        pinned _Overlay, or None to dispatch WITHOUT it (overlay off or
        empty, or its class cold on the serving path — the host delta
        trie serves meanwhile, counted by routing.device.host_delta)."""
        if not self.delta_overlay:
            return None
        self._overlay_sync()
        ov = self._overlay
        if ov is None:
            return None
        if gate_cold and self._class_key(self._cur_sig, Wp, Bp, dC=ov.cap) \
                not in self._warm_classes:
            self._wanted.add((Wp, Bp, None, ov.cap, None))
            self._kick_class_warm()
            self.node.metrics.inc("routing.device.cold_delta_class")
            return None
        return ov

    def _delta_pending(self, ov: Optional[_Overlay]) -> bool:
        """True when some live delta filter is NOT served by `ov` —
        consume then walks the host delta trie for the remainder and the
        vectorized fast path stands down."""
        if not self._delta_filter:
            return False
        if ov is None:
            return True
        return not self._delta_filter.keys() <= ov.fid_set

    # ---- dedup and the match cache ------------------------------------------
    def _plan_window(self, b, enc4, len4, dol4, gate_cold: bool,
                     ov: Optional[_Overlay] = None):
        """Dedup + match-cache analysis for one encoded window
        (``emqx_tpu/broker/device_engine.py:1906``).

        Collapses the [Wp, Bp] lanes to unique encoded topics (the padding
        lanes share one sentinel key), looks each up in the
        snapshot-keyed cache, and compacts the rest into a miss sub-batch
        whose size is quantized onto the batch-class ladder.

        Returns (plan, cache_info): `plan` is the cached dispatch's input
        set (None = dispatch the plain program), `cache_info` the
        post-readback insert list (kept when the plan is rejected: the
        plain path's readback still seeds the cache)."""
        Wp, Bp, L = enc4.shape
        if b.backend != "shapes" and Wp > 1:
            # a multi-batch trie window runs sequential steps: no plan
            return None, None
        if Wp == 1 and Bp <= self._STD_CLASSES[0][1]:
            # the smallest class can never engage (Bm floors at it)
            return None, None
        n_lanes = Wp * Bp
        encf = enc4.reshape(n_lanes, L)
        lenf = len4.reshape(n_lanes)
        dolf = dol4.reshape(n_lanes)
        keys_v = _topic_keys(encf, lenf, dolf)
        uniq, first_idx, inv = np.unique(keys_v, return_index=True,
                                         return_inverse=True)
        Bu = len(uniq)
        pad_u = lenf[first_idx] == 0          # [Bu] the sentinel pad lane
        uniq_real = Bu - int(pad_u.sum())
        if Bu > Bp:
            # more diverse than the Bp-wide unique arrays hold
            return None, None
        cache = self._match_cache
        keys = [None if pad_u[u] else uniq[u].tobytes()
                for u in range(Bu)]
        # the lookup runs before the engage decision (the miss count IS
        # the decision input), and misses seed the cache even from
        # plain-dispatched windows
        hit_rows: list = [None] * Bu
        miss_u: list[int] = []
        inserts: list[tuple] = []
        if cache is not None:
            rows = cache.get_many(b.sid,
                                  [k for k in keys if k is not None])
            it = iter(rows)
            for u, k in enumerate(keys):
                if k is None:
                    continue
                row = next(it)
                if row is not None and ov is not None:
                    # an overlay-fused dispatch needs the row's overlay
                    # triple, with every fid in the pinned table
                    if len(row) < 6 or row[3] is None or not all(
                            int(df) in ov.row_of for df in row[3]
                            if df >= 0):
                        row = None
                if row is None:
                    miss_u.append(u)
                    inserts.append((k, int(first_idx[u])))
                else:
                    hit_rows[u] = row
        else:
            miss_u = [u for u in range(Bu) if keys[u] is not None]
        info = _CacheInfo(
            b.sid, inserts,
            cache.delta_version if cache is not None
            and self.delta_overlay else None) if inserts else None
        n_miss = len(miss_u)
        n_hit = uniq_real - n_miss
        Bm = self._batch_class(max(1, n_miss))
        # engage only when the dedup removes real match work: the miss
        # class is smaller than the batch class, or the window is fused
        if not (Bm < Bp or Wp > 1):
            return None, info
        dC = ov.cap if ov is not None else None
        if gate_cold and self._class_key(self._cur_sig, Wp, Bp, Bm, dC) \
                not in self._warm_classes:
            # a cold cached class dispatches the warm plain program while
            # the background warm brings it online
            self._wanted.add((Wp, Bp, Bm, dC, None))
            self._kick_class_warm()
            self.node.metrics.inc("routing.device.cold_cached_class")
            return None, info
        base_m = np.full((Bp, b.match_width), -1, np.int32)
        base_c = np.zeros(Bp, np.int32)
        base_o = np.zeros(Bp, bool)
        base_dm = base_dc = base_do = None
        if ov is not None:
            base_dm = np.full((Bp, _DELTA_MATCH_CAP), -1, np.int32)
            base_dc = np.zeros(Bp, np.int32)
            base_do = np.zeros(Bp, bool)
        for u, row in enumerate(hit_rows):
            if row is not None:
                base_m[u] = row[0]
                base_c[u] = row[1]
                base_o[u] = row[2]
                if ov is not None:
                    # cached overlay triples are in fid space (stable
                    # across overlay row reassignment): mapped onto the
                    # pinned table's rows for the device-side merge
                    for j, df in enumerate(row[3]):
                        if df >= 0:
                            base_dm[u, j] = ov.row_of[int(df)]
                    base_dc[u] = row[4]
                    base_do[u] = row[5]
        miss_topics = np.full((Bm, L), I.PAD, np.int32)
        miss_lens = np.zeros(Bm, np.int32)
        miss_dollar = np.zeros(Bm, bool)
        # pad = Bp, past the [Bp]-wide base arrays: the merge's sink row.
        # NOT -1, which the reference wraps onto unique row Bp-1
        miss_pos = np.full(Bm, Bp, np.int32)
        if n_miss:
            src = first_idx[miss_u]
            miss_topics[:n_miss] = encf[src]
            miss_lens[:n_miss] = lenf[src]
            miss_dollar[:n_miss] = dolf[src]
            miss_pos[:n_miss] = miss_u
        plan = _CachePlan(miss_topics, miss_lens, miss_dollar, base_m,
                          base_c, base_o, miss_pos,
                          inv.reshape(Wp, Bp).astype(np.int32), Bm,
                          n_miss, n_hit)
        plan.base_dm, plan.base_dc, plan.base_do = base_dm, base_dc, \
            base_do
        # counted only for engaged plans: the exported hit rate and dedup
        # ratio describe match work removed from dispatches
        m = self.node.metrics
        real = int((lenf > 0).sum())
        m.inc("routing.device.dedup_lanes", real)
        m.inc("routing.device.dedup_unique", uniq_real)
        if self.tele is not None and real:
            self.tele.record_dedup(real, uniq_real)
        if cache is not None:
            cache.count_lookups(n_hit, n_miss)
        return plan, info

    def preencode_burst(self, topics: list) -> None:
        """Encode a read burst's unique topics in ONE native call (split,
        hash and id probe in C), memoized for prepare_window's encode.
        The memo is replaced per burst and read only while the intern
        table's length is unchanged."""
        uniq = list(dict.fromkeys(topics))
        self._burst_enc = ({t: i for i, t in enumerate(uniq)},
                           *encode_topics_str(self.intern, uniq,
                                              self.max_levels),
                           len(self.intern))

    def _encode_publish_batch(self, topics: list):
        """One batch's topic encode: a gather from the burst memo when
        every topic was pre-encoded under the current intern length, else
        encode_topics_str (the same outputs either way: the memo is a
        cache of that call)."""
        be = self._burst_enc
        if be is not None and be[5] == len(self.intern):
            idx_map, enc, lens, dollar, too_long = be[:5]
            idxs = [idx_map.get(t, -1) for t in topics]
            if -1 not in idxs:
                return enc[idxs], lens[idxs], dollar[idxs], too_long[idxs]
        return encode_topics_str(self.intern, topics, self.max_levels)

    def prepare_window(self, lives: list[list[Message]],
                       gate_cold: bool = True):
        """Stage 1 (event loop): encode 1..W micro-batches as one fused
        dispatch window, and with dedup on compact it to unique topics and
        match-cache hits (_plan_window), so the dispatch matches only the
        miss lanes. `gate_cold=False` (sync callers) lets a cold class run
        in-path instead of the warm plain program.

        Returns a _Handle, or None when the engine has no snapshot to
        serve (the caller routes host-side; a background rebuild may be
        warming up)."""
        self.poll_rebuild()
        if self._built is None or not lives:
            return None
        t0 = time.perf_counter()
        self._kick_class_warm()
        b = self._built
        subs = []
        encs = []
        Bp = 64
        for msgs in lives:
            enc, lens, dollar, too_long = self._encode_publish_batch(
                [m.topic for m in msgs])
            subs.append((msgs, too_long))
            encs.append((enc, lens, dollar))
            Bp = max(Bp, self._batch_class(len(msgs)))
        if len(lives) > 1:
            # fused windows run ONLY in the warmed (W, Bp) top standard
            # class: any other pair would start cold on the serving path
            Bp = max(Bp, self._STD_CLASSES[-1][1])
        for Wp in self._W_CLASSES:
            if len(lives) <= Wp:
                break
        else:
            Wp = _next_pow2(len(lives))
        enc4 = np.full((Wp, Bp, self.max_levels), I.PAD, np.int32)
        len4 = np.zeros((Wp, Bp), np.int32)
        dol4 = np.zeros((Wp, Bp), bool)
        for k, (enc, lens, dollar) in enumerate(encs):
            n = enc.shape[0]
            enc4[k, :n] = enc
            len4[k, :n] = lens
            dol4[k, :n] = dollar
        h = _Handle(subs, b, self.device_shared_active())
        h.enc = (enc4, len4, dol4)
        seq_trie = b.backend != "shapes" and Wp > 1
        # ladder rung 1: with the cache_insert or overlay_apply breaker
        # open the reuse layers stand down and this window dispatches the
        # PLAIN program (a class the warm-up captured; a cold one takes
        # the eager path and a background capture, never a capture here)
        degraded = self.sup is not None and not self.sup.reuse_enabled()
        if not seq_trie and not degraded:
            # the overlay for this dispatch (None: post-snapshot filters
            # route on the host). The rare multi-batch trie window runs
            # sequential steps and has no fused program to carry it.
            h.delta = self._gate_delta(Wp, Bp, gate_cold)
        if self.dedup and not degraded:
            h.plan, h.cache_info = self._plan_window(b, enc4, len4, dol4,
                                                     gate_cold, h.delta)
        if not degraded and not (seq_trie and h.plan is None):
            # CSR readback class for this dispatch (None = dense)
            h.pcap = self._gate_compact(Wp, Bp, h.plan, gate_cold, h.delta)
        self._outstanding += 1
        if self.ledger is not None:
            # the pin sentinel: this handle pins the snapshot until it
            # releases (with the lanes, when its plans complete)
            self.ledger.note_window()
            self.ledger.pin(id(h), h)
        self.node.metrics.inc("routing.device.windows")
        self.node.metrics.inc("routing.device.window_subs", len(lives))
        if b.cover is not None:
            # windows matched against the covering set, and the match
            # work saved: covered filters the root match never visited
            self.node.metrics.inc("pipeline.cover.windows")
            self.node.metrics.inc("pipeline.cover.filters_skipped",
                                  b.cover.n_covered)
        h.cost_s = self._stage("prepare", t0)
        self.node.metrics.inc("routing.device.messages",
                              sum(map(len, lives)))
        if self.tele is not None:
            # how much of the padded (Wp, Bp) class each dispatch fills
            for msgs in lives:
                self.tele.record_occupancy(f"b{Bp}", len(msgs) / Bp)
            if Wp > 1:
                self.tele.record_occupancy(f"w{Wp}", len(lives) / Wp)
        return h

    def _stage(self, name: str, t0: float) -> float:
        """Seconds since t0, also counted (in microseconds) under
        routing.device.<name>_us: where a window's host time goes."""
        dt = time.perf_counter() - t0
        self.node.metrics.inc(f"routing.device.{name}_us", int(dt * 1e6))
        return dt

    def _msg_hashes(self, msgs, strat_id) -> list[int]:
        if strat_id == STRATEGY_HASH_TOPIC:
            return [zlib.crc32(m.topic.encode()) & 0x7FFFFFFF
                    for m in msgs]
        if strat_id == STRATEGY_HASH_CLIENT:
            return [zlib.crc32((m.from_ or "").encode()) & 0x7FFFFFFF
                    for m in msgs]
        if strat_id == STRATEGY_ROUND_ROBIN:
            return [0] * len(msgs)
        return [(id(m) >> 4) & 0x7FFFFFFF for m in msgs]  # random

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _program(self, backend: str, tables, delta, cursors, ins, strat,
                 cls, *, match=None, scan=None):
        """Run the route program of class `cls` = (Wp, Bp, Bm, dC, P) on
        device inputs `ins` (the window's arrays in program order, see
        ``dispatch``): the plain window, with up to three optional fused
        dimensions — the dedup plan (Bm), the delta overlay (`delta`, row
        class dC) and the CSR readback (P). ``match`` and ``scan``
        override the kernel wrappers (the plain path)."""
        Wp, Bp, Bm, _dC, P = cls
        shapes = backend == "shapes"
        kw = dict(fanout_cap=self.fanout_cap, slot_cap=self.slot_cap)
        if scan is not None:
            kw["scan"] = scan
        if shapes:
            if match is not None:
                kw["match"] = match
        else:
            kw.update(frontier_cap=self.frontier_cap,
                      match_cap=self.match_cap)
            if Bm is None and delta is None and P is None:
                # plain trie window: sequential steps, stacked
                outs, cur = [], cursors
                for k in range(Wp):
                    r = RE.route_step(tables, cur, *(x[k] for x in ins),
                                      strat, **kw)
                    cur = r.new_cursors
                    outs.append(r)
                return RE.RouteResult(*[torch.stack(x) for x in zip(*outs)])
            # the other trie programs take one batch (Wp == 1)
            ins = (*ins[:-2], ins[-2][0], ins[-1][0]) if Bm is not None \
                else tuple(x[0] for x in ins)
        if delta is not None:
            kw.update(delta_match_cap=_DELTA_MATCH_CAP,
                      delta_fanout_cap=_DELTA_FANOUT_CAP)
            if P is not None:
                kw.update(payload_cap=P,
                          d_payload_cap=self._delta_payload_cap(Bp))
                fn = {(True, True): RE.route_window_delta_cached_compact,
                      (True, False): RE.route_window_delta_compact,
                      (False, True): RE.route_step_delta_cached_compact,
                      (False, False): RE.route_step_delta_compact}
            else:
                fn = {(True, True): RE.route_window_delta_cached,
                      (True, False): RE.route_window_delta,
                      (False, True): RE.route_step_delta_cached,
                      (False, False): RE.route_step_delta}
            return fn[shapes, Bm is not None](tables, delta, cursors, *ins,
                                              strat, **kw)
        if shapes:
            fn = RE.route_window_cached if Bm is not None \
                else RE.route_window
            return fn(tables, cursors, *ins, strat, payload_cap=P, **kw)
        if P is not None:
            fn = RE.route_step_cached_compact if Bm is not None \
                else RE.route_step_compact
            return fn(tables, cursors, *ins, strat, payload_cap=P, **kw)
        return RE.route_step_cached(tables, cursors, *ins, strat, **kw)

    @staticmethod
    def _unwrap(out) -> tuple:
        """(res [W, ...], compact, delta planes [W, B, ...], delta
        compact) of any program's result; absent parts are None."""
        if isinstance(out, RE.CompactDeltaRouteResult):
            return out.dres.res, out.compact, out.dres.dp, out.d_compact
        if isinstance(out, RE.DeltaRouteResult):
            return out.res, None, out.dp, None
        if isinstance(out, RE.CompactRouteResult):
            return out.res, out.compact, None, None
        if out.matches.dim() == 2:          # a single trie step
            out = RE.RouteResult(*[x[None] for x in out])
        return out, None, None, None

    def dispatch(self, h) -> None:
        """Stage 2: launch the route window on the card (on the loop; on
        an executor thread when the device is the CPU). The span lands on
        the flight recorder under the window's trace. Under an active
        device trace the launches run inside
        ``record_function("route_step#<trace id>")`` — graph replays
        included: the range is on the host, around the replay, so the
        card's timeline joins the recorder's Chrome dump on the id
        without the id entering the graph. A window with no trace (the
        recorder off) takes a private counter, as the reference's
        ``StepTraceAnnotation`` does."""
        t0 = time.perf_counter()
        ctx = contextlib.nullcontext()
        if self._profiler is not None:
            step = h.trace
            if not step:
                self._step_num += 1
                step = self._step_num
            ctx = torch.profiler.record_function(f"route_step#{step}")
        try:
            with ctx:
                self._dispatch_inner(h)
        except Exception as e:
            self._note_device_error(e)
            raise
        finally:
            if self.rec is not None and h.enc is not None:
                self._rec_span(
                    h.trace, "dispatch" if h.plan is None
                    else "dispatch_cached", t0, track="dispatch",
                    meta={"W": h.enc[0].shape[0], "B": h.enc[0].shape[1]})

    def _dispatch_inner(self, h) -> None:
        """The window's launches. The table/cursor pair is pinned once
        for the whole dispatch: a snapshot swap racing it can neither mix
        old and new tables nor have its cursors clobbered by a late write
        (the identity guard).
        A shape-hash window on the card replays its class's graph; a
        class without one (a sync caller's cold class) runs eagerly and
        is queued for capture off the serving path."""
        if self.sup is not None:
            # the dispatch injection point, before the device lock (a hang
            # must not hold it): an exception propagates to the batcher,
            # which notes the fault and replays the window on the host; a
            # hang is caught by its watchdog deadline
            self.sup.fire("dispatch")
        with self._cuda_lock, self._on(self._stream):
            t0 = time.perf_counter()
            if self._stream is not None:
                h.ev_start = torch.cuda.Event(enable_timing=True)
                h.ev_start.record(self._stream)
            tables, cursors = self._tables, self._cursors
            enc4, len4, dol4 = h.enc
            Wp, Bp = enc4.shape[0], enc4.shape[1]
            strat = self._strategy()
            msg_hash = np.zeros((Wp, Bp), np.int32)
            for k, (msgs, _t) in enumerate(h.subs):
                msg_hash[k, :len(msgs)] = self._msg_hashes(msgs, strat)
            p, P, ov = h.plan, h.pcap, h.delta
            h.cursors0 = cursors
            h.tables, h.strat = self._versioned(h.built, tables), strat
            h.cls = (Wp, Bp, p.Bm if p is not None else None,
                     ov.cap if ov is not None else None, P)
            if p is not None:
                h.arrays = (p.miss_topics, p.miss_lens, p.miss_dollar,
                            p.base_m, p.base_c, p.base_o) + (
                    (p.base_dm, p.base_dc, p.base_do)
                    if ov is not None else ()) + (p.miss_pos, p.inv,
                                                  msg_hash)
            else:
                h.arrays = (enc4, len4, dol4, msg_hash)
            gr = self._graphs.get(self._graph_key(h.built, h.cls, strat))
            if gr is not None:
                # the captured window: this window's inputs into its
                # static tensors, and one replay
                self._replay(gr, h.arrays, cursors, ov)
                res, cp, dp, dcp = gr.planes
                h.graphed = True
                self._graph_rows[gr.label]["replays"] += 1
            else:
                if h.built.backend == "shapes" and self._stream is not None:
                    # a class the traffic asked for without its graph:
                    # eager now, captured in the background for later
                    self.node.metrics.inc("routing.device.eager_windows")
                    self._wanted.add(h.cls)
                    self._kick_class_warm()
                ins = [self._h2d(a) for a in h.arrays]
                res, cp, dp, dcp = self._unwrap(self._program(
                    h.built.backend, h.tables, ov.dev if ov is not None
                    else None, cursors, ins, strat, h.cls))
                # the window's own output buffers, alive while in flight
                self._hold("pipeline_buffers", (res, cp, dp, dcp), "eager")
            if p is not None:
                self.node.metrics.inc("routing.device.cached_windows")
            if self._tables is tables:   # no swap raced this dispatch
                # a copy: a graph's outputs are rewritten by its next replay
                self._cursors = self._hold(
                    "snapshot_cursors", res.new_cursors[-1].clone(),
                    f"s{h.built.sid}")
            self._note_warm(h.built, h.cls)
            h.res, h.cres, h.dres, h.dcres = res, cp, dp, dcp
            if self._stream is not None:
                # start every plane materialize will read on its way into
                # pinned host memory; materialize waits on the event
                # behind them only (a graph's outputs must be copied
                # before its next replay rewrites them)
                h.host = [self._pinned(t) for t in self._plane_list(
                    res, cp, dp, dcp, self._wants_counts(h))]
                h.event = torch.cuda.Event(enable_timing=True)
                h.event.record(self._stream)
            h.launch_s = self._stage("dispatch", t0)
            h.cost_s += h.launch_s
            if self.tele is not None:
                self.tele.observe_stage(
                    "dispatch" if p is None else "dispatch_cached",
                    h.launch_s)

    def _wants_counts(self, h) -> bool:
        """A dense readback carries match_counts only when the cache has
        rows of this window to insert (consume never reads it)."""
        return h.cache_info is not None and self._match_cache is not None

    @staticmethod
    def _plane_list(res, cp, dp, dcp, counts: bool) -> list:
        """The planes a window's readback takes, in the order materialize
        reads them: the overlay's count and overflow planes and its CSR
        (or dense) planes; then the main CSR planes plus the
        overflow/occur planes, or the dense planes (with match_counts
        when the cache takes rows)."""
        out = []
        if dp is not None:
            out += [dp.counts, dp.moverflow, dp.overflow]
            out += [dcp.offsets, dcp.counts3, dcp.row_overflow, dcp.payload] \
                if dcp is not None else [dp.fids, dp.rows, dp.opts]
        if cp is not None:
            return out + [cp.offsets, cp.counts3, cp.row_overflow,
                          cp.payload, res.overflow, res.occur]
        out += [res.matches, res.rows, res.opts, res.shared_sids,
                res.shared_rows, res.shared_opts, res.overflow, res.occur]
        return out + ([res.match_counts] if counts else [])

    def _dense_again(self, h) -> tuple:
        """The dense (res, delta planes) of a window whose CSR payload
        overflowed. An eager dispatch still holds them; a replayed
        window's graph outputs may hold a later replay by now, so it runs
        again eagerly from the cursors, the overlay version and the cover
        append version it started with — the same planes, bit for bit."""
        if not h.graphed:
            return h.res, h.dres
        with self._cuda_lock, self._on(self._stream):
            ins = [self._h2d(a) for a in h.arrays]
            res, _cp, dp, _dcp = self._unwrap(self._program(
                h.built.backend, h.tables,
                h.delta.dev if h.delta is not None else None, h.cursors0,
                ins, h.strat, h.cls[:4] + (None,)))
            return res, dp

    def _read(self, planes) -> list:
        """Synchronous readback, ordered behind the dispatch stream."""
        with self._cuda_lock, self._on(self._stream):
            return [t.cpu().numpy() for t in planes]

    def _delta_cache_fields(self, h, lane: int, Bp: int) -> tuple:
        """Fields 3.. of a match-cache row under the overlay: (delta
        fids, delta count, MATCH-level delta overflow, encoded topic,
        len, is_dollar) — the overlay triple in fid space plus the topic
        encoding the delta-aware invalidation matches against. Empty with
        the overlay off (3-tuple rows)."""
        if not self.delta_overlay:
            return ()
        enc4, len4, dol4 = h.enc
        w, bb = divmod(lane, Bp)
        topic = (enc4[w, bb].copy(), int(len4[w, bb]), bool(dol4[w, bb]))
        nd = h.np_delta
        if nd is None:
            if self._delta_filter:
                # the overlay exists but this dispatch ran without it: the
                # topic's delta part is UNKNOWN — None keeps the main row
                # usable and the row ineligible as an overlay base
                return (None, 0, False) + topic
            dm = np.full(_DELTA_MATCH_CAP, -1, np.int32)
            return (dm, 0, False) + topic
        if isinstance(nd, _DeltaCsr):
            o = int(nd.off[w, bb])
            cm = int(nd.c3[w, bb, 0])
            dm = np.full(_DELTA_MATCH_CAP, -1, np.int32)
            dm[:cm] = nd.pay[w, o:o + cm]
        else:
            dm = nd.fids[w, bb].copy()
        return (dm, int(nd.counts[w, bb]), bool(nd.moverflow[w, bb])) \
            + topic

    def materialize(self, h) -> None:
        """Stage 3 (executor thread): device→host readback. Every field is
        [W, ...] (window-stacked). With a payload class the transfer is
        the CSR planes plus the small overflow/occur planes; a window
        whose entries outgrew its class reads the dense planes instead
        (_dense_again), and likewise for the overlay's CSR. Also the
        match-cache population point: the rows of this window's missed
        unique topics come out of the readback consume needs anyway.

        Under supervision the materialize injection point comes first: an
        exception propagates to the batcher (the window replays), a hang
        is caught by its watchdog, and "corrupt" truncates the host views
        (``_corrupt_readback``) so the consume fails as a wrong-shape
        readback would."""
        corrupt = None
        if self.sup is not None:
            corrupt = self.sup.fire("materialize", corrupt_ok=True)
        try:
            self._materialize(h)
        except Exception as e:
            self._note_device_error(e)
            raise
        if corrupt:
            self._corrupt_readback(h)

    def _materialize(self, h) -> None:
        t0 = time.perf_counter()
        metrics = self.node.metrics
        try:
            counts = self._wants_counts(h)
            if h.host is not None:
                h.event.synchronize()
                planes = [t.numpy() for t in h.host]
            else:
                planes = self._read(self._plane_list(
                    h.res, h.cres, h.dres, h.dcres, counts))
            # bytes this window read back (the readback section)
            nb = sum(a.nbytes for a in planes)
            it = iter(planes)
            dense = None
            if h.dres is not None:
                dcnt, dmov, dovf = next(it), next(it), next(it)
                if h.dcres is not None:
                    off, c3, rovf, pay = (next(it) for _ in range(4))
                    if rovf.any():
                        metrics.inc("routing.device.delta_compact_overflow")
                        dense = self._dense_again(h)
                        dp = dense[1]
                        fids, rows, opts = self._read(
                            [dp.fids, dp.rows, dp.opts])
                        nb += fids.nbytes + rows.nbytes + opts.nbytes
                        h.np_delta = _DeltaRes(fids, dcnt, dmov, rows, opts,
                                               dovf)
                    else:
                        h.np_delta = _DeltaCsr(off, c3, pay, dcnt, dmov,
                                               dovf)
                else:
                    fids, rows, opts = next(it), next(it), next(it)
                    h.np_delta = _DeltaRes(fids, dcnt, dmov, rows, opts,
                                           dovf)
            info = h.cache_info if self._match_cache is not None else None
            if h.cres is not None:
                off, c3, rovf, pay, overflow, occur = (next(it)
                                                       for _ in range(6))
                # the EWMA learns from the offsets either way — on the
                # overflow fallback the totals are what resizes the class
                self._note_payload(off.shape[1] - 1, off[:, -1])
                if not rovf.any():
                    h.np_res = _CsrRes(off, c3, pay, overflow, occur)
                    if info is not None:
                        self._cache_from_csr(h, info, off, c3, pay,
                                             overflow)
                    self._note_readback(h, "compact", nb, t0)
                    return
                metrics.inc("routing.device.compact_overflow")
                res = (dense or self._dense_again(h))[0]
                planes = self._read(self._plane_list(res, None, None, None,
                                                     counts))
                nb += sum(a.nbytes for a in planes)
                it = iter(planes)
            dense8 = tuple(next(it) for _ in range(8))
            h.np_res = dense8
            if info is not None:
                matches, overflow = dense8[0], dense8[6]
                Bp = matches.shape[1]
                mflat = matches.reshape(-1, matches.shape[-1])
                cflat = next(it).reshape(-1)
                oflat = overflow.reshape(-1)
                # overflow cached as the COMBINED flag (match|fanout|slot):
                # all three are functions of (snapshot, topic), and
                # post_match re-ORs the fan-out/slot parts
                self._cache_put(
                    info.sid,
                    [(k, (mflat[i].copy(), int(cflat[i]), bool(oflat[i]))
                      + self._delta_cache_fields(h, i, Bp))
                     for k, i in info.inserts], version=info.version)
            self._note_readback(h, "dense", nb, t0)
        finally:
            if h.event is not None:
                h.event.synchronize()
                # the stream's span from the first launch to the last copy;
                # the kernels run while the host still launches, so only
                # the part past the launches adds to the window's cost
                card_s = h.ev_start.elapsed_time(h.event) / 1e3
                metrics.inc("routing.device.card_us", int(card_s * 1e6))
                h.cost_s += max(0.0, card_s - h.launch_s)
                # the host's part: the wait, the plane views and the
                # match-cache inserts
                metrics.inc("routing.device.readback_us",
                            int((time.perf_counter() - t0) * 1e6))
            else:       # on the CPU the readback is the host's work
                h.cost_s += self._stage("materialize", t0)

    def _note_readback(self, h, path: str, nbytes: int, t0: float) -> None:
        """One window read back on `path` (compact or dense): the bytes
        and windows counters, the materialize stage span and its flight-
        recorder span."""
        m = self.node.metrics
        m.inc(f"pipeline.readback.bytes.{path}", nbytes)
        m.inc(f"pipeline.readback.windows.{path}")
        if self.tele is not None:
            self.tele.observe_stage("materialize", time.perf_counter() - t0)
        self._rec_span(h.trace, "materialize", t0, track="materialize")

    def _rec_span(self, trace_id: int, name: str, t0: float, *,
                  track: str, parent: int = 0, meta=None) -> None:
        """Record one [t0, now] span on the flight recorder (nothing when
        tracing is off or the window carries no trace)."""
        if self.rec is not None and trace_id:
            self.rec.record(trace_id, name, t0, time.perf_counter(),
                            track=track, parent=parent, meta=meta)

    # ---- device-side tracing -------------------------------------------
    def start_device_trace(self, log_dir: Optional[str] = None) -> bool:
        """Begin a torch.profiler capture of the card's work (and the
        host's): every dispatch is one ``route_step#<trace id>`` range.
        ``stop_device_trace`` ends it. Returns False when a capture is
        already running."""
        if self._profiler is not None:
            return False
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        self._profiler = prof
        self._trace_dir = log_dir
        return True

    def stop_device_trace(self):
        """End the capture; returns the finished ``torch.profiler``
        profile (None when none ran). With a ``log_dir`` it also writes
        the Chrome trace there as ``route_steps.json``, the document the
        recorder's dump joins on the trace id."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return None
        prof.__exit__(None, None, None)
        if self._trace_dir:
            import os
            os.makedirs(self._trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(self._trace_dir, "route_steps.json"))
        return prof

    def _cache_from_csr(self, h, info, off, c3, pay, overflow) -> None:
        """Cache population from the CSR view: a row is the
        hole-compacted valid prefix + -1 pad, which routes as the dense
        row does (the count is the true match count for both)."""
        mw = h.built.match_width
        Bp = off.shape[1] - 1
        o_flat = overflow.reshape(-1)
        items = []
        for key, lane in info.inserts:
            w, bb = divmod(lane, Bp)
            cm = int(c3[w, bb, 0])
            row = np.full(mw, -1, np.int32)
            row[:cm] = pay[w, off[w, bb]:off[w, bb] + cm]
            items.append((key, (row, cm, bool(o_flat[lane]))
                          + self._delta_cache_fields(h, lane, Bp)))
        self._cache_put(info.sid, items, version=info.version)

    def _cache_put(self, sid, items, version=None) -> None:
        """Match-cache population, the cache_insert fault domain: under
        supervision a contained failure costs the reuse layer (its breaker
        opens toward rung 1, plain dispatches), never the window."""
        sup = self.sup
        try:
            if sup is not None:
                sup.fire("cache_insert")
            self._match_cache.put_many(sid, items, version=version)
        except Exception as e:
            if sup is None or not contained(e, self.fail_on_device_error):
                raise
            sup.note_fault("cache_insert", e)
        else:
            if sup is not None:
                sup.note_ok("cache_insert")

    def _corrupt_readback(self, h) -> None:
        """Apply an injected corrupt-readback fault: truncate the window
        axis of the host views (views only: the pinned buffers are never
        written) so the consume fails as a wrong-shape readback would, at
        the first plane it reads — the supervisor's replay must then
        re-route the window on the host."""
        h.corrupt = True
        nr = h.np_res
        if isinstance(nr, _CsrRes):
            h.np_res = _CsrRes(nr.off[:0], nr.c3[:0], nr.pay[:0],
                               nr.overflow[:0], nr.occur[:0])
        elif nr is not None:
            h.np_res = tuple(a[:0] for a in nr)

    def _note_device_error(self, e: BaseException) -> None:
        """The engine's own dispatch, readback or probe raised. Under
        supervision an error the ladder does not contain on the card fails
        the engine (``failed``: every later batch raises it); a window's
        publishers get it from the batcher."""
        if self.sup is not None \
                and not contained(e, self.fail_on_device_error):
            self._fail(e)

    def finish_sub(self, h, k: int, defer: bool = True) -> list[int]:
        """Stage 4 (event loop): consume sub-batch k of the window into
        deliveries and release one handle reference.

        The clean common case — no delta/dirty filters, no shared
        involvement for the message — is consumed by ONE vectorized
        pre-pass over the whole sub-batch (_consume_batch_fast); the rest
        walk _consume_one.

        With the node's delivery lanes active (``defer=True``, a running
        loop), this stage only BUILDS the delivery plan: the clean
        messages' rows go to session-affine lane slices, the other
        messages are consumed in batch order behind the plan's barrier
        (one step for the sub-batch over its ``_SlowRows``), and the
        returned LaneCounts is back-filled when the plan completes. The
        handle reference is released then, so the snapshot swap waits
        for the lane work. The plan owns copies of every row it reads:
        the readback's pinned host buffers are let go once the window's
        last sub-batch is consumed, as without the lanes. ``defer=False``
        (the sync callers) keeps the inline consume: counts are final on
        return."""
        t0 = time.perf_counter()
        deferred = False
        try:
            nr = h.np_res
            msgs, too_long = h.subs[k]
            b = h.built
            csr = isinstance(nr, _CsrRes)
            if csr:
                overflow_k, occur_k = nr.overflow[k], nr.occur[k]
            else:
                (matches, rows, opts, shared_sids, shared_rows,
                 shared_opts, overflow, occur) = nr
                overflow_k, occur_k = overflow[k], occur[k]
            nd = h.np_delta
            d_counts_k = None
            if nd is not None:
                # an overlay-plane overflow (match cap or fan cap) leaves
                # the message's post-snapshot matches incomplete: the full
                # host fallback, as for the main planes
                overflow_k = overflow_k | nd.overflow[k]
                d_counts_k = nd.counts[k]
            pending = self._delta_pending(h.delta)
            plan = pool = None
            if defer:
                pool = getattr(self.node, "deliver_lanes", None)
                if pool is not None and pool.active():
                    plan = pool.new_plan(msgs)   # None without a loop
                    if plan is not None:
                        plan.routed_device = True
                        # the plan carries its sub-batch's trace, so the
                        # lanes' spans land on the right window
                        plan.trace = self._sub_trace(h, k)
            if h.dev_shared and b.n_slots:
                if plan is None:
                    self._writeback_cursors(occur_k, b)
                else:
                    # the host groups' cursors advance in plan order, as
                    # the first step behind the barrier: this sub-batch's
                    # host picks (fallbacks, dirty slots) must read them
                    # as the inline loop does, after the earlier
                    # sub-batches' picks and before the later ones'
                    plan.add_slow(None, functools.partial(
                        self._writeback_cursors, occur_k.copy(), b))
            if csr:
                fast = self._consume_batch_fast_csr(
                    msgs, nr.off[k], nr.c3[k], nr.pay[k], too_long,
                    overflow_k, h.dev_shared, b, d_counts_k, pending,
                    plan=plan)
            else:
                fast = self._consume_batch_fast(
                    msgs, matches[k], rows[k], opts[k], shared_sids[k],
                    too_long, overflow_k, h.dev_shared, b, d_counts_k,
                    pending, plan=plan)
            counts: list[int] = []
            slow_idx: list[int] = []
            ctx = None
            for i, f_i in enumerate(fast):
                if f_i is DEFERRED:
                    counts.append(0)      # back-filled at plan finalize
                elif f_i is not None:
                    counts.append(f_i)
                elif plan is not None:
                    # behind the plan's barrier: it runs with every prior
                    # fast delivery done and nothing overtaking, the
                    # interleaving of the inline loop
                    counts.append(0)
                    slow_idx.append(i)
                else:
                    if ctx is None:
                        ctx = _SlowRows(h, k, overflow_k, pending, False)
                    counts.append(self._consume_slow(ctx, msgs, i))
            if slow_idx:
                plan.add_slow_many(slow_idx, functools.partial(
                    self._consume_slow,
                    _SlowRows(h, k, overflow_k, pending, True), msgs))
            self.node.metrics.inc("routing.device.batches")
            if plan is not None:
                out = LaneCounts(counts)
                out.plan = plan
                plan.target = out
                plan.add_done_callback(lambda: self._plan_done(h, plan))
                pool.submit(plan)
                deferred = True
                return out
            return counts
        finally:
            dt = self._stage("consume", t0)
            h.cost_s += dt
            if self.tele is not None:
                self.tele.observe_stage("deliver", dt)
            self._rec_span(self._sub_trace(h, k), "deliver", t0,
                           track="consume")
            h.consumed += 1
            if h.consumed >= len(h.subs):
                # every row consume reads is copied out by now: the
                # pinned readback blocks go back to the host allocator's
                # cache for the next windows
                h.host = h.np_res = h.np_delta = None
                h.res = h.cres = h.dres = h.dcres = None
            if not deferred:
                self._release_one(h)

    @staticmethod
    def _sub_trace(h, k: int) -> int:
        """Sub-batch k's window trace (the lead's for an unfused one)."""
        st = h.sub_traces
        return st[k] if st and k < len(st) else h.trace

    def _consume_slow(self, ctx: _SlowRows, msgs: list, i: int) -> int:
        """Consume message i of a sub-batch on the slow path: the full host
        route where the window flagged it too deep or overflowing, as in
        the reference; else its rows through _consume_one."""
        msg = msgs[i]
        if ctx.too_long[i] or ctx.overflow[i]:
            self.node.metrics.inc("routing.device.host_fallback")
            return self.broker._route(msg, self.router.match(msg.topic))
        row6, drow = ctx.rows(i)
        return self._consume_one(msg, *row6, ctx.dev_shared, ctx.b,
                                 drow=drow, ov=ctx.ov, pending=ctx.pending)

    def _plan_done(self, h, plan) -> None:
        """A delivery plan completed: its lane seconds join the window's
        cost (the chooser's sample), and its handle reference goes."""
        h.cost_s += plan.lane_s
        self._release_one(h)

    def _consume_batch_fast(self, msgs, m_k, r_k, o_k, ss_k, too_long,
                            overflow_k, dev_shared: bool, b,
                            d_counts_k=None, pending: bool = False,
                            plan=None):
        """Vectorized consume for provably-clean messages. Returns a list
        with per-message delivery counts, or None where the slow path
        must run. Clean requires, globally: standalone node (no cluster
        forward / cluster group sweep), no delta filters beyond the fused
        overlay (`pending`), no post-snapshot shared groups; per message:
        no too-long/overflow, no dirty/rich matched filter, no overlay
        match, no shared involvement."""
        if (self.broker.cluster is not None or pending
                or self.new_slots_by_filter):
            return [None] * len(msgs)
        B = len(msgs)
        mask = m_k[:B] >= 0
        mi = np.nonzero(mask)[0]
        fids = m_k[:B][mask]
        shared_any = (ss_k[:B] >= 0).any(axis=1)

        def fetch(row_msg, col):
            return r_k[row_msg, col], o_k[row_msg, col]

        return self._fast_deliver(msgs, mi, fids, too_long, overflow_k,
                                  shared_any, fetch, dev_shared, b,
                                  d_counts_k, plan=plan)

    def _consume_batch_fast_csr(self, msgs, off_k, c3_k, pay_k, too_long,
                                overflow_k, dev_shared: bool, b,
                                d_counts_k=None, pending: bool = False,
                                plan=None):
        """_consume_batch_fast over one window row's CSR planes: same
        clean-message proof and the same vectorized delivery walk, with
        the 2-D plane gathers replaced by flat payload gathers at each
        message's family base offsets."""
        if (self.broker.cluster is not None or pending
                or self.new_slots_by_filter):
            return [None] * len(msgs)
        B = len(msgs)
        cm = c3_k[:B, 0].astype(np.int64)
        cf = c3_k[:B, 1].astype(np.int64)
        cs = c3_k[:B, 2]
        base = off_k[:B].astype(np.int64)
        total_m = int(cm.sum())
        mi = np.repeat(np.arange(B), cm)
        if total_m:
            mcum = np.cumsum(cm) - cm
            fids = pay_k[np.arange(total_m) - np.repeat(mcum, cm)
                         + np.repeat(base, cm)]
        else:
            fids = np.zeros(0, np.int32)
        shared_any = cs[:B] > 0
        fbase = base + cm           # fan rows start, per message
        obase = base + cm + cf      # fan opts start, per message

        def fetch(row_msg, col):
            return (pay_k[fbase[row_msg] + col],
                    pay_k[obase[row_msg] + col])

        return self._fast_deliver(msgs, mi, fids, too_long, overflow_k,
                                  shared_any, fetch, dev_shared, b,
                                  d_counts_k, plan=plan)

    @staticmethod
    def _attribute_rows(mi_f, fids_f, seg, total: int):
        """Within each message the fan-out rows are the concatenation of
        per-filter CSR segments in match order. Returns (row_msg, col,
        row_fid) — for every fan-out row, its message index, its column
        within that message's fan-out, and the filter it came from."""
        csum = np.cumsum(seg) - seg                # global exclusive
        starts = np.flatnonzero(np.r_[True, mi_f[1:] != mi_f[:-1]])
        base = np.repeat(csum[starts], np.diff(np.r_[starts,
                                                     mi_f.size]))
        within = csum - base                       # offset inside msg
        row_msg = np.repeat(mi_f, seg)
        ar = np.arange(total)
        row_local = ar - np.repeat(csum, seg)
        col = np.repeat(within, seg) + row_local
        row_fid = np.repeat(fids_f, seg)
        return row_msg, col, row_fid

    def _fast_deliver(self, msgs, mi, fids, too_long, overflow_k,
                      shared_any, fetch, dev_shared: bool, b,
                      d_counts_k=None, plan=None):
        """Shared tail of the vectorized fast consume (dense and CSR):
        per-message clean proof, row attribution, and delivery. `mi`/
        `fids` list every valid match (message index, filter id) in
        match order; `fetch(row_msg, col)` gathers the (sid, packed
        opts) of fan-out entry `col` within message `row_msg`.

        With `plan` (the delivery lanes) this stops at the gather: the
        (row_msg, sid, opt, fid) arrays — copies, not views of the
        readback — go to the plan, the lanes deliver them, and these
        messages come back DEFERRED. `plan=None` is the inline loop."""
        broker = self.broker
        B = len(msgs)
        hostside = self._hostside_mask(b)

        slow = np.asarray(too_long[:B]) | (overflow_k[:B] != 0)
        if d_counts_k is not None:
            # overlay-matched messages walk the slow path
            slow |= d_counts_k[:B] > 0
        if fids.size:
            np.logical_or.at(slow, mi, hostside[fids] | b.fid_shared[fids])
        if dev_shared:
            slow |= shared_any

        out: list = [None] * B
        fast_ok = ~slow
        if not fast_ok.any():
            return out
        keep = fast_ok[mi]
        mi_f, fids_f = mi[keep], fids[keep]
        seg = b.seg_np[fids_f]
        total = int(seg.sum())
        if plan is not None:
            fast_idx = np.flatnonzero(fast_ok)
            plan.register_fast(fast_idx)
            if total:
                row_msg, col, row_fid = self._attribute_rows(
                    mi_f, fids_f, seg, total)
                sid, opt = fetch(row_msg, col)
                valid = sid >= 0
                plan.add_rows(row_msg[valid], sid[valid], opt[valid],
                              row_fid[valid], b.fid_filter)
            for i in fast_idx.tolist():
                out[i] = DEFERRED
            return out
        counts = np.zeros(B, np.int64)
        delivered = 0
        if total:
            row_msg, col, row_fid = self._attribute_rows(
                mi_f, fids_f, seg, total)
            sid, opt = fetch(row_msg, col)
            valid = sid >= 0
            fid_filter = b.fid_filter
            deliver = broker._deliver
            # the dict copy: _deliver plants it into the delivered copy's
            # headers, and the OPT_TABLE entries are frozen
            for bi, s, ob, fd in zip(row_msg[valid].tolist(),
                                     sid[valid].tolist(),
                                     opt[valid].tolist(),
                                     row_fid[valid].tolist()):
                if deliver(s, fid_filter[fd], msgs[bi],
                           dict(OPT_TABLE[ob & 0x3F])):
                    counts[bi] += 1
                    delivered += 1
        if delivered:
            self.node.metrics.inc("messages.routed.device", delivered)
        metrics = self.node.metrics
        hooks = broker.hooks
        for i in np.flatnonzero(fast_ok).tolist():
            n = int(counts[i])
            if n == 0 and not msgs[i].is_sys:
                metrics.inc("messages.dropped")
                metrics.inc("messages.dropped.no_subscribers")
                hooks.run("message.dropped", (msgs[i], "no_subscribers"))
            out[i] = n
        return out

    def finish(self, h) -> list[int]:
        """Stage 4 for single-batch callers (route_batch): window of 1.
        Sync callers need final counts on return, so the consume stays
        inline (the lanes serve the pipelined path via finish_sub)."""
        return self.finish_sub(h, 0, defer=False)

    def _release_one(self, h) -> None:
        """Drop one sub-batch reference; the handle releases at zero."""
        if h is None or h.built is None:
            return
        h.refs -= 1
        if h.refs <= 0:
            self._release(h)

    def _release(self, h) -> None:
        """The handle is done: unpin its snapshot and run its release
        callback (the batcher's cost sample, when the lanes held it)."""
        h.built = None
        self._outstanding -= 1
        if self.ledger is not None:
            self.ledger.unpin(id(h))
        cb, h.on_release = h.on_release, None
        if cb is not None:
            cb()
        if self._building:
            self._try_swap()

    def abandon(self, h, error: Optional[BaseException] = None,
                defer: bool = False) -> None:
        """Release a handle ENTIRELY (error path: on the CPU the caller
        falls back to the host route for every remaining sub-batch; with
        `error` every remaining sub-batch raises it). With `defer` (a
        stage thread may still be inside the window) the handle only
        stops serving: the release — its snapshot pin and HBM ledger pin —
        waits for a later ``abandon(h)`` once the thread has left.
        Idempotent."""
        if h is None:
            return
        if error is not None:
            h.error = error
        if defer:
            h.abandoned = True
            return
        if h.built is not None:
            h.refs = 0
            self._release(h)

    def route_batch(self, msgs: list[Message]) -> Optional[list[int]]:
        """Route+deliver a micro-batch through the device window,
        synchronously (publish_batch / tests / warm-up). The pipelined
        serving path drives the four stages separately via
        PublishBatcher.

        Returns per-message delivery counts, or None when the engine has
        no tables to serve (caller falls back to the host path) — also
        while a background build of the first snapshot runs: building it a
        second time here would race that build's warm-up and swap."""
        # a sync rebuild must honor the handle pin: swapping the tables
        # while the batcher has a dispatch in flight would hand that
        # dispatch the new tables under the old _Built metadata
        if self._outstanding == 0 and not self._building \
                and (self._built is None
                     or self._compaction_reason() is not None):
            if self._built is not None:
                self._count_compaction(self._compaction_reason())
            self.rebuild()
        h = self.prepare(msgs, gate_cold=False)
        if h is None:
            return None
        try:
            self.dispatch(h)
            self.materialize(h)
        except Exception:
            self.abandon(h)
            raise
        return self.finish(h)

    def _writeback_cursors(self, occur: np.ndarray, b=None) -> None:
        """Mirror device round-robin cursor advances into the host
        SharedGroup state so the host path and the next rebuild stay fair."""
        if self.broker.shared_strategy != "round_robin":
            return
        b = b or self._built
        for slot in np.flatnonzero(occur[:b.n_slots]):
            f, gname = b.slot_key[slot]
            g = self.broker.shared.get(f, {}).get(gname)
            if g is not None and g.members:
                g.cursor = (g.cursor + int(occur[slot])) % len(g.members)

    def _consume_one(self, msg, m_row, r_row, o_row, ss_row, sr_row, so_row,
                     dev_shared: bool, b, drow=None, ov=None,
                     pending: bool = False) -> int:
        """Turn one message's route rows into deliveries.

        `drow` = (delta fids, delta fan rows, delta fan opts) when the
        dispatch fused the overlay `ov`: post-snapshot filters deliver
        from its planes. `pending` marks live delta filters the overlay
        does not cover — only those walk the host delta trie (and the
        overlay's fids are skipped there, so nothing delivers twice)."""
        broker = self.broker
        metrics = self.node.metrics
        n = 0
        matched: list[str] = []
        off = 0
        for fid in m_row:
            if fid < 0:
                continue
            f = b.fid_filter[fid]
            seg = b.seg_len[fid]
            matched.append(f)
            # rich-ness is snapshot state: read it from the handle's
            # pinned _Built, never from engine-level state
            if f in self.dirty_filters or b.fid_rich[fid]:
                n += broker.dispatch(f, msg)
            else:
                for k in range(off, off + seg):
                    sid = r_row[k]
                    if sid < 0:
                        continue
                    if broker._deliver(sid, f, msg,
                                       dict(OPT_TABLE[o_row[k] & 0x3F])):
                        n += 1
                        metrics.inc("messages.routed.device")
            off += seg

        # filters added since the snapshot: the overlay's planes, and the
        # host delta trie for the filters it does not cover
        if ov is not None and drow is not None:
            d_fids, d_rows, d_opts = drow
            doff = 0
            for raw in d_fids:
                dfid = int(raw)
                if dfid < 0:
                    continue
                seg = ov.seg_of.get(dfid, 0)
                f = self._delta_filter.get(dfid)
                if f is None:       # deleted while this window flew
                    doff += seg
                    continue
                matched.append(f)
                if dfid in ov.hostfan \
                        or self._fid_member_clock.get(dfid, -1) \
                        > ov.version:
                    # rich/oversized fan-out, or membership changed after
                    # this version was built: the match stands, delivery
                    # comes from the live host dict
                    n += broker.dispatch(f, msg)
                else:
                    for j in range(doff, doff + seg):
                        sid = int(d_rows[j])
                        if sid < 0:
                            continue
                        if broker._deliver(
                                sid, f, msg,
                                dict(OPT_TABLE[int(d_opts[j]) & 0x3F])):
                            n += 1
                            metrics.inc("messages.routed.device")
                doff += seg
        if self._delta_filter and (ov is None or pending):
            words = T.tokens(msg.topic)[:self.max_levels]
            ids = self.intern.encode_topic(words)
            dol = words[0].startswith("$") if words else False
            host_hit = False
            for dfid in self._delta_trie.match(ids, dol):
                if ov is not None and dfid in ov.fid_set:
                    continue    # the overlay's planes served it
                f = self._delta_filter.get(dfid)
                if f is None:
                    continue
                matched.append(f)
                n += broker.dispatch(f, msg)
                host_hit = True
            if host_hit:
                metrics.inc("routing.device.host_delta")

        # shared subscriptions
        if dev_shared:
            handled: set[tuple] = set()
            for k, slot in enumerate(ss_row):
                if slot < 0:
                    continue
                f, gname = b.slot_key[slot]
                handled.add((f, gname))
                if (f, gname) in self.dirty_slots:
                    if self._host_shared_dispatch(f, gname, msg):
                        n += 1
                    continue
                sid = sr_row[k]
                if sid < 0:
                    continue
                if sid >= _REMOTE_SID_BASE:
                    # device picked a remote member: directed forward,
                    # the host path's cross-node dispatch with the pick
                    # already done on device
                    cluster = broker.cluster
                    if cluster is not None:
                        origin, rsid = \
                            b.remote_members[sid - _REMOTE_SID_BASE]
                        cluster._spawn_fwd(
                            origin, "shared.deliver_fwd",
                            [f, gname, rsid, msg.to_wire()],
                            key=msg.topic)
                        n += 1
                        metrics.inc("messages.routed.device")
                        metrics.inc("messages.routed.device.remote_shared")
                    elif self._host_shared_dispatch(f, gname, msg):
                        # cluster torn down since the build: host decides
                        n += 1
                elif broker._deliver(
                        sid, f, msg,
                        dict(OPT_TABLE[so_row[k] & 0x3F], share=gname)):
                    n += 1
                    metrics.inc("messages.routed.device")
                else:
                    # re-dispatch ONLY when the picked member is actually
                    # gone (in-flight churn window) or the ack protocol is
                    # on — a nack from a live member with dispatch_ack off
                    # is final, matching the host pick's semantics (for
                    # sticky the re-pick is also where affinity re-homes,
                    # emqx_shared_sub.erl:269-283)
                    grp = broker.shared.get(f, {}).get(gname)
                    gone = grp is None or sid not in grp.members
                    if (gone or broker.shared_dispatch_ack) and \
                            self._host_shared_dispatch(f, gname, msg):
                        n += 1
            cluster = broker.cluster
            for f in matched:
                # groups created after the snapshot on matched filters
                for gname in self.new_slots_by_filter.get(f, ()):
                    if (f, gname) in handled:
                        continue
                    handled.add((f, gname))
                    if self._host_shared_dispatch(f, gname, msg):
                        n += 1
                # delta filters' groups (host dispatch covers them all)
                if f in self._delta_fid_of:
                    for gname in list(broker.shared.get(f, {})):
                        if (f, gname) not in handled:
                            handled.add((f, gname))
                            if self._host_shared_dispatch(f, gname, msg):
                                n += 1
                if cluster is not None:
                    # groups excluded from the snapshot (remote members)
                    # and remote-only groups known via replication;
                    # cached per filter — membership changes invalidate
                    groups = self._cluster_groups_cache.get(f)
                    if groups is None:
                        groups = tuple(
                            set(broker.shared.get(f, ()))
                            | cluster._groups_by_real.get(f, set()))
                        self._cluster_groups_cache[f] = groups
                    for gname in groups:
                        if (f, gname) in handled:
                            continue
                        handled.add((f, gname))
                        if self._host_shared_dispatch(f, gname, msg):
                            n += 1
        else:
            n += broker._dispatch_shared(msg, matched)

        if broker.cluster:
            n += broker.cluster.forward(msg, matched)
        if n == 0 and not msg.is_sys:
            metrics.inc("messages.dropped")
            metrics.inc("messages.dropped.no_subscribers")
            broker.hooks.run("message.dropped", (msg, "no_subscribers"))
        return n

    def rebuild_state(self) -> dict:
        """Live rebuild/overlay gauges for the telemetry snapshot's
        `rebuild` section: the point-in-time values a counter can't
        carry."""
        ov = self._overlay
        return {
            "journal_depth": self.journal_depth(),
            "building": self._building,
            "staleness": self.staleness(),
            "tombstones": len(self._built_deleted),
            "delta_overlay": self.delta_overlay,
            "overlay_rows": ov.n if ov is not None else 0,
            "overlay_class": ov.cap if ov is not None else 0,
            "overlay_version": ov.version if ov is not None else None,
            "overlay_uncovered": self._overlay_uncovered,
            "delta_filters": len(self._delta_filter),
        }

    def stats(self) -> dict:
        b = self._built
        ov = self._overlay
        return {
            "built": b is not None,
            "backend": b.backend if b else None,
            "filters": len(b.fid_filter) if b else 0,
            "shared_slots": b.n_slots if b else 0,
            "churn": self.staleness(),
            "dirty_filters": len(self.dirty_filters),
            "delta_filters": len(self._delta_filter),
            "building": self._building,
            "outstanding": self._outstanding,
            "dedup": self.dedup,
            "match_cache": self._match_cache.stats()
            if self._match_cache is not None else None,
            "compact_readback": self.compact_readback,
            "delta_overlay": self.delta_overlay,
            "overlay": {"rows": ov.n, "class": ov.cap,
                        "version": ov.version, "hostfan": len(ov.hostfan)}
            if ov is not None else None,
            "subscription_covering": self.subscription_covering,
            "cover": {"roots": b.cover.n_roots,
                      "covered": b.cover.n_covered,
                      "appends": b.cover.app_used,
                      "incomplete": b.cover.incomplete,
                      "reduction": round(
                          (b.cover.n_roots + b.cover.n_covered)
                          / max(1, b.cover.n_roots), 2)}
            if b is not None and b.cover is not None else None,
            "cover_detect_s": round(self.detect_s, 3),
            "graphs": len(self._graphs),
            "captures": self.captures,
            "capture_s": round(self.capture_s, 3),
            "payload_ewma": {k: round(v, 1)
                             for k, v in self._pay_ewma.items()},
            "device": str(self.device),
            "messages.routed.device": self.node.metrics.val(
                "messages.routed.device"),
            "routing.device.batches": self.node.metrics.val(
                "routing.device.batches"),
            "routing.device.bypassed": self.node.metrics.val(
                "routing.device.bypassed"),
        }
