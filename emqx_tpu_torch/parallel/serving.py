"""Multichip serving: routing PUBLISH windows through the dp×route mesh.

The port of ``emqx_tpu/parallel/serving.py``. Filters are partitioned by
``crc32(filter) % route`` (``shard_of``); every route shard compiles its
filters into its own trie tables with capacity classes shared by every
shard, stacked on a leading axis, and a window of topics is matched,
fanned out and picked by ``parallel/sharded.make_sharded_route_step``.
Two classes share one device core (``_MeshCore``: the per-shard trie
build with subscription covering, the exchange companions and the
exchange's segment-capacity ladder):

- ``ShardedRouteEngine``, a standalone engine built from a dict of
  subscriptions or columnar arrays (a million filters never pass through
  a per-filter Python loop). ``route_encoded`` runs the step, then the
  exchange, then copies each destination's occupied plan prefix to the
  host — or, for a window the exchange cannot serve, gathers the dense
  planes (counted in ``stats`` by reason).
- ``ShardedRouteServer`` (reference :143), a node's live serving engine
  behind the ``PublishBatcher`` (``Node`` builds it under
  ``broker.multichip.enable``). It compiles the node's live routing state
  per shard, serves the batcher's window protocol (``prepare_window`` /
  ``dispatch`` / ``materialize`` / ``finish_sub``) and consumes the
  result into session deliveries. Churn dirties a filter's shard; the
  next window's ``poll_rebuild`` rebuilds the dirty shards on the host
  with the snapshot's capacity classes and writes only their slices
  (``update_shard``, non-donating: a window in flight keeps the tensors
  it was prepared against). A shard outgrowing its class starts a full
  build in the background, and until it is adopted every window routes
  on the host (the reference's behaviour, counted under
  ``routing.mesh.rebuild_host``). After the step the exchange
  (``make_exchange_step``, kernel 3's ring rotation) packs each window's
  delivery rows per owning shard; a window the exchange cannot serve
  (a shared-slot hit, a rich or slotted filter, an overflow, a too-long
  topic, a segment class too small or cold) is gathered: its planes are
  compacted to CSR (kernel 2) and landed, or landed dense when the CSR
  outgrows its payload class. Every gather is counted by reason.

On the card every mesh dispatch runs eagerly: the NFA reads its frontier
width on the host at each level, so no CUDA graph covers a mesh window.
A failed step, exchange, readback or build there raises and marks the
server ``failed``, as the single-chip engine does; only what the
supervisor's injector caused replays on the host. The stacked tables
live on the mesh's first device.

Delivery records are (msg, sid, gfid | packed_opt << 24) triples; a
session's records come in (source shard asc, msg asc, row asc) order on
either path — the order the reference's consume delivers in.

Under a cluster, normal-route forwarding works as the single-chip
consume's (``cluster.forward`` on the matched set), and each shard's
shared slots hold the cluster-wide membership
(``device_engine.capture_shared``), remote members as sids of
``_REMOTE_SID_BASE`` and above that the consume turns into directed
``shared.deliver_fwd`` calls: the pick is made on the mesh. As in the
reference, a clustered node's windows never take the exchange or the
lanes' clean rows: every message goes through the per-message consume.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from emqx_tpu_torch import device as D
from emqx_tpu_torch.broker.deliver import DEFERRED, OPT_TABLE, LaneCounts
from emqx_tpu_torch.broker.device_engine import (_REMOTE_SID_BASE,
                                                 DeviceRouteEngine,
                                                 _device_lock, _is_rich,
                                                 _pack_opts, capture_shared,
                                                 resolve_compact_readback)
from emqx_tpu_torch.broker.device_engine import _next_pow2 as _batch_pow2
from emqx_tpu_torch.broker.supervise import contained, guard_task
from emqx_tpu_torch.engine import Plan, pack_opts
from emqx_tpu_torch.models.router_engine import ExchangeAux, RouterTables
from emqx_tpu_torch.ops import cover as CV
from emqx_tpu_torch.ops.compact import compact_result, csr_slices
from emqx_tpu_torch.ops.fanout import SubTable, _csr
from emqx_tpu_torch.ops.intern import PAD, InternTable
from emqx_tpu_torch.ops.match import encode_topics_str
from emqx_tpu_torch.ops.shapes import _next_pow2
from emqx_tpu_torch.ops.shared import (STRATEGIES, STRATEGY_ROUND_ROBIN,
                                       STRATEGY_STICKY, hash_base)
from emqx_tpu_torch.ops.trie import build_tables
from emqx_tpu_torch.parallel.mesh import make_mesh
from emqx_tpu_torch.parallel.sharded import (make_exchange_step,
                                             make_sharded_route_step,
                                             put_sharded, stack_tables,
                                             update_shard)
from emqx_tpu_torch.utils import topic as T

log = logging.getLogger("emqx.serving")

# gfid | packed_opt << 24 is the exchange wire word: global filter ids
# above this no longer fit next to the 6 subopt bits
EXCHANGE_MAX_GFID = 1 << 24


def resolve_device_exchange(configured=None) -> bool:
    """``broker.device_exchange``, default on; off serves every mesh
    window by the host gather (no exchange companions, no exchange step,
    no ``pipeline.exchange.*`` traffic)."""
    return True if configured is None else bool(configured)


def shard_of(topic_filter: str, n_route: int) -> int:
    """The route shard that owns a filter: crc32(filter) % route."""
    return zlib.crc32(topic_filter.encode()) % n_route


class ShardCapture(NamedTuple):
    """One shard's filters, sorted by string (local fid = position)."""
    filters: list
    words: np.ndarray       # [n, L] interned levels
    lens: np.ndarray        # [n]
    sub_start: np.ndarray   # [n+1] CSR of normal subscribers
    sub_row: np.ndarray     # session ids
    sub_opts: np.ndarray    # packed subopts
    slots: list             # [(local fid, group, [(sid, opts)])]


class MeshReadback(NamedTuple):
    """What one routed window brings back to the host (numpy).

    records [N, 3] (msg, sid, gfid | opt << 24) device-routed delivery
    rows and src [N] their source shard; dense holds the gathered planes
    of a fallback window (None when the exchange served it); host [B]
    marks messages to complete on the host (too long or overflowed)."""
    served: bool
    reason: str
    records: np.ndarray
    src: np.ndarray
    dense: Optional[dict]
    host: np.ndarray


class _MeshCore:
    """The device core both mesh engines share: the mesh, the sharded
    step, the per-shard build, the exchange companions and the exchange's
    segment-capacity ladder."""

    def _init_core(self, mesh, intern: InternTable, *, frontier_cap: int,
                   match_cap: int, fanout_cap: int, slot_cap: int,
                   level_cap: int, subscription_covering,
                   ledger=None) -> None:
        self.mesh = mesh
        self.ledger = ledger      # the node's HBM ledger, or None
        self.n_dp, self.n_route = mesh.dp, mesh.route
        self.device = mesh.grid[0][0]
        self.intern = intern
        self.frontier_cap, self.match_cap = frontier_cap, match_cap
        self.fanout_cap, self.slot_cap = fanout_cap, slot_cap
        self.level_cap = level_cap
        self.subscription_covering = True if subscription_covering is None \
            else bool(subscription_covering)
        self.detect_s = 0.0       # cover detection seconds, every shard
        # the one lock around the device work of every engine on the card
        self._cuda_lock = _device_lock(self.device)
        self.step = make_sharded_route_step(
            mesh, backend="trie", frontier_cap=frontier_cap,
            match_cap=match_cap, fanout_cap=fanout_cap, slot_cap=slot_cap,
            hold=self._hold)
        self._exch_steps: dict = {}
        self._exch_ewma: Optional[float] = None

    def _hold(self, category: str, tree):
        """Register a persistent device allocation with the HBM ledger;
        identity passthrough without one."""
        if self.ledger is not None:
            return self.ledger.hold(category, tree)
        return tree

    # --- build -----------------------------------------------------------

    @staticmethod
    def _shard_dims(c: ShardCapture) -> dict:
        return {"filters": len(c.filters), "nodes": int(c.lens.sum()) + 1,
                "subs": int(c.sub_start[-1]), "slots": len(c.slots),
                "members": sum(len(m) for _f, _g, m in c.slots)}

    @staticmethod
    def _caps_of(dims: dict) -> dict:
        return {k: _next_pow2(max(2, v)) for k, v in dims.items()}

    def _cover_shard(self, c: ShardCapture, caps: dict):
        """One shard's cover tables (reference :448-490): detection over
        the shard's filters, and uniform constants — out width
        match_cap, 256 candidates, caps["filters"] verify rows, a 1-row
        append region — so every shard's tables stack. Returns
        (CoverTables, root fids), or (None, None) with covering off or a
        filter too deep for the order key."""
        L = c.words.shape[1]
        if not self.subscription_covering or L > CV.MAX_KEY_LEVELS:
            return None, None
        n = len(c.filters)
        if n >= 2:
            dollar = np.fromiter((f.startswith("$") for f in c.filters),
                                 bool, n)
            t0 = time.perf_counter()
            covers, inc = CV.detect_covers(c.words, c.lens, dollar,
                                           device=self.device,
                                           lock=self._cuda_lock)
            self.detect_s += time.perf_counter() - t0
            owner = CV.assign_owners(covers, inc)
        else:
            owner = np.full(n, -1, np.int64)
        keys = CV.trie_order_keys(c.words, c.lens)
        ct = CV.build_cover_tables(
            c.words, c.lens, owner, keys, fid_cap=caps["filters"],
            out_width=self.match_cap, cand_cap=256,
            verify_cap=caps["filters"], append_cap=1)
        return ct, np.flatnonzero(owner < 0).astype(np.int64)

    def _build_shard(self, c: ShardCapture, caps: dict):
        """One shard's capture → (RouterTables of numpy planes, seg_len,
        fid_slow, root count), padded to the capacity classes — the
        planes equal the reference's build_tables / build_subtable (and,
        covering on, build_cover_tables) output."""
        n, Fc = len(c.filters), caps["filters"]
        ct, roots = self._cover_shard(c, caps)
        if ct is not None:
            trie = build_tables(c.words[roots], c.lens[roots],
                                filter_ids=roots,
                                node_capacity=caps["nodes"],
                                slot_capacity=4 * caps["nodes"])
            trie = trie._replace(cover=ct)
        else:
            trie = build_tables(c.words, c.lens,
                                node_capacity=caps["nodes"],
                                slot_capacity=4 * caps["nodes"])
        cnt = np.diff(c.sub_start).astype(np.int32)
        sub_start = np.zeros(Fc + 1, np.int32)
        sub_start[1:n + 1] = cnt
        np.cumsum(sub_start, out=sub_start)
        total = int(sub_start[-1])
        S = max(caps["subs"], total, 1)
        sub_row = np.full(S, -1, np.int32)
        sub_row[:total] = c.sub_row
        sub_opts = np.zeros(S, np.int8)
        sub_opts[:total] = c.sub_opts
        fs_map: dict = {}
        members: dict = {}
        for s, (fid, _g, m) in enumerate(c.slots):
            fs_map.setdefault(fid, []).append((s, 0))
            members[s] = m
        fs_start, fs_slot, _ = _csr(Fc, fs_map, caps["slots"])
        n_slots = max(caps["slots"], len(c.slots),
                      1 + int(fs_slot.max(initial=-1)))
        shared_start, shared_row, shared_opts = _csr(n_slots, members,
                                                     caps["members"])
        subs = SubTable(sub_start, sub_row, sub_opts, fs_start, fs_slot,
                        shared_start, shared_row, shared_opts.astype(np.int8))
        seg = np.zeros(Fc, np.int32)
        seg[:n] = cnt
        slow = np.zeros(Fc, bool)
        slow[[fid for fid, _g, _m in c.slots]] = True
        return RouterTables(trie=trie, subs=subs), seg, slow, \
            n if roots is None else len(roots)

    @staticmethod
    def _fid_offsets(counts) -> "tuple[np.ndarray, bool]":
        """Global-fid base per shard (the cumsum of the shards' filter
        counts in shard order) and whether the global fid space fits the
        exchange's wire word."""
        offs = np.zeros(len(counts), np.int32)
        offs[1:] = np.cumsum(counts)[:-1]
        return offs, int(sum(counts)) < EXCHANGE_MAX_GFID

    def _aux_tensors(self, seg: np.ndarray, slow: np.ndarray,
                     offs: np.ndarray) -> ExchangeAux:
        with self._cuda_lock:
            return ExchangeAux(*(torch.from_numpy(np.ascontiguousarray(x))
                                 .to(self.device) for x in (seg, slow, offs)))

    # --- exchange capacity ladder ------------------------------------------

    def _choose_ecap(self, Bp: int) -> int:
        """Per-dest segment capacity: the smallest rung of a {pow2,
        1.5*pow2} ladder holding 1.25x the peak-biased EWMA of observed
        per-dest row counts, bounded by the everything-to-one-dest case."""
        b_local = max(1, Bp // self.n_dp)
        cap_max = _next_pow2(b_local * self.fanout_cap
                             * max(1, self.n_route))
        ew = self._exch_ewma
        if ew is None:
            need = max(16, b_local // max(1, self.n_route))
        else:
            need = max(16, int(1.25 * ew) + 1)
        E = 16
        while E < need and E < cap_max:
            E = E * 3 // 2 if (E & (E - 1)) == 0 else E * 4 // 3
        return min(E, cap_max)

    def _note_exch(self, mx: float) -> None:
        ew = self._exch_ewma
        self._exch_ewma = mx if (ew is None or mx > ew) \
            else 0.8 * ew + 0.2 * mx

    def exchange_step(self, E: int):
        fn = self._exch_steps.get(E)
        if fn is None:
            fn = self._exch_steps[E] = make_exchange_step(self.mesh,
                                                          seg_cap=E)
        return fn

    def _land_exchange(self, ex, read=None):
        """Land one exchange result: ((plan, plan_cnt, src_cnt), "exchange",
        bytes) when every device reported clean and in capacity — only
        each destination's occupied plan prefix crosses, quantized to 8
        rows — else (None, reason, probe bytes). An overflow pushes the
        EWMA past the class so the next window asks for a bigger one.
        ``read(name, tensor)`` brings each plane to the host (default: a
        plain copy)."""
        if read is None:
            def read(_name, t):
                return t.cpu().numpy()
        ok = read("ok", ex.ok)
        if int(ok.min()) != 3:
            if not (ok & 2).all():
                cnt = read("plan_cnt", ex.plan_cnt)
                self._note_exch(float(cnt.max()) * 1.25)
                return None, "overflow", ok.nbytes + cnt.nbytes
            return None, "unclean", ok.nbytes
        cnt = read("plan_cnt", ex.plan_cnt)
        scnt = read("src_cnt", ex.src_cnt)
        hi = int(cnt.max())
        self._note_exch(float(hi))
        E = int(ex.plan.shape[2])
        hq = min(E, max(8, -(-hi // 8) * 8))
        plan = read("plan", ex.plan[:, :, :hq])
        return (plan, cnt, scnt), "exchange", \
            ok.nbytes + plan.nbytes + cnt.nbytes + scnt.nbytes

    @staticmethod
    def land_dense(res) -> dict:
        """The host gather: the step's planes cut to their widest used
        column, copied to the host."""
        def width(c, cap):
            return max(1, min(cap, int(c.max()) if c.numel() else 0))

        fe = width(res.fan_counts, res.rows.shape[2])
        ks = width((res.shared_sids >= 0).sum(-1), res.shared_sids.shape[2])
        mm = width(res.match_counts, res.matches.shape[2])
        return {"matches": res.matches[..., :mm].cpu().numpy(),
                "rows": res.rows[..., :fe].cpu().numpy(),
                "opts": res.opts[..., :fe].cpu().numpy(),
                "fan_counts": res.fan_counts.cpu().numpy(),
                "shared_sids": res.shared_sids[..., :ks].cpu().numpy(),
                "shared_rows": res.shared_rows[..., :ks].cpu().numpy(),
                "shared_opts": res.shared_opts[..., :ks].cpu().numpy(),
                "overflow": res.overflow.cpu().numpy()}

    def _exchange_records(self, plan: np.ndarray, scnt: np.ndarray):
        """Landed per-dest plans → records, per source shard asc, then
        dest, then dp row (so each session reads (src, msg, row))."""
        R = self.n_route
        starts = np.cumsum(scnt, axis=2) - scnt         # [dp, dst, src]
        pieces, srcs = [], []
        for r in range(R):
            for t in range(R):
                for d in range(plan.shape[0]):
                    c = int(scnt[d, t, r])
                    if c:
                        s0 = int(starts[d, t, r])
                        pieces.append(plan[d, t, s0:s0 + c])
                        srcs.append(np.full(c, r, np.int32))
        if not pieces:
            return np.zeros((0, 3), np.int32), np.zeros(0, np.int32)
        return np.concatenate(pieces), np.concatenate(srcs)


class ShardedRouteEngine(_MeshCore):
    """Routes topic windows through a dp×route mesh of trie shards.

    Build with ``from_subscriptions`` (filter → [(sid, opts)], with
    ``$share/<group>/`` prefixes) or ``from_columnar`` (filter strings,
    interned words and a normal-subscriber CSR). ``route(topics)``
    returns one ``Plan`` per topic; ``route_encoded`` routes one encoded
    window and returns its ``MeshReadback``; ``sessions(rb)`` gives each
    session's delivery records in order.
    """

    def __init__(self, captures: list, intern: InternTable, mesh, *,
                 frontier_cap: int = 16, match_cap: int = 64,
                 fanout_cap: int = 128, slot_cap: int = 16,
                 level_cap: int = 16, batch: int = 256,
                 strategy: str = "round_robin",
                 subscription_covering: Optional[bool] = None):
        self._init_core(mesh, intern, frontier_cap=frontier_cap,
                        match_cap=match_cap, fanout_cap=fanout_cap,
                        slot_cap=slot_cap, level_cap=level_cap,
                        subscription_covering=subscription_covering)
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown shared strategy {strategy!r}")
        self.strategy = STRATEGIES[strategy]
        if batch % self.n_dp:
            raise ValueError(f"batch {batch} does not split over "
                             f"dp={self.n_dp}")
        self.batch = batch
        self.stats = {"windows": 0, "exchange_windows": 0,
                      "host_messages": 0, "fallback": {},
                      "subscription_covering": self.subscription_covering,
                      "cover": None}
        self._build(captures)

    def _build(self, captures: list) -> None:
        dims = [self._shard_dims(c) for c in captures]
        caps = self._caps_of({k: max(d[k] for d in dims) for k in dims[0]})
        built = [self._build_shard(c, caps) for c in captures]
        self.caps = caps
        self.captures = captures
        self.tables, self.cursors = put_sharded(
            self.mesh, stack_tables([b[0] for b in built]),
            np.zeros((self.n_route, caps["slots"]), np.int32))
        self.subs_host = [b[0].subs for b in built]
        counts = [len(c.filters) for c in captures]
        self.fid_off, self.exchange_fits = self._fid_offsets(counts)
        self.slot_off = np.concatenate(
            [[0], np.cumsum([len(c.slots) for c in captures])[:-1]])
        self.aux = self._aux_tensors(np.stack([b[1] for b in built]),
                                     np.stack([b[2] for b in built]),
                                     self.fid_off)
        self.filters = [f for c in captures for f in c.filters]
        if self.subscription_covering:
            # per-shard detection, summed; reduction = full set / roots
            nr = sum(b[3] for b in built)
            nc = sum(counts) - nr
            self.stats["cover"] = {"roots": nr, "covered": nc,
                                   "reduction": round((nr + nc)
                                                      / max(1, nr), 2)}

    @staticmethod
    def _mesh_of(n_devices, dp, device):
        return make_mesh(n_devices, dp=dp,
                         devices=None if device is None else [device])

    @classmethod
    def from_subscriptions(cls, subscriptions: dict, *,
                           n_devices: Optional[int] = None,
                           dp: Optional[int] = None, device=None,
                           level_cap: int = 16, **kw) -> "ShardedRouteEngine":
        """subscriptions: filter → [(sid, opts)], where a filter may carry
        a ``$share/<group>/`` or ``$queue/`` prefix and opts is a packed
        int or a dict of qos/nl/rap/rh. ``device`` is the card (or
        ``"cpu"``) every shard lives on."""
        mesh = cls._mesh_of(n_devices or 8, dp, device)
        normal: dict = {}
        shared: dict = {}
        for raw, members in subscriptions.items():
            filt, o = T.parse(raw)
            T.validate(filt, "filter")
            packed = [(int(s), p if isinstance(p, int) else pack_opts(p))
                      for s, p in members]
            if "share" in o:
                shared.setdefault(filt, {}).setdefault(
                    o["share"], []).extend(packed)
            else:
                normal.setdefault(filt, []).extend(packed)
        intern = InternTable()
        R = mesh.route
        buckets: list = [[] for _ in range(R)]
        for f in sorted(set(normal) | set(shared)):
            if len(T.tokens(f)) > level_cap:
                raise ValueError(f"filter {f!r} is deeper than "
                                 f"level_cap={level_cap}")
            buckets[shard_of(f, R)].append(f)
        captures = []
        for fl in buckets:
            words = np.full((len(fl), level_cap), PAD, np.int32)
            lens = np.zeros(len(fl), np.int64)
            rows, opts, starts, slots = [], [], [0], []
            for i, f in enumerate(fl):
                ids = intern.encode_filter(T.tokens(f))
                words[i, :len(ids)] = ids
                lens[i] = len(ids)
                for s, p in normal.get(f, ()):
                    rows.append(s)
                    opts.append(p)
                starts.append(len(rows))
                for g in sorted(shared.get(f, {})):
                    slots.append((i, g, shared[f][g]))
            captures.append(ShardCapture(
                fl, words, lens, np.asarray(starts, np.int64),
                np.asarray(rows, np.int32), np.asarray(opts, np.int8), slots))
        return cls(captures, intern, mesh, level_cap=level_cap, **kw)

    @classmethod
    def from_columnar(cls, filters: list, words: np.ndarray,
                      lens: np.ndarray, sub_start: np.ndarray,
                      sub_row: np.ndarray, sub_opts: np.ndarray,
                      intern: InternTable, *, n_devices: Optional[int] = None,
                      dp: Optional[int] = None, device=None,
                      **kw) -> "ShardedRouteEngine":
        """filters [F] strings with their interned words [F, L] and lens
        [F], and a CSR of normal subscribers (sub_start [F+1], sub_row,
        sub_opts). Vectorized per shard: no per-filter Python work beyond
        the crc32 of each filter string."""
        mesh = cls._mesh_of(n_devices or 8, dp, device)
        R = mesh.route
        shard = np.fromiter((shard_of(f, R) for f in filters), np.int64,
                            len(filters))
        names = np.asarray(filters)
        sub_start = np.asarray(sub_start, np.int64)
        cnt = np.diff(sub_start)
        captures = []
        for r in range(R):
            sel = np.flatnonzero(shard == r)
            sel = sel[np.argsort(names[sel], kind="stable")]
            c = cnt[sel]
            starts = np.concatenate([[0], np.cumsum(c)])
            src = np.repeat(sub_start[sel], c) + (
                np.arange(int(starts[-1])) - np.repeat(starts[:-1], c))
            captures.append(ShardCapture(
                names[sel].tolist(), np.asarray(words)[sel],
                np.asarray(lens, np.int64)[sel], starts,
                np.asarray(sub_row, np.int32)[src],
                np.asarray(sub_opts, np.int8)[src], []))
        return cls(captures, intern, mesh, level_cap=words.shape[1], **kw)

    # --- route -------------------------------------------------------------

    def _fallback(self, reason: str) -> None:
        fb = self.stats["fallback"]
        fb[reason] = fb.get(reason, 0) + 1

    def route_encoded(self, topics, lens, is_dollar, msg_hash,
                      too_long=None) -> MeshReadback:
        """Route one encoded window ([B, L] topics, [B] lens, dollar flags
        and hashes; numpy or tensors): step, exchange, and the plan
        readback — or the counted host gather. Advances the cursors."""
        dev = self.device

        def on(x, dtype):
            return torch.as_tensor(x).to(device=dev, dtype=dtype)

        B = int(np.shape(lens)[0])
        too_long = np.zeros(B, bool) if too_long is None \
            else np.asarray(too_long, bool)
        res = self.step(self.tables, self.cursors, on(topics, torch.int32),
                        on(lens, torch.int32), on(is_dollar, torch.bool),
                        on(msg_hash, torch.int32), self.strategy)
        self.cursors = res.new_cursors
        self.stats["windows"] += 1
        reason = "exchange"
        if too_long.any():
            reason = "host_idx"
        elif not self.exchange_fits:
            reason = "gfid_space"
        else:
            E = self._choose_ecap(B)
            ex = self.exchange_step(E)(res.matches, res.rows, res.opts,
                                       res.shared_sids, res.overflow,
                                       self.aux)
            landed, reason, _nbytes = self._land_exchange(ex)
            if landed is not None:
                plan, _cnt, scnt = landed
                rec, src = self._exchange_records(plan, scnt)
                self.stats["exchange_windows"] += 1
                return MeshReadback(True, reason, rec, src, None,
                                    np.zeros(B, bool))
        self._fallback(reason)
        return self.gather(res, reason, too_long)

    def gather(self, res, reason: str = "gather",
               too_long=None) -> MeshReadback:
        """The host gather of one window's step result: dense planes to
        the host, records in (source shard, msg, row) order; too-long and
        overflowed messages are left to the host."""
        dense = self.land_dense(res)
        host = dense["overflow"].any(1)
        if too_long is not None:
            host = host | too_long
        rec, src = self._gather_records(dense, host)
        return MeshReadback(False, reason, rec, src, dense, host)

    def _gather_records(self, dense: dict, host: np.ndarray):
        """Records from the dense planes, source shard asc, msg asc, row
        asc (the reference's gather consume), skipping host messages."""
        R = self.n_route
        seg = self.aux.seg_len.cpu().numpy()
        out, srcs = [], []
        for r in range(R):
            m = dense["matches"][:, r]
            ok = (m >= 0) & ~host[:, None]
            mi, _ = np.nonzero(ok)
            fids = m[ok].astype(np.int64)
            sl = seg[r][fids].astype(np.int64)
            total = int(sl.sum())
            row_msg = np.repeat(mi, sl)
            row_fid = np.repeat(fids, sl)
            # a message's rows fill columns 0.. in match order: a row's
            # column is its position past the first row of its message
            fid_start = np.cumsum(sl) - sl
            first = np.r_[True, mi[1:] != mi[:-1]] if mi.size else \
                np.zeros(0, bool)
            msg_start = np.maximum.accumulate(
                np.where(first, fid_start, 0)) if mi.size else fid_start
            col = np.arange(total) - np.repeat(msg_start, sl)
            sid = dense["rows"][row_msg, r, col]
            opt = dense["opts"][row_msg, r, col].astype(np.int32)
            keep = sid >= 0
            w2 = (row_fid + self.fid_off[r]).astype(np.int32) \
                | ((opt & 0x3F) << 24)
            out.append(np.stack([row_msg.astype(np.int32), sid, w2],
                                -1)[keep])
            srcs.append(np.full(int(keep.sum()), r, np.int32))
        return np.concatenate(out), np.concatenate(srcs)

    @staticmethod
    def session_order(rb: MeshReadback) -> np.ndarray:
        """The records grouped by session (sid asc), each session's in
        delivery order: two windows deliver alike to every session iff
        these arrays are equal."""
        return rb.records[np.argsort(rb.records[:, 1], kind="stable")]

    def sessions(self, rb: MeshReadback) -> dict:
        """Each session's delivery records in delivery order:
        sid → [N, 2] (msg, gfid | opt << 24)."""
        rec = self.session_order(rb)
        s = rec[:, 1]
        cuts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]]) if s.size \
            else np.zeros(0, np.int64)
        parts = np.split(rec[:, [0, 2]], cuts[1:])
        return {int(s[c]): p for c, p in zip(cuts, parts)}

    def route(self, topics: list, msg_hash=None) -> list:
        """Route topic strings; one Plan per topic, in order. Plan.fids
        are global filter ids (``self.filters``), sorted; rows and opts
        come per source shard, then delivery shard, in row order."""
        enc, lens, dollar, too_long = encode_topics_str(
            self.intern, topics, self.level_cap)
        if msg_hash is None:
            mh = np.array([zlib.crc32(t.encode()) & 0x7FFFFFFF
                           for t in topics], np.int32)
        else:
            mh = np.asarray(msg_hash, np.int32)
        B = self.batch
        plans: list = []
        for s in range(0, len(topics), B):
            n = min(len(topics) - s, B)

            def win(a):
                out = np.zeros((B,) + a.shape[1:], a.dtype)
                out[:n] = a[s:s + n]
                return out

            rb = self.route_encoded(win(enc), win(lens), win(dollar),
                                    win(mh), win(too_long))
            plans.extend(self._plans(rb, topics[s:s + n], mh[s:s + n]))
        return plans

    def _plans(self, rb: MeshReadback, topics: list, mh: np.ndarray) -> list:
        n = len(topics)
        rec, R = rb.records, self.n_route
        order = np.lexsort((rec[:, 1] % R, rb.src, rec[:, 0]))
        rec = rec[order]
        bounds = np.searchsorted(rec[:, 0], np.arange(n + 1))
        gfid = rec[:, 2] & (EXCHANGE_MAX_GFID - 1)
        opt = (rec[:, 2] >> 24) & 0x3F
        shared = self._shared_picks(rb.dense, n)
        fids_dense = self._dense_fids(rb.dense, n)
        plans = []
        for i in range(n):
            if rb.host[i]:
                plans.append(self._host_plan(topics[i], int(mh[i])))
                continue
            a, b = bounds[i], bounds[i + 1]
            fids = fids_dense[i] if fids_dense is not None \
                else np.unique(gfid[a:b])
            ss, sr, so = shared[i] if shared is not None else (
                np.zeros(0, np.int32),) * 3
            plans.append(Plan(fids.astype(np.int32), rec[a:b, 1].copy(),
                              opt[a:b].astype(np.int32), ss, sr, so))
        return plans

    def _dense_fids(self, dense, n: int):
        if dense is None:
            return None
        m = dense["matches"][:n]
        g = np.where(m >= 0, m + self.fid_off[None, :, None], -1)
        return [np.unique(row[row >= 0]) for row in g.reshape(n, -1)]

    def _shared_picks(self, dense, n: int):
        if dense is None:
            return None
        s = dense["shared_sids"][:n]
        i, r, k = np.nonzero(s >= 0)
        slots = (s[i, r, k] + self.slot_off[r]).astype(np.int32)
        rows = dense["shared_rows"][i, r, k]
        opts = dense["shared_opts"][i, r, k].astype(np.int32)
        cuts = np.searchsorted(i, np.arange(n + 1))
        return [(slots[a:b], rows[a:b], opts[a:b])
                for a, b in zip(cuts[:-1], cuts[1:])]

    # --- host completion ---------------------------------------------------

    def _host_plan(self, topic: str, mh: int) -> Plan:
        """Complete one message on the host: brute-force match over every
        shard's filters, each subscriber, and one pick per shared slot (a
        round-robin pick advances its device cursor by one)."""
        self.stats["host_messages"] += 1
        R = self.n_route
        recs, fids, slots, srows, sopts = [], [], [], [], []
        for r, c in enumerate(self.captures):
            st = self.subs_host[r]
            for fid, f in enumerate(c.filters):
                if not T.match(topic, f):
                    continue
                fids.append(int(self.fid_off[r]) + fid)
                for j in range(int(c.sub_start[fid]),
                               int(c.sub_start[fid + 1])):
                    sid = int(c.sub_row[j])
                    recs.append((r, sid % R, sid, int(c.sub_opts[j])))
                for s in st.fs_slot[int(st.fs_start[fid]):
                                    int(st.fs_start[fid + 1])]:
                    s = int(s)
                    lo = int(st.shared_start[s])
                    size = int(st.shared_start[s + 1]) - lo
                    slots.append(int(self.slot_off[r]) + s)
                    if size == 0:
                        srows.append(-1)
                        sopts.append(0)
                        continue
                    j = lo + self._pick_offset(r, s, size, mh)
                    srows.append(int(st.shared_row[j]))
                    sopts.append(int(st.shared_opts[j]))
        recs.sort(key=lambda x: (x[0], x[1]))
        arr = [np.array(x, np.int32) for x in (
            sorted(fids), [x[2] for x in recs], [x[3] for x in recs], slots,
            srows, sopts)]
        return Plan(*arr, host=True)

    def _pick_offset(self, r: int, slot: int, size: int, mh: int) -> int:
        if self.strategy in (STRATEGY_ROUND_ROBIN, STRATEGY_STICKY):
            cur = int(self.cursors[r, slot])
            if self.strategy == STRATEGY_ROUND_ROBIN:
                self.cursors[r, slot] += 1
            return cur % size
        base = int(hash_base(torch.tensor([mh], dtype=torch.int32),
                             torch.tensor([[slot]])))
        return base % size


# ---- the node's serving engine ---------------------------------------------


class _ShardBuilt:
    """Host index of one shard's compiled tables."""

    __slots__ = ("fid_of", "fid_filter", "seg_len", "slot_key", "rich",
                 "host_extra", "seg_np", "fid_slow", "cover_roots",
                 "cover_covered", "remote_members")

    def __init__(self):
        self.fid_of: dict[str, int] = {}
        self.fid_filter: list[str] = []
        self.seg_len: list[int] = []
        self.slot_key: list[tuple] = []      # local slot -> (filter, group)
        self.rich: set[str] = set()          # host-dict dispatch filters
        self.host_extra: list[tuple] = []    # too deep: (filter, words)
        self.seg_np = np.zeros(0, np.int64)  # seg_len as an array
        self.fid_slow = np.zeros(0, bool)    # rich OR slotted fids
        self.cover_roots = 0
        self.cover_covered = 0
        # device sid _REMOTE_SID_BASE+i -> (origin, remote sid)
        self.remote_members: list[tuple] = []


class _Handle:
    """One dispatched window (the PublishBatcher's handle protocol, one
    sub-batch). It pins the whole snapshot it was prepared against — the
    host index and the stacked tables, cursors and exchange companions —
    so a shard update applied while it is in flight can neither re-index
    its consume nor swap the tensors under its dispatch."""

    __slots__ = ("subs", "built", "tables", "cursors", "enc", "res",
                 "np_res", "t0", "host_idx", "trace", "sub_traces", "aux",
                 "exch", "exch_bytes", "exch_fits", "pcap", "delta", "plan",
                 "n_msgs", "cost_s", "abandoned", "error", "corrupt",
                 "on_release", "released", "host", "event", "__weakref__")

    def __init__(self, subs, built, tables, cursors, enc, host_idx,
                 aux=None, exch_fits=True):
        self.subs = subs          # [[Message, ...]]: one sub-batch
        self.built = built        # list[_ShardBuilt] snapshot; None once
        self.tables = tables      # released
        self.cursors = cursors
        self.enc = enc            # (topics, lens, dollar, hashes) tensors
        self.host_idx = host_idx  # msg indexes forced host-side (too long)
        self.res = None
        self.np_res = None
        self.trace = 0            # flight-recorder window trace
        self.sub_traces = None
        self.t0: Optional[float] = None
        self.aux = aux            # ExchangeAux snapshot
        self.exch = None          # ExchangeResult once the stage ran
        self.exch_bytes = 0       # bytes the exchange landing cost
        self.exch_fits = exch_fits  # snapshot's gfid-space verdict
        self.pcap = None          # payload class of a CSR gather
        self.delta = None         # (the single-chip engine's reuse
        self.plan = None          #  layers: never on the mesh)
        self.n_msgs = len(subs[0])
        self.cost_s = 0.0         # prepare + dispatch + readback seconds
        self.abandoned = False
        self.error = None
        self.corrupt = False
        self.on_release = None
        self.released = False
        self.host = None          # pinned copies started at dispatch end
        self.event = None         # recorded behind them


class ShardedRouteServer(_MeshCore):
    """Serve a node's publishes through a dp×route mesh of trie shards.

    ``n_devices`` shards (default 8) split into ``dp`` rows (default 1)
    of route shards, all on the node's device. ``max_batch`` (256) is the
    largest window; windows are padded to power-of-two classes from
    ``dp`` up. Routes are read from the node's broker; ``Node`` builds
    the server under ``broker.multichip.enable``."""

    def __init__(self, node, *, n_devices: Optional[int] = None,
                 dp: Optional[int] = None, device=None,
                 frontier_cap: int = 16, match_cap: int = 64,
                 fanout_cap: int = 128, slot_cap: int = 16,
                 level_cap: int = 16, max_batch: int = 256,
                 compact_readback: Optional[bool] = None,
                 delta_overlay: Optional[bool] = None,
                 dispatch_depth: Optional[int] = None,
                 device_exchange: Optional[bool] = None,
                 subscription_covering: Optional[bool] = None):
        from emqx_tpu_torch.broker.batcher import resolve_dispatch_depth
        self.node = node
        self.broker = node.broker
        self.router = node.broker.router
        dev = device if device is not None else getattr(node, "device",
                                                        None)
        mesh = make_mesh(n_devices or 8, dp=dp,
                         devices=None if dev is None else [dev])
        self._init_core(mesh, InternTable(), frontier_cap=frontier_cap,
                        match_cap=match_cap, fanout_cap=fanout_cap,
                        slot_cap=slot_cap, level_cap=level_cap,
                        subscription_covering=subscription_covering,
                        ledger=getattr(node, "hbm_ledger", None))
        # pow2: _batch_class quantizes onto the doubling warm ladder
        self.max_batch = _batch_pow2(max_batch)
        self._STD_CLASSES = ((1, self.max_batch),)
        self._enc_cache: dict[str, list] = {}   # filter -> interned words

        self.tables = None            # stacked device tables [R, ...]
        self.cursors = None           # device [R, G]
        self._builts: Optional[list] = None
        self._caps: Optional[dict] = None
        self.dirty_shards: set[int] = set()
        self._warm_classes: set[int] = set()
        self._warm_thread: Optional[threading.Thread] = None
        self._rebuild_thread: Optional[threading.Thread] = None
        self._capture_task = None     # pending chunked capture (loop)
        # build generations: a result adopts only if its generation is
        # newer than the adopted one; a capture whose generation is no
        # longer current was superseded and is dropped
        self._build_gen = 0
        self._adopted_gen = 0
        self._capture_gen = 0
        self._rebuild_backoff_until = 0.0
        self._lock = threading.Lock()   # dispatch thread vs loop updates

        # the CSR readback of gathered windows: payload classes (Bp, P)
        # sized by a peak-biased EWMA, warmed beside the batch classes;
        # off, every gathered window reads back dense
        self.compact_readback = resolve_compact_readback(compact_readback)
        self._payload_mults = (8, 32, 128)
        self._pay_ewma: Optional[float] = None
        self._compact_warm: set[tuple] = set()    # {(Bp, P)}
        self._wanted_pcap: set[tuple] = set()
        # the mesh's churn path is already incremental (per-shard
        # rebuilds): the overlay key is accepted and reported in stats
        self.delta_overlay = True if delta_overlay is None \
            else bool(delta_overlay)
        self.dispatch_depth = resolve_dispatch_depth(dispatch_depth)
        # the device-to-device exchange and its segment classes (Bp, E)
        self.device_exchange = resolve_device_exchange(device_exchange)
        self.aux = None                   # device ExchangeAux [R, ...]
        self._exch_warm: set[tuple] = set()
        self._wanted_ecap: set[tuple] = set()
        self._exch_fits = True            # global fid space < 2^24
        self._flat_memo: Optional[tuple] = None
        self._outstanding = 0             # prepared, not yet released

        # on the card a dispatch syncs at every NFA level, so it keeps
        # the batcher's dispatch thread; a device failure raises and a
        # failure off the serving path is kept here
        cuda = self.device.type == "cuda"
        self.dispatch_on_loop = False
        self.fail_on_device_error = cuda
        self.failed: Optional[BaseException] = None

        self.tele = getattr(node, "pipeline_telemetry", None)
        self.rec = getattr(node, "flight_recorder", None)
        # the mesh_exchange fault domain: its breaker gates the whole
        # sharded path (open: prepare_window declines and the batcher
        # routes on the host), its injection point rides dispatch
        self.sup = getattr(node, "supervisor", None)
        self.probe_launches: dict[str, int] = {}
        if self.sup is not None:
            self.sup.register_probe("mesh_exchange", self._probe_mesh)
        self.broker.device_engine = self
        node.device_engine = self
        self.router.on_route_change = self.note_route_change

    # ---- churn tracking -------------------------------------------------
    def shard_of(self, topic_filter: str) -> int:
        return shard_of(topic_filter, self.n_route)

    def note_route_change(self, topic_filter: str, added: bool) -> None:
        self.dirty_shards.add(self.shard_of(topic_filter))

    def note_member_change(self, real: str, group) -> None:
        self.dirty_shards.add(self.shard_of(real))

    # ---- build ----------------------------------------------------------
    def _bucket_filters(self) -> list:
        """The filter universe → per-shard lists."""
        buckets: list = [[] for _ in range(self.n_route)]
        for f in list(self.router.exact) + list(self.router.wildcards):
            buckets[self.shard_of(f)].append(f)
        return buckets

    def _capture_filters(self, fs, subs: dict, shared: dict) -> None:
        """Capture filters `fs` into the subs/shared dicts: one body for
        the sync shard capture and the chunked async capture."""
        broker = self.broker
        for f in fs:
            s = broker.subs.get(f)
            if s:
                subs[f] = list(s.items())
            cap = capture_shared(broker, f)
            if cap:
                shared[f] = cap

    def _capture_shard(self, mine: list):
        """(filters, subs, shared) of one shard's bucketed filters."""
        subs: dict = {}
        shared: dict = {}
        self._capture_filters(mine, subs, shared)
        return mine, subs, shared

    @staticmethod
    def _live_dims(capture) -> dict:
        """The raw dims one shard's live capture needs (too-deep filters
        included, as the reference counts them)."""
        mine, subs, shared = capture
        return {
            "filters": len(mine),
            "nodes": sum(len(T.tokens(f)) for f in mine) + 1,
            "subs": sum(len(v) for v in subs.values()),
            "slots": sum(len(g) for g in shared.values()),
            "members": sum(len(m[0]) for g in shared.values()
                           for m in g.values()),
        }

    @staticmethod
    def _fits(dims: dict, caps: dict) -> bool:
        return all(dims[k] <= caps[k] for k in dims)

    def _words(self, f: str, ws: list) -> list:
        w = self._enc_cache.get(f)
        if w is None:
            w = self._enc_cache[f] = self.intern.encode_filter(ws)
        return w

    def _build_live_shard(self, capture, caps: dict):
        """Compile one shard's live capture into (built, RouterTables of
        numpy planes, seg, slow, cursor row) at the capacity classes:
        the capture becomes a ShardCapture of the filters the trie can
        hold (sorted; filters deeper than the level cap match on the host
        per message) and goes through the shared shard build."""
        mine, subs_cap, shared_cap = capture
        b = _ShardBuilt()
        L = self.level_cap
        dev_f = []
        for f in mine:
            ws = T.tokens(f)
            if len(ws) > L:
                b.host_extra.append((f, ws))
            else:
                dev_f.append(f)
        dev_f.sort()
        n = len(dev_f)
        words = np.full((n, L), PAD, np.int32)
        lens = np.zeros(n, np.int64)
        rows, opts, starts, slots, cursors = [], [], [0], [], []
        for fid, f in enumerate(dev_f):
            ids = self._words(f, T.tokens(f))
            words[fid, :len(ids)] = ids
            lens[fid] = len(ids)
            b.fid_of[f] = fid
            for sid, o in subs_cap.get(f, ()):
                # rich subopts (v5 subscription ids) don't survive the
                # packed byte: the rows stay, delivery goes through the
                # host dict
                if _is_rich(o):
                    b.rich.add(f)
                rows.append(sid)
                opts.append(_pack_opts(o))
            starts.append(len(rows))
            for g in sorted(shared_cap.get(f, {})):
                members_raw, cursor = shared_cap[f][g]
                b.slot_key.append((f, g))
                members = []
                for sid, o in members_raw:
                    if isinstance(sid, tuple):
                        # remote member ref -> reserved-range device sid
                        dev_sid = _REMOTE_SID_BASE + len(b.remote_members)
                        b.remote_members.append(sid)
                        members.append((dev_sid, 0))
                    else:
                        members.append((sid, _pack_opts(o)))
                slots.append((fid, g, members))
                cursors.append(cursor)
        b.fid_filter = dev_f
        c = ShardCapture(dev_f, words, lens, np.asarray(starts, np.int64),
                         np.asarray(rows, np.int32),
                         np.asarray(opts, np.int8), slots)
        tables, seg, slow, n_roots = self._build_shard(c, caps)
        for f in b.rich:
            slow[b.fid_of[f]] = True
        b.seg_np = seg[:n].astype(np.int64)
        b.seg_len = b.seg_np.tolist()
        b.fid_slow = slow
        if self.subscription_covering:
            b.cover_roots = n_roots
            b.cover_covered = n - n_roots
        cur = np.zeros(caps["slots"], np.int32)
        cur[:len(cursors)] = cursors
        return b, tables, seg, slow, cur

    def _next_gen(self) -> int:
        self._build_gen += 1
        return self._build_gen

    def rebuild(self) -> None:
        """Full build, synchronously: capture every shard, compile, stack
        and upload. Direct callers (tests, warm-up) use this; the serving
        path hands full builds to a background thread and serves on the
        host meanwhile. A build in flight is superseded."""
        gen = self._next_gen()
        seen = set(self.dirty_shards)
        self.dirty_shards.clear()   # the capture below covers everything
        try:
            self._adopt_full_build(self._full_build(
                [self._capture_shard(mine)
                 for mine in self._bucket_filters()]), gen)
        except Exception:
            # the old snapshot keeps serving and those shards still need
            # their repair
            self.dirty_shards |= seen
            raise

    def _full_build(self, captures):
        """Compile every shard (loop-free: safe on a thread). Returns
        (caps, builts, tables, cursors, aux, fits)."""
        t0 = time.perf_counter()
        dims = [self._live_dims(c) for c in captures]
        caps = self._caps_of({k: max(d[k] for d in dims)
                              for k in dims[0]})
        built = [self._build_live_shard(c, caps) for c in captures]
        builts = [x[0] for x in built]
        stacked = stack_tables([x[1] for x in built])
        with self._cuda_lock:
            tables, cursors = put_sharded(
                self.mesh, stacked, np.stack([x[4] for x in built]),
                ledger=self.ledger)
        aux, fits = None, True
        if self.device_exchange:
            offs, fits = self._fid_offsets([len(b.fid_filter)
                                            for b in builts])
            aux = self._aux_tensors(np.stack([x[2] for x in built]),
                                    np.stack([x[3] for x in built]), offs)
        if self.tele is not None:
            self.tele.observe_rebuild("build", time.perf_counter() - t0)
        return caps, builts, tables, cursors, aux, fits

    def _update_aux_shard(self, s: int, seg, slow, builts) -> ExchangeAux:
        """Per-shard churn twin of the companions' build: slice-update
        the seg/slow planes (non-donating, like the tables) and recompute
        the fid bases, which shift for every shard after `s` when its
        filter count changed."""
        offs, fits = self._fid_offsets([len(b.fid_filter) for b in builts])
        self._exch_fits = fits
        new = [x.clone() for x in (self.aux.seg_len, self.aux.fid_slow)]
        new[0][s].copy_(torch.from_numpy(seg))
        new[1][s].copy_(torch.from_numpy(slow))
        return ExchangeAux(new[0], new[1],
                           torch.from_numpy(offs).to(self.device))

    def _adopt_full_build(self, result, gen: int) -> bool:
        caps, builts, tables, cursors, aux, fits = result
        with self._lock:
            if gen <= self._adopted_gen:
                return False    # a newer build already adopted: drop
            self._adopted_gen = gen
            self.tables = tables
            self.cursors = cursors
            self._builts = builts
            if caps != self._caps:
                # the capacity classes are the warm signature: only a
                # class change makes the classes cold again
                self._warm_classes.clear()
                self._exch_warm.clear()
            self._caps = caps
            self.aux = self._hold("exchange_aux", aux) \
                if aux is not None else None
            self._exch_fits = fits
        self.node.metrics.inc("routing.mesh.rebuilds")
        return True

    def _fail(self, e: BaseException) -> None:
        """A device failure off the serving path (a background build or
        warm-up): on the card it is kept and raised to every later
        window; on the CPU the reference's retry stands."""
        if self.fail_on_device_error and self.failed is None:
            self.failed = e

    def _check_failed(self) -> None:
        if self.failed is not None:
            raise RuntimeError("the mesh route server failed") \
                from self.failed

    def _kick_full_rebuild(self) -> None:
        """Background full build: the capture runs on the loop in
        yielding chunks, the compile and upload on a thread; windows
        route on the host until the swap. Dirty marks clear before the
        capture starts (churn landing meanwhile re-dirties its shard and
        follows as a per-shard update); a failed build restores them and
        backs off for 5 s."""
        if self._rebuild_thread is not None \
                and self._rebuild_thread.is_alive():
            return
        if self._capture_task is not None \
                and not self._capture_task.done():
            return
        if time.monotonic() < self._rebuild_backoff_until:
            return
        gen = self._next_gen()
        seen = set(self.dirty_shards)
        self.dirty_shards -= seen
        self.node.metrics.inc("routing.mesh.full_rebuilds")
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._start_build_thread(
                [self._capture_shard(mine)
                 for mine in self._bucket_filters()], seen, gen)
            return
        self._capture_gen = gen
        self._capture_task = guard_task(
            loop.create_task(self._capture_then_build(seen, gen)),
            "mesh-capture", self.node.metrics)

    async def _capture_then_build(self, seen, gen: int) -> None:
        chunk = 2048
        t0 = time.perf_counter()
        try:
            captures = []
            for mine in self._bucket_filters():
                subs: dict = {}
                shared: dict = {}
                for i in range(0, len(mine), chunk):
                    self._capture_filters(mine[i:i + chunk], subs, shared)
                    await asyncio.sleep(0)
                captures.append((mine, subs, shared))
        except Exception:   # noqa: BLE001 — surfaced and retried
            log.exception("chunked mesh capture failed; backing off")
            self.dirty_shards |= seen
            self._rebuild_backoff_until = time.monotonic() + 5.0
            return
        if self.tele is not None:
            self.tele.observe_rebuild("capture", time.perf_counter() - t0)
        if gen != self._build_gen:
            # superseded: drop the captures, restore the marks
            self.dirty_shards |= seen
            return
        self._start_build_thread(captures, seen, gen)

    def _start_build_thread(self, captures, seen, gen: int) -> None:
        def work():
            try:
                result = self._full_build(captures)
            except Exception as e:   # noqa: BLE001 — surfaced and retried
                log.exception("background mesh rebuild failed")
                self.node.metrics.inc("routing.mesh.rebuild_failed")
                self.dirty_shards |= seen
                self._rebuild_backoff_until = time.monotonic() + 5.0
                self._fail(e)
                return
            if not self._adopt_full_build(result, gen):
                self.dirty_shards |= seen

        self._rebuild_thread = threading.Thread(target=work, daemon=True)
        self._rebuild_thread.start()

    def _rebuilding(self) -> bool:
        return (self._rebuild_thread is not None
                and self._rebuild_thread.is_alive()) or \
            (self._capture_task is not None
             and not self._capture_task.done()
             and self._capture_gen == self._build_gen)

    def poll_rebuild(self) -> bool:
        """Apply pending churn before serving: each dirty shard rebuilds
        on the host at the snapshot's classes and only its slices update
        (non-donating: handles in flight keep the previous tensors); a
        shard outgrowing its class starts a background full build.
        Returns False while the mesh cannot serve (no snapshot yet, or a
        full build in flight) — callers route on the host. The
        supervisor's tick rides the same call (the batcher makes it for
        every window, the host-routed ones included)."""
        self._check_failed()
        if self.sup is not None:
            self.sup.poll()
        if self._rebuilding():
            return False
        if self._builts is None:
            self._kick_full_rebuild()
            return False
        if not self.dirty_shards:
            return True
        buckets = self._bucket_filters()
        for s in sorted(self.dirty_shards):
            capture = self._capture_shard(buckets[s])
            if not self._fits(self._live_dims(capture), self._caps):
                self._kick_full_rebuild()
                return False
            b, t, seg, slow, cur = self._build_live_shard(capture,
                                                          self._caps)
            # the device lock first: a warm-up thread takes _lock inside it
            with self._cuda_lock, self._lock:
                self.tables = self._hold("mesh_tables", update_shard(
                    self.tables, s, t, donate=False))
                cursors = self.cursors.clone()
                cursors[s] = torch.from_numpy(cur)
                self.cursors = self._hold("mesh_cursors", cursors)
                # copy-on-write: handles in flight keep the list they
                # captured, and dispatch's `_builts is h.built` cursor
                # guard fires for them
                builts = list(self._builts)
                builts[s] = b
                self._builts = builts
                if self.aux is not None:
                    self.aux = self._hold("exchange_aux",
                                          self._update_aux_shard(
                                              s, seg, slow, builts))
                self.dirty_shards.discard(s)
            self.node.metrics.inc("routing.mesh.shard_updates")
        return True

    # ---- PublishBatcher engine protocol ---------------------------------
    def _batch_class(self, n: int) -> int:
        return min(self.max_batch,
                   max(self.n_dp, _batch_pow2(max(2, n))))

    def batch_class_warm(self, n_msgs: int) -> bool:
        return self._builts is not None and \
            self._batch_class(n_msgs) in self._warm_classes

    def max_fuse(self) -> int:
        return 1        # no window fusion on the mesh

    def preencode_burst(self, topics: list) -> None:
        """The columnar ingress's burst pre-encode: the mesh encodes each
        window itself."""

    def _kick_class_warm(self) -> None:
        """Run every batch class once, and the CSR payload and exchange
        classes windows asked for, off the serving path."""
        if self._warm_thread is not None and self._warm_thread.is_alive():
            return
        if self._builts is None:
            return

        def warm():
            classes = []
            Bp = self.n_dp
            while Bp <= self.max_batch:
                classes.append(Bp)
                Bp *= 2
            for _ in range(8 * (len(classes) + 4)):   # bounded self-heal
                if self._builts is None:
                    return
                missing = [c for c in classes
                           if c not in self._warm_classes]
                want_c = sorted({bq for bq, P in list(self._wanted_pcap)
                                 if (bq, P) not in self._compact_warm})
                want_e = sorted({bq for bq, E in list(self._wanted_ecap)
                                 if (bq, E) not in self._exch_warm})
                if not missing and not want_c and not want_e:
                    return
                try:
                    self._warm_one((missing + want_c + want_e)[0])
                except Exception as e:   # noqa: BLE001 — kept on the card
                    log.exception("mesh class warm-up failed")
                    self._fail(e)
                    return

        self._warm_thread = threading.Thread(target=warm, daemon=True)
        self._warm_thread.start()

    def _warm_one(self, Bp: int) -> list:
        """One warm-shaped step at batch class Bp over an all-pad batch,
        then the wanted CSR payload and exchange classes of that Bp on
        its result. Its kernel launches serve no traffic: they are
        recorded, not counted, and returned."""
        with D.recording_launches() as calls:
            self._warm_one_inner(Bp)
        return calls

    def _warm_one_inner(self, Bp: int) -> None:
        enc = self._enc_tensors(
            np.full((Bp, self.level_cap), PAD, np.int32),
            np.zeros(Bp, np.int32), np.zeros(Bp, bool),
            np.zeros(Bp, np.int32))
        with self._lock:
            tables, cursors, caps = self.tables, self.cursors, self._caps
            aux = self.aux
        with self._cuda_lock:
            res = self.step(tables, cursors, *enc,
                            STRATEGY_ROUND_ROBIN)
            for bq, P in sorted(self._wanted_pcap):
                if bq != Bp or (Bp, P) in self._compact_warm:
                    continue
                self._compact(res, P).offsets.cpu()
                self._compact_warm.add((Bp, P))
            if aux is not None:
                for bq, E in sorted(self._wanted_ecap):
                    if bq != Bp or (Bp, E) in self._exch_warm:
                        continue
                    self.exchange_step(E)(res.matches, res.rows, res.opts,
                                          res.shared_sids, res.overflow,
                                          aux).plan.cpu()
                    with self._lock:
                        if self._caps == caps:
                            self._exch_warm.add((Bp, E))
            res.overflow.cpu()
        with self._lock:
            if self._caps == caps:      # the signature is still current
                self._warm_classes.add(Bp)

    def _probe_mesh(self) -> None:
        """The mesh_exchange half-open probe: a warm-shaped step at the
        smallest class off the serving path, with the exchange step at
        that class when the exchange is on (the domain covers the ring).
        Raising keeps the breaker open; an error the ladder does not
        contain on the card also fails the server."""
        if self._builts is None:
            return      # nothing to probe: vacuous health
        if self.device_exchange and self.aux is not None \
                and self._exch_fits:
            key = (self.n_dp, self._choose_ecap(self.n_dp))
            self._wanted_ecap.add(key)
            self._exch_warm.discard(key)
        try:
            calls = self._warm_one(self.n_dp)
        except Exception as e:
            if not contained(e, self.fail_on_device_error):
                self._fail(e)
            raise
        for name, shape in calls:
            D.count_launch(name, shape)
            self.probe_launches[name] = self.probe_launches.get(name, 0) + 1

    def warm_exchange(self, n_msgs: int) -> bool:
        """Blocking warm of the exchange class serving `n_msgs`-wide
        windows (tests and warm-ups; the serving path asks for classes
        and warms them in the background)."""
        if not self.device_exchange or self._builts is None \
                or self.aux is None:
            return False
        Bp = self._batch_class(n_msgs)
        key = (Bp, self._choose_ecap(Bp))
        self._wanted_ecap.add(key)
        self._warm_one(Bp)
        return key in self._exch_warm

    def _enc_tensors(self, enc, lens, dollar, msg_hash) -> tuple:
        dev = self.device
        return (torch.from_numpy(np.ascontiguousarray(enc)).to(dev),
                torch.from_numpy(np.ascontiguousarray(lens, np.int32))
                .to(dev),
                torch.from_numpy(np.ascontiguousarray(dollar, bool)).to(dev),
                torch.from_numpy(np.ascontiguousarray(msg_hash, np.int32))
                .to(dev))

    def prepare(self, msgs: list) -> Optional[_Handle]:
        return self.prepare_window([msgs])

    def prepare_window(self, lives, gate_cold: bool = True) -> \
            Optional[_Handle]:
        """Stage 1 (event loop): encode one micro-batch. The single-chip
        engine's match cache and dedup are bypassed: the shards' slices
        update independently, so there is no one snapshot a cached row
        could be keyed to."""
        t0 = time.perf_counter()
        serving = self.poll_rebuild()
        if self.sup is not None and not self.sup.mesh_enabled():
            # mesh_exchange breaker open: host route until the half-open
            # probe proves the mesh healthy
            self.node.metrics.inc("routing.mesh.supervised_bypass")
            return None
        if not serving:
            if self._builts is not None:
                self.node.metrics.inc("routing.mesh.rebuild_host",
                                      sum(len(m) for m in lives))
            return None
        if self._builts is None or not lives:
            return None
        msgs = lives[0]
        Bp = self._batch_class(len(msgs))
        if len(msgs) > Bp:
            return None
        enc, lens, dollar, too_long = encode_topics_str(
            self.intern, [m.topic for m in msgs], self.level_cap)
        host_idx = set(np.flatnonzero(too_long).tolist())
        pad = Bp - len(msgs)
        if pad:
            enc = np.vstack([enc, np.full((pad, self.level_cap), PAD,
                                          np.int32)])
            lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
            dollar = np.concatenate([dollar, np.zeros(pad, bool)])
        msg_hash = np.array(
            [zlib.crc32(m.topic.encode()) & 0x7FFFFFFF for m in msgs]
            + [0] * pad, np.int32)
        if self.tele is not None:
            self.tele.record_occupancy(f"b{Bp}", len(msgs) / Bp)
        with self._cuda_lock:
            enc_t = self._enc_tensors(enc, lens, dollar, msg_hash)
        with self._lock:
            h = _Handle(subs=[msgs], built=self._builts,
                        tables=self.tables, cursors=self.cursors,
                        enc=enc_t, host_idx=host_idx, aux=self.aux,
                        exch_fits=self._exch_fits)
        self._outstanding += 1
        if self.ledger is not None:
            self.ledger.note_window()
            self.ledger.pin(id(h), h)
        h.cost_s += time.perf_counter() - t0
        return h

    def dispatch(self, h: _Handle) -> None:
        """Stage 2 (dispatch thread): the sharded step on the handle's
        pinned snapshot, then the exchange. Cursors thread from the live
        ones unless a shard update raced (then the pinned ones: the only
        set consistent with the handle's slot layout)."""
        strategy = STRATEGIES.get(self.broker.shared_strategy, 0)
        t0 = time.perf_counter()
        with self._lock:
            cursors = self.cursors if self._builts is h.built \
                else h.cursors
        try:
            if self.sup is not None:
                # the mesh_exchange injection point: a raise goes to the
                # batcher's stage await (host replay where contained)
                self.sup.fire("mesh_exchange")
            with self._cuda_lock:
                h.res = self.step(h.tables, cursors, *h.enc, strategy)
        except Exception as e:
            if self.sup is not None:
                self.sup.note_fault("mesh_exchange", e)
                if not contained(e, self.fail_on_device_error):
                    self._fail(e)
            raise
        with self._lock:
            if self._builts is h.built:    # no update raced
                self.cursors = self._hold("mesh_cursors",
                                          h.res.new_cursors)
        # the domain's ok only once the step AND the ring succeeded: an
        # ok for the step alone would reset the breaker's count right
        # before a persistently dead ring's fault
        exchange_faulted = self._run_exchange(h)
        if self.sup is not None and not exchange_faulted:
            self.sup.note_ok("mesh_exchange")
        if self.dispatch_depth > 1:
            # materialize(W) then waits on copies already under way while
            # dispatch(W+1) runs
            self._start_readback(h)
        dt = time.perf_counter() - t0
        h.cost_s += dt
        if self.tele is not None:
            self.tele.observe_stage("dispatch", dt)
        self._rec_span(h.trace, "dispatch", t0, track="dispatch")

    def _start_readback(self, h: _Handle) -> None:
        """On the card, start the device → host copies of the small planes
        materialize reads first — overflow and occur, and an exchange
        window's ok, plan_cnt and src_cnt — into pinned host tensors, with
        an event recorded behind them. The result registers with the HBM
        ledger under ``pipeline_buffers`` while it is in flight."""
        r = h.res
        if r is None or self.device.type != "cuda":
            return
        self._hold("pipeline_buffers", r)
        planes = {"overflow": r.overflow, "occur": r.occur}
        if h.exch is not None:
            planes.update(ok=h.exch.ok, plan_cnt=h.exch.plan_cnt,
                          src_cnt=h.exch.src_cnt)
        with self._cuda_lock:
            host = {}
            for k, v in planes.items():
                host[k] = torch.empty(v.shape, dtype=v.dtype,
                                      pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        h.host, h.event = host, ev

    def _read(self, h: _Handle, name: str, t) -> np.ndarray:
        """Plane `name` of the window on the host: its pinned copy once the
        dispatch's event completed, else a plain copy."""
        if h.host is not None and name in h.host:
            h.event.synchronize()
            return h.host[name].numpy()
        with self._cuda_lock:
            return t.cpu().numpy()

    def _choose_pcap(self, Bp: int) -> Optional[int]:
        """Payload class of a Bp-wide gather's CSR readback, or None for
        the dense planes (the single-chip engine's peak-biased EWMA and
        pow2-multiple ladder; entries sum over shards, so the ladder
        multiplies Bp). None when ``compact_readback`` is off."""
        if not self.compact_readback:
            return None
        dense = self.match_cap + 2 * self.fanout_cap + 3 * self.slot_cap
        mults = [m for m in self._payload_mults if m < dense]
        if not mults:
            return None
        ew = self._pay_ewma
        if ew is None:
            return mults[min(1, len(mults) - 1)] * Bp
        for m in mults:
            if m * Bp >= 2.0 * ew:
                return m * Bp
        return None

    def _note_payload(self, total: float) -> None:
        ew = self._pay_ewma
        self._pay_ewma = total if (ew is None or total > ew) \
            else 0.8 * ew + 0.2 * total

    def _run_exchange(self, h: _Handle) -> bool:
        """Stage 2b (dispatch thread): the exchange on the handle's pinned
        (result, companions). Every stand-down is counted. A raising
        exchange gathers THIS window on the CPU and advances the
        mesh_exchange breaker; on the card an error the injector did not
        cause raises. Returns True iff the exchange faulted."""
        if not self.device_exchange or h.aux is None or h.res is None:
            return False
        metrics = self.node.metrics
        if not h.exch_fits:
            metrics.inc("pipeline.exchange.fallback.gfid_space")
            return False
        if self.broker.cluster is not None \
                or self.broker.shared_strategy not in STRATEGIES \
                or any(b.host_extra for b in h.built):
            metrics.inc("pipeline.exchange.fallback.precluded")
            return False
        if h.host_idx:
            metrics.inc("pipeline.exchange.fallback.host_idx")
            return False
        Bp = int(h.res.matches.shape[0])
        E = self._choose_ecap(Bp)
        if (Bp, E) not in self._exch_warm:
            # target class cold: warm it in the background, and serve
            # with the largest warm class that holds the observed peak
            self._wanted_ecap.add((Bp, E))
            self._kick_class_warm()
            ew = self._exch_ewma
            cand = [e for bq, e in sorted(self._exch_warm)
                    if bq == Bp and (ew is None or e >= ew)]
            if not cand:
                metrics.inc("pipeline.exchange.cold_class")
                return False
            E = max(cand)
        fn = self._exch_steps.get(E)
        if fn is None:
            metrics.inc("pipeline.exchange.cold_class")
            return False
        t0 = time.perf_counter()
        r = h.res
        try:
            with self._cuda_lock:
                h.exch = fn(r.matches, r.rows, r.opts, r.shared_sids,
                            r.overflow, h.aux)
        except Exception as e:
            if self.sup is not None:
                self.sup.note_fault("mesh_exchange", e)
            if not contained(e, self.fail_on_device_error):
                self._fail(e)
                raise
            metrics.inc("pipeline.exchange.fallback.error")
            h.exch = None
            return True
        self._hold("exchange_buffers", h.exch)
        R = self.n_route
        metrics.inc("pipeline.exchange.rounds", R - 1)
        metrics.inc("pipeline.exchange.bytes_exchanged",
                    self.n_dp * R * ((R - 1) * E * 12 + R * 4))
        if self.tele is not None:
            self.tele.observe_stage("exchange", time.perf_counter() - t0)
        self._rec_span(h.trace, "exchange", t0, track="dispatch")
        return False

    def materialize(self, h: _Handle) -> None:
        """Stage 3 (readback thread): device → host. An exchange window
        lands its plans; a gathered one compacts its [B, R, ...] planes
        to one CSR pseudo-window (lane i*R + r) and lands offsets and
        entries, or the dense planes when the payload class is cold or
        outgrown."""
        t0 = time.perf_counter()
        try:
            self._materialize(h)
        except Exception as e:
            if not contained(e, self.fail_on_device_error):
                self._fail(e)
            raise
        dt = time.perf_counter() - t0
        h.cost_s += dt
        if self.tele is not None:
            self.tele.observe_stage("materialize", dt)
        self._rec_span(h.trace, "materialize", t0, track="materialize")

    def _materialize(self, h: _Handle) -> None:
        metrics = self.node.metrics
        r = h.res
        if h.exch is not None and self._materialize_exchange(h, metrics):
            return
        Bp = int(r.matches.shape[0])
        P = self._choose_pcap(Bp)
        if P is not None and (Bp, P) not in self._compact_warm:
            self._wanted_pcap.add((Bp, P))
            self._kick_class_warm()
            metrics.inc("routing.device.cold_compact_class")
            P = None
        probe_bytes = 0
        if P is not None:
            with self._cuda_lock:
                cp = self._compact(r, P)
                off = cp.offsets[0].cpu().numpy()
                c3 = cp.counts3[0].cpu().numpy()
                rovf = cp.row_overflow.cpu().numpy()
            self._note_payload(float(off[-1]))
            if rovf.any():
                metrics.inc("routing.device.compact_overflow")
                probe_bytes = off.nbytes + c3.nbytes + rovf.nbytes
            else:
                with self._cuda_lock:
                    pay = cp.payload[0, :int(off[-1])].cpu().numpy()
                overflow = self._read(h, "overflow", r.overflow)
                occur = self._read(h, "occur", r.occur)
                h.pcap = P
                h.np_res = {"csr": (off, c3, pay), "overflow": overflow,
                            "occur": occur}
                metrics.inc("pipeline.readback.bytes.compact",
                            off.nbytes + c3.nbytes + pay.nbytes
                            + overflow.nbytes + occur.nbytes)
                metrics.inc("pipeline.readback.windows.compact")
                return
        h.np_res = self._dense_np_res(r)
        metrics.inc("pipeline.readback.bytes.dense",
                    sum(a.nbytes for a in h.np_res.values()) + probe_bytes)
        metrics.inc("pipeline.readback.windows.dense")

    def _compact(self, r, P: int):
        """The CSR compaction of one window's [B, R, ...] planes as one
        [1, B*R] pseudo-window (the trie's matches are prefix-packed)."""
        B, R = r.matches.shape[:2]

        def flat(x):
            return x.reshape((1, B * R) + tuple(x.shape[2:]))

        return compact_result(
            flat(r.matches), flat(r.rows), flat(r.opts), flat(r.fan_counts),
            flat(r.shared_sids), flat(r.shared_rows), flat(r.shared_opts),
            payload_cap=P, match_holes=False)

    def _dense_np_res(self, r) -> dict:
        with self._cuda_lock:
            out = self.land_dense(r)
            out["occur"] = r.occur.cpu().numpy()        # [R, G]
        return out

    def _fast_lane_live_ok(self, builts) -> bool:
        """THE live-state guard of every fast lane (the vectorized
        consume, the exchange landing and consume): churn marks, a raced
        snapshot swap, a build in flight, a non-device strategy or
        too-deep filters mean the snapshot's clean masks can no longer be
        trusted."""
        return not (self.broker.cluster is not None or self.dirty_shards
                    or builts is not self._builts
                    or self._rebuilding()
                    or self.broker.shared_strategy not in STRATEGIES
                    or any(b.host_extra for b in builts))

    def _materialize_exchange(self, h: _Handle, metrics) -> bool:
        """Land the exchange result if every device reported clean and in
        capacity; else count the reason and let the gather land the
        window. Returns True when the plans were landed."""
        if not self._fast_lane_live_ok(h.built):
            metrics.inc("pipeline.exchange.fallback.late")
            return False
        landed, reason, nbytes = self._land_exchange(
            h.exch, lambda name, t: self._read(h, name, t))
        if landed is None:
            if reason == "overflow":
                metrics.inc("pipeline.exchange.overflow")
            else:
                metrics.inc("pipeline.exchange.fallback.unclean")
            metrics.inc("pipeline.exchange.probe_bytes", nbytes)
            return False
        h.np_res = {"exchange": landed}
        h.exch_bytes = nbytes
        return True

    def _land_dense(self, h: _Handle) -> dict:
        """Late gather (churn landed between dispatch and consume): land
        the dense planes of the still-held result, billed as a dense
        window."""
        np_res = self._dense_np_res(h.res)
        metrics = self.node.metrics
        metrics.inc("pipeline.exchange.fallback.late")
        metrics.inc("pipeline.readback.bytes.dense",
                    sum(a.nbytes for a in np_res.values()))
        metrics.inc("pipeline.readback.windows.dense")
        return np_res

    def _rec_span(self, trace_id: int, name: str, t0: float, *,
                  track: str) -> None:
        if self.rec is not None and trace_id:
            self.rec.record(trace_id, name, t0, time.perf_counter(),
                            track=track)

    def finish_sub(self, h: _Handle, k: int, defer: bool = True):
        """Stage 4 (event loop): consume the window into deliveries. With
        the delivery lanes (``defer``, inside a running loop) the clean
        messages' rows go to a plan and the rest ride its ordered barrier
        closures; ``defer=False`` consumes inline."""
        t0 = time.perf_counter()
        msgs = h.subs[k]
        np_res = h.np_res
        builts = h.built
        plan = None
        pool = None
        if defer:
            pool = getattr(self.node, "deliver_lanes", None)
            if pool is not None and pool.active():
                plan = pool.new_plan(msgs)
                if plan is not None:
                    plan.routed_device = True
                    plan.trace = h.sub_traces[k] \
                        if h.sub_traces and k < len(h.sub_traces) \
                        else h.trace
        metrics = self.node.metrics
        fast = None
        if "exchange" in np_res:
            fast = self._consume_exchange(msgs, np_res["exchange"],
                                          builts, plan)
            if fast is None:
                metrics.inc("pipeline.exchange.probe_bytes", h.exch_bytes)
                np_res = h.np_res = self._land_dense(h)
            else:
                metrics.inc("pipeline.exchange.windows")
                metrics.inc("pipeline.exchange.host_landed_bytes",
                            h.exch_bytes)
        if fast is None:
            fast = self._consume_fast(msgs, np_res, builts, plan,
                                      h.host_idx)
        counts: list = []
        for i, msg in enumerate(msgs):
            if fast is not None and fast[i] is not None:
                counts.append(0 if fast[i] is DEFERRED else int(fast[i]))
                continue
            if i in h.host_idx or bool(np_res["overflow"][i].any()):
                if plan is not None:
                    counts.append(0)
                    plan.add_slow(i, lambda m=msg: self._host_route(m))
                else:
                    counts.append(self._host_route(msg))
                continue
            if plan is not None:
                rows = self._collect_clean(msg, i, np_res, builts) \
                    if fast is None else None
                counts.append(0)
                if rows is not None:
                    plan.register_fast([i])
                    plan.add_rows_py(i, rows)
                else:
                    plan.add_slow(
                        i, lambda m=msg, j=i: self._consume_one(
                            m, j, np_res, builts))
                continue
            counts.append(self._consume_one(msg, i, np_res, builts))
        if "occur" in np_res:
            # exchange windows carry no shared-slot occurrences
            self._writeback_cursors(np_res["occur"], builts)
        metrics.inc("routing.device.batches")
        dt = time.perf_counter() - t0
        h.cost_s += dt
        if self.tele is not None:
            self.tele.observe_stage("deliver", dt)
        self._rec_span(h.trace, "deliver", t0, track="consume")
        if plan is not None:
            out = LaneCounts(counts)
            out.plan = plan
            plan.target = out
            plan.add_done_callback(lambda: self._release(h))
            pool.submit(plan)
            return out
        self._release(h)
        return counts

    def finish(self, h: _Handle) -> list:
        # sync callers need final counts: inline consume, no lanes
        return self.finish_sub(h, 0, defer=False)

    def _release(self, h: _Handle) -> None:
        """The handle is done: drop its snapshot pin and run its release
        callback (the batcher's cost sample). Idempotent."""
        if h.released:
            return
        h.released = True
        self._outstanding -= 1
        h.built = None
        h.res = h.exch = h.host = h.event = None
        if self.ledger is not None:
            self.ledger.unpin(id(h))
        cb, h.on_release = h.on_release, None
        if cb is not None:
            cb()

    def abandon(self, h: _Handle, error: Optional[BaseException] = None,
                defer: bool = False) -> None:
        """Drop a handle on an error path. With `error` its remaining
        consumers raise it; with `defer` (a stage thread may still be
        inside the window) it only stops serving, and the release waits
        for a later ``abandon(h)``."""
        if h is None:
            return
        if error is not None:
            h.error = error
        h.abandoned = True
        if defer:
            return
        h.np_res = None
        self._release(h)

    def _flat_filters(self, builts):
        """(flat fid -> filter list, per-shard offsets) across the
        snapshot's shards: global fid = offs[r] + local fid. Memoized on
        the copy-on-write builts list."""
        memo = self._flat_memo
        if memo is not None and memo[0] is builts:
            return memo[1], memo[2]
        flat: list = []
        offs = np.zeros(self.n_route, np.int64)
        for r, b in enumerate(builts):
            offs[r] = len(flat)
            flat.extend(b.fid_filter)
        self._flat_memo = (builts, flat, offs)
        return flat, offs

    def _deliver_rows(self, msgs, chunks, builts, plan, clean) -> list:
        """Deliver the clean messages' rows: `chunks` is one (row_msg,
        sid, opt, gfid) tuple per source shard, in (shard, msg, row)
        order. With a plan the chunks go to the lanes; inline each row is
        delivered here. Returns the per-message list (DEFERRED under the
        lanes, counts inline, None for the messages not in `clean`)."""
        B = len(msgs)
        out: list = [None] * B
        idx = np.flatnonzero(clean)
        if not idx.size:
            return out
        flat, _offs = self._flat_filters(builts)
        if plan is not None:
            plan.register_fast(idx)
            for row_msg, sid, opt, gfid in chunks:
                if row_msg.size:
                    plan.add_rows(row_msg, sid, opt, gfid, flat)
            for i in idx.tolist():
                out[i] = DEFERRED
            return out
        broker = self.broker
        deliver = broker._deliver
        metrics = self.node.metrics
        counts = np.zeros(B, np.int64)
        delivered = 0
        for row_msg, sid, opt, gfid in chunks:
            for bi, s, ob, fd in zip(row_msg.tolist(), sid.tolist(),
                                     opt.tolist(), gfid.tolist()):
                if deliver(s, flat[fd], msgs[bi],
                           dict(OPT_TABLE[ob & 0x3F])):
                    counts[bi] += 1
                    delivered += 1
        if delivered:
            metrics.inc("messages.routed.device", delivered)
        hooks = broker.hooks
        for i in idx.tolist():
            n = int(counts[i])
            if n == 0 and not msgs[i].is_sys:
                metrics.inc("messages.dropped")
                metrics.inc("messages.dropped.no_subscribers")
                hooks.run("message.dropped", (msgs[i], "no_subscribers"))
            out[i] = n
        return out

    def _consume_fast(self, msgs, np_res, builts, plan, host_idx):
        """The vectorized consume: one numpy pass proves which messages
        are clean — no overflow, no too-long topic, no shared-slot hit, no
        rich or slotted matched filter — and gathers their fan-out rows
        per shard. Returns the per-message list of ``_deliver_rows``, or
        None when a live-state disqualifier stands (then every message
        takes the per-message path)."""
        if not self._fast_lane_live_ok(builts):
            return None
        B = len(msgs)
        if B == 0:
            return []
        R = self.n_route
        slow = np.asarray(np_res["overflow"])[:B].reshape(B, -1).any(axis=1)
        if host_idx:
            slow[sorted(host_idx)] = True
        shard_rows = []
        csr = np_res.get("csr")
        if csr is not None:
            off, c3, pay = csr
            lanes = np.arange(B)[:, None] * R + np.arange(R)[None, :]
            slow |= (c3[:, 2][lanes] > 0).any(axis=1)
            for r in range(R):
                idx = np.arange(B) * R + r
                cm = c3[idx, 0].astype(np.int64)
                base = off[idx].astype(np.int64)
                total_m = int(cm.sum())
                mi = np.repeat(np.arange(B), cm)
                if total_m:
                    mcum = np.cumsum(cm) - cm
                    fids = pay[np.arange(total_m) - np.repeat(mcum, cm)
                               + np.repeat(base, cm)].astype(np.int64)
                else:
                    fids = np.zeros(0, np.int64)
                cf = c3[idx, 1].astype(np.int64)
                fbase, obase = base + cm, base + cm + cf

                def fetch(row_msg, col, fbase=fbase, obase=obase):
                    return (pay[fbase[row_msg] + col],
                            pay[obase[row_msg] + col])

                shard_rows.append((mi, fids, fetch))
        else:
            slow |= (np.asarray(np_res["shared_sids"])[:B] >= 0) \
                .any(axis=(1, 2))
            matches = np_res["matches"]
            for r in range(R):
                m = matches[:B, r]
                valid = m >= 0
                mi, _cols = np.nonzero(valid)
                fids = m[valid].astype(np.int64)

                def fetch(row_msg, col, r=r, rows_p=np_res["rows"],
                          opts_p=np_res["opts"]):
                    return (rows_p[row_msg, r, col],
                            opts_p[row_msg, r, col])

                shard_rows.append((mi, fids, fetch))
        for r in range(R):
            mi, fids, _f = shard_rows[r]
            if fids.size:
                np.logical_or.at(slow, mi, builts[r].fid_slow[fids])
        fast_ok = ~slow
        _flat, offs = self._flat_filters(builts)
        chunks = []
        for r in range(R):
            mi, fids, fetch = shard_rows[r]
            keep = fast_ok[mi]
            mi_f, fids_f = mi[keep], fids[keep]
            if not mi_f.size:
                continue
            seg = builts[r].seg_np[fids_f]
            total = int(seg.sum())
            if not total:
                continue
            row_msg, col, row_fid = DeviceRouteEngine._attribute_rows(
                mi_f, fids_f, seg, total)
            sid, opt = fetch(row_msg, col)
            v = sid >= 0
            chunks.append((row_msg[v], sid[v].astype(np.int64),
                           opt[v].astype(np.int64), row_fid[v] + offs[r]))
        return self._deliver_rows(msgs, chunks, builts, plan, fast_ok)

    def _consume_exchange(self, msgs, exch, builts, plan):
        """Consume the exchanged per-dest plans: every message of the
        window is device-proven clean. Chunks go per source shard
        ascending, so a session's sequence equals the gather walk's.
        None when a live-state disqualifier landed after materialize."""
        if not self._fast_lane_live_ok(builts):
            return None
        if not msgs:
            return []
        plan_p, _cnt, scnt = exch
        rec, src = self._exchange_records(plan_p, scnt)
        chunks = []
        for r in range(self.n_route):
            a = rec[src == r]
            if a.size:
                w2 = a[:, 2].astype(np.int64)
                chunks.append((a[:, 0].astype(np.int64),
                               a[:, 1].astype(np.int64),
                               (w2 >> 24) & 0x3F,
                               w2 & (EXCHANGE_MAX_GFID - 1)))
        return self._deliver_rows(msgs, chunks, builts, plan,
                                  np.ones(len(msgs), bool))

    def _rows_of(self, np_res, i: int, r: int):
        """Message i's entries in shard r: (matches, rows, opts, shared
        slots, shared rows, shared opts), from the CSR or the dense
        planes."""
        csr = np_res.get("csr")
        if csr is not None:
            return csr_slices(csr[0], csr[1], csr[2], i * self.n_route + r)
        return tuple(np_res[k][i, r] for k in (
            "matches", "rows", "opts", "shared_sids", "shared_rows",
            "shared_opts"))

    def _collect_clean(self, msg, i: int, np_res, builts):
        """Clean-proof and row collection for the lanes: [(sid,
        packed_opt, filter)] when every delivery of this message is a
        plain fan-out row, else None (the ordered per-message consume
        serves it)."""
        broker = self.broker
        if broker.cluster is not None:
            return None
        decoded = []
        for r in range(self.n_route):
            b = builts[r]
            if b.host_extra:
                return None
            row_m, rows, opts, srow, _pr, _or = self._rows_of(np_res, i, r)
            if (np.asarray(srow) >= 0).any():
                return None
            for fid in row_m:
                if fid < 0:
                    continue
                f = b.fid_filter[fid]
                if f in b.rich or broker.shared.get(f):
                    return None
            decoded.append((b, row_m, rows, opts))
        out: list = []
        for b, row_m, rows, opts in decoded:
            off = 0
            for fid in row_m:
                if fid < 0:
                    continue
                f = b.fid_filter[fid]
                seg = b.seg_len[fid]
                for j in range(off, off + seg):
                    sid = int(rows[j])
                    if sid >= 0:
                        out.append((sid, int(opts[j]), f))
                off += seg
        return out

    def _writeback_cursors(self, occur, builts) -> None:
        """Mirror the device's round-robin advances onto the host groups'
        cursors: the next shard capture re-seeds its device row from them,
        so churn does not reset a group's rotation."""
        if self.broker.shared_strategy != "round_robin":
            return
        for r in range(self.n_route):
            b = builts[r]
            occ = occur[r]
            for slot in np.flatnonzero(occ[:len(b.slot_key)]):
                f, gname = b.slot_key[slot]
                g = self.broker.shared.get(f, {}).get(gname)
                if g is not None and g.members:
                    g.cursor = (g.cursor + int(occ[slot])) \
                        % len(g.members)

    # ---- consume --------------------------------------------------------
    def _host_route(self, msg) -> int:
        broker = self.broker
        return broker._route(msg, broker.router.match(msg.topic))

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

    def _consume_one(self, msg, i: int, np_res, builts) -> int:
        """The per-message consume (reference :1876): fan-out rows per
        matched filter (rich filters through the host dict), too-deep
        filters matched on the host, the device's shared picks with the
        staleness guard, remote picks forwarded to their node, the sweep
        of live groups the pinned snapshot has no slot for, and the
        cluster forward."""
        broker = self.broker
        metrics = self.node.metrics
        cluster = broker.cluster
        dev_shared = broker.shared_strategy in STRATEGIES
        n = 0
        matched: list = []
        handled: set = set()
        for r in range(self.n_route):
            b = builts[r]
            row_m, rows, opts, srow, prow, orow = self._rows_of(np_res, i, r)
            off = 0
            for fid in row_m:
                if fid < 0:
                    continue
                f = b.fid_filter[fid]
                matched.append(f)
                seg = b.seg_len[fid]
                if f in b.rich:
                    n += broker.dispatch(f, msg)
                else:
                    for j in range(off, off + seg):
                        sid = int(rows[j])
                        if sid >= 0 and broker._deliver(
                                sid, f, msg,
                                dict(OPT_TABLE[int(opts[j]) & 0x3F])):
                            n += 1
                            metrics.inc("messages.routed.device")
                off += seg
            for f, _ws in b.host_extra:
                if T.match(msg.topic, f):
                    matched.append(f)
                    n += broker.dispatch(f, msg)
            if not dev_shared:
                continue
            for k, slot in enumerate(srow):
                if slot < 0 or slot >= len(b.slot_key):
                    continue
                f, gname = b.slot_key[slot]
                handled.add((f, gname))
                sid = int(prow[k])
                if sid < 0:
                    continue
                if sid >= _REMOTE_SID_BASE:
                    # device picked a remote member: directed forward,
                    # the pick already made on the mesh
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
                        n += 1   # cluster torn down since the build
                    continue
                # the pick was made against the handle's pinned shard: a
                # member that left, or a shard re-dirtied since, re-picks
                # on the host against live membership
                grp = broker.shared.get(f, {}).get(gname)
                if grp is None or sid not in grp.members \
                        or self.shard_of(f) in self.dirty_shards:
                    if self._host_shared_dispatch(f, gname, msg):
                        n += 1
                elif broker._deliver(
                        sid, f, msg,
                        dict(OPT_TABLE[int(orow[k]) & 0x3F], share=gname)):
                    n += 1
                    metrics.inc("messages.routed.device")
                elif broker.shared_dispatch_ack \
                        and self._host_shared_dispatch(f, gname, msg):
                    n += 1
        if not dev_shared:
            n += broker._dispatch_shared(msg, matched)
        else:
            # groups live on a matched filter but absent from the pinned
            # snapshot (subscribed after prepare, or on a too-deep
            # filter) dispatch on the host
            for f in matched:
                names = set(broker.shared.get(f, ()))
                if cluster is not None:
                    names |= cluster._groups_by_real.get(f, set())
                for gname in names:
                    if (f, gname) in handled:
                        continue
                    handled.add((f, gname))
                    if self._host_shared_dispatch(f, gname, msg):
                        n += 1
        if cluster:
            n += cluster.forward(msg, matched)
        if n == 0 and not msg.is_sys:
            metrics.inc("messages.dropped")
            metrics.inc("messages.dropped.no_subscribers")
            broker.hooks.run("message.dropped", (msg, "no_subscribers"))
        return n

    # ---- synchronous composition ----------------------------------------
    def route_batch(self, msgs: list, wait: bool = False) -> Optional[list]:
        """Route one batch synchronously. None when the mesh cannot serve
        right now (first build or a background build in flight) — callers
        route on the host. ``wait=True`` blocks until the mesh can serve
        (tests, warm-ups: never the event loop)."""
        if wait:
            t = self._rebuild_thread
            if t is not None and t.is_alive():
                t.join()
            if self._builts is None:
                self.rebuild()
            if not self.poll_rebuild():     # churn started a full build
                ct = self._capture_task
                if ct is not None and not ct.done():
                    self.rebuild()
                else:
                    t = self._rebuild_thread
                    if t is not None:
                        t.join()
                self.poll_rebuild()
        h = self.prepare(msgs)
        if h is None:
            return None
        h.t0 = time.perf_counter()
        try:
            self.dispatch(h)
            self.materialize(h)
        except Exception:
            self.abandon(h)
            raise
        return self.finish(h)

    def close(self) -> None:
        """Wait for the background warm-up and build threads to leave
        (a process must not exit while one is inside the device's
        code)."""
        for t in (self._warm_thread, self._rebuild_thread):
            if t is not None:
                t.join()

    def stats(self) -> dict:
        builts = self._builts or ()
        m = self.node.metrics
        fb = {k.rsplit(".", 1)[1]: v for k, v in m.all().items()
              if k.startswith("pipeline.exchange.fallback.") and v}
        for k in ("overflow", "cold_class"):
            if m.val(f"pipeline.exchange.{k}"):
                fb[k] = m.val(f"pipeline.exchange.{k}")
        nr = sum(b.cover_roots for b in builts)
        nc = sum(b.cover_covered for b in builts)
        return {
            "built": self._builts is not None,
            "mesh": {"dp": self.n_dp, "route": self.n_route,
                     "device": str(self.device)},
            "filters": sum(len(b.fid_filter) for b in builts),
            "shared_slots": sum(len(b.slot_key) for b in builts),
            "dirty_shards": sorted(self.dirty_shards),
            "caps": dict(self._caps or {}),
            "warm_classes": sorted(self._warm_classes),
            "match_cache": "bypassed",
            "compact_readback": self.compact_readback,
            "dispatch_depth": self.dispatch_depth,
            "delta_overlay": "per-shard-rebuild" if self.delta_overlay
            else False,
            "payload_ewma": round(self._pay_ewma, 1)
            if self._pay_ewma is not None else None,
            "device_exchange": bool(self.device_exchange
                                    and self._exch_fits),
            "exchange_warm": sorted(self._exch_warm),
            "exchange_ewma": round(self._exch_ewma, 1)
            if self._exch_ewma is not None else None,
            "exchange_windows": m.val("pipeline.exchange.windows"),
            "gathers": fb,
            "rebuild_host_messages": m.val("routing.mesh.rebuild_host"),
            "subscription_covering": self.subscription_covering,
            "cover": {"roots": nr, "covered": nc,
                      "reduction": round((nr + nc) / max(1, nr), 2)}
            if self.subscription_covering else None,
        }
