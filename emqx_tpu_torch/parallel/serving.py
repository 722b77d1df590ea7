"""ShardedRouteEngine: route PUBLISH windows through the dp×route mesh.

A slim counterpart of ``emqx_tpu/parallel/serving.py``
``ShardedRouteServer`` (:143) — without Node, batcher, supervisor,
ledger or the delta overlay (the full engine protocol is later work). It
keeps what the device path needs:

- filters partitioned by ``crc32(filter) % route`` (``shard_of``, :311);
- the per-shard capture and trie build with capacity classes shared by
  every shard (``_shard_dims`` / ``_caps_of`` / ``_build_shard``,
  :352-501, trie branch), from a dict of subscriptions or columnar
  arrays (a million filters never pass through a per-filter Python loop);
- subscription covering (reference :448-490, on by default): with it on
  every shard's trie holds that shard's covering set and carries its
  expansion CSR (an identity CSR where nothing is covered, so the
  stacked tables stay uniform), and the step expands each shard's rows
  before the exchange ships them;
- the exchange companions (``_aux_host_rows`` / ``_fid_offsets`` /
  ``_build_aux``, :552-595) and the segment-capacity ladder with its
  peak-biased EWMA (``_choose_ecap`` / ``_note_exch``, :1140-1170);
- ``route_encoded``: the sharded step, then the exchange, then the
  device-to-host copy of each destination's occupied plan prefix only.
  A window the exchange cannot serve — a shared-slot hit or other
  unclean message (ok & 1 == 0), a segment outgrowing its class
  (ok & 2 == 0), a too-long topic, a global fid space past 2^24 — is
  landed by a host gather of the dense [B, R, ...] planes instead, and
  every such window is counted in ``stats`` under its reason.

Delivery records are (msg, sid, gfid | packed_opt << 24) triples; a
session's records come in (source shard asc, msg asc, row asc) order on
either path — the order the reference's consume delivers in.
"""

from __future__ import annotations

import time
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from emqx_tpu_torch.engine import Plan, pack_opts
from emqx_tpu_torch.models.router_engine import ExchangeAux, RouterTables
from emqx_tpu_torch.ops import cover as CV
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
                                             put_sharded, stack_tables)
from emqx_tpu_torch.utils import topic as T

# gfid | packed_opt << 24 is the exchange wire word: global filter ids
# above this no longer fit next to the 6 subopt bits
EXCHANGE_MAX_GFID = 1 << 24


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


class ShardedRouteEngine:
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
        self.mesh = mesh
        self.n_dp, self.n_route = mesh.dp, mesh.route
        self.device = mesh.grid[0][0]
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown shared strategy {strategy!r}")
        self.strategy = STRATEGIES[strategy]
        self.intern = intern
        self.frontier_cap, self.match_cap = frontier_cap, match_cap
        self.fanout_cap, self.slot_cap = fanout_cap, slot_cap
        self.level_cap = level_cap
        self.subscription_covering = True if subscription_covering is None \
            else bool(subscription_covering)
        self.detect_s = 0.0       # cover detection seconds, every shard
        if batch % self.n_dp:
            raise ValueError(f"batch {batch} does not split over "
                             f"dp={self.n_dp}")
        self.batch = batch
        self.step = make_sharded_route_step(
            mesh, backend="trie", frontier_cap=frontier_cap,
            match_cap=match_cap, fanout_cap=fanout_cap, slot_cap=slot_cap)
        self._exch_steps: dict = {}
        self._exch_ewma: Optional[float] = None
        self.stats = {"windows": 0, "exchange_windows": 0,
                      "host_messages": 0, "fallback": {},
                      "subscription_covering": self.subscription_covering,
                      "cover": None}
        self._build(captures)

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
                                           device=self.device)
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
        self.fid_off = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(
            np.int32)
        self.slot_off = np.concatenate(
            [[0], np.cumsum([len(c.slots) for c in captures])[:-1]])
        self.exchange_fits = sum(counts) < EXCHANGE_MAX_GFID
        self.aux = ExchangeAux(
            *(torch.from_numpy(x).to(self.device) for x in (
                np.stack([b[1] for b in built]),
                np.stack([b[2] for b in built]), self.fid_off)))
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
            ok = ex.ok.cpu().numpy()
            cnt = ex.plan_cnt.cpu().numpy()
            if int(ok.min()) == 3:
                scnt = ex.src_cnt.cpu().numpy()
                hi = int(cnt.max())
                self._note_exch(float(hi))
                hq = min(E, max(8, -(-hi // 8) * 8))
                plan = ex.plan[:, :, :hq].cpu().numpy()
                rec, src = self._exchange_records(plan, scnt)
                self.stats["exchange_windows"] += 1
                return MeshReadback(True, reason, rec, src, None,
                                    np.zeros(B, bool))
            if not (ok & 2).all():
                reason = "overflow"
                self._note_exch(float(cnt.max()) * 1.25)
            else:
                reason = "unclean"
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

    def land_dense(self, res) -> dict:
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
