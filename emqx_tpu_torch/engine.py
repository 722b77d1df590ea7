"""RouteEngine: the port's entry point for routing PUBLISH windows.

A slim counterpart of the shapes-backend core of ``DeviceRouteEngine``
(``emqx_tpu/broker/device_engine.py``): it builds the shape-hash and
subscriber tables once, uploads them, and routes batches of topics
through the compacted route window (``models/router_engine.route_window``),
reading back one CSR payload per window and decoding it with
``csr_slices``.

Fallbacks are the reference's own semantics, not device fallbacks:
- a window whose entries outgrow the payload capacity (``row_overflow``)
  is decoded from the dense planes of the same window, and the capacity
  grows to fit for the next window;
- a topic deeper than ``max_levels`` (``too_long``) or one whose fan-out
  or shared slots overflow their caps is completed on the host from the
  engine's filter list with ``utils.topic.match``; an overflowing topic
  keeps the picks the window made for it, which its cursors count.
"""

from __future__ import annotations

import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from emqx_tpu_torch.convert import tables_from_numpy
from emqx_tpu_torch.device import resolve_device, span
from emqx_tpu_torch.models.router_engine import route_window
from emqx_tpu_torch.ops.compact import csr_slices
from emqx_tpu_torch.ops.fanout import build_subtable
from emqx_tpu_torch.ops.intern import PAD, InternTable
from emqx_tpu_torch.ops.match import encode_topics_str
from emqx_tpu_torch.ops.shapes import _next_pow2, build_shape_tables
from emqx_tpu_torch.ops.shared import (STRATEGIES, STRATEGY_HASH_CLIENT,
                                       STRATEGY_HASH_TOPIC, STRATEGY_RANDOM,
                                       STRATEGY_ROUND_ROBIN, STRATEGY_STICKY,
                                       hash_base)
from emqx_tpu_torch.utils import topic as T


def pack_opts(opts: dict) -> int:
    """Subscription options → the packed byte the tables carry."""
    return ((int(opts.get("qos", 0)) & 0x3)
            | ((1 if opts.get("nl") else 0) << 2)
            | ((1 if opts.get("rap") else 0) << 3)
            | ((int(opts.get("rh", 0)) & 0x3) << 4))


class Plan(NamedTuple):
    """One message's delivery plan. Matched fids are in match order; rows
    and opts concatenate each matched filter's subscribers in that order;
    one (slot, row, opts) pick per matched shared slot (row -1 for a slot
    with no members). ``host`` marks a plan completed on the host."""
    fids: np.ndarray
    rows: np.ndarray
    opts: np.ndarray
    shared_slots: np.ndarray
    shared_rows: np.ndarray
    shared_opts: np.ndarray
    host: bool = False


class WindowReadback(NamedTuple):
    """What one routed window brings back to the host (numpy)."""
    offsets: np.ndarray        # [W, B+1]
    counts3: np.ndarray        # [W, B, 3]
    payload: np.ndarray        # [W, <=P] (the used prefix of every row)
    row_overflow: np.ndarray   # [W]
    overflow: np.ndarray       # [W, B]
    dense: Optional[tuple]     # dense planes when any row overflowed


class RouteEngine:
    """Routes topic batches on one device through the compacted window.

    Build with ``from_subscriptions`` (a dict API) or ``from_columnar``
    (filter words plus a built SubTable, as the bench builds them).
    ``route(topics)`` returns one ``Plan`` per topic; ``route_encoded``
    routes one pre-encoded window and returns its readback.
    """

    def __init__(self, shapes, subs, intern: InternTable, *,
                 filters: Optional[list] = None,
                 filter_words: Optional[np.ndarray] = None,
                 filter_lens: Optional[np.ndarray] = None,
                 slot_keys: Optional[list] = None, device=None,
                 batch: int = 1024, window: int = 8, fanout_cap: int = 16,
                 slot_cap: int = 4, strategy: str = "round_robin",
                 max_levels: int = 16, payload_cap: Optional[int] = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.tables = tables_from_numpy(shapes, subs, self.device)
        self.subs_host = subs
        self.intern = intern
        self._filters = filters
        self._words, self._lens = filter_words, filter_lens
        self.slot_keys = slot_keys or []
        self.n_slots = len(subs.shared_start) - 1
        self.cursors = torch.zeros(self.n_slots, dtype=torch.int32,
                                   device=self.device)
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown shared strategy {strategy!r}")
        self.strategy = STRATEGIES[strategy]
        self.batch, self.window = batch, window
        self.fanout_cap, self.slot_cap = fanout_cap, slot_cap
        self.max_levels = max_levels
        self.payload_cap = payload_cap or _next_pow2(2 * batch)
        self.generator = torch.Generator().manual_seed(seed)
        # csr_entries: payload entries the windows used (offsets[:, -1]);
        # d2h_bytes: bytes every readback copied into host memory
        self.stats = {"windows": 0, "dense_windows": 0, "host_messages": 0,
                      "csr_entries": 0, "d2h_bytes": 0}

    # --- build -----------------------------------------------------------

    @classmethod
    def from_subscriptions(cls, subscriptions: dict, *, max_levels: int = 16,
                           **kw) -> "RouteEngine":
        """subscriptions: filter → [(session_row, opts)], where a filter may
        carry a ``$share/<group>/`` or ``$queue/`` prefix and opts is a
        packed int or a dict of qos/nl/rap/rh."""
        normal_f: dict = {}
        shared_g: dict = {}
        for raw, members in subscriptions.items():
            filt, o = T.parse(raw)
            T.validate(filt, "filter")
            packed = [(int(r), p if isinstance(p, int) else pack_opts(p))
                      for r, p in members]
            if "share" in o:
                shared_g.setdefault((o["share"], filt), []).extend(packed)
            else:
                normal_f.setdefault(filt, []).extend(packed)
        filters = sorted(set(normal_f) | {f for _, f in shared_g})
        fid = {f: i for i, f in enumerate(filters)}
        intern = InternTable()
        words = np.full((len(filters), max_levels), PAD, np.int32)
        lens = np.zeros(len(filters), np.int64)
        for i, f in enumerate(filters):
            ws = T.tokens(f)
            if len(ws) > max_levels:
                raise ValueError(f"filter {f!r} is deeper than "
                                 f"max_levels={max_levels}")
            words[i, :len(ws)] = intern.encode_filter(ws)
            lens[i] = len(ws)
        slot_keys = sorted(shared_g)
        filter_slots: dict = {}
        for s, (_g, f) in enumerate(slot_keys):
            filter_slots.setdefault(fid[f], []).append(s)
        subs = build_subtable(
            len(filters), {fid[f]: m for f, m in normal_f.items()},
            filter_slots, {s: shared_g[k] for s, k in enumerate(slot_keys)})
        return cls(build_shape_tables(words, lens), subs, intern,
                   filters=filters, slot_keys=slot_keys,
                   max_levels=max_levels, **kw)

    @classmethod
    def from_columnar(cls, words: np.ndarray, lens: np.ndarray, subs,
                      intern: InternTable, **kw) -> "RouteEngine":
        """words [F, L] interned filter levels, lens [F]; subs a SubTable of
        numpy arrays indexed by the same filter ids."""
        return cls(build_shape_tables(words, lens), subs, intern,
                   filter_words=words, filter_lens=lens, **kw)

    @property
    def filters(self) -> list:
        """Filter strings by fid (derived from the words when built
        columnar)."""
        if self._filters is None:
            w = self.intern.word
            self._filters = ["/".join(w(int(x)) for x in row[:n])
                             for row, n in zip(self._words, self._lens)]
        return self._filters

    # --- route -----------------------------------------------------------

    def _msg_hashes(self, topics: list, msg_hash) -> np.ndarray:
        if msg_hash is not None:
            return np.asarray(msg_hash, np.int32)
        if self.strategy == STRATEGY_HASH_TOPIC:
            return np.array([zlib.crc32(t.encode()) & 0x7FFFFFFF
                             for t in topics], np.int32)
        if self.strategy == STRATEGY_HASH_CLIENT:
            raise ValueError("hash_clientid needs msg_hash: one publisher "
                             "hash per topic")
        if self.strategy == STRATEGY_RANDOM:
            return torch.randint(0, 1 << 31, (len(topics),),
                                 generator=self.generator,
                                 dtype=torch.int32).numpy()
        return np.zeros(len(topics), np.int32)

    def route(self, topics: list, msg_hash=None) -> list:
        """Route topic strings; one Plan per topic, in order. msg_hash
        (one int32 per topic) feeds the hash strategies."""
        enc, lens, dollar, too_long = encode_topics_str(
            self.intern, topics, self.max_levels)
        mh = self._msg_hashes(topics, msg_hash)
        B = self.batch
        plans: list = []
        for s in range(0, len(topics), B * self.window):
            n = min(len(topics) - s, B * self.window)
            W = -(-n // B)

            def win(a):
                out = np.zeros((W * B,) + a.shape[1:], a.dtype)
                out[:n] = a[s:s + n]
                return out.reshape((W, B) + a.shape[1:])

            rb = self.route_encoded(win(enc), win(lens), win(dollar),
                                    win(mh))
            plans.extend(self._decode(rb, topics[s:s + n],
                                      too_long[s:s + n], mh[s:s + n]))
        return plans

    def route_encoded(self, topics, lens, is_dollar,
                      msg_hash) -> WindowReadback:
        """Route one encoded window ([W, B, L] topics, [W, B] lens, dollar
        flags and hashes; numpy or tensors) and read it back. Advances
        the engine's cursors. The call runs inside a ``route.window``
        range whose stages (``route.upload``, the window's own,
        ``route.readback`` with ``route.wait`` first inside it) partition
        it (``device.span``)."""
        dev = self.device
        with span("route.window"):
            with span("route.upload"):
                ins = [torch.as_tensor(x).to(device=dev, dtype=dt)
                       for x, dt in ((topics, torch.int32),
                                     (lens, torch.int32),
                                     (is_dollar, torch.bool),
                                     (msg_hash, torch.int32))]
            out = route_window(
                self.tables, self.cursors, *ins, self.strategy,
                fanout_cap=self.fanout_cap, slot_cap=self.slot_cap,
                payload_cap=self.payload_cap)
            with span("route.readback"):
                return self._readback(out)

    def _readback(self, out) -> WindowReadback:
        """Hand the window's cursors on, wait for its device work, and
        copy its CSR planes (the dense ones on a payload overflow) into
        host memory."""
        res, cp = out.res, out.compact
        self.cursors = res.new_cursors[-1].clone()
        with span("route.wait"):
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        host = self._host
        offsets = host(cp.offsets)
        used = int(offsets[:, -1].max(initial=0))
        row_overflow = host(cp.row_overflow)
        dense = None
        if row_overflow.any():
            self.stats["dense_windows"] += 1
            dense = tuple(host(x) for x in (
                res.matches, res.rows, res.opts, res.fan_counts,
                res.shared_sids, res.shared_rows, res.shared_opts))
            # learn the capacity upward so the next window fits
            self.payload_cap = _next_pow2(used)
        rb = WindowReadback(
            offsets=offsets, counts3=host(cp.counts3),
            payload=host(cp.payload[:, :used]),
            row_overflow=row_overflow, overflow=host(res.overflow),
            dense=dense)
        self.stats["windows"] += 1
        self.stats["csr_entries"] += int(offsets[:, -1].sum())
        self.stats["d2h_bytes"] += sum(
            x.nbytes for x in (*rb[:5], *(dense or ())))
        return rb

    def _host(self, x: torch.Tensor) -> np.ndarray:
        """``x`` in host memory. On the card the copy lands in page-locked
        memory from the caching host allocator: the copy engine writes it
        at the host link's rate, with no staging copy and no page faults
        on fresh pages, and the block goes back to the cache when the
        array is dropped."""
        if self.device.type != "cuda":
            return x.cpu().numpy()
        return torch.empty(x.shape, dtype=x.dtype,
                           pin_memory=True).copy_(x).numpy()

    def _decode(self, rb: WindowReadback, topics: list,
                too_long: np.ndarray, mh: np.ndarray) -> list:
        B = rb.overflow.shape[1]
        plans = []
        for g, topic in enumerate(topics):
            k, i = divmod(g, B)
            if too_long[g]:
                plans.append(self._host_plan(topic, int(mh[g])))
                continue
            plan = self._device_plan(rb, k, i)
            if rb.overflow[k, i]:
                # the window ranked this message's first slot_cap slots
                # and counted them in the cursors: the host keeps those
                # picks and completes the rest
                picked = {int(s): (int(r), int(o)) for s, r, o in zip(
                    plan.shared_slots, plan.shared_rows, plan.shared_opts)}
                plan = self._host_plan(topic, int(mh[g]), picked)
            plans.append(plan)
        return plans

    @staticmethod
    def _device_plan(rb: WindowReadback, k: int, i: int) -> Plan:
        """Message i of step k as the window planned it: from the dense
        planes of a step whose payload overflowed, else its CSR row."""
        if rb.row_overflow[k]:
            m, r, o, fc, ss, sr, so = (x[k, i] for x in rb.dense)
            cf = min(int(fc), r.shape[0])
            cs = int((ss >= 0).sum())
            return Plan(m[m >= 0], r[:cf], o[:cf].astype(np.int32),
                        ss[:cs], sr[:cs], so[:cs].astype(np.int32))
        return Plan(*csr_slices(rb.offsets[k], rb.counts3[k], rb.payload[k],
                                i))

    # --- host fallback ---------------------------------------------------

    def _pick_host(self, slot: int, lo: int, size: int, mh: int) -> int:
        """One member index for a host-completed shared slot, by the same
        arithmetic as ops.shared.pick_members (round robin advances the
        slot's device cursor by one)."""
        if self.strategy in (STRATEGY_ROUND_ROBIN, STRATEGY_STICKY):
            cur = int(self.cursors[slot])
            if self.strategy == STRATEGY_ROUND_ROBIN:
                self.cursors[slot] += 1
            return lo + cur % size
        base = int(hash_base(torch.tensor([mh], dtype=torch.int32),
                             torch.tensor([[slot]])))
        return lo + base % size

    def _host_plan(self, topic: str, mh: int,
                   picked: Optional[dict] = None) -> Plan:
        """Complete one message on the host: brute-force match over the
        filter list, then every subscriber and one pick per shared slot;
        ``picked`` maps the slots the window already picked for it to
        their (row, opts)."""
        self.stats["host_messages"] += 1
        st = self.subs_host
        fids, rows, opts, slots, srows, sopts = [], [], [], [], [], []
        for fid, f in enumerate(self.filters):
            if not T.match(topic, f):
                continue
            fids.append(fid)
            a, b = int(st.sub_start[fid]), int(st.sub_start[fid + 1])
            rows.extend(int(x) for x in st.sub_row[a:b])
            opts.extend(int(x) for x in st.sub_opts[a:b])
            for s in st.fs_slot[int(st.fs_start[fid]):
                                int(st.fs_start[fid + 1])]:
                s = int(s)
                lo = int(st.shared_start[s])
                size = int(st.shared_start[s + 1]) - lo
                slots.append(s)
                if picked and s in picked:
                    srows.append(picked[s][0])
                    sopts.append(picked[s][1])
                    continue
                if size == 0:
                    srows.append(-1)
                    sopts.append(0)
                    continue
                j = self._pick_host(s, lo, size, mh)
                srows.append(int(st.shared_row[j]))
                sopts.append(int(st.shared_opts[j]))
        arr = [np.array(x, np.int32) for x in
               (fids, rows, opts, slots, srows, sopts)]
        return Plan(*arr, host=True)
