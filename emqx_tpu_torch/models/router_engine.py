"""The PUBLISH route window: match → fan-out → shared picks → compaction.

Counterpart of ``emqx_tpu/models/router_engine.py``: the table and result
types (``RouterTables`` :37, ``ExchangeAux`` :63, ``ExchangeResult`` :74),
``post_match`` (:87), the trie ``route_step`` (:106), ``route_step_shapes``
(:119), ``route_step_compact`` (:235), ``route_window_full`` (:683)
together with ``route_window_full_compact`` (:281), and ``route_digest``
(:631).

``route_window`` routes W sub-batches in one call. The match, the normal
fan-out and the shared-slot expansion do not depend on the cursors, so
they run once over the flattened W×B lanes; the member picks then thread
the cursors through the W sub-batches in order, exactly as the
reference's ``lax.scan`` does, so row k of ``new_cursors``/``occur`` is
the state after sub-batch k.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from emqx_tpu_torch.ops.compact import CompactPlanes, compact_result
from emqx_tpu_torch.ops.fanout import SubTable, fanout_normal, shared_slots
from emqx_tpu_torch.ops.match import MatchResult, match_batch
from emqx_tpu_torch.ops.scan import prefix_sum
from emqx_tpu_torch.ops.shapes import ShapeTables, shape_match
from emqx_tpu_torch.ops.shared import pick_members
from emqx_tpu_torch.ops.trie import TrieTables


class RouterTables(NamedTuple):
    """Device routing state for the trie-NFA backend (general shapes)."""
    trie: TrieTables
    subs: SubTable


class ShapeRouterTables(NamedTuple):
    """Device routing state for the shape-hash backend."""
    shapes: ShapeTables
    subs: SubTable


class RouteResult(NamedTuple):
    matches: torch.Tensor       # [B, M] matched filter ids
    match_counts: torch.Tensor  # [B]
    rows: torch.Tensor          # [B, D] normal delivery session rows
    opts: torch.Tensor          # [B, D] packed subopts
    fan_counts: torch.Tensor    # [B]
    shared_sids: torch.Tensor   # [B, K] matched shared-slot ids (-1 pad)
    shared_rows: torch.Tensor   # [B, K] shared picks (session rows)
    shared_opts: torch.Tensor   # [B, K]
    overflow: torch.Tensor      # [B] any capacity overflow → host fallback
    new_cursors: torch.Tensor   # [G]
    occur: torch.Tensor         # [G] shared-slot occurrences this batch


class ExchangeAux(NamedTuple):
    """Per-shard companions the exchange stage needs on device, stacked on
    the route axis next to the shard tables."""
    seg_len: torch.Tensor   # [R, F_cap] int32 fan-out segment length per fid
    fid_slow: torch.Tensor  # [R, F_cap] bool: a matched fid here → unclean
    fid_off: torch.Tensor   # [R] int32 global-fid base per shard


class ExchangeResult(NamedTuple):
    """Each (dp, dest) shard's final delivery plan after the exchange:
    only the rows whose sessions it owns (sid % R == dest), received from
    every source shard around the route ring, as (msg, sid, gfid |
    packed_opt << 24) int32 triples in (source asc, msg asc, row asc)
    order."""
    plan: torch.Tensor      # [dp, R_dst, E, 3] int32, -1 pad
    plan_cnt: torch.Tensor  # [dp, R_dst] int32 (clamped to E)
    src_cnt: torch.Tensor   # [dp, R_dst, R_src] int32 segment boundaries
    ok: torch.Tensor        # [dp, R] int32 bitmask: 1=msgs clean, 2=caps fit


class CompactRouteResult(NamedTuple):
    """A window's stacked dense planes plus their CSR readback (None when
    no payload capacity was asked for)."""
    res: RouteResult
    compact: Optional[CompactPlanes]


def post_match(subs: SubTable, mr: MatchResult, cursors: torch.Tensor,
               msg_hash: torch.Tensor, strategy: int, *, fanout_cap: int,
               slot_cap: int, scan=prefix_sum) -> RouteResult:
    """Fan-out + shared-sub selection on a MatchResult."""
    fr = fanout_normal(subs, mr.matches, fanout_cap=fanout_cap, scan=scan)
    sids, slot_oflow = shared_slots(subs, mr.matches, slot_cap=slot_cap,
                                    scan=scan)
    sp = pick_members(subs, cursors, sids, strategy, msg_hash, scan=scan)
    return RouteResult(
        matches=mr.matches, match_counts=mr.counts,
        rows=fr.rows, opts=fr.opts, fan_counts=fr.counts,
        shared_sids=sids, shared_rows=sp.rows, shared_opts=sp.opts,
        overflow=mr.overflow | fr.overflow | slot_oflow,
        new_cursors=sp.new_cursors, occur=sp.occur)


def route_step(tables: RouterTables, cursors, topics, lens, is_dollar,
               msg_hash, strategy: int, *, frontier_cap: int = 16,
               match_cap: int = 64, fanout_cap: int = 128,
               slot_cap: int = 16, scan=prefix_sum) -> RouteResult:
    """Trie-NFA route step: match + fan-out + shared picks."""
    mr = match_batch(tables.trie, topics, lens, is_dollar,
                     frontier_cap=frontier_cap, match_cap=match_cap,
                     scan=scan)
    return post_match(tables.subs, mr, cursors, msg_hash, strategy,
                      fanout_cap=fanout_cap, slot_cap=slot_cap, scan=scan)


def route_step_shapes(tables: ShapeRouterTables, cursors, topics, lens,
                      is_dollar, msg_hash, strategy: int, *,
                      fanout_cap: int = 128, slot_cap: int = 16,
                      match=shape_match, scan=prefix_sum) -> RouteResult:
    """One batch: shape-hash match + post_match."""
    mr = match(tables.shapes, topics, lens, is_dollar)
    return post_match(tables.subs, mr, cursors, msg_hash, strategy,
                      fanout_cap=fanout_cap, slot_cap=slot_cap, scan=scan)


def route_step_compact(tables: RouterTables, cursors, topics, lens,
                       is_dollar, msg_hash, strategy: int, *,
                       frontier_cap: int = 16, match_cap: int = 64,
                       fanout_cap: int = 128, slot_cap: int = 16,
                       payload_cap: int = 4096,
                       scan=prefix_sum) -> CompactRouteResult:
    """Trie-NFA route step with the fused CSR readback, window-shaped
    (every plane gains a leading W = 1 axis). The NFA emits matches
    densely packed, so the compaction skips the hole-closing stage."""
    r = route_step(tables, cursors, topics, lens, is_dollar, msg_hash,
                   strategy, frontier_cap=frontier_cap, match_cap=match_cap,
                   fanout_cap=fanout_cap, slot_cap=slot_cap, scan=scan)
    r = RouteResult(*[x[None] for x in r])
    cp = compact_result(r.matches, r.rows, r.opts, r.fan_counts,
                        r.shared_sids, r.shared_rows, r.shared_opts,
                        payload_cap=payload_cap, match_holes=False,
                        scan=scan)
    return CompactRouteResult(res=r, compact=cp)


def route_window(tables: ShapeRouterTables, cursors: torch.Tensor,
                 topics: torch.Tensor, lens: torch.Tensor,
                 is_dollar: torch.Tensor, msg_hash: torch.Tensor,
                 strategy: int, *, fanout_cap: int = 128,
                 slot_cap: int = 16, payload_cap: Optional[int] = None,
                 match=shape_match, scan=prefix_sum) -> CompactRouteResult:
    """W route steps over a [W, B, ...] window, cursors threaded.

    Every field of the returned RouteResult is stacked [W, ...], as the
    reference's ``route_window_full``; with ``payload_cap`` the CSR
    compaction of ``route_window_full_compact`` rides along. ``match`` and
    ``scan`` default to the kernel wrappers; passing the plain versions
    (``shape_match_ref``, ``prefix_sum_ref``) gives the reference path on
    the same device.
    """
    W, B, L = topics.shape
    subs = tables.subs
    mr = match(tables.shapes, topics.reshape(W * B, L), lens.reshape(W * B),
               is_dollar.reshape(W * B))
    fr = fanout_normal(subs, mr.matches, fanout_cap=fanout_cap, scan=scan)
    sids, slot_oflow = shared_slots(subs, mr.matches, slot_cap=slot_cap,
                                    scan=scan)

    def per_step(x):
        return x.reshape((W, B) + x.shape[1:])

    sids_w = per_step(sids)
    picks, cur = [], cursors
    for k in range(W):
        sp = pick_members(subs, cur, sids_w[k], strategy, msg_hash[k],
                          scan=scan)
        picks.append(sp)
        cur = sp.new_cursors
    res = RouteResult(
        matches=per_step(mr.matches), match_counts=per_step(mr.counts),
        rows=per_step(fr.rows), opts=per_step(fr.opts),
        fan_counts=per_step(fr.counts), shared_sids=sids_w,
        shared_rows=torch.stack([p.rows for p in picks]),
        shared_opts=torch.stack([p.opts for p in picks]),
        overflow=per_step(mr.overflow | fr.overflow | slot_oflow),
        new_cursors=torch.stack([p.new_cursors for p in picks]),
        occur=torch.stack([p.occur for p in picks]))
    cp = None
    if payload_cap is not None:
        cp = compact_result(res.matches, res.rows, res.opts, res.fan_counts,
                            res.shared_sids, res.shared_rows,
                            res.shared_opts, payload_cap=payload_cap,
                            match_holes=True, scan=scan)
    return CompactRouteResult(res=res, compact=cp)


def route_digest(r: RouteResult) -> torch.Tensor:
    """Scalar int32 reduction over every RouteResult output plane (sums
    wrap modulo 2^32 exactly as the reference's int32 sums)."""
    total = sum(x.sum(dtype=torch.int64) for x in (
        r.matches, r.rows, r.opts, r.fan_counts, r.shared_sids,
        r.shared_rows, r.shared_opts, r.match_counts,
        r.overflow.to(torch.int32), r.occur))
    total = total & 0xFFFFFFFF
    return (total - ((total >> 31) << 32)).to(torch.int32)
