"""The PUBLISH route window: match → fan-out → shared picks → compaction.

Counterpart of ``emqx_tpu/models/router_engine.py``: the table and result
types (``RouterTables`` :37, ``ExchangeAux`` :63, ``ExchangeResult`` :74),
``post_match`` (:87), the trie ``route_step`` (:106), ``route_step_shapes``
(:119), ``route_step_compact`` (:235), ``route_window_full`` (:683)
together with ``route_window_full_compact`` (:281), and ``route_digest``
(:631); the deduplicated programs ``route_step_cached`` (:133),
``route_window_cached`` (:162), ``route_step_cached_compact`` (:254) and
``route_window_cached_compact`` (:299); and the delta-overlay programs
(:323-630): ``DeltaRouteResult``, ``CompactDeltaRouteResult`` and the
eight ``route_{step,window}_delta[_cached][_compact]`` variants.

``route_window`` routes W sub-batches in one call. The match, the normal
fan-out and the shared-slot expansion do not depend on the cursors, so
they run once over the flattened W×B lanes; the member picks of the W
sub-batches then run as one pass over the window (``pick_window``) with
the results of the reference's ``lax.scan`` over the steps, so row k of
``new_cursors``/``occur`` is the state after sub-batch k. A window
program takes its payload class as ``payload_cap`` (None: dense planes
only), where the reference has a ``_compact`` twin of each.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from emqx_tpu_torch.device import span
from emqx_tpu_torch.ops.compact import CompactPlanes, compact_result
from emqx_tpu_torch.ops.fanout import SubTable, fanout_normal, shared_slots
from emqx_tpu_torch.ops.delta import (DeltaPlanes, DeltaTables,
                                      delta_expand, delta_match,
                                      delta_overlay)
from emqx_tpu_torch.ops.match import (MatchResult, match_batch,
                                      merge_match_results)
from emqx_tpu_torch.ops.scan import prefix_sum
from emqx_tpu_torch.ops.shapes import ShapeTables, shape_match
from emqx_tpu_torch.ops.shared import pick_members, pick_window
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


def _stack1(r: RouteResult) -> RouteResult:
    """Lift a single-batch RouteResult to window form (W = 1)."""
    return RouteResult(*[x[None] for x in r])


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
    r = _stack1(r)
    return CompactRouteResult(res=r, compact=_compact(r, payload_cap, False,
                                                      scan))


def _post_window(subs: SubTable, mr: MatchResult, cursors: torch.Tensor,
                 msg_hash: torch.Tensor, W: int, B: int, strategy: int, *,
                 fanout_cap: int, slot_cap: int, scan) -> RouteResult:
    """post_match over a window's W×B flattened match rows: fan-out and
    slot expansion once over every lane, then the member picks of all W
    steps in one pass (``ops/shared.pick_window``: one sort and one rank
    scan over the window, the cursors threaded along the steps by a scan);
    every field stacked [W, ...]. The two halves run inside the
    ``route.expand`` and ``route.picks`` ranges."""

    def per_step(x):
        return x.reshape((W, B) + x.shape[1:])

    with span("route.expand"):
        fr = fanout_normal(subs, mr.matches, fanout_cap=fanout_cap,
                           scan=scan)
        sids, slot_oflow = shared_slots(subs, mr.matches, slot_cap=slot_cap,
                                        scan=scan)
        overflow = mr.overflow | fr.overflow | slot_oflow
    sids_w = per_step(sids)
    with span("route.picks"):
        sp = pick_window(subs, cursors, sids_w, strategy, msg_hash,
                         scan=scan)
    return RouteResult(
        matches=per_step(mr.matches), match_counts=per_step(mr.counts),
        rows=per_step(fr.rows), opts=per_step(fr.opts),
        fan_counts=per_step(fr.counts), shared_sids=sids_w,
        shared_rows=sp.rows, shared_opts=sp.opts,
        overflow=per_step(overflow), new_cursors=sp.new_cursors,
        occur=sp.occur)


def _compact(r: RouteResult, payload_cap: int, match_holes: bool,
             scan) -> CompactPlanes:
    return compact_result(r.matches, r.rows, r.opts, r.fan_counts,
                          r.shared_sids, r.shared_rows, r.shared_opts,
                          payload_cap=payload_cap, match_holes=match_holes,
                          scan=scan)


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
    the same device. The stages run inside the ``route.match``,
    ``route.expand``, ``route.picks`` and ``route.compact`` ranges
    (``device.span``).
    """
    W, B, L = topics.shape
    with span("route.match"):
        mr = match(tables.shapes, topics.reshape(W * B, L),
                   lens.reshape(W * B), is_dollar.reshape(W * B))
    res = _post_window(tables.subs, mr, cursors, msg_hash, W, B, strategy,
                       fanout_cap=fanout_cap, slot_cap=slot_cap, scan=scan)
    cp = None
    if payload_cap is not None:
        with span("route.compact"):
            cp = _compact(res, payload_cap, True, scan)
    return CompactRouteResult(res=res, compact=cp)


# ---- the deduplicated (cache-backed) programs -----------------------------
#
# The match stage runs only on the [Bm] compacted miss lanes; cache-hit
# unique topics ride in as host-filled base rows ([U] per unique topic,
# U = Bp). ``merge_match_results`` scatters the fresh rows into the base,
# and ``inv`` gathers the unique rows back to full width before the
# cursor-dependent post stage, so the result equals the plain program's
# on the same window bit for bit.

def _gather(um: MatchResult, inv: torch.Tensor) -> MatchResult:
    ix = inv.reshape(-1).long()
    return MatchResult(matches=um.matches[ix], counts=um.counts[ix],
                       overflow=um.overflow[ix])


def route_step_cached(tables: RouterTables, cursors, miss_topics, miss_lens,
                      miss_dollar, base_matches, base_counts, base_overflow,
                      miss_pos, inv, msg_hash, strategy: int, *,
                      frontier_cap: int = 16, match_cap: int = 64,
                      fanout_cap: int = 128, slot_cap: int = 16,
                      scan=prefix_sum) -> RouteResult:
    """Trie-NFA route step over a deduplicated batch with cached rows
    (``route_step_cached``, reference :133); ``inv`` is [B]."""
    mr = match_batch(tables.trie, miss_topics, miss_lens, miss_dollar,
                     frontier_cap=frontier_cap, match_cap=match_cap,
                     scan=scan)
    um = merge_match_results(base_matches, base_counts, base_overflow, mr,
                             miss_pos)
    return post_match(tables.subs, _gather(um, inv), cursors, msg_hash,
                      strategy, fanout_cap=fanout_cap, slot_cap=slot_cap,
                      scan=scan)


def route_step_cached_compact(tables: RouterTables, cursors, miss_topics,
                              miss_lens, miss_dollar, base_matches,
                              base_counts, base_overflow, miss_pos, inv,
                              msg_hash, strategy: int, *,
                              frontier_cap: int = 16, match_cap: int = 64,
                              fanout_cap: int = 128, slot_cap: int = 16,
                              payload_cap: int = 4096,
                              scan=prefix_sum) -> CompactRouteResult:
    """Deduplicated trie step + fused CSR readback, window-shaped
    (reference :254)."""
    r = _stack1(route_step_cached(
        tables, cursors, miss_topics, miss_lens, miss_dollar, base_matches,
        base_counts, base_overflow, miss_pos, inv, msg_hash, strategy,
        frontier_cap=frontier_cap, match_cap=match_cap,
        fanout_cap=fanout_cap, slot_cap=slot_cap, scan=scan))
    return CompactRouteResult(res=r, compact=_compact(r, payload_cap, False,
                                                      scan))


def route_window_cached(tables: ShapeRouterTables, cursors, miss_topics,
                        miss_lens, miss_dollar, base_matches, base_counts,
                        base_overflow, miss_pos, inv, msg_hash,
                        strategy: int, *, fanout_cap: int = 128,
                        slot_cap: int = 16,
                        payload_cap: Optional[int] = None,
                        match=shape_match,
                        scan=prefix_sum) -> CompactRouteResult:
    """Shape-hash window over a deduplicated window with cached rows
    (``route_window_cached`` :162, with ``payload_cap`` its ``_compact``
    twin :299): kernel 1 runs once over the [Bm] miss lanes, ``inv``
    [W, B] gathers the merged unique rows back to window width, and the
    post stage threads the cursors through the W steps. The merge and
    gather run inside ``route.match`` with kernel 1, the rest inside the
    ranges of ``route_window``."""
    W, B = inv.shape
    with span("route.match"):
        mr = match(tables.shapes, miss_topics, miss_lens, miss_dollar)
        um = _gather(merge_match_results(base_matches, base_counts,
                                         base_overflow, mr, miss_pos), inv)
    res = _post_window(tables.subs, um, cursors, msg_hash, W, B, strategy,
                       fanout_cap=fanout_cap, slot_cap=slot_cap, scan=scan)
    cp = None
    if payload_cap is not None:
        with span("route.compact"):
            cp = _compact(res, payload_cap, True, scan)
    return CompactRouteResult(res=res, compact=cp)


def route_window_cached_compact(*args, payload_cap: int = 4096,
                                **kw) -> CompactRouteResult:
    """``route_window_cached`` with its CSR readback (reference :299)."""
    return route_window_cached(*args, payload_cap=payload_cap, **kw)


# ---- the delta-overlay programs ------------------------------------------

class DeltaRouteResult(NamedTuple):
    """A route result with its fused delta-overlay planes: ``res`` is the
    main snapshot's, window-shaped [W, ...] for every variant; ``dp`` the
    overlay's match and fan-out planes, each [W, B, ...]. The two fid
    spaces are disjoint: ``res.matches`` are snapshot fids, ``dp.fids``
    the engine's delta fids."""
    res: RouteResult
    dp: DeltaPlanes


class CompactDeltaRouteResult(NamedTuple):
    """DeltaRouteResult + the CSR readbacks of both plane families: the
    overlay's reuses ``compact_result`` with an empty width-1 shared
    family, so ``csr_slices`` decodes both."""
    dres: DeltaRouteResult
    compact: CompactPlanes
    d_compact: CompactPlanes


def _window_delta(delta: DeltaTables, topics, lens, is_dollar, *,
                  dmatch_cap: int, dfan_cap: int, scan) -> DeltaPlanes:
    """Overlay planes for a full [W, B] window: the linear matcher does
    not depend on the cursors, so it runs once over the flattened lanes."""
    W, B = topics.shape[:2]
    mr = delta_match(delta, topics.reshape(W * B, -1), lens.reshape(W * B),
                     is_dollar.reshape(W * B), match_cap=dmatch_cap,
                     scan=scan)
    dp = delta_expand(delta, mr, fanout_cap=dfan_cap, scan=scan)
    return DeltaPlanes(*[x.reshape((W, B) + x.shape[1:]) for x in dp])


def _cached_delta(delta: DeltaTables, miss_topics, miss_lens, miss_dollar,
                  base_dm, base_dc, base_do, miss_pos, inv, *,
                  dmatch_cap: int, dfan_cap: int, scan) -> DeltaPlanes:
    """Overlay planes for a deduplicated dispatch: the matcher runs on the
    [Bm] miss lanes, the cache-hit base rows (overlay ROW indices, counts,
    match-level overflow) merge with the same scatter as the main match,
    the fan-out expands the merged unique rows against the CURRENT overlay
    CSR (cached rows carry no membership), and ``inv`` gathers back to
    full width ([B] for a step, [W, B] for a window)."""
    mr = delta_match(delta, miss_topics, miss_lens, miss_dollar,
                     match_cap=dmatch_cap, scan=scan)
    um = merge_match_results(base_dm, base_dc, base_do, mr, miss_pos)
    dp_u = delta_expand(delta, um, fanout_cap=dfan_cap, scan=scan)
    ix = inv.long()
    return DeltaPlanes(*[x[ix] for x in dp_u])


def _stack1_dp(dp: DeltaPlanes) -> DeltaPlanes:
    return DeltaPlanes(*[x[None] for x in dp])


def _dkw(delta_match_cap, delta_fanout_cap, scan):
    return dict(dmatch_cap=delta_match_cap, dfan_cap=delta_fanout_cap,
                scan=scan)


def route_step_delta(tables: RouterTables, delta: DeltaTables, cursors,
                     topics, lens, is_dollar, msg_hash, strategy: int, *,
                     frontier_cap: int = 16, match_cap: int = 64,
                     fanout_cap: int = 128, slot_cap: int = 16,
                     delta_match_cap: int = 16, delta_fanout_cap: int = 64,
                     scan=prefix_sum) -> DeltaRouteResult:
    """Trie-NFA route step + the delta overlay (W = 1), reference :392."""
    r = route_step(tables, cursors, topics, lens, is_dollar, msg_hash,
                   strategy, frontier_cap=frontier_cap, match_cap=match_cap,
                   fanout_cap=fanout_cap, slot_cap=slot_cap, scan=scan)
    dp = delta_overlay(delta, topics, lens, is_dollar,
                       match_cap=delta_match_cap,
                       fanout_cap=delta_fanout_cap, scan=scan)
    return DeltaRouteResult(res=_stack1(r), dp=_stack1_dp(dp))


def route_window_delta(tables: ShapeRouterTables, delta: DeltaTables,
                       cursors, topics, lens, is_dollar, msg_hash,
                       strategy: int, *, fanout_cap: int = 128,
                       slot_cap: int = 16, delta_match_cap: int = 16,
                       delta_fanout_cap: int = 64, match=shape_match,
                       scan=prefix_sum) -> DeltaRouteResult:
    """The shape-hash window + the delta overlay, reference :415."""
    r = route_window(tables, cursors, topics, lens, is_dollar, msg_hash,
                     strategy, fanout_cap=fanout_cap, slot_cap=slot_cap,
                     match=match, scan=scan).res
    dp = _window_delta(delta, topics, lens, is_dollar,
                       **_dkw(delta_match_cap, delta_fanout_cap, scan))
    return DeltaRouteResult(res=r, dp=dp)


def route_step_delta_cached(tables: RouterTables, delta: DeltaTables,
                            cursors, miss_topics, miss_lens, miss_dollar,
                            base_matches, base_counts, base_overflow,
                            base_dm, base_dc, base_do, miss_pos, inv,
                            msg_hash, strategy: int, *,
                            frontier_cap: int = 16, match_cap: int = 64,
                            fanout_cap: int = 128, slot_cap: int = 16,
                            delta_match_cap: int = 16,
                            delta_fanout_cap: int = 64,
                            scan=prefix_sum) -> DeltaRouteResult:
    """Deduplicated trie step + the overlay, reference :436."""
    r = route_step_cached(tables, cursors, miss_topics, miss_lens,
                          miss_dollar, base_matches, base_counts,
                          base_overflow, miss_pos, inv, msg_hash, strategy,
                          frontier_cap=frontier_cap, match_cap=match_cap,
                          fanout_cap=fanout_cap, slot_cap=slot_cap,
                          scan=scan)
    dp = _cached_delta(delta, miss_topics, miss_lens, miss_dollar, base_dm,
                       base_dc, base_do, miss_pos, inv,
                       **_dkw(delta_match_cap, delta_fanout_cap, scan))
    return DeltaRouteResult(res=_stack1(r), dp=_stack1_dp(dp))


def route_window_delta_cached(tables: ShapeRouterTables,
                              delta: DeltaTables, cursors, miss_topics,
                              miss_lens, miss_dollar, base_matches,
                              base_counts, base_overflow, base_dm, base_dc,
                              base_do, miss_pos, inv, msg_hash,
                              strategy: int, *, fanout_cap: int = 128,
                              slot_cap: int = 16, delta_match_cap: int = 16,
                              delta_fanout_cap: int = 64, match=shape_match,
                              scan=prefix_sum) -> DeltaRouteResult:
    """Deduplicated window + the overlay, reference :470."""
    r = route_window_cached(tables, cursors, miss_topics, miss_lens,
                            miss_dollar, base_matches, base_counts,
                            base_overflow, miss_pos, inv, msg_hash,
                            strategy, fanout_cap=fanout_cap,
                            slot_cap=slot_cap, match=match, scan=scan).res
    dp = _cached_delta(delta, miss_topics, miss_lens, miss_dollar, base_dm,
                       base_dc, base_do, miss_pos, inv,
                       **_dkw(delta_match_cap, delta_fanout_cap, scan))
    return DeltaRouteResult(res=r, dp=dp)


def _with_delta_compact(dres: DeltaRouteResult, payload_cap: int,
                        d_payload_cap: int, match_holes: bool,
                        scan=prefix_sum) -> CompactDeltaRouteResult:
    """Both CSR compactions on a delta route result (reference :499): the
    overlay family with a width-1 all-empty shared family (cs == 0) and
    no hole closing (overlay matches are prefix-compacted)."""
    r, dp = dres.res, dres.dp
    W, B = dp.fids.shape[:2]
    dev = dp.fids.device
    no_slot = torch.full((W, B, 1), -1, dtype=torch.int32, device=dev)
    zero32 = torch.zeros((W, B, 1), dtype=torch.int32, device=dev)
    zero8 = torch.zeros((W, B, 1), dtype=torch.int8, device=dev)
    dcp = compact_result(dp.fids, dp.rows, dp.opts, dp.fan_counts, no_slot,
                         zero32, zero8, payload_cap=d_payload_cap,
                         match_holes=False, scan=scan)
    return CompactDeltaRouteResult(
        dres=dres, compact=_compact(r, payload_cap, match_holes, scan),
        d_compact=dcp)


def route_step_delta_compact(*args, payload_cap: int = 4096,
                             d_payload_cap: int = 1024, scan=prefix_sum,
                             **kw) -> CompactDeltaRouteResult:
    """route_step_delta + both CSR readbacks, reference :527."""
    return _with_delta_compact(route_step_delta(*args, scan=scan, **kw),
                               payload_cap, d_payload_cap, False, scan)


def route_window_delta_compact(*args, payload_cap: int = 4096,
                               d_payload_cap: int = 1024, scan=prefix_sum,
                               **kw) -> CompactDeltaRouteResult:
    """route_window_delta + both CSR readbacks, reference :552."""
    return _with_delta_compact(route_window_delta(*args, scan=scan, **kw),
                               payload_cap, d_payload_cap, True, scan)


def route_step_delta_cached_compact(*args, payload_cap: int = 4096,
                                    d_payload_cap: int = 1024,
                                    scan=prefix_sum,
                                    **kw) -> CompactDeltaRouteResult:
    """Deduplicated trie step + overlay + both CSR readbacks, :575."""
    return _with_delta_compact(
        route_step_delta_cached(*args, scan=scan, **kw), payload_cap,
        d_payload_cap, False, scan)


def route_window_delta_cached_compact(*args, payload_cap: int = 4096,
                                      d_payload_cap: int = 1024,
                                      scan=prefix_sum,
                                      **kw) -> CompactDeltaRouteResult:
    """Deduplicated window + overlay + both CSR readbacks, :606."""
    return _with_delta_compact(
        route_window_delta_cached(*args, scan=scan, **kw), payload_cap,
        d_payload_cap, True, scan)


def route_digest(r: RouteResult) -> torch.Tensor:
    """Scalar int32 reduction over every RouteResult output plane (sums
    wrap modulo 2^32 exactly as the reference's int32 sums)."""
    total = sum(x.sum(dtype=torch.int64) for x in (
        r.matches, r.rows, r.opts, r.fan_counts, r.shared_sids,
        r.shared_rows, r.shared_opts, r.match_counts,
        r.overflow.to(torch.int32), r.occur))
    total = total & 0xFFFFFFFF
    return (total - ((total >> 31) << 32)).to(torch.int32)
