"""Device-resident delta overlay: post-snapshot filters matched on device.

Counterpart of ``emqx_tpu/ops/delta.py``: ``DeltaTables`` and
``DeltaPlanes``, ``delta_match`` (:92), ``delta_expand`` (:144),
``delta_overlay`` (:164), and the numpy ``build_delta_tables`` (:177),
``np_filter_match`` (:222) and ``empty_delta_tables`` (:247).

The compiled tables are an immutable snapshot. Filters subscribed after
the build live in a small flat overlay table — encoded level ids in the
same intern id space as the main tables, plus a per-row fan-out CSR — and
a linear matcher runs them against every publish lane inside the same
route window (``models/router_engine.route_*_delta*``), so a subscription
landing one window ago is matched on the card in the same dispatch. The
overlay is bounded by the engine's compaction policy to a few hundred
rows, so the match is a dense [N, C] test over the L levels, and the
table rebuilds on the host in microseconds on every subscribe.

Match semantics are emqx_topic.erl match/2, as the main tables': per
level an exact word id or '+'; a trailing '#' matches zero or more
remaining levels; '$'-rooted topics skip filters whose first level is
'+' or '#'; unseen publish words encode to UNKNOWN and match wildcards
only.

Emitted matches are overlay ROW indices, prefix-compacted with -1 pad;
the engine's delta fids ride in ``DeltaTables.fids`` for host
attribution. The emission compaction (a prefix sum over [N, C]) and the
fan-out expansion (``ops/fanout._segment_expand`` over the overlay's own
CSR) go through kernel 2 (``ops/scan.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from emqx_tpu_torch.ops.fanout import _segment_expand, take
from emqx_tpu_torch.ops.intern import HASH, PAD, PLUS
from emqx_tpu_torch.ops.match import MatchResult
from emqx_tpu_torch.ops.scan import prefix_sum


class DeltaTables(NamedTuple):
    """Flat overlay of post-snapshot filters (numpy from
    ``build_delta_tables``, tensors after ``to_device``).

    levels: [C, L] int32 encoded filter level ids ('+'/'#' as the
            reserved PLUS/HASH ids, PAD beyond lens[c]).
    lens:   [C] int32 level counts; 0 = empty row (matches nothing).
    fids:   [C] int32 engine delta fid per row (-1 = empty).
    sub_start/sub_row/sub_opts: per-row fan-out CSR (session rows and
            packed subopts). Rows delivering on the host (rich subopts,
            oversized fan-out) keep an EMPTY segment and still match.
    """

    levels: object      # [C, L]
    lens: object        # [C]
    fids: object        # [C]
    sub_start: object   # [C+1]
    sub_row: object     # [S]
    sub_opts: object    # [S] int8


class DeltaPlanes(NamedTuple):
    """Per-lane overlay planes: the delta twin of RouteResult's match and
    fan-out families (a post-snapshot shared group dispatches on the host
    through the consume's sweep)."""

    fids: torch.Tensor        # [N, Dm] delta fids in match order (-1 pad)
    counts: torch.Tensor      # [N] true delta match count
    moverflow: torch.Tensor   # [N] match-capacity overflow (pre-fan-out)
    rows: torch.Tensor        # [N, Dc] fan-out session rows (-1 pad)
    opts: torch.Tensor        # [N, Dc] packed subopts
    fan_counts: torch.Tensor  # [N] true fan-out entry count
    overflow: torch.Tensor    # [N] combined (match | fan-out) overflow


def to_device(dt: DeltaTables, device) -> DeltaTables:
    """Upload a numpy DeltaTables, dtypes unchanged."""
    return DeltaTables(*[torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in dt])


def delta_match(dt: DeltaTables, topics: torch.Tensor, lens: torch.Tensor,
                is_dollar: torch.Tensor, *, match_cap: int,
                scan=prefix_sum) -> MatchResult:
    """Linear wildcard match of [N] topic lanes against [C] overlay rows.

    Returns a MatchResult whose ``matches`` are overlay row indices in
    ascending order (overlay insertion order), prefix-compacted, and whose
    ``counts`` are the true match counts. The level test runs over the
    whole [N, C, L] block at once; the emission compaction is a prefix
    sum over [N, C] through ``scan``.
    """
    N, L = topics.shape
    C = dt.levels.shape[0]
    dev = topics.device
    flen = dt.lens                                             # [C]
    crow = torch.arange(C, device=dev)
    last = dt.levels[crow, (flen - 1).clamp(min=0).long()]
    last_hash = (flen > 0) & (last == HASH)                    # [C]
    # the prefix to verify level by level: everything before the '#'
    plen = flen - last_hash.to(flen.dtype)                     # [C]
    fl = dt.levels[:, :L]                                      # [C, L]
    lvl_ok = (fl[None] == topics[:, None, :]) | (fl == PLUS)[None]
    need = torch.arange(L, device=dev)[None, :] < plen[:, None]   # [C, L]
    ok = (lvl_ok | ~need[None]).all(-1)                        # [N, C]
    len_ok = torch.where(last_hash[None, :],
                         lens[:, None] >= plen[None, :],
                         lens[:, None] == flen[None, :])
    first = dt.levels[:, 0]
    dollar_skip = is_dollar[:, None] \
        & ((first == PLUS) | (first == HASH))[None, :]
    valid = (ok & len_ok & ~dollar_skip & (flen > 0)[None, :]
             & (dt.fids >= 0)[None, :] & (lens > 0)[:, None])   # [N, C]

    counts = valid.sum(-1, dtype=torch.int32)
    pos = scan(valid.to(torch.int32)) - 1
    # column match_cap is a spill column, sliced away (the reference
    # drops out-of-range writes)
    pos = torch.where(valid, pos, match_cap).clamp(max=match_cap)
    out = torch.full((N, match_cap + 1), -1, dtype=torch.int32, device=dev)
    out.scatter_(1, pos.long(),
                 crow.to(torch.int32).expand(N, C).contiguous())
    return MatchResult(matches=out[:, :match_cap].contiguous(),
                       counts=counts, overflow=counts > match_cap)


def delta_expand(dt: DeltaTables, mr: MatchResult, *, fanout_cap: int,
                 scan=prefix_sum) -> DeltaPlanes:
    """Expand matched overlay rows into fan-out planes and delta fids.

    ``mr.overflow`` must be the MATCH-level overflow only (delta_match's,
    or a cache-merged base of the same): the fan-out overflow is computed
    here from the CURRENT table, so a membership change between cache
    population and dispatch cannot resurrect a stale overflow bit.
    """
    rows, idx, fan_counts, fan_oflow = _segment_expand(
        dt.sub_start, dt.sub_row, mr.matches, fanout_cap, scan)
    opts = torch.where(idx >= 0, take(dt.sub_opts, idx),
                       torch.zeros((), dtype=dt.sub_opts.dtype,
                                   device=idx.device))
    safe = mr.matches.clamp(0, dt.fids.shape[0] - 1).long()
    fids = torch.where(mr.matches >= 0, dt.fids[safe], -1)
    return DeltaPlanes(fids=fids, counts=mr.counts, moverflow=mr.overflow,
                       rows=rows, opts=opts, fan_counts=fan_counts,
                       overflow=mr.overflow | fan_oflow)


def delta_overlay(dt: DeltaTables, topics: torch.Tensor, lens: torch.Tensor,
                  is_dollar: torch.Tensor, *, match_cap: int = 16,
                  fanout_cap: int = 64, scan=prefix_sum) -> DeltaPlanes:
    """match + expand in one call (the plain composition; the cached route
    programs call the two stages around their base-row merge)."""
    return delta_expand(dt, delta_match(dt, topics, lens, is_dollar,
                                        match_cap=match_cap, scan=scan),
                        fanout_cap=fanout_cap, scan=scan)


# ---- host-side builder and host-mirror matcher ---------------------------

def build_delta_tables(entries: list, *, row_cap: int, level_cap: int,
                       fan_per_row: int = 8) -> DeltaTables:
    """Compile overlay entries into numpy DeltaTables (uploaded by the
    caller, ``to_device``).

    entries: list of (word_ids, fid, fan) where ``fan`` is a list of
    (session_row, packed_opts) — an EMPTY fan list for rows whose
    delivery stays on the host (rich subopts, oversized fan-out).
    Capacities are fixed per (row_cap, level_cap, fan_per_row) class: sub
    rows are ``row_cap * fan_per_row``, so overlay membership growth never
    changes the shapes inside a class.
    """
    C, L = row_cap, level_cap
    S = max(1, C * fan_per_row)
    levels = np.full((C, L), PAD, np.int32)
    lens = np.zeros(C, np.int32)
    fids = np.full(C, -1, np.int32)
    sub_start = np.zeros(C + 1, np.int32)
    sub_row = np.full(S, -1, np.int32)
    sub_opts = np.zeros(S, np.int8)
    if len(entries) > C:
        raise ValueError(f"{len(entries)} overlay entries > row cap {C}")
    off = 0
    for c, (words, fid, fan) in enumerate(entries):
        if len(words) > L:
            raise ValueError(f"overlay filter deeper than {L} levels")
        levels[c, :len(words)] = words
        lens[c] = len(words)
        fids[c] = fid
        if len(fan) > fan_per_row:
            raise ValueError(
                f"{len(fan)} fan rows > per-row budget {fan_per_row}")
        sub_start[c] = off
        for sid, opt in fan:
            sub_row[off] = sid
            sub_opts[off] = opt
            off += 1
    sub_start[len(entries):] = off
    return DeltaTables(levels=levels, lens=lens, fids=fids,
                       sub_start=sub_start, sub_row=sub_row,
                       sub_opts=sub_opts)


def np_filter_match(words: list, enc: np.ndarray, lens: np.ndarray,
                    dollar: np.ndarray) -> np.ndarray:
    """Host mirror of delta_match for ONE filter against [N] encoded
    topics: the delta-aware match-cache invalidation check
    (``broker/match_cache.drop_where``) — a new or deleted overlay filter
    drops exactly the cached topics it matches."""
    fl = len(words)
    if fl == 0:
        return np.zeros(len(lens), bool)
    last_hash = words[-1] == HASH
    plen = fl - (1 if last_hash else 0)
    ok = lens > 0
    if last_hash:
        ok &= lens >= plen
    else:
        ok &= lens == fl
    for l in range(min(plen, enc.shape[1])):
        if words[l] != PLUS:
            ok &= enc[:, l] == words[l]
    if words[0] in (PLUS, HASH):
        ok &= ~dollar.astype(bool)
    return ok


def empty_delta_tables(row_cap: int, level_cap: int,
                       fan_per_row: int = 8) -> DeltaTables:
    return build_delta_tables([], row_cap=row_cap, level_cap=level_cap,
                              fan_per_row=fan_per_row)
