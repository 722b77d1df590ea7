"""Shared-subscription member selection, batched.

Counterpart of ``emqx_tpu/ops/shared.py``. Each (group, filter) pair is a
dense "shared slot" with a persistent cursor; within a batch every
occurrence of a slot gets successive cursor offsets in batch order (the
rank over equal slots), so round-robin holds within and across batches.
The rank is computed in the sorted form (counterpart of
``_rank_and_occur_sorted``): a stable sort, run starts, and the run ids
as a prefix sum — which goes through kernel 2 (``ops/scan.py``). It
equals the reference's blocked form (``_rank_and_occur_blocked``),
including rank 0 for ``-1`` entries.

``pick_window`` picks a whole window of W sub-batches in one pass, with
the results of W chained ``pick_members`` calls (the reference's
``lax.scan``): the cursor that step k reads is the window's cursor plus
the slot's occurrences in steps before k, so one rank over the window
flattened step-major gives every pick, and int32 adds wrap alike in
either order. The per-step occurrences are counted once per (slot,
step) and their running sum along the steps is one more kernel-2 scan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from emqx_tpu_torch.ops import scan as kernel2
from emqx_tpu_torch.ops.fanout import SubTable, take
from emqx_tpu_torch.ops.scan import prefix_sum

STRATEGY_ROUND_ROBIN = 0
STRATEGY_RANDOM = 1       # pseudo-random: hash of (msg seed, slot)
STRATEGY_HASH_TOPIC = 2   # stable per topic-hash
STRATEGY_HASH_CLIENT = 3  # stable per publisher-hash
STRATEGY_STICKY = 4       # persistent per-slot member (cursor = affinity)
STRATEGIES = {
    "round_robin": STRATEGY_ROUND_ROBIN,
    "random": STRATEGY_RANDOM,
    "hash_topic": STRATEGY_HASH_TOPIC,
    "hash_clientid": STRATEGY_HASH_CLIENT,
    # sticky rides the round_robin cursor state, reinterpreted: the host
    # seeds each slot's cursor with its sticky member and it never advances
    "sticky": STRATEGY_STICKY,
}


class SharedPickResult(NamedTuple):
    rows: torch.Tensor         # [B, K] picked member session row, -1 pad
    opts: torch.Tensor         # [B, K] packed subopts of picked member
    new_cursors: torch.Tensor  # [G] updated round-robin cursors
    occur: torch.Tensor        # [G] occurrences of each slot in this batch


def _sorted_rank(flat: torch.Tensor, *, scan):
    """Stable sort of 1-D slot ids and each lane's rank: the number of
    equal ids before it (0 for -1 lanes). Returns (sorted ids, rank in
    sorted order, run ends in sorted order, rank in lane order)."""
    n = flat.shape[0]
    dev = flat.device
    sorted_sids, order = torch.sort(flat, stable=True)
    change = sorted_sids[1:] != sorted_sids[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    is_start = torch.cat([one, change])
    is_end = torch.cat([change, one])
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    run_id = scan(is_start.to(torch.int32)) - 1
    # scatters through a spare last slot instead of boolean-mask indexing:
    # a mask index sizes its result on the host (a device sync per call)
    starts = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    starts.scatter_(0, torch.where(is_start, run_id, n).long(), pos)
    rank_sorted = pos - starts[run_id.long()]
    rank = torch.zeros(n, dtype=torch.int32, device=dev)
    rank[order] = rank_sorted
    rank = torch.where(flat >= 0, rank, 0)
    return sorted_sids, rank_sorted, is_end, rank


def _run_occur(sorted_sids, rank_sorted, is_end, n_slots: int):
    """occur[g] = occurrences of slot g: at each run END the rank is
    (count-1), and the slots are unique there."""
    occur = torch.zeros(n_slots + 1, dtype=torch.int32,
                        device=sorted_sids.device)
    last = is_end & (sorted_sids >= 0) & (sorted_sids < n_slots)
    occur.scatter_(0, torch.where(last, sorted_sids, n_slots).long(),
                   rank_sorted + 1)
    return occur[:n_slots]


def rank_and_occur(sids: torch.Tensor, n_slots: int, *, scan=prefix_sum):
    """rank[b,k] = #occurrences of sids[b,k] earlier in flattened batch
    order (0 for -1 entries); occur[g] = occurrences of slot g."""
    sorted_sids, rank_sorted, is_end, rank = _sorted_rank(
        sids.reshape(-1), scan=scan)
    return (rank.reshape(sids.shape),
            _run_occur(sorted_sids, rank_sorted, is_end, n_slots))


def _step_occur(sids: torch.Tensor, n_slots: int) -> torch.Tensor:
    """[G, W] occurrences of each slot in each step of a [W, B, K]
    window: one scatter-add of ones at slot·W + step. Each -1 or
    out-of-range lane adds to a spare element of its own past the G·W
    counts: atomic adds to one address run one at a time."""
    W = sids.shape[0]
    dev = sids.device
    flat = sids.reshape(W, -1)
    n, GW = flat.numel(), n_slots * W
    key = flat.long() * W + torch.arange(W, device=dev)[:, None]
    keep = (flat >= 0) & (flat < n_slots)
    spare = torch.arange(GW, GW + n, device=dev).view(W, -1)
    occ = torch.zeros(GW + n, dtype=torch.int32, device=dev)
    occ.scatter_add_(0, torch.where(keep, key, spare).reshape(-1),
                     torch.ones(n, dtype=torch.int32, device=dev))
    return occ[:GW].view(n_slots, W)


def hash_base(msg_hash: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """abs(int32((uint32(msg_hash) * 0x9E3779B1) ^ uint32(slot))), with
    abs(INT32_MIN) == INT32_MIN as in int32 arithmetic."""
    m = msg_hash.long()[..., None] & 0xFFFFFFFF
    lo, hi = 0x79B1, 0x9E37          # 0x9E3779B1 in 16-bit halves
    x = (m * lo + (((m * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF
    x = x ^ (safe.long() & 0xFFFFFFFF)
    x = x - ((x >> 31) << 32)        # reinterpret as signed 32-bit
    return torch.where(x == -(1 << 31), x, x.abs())


def pick_members(table: SubTable, cursors: torch.Tensor, sids: torch.Tensor,
                 strategy: int, msg_hash: torch.Tensor, *,
                 scan=prefix_sum) -> SharedPickResult:
    """Pick one member per matched shared slot, batched.

    cursors: [G] persistent per-slot round-robin counters (device state).
    sids: [B, K] matched shared-slot ids (-1 pad) from shared_slots().
    strategy: STRATEGY_* id. msg_hash: [B] int32 per-message hash, used by
      the random/hash strategies.
    """
    r = pick_window(table, cursors, sids[None], strategy, msg_hash[None],
                    scan=scan)
    return SharedPickResult(*(x[0] for x in r))


def pick_window(table: SubTable, cursors: torch.Tensor, sids: torch.Tensor,
                strategy: int, msg_hash: torch.Tensor, *,
                scan=prefix_sum) -> SharedPickResult:
    """``pick_members`` over a window of W sub-batches, the cursors
    threaded through them in order: sids [W, B, K], msg_hash [W, B]; every
    field comes back stacked [W, ...], row k of ``new_cursors`` and
    ``occur`` the state after sub-batch k.

    One stable sort and one run-id scan at [W·B·K] rank the whole window;
    the per-step occurrences take one scatter-add and one scan at [G, W].
    A window longer than kernel 2's ``MAX_LEN`` runs as the fewest groups
    of whole steps that fit, the cursors threaded between them. W = 1 is
    ``pick_members``' own pass: the run ends give ``occur``. Nothing
    syncs with the host, so the pass can be captured into a CUDA graph.
    Slot ids index the cursors (< G), as ``shared_slots`` gives them.
    """
    W, B, K = sids.shape
    fit = max(1, kernel2.MAX_LEN // (B * K))
    if W > fit:
        parts, cur = [], cursors
        for k in range(0, W, fit):
            p = pick_window(table, cur, sids[k:k + fit], strategy,
                            msg_hash[k:k + fit], scan=scan)
            parts.append(p)
            cur = p.new_cursors[-1]
        return SharedPickResult(*(torch.cat(x) for x in zip(*parts)))
    G = cursors.shape[0]
    valid = sids >= 0
    safe = sids.clamp(min=0)
    lo = take(table.shared_start, safe)
    size = take(table.shared_start, safe + 1) - lo   # [W, B, K] members
    nonempty = valid & (size > 0)

    sorted_sids, rank_sorted, is_end, rank = _sorted_rank(
        sids.reshape(-1), scan=scan)
    rank = rank.view(sids.shape)
    cur = take(cursors, safe)
    if strategy == STRATEGY_ROUND_ROBIN:
        base = cur + rank   # int32 add: wraps like the reference's
    elif strategy == STRATEGY_STICKY:
        base = cur
    else:
        base = hash_base(msg_hash, safe)
    member = torch.where(nonempty,
                         torch.remainder(base.long(), size.clamp(min=1)), 0)
    idx = (lo + member).to(torch.int32)
    rows = torch.where(nonempty, take(table.shared_row, idx), -1)
    opts = torch.where(nonempty, take(table.shared_opts, idx),
                       torch.zeros((), dtype=table.shared_opts.dtype,
                                   device=sids.device))
    rr = strategy == STRATEGY_ROUND_ROBIN
    if W == 1:
        occur = _run_occur(sorted_sids, rank_sorted, is_end, G)
        new_cursors = cursors + occur if rr else cursors.clone()
        occur, new_cursors = occur[None], new_cursors[None]
    else:
        # the state after step k: the window's cursors plus the slot's
        # occurrences through step k (kernel 2 along the steps)
        occ = _step_occur(sids, G)                     # [G, W]
        new_cursors = (cursors[:, None] + scan(occ)).t().contiguous() if rr \
            else cursors.expand(W, G).contiguous()
        occur = occ.t().contiguous()
    return SharedPickResult(rows=rows, opts=opts, new_cursors=new_cursors,
                            occur=occur)
