"""Batched wildcard topic matching: a level-stepped NFA over TrieTables,
plus host-side topic encoding.

Counterpart of ``emqx_tpu/ops/match.py``: ``MatchResult``,
``edge_lookup`` (:40), ``_gather_node`` (:54), ``match_batch`` (:61),
``merge_match_results`` (:137) and the Python path of ``encode_topics`` /
``encode_topics_str``.

``match_batch`` matches a whole batch at once: the batch is the parallel
axis, topic levels the time axis (the reference's ``lax.scan`` becomes a
Python loop), and each topic carries a fixed-capacity frontier of live
trie nodes. Semantics follow emqx_topic.erl match/2, including the
root-level '$' exclusion and "sport/# matches sport". Plain PyTorch: the
reference has no Pallas kernel here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from emqx_tpu_torch.ops.intern import PAD, UNKNOWN
from emqx_tpu_torch.ops.scan import prefix_sum
from emqx_tpu_torch.ops.trie import MAX_PROBES
from emqx_tpu_torch.utils.topic import tokens

_M32 = 0xFFFFFFFF


class MatchResult(NamedTuple):
    matches: torch.Tensor   # [B, match_cap] int32 filter ids, -1 padded
    counts: torch.Tensor    # [B] int32 true match count
    overflow: torch.Tensor  # [B] bool — capacity exceeded (host fallback)


def _mul(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) and a 32-bit constant c, with
    every intermediate below 2^49 (no int64 wraparound)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _mix_hash_t(parent: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """``ops/trie.mix_hash`` on tensors: uint32 carried in int64 masked to
    32 bits. A -1 parent casts to 0xFFFFFFFF as in numpy; the products go
    through the split 16-bit multiply so nothing overflows int64."""
    p = parent.long() & _M32
    w = word.long() & _M32
    h = _mul(p, 0x9E3779B1) ^ _mul(w, 0x85EBCA77)
    h = h ^ (h >> 16)
    h = _mul(h, 0x7FEB352D)
    return h ^ (h >> 15)


def edge_lookup(tables, parent: torch.Tensor, word: torch.Tensor,
                shards: int = 1) -> torch.Tensor:
    """Hash-table edge probe: child node id or -1. Shapes broadcast.

    All MAX_PROBES slots are read at once; the child of the first slot
    that holds (parent, word) wins, as in the reference's unrolled loop.
    With ``shards`` > 1 the tables are that many shards' tables laid end
    to end, node ids offset by shard * N (``flatten_tries``): the key
    hashes with the shard-local parent into that shard's slot range."""
    S = tables.slot_parent.shape[0] // shards
    probes = torch.arange(MAX_PROBES, device=parent.device)
    if shards == 1:
        h = _mix_hash_t(parent, word) & (S - 1)
        idx = (h[..., None] + probes) & (S - 1)             # [..., P]
    else:
        N = tables.plus_child.shape[0] // shards
        safe = parent.clamp(min=0)
        h = _mix_hash_t(safe % N, word) & (S - 1)
        idx = (safe // N * S)[..., None] + ((h[..., None] + probes) & (S - 1))
    hit = ((parent >= 0)[..., None]
           & (tables.slot_parent[idx] == parent[..., None])
           & (tables.slot_word[idx] == word[..., None]))
    first = hit.to(torch.int8).argmax(dim=-1, keepdim=True)
    child = torch.gather(tables.slot_child[idx], -1, first)[..., 0]
    return torch.where(hit.any(dim=-1), child, -1)


def flatten_tries(trie):
    """Stacked per-shard TrieTables ([n, ...] tensors) → one table laid
    end to end: node ids of shard r (children, edge parents) offset by
    r * N, filter ids and words unchanged. ``match_batch(..., shards=n)``
    matches n shards' batches in one pass over it. Cover state is not
    carried: each shard's expansion runs on its own block of the result
    (``parallel/sharded``)."""
    n, N = trie.plus_child.shape
    off = (torch.arange(n, device=trie.plus_child.device) * N)[:, None]

    def nodes(x):
        return torch.where(x >= 0, x + off.to(x.dtype), x).reshape(-1)

    return type(trie)(
        slot_parent=nodes(trie.slot_parent),
        slot_word=trie.slot_word.reshape(-1),
        slot_child=nodes(trie.slot_child), plus_child=nodes(trie.plus_child),
        hash_child=nodes(trie.hash_child),
        node_filter=trie.node_filter.reshape(-1),
        num_nodes=trie.num_nodes, num_edges=trie.num_edges)


def _gather_node(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] with -1 indices yielding -1."""
    safe = idx.clamp(0, arr.shape[0] - 1).long()
    return torch.where(idx >= 0, arr[safe], -1)


def match_batch(tables, topics: torch.Tensor, lens: torch.Tensor,
                is_dollar: torch.Tensor, *, frontier_cap: int = 16,
                match_cap: int = 64, scan=prefix_sum,
                shards: int = 1) -> MatchResult:
    """Match a batch of publish topics against the compiled trie.

    topics: [B, L] int32 interned level ids (PAD beyond lens[b]).
    lens: [B] int32 level counts. is_dollar: [B] bool ('$'-rooted topics).

    Same result as the reference, lane for lane, with two exact
    shortcuts. The frontier stays left-packed (the reference's stable
    sort of ``cand < 0``, done here as a prefix-sum placement through
    ``scan``), so it is kept only as wide as its fullest row — columns
    past that are -1 in every row and emit and expand nothing; one host
    read per level gives the width. When it reaches 0 no later level can
    change anything and the loop stops.

    ``shards`` > 1 matches several shards in one pass: ``tables`` comes
    from ``flatten_tries`` and the batch is ``shards`` equal blocks, block
    r matched against shard r (filter ids stay shard-local).

    With cover state (``tables.cover``, subscription covering) the trie
    held the covering set only, and the row is expanded into the exact
    full-set row (``ops/cover.cover_expand``, through ``scan``), as the
    reference does (:125-131).
    """
    B, L = topics.shape
    F, M = frontier_cap, match_cap
    dev = topics.device
    lens = lens.to(torch.int32)
    root = (torch.arange(B, device=dev, dtype=torch.int32)
            // (B // shards) * (tables.plus_child.shape[0] // shards)) \
        if shards > 1 else 0
    frontier = torch.where(lens > 0, root, -1).to(torch.int32)[:, None]
    # column M is a spill column: emissions past the capacity land there
    # and are sliced away (the reference drops them)
    out = torch.full((B, M + 1), -1, dtype=torch.int32, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    oflow = torch.zeros(B, dtype=torch.bool, device=dev)
    no_skip = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    pad_word = torch.full((B,), PAD, dtype=topics.dtype, device=dev)

    for l in range(L + 1):
        if frontier.shape[1] == 0:
            break
        w = topics[:, l] if l < L else pad_word
        active = frontier >= 0

        # --- emissions at depth l ---
        hc = _gather_node(tables.hash_child, frontier)
        skip_root_wild = is_dollar[:, None] if l == 0 else no_skip
        hash_fid = _gather_node(tables.node_filter, hc)
        hash_emit = active & (hash_fid >= 0) & ~skip_root_wild
        exact_fid = _gather_node(tables.node_filter, frontier)
        exact_emit = active & (exact_fid >= 0) & (lens == l)[:, None]
        emit_fid = torch.cat([hash_fid, exact_fid], dim=1)
        emit_mask = torch.cat([hash_emit, exact_emit], dim=1)

        pos = count[:, None] + scan(emit_mask.to(torch.int32)) - 1
        pos = torch.where(emit_mask, pos, M).clamp(max=M)
        out.scatter_(1, pos.long(), emit_fid)
        count = count + emit_mask.sum(dim=1, dtype=torch.int32)

        # --- frontier expansion with word w ---
        expanding = active & (l < lens)[:, None]
        parent = torch.where(expanding, frontier, -1)
        c_exact = edge_lookup(tables, parent, w[:, None], shards)
        c_plus = torch.where(expanding & ~skip_root_wild,
                             _gather_node(tables.plus_child, frontier), -1)
        cand = torch.cat([c_exact, c_plus], dim=1)           # [B, 2w]
        valid = cand >= 0
        n_valid = valid.sum(dim=1, dtype=torch.int32)
        oflow = oflow | (n_valid > F)
        width = min(F, int(n_valid.max()) if B else 0)
        # valid lanes first, in lane order: lane k goes to its rank among
        # the row's valid lanes; the rest (and ranks past F) spill
        rank = scan(valid.to(torch.int32)) - 1
        slot = torch.where(valid & (rank < width), rank, width)
        nxt = torch.full((B, width + 1), -1, dtype=torch.int32, device=dev)
        nxt.scatter_(1, slot.long(), cand)
        frontier = nxt[:, :width]

    oflow = oflow | (count > M)
    mr = MatchResult(matches=out[:, :M].contiguous(),
                     counts=torch.clamp(count, max=M), overflow=oflow)
    if getattr(tables, "cover", None) is not None:
        from emqx_tpu_torch.ops.cover import cover_expand
        mr = cover_expand(tables.cover, mr, topics, lens, is_dollar,
                          scan=scan)
    return mr


def merge_match_results(base_matches: torch.Tensor, base_counts: torch.Tensor,
                        base_overflow: torch.Tensor, mr: MatchResult,
                        miss_pos: torch.Tensor) -> MatchResult:
    """Scatter a miss sub-batch's fresh MatchResult into cached base rows
    (``emqx_tpu/ops/match.py:137``).

    base_*: [U, ...] per-unique-topic rows (cache hits filled by the
    host, the rest the empty row). mr: the match of the [Bm] compacted
    miss lanes. miss_pos: [Bm] destination row of each miss lane; pad
    lanes carry U, which lands in a sink row past the U rows and is
    sliced away. Indices are read as the reference's ``mode="drop"``
    scatter reads them: a negative index counts from the end (JAX wraps
    it before the bounds check), one out of range after that is dropped.
    Real miss positions are distinct, so the scatter has one writer per
    kept row."""
    U = base_matches.shape[0]
    pos = miss_pos.long()
    pos = torch.where(pos < 0, pos + U, pos)
    pos = torch.where((pos >= 0) & (pos < U), pos, U)

    def put(base, vals):
        out = torch.cat([base, base[:1]])      # row U: the sink
        out.index_copy_(0, pos, vals.to(base.dtype))
        return out[:U]

    return MatchResult(matches=put(base_matches, mr.matches),
                       counts=put(base_counts, mr.counts),
                       overflow=put(base_overflow, mr.overflow))


def encode_topics_str(intern, topics: list, max_levels: int):
    """Encode publish topics from their raw strings: ONE native call for
    the whole batch when the host library and the intern table's mirror
    are there (split, hash and id probe per level in C,
    ``emqx_tpu_torch/native.topic_encode_batch``), else the Python
    per-word path. Same outputs as encode_topics: (ids [B,L], lens [B],
    is_dollar [B], too_long [B])."""
    h = intern.mirror_handle()
    if h is not False:
        from emqx_tpu_torch import native
        out = native.topic_encode_batch(h, topics, max_levels, UNKNOWN, PAD)
        if out is not None:
            return out
    # NOT pre-truncated: encode_topics must see the real level count so
    # deeper-than-L topics get the too_long host-fallback flag (a
    # truncated topic could falsely match a filter on its prefix)
    return encode_topics(intern, [tokens(t) for t in topics], max_levels)


def encode_topics(intern, topic_words: list, max_levels: int):
    """Host helper: list of word-lists → (topics [B,L], lens [B], is_dollar [B],
    too_long [B]) numpy arrays.

    Topics longer than max_levels are truncated and flagged via the returned
    `too_long` mask — the caller must route those to the host fallback. The
    ids of every topic go through one flat list and one scatter.
    """
    B = len(topic_words)
    L = max_levels
    n = np.fromiter(map(len, topic_words), np.int64, B)
    too_long = n > L
    lens = np.minimum(n, L).astype(np.int32)
    dollar = np.fromiter((ws[0][:1] == "$" if ws else False
                          for ws in topic_words), bool, B)
    look = intern.lookup
    ids = [look(w) for ws in topic_words
           for w in (ws if len(ws) <= L else ws[:L])]
    topics = np.full((B, L), PAD, np.int32)
    rows = np.repeat(np.arange(B), lens)
    cols = np.arange(rows.size) - np.repeat(np.cumsum(lens) - lens, lens)
    topics[rows, cols] = ids
    return topics, lens, dollar, too_long
