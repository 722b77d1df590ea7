"""Shape-directed wildcard matching: the fast route path.

Counterpart of ``emqx_tpu/ops/shapes.py``. A wildcard filter is its
*shape* (which levels are '+', whether it ends in '#', how many concrete
levels) plus its concrete words. Filters live in one two-choice bucketed
hash table keyed by (shape, concrete-word path hash); matching a topic
costs, per candidate shape, a uint32 hash fold over the topic's levels
plus at most two bucket-row reads.

- ``build_shape_tables``: the host-side table build, numpy only,
  bit-identical to the reference's arrays.
- ``fold_ref`` / ``probe_ref``: the plain PyTorch fold and probe
  (counterparts of ``_fold_xla`` and ``_probe_buckets``).
- ``shape_match``: launches the fused fold+probe CUDA kernel
  (``ops/fold.py``) for a CUDA tensor, runs the plain path for a CPU one.
  Both it and ``shape_match_ref`` re-expand the covering set into the
  full-set row when the tables carry cover state (``ops/cover.py``), as
  the reference's ``_cover_expand_maybe`` (:538) does.

uint32 arithmetic: torch implements only ``mul``, ``xor`` and ``and`` for
``torch.uint32`` on the CPU (``add`` and ``>>`` raise), so the plain path
carries hashes in int64 masked to 32 bits, and every product is a
variable times a 32-bit constant split into 16-bit halves so no
intermediate passes 2^49 (``_mul``). Hash planes leave as int32 bit
patterns, as the reference's int32 casts do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from emqx_tpu_torch.ops.fold import launch_shape_match
from emqx_tpu_torch.ops.intern import HASH, PLUS
from emqx_tpu_torch.ops.match import MatchResult, _mul
from emqx_tpu_torch.ops.scan import prefix_sum, prefix_sum_ref

BK = 8                  # filter entries per bucket (one row read wide)
DEFAULT_SHAPE_CAP = 32  # max distinct shapes per table

_U = np.uint32
_M32 = 0xFFFFFFFF


# --- host (numpy) uint32 helpers: identical to the reference's build --

def _fold(h, w, l: int):
    """One hash-fold step on numpy uint32."""
    h = h ^ (w * _U(0x85EBCA77) + _U((l * 0x9E3779B1) & 0xFFFFFFFF))
    h = h * _U(0xC2B2AE35)
    return h ^ (h >> _U(15))


def _fin(h):
    h = h ^ (h >> _U(16))
    h = h * _U(0x7FEB352D)
    return h ^ (h >> _U(13))


def _seed(shape_id, c1: int, c2: int):
    return _fin(shape_id.astype("uint32") * _U(c1) + _U(c2))


class ShapeTables(NamedTuple):
    """Compiled shape-partitioned filter store (int32 planes; numpy after
    ``build_shape_tables``, torch tensors after ``convert.tables_from_numpy``).

    shape_plus_mask: [NS] bit l set = level l is '+'.
    shape_len: [NS] concrete level count (excluding trailing '#'); -1 = pad.
    shape_has_hash: [NS] 1 if the shape ends in '#'.
    shape_wild_root: [NS] 1 if level 0 is '+' or the shape is bare '#'
      (excluded for '$'-rooted topics, emqx_topic.erl:66-69).
    buckets: [NB, 3*BK] rows of h1[BK] | h2[BK] | fid[BK], fid -1 = empty.
      Every filter lives in one of its two home buckets, so a lookup reads
      at most two rows.
    cover: ``ops.cover.CoverTables`` when the buckets hold the covering
      set only (subscription covering), else None.
    """

    shape_plus_mask: object
    shape_len: object
    shape_has_hash: object
    shape_wild_root: object
    buckets: object
    n_shapes: object
    n_filters: object
    cover: Optional[NamedTuple] = None


class ShapeCapacityError(ValueError):
    """Filter set has more distinct shapes than the table capacity."""


def _next_pow2(x: int) -> int:
    return 1 << max(2, (x - 1).bit_length())


def _homes_host(h1: np.ndarray, h2: np.ndarray, nb: int):
    """Two home buckets per item, in-place uint32 arithmetic (host build)."""
    out = []
    for a, b, c in ((h1, h2, 0x9E3779B1), (h2, h1, 0x85EBCA77)):
        x = b * _U(c)
        x ^= a
        tmp = x >> _U(16)
        x ^= tmp
        x *= _U(0x7FEB352D)
        np.right_shift(x, _U(13), out=tmp)
        x ^= tmp
        x &= _U(nb - 1)
        out.append(x)
    return out[0], out[1]


def _place(home1: np.ndarray, home2: np.ndarray, nb: int):
    """Assign each item a (bucket, rank<BK) among its two homes, vectorized.

    Sort-free scatter race: each round, every pending item claims one of
    its 2*BK candidate positions with a last-writer-wins scatter and a
    re-gather finds the winner; a sequential cuckoo-eviction pass seats
    the tiny tail. Round 0 (empty table) claims (b1, slot h2&7) directly.
    Returns (bucket, rank, leftover) — leftover is empty on success.
    """
    F = len(home1)
    h1_32 = np.ascontiguousarray(home1).view(np.int32) \
        if home1.dtype == np.uint32 else home1.astype(np.int32)
    h2_32 = np.ascontiguousarray(home2).view(np.int32) \
        if home2.dtype == np.uint32 else home2.astype(np.int32)
    pos_tab = np.full(nb * BK, -1, np.int32)
    cand = (h1_32 << 3) | (h2_32 & (BK - 1))
    pending = np.arange(F, dtype=np.int32)
    pos_tab[cand] = pending              # all slots empty: claim directly
    lost = pos_tab[cand] != pending
    pending = pending[lost]
    p1 = h1_32[lost]
    p2 = h2_32[lost]
    pref = p1 * 0x9E37 + p2 * 0x85EB     # per-item probe-order seed
    for r in range(1, 2 * BK):           # one round per candidate position
        if len(pending) == 0:
            break
        k = (pref + r) & (2 * BK - 1)
        choice = np.where(k & 1 == 0, p1, p2)
        cand = choice * BK + (k >> 1)
        free = pos_tab[cand] == -1
        cf, pf = cand[free], pending[free]
        pos_tab[cf] = pf
        lost = np.ones(len(pending), bool)
        lost[np.flatnonzero(free)[pos_tab[cf] == pf]] = False
        pending = pending[lost]
        p1, p2, pref = p1[lost], p2[lost], pref[lost]
    combined = np.full(F, -1, np.int32)
    filled = np.flatnonzero(pos_tab >= 0).astype(np.int32)
    combined[pos_tab[filled]] = filled
    placed = combined >= 0
    bucket = np.where(placed, combined >> 3, -1)
    rank = np.where(placed, combined & 7, -1)
    if len(pending) == 0:
        return bucket, rank, pending
    return _place_evict(bucket, rank, pending, home1, home2,
                        pos_tab.reshape(nb, BK))


_MAX_KICKS = 500


def _place_evict(bucket, rank, pending, home1, home2, slots):
    """Cuckoo random-walk eviction for items whose candidate slots all lost.
    Deterministic: the victim slot rotates with the walk step."""
    still = []
    for it in pending:
        cur = int(it)
        b = int(home1[cur])
        for step in range(_MAX_KICKS):
            row = slots[b]
            free = np.flatnonzero(row == -1)
            if len(free):
                r = int(free[0])
                slots[b, r] = cur
                bucket[cur], rank[cur] = b, r
                cur = -1
                break
            v_slot = (cur + step) % BK
            victim = int(slots[b, v_slot])
            slots[b, v_slot] = cur
            bucket[cur], rank[cur] = b, v_slot
            cur = victim
            b = int(home1[cur]) if b == home2[cur] else int(home2[cur])
        if cur >= 0:
            bucket[cur], rank[cur] = -1, -1
            still.append(cur)
    return bucket, rank, np.array(still, np.int64)


def _fold_into(h: np.ndarray, w: np.ndarray, l: int,
               tmp: np.ndarray) -> None:
    """In-place _fold (host only): identical uint32 arithmetic."""
    np.multiply(w, _U(0x85EBCA77), out=tmp)
    tmp += _U((l * 0x9E3779B1) & 0xFFFFFFFF)
    h ^= tmp
    h *= _U(0xC2B2AE35)
    np.right_shift(h, _U(15), out=tmp)
    h ^= tmp


def _path_hashes(wordsT: np.ndarray, slen, plus_mask, seeds1, seeds2):
    """Fold concrete-word hashes over levels. wordsT [L, N] (each level a
    contiguous row); others [N]. Levels where no item is concrete are
    skipped, all-concrete levels fold in place, mixed levels fold a copy
    and merge masked."""
    h1 = np.asarray(seeds1).astype(np.uint32, copy=True)
    h2 = np.asarray(seeds2).astype(np.uint32, copy=True)
    N = len(h1)
    L = wordsT.shape[0] if wordsT.ndim == 2 else 0
    L = min(L, int(np.max(slen, initial=0)))
    tmp = np.empty(N, np.uint32)
    for l in range(L):
        concrete = (l < slen) & ((plus_mask >> l) & 1 == 0)
        n_conc = int(np.count_nonzero(concrete))
        if n_conc == 0:
            continue
        w = wordsT[l].view(np.uint32)
        if n_conc == N:
            _fold_into(h1, w, 2 * l, tmp)
            _fold_into(h2, w, 2 * l + 1, tmp)
        else:
            for h, ll in ((h1, 2 * l), (h2, 2 * l + 1)):
                folded = h.copy()
                _fold_into(folded, w, ll, tmp)
                np.copyto(h, folded, where=concrete)
    return h1, h2


def build_shape_tables(words: np.ndarray, lens: np.ndarray,
                       filter_ids: Optional[np.ndarray] = None,
                       shape_cap: int = DEFAULT_SHAPE_CAP,
                       bucket_capacity: Optional[int] = None) -> ShapeTables:
    """Compile a deduplicated filter set into ShapeTables (host, numpy).

    words: [F, L] interned level ids (PAD beyond lens); lens: [F] (>=1).
    Raises ShapeCapacityError when distinct shapes exceed shape_cap.
    """
    words = np.asarray(words, np.int32)
    lens = np.asarray(lens, np.int64)
    F = len(lens)
    if filter_ids is None:
        filter_ids = np.arange(F)
    filter_ids = np.asarray(filter_ids, np.int64)

    if F == 0:
        NSc = 1
        return ShapeTables(
            shape_plus_mask=np.zeros(NSc, np.int32),
            shape_len=np.full(NSc, -1, np.int32),
            shape_has_hash=np.zeros(NSc, np.int32),
            shape_wild_root=np.zeros(NSc, np.int32),
            buckets=np.concatenate([np.zeros((16, 2 * BK), np.int32),
                                    np.full((16, BK), -1, np.int32)], axis=1),
            n_shapes=np.int32(0), n_filters=np.int32(0))

    L = words.shape[1]
    if L > 20:
        raise ValueError("shape tables support at most 20 levels")
    lens32 = lens.astype(np.int32)
    arangeF = np.arange(F, dtype=np.int32)
    has_hash = (words[arangeF, lens32 - 1] == HASH).astype(np.int32)
    slen = lens32 - has_hash
    Lmax = min(L, int(slen.max(initial=0)))
    wordsT = np.ascontiguousarray(words[:, :Lmax].T)
    plus_mask = np.zeros(F, np.int32)
    for l in range(Lmax):
        plus_mask |= ((wordsT[l] == PLUS)
                      & (l < slen)).astype(np.int32) << l

    # O(F) factorize via a 26-bit lookup table (plus_mask < 2^20, slen
    # 5 bits, has_hash 1 bit); flatnonzero keeps sorted-unique order, so
    # shape ids equal np.unique's
    sig_small = plus_mask | (slen << 20) | (has_hash << 25)
    seen = np.zeros(1 << 26, bool)
    seen[sig_small] = True
    uniq_small = np.flatnonzero(seen).astype(np.int64)
    NS = len(uniq_small)
    if NS > shape_cap:
        raise ShapeCapacityError(f"{NS} shapes > cap {shape_cap}")
    lut_dtype = np.int8 if NS <= 127 else np.int32
    lut = np.zeros(1 << 26, lut_dtype)
    lut[uniq_small] = np.arange(NS, dtype=lut_dtype)
    inv = lut[sig_small]
    del seen, lut
    uniq = ((uniq_small & 0xFFFFF) | (((uniq_small >> 20) & 0x1F) << 24)
            | ((uniq_small >> 25) << 60))
    # pad the shape axis to the next pow2 of the actual count
    NSc = 1 << max(0, (NS - 1).bit_length())

    shape_plus_mask = np.zeros(NSc, np.int32)
    shape_len = np.full(NSc, -1, np.int32)
    shape_has_hash = np.zeros(NSc, np.int32)
    shape_plus_mask[:NS] = (uniq & 0xFFFFFF).astype(np.int32)
    shape_len[:NS] = ((uniq >> 24) & 0xFFFFFFFF).astype(np.int32)
    shape_has_hash[:NS] = (uniq >> 60).astype(np.int32)
    shape_wild_root = (((shape_plus_mask & 1) == 1)
                       | ((shape_has_hash == 1) & (shape_len == 0))
                       ).astype(np.int32)
    shape_wild_root[shape_len < 0] = 0

    sid_u = np.arange(NS, dtype=np.int64)
    s1 = _seed(sid_u, 0x27D4EB2F, 0x165667B1)[inv]
    s2 = _seed(sid_u, 0x85EBCA6B, 0xC2B2AE3D)[inv]
    h1, h2 = _path_hashes(wordsT, slen, plus_mask, s1, s2)

    # pre-size to ~0.7 load: two-choice placement seats everything there
    NB = bucket_capacity or _next_pow2(max(16, -(-F * 10 // (BK * 7))))
    while True:
        b1, b2 = _homes_host(h1, h2, NB)
        bucket, rank, leftover = _place(b1, b2, NB)
        if len(leftover) == 0:
            break
        if bucket_capacity is not None:
            err = ShapeCapacityError(
                f"bucket_capacity={bucket_capacity} overflows ("
                f"{len(leftover)} filters unplaceable); rebuild with "
                f"bucket_capacity={2 * NB}")
            err.needed_capacity = 2 * NB
            raise err
        NB *= 2
        if NB > 1 << 28:
            raise MemoryError("shape bucket table too large")

    buckets = np.zeros((NB, 3 * BK), np.int32)
    buckets[:, 2 * BK:] = -1
    flat = buckets.reshape(-1)
    base = bucket * (3 * BK) + rank      # NB*3*BK < 2^31: int32 safe
    flat[base] = h1.view(np.int32)       # uint32 bit-reinterpret
    flat[base + BK] = h2.view(np.int32)
    flat[base + 2 * BK] = filter_ids.astype(np.int32)

    return ShapeTables(
        shape_plus_mask=shape_plus_mask, shape_len=shape_len,
        shape_has_hash=shape_has_hash, shape_wild_root=shape_wild_root,
        buckets=buckets, n_shapes=np.int32(NS), n_filters=np.int32(F))


# --- plain PyTorch path: uint32 carried in int64 masked to 32 bits -------

def _fold_t(h, w, l: int):
    h = h ^ ((_mul(w, 0x85EBCA77) + ((l * 0x9E3779B1) & _M32)) & _M32)
    h = _mul(h, 0xC2B2AE35)
    return h ^ (h >> 15)


def _fin_t(h):
    h = h ^ (h >> 16)
    h = _mul(h, 0x7FEB352D)
    return h ^ (h >> 13)


def _homes_t(h1, h2, nb: int):
    b1 = _fin_t(h1 ^ _mul(h2, 0x9E3779B1)) & (nb - 1)
    b2 = _fin_t(h2 ^ _mul(h1, 0x85EBCA77)) & (nb - 1)
    return b1, b2


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """[0, 2^32) int64 -> the same 32 bits as int32."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def fold_ref(st: ShapeTables, topics: torch.Tensor, lens: torch.Tensor,
             is_dollar: torch.Tensor):
    """Per-level hash fold + homes + compatibility (counterpart of
    ``_fold_xla``) -> (h1, h2, b1, b2, compat), each [B, NSc] int32."""
    B, L = topics.shape
    NSc = st.shape_plus_mask.shape[0]
    NB = st.buckets.shape[0]
    sid = torch.arange(NSc, dtype=torch.int64, device=topics.device)[None]
    h1 = _fin_t((_mul(sid, 0x27D4EB2F) + 0x165667B1) & _M32).expand(B, NSc)
    h2 = _fin_t((_mul(sid, 0x85EBCA6B) + 0xC2B2AE3D) & _M32).expand(B, NSc)
    slen = st.shape_len.long()[None]
    pmask = st.shape_plus_mask.long()[None]
    words = topics.long() & _M32
    for l in range(L):
        concrete = (l < slen) & (((pmask >> l) & 1) == 0)
        w = words[:, l:l + 1]
        h1 = torch.where(concrete, _fold_t(h1, w, 2 * l), h1)
        h2 = torch.where(concrete, _fold_t(h2, w, 2 * l + 1), h2)

    lens_ = lens.long()[:, None]
    compat = torch.where(st.shape_has_hash[None] == 1,
                         lens_ >= slen, lens_ == slen)
    compat &= slen >= 0
    compat &= ~(is_dollar.bool()[:, None] & (st.shape_wild_root[None] == 1))
    compat &= lens_ > 0  # batch-padding rows match nothing
    b1, b2 = _homes_t(h1, h2, NB)
    return (_as_i32(h1), _as_i32(h2), _as_i32(b1), _as_i32(b2),
            compat.to(torch.int32))


def probe_ref(st: ShapeTables, h1, h2, b1, b2, compat) -> MatchResult:
    """Two bucket row-gathers + hash compare (counterpart of
    ``_probe_buckets``): the lowest slot whose h1, h2 match with fid >= 0,
    b1's row before b2's."""
    B = h1.shape[0]
    h1i = h1[..., None]
    h2i = h2[..., None]
    ok = compat.bool()[..., None]

    def probe(home):
        rows = st.buckets[home.long()]           # [B, NSc, 3*BK] gather
        hit = ((rows[..., :BK] == h1i) & (rows[..., BK:2 * BK] == h2i)
               & (rows[..., 2 * BK:] >= 0) & ok)
        idx = torch.argmax(hit.to(torch.int32), dim=-1, keepdim=True)
        fid = torch.gather(rows[..., 2 * BK:], -1, idx)[..., 0]
        return hit.any(-1), fid

    hit1, fid1 = probe(b1)
    hit2, fid2 = probe(b2)
    matches = torch.where(hit1, fid1, torch.where(hit2, fid2, -1))
    counts = (matches >= 0).sum(-1, dtype=torch.int32)
    return MatchResult(matches=matches, counts=counts,
                       overflow=torch.zeros(B, dtype=torch.bool,
                                            device=h1.device))


def _cover_expand_maybe(st: ShapeTables, mr: MatchResult, topics, lens,
                        is_dollar, scan) -> MatchResult:
    """With cover state the buckets held the covering set only: expand
    the matched roots into the exact full-set row (``ops/cover``)."""
    if st.cover is None:
        return mr
    from emqx_tpu_torch.ops.cover import cover_expand
    return cover_expand(st.cover, mr, topics, lens, is_dollar, scan=scan)


def shape_match_ref(st: ShapeTables, topics, lens, is_dollar) -> MatchResult:
    """The plain version of ``shape_match``: the plain fold and probe, and
    with cover state the expansion with the plain scan."""
    mr = probe_ref(st, *fold_ref(st, topics, lens, is_dollar))
    return _cover_expand_maybe(st, mr, topics, lens, is_dollar,
                               prefix_sum_ref)


def shape_match(st: ShapeTables, topics: torch.Tensor, lens: torch.Tensor,
                is_dollar: torch.Tensor) -> MatchResult:
    """Match a topic batch against all shapes (counterpart of
    ``emqx_tpu.ops.shapes.shape_match``).

    topics [B, L] int32, lens [B] int32, is_dollar [B] bool. Returns
    matches [B, NSc] (each shape contributes at most one filter id, -1
    otherwise), counts [B], overflow all False — or, with cover state,
    the expanded full-set row. A CUDA batch launches the fused fold+probe
    kernel (and kernel 2 in the expansion); a CPU batch runs the plain
    path.
    """
    if topics.device.type == "cpu":
        return shape_match_ref(st, topics, lens, is_dollar)
    matches, counts = launch_shape_match(st, topics, lens, is_dollar)
    mr = MatchResult(matches=matches, counts=counts,
                     overflow=torch.zeros(topics.shape[0], dtype=torch.bool,
                                          device=topics.device))
    return _cover_expand_maybe(st, mr, topics, lens, is_dollar, prefix_sum)
