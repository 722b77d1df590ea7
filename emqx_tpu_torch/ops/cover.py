"""Subscription covering: match the covering set, expand at fan-out.

Counterpart of ``emqx_tpu/ops/cover.py``: ``CoverTables`` (:77),
``covers_pair`` (:124), ``trie_order_keys`` (:158), ``shape_order_keys``
(:179), ``full_shape_count`` (:199), ``detect_covers`` (:210),
``assign_owners`` (:276), ``build_cover_tables`` (:302), ``rank_base``
(:384), ``_verify_rows`` (:394), ``cover_expand`` (:433) and
``host_covering_roots`` (:513).

Most real subscription populations are cover-heavy: ``fleet/#`` matches
every topic ``fleet/+/temp`` does. The match tables are built over the
COVERING set only (the filters nothing else covers, the roots), and a
per-root expansion CSR re-expands each matched root into the filters it
owns right after the match stage. Every candidate is verified against
the topic with the linear level-wise matcher, and the expanded row is
sorted by a per-filter order key that reproduces the full-set backend's
emission order, so the expanded row equals the covering-off row, values
and order.

- A covers B iff every topic matching B matches A (emqx_topic.erl
  match/2): a trailing ``#`` covers any suffix, ``+`` covers a literal or
  ``+`` at its level but never a trailing ``#``, a literal covers only
  itself, and a root wildcard covers no ``$``-rooted filter.
- Detection matches each filter as a pseudo-topic (trailing ``#``
  dropped, ``+`` riding as the PLUS word id, a ``$`` root as is_dollar)
  against the trie of the whole set, through the port's NFA
  (``ops/match.match_batch``) on the engine's device, batch by batch.
- Order keys: for the trie, ``((step*2 + is_exact) << 24) | plus_bits``;
  for the shape tables, the shape's ``sig_small``. Both are densified
  to ranks at build so the final ordering is one int32 sort of
  ``(rank << lane_bits) | lane`` keys.

The host functions are numpy and give the reference's arrays; the
per-filter Python loops of the reference are vectorized where the
outputs stay equal (``assign_owners`` keeps the sequential walk for the
case where some root reaches its budget). ``cover_expand`` is plain
PyTorch: its gather goes through ``ops/fanout._segment_expand``, which
scans with kernel 2 on the card; the two sorts are ``torch.sort`` and
``torch.argsort(stable=True)``, as the reference's are ``jnp.sort`` and
``jnp.argsort``.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from emqx_tpu_torch.ops.fanout import _segment_expand, take
from emqx_tpu_torch.ops.intern import HASH, PAD, PLUS
from emqx_tpu_torch.ops.match import MatchResult
from emqx_tpu_torch.ops.scan import prefix_sum

# order-key packing: plus-choice bits in the low MAX_KEY_LEVELS bits,
# (step*2 + class) above; filters deeper than this disable covering for
# the snapshot (always correct: covering only removes match work)
MAX_KEY_LEVELS = 24

_KEY_INVALID = np.int32(0x7FFFFFFF)


class CoverTables(NamedTuple):
    """Expansion state of one snapshot (numpy after ``build_cover_tables``,
    tensors after ``convert.cover_from_numpy``).

    exp_start/exp_fid/exp_slot: per-fid expansion CSR. A root's segment
      is [itself] + its covered filters; covered fids have empty
      segments. exp_slot is the verify row, -1 = pre-verified (the
      root's own entry: the base match proved it).
    vwords/vlens: the covered filters' interned levels, for the
      per-candidate linear verification.
    order_key: per-fid emission order rank (dense; _KEY_INVALID pad).
    out_pad: [M_out] zeros carrying the expanded row width.
    cand_pad: [C] zeros carrying the candidate capacity; a topic whose
      matched roots own more than C candidates flags overflow.
    app_*: the append region (cover-set churn): a new filter covered by
      a built root. app_root is the owning root's fid (-1 = empty row),
      app_fid the new filter's fid, app_key its rank (after every built
      filter's), app_words/app_lens its levels.
    """

    exp_start: object   # [Fc+1]
    exp_fid: object     # [E]
    exp_slot: object    # [E]
    vwords: object      # [V, L]
    vlens: object       # [V]
    order_key: object   # [Fc]
    out_pad: object     # [M_out]
    cand_pad: object    # [C]
    app_root: object    # [A]
    app_fid: object     # [A]
    app_key: object     # [A]
    app_words: object   # [A, L]
    app_lens: object    # [A]


APPEND_FIELDS = ("app_root", "app_fid", "app_key", "app_words", "app_lens")


# ---- pairwise predicate (the oracle) ---------------------------------------

def covers_pair(wa: list, wb: list, b_dollar: bool = False) -> bool:
    """True iff filter A (interned words `wa`) covers filter B — every
    topic matching B matches A. True for identical filters (callers
    exclude self by fid). `b_dollar`: B's root level is a ``$`` literal."""
    la, lb = len(wa), len(wb)
    if la == 0 or lb == 0:
        return False
    a_hash = wa[-1] == HASH
    b_hash = wb[-1] == HASH
    pa = la - (1 if a_hash else 0)
    if a_hash:
        if pa > lb - (1 if b_hash else 0):
            return False
    elif b_hash or la != lb:
        # without a trailing '#', A matches exactly-la-level topics
        return False
    if b_dollar and wa[0] in (PLUS, HASH):
        return False            # root wildcards never match '$'-topics
    for lvl in range(pa):
        aw, bw = wa[lvl], wb[lvl]
        if aw != PLUS and aw != bw:
            return False        # a literal covers only the same literal
    return True


# ---- order keys --------------------------------------------------------------

def _tail_hash(words: np.ndarray, lens: np.ndarray) -> np.ndarray:
    ar = np.arange(len(lens))
    return words[ar, np.maximum(lens - 1, 0)] == HASH


def _plus_bits(words: np.ndarray, plen: np.ndarray) -> np.ndarray:
    bits = np.zeros(len(plen), np.int64)
    for lvl in range(min(words.shape[1], int(plen.max(initial=0)))):
        bits |= ((words[:, lvl] == PLUS)
                 & (lvl < plen)).astype(np.int64) << lvl
    return bits


def trie_order_keys(words: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per-filter emission order key of ``ops/match.match_batch``.
    Requires every filter at most MAX_KEY_LEVELS deep."""
    words = np.asarray(words, np.int32)
    lens = np.asarray(lens, np.int64)
    if len(lens) == 0:
        return np.zeros(0, np.int32)
    has_hash = _tail_hash(words, lens)
    plen = lens - has_hash
    bits = _plus_bits(words, plen)
    step = np.where(has_hash, plen, lens)
    cls = (~has_hash).astype(np.int64)
    key = ((step * 2 + cls) << MAX_KEY_LEVELS) | bits
    return key.astype(np.int32)


def shape_order_keys(words: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per-filter ``sig_small``: the shape tables assign shape ids in
    ascending sig_small, whatever subset they are built over."""
    words = np.asarray(words, np.int32)
    lens = np.asarray(lens, np.int64)
    if len(lens) == 0:
        return np.zeros(0, np.int32)
    has_hash = _tail_hash(words, lens).astype(np.int64)
    slen = lens - has_hash
    sig = _plus_bits(words, slen) | (slen << 20) | (has_hash << 25)
    return sig.astype(np.int32)


def full_shape_count(words: np.ndarray, lens: np.ndarray) -> int:
    """Distinct shapes of a filter set (what sets the covering-off
    twin's match-row width)."""
    if len(lens) == 0:
        return 0
    return len(np.unique(shape_order_keys(words, lens)))


# ---- detection ---------------------------------------------------------------

class CoverSets:
    """Per-filter covering fids, self excluded, as a CSR (indptr [F+1],
    fids): ``covers[i]`` is filter i's array in the matcher's emission
    order, as the reference's list of arrays holds it."""

    __slots__ = ("indptr", "fids")

    def __init__(self, indptr: np.ndarray, fids: np.ndarray):
        self.indptr = indptr
        self.fids = fids

    @classmethod
    def from_list(cls, covers: list) -> "CoverSets":
        n = np.fromiter((len(c) for c in covers), np.int64, len(covers))
        indptr = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
        fids = np.concatenate([np.asarray(c, np.int64) for c in covers]) \
            if len(covers) else np.zeros(0, np.int64)
        return cls(indptr, fids.astype(np.int64))

    def __len__(self) -> int:
        return len(self.indptr) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.fids[self.indptr[i]:self.indptr[i + 1]]

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def detect_covers(words: np.ndarray, lens: np.ndarray, dollar: np.ndarray,
                  *, batch: int = 2048, match_cap: int = 128,
                  frontier_cap: int = 32, device="cpu", lock=None):
    """Find, per filter, the OTHER filters covering it.

    Each filter becomes a pseudo-topic matched against the trie of the
    whole set on `device`, `batch` lanes a dispatch (``lock``, when
    given, is held around each batch's device work only).

    Returns (covers, incomplete): ``covers`` a ``CoverSets``, and
    ``incomplete`` the filters whose match overflowed a capacity — those
    stay uncovered (kept as roots; always correct)."""
    from emqx_tpu_torch.convert import trie_from_numpy
    from emqx_tpu_torch.ops.match import match_batch
    from emqx_tpu_torch.ops.trie import build_tables

    words = np.asarray(words, np.int32)
    lens = np.asarray(lens, np.int64)
    dollar = np.asarray(dollar, bool)
    F = len(lens)
    incomplete = np.zeros(F, bool)
    if F == 0:
        return CoverSets(np.zeros(1, np.int64), np.zeros(0, np.int64)), \
            incomplete

    L = words.shape[1]
    has_hash = _tail_hash(words, lens)
    plen = (lens - has_hash).astype(np.int32)
    pseudo = words.copy()
    pseudo[has_hash, np.maximum(lens[has_hash] - 1, 0)] = PAD

    host = build_tables(words, lens)
    ctx = lock if lock is not None else contextlib.nullcontext()
    with ctx:
        tables = trie_from_numpy(host, device)
    counts = np.zeros(F, np.int64)
    parts = []
    for lo in range(0, F, batch):
        hi = min(F, lo + batch)
        B = hi - lo
        t = np.full((batch, L), PAD, np.int32)
        t[:B] = pseudo[lo:hi]
        ln = np.zeros(batch, np.int32)
        ln[:B] = plen[lo:hi]
        dl = np.zeros(batch, bool)
        dl[:B] = dollar[lo:hi]
        with ctx:
            mr = match_batch(tables, torch.from_numpy(t).to(device),
                             torch.from_numpy(ln).to(device),
                             torch.from_numpy(dl).to(device),
                             frontier_cap=frontier_cap, match_cap=match_cap)
            m = mr.matches[:B].cpu().numpy().astype(np.int64)
            ov = mr.overflow[:B].cpu().numpy()
        fid = np.arange(lo, hi)
        keep = (m >= 0) & (m != fid[:, None]) & ~ov[:, None]
        # a '#'-filter is only covered by '#'-filters: its pseudo-topic
        # also surfaces exact matches of its prefix
        keep &= ~has_hash[fid][:, None] | has_hash[np.maximum(m, 0)]
        incomplete[lo:hi] = ov
        counts[lo:hi] = keep.sum(1)
        parts.append(m[keep])
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return CoverSets(indptr, np.concatenate(parts)), incomplete


def assign_owners(covers, incomplete: np.ndarray, *,
                  own_budget: int = 256) -> np.ndarray:
    """One covering ROOT per covered filter → owner[fid] (-1 = stays in
    the covering set). Roots are filters nothing covers (or whose
    detection overflowed); a covered filter's owner is its smallest-fid
    covering root with fewer than `own_budget` owned filters, walked in
    fid order. When no root's first-choice count passes the budget the
    walk is one vectorized pass; otherwise it runs filter by filter."""
    cs = covers if isinstance(covers, CoverSets) \
        else CoverSets.from_list(covers)
    F = len(cs)
    n = np.diff(cs.indptr)
    is_root = (n == 0) | np.asarray(incomplete, bool)
    owner = np.full(F, -1, np.int64)
    if F == 0:
        return owner
    row = np.repeat(np.arange(F), n)
    cand = is_root[cs.fids] & ~is_root[row]
    big = np.int64(F)
    first = np.full(F, big)
    np.minimum.at(first, row[cand], cs.fids[cand])
    has = first < big
    if not has.any():
        return owner
    if np.bincount(first[has], minlength=F).max() <= own_budget:
        owner[has] = first[has]
        return owner
    owned = np.zeros(F, np.int64)
    for fid in np.flatnonzero(~is_root).tolist():
        for a in sorted(cs[fid].tolist()):
            if is_root[a] and owned[a] < own_budget:
                owner[fid] = a
                owned[a] += 1
                break
    return owner


# ---- table builder -----------------------------------------------------------

def build_cover_tables(words: np.ndarray, lens: np.ndarray,
                       owner: np.ndarray, order_key: np.ndarray, *,
                       fid_cap: int, out_width: int, cand_cap: int,
                       verify_cap: Optional[int] = None,
                       append_cap: int = 64) -> CoverTables:
    """Compile owner assignments into CoverTables (numpy). Every filter
    sits in exactly one expansion segment: a root carries itself then
    its owned filters in fid order."""
    words = np.asarray(words, np.int32)
    lens = np.asarray(lens, np.int64)
    owner = np.asarray(owner, np.int64)
    order_key = np.asarray(order_key, np.int32)
    F = len(lens)
    L = max(1, words.shape[1] if words.ndim == 2 else 1)
    covered = np.flatnonzero(owner >= 0)
    V = max(1, verify_cap or _next_pow2(max(1, len(covered))))
    if len(covered) > V:
        raise ValueError(f"{len(covered)} covered filters > verify "
                         f"capacity {V}")
    E = max(1, fid_cap)

    # dense ranks: order-preserving, so the expansion sort packs them
    # with the lane into one int32 key
    uniq = np.unique(order_key)
    order_key = np.searchsorted(uniq, order_key).astype(np.int32)

    exp_start = np.zeros(fid_cap + 1, np.int32)
    exp_fid = np.full(E, -1, np.int32)
    exp_slot = np.full(E, -1, np.int32)
    vwords = np.full((V, L), PAD, np.int32)
    vlens = np.zeros(V, np.int32)
    key_pad = np.full(fid_cap, _KEY_INVALID, np.int32)
    key_pad[:F] = order_key

    nc = len(covered)
    if nc:
        cw = words[covered, :L] if words.ndim == 2 else \
            np.zeros((nc, L), np.int32)
        vwords[:nc] = np.where(np.arange(L)[None, :] < lens[covered, None],
                               cw, PAD)
        vlens[:nc] = lens[covered]

    # segment order: by (root, self before owned, fid); a covered filter
    # rides its owner's segment
    fid = np.arange(F)
    seg_root = np.where(owner >= 0, owner, fid)
    order = np.lexsort((fid, owner >= 0, seg_root))
    n_ent = len(order)
    exp_fid[:n_ent] = order
    slot_of = np.full(F, -1, np.int64)
    slot_of[covered] = np.arange(nc)
    exp_slot[:n_ent] = slot_of[order]
    seg_len = np.bincount(seg_root, minlength=F)[:F] if F else \
        np.zeros(0, np.int64)
    seg_len = np.where(owner >= 0, 0, seg_len)
    exp_start[:F] = np.cumsum(seg_len) - seg_len
    exp_start[F:] = n_ent

    A = max(1, append_cap)
    return CoverTables(
        exp_start=exp_start, exp_fid=exp_fid, exp_slot=exp_slot,
        vwords=vwords, vlens=vlens, order_key=key_pad,
        out_pad=np.zeros(max(1, out_width), np.int32),
        cand_pad=np.zeros(max(1, cand_cap), np.int32),
        app_root=np.full(A, -1, np.int32),
        app_fid=np.full(A, -1, np.int32),
        app_key=np.zeros(A, np.int32),
        app_words=np.full((A, L), PAD, np.int32),
        app_lens=np.zeros(A, np.int32))


def _next_pow2(x: int) -> int:
    return 1 << max(2, (x - 1).bit_length())


def rank_base(ct: CoverTables) -> int:
    """First free order rank for the append path: built filters hold
    ranks 0..rank_base-1, so appended filters sort after all of them."""
    valid = ct.order_key[ct.order_key != _KEY_INVALID]
    return int(valid.max()) + 1 if valid.size else 0


# ---- the expansion stage (torch) ---------------------------------------------

# host-known constants of a snapshot's immutable cover planes, keyed by
# the tensor's id and dropped when it dies: the deepest verify row
# ("depth", of vlens: levels past it verify every row, so the level loop
# stops there) and the longest expansion segment ("seg", of exp_start:
# no lane has more candidates than its matched roots times it). Noted at
# upload from the host build (no device read); otherwise read once.
_HOST: dict = {}


def note_host(t: torch.Tensor, key: str, value: int) -> None:
    if id(t) not in _HOST:
        weakref.finalize(t, _HOST.pop, id(t), None)
        _HOST[id(t)] = {}
    _HOST[id(t)][key] = int(value)


def host_facts(ct) -> dict:
    """The host constants of numpy CoverTables `ct`, as ``note_host``
    takes them."""
    vlens = np.asarray(ct.vlens)
    starts = np.asarray(ct.exp_start)
    return {"depth": int(vlens.max()) if vlens.size else 0,
            "seg": int(np.diff(starts).max()) if starts.size > 1 else 0}


def _host(t: torch.Tensor, key: str, read) -> int:
    v = _HOST.get(id(t), {}).get(key)
    if v is None:
        v = read(t) if t.numel() else 0
        note_host(t, key, v)
    return v


def identity_rows(ct: CoverTables) -> bool:
    """True when `ct` covers nothing and holds no append entry: every
    segment is its root alone. Behind the trie NFA, which emits a row in
    ``trie_order_keys`` order, the expansion of such tables is the base
    row itself (matches, counts and overflow), so a caller may skip it.
    Read once per tensor (a mesh shard's tables change only by a new
    upload)."""
    return _host(ct.exp_slot, "covered", lambda t: int((t >= 0).sum())) \
        == 0 and _host(ct.app_root, "appended",
                       lambda t: int((t >= 0).sum())) == 0


def _verify_rows(vwords, vlens, sel, topics, lens, is_dollar,
                 depth: Optional[int] = None):
    """Linear wildcard verification: out[b, c] = filter row sel[b, c]
    matches topic b (sel -1 = pre-verified, True). The reference's
    semantics: per level exact-or-'+', the trailing-'#' prefix rule,
    root-'$' exclusion, empty rows match nothing. Computed level by
    level over [B, C] planes (no [B, C, Lv] row gather), which keeps a
    whole window's verify to a few [B, C] planes; with `depth` (no row
    deeper) the loop stops there — the later levels hold for every row."""
    L = topics.shape[1]
    V, Lv = vwords.shape
    Lc = min(L, Lv)
    lens = lens.to(torch.int32)
    safe = sel.clamp(0, V - 1)

    def at(idx):                # vwords.view(-1)[idx], idx [B, C]
        return take(vwords.reshape(-1), idx)

    base = safe * Lv if V * Lv < (1 << 31) else safe.long() * Lv
    fl = torch.where(sel >= 0, take(vlens, safe), 0)     # [B, C]
    last = at(base + (fl - 1).clamp(0, Lv - 1))
    last_hash = (fl > 0) & (last == HASH)
    plen = fl - last_hash.to(fl.dtype)
    ok = plen <= Lc
    for lvl in range(Lc if depth is None else min(Lc, depth)):
        head = at(base + lvl)
        ok &= ((head == topics[:, lvl:lvl + 1]) | (head == PLUS)
               | (plen <= lvl))
    len_ok = torch.where(last_hash, lens[:, None] >= plen,
                         lens[:, None] == fl)
    first = at(base)
    dskip = is_dollar.bool()[:, None] & ((first == PLUS) | (first == HASH))
    res = ok & len_ok & ~dskip & (fl > 0) & (lens > 0)[:, None]
    return torch.where(sel >= 0, res, True)


def cover_expand(ct: CoverTables, mr: MatchResult, topics, lens, is_dollar,
                 scan=prefix_sum) -> MatchResult:
    """Expand matched roots into the exact full-set MatchResult: the CSR
    gather of each matched root's candidates (through ``scan``), their
    verification against the topic, the append region, and the sort by
    order rank, so the row equals the covering-off twin's, values and
    order. Overflow = base overflow | candidate overflow | a true count
    past the output width (where the off twin flags it too)."""
    M = ct.out_pad.shape[0]
    C = ct.cand_pad.shape[0]
    A = ct.app_root.shape[0]
    B = mr.matches.shape[0]
    dev = mr.matches.device

    # candidate columns past the matched roots times the longest segment
    # are empty in every lane: expand only that many (at most C); the
    # capacity check still compares the true total with C
    seg = _host(ct.exp_start, "seg",
                lambda t: int((t[1:] - t[:-1]).max()))
    Cw = min(C, mr.matches.shape[1] * max(1, seg))
    fids, idx, total, _ = _segment_expand(
        ct.exp_start, ct.exp_fid, mr.matches, Cw, scan)
    cand_oflow = total > C
    slots = torch.where(idx >= 0, take(ct.exp_slot, idx), -1)
    keys = torch.where(fids >= 0, take(ct.order_key, fids),
                       int(_KEY_INVALID))
    ok = _verify_rows(ct.vwords, ct.vlens, slots, topics, lens, is_dollar,
                      depth=_host(ct.vlens, "depth",
                                  lambda t: int(t.max())))
    valid = (fids >= 0) & ok

    # append region: entry a rides lane b when its root is in b's row
    # (its rows change in place with each append: no depth bound)
    live = ct.app_root >= 0
    m = mr.matches
    hit = ((m[:, :, None] == ct.app_root[None, None, :])
           & (m >= 0)[:, :, None]).any(dim=1)                   # [B, A]
    app_sel = torch.arange(A, dtype=torch.int32, device=dev).expand(B, A)
    app_ok = _verify_rows(ct.app_words, ct.app_lens, app_sel, topics, lens,
                          is_dollar)
    app_valid = hit & app_ok & live[None, :]

    cand_fid = torch.cat([fids, ct.app_fid[None, :].expand(B, A)], dim=1)
    cand_key = torch.cat([keys, ct.app_key[None, :].expand(B, A)], dim=1)
    cand_valid = torch.cat([valid, app_valid], dim=1)

    # final ordering: dense ranks pack with the lane into one int32 key,
    # so one sort of unique keys gives the stable order (the bit budget,
    # and with it the branch, is the reference's, of C + A lanes)
    C_tot = C + A
    lane_bits = max(1, (C_tot - 1).bit_length())
    Fc = ct.order_key.shape[0]
    rank_bits = max(2, (Fc + A + 1).bit_length())
    if lane_bits + rank_bits <= 31:
        invalid = (1 << rank_bits) - 1
        lane = torch.arange(Cw + A, dtype=torch.int32, device=dev)
        sk = torch.where(cand_valid, cand_key.clamp(max=invalid), invalid)
        packed = torch.sort((sk << lane_bits) | lane, dim=1).values[:, :M]
        s_ok = (packed >> lane_bits) < invalid
        lanes = packed & ((1 << lane_bits) - 1)
        s_fid = torch.gather(cand_fid, 1, lanes.long())
    else:   # bit budget exceeded (a huge shard): the stable argsort
        sort_key = torch.where(cand_valid, cand_key, int(_KEY_INVALID))
        order = torch.argsort(sort_key, dim=1, stable=True)[:, :M]
        s_fid = torch.gather(cand_fid, 1, order)
        s_ok = torch.gather(cand_valid, 1, order)
    out = torch.where(s_ok, s_fid, -1)
    width = min(M, C_tot)       # the row the reference's C + A lanes give
    if out.shape[1] < width:
        out = torch.nn.functional.pad(out, (0, width - out.shape[1]),
                                      value=-1)
    count = cand_valid.sum(dim=1, dtype=torch.int32)
    overflow = mr.overflow | cand_oflow | (count > M)
    return MatchResult(matches=out, counts=count.clamp(max=M),
                       overflow=overflow)


# ---- host-side cover lookup (the append path) --------------------------------

def host_covering_roots(root_trie, root_words: dict, words: list,
                        b_dollar: bool) -> list:
    """Built ROOTS covering a new filter, by the same pseudo-topic walk
    over a HostTrie of the roots; candidates are post-checked with
    ``covers_pair``. [] means the new filter takes the overlay path."""
    words = list(words)
    b_hash = len(words) > 0 and words[-1] == HASH
    pseudo = words[:-1] if b_hash else words
    out = []
    for f in root_trie.match(list(pseudo), is_dollar=b_dollar):
        wa = root_words.get(f)
        if wa is None or list(wa) == words:
            continue
        if covers_pair(list(wa), words, b_dollar):
            out.append(f)
    return out
