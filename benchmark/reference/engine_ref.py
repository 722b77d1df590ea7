"""The route window's delivery plans, plain, and their comparison.

For every topic of a window (W steps of B topics, step-major, in order of
arrival) the plan is: every filter that matches it (``GridIndex``), every
subscriber row of each with its packed options, and one member of each
shared slot of each, picked round robin: the k-th occurrence of slot s in
step w takes member ``(cursor[s] + k) % size``, and the cursors advance by
each step's occurrences before the next step. A topic whose subscriber
rows exceed ``fanout_cap`` or whose slots exceed ``slot_cap`` is flagged
as overflowing (the program completes it on the host).

``Plans`` holds a window's plans as flat families, each entry tagged with
its topic: the matched filters, the (row, options) pairs and the (slot,
row, options) picks. ``from_readback`` reads the program's window
readback into the same form (its CSR rows, or the dense planes of a step
whose CSR row overflowed); ``compare`` lists the topics whose plans
differ, order within a family aside.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Plans(NamedTuple):
    counts: np.ndarray      # [T, 3] matches, subscriber rows, shared slots
    overflow: np.ndarray    # [T] bool
    fids: tuple             # (topic, fid)
    rows: tuple             # (topic, row, opts)
    picks: tuple            # (topic, slot, row, opts)


def segments(starts, counts):
    """Flat positions of the segments [start, start + count) in order,
    and each position's segment number."""
    counts = np.asarray(counts, np.int64)
    owner = np.repeat(np.arange(len(counts)), counts)
    first = np.cumsum(counts) - counts
    pos = np.repeat(np.asarray(starts, np.int64), counts) \
        + np.arange(int(counts.sum())) - np.repeat(first, counts)
    return pos, owner


def run_ranks(keys: np.ndarray) -> np.ndarray:
    """Each entry's number of earlier entries with the same key."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    new = np.ones(len(k), bool)
    new[1:] = k[1:] != k[:-1]
    starts = np.flatnonzero(new)
    runs = np.diff(np.append(starts, len(k)))
    ranks = np.empty(len(k), np.int64)
    ranks[order] = np.arange(len(k)) - np.repeat(starts, runs)
    return ranks


def expected(matched, W: int, B: int, st: dict, cursors: np.ndarray,
             fanout_cap: int, slot_cap: int):
    """(Plans, cursors after the window) of one window: ``matched`` its
    topics' matching filters (``GridIndex.match_many``), ``st`` the
    subscriber table's arrays, ``cursors`` [G] before the window."""
    T = W * B
    cm, fids = matched
    m_owner = np.repeat(np.arange(T), cm)
    s0 = st["sub_start"][fids]
    pos, own = segments(s0, st["sub_start"][fids + 1] - s0)
    r_owner = m_owner[own]
    rows = st["sub_row"][pos].astype(np.int64)
    opts = st["sub_opts"][pos].astype(np.int64)
    f0 = st["fs_start"][fids]
    pos, own = segments(f0, st["fs_start"][fids + 1] - f0)
    s_owner = m_owner[own]
    slots = st["fs_slot"][pos].astype(np.int64)
    cf = np.bincount(r_owner, minlength=T)
    cs = np.bincount(s_owner, minlength=T)
    overflow = (cf > fanout_cap) | (cs > slot_cap)
    # a topic holds at most slot_cap slots on the device
    keep = run_ranks(s_owner) < slot_cap
    s_owner, slots = s_owner[keep], slots[keep]
    cur = np.asarray(cursors, np.int64).copy()
    ss = st["shared_start"].astype(np.int64)
    p_row = np.empty(len(slots), np.int64)
    p_opt = np.empty(len(slots), np.int64)
    step = s_owner // B
    for w in range(W):
        sel = np.flatnonzero(step == w)
        sl = slots[sel]
        lo, size = ss[sl], ss[sl + 1] - ss[sl]
        member = np.where(size > 0,
                          (cur[sl] + run_ranks(sl)) % np.maximum(size, 1), 0)
        at = lo + member
        p_row[sel] = np.where(size > 0, st["shared_row"][
            np.minimum(at, len(st["shared_row"]) - 1)], -1)
        p_opt[sel] = np.where(size > 0, st["shared_opts"][
            np.minimum(at, len(st["shared_opts"]) - 1)], 0)
        cur += np.bincount(sl, minlength=len(cur))
    counts = np.stack([cm, cf, np.minimum(cs, slot_cap)], 1)
    return Plans(counts, overflow, (m_owner, fids), (r_owner, rows, opts),
                 (s_owner, slots, p_row, p_opt)), cur


def from_readback(rb, B: int) -> Plans:
    """The program's window readback (offsets [W, B+1], counts3 [W, B,
    3], payload [W, P], row_overflow [W], overflow [W, B], dense planes
    or None) as Plans. Entries a count points past the payload read as
    -2."""
    W = rb.overflow.shape[0]
    fam = {k: [] for k in ("f", "r", "p")}
    counts = np.asarray(rb.counts3, np.int64).reshape(W, B, 3).copy()
    for w in range(W):
        base = w * B
        if rb.row_overflow[w]:
            m, r, o, fc, sid, sr, so = (np.asarray(x[w]) for x in rb.dense)
            ok = m >= 0
            counts[w, :, 0] = ok.sum(1)
            own = np.nonzero(ok)[0]
            fam["f"].append((base + own, m[ok].astype(np.int64)))
            cf = np.minimum(fc.astype(np.int64), r.shape[1])
            ok = np.arange(r.shape[1])[None, :] < cf[:, None]
            counts[w, :, 1] = cf
            own = np.nonzero(ok)[0]
            fam["r"].append((base + own, r[ok].astype(np.int64),
                             o[ok].astype(np.int64)))
            ok = sid >= 0
            counts[w, :, 2] = ok.sum(1)
            own = np.nonzero(ok)[0]
            fam["p"].append((base + own, sid[ok].astype(np.int64),
                             sr[ok].astype(np.int64),
                             so[ok].astype(np.int64)))
            continue
        pay = np.asarray(rb.payload[w], np.int64)
        c = np.clip(counts[w], 0, 1 << 16)
        o = np.asarray(rb.offsets[w][:B], np.int64)

        def take(start, n):
            pos, own = segments(start, n)
            ok = (pos >= 0) & (pos < len(pay))
            return base + own, np.where(ok, pay[np.clip(
                pos, 0, max(len(pay) - 1, 0))] if len(pay) else -2, -2)

        cm, cf, cs = c[:, 0], c[:, 1], c[:, 2]
        fam["f"].append(take(o, cm))
        own, rows = take(o + cm, cf)
        fam["r"].append((own, rows, take(o + cm + cf, cf)[1]))
        s0 = o + cm + 2 * cf
        own, slots = take(s0, cs)
        fam["p"].append((own, slots, take(s0 + cs, cs)[1],
                         take(s0 + 2 * cs, cs)[1]))

    def cat(parts, n):
        if not parts:
            return tuple(np.zeros(0, np.int64) for _ in range(n))
        return tuple(np.concatenate([p[k] for p in parts]) for k in range(n))

    return Plans(counts.reshape(W * B, 3),
                 np.asarray(rb.overflow, bool).reshape(-1),
                 cat(fam["f"], 2), cat(fam["r"], 3), cat(fam["p"], 4))


def _sorted(fam: tuple, keep: np.ndarray) -> np.ndarray:
    sel = keep[fam[0]]
    cols = [c[sel] for c in fam]
    order = np.lexsort(cols[::-1])
    return np.stack([c[order] for c in cols], 1)


def compare(want: Plans, got: Plans, offsets=None, W: int = 0,
            B: int = 0, row_overflow=None) -> np.ndarray:
    """The topics whose plans differ: the overflow flag; for a topic that
    fits, its counts, its CSR offset (``offsets`` [W, B+1], steps read
    from CSR) and every entry of each family, order within a topic
    aside."""
    bad = want.overflow != got.overflow
    fits = ~want.overflow & ~got.overflow
    bad |= fits & (want.counts != got.counts).any(1)
    if offsets is not None:
        size = want.counts @ np.array([1, 2, 3])
        for w in range(W):
            if row_overflow[w] or want.overflow[w * B:(w + 1) * B].any():
                continue
            s = size[w * B:(w + 1) * B]
            exp = np.concatenate([[0], np.cumsum(s)])
            got_o = np.asarray(offsets[w], np.int64)
            diff = got_o != exp
            bad[w * B:(w + 1) * B] |= diff[:B]
            if diff[B]:
                bad[(w + 1) * B - 1] = True
    keep = fits & ~bad
    for a, b in ((want.fids, got.fids), (want.rows, got.rows),
                 (want.picks, got.picks)):
        x, y = _sorted(a, keep), _sorted(b, keep)
        if x.shape != y.shape:
            # equal counts give equal lengths; a malformed readback may not
            owners = np.union1d(x[:, 0], y[:, 0]) if len(x) or len(y) \
                else np.zeros(0, np.int64)
            bad[owners] = True
            continue
        diff = (x != y).any(1)
        bad[x[diff, 0]] = True
        bad[y[diff, 0]] = True
    return np.flatnonzero(bad)
