"""Port vs JAX reference: in-window topic dedup and the match cache.

- ``_topic_keys`` and the ``MatchCache`` copy equal the reference's (the
  same keys; the same rows, LRU order, evictions, snapshot and version
  refusals and counters over one random sequence of operations);
- ``merge_match_results`` equals the reference's scatter, including the
  pad lane when every unique row is live (Bu == Bp) and a negative index;
- the four cached programs (``route_window_cached`` dense and compact on
  the shape-hash tables, ``route_step_cached`` and
  ``route_step_cached_compact`` on the trie) equal the JAX programs on the
  same inputs and the plain window on the same window — full,
  under-filled, cap-overflowing, all unique rows live — and thread the
  shared cursors through consecutive windows as the plain window does.

Inputs come from a seed through numpy; comparisons are exact.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.broker import device_engine as JDE
from emqx_tpu.broker.match_cache import MatchCache as JCache
from emqx_tpu.models import router_engine as JR
from emqx_tpu.ops import match as JM
from emqx_tpu.ops.fanout import build_subtable as j_build_subtable
from emqx_tpu.ops.shapes import build_shape_tables as j_build_shapes
from emqx_tpu.ops.shapes import shape_match as j_shape_match
from emqx_tpu.ops.trie import build_tables as j_build_tables
from emqx_tpu_torch.broker import device_engine as TDE
from emqx_tpu_torch.broker.match_cache import DEFAULT_CAPACITY
from emqx_tpu_torch.broker.match_cache import MatchCache as TCache
from emqx_tpu_torch.convert import router_tables_from_numpy, tables_from_numpy
from emqx_tpu_torch.models import router_engine as TR
from emqx_tpu_torch.ops import intern as I
from emqx_tpu_torch.ops import match as TM
from emqx_tpu_torch.ops.shared import (STRATEGY_RANDOM, STRATEGY_ROUND_ROBIN,
                                       STRATEGY_STICKY)
from emqx_tpu_torch.utils import topic as T
from emqx_tpu_torch.workloads import pattern_population
from tests.test_torch_trie import encode
from tests.test_trie_match import rand_filter, rand_topic

torch.set_num_threads(1)


def t_(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def assert_equal(got, want, name=""):
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype, name
    np.testing.assert_array_equal(g, w, name)


# ---- keys and the cache copy ----------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
def test_topic_keys_equal_jax(seed):
    r = np.random.RandomState(seed)
    n, L = 500, 16
    enc = r.randint(0, 1 << 20, (n, L)).astype(np.int32)
    enc[::7] = enc[0]                 # duplicates
    lens = r.randint(0, L + 1, n).astype(np.int32)
    dol = r.rand(n) < 0.2
    got = TDE._topic_keys(enc, lens, dol)
    want = JDE._topic_keys(enc, lens, dol)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert len(np.unique(got)) == len(np.unique(want))


def test_match_cache_equals_jax():
    """One random sequence of every operation on both caches: equal
    returns, rows in LRU order, and stats."""
    assert DEFAULT_CAPACITY == 8192
    r = random.Random(4)
    jc, tc = JCache(20), TCache(20)
    keys = [bytes([k]) * 16 for k in range(40)]

    def row(k, v):
        enc = np.full(4, k % 5, np.int32)
        return (np.full(3, v, np.int32), v, bool(v & 1), None, 0, False,
                enc, k % 4, bool(k % 3 == 0))

    sid = 1
    for c in (jc, tc):
        c.attach(sid)
    for step in range(400):
        op = r.random()
        if op < 0.35:
            items = [(k, row(keys.index(k), step)) for k in
                     r.sample(keys, r.randint(1, 8))]
            ver = r.choice([None, jc.delta_version, jc.delta_version - 1])
            s = r.choice([sid, sid, sid - 1])
            for c in (jc, tc):
                c.put_many(s, items, version=ver)
        elif op < 0.65:
            ks = r.sample(keys, r.randint(1, 10))
            s = r.choice([sid, sid, sid + 1])
            got, want = tc.get_many(s, ks), jc.get_many(s, ks)
            assert [g is None for g in got] == [w is None for w in want]
            for g, w in zip(got, want):
                if w is not None:
                    assert g[1] == w[1]
        elif op < 0.75:
            h, m = r.randint(0, 5), r.randint(0, 5)
            for c in (jc, tc):
                c.count_lookups(h, m)
        elif op < 0.85:
            for c in (jc, tc):
                c.bump_delta_version()
        elif op < 0.95:
            v = r.randint(0, 4)

            def pred(encs, lens, dols):
                return encs[:, 0] == v
            assert tc.drop_where(sid, pred) == jc.drop_where(sid, pred)
        else:
            sid += 1
            for c in (jc, tc):
                c.attach(sid)
        assert list(tc._rows) == list(jc._rows)
        assert tc.stats() == jc.stats()
        assert len(tc) == len(jc)


# ---- merge_match_results ---------------------------------------------------

@pytest.mark.parametrize("case", ["padded", "all_live", "negative"])
def test_merge_match_results_equals_jax(case):
    r = np.random.RandomState(len(case))
    U, M, Bm = 32, 6, 12
    base_m = r.randint(-1, 50, (U, M)).astype(np.int32)
    base_c = r.randint(0, M, U).astype(np.int32)
    base_o = r.rand(U) < 0.3
    mr_np = (r.randint(-1, 50, (Bm, M)).astype(np.int32),
             r.randint(0, M, Bm).astype(np.int32), r.rand(Bm) < 0.3)
    pos = np.full(Bm, U, np.int32)           # pad = U, out of range
    if case == "padded":
        pos[:7] = r.choice(U, 7, replace=False)
    elif case == "all_live":
        # every unique row live: the miss lanes fill the tail rows, row
        # U-1 included, and the pads must not land on it
        pos[:5] = np.arange(U - 5, U)
    else:
        pos[:4] = [3, 9, -1, -3]             # negative: counted from the end
        pos[4:6] = [U + 5, 1 << 20]
    want = JM.merge_match_results(
        *map(jnp.asarray, (base_m, base_c, base_o)),
        JM.MatchResult(*map(jnp.asarray, mr_np)), jnp.asarray(pos))
    got = TM.merge_match_results(*t_(base_m, base_c, base_o),
                                 TM.MatchResult(*t_(*mr_np)), *t_(pos))
    for g, w, name in zip(got, want, ("matches", "counts", "overflow")):
        assert_equal(g, w, name)
    if case == "all_live":
        assert_equal(got.matches[U - 1], mr_np[0][4], "row U-1")


# ---- the cached programs ---------------------------------------------------

def _plan(match_rows, enc, tl, dol, Bp, width, hit_frac, rng):
    """A deduplicated window's inputs from its [W, B] lanes: unique
    topics (pads share one sentinel), a random hit subset whose base rows
    are the plain match's, the misses compacted into [Bm] lanes."""
    W, B, L = enc.shape
    encf, lenf, dolf = enc.reshape(-1, L), tl.reshape(-1), dol.reshape(-1)
    keys = TDE._topic_keys(encf, lenf, dolf)
    _u, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    Bu = len(first)
    assert Bu <= Bp
    m, c, o = match_rows(encf[first], lenf[first], dolf[first])
    hit = rng.rand(Bu) < hit_frac
    base_m = np.full((Bp, width), -1, np.int32)
    base_c = np.zeros(Bp, np.int32)
    base_o = np.zeros(Bp, bool)
    base_m[:Bu][hit], base_c[:Bu][hit], base_o[:Bu][hit] = \
        m[hit], c[hit], o[hit]
    miss = np.flatnonzero(~hit)
    Bm = len(miss) + 3
    mt = np.full((Bm, L), I.PAD, np.int32)
    ml = np.zeros(Bm, np.int32)
    md = np.zeros(Bm, bool)
    pos = np.full(Bm, Bp, np.int32)
    src = first[miss]
    mt[:len(miss)], ml[:len(miss)], md[:len(miss)] = \
        encf[src], lenf[src], dolf[src]
    pos[:len(miss)] = miss
    return (mt, ml, md, base_m, base_c, base_o, pos,
            inv.reshape(W, B).astype(np.int32)), Bu


def shapes_fixture(seed, case, W=3, B=32, fs_frac=0.4):
    """JAX-built shape tables over the six-pattern population, subscribers
    and shared groups, and a [W, B] window drawn from a few topics."""
    rng = np.random.default_rng(seed)
    _i, words, flens, t, tl, dol = pattern_population(rng, 200, 400)
    F = len(flens)
    r = np.random.RandomState(seed)
    normal = {f: [(int(r.randint(900)), int(r.randint(64)))
                  for _ in range(r.randint(0, 4))] for f in range(F)}
    G = 9
    fslots = {f: sorted(r.choice(G, r.randint(1, 3), replace=False).tolist())
              for f in range(F) if r.rand() < fs_frac}
    shared = {g: [(2000 + 8 * g + j, int(r.randint(64)))
                  for j in range(r.randint(0, 5))] for g in range(G)}
    tables = JR.ShapeRouterTables(
        shapes=j_build_shapes(words, flens),
        subs=j_build_subtable(F, normal, fslots, shared, slot_cap=G))
    n_topics = B - 1 if case == "all_live" else 12
    distinct = np.unique(TDE._topic_keys(t, tl, dol), return_index=True)[1]
    distinct = distinct[tl[distinct] > 0]
    pick = r.choice(distinct, n_topics, replace=False)
    if case == "all_live":
        # every lane a distinct topic but one pad lane per row
        lanes = np.tile(np.append(pick, pick[0]), W)
    else:
        lanes = r.choice(pick, W * B)
    enc = t[lanes].reshape(W, B, -1)
    lens = tl[lanes].reshape(W, B).copy()
    dl = dol[lanes].reshape(W, B)
    if case == "underfilled":
        lens[2, 10:] = 0
    if case == "all_live":
        lens[:, -1] = 0
    mh = r.randint(0, 1 << 31, (W, B)).astype(np.int32)
    cursors = r.randint(0, 7, G).astype(np.int32)
    return tables, cursors, enc, lens, dl, mh


def shape_rows(st):
    def rows(enc, lens, dol):
        mr = j_shape_match(st, enc, lens, dol)
        return (np.asarray(mr.matches), np.asarray(mr.counts),
                np.asarray(mr.overflow))
    return rows


CASES = {
    # name: (fanout_cap, slot_cap, payload_cap)
    "full": (8, 4, 4096),
    "underfilled": (8, 4, 4096),
    "cap_overflow": (1, 1, 4096),
    "all_live": (8, 4, 4096),
    "row_overflow": (8, 4, 16),
}


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("strategy", [STRATEGY_ROUND_ROBIN, STRATEGY_RANDOM,
                                      STRATEGY_STICKY])
@pytest.mark.parametrize("case", sorted(CASES))
def test_route_window_cached_equals_jax(case, strategy, compact):
    fan, slot, pcap = CASES[case]
    tables, cursors, enc, tl, dol, mh = shapes_fixture(len(case), case)
    W, B = tl.shape
    st = tables.shapes
    width = int(np.asarray(j_shape_match(st, enc[0], tl[0], dol[0])
                           .matches).shape[1])
    plan, Bu = _plan(shape_rows(st), enc, tl, dol, B, width, 0.5,
                     np.random.RandomState(1))
    if case == "all_live":
        assert Bu == B
    kw = dict(fanout_cap=fan, slot_cap=slot)
    s = np.int32(strategy)
    if compact:
        want = JR.route_window_cached_compact(tables, cursors, *plan, mh, s,
                                              payload_cap=pcap, **kw)
        want_res, want_cp = want.res, want.compact
    else:
        want_res = JR.route_window_cached(tables, cursors, *plan, mh, s,
                                          **kw)
    pt = tables_from_numpy(st, tables.subs, "cpu")
    fn = TR.route_window_cached_compact if compact else \
        TR.route_window_cached
    ckw = dict(payload_cap=pcap) if compact else {}
    got = fn(pt, *t_(cursors, *plan, mh), strategy, **kw, **ckw)
    for name in JR.RouteResult._fields:
        assert_equal(getattr(got.res, name), getattr(want_res, name), name)
    plain = TR.route_window(pt, *t_(cursors, enc, tl, dol, mh), strategy,
                            payload_cap=pcap if compact else None, **kw)
    for name in JR.RouteResult._fields:
        assert torch.equal(getattr(got.res, name), getattr(plain.res, name))
    if compact:
        for name in TR.CompactPlanes._fields:
            assert_equal(getattr(got.compact, name), getattr(want_cp, name),
                         name)
            assert torch.equal(getattr(got.compact, name),
                               getattr(plain.compact, name))
        assert bool(got.compact.row_overflow.any()) == \
            (case == "row_overflow")
    else:
        assert got.compact is None
    if case == "cap_overflow":
        assert got.res.overflow.any()


def trie_fixture(seed, B=96):
    rng = random.Random(seed)
    filters = sorted({rand_filter(rng) for _ in range(120)}
                     | {"sport/#", "$sys/#", "#", "+/+", "a/+", "a/b"})
    intern, words, lens = encode(filters, 8)
    hot = [rand_topic(rng) for _ in range(14)] + ["sport", "$sys/a", "a/b"]
    topics = [rng.choice(hot) for _ in range(B)]
    enc, tl, dol, _ = TM.encode_topics(intern, [T.tokens(t) for t in topics],
                                       8)
    tl[:5] = 0
    r = np.random.RandomState(seed)
    Fn = len(filters)
    normal = {f: [(int(r.randint(500)), int(r.randint(64)))
                  for _ in range(r.randint(0, 3))] for f in range(Fn)}
    G = 5
    fslots = {f: [int(r.randint(G))] for f in range(Fn) if r.rand() < 0.3}
    shared = {g: [(900 + 4 * g + j, 1) for j in range(g % 3 + 1)]
              for g in range(G)}
    tables = JR.RouterTables(trie=j_build_tables(words, lens),
                             subs=j_build_subtable(Fn, normal, fslots,
                                                   shared, slot_cap=G))
    mh = r.randint(0, 1 << 30, (1, B)).astype(np.int32)
    cursors = r.randint(0, 5, G).astype(np.int32)
    return tables, cursors, enc[None], tl[None], dol[None], mh


@pytest.mark.parametrize("caps", [(8, 16, 8, 4), (2, 3, 1, 1)])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("strategy", [STRATEGY_ROUND_ROBIN, STRATEGY_RANDOM])
def test_route_step_cached_equals_jax(strategy, compact, caps):
    F, M, fan, slot = caps
    tables, cursors, enc, tl, dol, mh = trie_fixture(3 + F)
    B = tl.shape[1]

    def rows(e, l, d):
        mr = JM.match_batch(tables.trie, e, l, d, frontier_cap=F,
                            match_cap=M)
        return (np.asarray(mr.matches), np.asarray(mr.counts),
                np.asarray(mr.overflow))

    plan, _Bu = _plan(rows, enc, tl, dol, B, M, 0.5,
                      np.random.RandomState(2))
    plan = plan[:-1] + (plan[-1][0],)           # inv [B] for a step
    kw = dict(frontier_cap=F, match_cap=M, fanout_cap=fan, slot_cap=slot)
    s = np.int32(strategy)
    pt = router_tables_from_numpy(tables.trie, tables.subs, "cpu")
    if compact:
        want = JR.route_step_cached_compact(tables, cursors, *plan, mh[0],
                                            s, payload_cap=512, **kw)
        got = TR.route_step_cached_compact(pt, *t_(cursors, *plan, mh[0]),
                                           strategy, payload_cap=512, **kw)
        for name in TR.CompactPlanes._fields:
            assert_equal(getattr(got.compact, name),
                         getattr(want.compact, name), name)
        want_res, got_res = want.res, got.res
    else:
        want_res = JR.route_step_cached(tables, cursors, *plan, mh[0], s,
                                        **kw)
        got_res = TR.route_step_cached(pt, *t_(cursors, *plan, mh[0]),
                                       strategy, **kw)
    for name in JR.RouteResult._fields:
        assert_equal(getattr(got_res, name), getattr(want_res, name), name)
    plain = TR.route_step(pt, *t_(cursors, enc[0], tl[0], dol[0], mh[0]),
                          strategy, **kw)
    for name in JR.RouteResult._fields:
        g = getattr(got_res, name)
        assert torch.equal(g[0] if compact else g, getattr(plain, name))


def test_cached_window_threads_shared_cursors():
    """Three consecutive windows, round robin: the cached window's cursors
    and occurrences equal the plain window's window after window, fully
    cached from the second window on."""
    tables, cursors, enc, tl, dol, mh = shapes_fixture(5, "full",
                                                       fs_frac=1.0)
    st = tables.shapes
    pt = tables_from_numpy(st, tables.subs, "cpu")
    W, B = tl.shape
    width = int(np.asarray(j_shape_match(st, enc[0], tl[0], dol[0])
                           .matches).shape[1])
    cur_c = cur_p = torch.from_numpy(cursors)
    for k in range(3):
        plan, _ = _plan(shape_rows(st), enc, tl, dol, B, width,
                        0.0 if k == 0 else 1.0, np.random.RandomState(k))
        got = TR.route_window_cached(pt, cur_c, *t_(*plan, mh),
                                     STRATEGY_ROUND_ROBIN, fanout_cap=8,
                                     slot_cap=4)
        plain = TR.route_window(pt, cur_p, *t_(enc, tl, dol, mh),
                                STRATEGY_ROUND_ROBIN, fanout_cap=8,
                                slot_cap=4)
        for name in ("new_cursors", "occur", "shared_rows", "rows"):
            assert torch.equal(getattr(got.res, name),
                               getattr(plain.res, name))
        cur_c = got.res.new_cursors[-1]
        cur_p = plain.res.new_cursors[-1]
    assert int(plain.res.occur.sum()) > 0
