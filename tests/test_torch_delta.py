"""Port vs JAX reference: the device delta overlay.

- ``build_delta_tables`` / ``empty_delta_tables`` build the reference's
  arrays; ``delta_match``, ``delta_expand`` and ``delta_overlay`` equal
  the reference's planes (match and fan-out capacity overflow included);
  ``np_filter_match`` equals the reference's and ``HostTrie``;
- the eight delta programs (plain, cached, compact and cached + compact,
  on the shape-hash window and on the trie step) equal the JAX programs
  on the same inputs;
- engine level, against the JAX engine: an overlay insert drops exactly
  the cached topics the new filter matches, a delete drops them again,
  and the deliveries agree.

Inputs come from a seed through numpy; comparisons are exact.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.models import router_engine as JR
from emqx_tpu.ops import delta as JD
from emqx_tpu.ops import match as JM
from emqx_tpu.ops.shapes import shape_match as j_shape_match
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.convert import router_tables_from_numpy, tables_from_numpy
from emqx_tpu_torch.models import router_engine as TR
from emqx_tpu_torch.ops import delta as TD
from emqx_tpu_torch.ops import intern as I
from emqx_tpu_torch.ops.shared import STRATEGY_RANDOM, STRATEGY_ROUND_ROBIN
from emqx_tpu_torch.ops.trie import HostTrie
from emqx_tpu_torch.utils import topic as T
from tests.test_torch_cache import (_plan, assert_equal, shape_rows,
                                   shapes_fixture, t_, trie_fixture)
from tests.test_torch_engine import JAX_BROKER

torch.set_num_threads(1)


def overlay_entries(enc, lens, rng, n, fan_max=3):
    """n overlay filters made from encoded topic rows: a level turned
    into '+', a prefix closed by '#', the topic itself, and the root
    wildcards; each with 0..fan_max subscribers."""
    out, seen = [], set()
    rows = [i for i in range(len(lens)) if lens[i] > 0]
    for fid in range(n):
        kind = rng.randrange(5)
        i = rng.choice(rows)
        ws = [int(w) for w in enc[i, :lens[i]]]
        if kind == 0:
            ws[rng.randrange(len(ws))] = I.PLUS
        elif kind == 1:
            ws = ws[:min(rng.randrange(len(ws) + 1),
                         enc.shape[1] - 1)] + [I.HASH]
        elif kind == 3:
            ws = rng.choice([[I.HASH], [I.PLUS] * len(ws), [I.PLUS, I.HASH]])
        key = tuple(ws)
        if key in seen:
            continue
        seen.add(key)
        fan = [(rng.randrange(500), rng.randrange(64))
               for _ in range(rng.randrange(fan_max + 1))]
        out.append((ws, 100 + fid, fan))
    return out


def both_tables(entries, cap, L, fan_per_row=8):
    dt = JD.build_delta_tables(entries, row_cap=cap, level_cap=L,
                               fan_per_row=fan_per_row)
    return JD.DeltaTables(*map(jnp.asarray, dt)), TD.to_device(dt, "cpu")


def test_build_delta_tables_equal_jax():
    r = random.Random(1)
    enc = np.random.RandomState(1).randint(4, 60, (40, 6)).astype(np.int32)
    lens = np.random.RandomState(2).randint(1, 7, 40).astype(np.int32)
    entries = overlay_entries(enc, lens, r, 20)
    for cap in (16, 128):
        want = JD.build_delta_tables(entries[:16], row_cap=cap, level_cap=6)
        got = TD.build_delta_tables(entries[:16], row_cap=cap, level_cap=6)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for g, w in zip(TD.empty_delta_tables(16, 6), JD.empty_delta_tables(16,
                                                                       6)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        TD.build_delta_tables(entries, row_cap=4, level_cap=6)


@pytest.mark.parametrize("caps", [(16, 64), (2, 2), (1, 64)])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_delta_ops_equal_jax(seed, caps):
    match_cap, fan_cap = caps
    rs = np.random.RandomState(seed)
    N, L = 200, 8
    enc = rs.randint(4, 12, (N, L)).astype(np.int32)
    lens = rs.randint(0, L + 1, N).astype(np.int32)
    for i in range(N):
        enc[i, lens[i]:] = I.PAD
    dol = rs.rand(N) < 0.15
    entries = overlay_entries(enc, lens, random.Random(seed), 60)
    jt, tt = both_tables(entries, 128, L)
    args = (enc, lens, dol)
    jmr = JD.delta_match(jt, *map(jnp.asarray, args), match_cap=match_cap)
    tmr = TD.delta_match(tt, *t_(*args), match_cap=match_cap)
    for g, w, name in zip(tmr, jmr, ("matches", "counts", "overflow")):
        assert_equal(g, w, name)
    assert int(tmr.counts.sum()) > 0
    jdp = JD.delta_expand(jt, jmr, fanout_cap=fan_cap)
    tdp = TD.delta_expand(tt, tmr, fanout_cap=fan_cap)
    jov = JD.delta_overlay(jt, *args, match_cap=match_cap,
                           fanout_cap=fan_cap)
    tov = TD.delta_overlay(tt, *t_(*args), match_cap=match_cap,
                           fanout_cap=fan_cap)
    for name in JD.DeltaPlanes._fields:
        assert_equal(getattr(tdp, name), getattr(jdp, name), name)
        assert_equal(getattr(tov, name), getattr(jov, name), name)
    if match_cap == 1:
        assert tmr.overflow.any()


def test_np_filter_match_equals_jax_and_host_trie():
    t = I.InternTable()
    filters = ["a/b", "a/+", "a/#", "#", "+/b", "$sys/+", "a/b/c", "+/#",
               "$sys/#", "a/+/c"]
    host = HostTrie()
    for fid, f in enumerate(filters):
        host.insert(t.encode_filter(T.tokens(f)), fid)
    topics = ["a/b", "a/x", "a", "b", "$sys/n", "a/b/c", "q", "a/q/c",
              "$sys"]
    L = 4
    enc = np.zeros((len(topics), L), np.int32)
    lens = np.zeros(len(topics), np.int32)
    dol = np.zeros(len(topics), bool)
    for i, topic in enumerate(topics):
        ids = t.encode_topic(T.tokens(topic))
        enc[i, :len(ids)] = ids
        lens[i] = len(ids)
        dol[i] = topic.startswith("$")
    for fid, f in enumerate(filters):
        words = t.encode_filter(T.tokens(f))
        got = TD.np_filter_match(words, enc, lens, dol)
        np.testing.assert_array_equal(
            got, JD.np_filter_match(words, enc, lens, dol))
        want = [fid in set(host.match(list(enc[i, :lens[i]]), bool(dol[i])))
                for i in range(len(topics))]
        assert got.tolist() == want, f


# ---- the eight delta programs ----------------------------------------------

DKW = dict(delta_match_cap=4, delta_fanout_cap=8)


def _delta_plan(jt, plan, enc, tl, dol, Bp, rng, hit_frac=0.5):
    """The overlay base rows of a deduplicated window: overlay ROW matches
    of the unique topics, a random subset as cache hits."""
    L = enc.shape[-1]
    encf, lenf, dolf = enc.reshape(-1, L), tl.reshape(-1), dol.reshape(-1)
    from emqx_tpu_torch.broker.device_engine import _topic_keys
    _u, first = np.unique(_topic_keys(encf, lenf, dolf), return_index=True)
    mr = JD.delta_match(jt, encf[first], lenf[first], dolf[first],
                        match_cap=DKW["delta_match_cap"])
    Bu = len(first)
    hit = rng.rand(Bu) < hit_frac
    bdm = np.full((Bp, DKW["delta_match_cap"]), -1, np.int32)
    bdc = np.zeros(Bp, np.int32)
    bdo = np.zeros(Bp, bool)
    bdm[:Bu][hit] = np.asarray(mr.matches)[hit]
    bdc[:Bu][hit] = np.asarray(mr.counts)[hit]
    bdo[:Bu][hit] = np.asarray(mr.overflow)[hit]
    return bdm, bdc, bdo


def _check(got, want, compact):
    if compact:
        for name in TR.CompactPlanes._fields:
            assert_equal(getattr(got.compact, name),
                         getattr(want.compact, name), name)
            assert_equal(getattr(got.d_compact, name),
                         getattr(want.d_compact, name), "d " + name)
        got, want = got.dres, want.dres
    for name in JR.RouteResult._fields:
        assert_equal(getattr(got.res, name), getattr(want.res, name), name)
    for name in JD.DeltaPlanes._fields:
        assert_equal(getattr(got.dp, name), getattr(want.dp, name),
                     "dp " + name)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("strategy", [STRATEGY_ROUND_ROBIN, STRATEGY_RANDOM])
def test_window_delta_programs_equal_jax(strategy, cached, compact):
    tables, cursors, enc, tl, dol, mh = shapes_fixture(7, "underfilled")
    W, B, L = enc.shape
    st = tables.shapes
    entries = overlay_entries(enc.reshape(-1, L), tl.reshape(-1),
                              random.Random(strategy), 12)
    jt, tt = both_tables(entries, 16, L)
    pt = tables_from_numpy(st, tables.subs, "cpu")
    kw = dict(fanout_cap=8, slot_cap=4, **DKW)
    ckw = dict(payload_cap=4096, d_payload_cap=64) if compact else {}
    s = np.int32(strategy)
    if cached:
        width = int(np.asarray(j_shape_match(st, enc[0], tl[0], dol[0])
                               .matches).shape[1])
        plan, _ = _plan(shape_rows(st), enc, tl, dol, B, width, 0.5,
                        np.random.RandomState(3))
        dbase = _delta_plan(jt, plan, enc, tl, dol, B,
                            np.random.RandomState(4))
        args = plan[:6] + dbase + plan[6:] + (mh,)
        jfn = JR.route_window_delta_cached_compact if compact else \
            JR.route_window_delta_cached
        tfn = TR.route_window_delta_cached_compact if compact else \
            TR.route_window_delta_cached
    else:
        args = (enc, tl, dol, mh)
        jfn = JR.route_window_delta_compact if compact else \
            JR.route_window_delta
        tfn = TR.route_window_delta_compact if compact else \
            TR.route_window_delta
    want = jfn(tables, jt, cursors, *args, s, **kw, **ckw)
    got = tfn(pt, tt, *t_(cursors, *args), strategy, **kw, **ckw)
    _check(got, want, compact)
    dp = got.dres.dp if compact else got.dp
    assert int(dp.counts.sum()) > 0


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_step_delta_programs_equal_jax(cached, compact):
    tables, cursors, enc, tl, dol, mh = trie_fixture(11)
    W, B, L = enc.shape
    entries = overlay_entries(enc.reshape(-1, L), tl.reshape(-1),
                              random.Random(5), 12)
    jt, tt = both_tables(entries, 16, L)
    pt = router_tables_from_numpy(tables.trie, tables.subs, "cpu")
    kw = dict(frontier_cap=8, match_cap=16, fanout_cap=8, slot_cap=4, **DKW)
    ckw = dict(payload_cap=512, d_payload_cap=64) if compact else {}
    s = np.int32(STRATEGY_ROUND_ROBIN)
    if cached:
        def rows(e, l, d):
            mr = JM.match_batch(tables.trie, e, l, d, frontier_cap=8,
                                match_cap=16)
            return (np.asarray(mr.matches), np.asarray(mr.counts),
                    np.asarray(mr.overflow))
        plan, _ = _plan(rows, enc, tl, dol, B, 16, 0.5,
                        np.random.RandomState(6))
        dbase = _delta_plan(jt, plan, enc, tl, dol, B,
                            np.random.RandomState(7))
        args = plan[:6] + dbase + (plan[6], plan[7][0], mh[0])
        jfn = JR.route_step_delta_cached_compact if compact else \
            JR.route_step_delta_cached
        tfn = TR.route_step_delta_cached_compact if compact else \
            TR.route_step_delta_cached
    else:
        args = (enc[0], tl[0], dol[0], mh[0])
        jfn = JR.route_step_delta_compact if compact else \
            JR.route_step_delta
        tfn = TR.route_step_delta_compact if compact else TR.route_step_delta
    want = jfn(tables, jt, cursors, *args, s, **kw, **ckw)
    got = tfn(pt, tt, *t_(cursors, *args), STRATEGY_ROUND_ROBIN, **kw, **ckw)
    _check(got, want, compact)


# ---- the engine: delta-aware cache invalidation ---------------------------

class Sink:
    def __init__(self):
        self.got = []

    def deliver(self, topic_filter, msg):
        self.got.append((topic_filter, msg.topic))
        return True


def _nodes():
    on = {"topic_dedup": True, "match_cache_size": 8192,
          "delta_overlay": True}
    return (JNode({"broker": dict(JAX_BROKER, **on)}, use_device=True),
            TNode({"broker": on}, device="cpu"))


def test_overlay_change_drops_only_matching_topics():
    """Mirrors the reference's delta-aware invalidation: a new filter
    drops just the cached topics it matches, its delete drops them again,
    and both engines deliver the same throughout."""
    nodes = _nodes()
    sinks = []
    for node in nodes:
        s = Sink()
        sid = node.broker.register(s, "c")
        for i in range(8):
            node.broker.subscribe(sid, f"dev/{i}/+", {"qos": 0})
        sinks.append(s)
    topics = ["dev/1/t"] * 40 + ["dev/2/t"] * 30 + ["other/x"] * 20

    def route():
        out = [n.device_engine.route_batch([jmake("p", 0, t, b"")
                                            for t in topics])
               for n in nodes]
        assert out[0] == out[1]
        assert sinks[0].got == sinks[1].got
        return out[1]

    route()
    caches = [n.device_engine._match_cache for n in nodes]
    assert len(caches[1]) >= 3
    before = [len(c) for c in caches]
    for node in nodes:
        node.broker.subscribe(0, "dev/1/#", {"qos": 0})    # delta insert
    for c, b in zip(caches, before):
        assert c.delta_invalidated == 1 and len(c) == b - 1
    assert route()[0] == 2                 # the new filter delivers
    n_mid = [len(c) for c in caches]
    for node in nodes:
        node.broker.unsubscribe(0, "dev/1/#")               # delta delete
    assert [len(c) for c in caches] == [n - 1 for n in n_mid]
    assert route()[0] == 1
    tn = nodes[1]
    assert tn.metrics.val("routing.device.host_delta") == 0
    assert tn.metrics.val("routing.device.delta_applies") == 1
    assert tn.device_engine.stats()["overlay"] is None
    # snapshot ids count per process and package: not compared
    ts, js = caches[1].stats(), caches[0].stats()
    ts.pop("snapshot_id")
    js.pop("snapshot_id")
    assert ts == js
