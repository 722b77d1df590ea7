"""Port vs JAX reference: subscription covering (``ops/cover.py``, the
engine's covering snapshot and append path, and the mesh's per-shard
cover tables).

The same numpy inputs, made from seeded populations, go through the
reference's function and its counterpart in the port. Every output here
is an integer or boolean plane, a list of fids, a delivery list or a
counter, so every comparison is exact (tolerance 0):

- ``covers_pair`` against brute-force topic enumeration and the
  reference's predicate;
- ``detect_covers`` against the exhaustive pairwise search and the
  reference (cover sets in emission order, detection overflow);
- ``assign_owners`` with its budget (the vectorized pass and the
  filter-by-filter walk), both order-key families, ``full_shape_count``,
  ``build_cover_tables`` and ``rank_base`` array for array;
- ``cover_expand`` behind the trie NFA and the shape tables on the same
  tables and topics, both sort branches, with append entries and
  candidate overflow;
- the engine twin: the port's ``Node(device="cpu")`` with covering on
  against the JAX ``Node(..., use_device=True)`` with covering on — the
  same delivery lists, per-session order, counts and ``stats()["cover"]``
  on a shapes, a mixed (off twin trie, on twin shapes over the roots)
  and a trie population, through a covered-filter unsubscribe, the
  append path, cache invalidation over the expanded set and the
  "covering" compaction after 64 rejected appends; the off twin carries
  no cover state;
- the mesh: the sharded step on stacked per-shard cover tables against
  the reference's step, and ``ShardedRouteEngine`` with covering on
  against a JAX Node serving through ``ShardedRouteServer`` with covering
  on (per-session delivery order), on the 8 virtual CPU devices;
- ``workloads.cover_heavy_filters`` / ``concretize`` against
  ``tools/workloads.py``.
"""

import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.models.router_engine import RouterTables as JRT
from emqx_tpu.ops import cover as JC
from emqx_tpu.ops import intern as JI
from emqx_tpu.ops.fanout import build_subtable as j_build_subtable
from emqx_tpu.ops.match import match_batch as j_match_batch
from emqx_tpu.ops.shapes import build_shape_tables as j_build_shapes
from emqx_tpu.ops.shapes import shape_match as j_shape_match
from emqx_tpu.ops.trie import HostTrie as JHostTrie
from emqx_tpu.ops.trie import build_tables as j_build_tables
from emqx_tpu.parallel import mesh as JMESH
from emqx_tpu.parallel import sharded as JS
from emqx_tpu_torch import workloads as TW
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.convert import (cover_from_numpy, stacked_from_numpy,
                                    tables_from_numpy, trie_from_numpy)
from emqx_tpu_torch.ops import cover as TC
from emqx_tpu_torch.ops.fanout import build_subtable
from emqx_tpu_torch.ops.match import encode_topics, match_batch
from emqx_tpu_torch.ops.scan import prefix_sum_ref
from emqx_tpu_torch.ops.shapes import shape_match, shape_match_ref
from emqx_tpu_torch.ops.trie import HostTrie
from emqx_tpu_torch.parallel import mesh as TMESH
from emqx_tpu_torch.parallel import sharded as TS
from emqx_tpu_torch.utils import topic as T
from tests.test_cover import EDGE_FILTERS, POPULATIONS, TRAFFIC
from tests.test_torch_engine import JAX_BROKER
from tools import workloads as RW

torch.set_num_threads(1)


def _encode(intern, filters, L=None):
    L = L or max(len(f.split("/")) for f in filters)
    rows = np.full((len(filters), L), JI.PAD, np.int32)
    lens = np.zeros(len(filters), np.int64)
    for i, f in enumerate(filters):
        ids = intern.encode_filter(f.split("/"))
        rows[i, :len(ids)] = ids
        lens[i] = len(ids)
    dollar = np.fromiter((f.startswith("$") for f in filters), bool,
                         len(filters))
    return rows, lens, dollar


def _population(n=400, ratio=0.6):
    intern = JI.InternTable()
    filters = sorted(set(EDGE_FILTERS
                         + RW.cover_heavy_filters(n, cover_ratio=ratio)))
    return intern, filters, *_encode(intern, filters)


def _topics(intern, filters, L, extra=()):
    topics = [RW.concretize(f) for f in filters] + list(extra)
    enc, tl, dol, _ = encode_topics(
        intern, [T.tokens(t) for t in topics], L)
    return enc, tl, dol


def _same(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, what)


# ---- host functions ---------------------------------------------------------

def test_covers_pair_against_topic_enumeration():
    """A covers B == topics(B) within topics(A), brute-forced through the
    port's HostTrie over an alphabet with a '$' root; the reference's
    predicate agrees on every pair."""
    intern = JI.InternTable()
    alphabet = ["a", "b", "c", "s", "t", "u", "v", "x", "$SYS"]
    topics = [[w] for w in alphabet]
    frontier = list(topics)
    for _ in range(3):
        frontier = [t + [w] for t in frontier for w in alphabet]
        topics += frontier
    enc = {f: intern.encode_filter(f.split("/")) for f in EDGE_FILTERS}
    tsets = {}
    for f in EDGE_FILTERS:
        trie = HostTrie()
        trie.insert(enc[f], 0)
        tsets[f] = {tuple(tw) for tw in topics if trie.match(
            [intern.lookup(w) for w in tw], is_dollar=tw[0][0] == "$")}
    for fa in EDGE_FILTERS:
        for fb in EDGE_FILTERS:
            got = TC.covers_pair(enc[fa], enc[fb], fb.startswith("$"))
            assert got == JC.covers_pair(enc[fa], enc[fb],
                                         fb.startswith("$"))
            assert got == (tsets[fb] <= tsets[fa]), (fa, fb)


@pytest.mark.parametrize("caps", [(128, 32), (4, 2)])
def test_detect_covers_equals_pairwise_and_jax(caps):
    """Cover sets (emission order) and the detection-overflow mask equal
    the reference's; without overflow they equal the pairwise oracle.
    (4, 2) forces match and frontier overflow: those filters must be
    flagged exactly as the reference flags them."""
    match_cap, frontier_cap = caps
    _i, filters, rows, lens, dollar = _population(150, 0.5)
    want, winc = JC.detect_covers(rows, lens, dollar, match_cap=match_cap,
                                  frontier_cap=frontier_cap)
    got, inc = TC.detect_covers(rows, lens, dollar, match_cap=match_cap,
                                frontier_cap=frontier_cap, batch=64)
    _same(winc, inc)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        _same(np.asarray(a, np.int64), b)
    if match_cap == 4:
        assert inc.any()
        return
    assert not inc.any()
    n = len(filters)
    words = [[int(x) for x in rows[i, :lens[i]]] for i in range(n)]
    for b in range(n):
        want_b = {a for a in range(n) if a != b and TC.covers_pair(
            words[a], words[b], b_dollar=bool(dollar[b]))}
        assert set(got[b].tolist()) == want_b, filters[b]


@pytest.mark.parametrize("budget", [256, 5, 2])
def test_assign_owners_equals_jax(budget):
    """Owners equal the reference's: 256 takes the vectorized pass, the
    small budgets the filter-by-filter walk (some root fills up)."""
    _i, _f, rows, lens, dollar = _population()
    covers, inc = JC.detect_covers(rows, lens, dollar)
    want = JC.assign_owners(covers, inc, own_budget=budget)
    got = TC.assign_owners(TC.detect_covers(rows, lens, dollar)[0], inc,
                           own_budget=budget)
    _same(want, got)
    _same(want, TC.assign_owners(covers, inc, own_budget=budget))
    if budget == 2:
        assert np.bincount(got[got >= 0]).max() == 2


def test_order_keys_and_shape_count_equal_jax():
    _i, _f, rows, lens, _d = _population()
    _same(JC.trie_order_keys(rows, lens), TC.trie_order_keys(rows, lens))
    _same(JC.shape_order_keys(rows, lens), TC.shape_order_keys(rows, lens))
    assert JC.full_shape_count(rows, lens) == \
        TC.full_shape_count(rows, lens)
    assert TC.trie_order_keys(rows[:0], lens[:0]).shape == (0,)


@pytest.mark.parametrize("keys,verify_cap,append_cap", [
    ("trie", None, 64), ("shape", None, 8), ("trie", 1024, 1)])
def test_build_cover_tables_and_rank_base_equal_jax(keys, verify_cap,
                                                    append_cap):
    _i, _f, rows, lens, dollar = _population()
    covers, inc = JC.detect_covers(rows, lens, dollar)
    owner = JC.assign_owners(covers, inc)
    k = getattr(JC, f"{keys}_order_keys")(rows, lens)
    fc = 1 << (len(lens) - 1).bit_length()
    kw = dict(fid_cap=fc, out_width=64, cand_cap=256,
              verify_cap=verify_cap, append_cap=append_cap)
    want = JC.build_cover_tables(rows, lens, owner, k, **kw)
    got = TC.build_cover_tables(rows, lens, owner, k, **kw)
    for name in JC.CoverTables._fields:
        _same(getattr(want, name), getattr(got, name), name)
    assert JC.rank_base(want) == TC.rank_base(got)
    dev = cover_from_numpy(want, "cpu")
    for name in JC.CoverTables._fields:
        _same(getattr(want, name), getattr(dev, name), name)


def test_host_covering_roots_equals_jax():
    intern, filters, rows, lens, dollar = _population(200)
    covers, inc = JC.detect_covers(rows, lens, dollar)
    owner = JC.assign_owners(covers, inc)
    jt, tt, rw = JHostTrie(), HostTrie(), {}
    for fid in np.flatnonzero(owner < 0).tolist():
        w = [int(x) for x in rows[fid, :lens[fid]]]
        jt.insert(w, fid)
        tt.insert(w, fid)
        rw[fid] = w
    news = ["s/u/q", "a/z", "$SYS/y", "d3/#", "zz/top", "b/c/d"] + [
        f + "/extra" for f in filters[::25] if not f.endswith("#")]
    for f in news:
        w = intern.encode_filter(f.split("/"))
        assert TC.host_covering_roots(tt, rw, w, f[0] == "$") == \
            JC.host_covering_roots(jt, rw, w, f[0] == "$"), f


# ---- the expansion stage ------------------------------------------------------

def _tables(rows, lens, dollar, *, budget, fid_cap, cand, keys):
    covers, inc = JC.detect_covers(rows, lens, dollar)
    owner = JC.assign_owners(covers, inc, own_budget=budget)
    k = getattr(JC, f"{keys}_order_keys")(rows, lens)
    ct = JC.build_cover_tables(rows, lens, owner, k, fid_cap=fid_cap,
                               out_width=64, cand_cap=cand)
    # two append entries on the first covered filter's root: its own
    # words again (matches what it matches) and a '#'-tailed one
    cov = np.flatnonzero(owner >= 0)
    F = len(lens)
    for a, b in enumerate(cov[:2]):
        ct.app_root[a] = owner[b]
        ct.app_fid[a] = F + a
        ct.app_key[a] = JC.rank_base(ct) + a
        ct.app_words[a, :lens[b]] = rows[b, :lens[b]]
        ct.app_lens[a] = lens[b]
    return ct, np.flatnonzero(owner < 0)


@pytest.mark.parametrize("case", ["packed", "cand_overflow", "stable",
                                  "shapes"])
def test_cover_expand_equals_jax(case):
    """The expanded MatchResult (matches, counts, overflow) behind the
    trie NFA (match_batch) and the shape tables (shape_match and
    shape_match_ref) equals the reference's on the same tables and
    topics: the packed int32 sort, a candidate overflow (a 4-wide
    candidate lane under budget 3), the stable argsort (a 2^20 fid
    capacity pushes the key past 31 bits), and the shape order keys."""
    intern, filters, rows, lens, dollar = _population()
    fc = 1 << (len(lens) - 1).bit_length()
    kw = {"packed": dict(budget=256, fid_cap=fc, cand=256, keys="trie"),
          "cand_overflow": dict(budget=3, fid_cap=fc, cand=4, keys="trie"),
          "stable": dict(budget=256, fid_cap=1 << 20, cand=1024,
                         keys="trie"),
          "shapes": dict(budget=256, fid_cap=fc, cand=256,
                         keys="shape")}[case]
    ct, roots = _tables(rows, lens, dollar, **kw)
    enc, tl, dol = _topics(intern, filters, rows.shape[1],
                           ["$SYS/x", "a/b", "s/u/t", "zz"])
    tin = [torch.from_numpy(x) for x in (enc, tl, dol)]
    if case == "shapes":
        st = j_build_shapes(rows[roots], lens[roots], filter_ids=roots,
                            shape_cap=64)._replace(cover=ct)
        want = j_shape_match(st, *map(jnp.asarray, (enc, tl, dol)))
        tst = tables_from_numpy(st, build_subtable(fc, {}, {}, {}),
                                "cpu").shapes
        gots = [shape_match_ref(tst, *tin), shape_match(tst, *tin)]
    else:
        tr = j_build_tables(rows[roots], lens[roots], filter_ids=roots,
                            node_capacity=4096,
                            slot_capacity=16384)._replace(cover=ct)
        want = j_match_batch(tr, *map(jnp.asarray, (enc, tl, dol)),
                             frontier_cap=16, match_cap=64)
        ttr = trie_from_numpy(tr, "cpu")
        gots = [match_batch(ttr, *tin, frontier_cap=16, match_cap=64,
                            scan=prefix_sum_ref)]
    for got in gots:
        for name in ("matches", "counts", "overflow"):
            _same(getattr(want, name), getattr(got, name), name)
    ov = np.asarray(want.overflow)
    if case == "cand_overflow":
        assert ov.any() and not ov.all()
    if case == "stable":
        lane_bits = (1024 + 64 - 1).bit_length()
        assert lane_bits + ((1 << 20) + 64 + 1).bit_length() > 31
        assert not ov.any()
    # the appended filters surfaced on the lanes they match
    assert (np.asarray(want.matches) >= len(lens)).any()


@pytest.mark.parametrize("append_cap", [1, 64])
def test_cover_expand_narrow_rows_equal_jax(append_cap):
    """Roots of one shape (a one-column base row) owning two filters
    each, with a 64-wide output: the port expands only the columns a
    lane can fill and pads the row to the reference's width."""
    intern = JI.InternTable()
    filters = sorted([f"r{i}/#" for i in range(4)]
                     + [f"r{i}/{w}" for i in range(4) for w in "ab"]
                     + ["$SYS/#", "q/x/y"])
    rows, lens, dollar = _encode(intern, filters)
    covers, inc = JC.detect_covers(rows, lens, dollar)
    owner = JC.assign_owners(covers, inc)
    roots = np.flatnonzero(owner < 0)
    ct = JC.build_cover_tables(rows, lens, owner,
                               JC.trie_order_keys(rows, lens), fid_cap=16,
                               out_width=64, cand_cap=256,
                               append_cap=append_cap)
    st = j_build_shapes(rows[roots], lens[roots], filter_ids=roots,
                        shape_cap=8)._replace(cover=ct)
    enc, tl, dol = _topics(intern, filters, rows.shape[1],
                           ["r1/a", "r2/b/c", "r3", "zz"])
    want = j_shape_match(st, *map(jnp.asarray, (enc, tl, dol)))
    tst = tables_from_numpy(st, build_subtable(16, {}, {}, {}),
                            "cpu").shapes
    got = shape_match_ref(tst, *(torch.from_numpy(x)
                                 for x in (enc, tl, dol)))
    for name in ("matches", "counts", "overflow"):
        _same(getattr(want, name), getattr(got, name), name)
    assert np.asarray(want.matches).shape[1] == min(64, 256 + append_cap)


# ---- engine twins --------------------------------------------------------------

class Sink:
    def __init__(self):
        self.got = []

    def deliver(self, topic_filter, msg):
        self.got.append((topic_filter, msg.topic, bytes(msg.payload)))
        return True


# the reference's default routing layers, covering on, on both nodes
FULL = {"topic_dedup": True, "match_cache_size": 8192,
        "delta_overlay": True, "subscription_covering": True}


def _twin(filters, covering=True, shape_cap=None):
    """(JAX node, port node), each with one sink and session per filter."""
    out = []
    for mk in (lambda: JNode({"broker": dict(
                   JAX_BROKER, **dict(FULL,
                                      subscription_covering=covering))},
                   use_device=True),
               lambda: TNode({"broker": dict(
                   FULL, subscription_covering=covering)}, device="cpu")):
        node = mk()
        if shape_cap is not None:
            node.device_engine.shape_cap = shape_cap
        sinks, sids = {}, {}
        for i, f in enumerate(filters):
            s = Sink()
            sid = node.broker.register(s, f"c{i}")
            node.broker.subscribe(sid, f, {"qos": 0})
            sinks[f], sids[f] = s, sid
        out.append((node, sinks, sids))
    return out


def _route(twin, topics, payload=b"x"):
    counts = []
    for node, _s, _i in twin:
        counts.append(node.device_engine.route_batch(
            [jmake("pub", 0, t, payload) for t in topics]))
    assert counts[0] is not None and counts[0] == counts[1]
    (_, s1, _), (_, s2, _) = twin
    assert s1.keys() == s2.keys()
    for f in s1:
        assert s1[f].got == s2[f].got, f
    return counts[1]


def _check_state(twin):
    (jn, _, _), (tn, _, _) = twin
    js, ts = jn.device_engine.stats(), tn.device_engine.stats()
    for k in ("backend", "filters", "delta_filters", "subscription_covering",
              "cover"):
        assert js[k] == ts[k], k
    for k in ("routing.cover.appends", "routing.cover.append_rejects",
              "pipeline.cover.windows", "pipeline.cover.filters_skipped",
              "routing.device.rebuilds", "routing.device.host_fallback"):
        assert jn.metrics.val(k) == tn.metrics.val(k), k
    return ts


@pytest.mark.parametrize("pop", ["shapes", "mixed", "trie"])
def test_engine_twin_covering(pop):
    """Clean rounds (cache hits included), post-snapshot subscriptions
    (for the shapes population "s/u/new" lands as an append under the
    built "s/#"; "fresh/+" takes the overlay), then a BUILT covered
    filter unsubscribed: the same deliveries, order, counts and cover
    state on both. "trie" forces both onto the trie (shape_cap 0)."""
    filters = POPULATIONS["shapes" if pop == "trie" else pop]
    twin = _twin(filters, shape_cap=0 if pop == "trie" else None)
    for rnd in range(3):
        _route(twin, TRAFFIC, b"r%d" % rnd)
    st = _check_state(twin)
    assert st["cover"]["covered"] > 0
    assert st["backend"] == ("trie" if pop == "trie" else "shapes")
    for node, sinks, _ in twin:
        s = Sink()
        sid = node.broker.register(s, "dirty")
        node.broker.subscribe(sid, "s/u/new", {"qos": 0})
        node.broker.subscribe(sid, "fresh/+", {"qos": 0})
        sinks["s/u/new"] = sinks["fresh/+"] = s
    _route(twin, TRAFFIC + ["s/u/new", "fresh/go"], b"dirty")
    st = _check_state(twin)
    if pop != "mixed":
        assert st["cover"]["appends"] == 1 and st["delta_filters"] == 1
    victim = [f for f in filters if "+" not in f and "#" not in f][0]
    for node, _s, sids in twin:
        node.broker.unsubscribe(sids[victim], victim)
    _route(twin, TRAFFIC, b"churn")
    _check_state(twin)


def test_append_path_and_cache_over_expanded_set():
    """A covered SUBSCRIBE after the build is an append (no overlay row,
    no rebuild); a cached topic the appended filter matches drops from
    the match cache (the invalidation walks the EXPANDED set) and
    delivers to the new subscriber; unrelated cached topics survive;
    deleting a covered built filter re-resolves its cached topic. The
    same counts, deliveries and cache accounting on both nodes."""
    twin = _twin(["s/#", "s/+/t", "s/u/t"])
    _route(twin, ["s/b"] * 70 + ["s/c"] * 70)
    _route(twin, ["s/b"] * 70)
    (jn, js, _), (tn, ts, _) = twin
    assert tn.device_engine.stats()["match_cache"]["hits"] >= 1
    for node, sinks, _ in twin:
        s = Sink()
        node.broker.subscribe(node.broker.register(s, "new"), "s/b",
                              {"qos": 0})
        sinks["s/b"] = s
    st = _check_state(twin)
    assert st["cover"]["appends"] == 1 and st["delta_filters"] == 0
    assert tn.metrics.val("routing.device.rebuilds") == 1
    assert _route(twin, ["s/b"] * 70) == [2] * 70
    assert _route(twin, ["s/c"] * 70) == [1] * 70
    assert ts["s/b"].got and all(g[1] == "s/b" for g in ts["s/b"].got)
    for node, _s, sids in twin:
        node.broker.unsubscribe(sids["s/u/t"], "s/u/t")
    assert _route(twin, ["s/u/t"] * 70) == [2] * 70
    jc = jn.device_engine.stats()["match_cache"]
    tc = tn.device_engine.stats()["match_cache"]
    for k in ("size", "hits", "misses", "delta_version",
              "delta_invalidated"):
        assert jc[k] == tc[k], k
    _check_state(twin)


def test_covering_compaction_after_64_rejected_appends():
    """New COVERING filters cannot append (no built root covers them):
    each takes the overlay and counts a reject; at 64 both engines name
    the "covering" compaction, and the next batch recompacts."""
    twin = _twin(["s/#", "s/+/t", "q/x"])
    _route(twin, ["s/u/t", "q/x"])
    for node, _s, sids in twin:
        for i in range(64):
            node.broker.subscribe(sids["s/#"], f"n{i}/#", {"qos": 0})
    (jn, _, _), (tn, _, _) = twin
    assert tn.device_engine._cover_churn == jn.device_engine._cover_churn \
        == 64
    assert tn.device_engine._compaction_reason() == "covering" == \
        jn.device_engine._compaction_reason()
    _route(twin, ["s/u/t", "n3/x", "q/x"])
    for node in (jn, tn):
        assert node.metrics.val("routing.device.compaction.covering") == 1
    assert tn.device_engine._cover_churn == 0
    _check_state(twin)


def test_stats_and_off_twin_has_no_cover_state():
    twin = _twin(["s/#", "s/+/t", "s/u/t"])
    _route(twin, ["s/u/t"])
    st = _check_state(twin)
    assert st["subscription_covering"] is True
    assert st["cover"] == {"roots": 1, "covered": 2, "appends": 0,
                           "incomplete": 0, "reduction": 3.0}
    off = _twin(["s/#", "s/+/t"], covering=False)
    _route(off, ["s/u/t"])
    st = _check_state(off)
    assert st["subscription_covering"] is False and st["cover"] is None
    eng = off[1][0].device_engine
    assert eng._built.cover is None and eng._tables.shapes.cover is None
    assert TNode(device="cpu").device_engine.subscription_covering is True


def test_cover_heavy_population_twin():
    """A cover_heavy_filters population whose full set overflows a small
    shape cap while its roots fit: the on twin matches the roots on the
    shape tables with trie order keys and expands to match_cap."""
    filters = TW.cover_heavy_filters(300, cover_ratio=0.6, max_depth=3)
    twin = _twin(filters, shape_cap=8)
    topics = [TW.concretize(f) for f in filters]
    for k in range(0, len(topics), 100):
        _route(twin, topics[k:k + 100])
    st = _check_state(twin)
    assert st["backend"] == "shapes"
    assert twin[1][0].device_engine._built.match_width == 64


# ---- the mesh ------------------------------------------------------------------

MESHES = [(2, 1), (4, 2), (8, 2)]
L = 8
KW = dict(frontier_cap=8, match_cap=16, fanout_cap=8, slot_cap=4)


def _mesh_tables(R, seed):
    """Per-shard reference tables with cover state (uniform constants),
    stacked, and a window of encoded topics."""
    rng = random.Random(seed)
    filters = sorted(set(RW.cover_heavy_filters(150, cover_ratio=0.6,
                                                max_depth=4))
                     | {"#", "a/+", "g/t", "$SYS/#"})
    intern = JI.InternTable()
    shards = [[] for _ in range(R)]
    for f in filters:
        shards[zlib.crc32(f.encode()) % R].append(f)
    fcap = 1 << max(2, max(len(s) for s in shards).bit_length())
    tables = []
    for fl in shards:
        rows, lens, dollar = _encode(intern, fl, L)
        covers, inc = JC.detect_covers(rows, lens, dollar)
        owner = JC.assign_owners(covers, inc)
        ct = JC.build_cover_tables(
            rows, lens, owner, JC.trie_order_keys(rows, lens),
            fid_cap=fcap, out_width=KW["match_cap"], cand_cap=256,
            verify_cap=fcap, append_cap=1)
        roots = np.flatnonzero(owner < 0)
        trie = j_build_tables(rows[roots], lens[roots], filter_ids=roots,
                              node_capacity=1024,
                              slot_capacity=4096)._replace(cover=ct)
        normal = {i: [(rng.randrange(50), rng.randrange(64))]
                  for i in range(len(fl))}
        tables.append(JRT(trie=trie, subs=j_build_subtable(
            fcap, normal, {}, {}, slot_cap=4, sub_rows_cap=256,
            fs_rows_cap=4, member_rows_cap=16)))
    topics = [RW.concretize(f) for f in rng.sample(filters, 29)] + [
        "$SYS/x", "none", "a/b"]
    enc, tl, dol, _ = encode_topics(intern, [T.tokens(t) for t in topics],
                                    L)
    mh = np.asarray([zlib.crc32(t.encode()) & 0x7FFFFFFF for t in topics],
                    np.int32)
    return JS.stack_tables(tables), (enc, tl, dol, mh)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("devices,dp", MESHES)
def test_mesh_step_with_cover_tables_equals_jax(devices, dp):
    """The sharded step over stacked per-shard cover tables: each shard's
    block of the one flattened match pass expands against its own
    CoverTables, plane for plane the reference's per-shard match_batch."""
    R = devices // dp
    stacked, inputs = _mesh_tables(R, devices)
    cur = np.zeros((R, 4), np.int32)
    want = JS.make_sharded_route_step(JMESH.make_mesh(devices, dp=dp),
                                      **KW)(stacked, cur, *inputs,
                                            np.int32(0))
    tm = TMESH.make_mesh(devices, dp=dp, devices=["cpu"])
    got = TS.make_sharded_route_step(tm, scan=prefix_sum_ref, **KW)(
        stacked_from_numpy(stacked, "cpu"), torch.from_numpy(cur),
        *(torch.from_numpy(np.asarray(x)) for x in inputs), 0)
    for name in want._fields:
        _same(getattr(want, name), getattr(got, name), name)
    assert (np.asarray(want.matches) >= 0).sum() > len(inputs[0])


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("caps", [(8, 16), (2, 4)])
def test_mesh_step_identity_cover_equals_jax(seed, caps):
    """Shards whose cover tables are the identity CSR (every filter its
    own root, as the reference builds a shard with no cover relation):
    the port keeps each shard's NFA block, the reference sorts it by the
    order key — equal planes, also under frontier and match overflow
    (caps (2, 4))."""
    from tests.test_trie_match import rand_filter, rand_topic
    frontier_cap, match_cap = caps
    devices, dp = 8, 2
    R = devices // dp
    rng = random.Random(seed)
    filters = sorted({rand_filter(rng) for _ in range(120)}
                     | {"#", "+/#", "+/+"})
    filters = [f for f in filters if len(T.tokens(f)) <= L]
    intern = JI.InternTable()
    shards = [[] for _ in range(R)]
    for f in filters:
        shards[zlib.crc32(f.encode()) % R].append(f)
    fcap = 1 << max(2, max(len(s) for s in shards).bit_length())
    tables = []
    for fl in shards:
        rows, lens, _d = _encode(intern, fl, L)
        ct = JC.build_cover_tables(
            rows, lens, np.full(len(fl), -1), JC.trie_order_keys(rows, lens),
            fid_cap=fcap, out_width=match_cap, cand_cap=256,
            verify_cap=fcap, append_cap=1)
        trie = j_build_tables(rows, lens, filter_ids=np.arange(len(fl)),
                              node_capacity=1024,
                              slot_capacity=4096)._replace(cover=ct)
        tables.append(JRT(trie=trie, subs=j_build_subtable(
            fcap, {i: [(i % 50, 1)] for i in range(len(fl))}, {}, {},
            slot_cap=4, sub_rows_cap=256, fs_rows_cap=4,
            member_rows_cap=16)))
    stacked = JS.stack_tables(tables)
    topics = [rand_topic(rng) for _ in range(32)]
    enc, tl, dol, _ = encode_topics(intern, [T.tokens(t) for t in topics],
                                    L)
    mh = np.zeros(32, np.int32)
    kw = dict(frontier_cap=frontier_cap, match_cap=match_cap, fanout_cap=8,
              slot_cap=4)
    cur = np.zeros((R, 4), np.int32)
    want = JS.make_sharded_route_step(JMESH.make_mesh(devices, dp=dp),
                                      **kw)(stacked, cur, enc, tl, dol, mh,
                                            np.int32(0))
    got = TS.make_sharded_route_step(
        TMESH.make_mesh(devices, dp=dp, devices=["cpu"]), **kw)(
        stacked_from_numpy(stacked, "cpu"), torch.from_numpy(cur),
        *(torch.from_numpy(np.asarray(x)) for x in (enc, tl, dol, mh)), 0)
    for name in want._fields:
        _same(getattr(want, name), getattr(got, name), name)
    if caps == (2, 4):
        assert np.asarray(want.overflow).any()


_COVER_SPEC = ([("multi", "ab/#", 0), ("multi", "ab/+", 0),
                ("multi", "ab/x", 0), ("multi", "+/x", 0),
                ("deep", "ab/+/c", 0), ("deep", "ab/q/c", 0)]
               + [(f"fan{i}", "hot/+", 0) for i in range(4)]
               + [(f"hot{i}", f"hot/{i}", 0) for i in range(4)]
               + [("um", "hot/#", 0), ("um", "$SYS/#", 0)]
               + [(f"solo{i}", f"solo/t{i}", 0) for i in range(4)])
_COVER_TOPICS = ["ab/x", "hot/1", "solo/t3", "ab/y", "ab/q/c", "hot/2",
                 "ab/z/c", "nomatch/z", "$SYS/x", "hot/3", "solo/t1",
                 "q/x", "ab", "hot"]


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("devices,dp", MESHES)
def test_mesh_engine_covering_sessions_equal_jax_node(devices, dp):
    """ShardedRouteEngine with covering on against a JAX Node serving
    through ShardedRouteServer with covering on and the exchange: the
    same per-session delivery sequences, exchange-served, and the same
    cover totals."""
    from emqx_tpu_torch.ops.match import encode_topics_str
    from emqx_tpu_torch.parallel.serving import ShardedRouteEngine
    from tests.test_exchange import Rec, _mk_node
    from tests.test_exchange import _route as j_route
    windows = [_COVER_TOPICS, list(reversed(_COVER_TOPICS))]
    node = _mk_node(devices, dp, exchange=True,
                    extra={"subscription_covering": True})
    recs, sids = {}, {}
    for client, f, _o in _COVER_SPEC:
        if client not in recs:
            recs[client] = Rec()
            sids[client] = node.broker.register(recs[client], client)
        node.broker.subscribe(sids[client], f, None)
    jeng = node.device_engine
    jeng.rebuild()
    assert jeng.warm_exchange(len(windows[0]))
    for _ in range(3):
        j_route(node, windows[0])
        if node.metrics.val("pipeline.exchange.windows"):
            break
        jeng.warm_exchange(len(windows[0]))
    for r in recs.values():
        r.got.clear()
    for w in windows:
        j_route(node, w)
    want = {c: list(r.got) for c, r in recs.items()}

    subs: dict = {}
    for client, f, o in _COVER_SPEC:
        subs.setdefault(f, []).append((sids[client], o))
    eng = ShardedRouteEngine.from_subscriptions(
        subs, n_devices=devices, dp=dp, device="cpu", batch=16,
        subscription_covering=True)
    jc = jeng.stats()["cover"]
    assert eng.stats["cover"] == {k: jc[k] for k in
                                  ("roots", "covered", "reduction")}
    assert eng.stats["cover"]["covered"] > 0
    client_of = {s: c for c, s in sids.items()}

    def route(w):
        enc, tl, dol, too_long = encode_topics_str(eng.intern, w, 16)
        pad = 16 - len(w)
        return eng.route_encoded(
            np.pad(enc, ((0, pad), (0, 0))), np.pad(tl, (0, pad)),
            np.pad(dol, (0, pad)), np.zeros(16, np.int32),
            np.pad(too_long, (0, pad)))

    for _ in range(3):
        if route(windows[0]).served:
            break
    got: dict = {c: [] for c in want}
    for w in windows:
        rb = route(w)
        assert rb.served, rb.reason
        for sid, rows in eng.sessions(rb).items():
            got[client_of[sid]] += [
                (eng.filters[int(x) & 0xFFFFFF], w[m], b"p%d" % m)
                for m, x in rows.tolist()]
    assert got == want


def test_mesh_covering_off_and_identity_tables():
    """Covering off builds no cover state; on, a shard with no cover
    relation carries an identity CSR and routes exactly as off."""
    from emqx_tpu_torch.parallel.serving import ShardedRouteEngine
    subs = {f"solo/t{i}": [(i, 1)] for i in range(12)}
    engs = [ShardedRouteEngine.from_subscriptions(
        subs, n_devices=4, dp=2, device="cpu", batch=16,
        subscription_covering=c) for c in (True, False)]
    on, off = engs
    assert off.tables.trie.cover is None and off.stats["cover"] is None
    ct = on.tables.trie.cover
    assert on.stats["cover"] == {"roots": 12, "covered": 0,
                                 "reduction": 1.0}
    assert (ct.exp_slot == -1).all() and (ct.app_root == -1).all()
    topics = [f"solo/t{i}" for i in range(14)]
    got = [[(p.fids.tolist(), p.rows.tolist()) for p in e.route(topics)]
           for e in engs]
    assert got[0] == got[1]


# ---- workloads ----------------------------------------------------------------

@pytest.mark.parametrize("n,ratio", [(1, 0.0), (7, 0.5), (400, 0.6),
                                     (2000, 0.6)])
def test_workloads_equal_tools(n, ratio):
    want = RW.cover_heavy_filters(n, cover_ratio=ratio)
    assert TW.cover_heavy_filters(n, cover_ratio=ratio) == want
    assert [TW.concretize(f) for f in want] == \
        [RW.concretize(f) for f in want]
    with pytest.raises(ValueError):
        TW.cover_heavy_filters(5, cover_ratio=1.0)
