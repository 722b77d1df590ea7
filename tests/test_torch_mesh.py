"""Port vs JAX reference: the sharded mesh route path.

On the reference's 8-virtual-device CPU mesh (the JAX side) and a grid of
CPU shards (the port), from the same stacked tables and inputs, exact:

- the sharded route step, both backends, for (devices, dp) in
  {(2, 1), (4, 2), (8, 2)}, including the cross-dp round-robin case;
- the exchange step (plan, plan_cnt, src_cnt, ok), including a forced
  segment-capacity overflow (ok & 2 == 0) and a shared hit (ok & 1 == 0);
- ring_rotate_ref against np.roll for every hop count;
- update_shard and make_mesh errors;
- the slim ShardedRouteEngine's per-session delivery order against a JAX
  Node serving through ShardedRouteServer with the exchange on.
"""

import random
import zlib

import jax
import numpy as np
import pytest
import torch

from emqx_tpu.models.router_engine import RouterTables as JRT
from emqx_tpu.models.router_engine import ShapeRouterTables as JSRT
from emqx_tpu.ops import intern as JI
from emqx_tpu.ops.fanout import build_subtable as j_build_subtable
from emqx_tpu.ops.shapes import build_shape_tables as j_build_shapes
from emqx_tpu.ops.trie import build_tables as j_build_tables
from emqx_tpu.parallel import mesh as JMESH
from emqx_tpu.parallel import sharded as JS
from emqx_tpu_torch.convert import stacked_from_numpy
from emqx_tpu_torch.models.router_engine import ExchangeAux
from emqx_tpu_torch.ops.exchange import ring_rotate, ring_rotate_ref
from emqx_tpu_torch.ops.match import encode_topics
from emqx_tpu_torch.ops.shared import (STRATEGY_HASH_TOPIC,
                                       STRATEGY_ROUND_ROBIN)
from emqx_tpu_torch.parallel import mesh as TMESH
from emqx_tpu_torch.parallel import sharded as TS
from emqx_tpu_torch.utils import topic as T
from tests.test_trie_match import rand_filter, rand_topic

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

L = 8
MESHES = [(2, 1), (4, 2), (8, 2)]


def population(seed, R, n_filters=60, n_topics=16, shared=True):
    """Random filters split by crc32 over R shards (same capacities),
    normal subscribers (sid % R spreads them over delivery shards) and,
    optionally, shared groups; topics encoded with the shared intern."""
    rng = random.Random(seed)
    filters = sorted({rand_filter(rng) for _ in range(n_filters)}
                     | {"g/t", "#", "a/+"})
    intern = JI.InternTable()
    shards = [[] for _ in range(R)]
    for f in filters:
        shards[zlib.crc32(f.encode()) % R].append(f)
    fcap = 1 << max(2, max(len(s) for s in shards).bit_length())
    tables = []
    for s, fl in enumerate(shards):
        rows = np.zeros((len(fl), L), np.int32)
        lens = np.zeros(len(fl), np.int64)
        normal, fslots, members = {}, {}, {}
        for i, f in enumerate(fl):
            ids = intern.encode_filter(T.tokens(f))
            rows[i, :len(ids)] = ids
            lens[i] = len(ids)
            normal[i] = [(rng.randrange(50), rng.randrange(64))
                         for _ in range(rng.randrange(1, 4))]
            if shared and (f == "g/t" or rng.random() < 0.1):
                fslots[i] = [len(members)]
                members[len(members)] = [(100 + 10 * s + j, 1)
                                         for j in range(3)]
        trie = j_build_tables(rows, lens, node_capacity=512,
                              slot_capacity=2048)
        subs = j_build_subtable(fcap, normal, fslots, members, slot_cap=4,
                                sub_rows_cap=256, fs_rows_cap=4,
                                member_rows_cap=16)
        tables.append(JRT(trie=trie, subs=subs))
    topics = [rand_topic(rng) for _ in range(n_topics - 4)]
    topics += ["g/t", "g/t", "a/b", "$sys/x"]
    enc, tl, dol, _ = encode_topics(intern, [T.tokens(t) for t in topics], L)
    mh = np.asarray([zlib.crc32(t.encode()) & 0x7FFFFFFF for t in topics],
                    np.int32)
    return shards, JS.stack_tables(tables), (enc, tl, dol, mh)


def meshes(devices, dp):
    return (JMESH.make_mesh(devices, dp=dp),
            TMESH.make_mesh(devices, dp=dp, devices=["cpu"]))


def t(x):
    return torch.from_numpy(np.array(x))


def assert_tree_equal(got, want):
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, name)


KW = dict(frontier_cap=8, match_cap=16, fanout_cap=8, slot_cap=4)


@pytest.mark.parametrize("strategy", [STRATEGY_ROUND_ROBIN,
                                      STRATEGY_HASH_TOPIC])
@pytest.mark.parametrize("devices,dp", MESHES)
def test_trie_step_equals_jax(devices, dp, strategy):
    jm, tm = meshes(devices, dp)
    R = devices // dp
    _s, stacked, inputs = population(devices + strategy, R)
    cursors = np.arange(R * 4, dtype=np.int32).reshape(R, 4) % 3
    want = JS.make_sharded_route_step(jm, **KW)(
        stacked, cursors, *inputs, np.int32(strategy))
    got = TS.make_sharded_route_step(tm, **KW)(
        stacked_from_numpy(stacked, "cpu"), t(cursors), *map(t, inputs),
        strategy)
    assert_tree_equal(got, want)


@pytest.mark.parametrize("devices,dp", MESHES)
def test_shapes_step_equals_jax(devices, dp):
    jm, tm = meshes(devices, dp)
    R = devices // dp
    intern = JI.InternTable()
    tables = []
    for s in range(R):
        fl = [f"a{s}x{i}/+" for i in range(6)] + [f"b{i}/+" for i in range(s)]
        rows = np.zeros((len(fl), L), np.int32)
        for i, f in enumerate(fl):
            rows[i, :2] = intern.encode_filter(T.tokens(f))
        st = j_build_shapes(rows, np.full(len(fl), 2), bucket_capacity=64)
        subs = j_build_subtable(16, {i: [(10 * s + i, 1)]
                                     for i in range(len(fl))}, {}, {},
                                slot_cap=2, sub_rows_cap=16)
        tables.append(JSRT(shapes=st, subs=subs))
    stacked = JS.stack_tables(tables)
    topics = [f"a{i % R}x{i % 7}/q" for i in range(8)] + ["b0/z"] * 8
    enc, tl, dol, _ = encode_topics(intern, [T.tokens(x) for x in topics], L)
    mh = np.zeros(len(topics), np.int32)
    cursors = np.zeros((R, 2), np.int32)
    want = JS.make_sharded_route_step(jm, backend="shapes", **KW)(
        stacked, cursors, enc, tl, dol, mh, np.int32(0))
    got = TS.make_sharded_route_step(tm, backend="shapes", **KW)(
        stacked_from_numpy(stacked, "cpu"), t(cursors),
        *map(t, (enc, tl, dol, mh)), 0)
    assert_tree_equal(got, want)
    assert int(np.asarray(want.match_counts).sum()) > 0


def test_cross_dp_round_robin():
    """Messages split across dp rows round-robin one group in global
    batch order (the reference's test_sharded.py:85 case)."""
    _jm, tm = meshes(8, 2)
    intern = JI.InternTable()

    def shard(fl, fslots, members):
        rows = np.zeros((len(fl), L), np.int32)
        for i, f in enumerate(fl):
            rows[i, :2] = intern.encode_filter(T.tokens(f))
        return JRT(trie=j_build_tables(rows, np.full(len(fl), 2),
                                       node_capacity=64, slot_capacity=256),
                   subs=j_build_subtable(2, {}, fslots, members, slot_cap=2,
                                         sub_rows_cap=8, fs_rows_cap=8,
                                         member_rows_cap=8))

    shards = [shard(["g/t"], {0: [0]}, {0: [(7, 0), (8, 0), (9, 0)]})]
    shards += [shard([], {}, {}) for _ in range(3)]
    stacked = JS.stack_tables(shards)
    enc, tl, dol, _ = encode_topics(intern, [["g", "t"]] * 8, L)
    res = TS.make_sharded_route_step(tm, **KW)(
        stacked_from_numpy(stacked, "cpu"), torch.zeros((4, 2),
                                                        dtype=torch.int32),
        *map(t, (enc, tl, dol, np.zeros(8, np.int32))), STRATEGY_ROUND_ROBIN)
    picks = [int(r) for r in res.shared_rows.reshape(8, -1).numpy().ravel()
             if r >= 0]
    assert picks == [7, 8, 9, 7, 8, 9, 7, 8]
    assert int(res.new_cursors[0, 0]) == 8


def exchange_inputs(seed, devices, dp, shared=False):
    jm, tm = meshes(devices, dp)
    R = devices // dp
    shards, stacked, inputs = population(seed, R, shared=shared)
    step = JS.make_sharded_route_step(jm, **KW)
    res = step(stacked, np.zeros((R, 4), np.int32), *inputs, np.int32(0))
    fcap = np.asarray(stacked.subs.sub_start).shape[1] - 1
    seg = np.zeros((R, fcap), np.int32)
    slow = np.zeros((R, fcap), bool)
    start = np.asarray(stacked.subs.sub_start)
    fs = np.asarray(stacked.subs.fs_start)
    offs = np.zeros(R, np.int32)
    total = 0
    for r, fl in enumerate(shards):
        n = len(fl)
        seg[r, :n] = np.diff(start[r])[:n]
        slow[r, :n] = np.diff(fs[r])[:n] > 0
        offs[r] = total
        total += n
    planes = [np.asarray(getattr(res, k)) for k in
              ("matches", "rows", "opts", "shared_sids", "overflow")]
    return jm, tm, planes, (seg, slow, offs), res


@pytest.mark.parametrize("seg_cap", [16, 64])
@pytest.mark.parametrize("devices,dp", MESHES)
def test_exchange_equals_jax(devices, dp, seg_cap):
    jm, tm, planes, aux, res = exchange_inputs(3 + devices, devices, dp)
    assert not np.asarray(res.overflow).any()
    want = JS.make_exchange_step(jm, seg_cap=seg_cap)(*planes, *aux)
    got = TS.make_exchange_step(tm, seg_cap=seg_cap)(
        *map(t, planes), ExchangeAux(*map(t, aux)))
    assert_tree_equal(got, want)
    ok = got.ok.numpy()
    if seg_cap == 64:
        assert (ok == 3).all()


def test_exchange_overflow_and_shared_hit():
    jm, tm, planes, aux, _ = exchange_inputs(11, 8, 2, shared=True)
    for seg_cap in (2, 32):
        want = JS.make_exchange_step(jm, seg_cap=seg_cap)(*planes, *aux)
        got = TS.make_exchange_step(tm, seg_cap=seg_cap)(
            *map(t, planes), ExchangeAux(*map(t, aux)))
        assert_tree_equal(got, want)
        ok = got.ok.numpy()
        assert ((ok & 1) == 0).any()          # the g/t shared hit
        if seg_cap == 2:
            assert ((ok & 2) == 0).any()      # segments outgrew E


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_ring_rotate_ref_equals_roll(k):
    x = np.arange(2 * 4 * 5 * 3, dtype=np.int32).reshape(2, 4, 5, 3)
    blocks = [[torch.from_numpy(x[d, r].copy()) for r in range(4)]
              for d in range(2)]
    for fn in (ring_rotate_ref, ring_rotate):   # CPU: the plain version
        out = fn(blocks, k)
        got = np.stack([np.stack([o.numpy() for o in row]) for row in out])
        np.testing.assert_array_equal(got, np.roll(x, k, axis=1))


def test_update_shard_and_mesh_errors():
    _s, stacked, _ = population(5, 4)
    dev = stacked_from_numpy(stacked, "cpu")
    shard2 = jax.tree.map(lambda x: np.asarray(x)[2], stacked)
    with pytest.raises(IndexError):
        TS.update_shard(dev, 4, shard2)
    bad = shard2._replace(trie=shard2.trie._replace(
        slot_parent=np.zeros(7, np.int32)))
    with pytest.raises(ValueError):
        TS.update_shard(dev, 1, bad)
    kept = TS.update_shard(dev, 0, shard2, donate=False)
    assert torch.equal(kept.trie.slot_parent[0], dev.trie.slot_parent[2])
    assert not torch.equal(dev.trie.slot_parent[0], dev.trie.slot_parent[2])
    TS.update_shard(dev, 0, shard2)          # in place
    assert torch.equal(dev.trie.slot_parent[0], dev.trie.slot_parent[2])
    with pytest.raises(ValueError):
        TMESH.make_mesh(8, dp=3, devices=["cpu"])
    with pytest.raises(ValueError):
        JMESH.make_mesh(8, dp=3)
    m = TMESH.make_mesh(8, dp=2, devices=["cpu"])
    assert (m.dp, m.route, m.devices()) == (2, 4, [torch.device("cpu")])


def _jax_node_sessions(devices, dp, spec, windows):
    """Per-client delivery sequences from a JAX Node serving through
    ShardedRouteServer with the exchange on, after the same warm-up as
    the reference's own exchange tests; plus each client's sid."""
    from tests.test_exchange import Rec, _mk_node, _route
    node = _mk_node(devices, dp, exchange=True)
    broker = node.broker
    recs, sids = {}, {}
    for client, f, _o in spec:
        if client not in recs:
            recs[client] = Rec()
            sids[client] = broker.register(recs[client], client)
        broker.subscribe(sids[client], f, None)
    eng = node.device_engine
    eng.rebuild()
    assert eng.warm_exchange(len(windows[0]))
    for _ in range(3):
        _route(node, windows[0])
        if node.metrics.val("pipeline.exchange.windows"):
            break
        eng.warm_exchange(len(windows[0]))
    for r in recs.values():
        r.got.clear()
    before = node.metrics.val("pipeline.exchange.windows")
    for w in windows:
        _route(node, w)
    assert node.metrics.val("pipeline.exchange.windows") \
        == before + len(windows)
    return {c: list(r.got) for c, r in recs.items()}, sids


@pytest.mark.parametrize("devices,dp", MESHES)
def test_engine_sessions_equal_jax_node(devices, dp):
    from emqx_tpu_torch.ops.match import encode_topics_str
    from emqx_tpu_torch.parallel.serving import ShardedRouteEngine
    from tests.test_exchange import _SPEC, _TOPICS
    windows = [_TOPICS, list(reversed(_TOPICS))]
    want, sids = _jax_node_sessions(devices, dp, _SPEC, windows)
    subs: dict = {}
    for client, f, o in _SPEC:
        subs.setdefault(f, []).append((sids[client], o))
    eng = ShardedRouteEngine.from_subscriptions(
        subs, n_devices=devices, dp=dp, device="cpu", batch=16)
    client_of = {s: c for c, s in sids.items()}

    def route(w):
        enc, tl, dol, too_long = encode_topics_str(eng.intern, w, 16)
        pad = 16 - len(w)
        return eng.route_encoded(
            np.pad(enc, ((0, pad), (0, 0))), np.pad(tl, (0, pad)),
            np.pad(dol, (0, pad)), np.zeros(16, np.int32),
            np.pad(too_long, (0, pad)))

    for _ in range(3):             # warm-up: the segment ladder adapts
        if route(windows[0]).served:
            break
    got: dict = {c: [] for c in want}
    for w in windows:
        rb = route(w)
        assert rb.served, rb.reason         # the exchange served it
        for sid, recs in eng.sessions(rb).items():
            got[client_of[sid]] += [
                (eng.filters[int(x) & 0xFFFFFF], w[m], b"p%d" % m)
                for m, x in recs.tolist()]
    assert got == want
    assert eng.stats["exchange_windows"] >= 3


def test_engine_plans_and_fallbacks():
    """route() plans equal the brute-force oracle through every rung:
    exchange windows, a shared hit (unclean gather), a segment overflow,
    and too-long topics completed on the host."""
    from emqx_tpu_torch.parallel.serving import ShardedRouteEngine
    rng = random.Random(4)
    filters = sorted({f for f in (rand_filter(rng) for _ in range(80)) if f})
    subs = {f: [(i, i % 64)] for i, f in enumerate(filters)}
    subs["$share/g/a/+"] = [(500, 1), (501, 2)]
    eng = ShardedRouteEngine.from_subscriptions(
        subs, n_devices=8, dp=2, device="cpu", batch=32, level_cap=6,
        fanout_cap=16, slot_cap=4)
    topics = [rand_topic(rng) for _ in range(90)] + ["a/b/c/a/b/c/a/b"]
    clean = [x for x in topics
             if not T.match(x, "a/+") and len(T.tokens(x)) <= 6][:32]

    def check(topics, plans):
        for topic, plan in zip(topics, plans):
            hit = [f for f in filters if T.match(topic, f)]
            shared = T.match(topic, "a/+")
            assert sorted(eng.filters[i] for i in plan.fids) == sorted(
                set(hit) | ({"a/+"} if shared else set())), topic
            assert sorted(plan.rows.tolist()) == sorted(
                subs[f][0][0] for f in hit), topic
            assert len(plan.shared_slots) == int(shared), topic
            if shared:
                assert int(plan.shared_rows[0]) in (500, 501)

    check(topics, eng.route(topics))
    fb = eng.stats["fallback"]
    assert fb == {"overflow": 1, "unclean": 1, "host_idx": 1}
    assert eng.stats["host_messages"] == 1
    check(clean, eng.route(clean))        # the grown class now fits
    assert eng.stats["exchange_windows"] == 1


def test_chip_smoke_mesh_path_on_cpu():
    """chip_smoke.py's mesh phase, rehearsed on the CPU at a small size:
    the known answer, the plain-path comparison, the exchange-vs-gather
    session order and the all-served timed windows hold (the kernel
    launch counts stay 0 here)."""
    import chip_smoke
    m = chip_smoke.mesh_engine(torch.device("cpu"), 5000, 256, 7)
    r = chip_smoke.drive_mesh(m, 2)
    assert r["launches"] == {"shape_match": 0, "prefix_sum": 0,
                             "ring_rotate": 0}
    assert (r["served"], r["fell_back"], r["err_ring"]) == (2, 0, 0)
    assert m["eng"].stats["exchange_windows"] >= 4
