"""Port vs JAX reference: the compacted route window, the table carry-over
and the RouteEngine's delivery plans.

- route_window equals route_window_full_compact field by field (every
  RouteResult plane stacked [W, ...] and every CompactPlanes field),
  exact, on full, under-filled, row-overflowing and cap-overflowing
  windows;
- tables_from_numpy carries JAX-built tables unchanged;
- RouteEngine(device="cpu") plans equal the brute-force
  emqx_tpu.utils.topic.match oracle.
"""

import random

import numpy as np
import pytest
import torch

from emqx_tpu.models import router_engine as JR
from emqx_tpu.ops.fanout import build_subtable as j_build_subtable
from emqx_tpu.ops.shapes import build_shape_tables as j_build_shapes
from emqx_tpu.utils import topic as JT
from emqx_tpu_torch.convert import tables_from_numpy
from emqx_tpu_torch.engine import RouteEngine
from emqx_tpu_torch.models import router_engine as TR
from emqx_tpu_torch.ops.shared import (STRATEGY_HASH_CLIENT,
                                       STRATEGY_HASH_TOPIC, STRATEGY_RANDOM,
                                       STRATEGY_ROUND_ROBIN, STRATEGY_STICKY)
from emqx_tpu_torch.workloads import pattern_population
from tests.test_trie_match import rand_filter, rand_topic

# small CPU cases: one intra-op thread leaves the cores to the other
# test workers (torch would otherwise spin a thread per core)
torch.set_num_threads(1)


def window_fixture(seed, W=3, B=24, hot=False):
    """JAX-built tables over the six-pattern population, random normal and
    shared subscribers, and a [W, B] window of encoded topics. ``hot``:
    every filter also feeds slots 1-3, so each is hit in every step, and
    the cursors start within 16 of 2^31, so the int32 add wraps."""
    rng = np.random.default_rng(seed)
    _i, words, flens, t, tl, dol = pattern_population(rng, 300, W * B)
    F = len(flens)
    r = np.random.RandomState(seed)
    normal = {f: [(int(r.randint(900)), int(r.randint(64)))
                  for _ in range(r.randint(0, 4))] for f in range(F)}
    G = 11
    filter_slots = {f: sorted(r.choice(G, r.randint(1, 3),
                                       replace=False).tolist())
                    for f in range(F) if r.rand() < 0.4}
    if hot:
        filter_slots = {f: sorted({1, 2, 3} | set(filter_slots.get(f, [])))
                        for f in range(F)}
    shared = {g: [(2000 + 8 * g + j, int(r.randint(64)))
                  for j in range(r.randint(0, 5))] for g in range(G)}
    tables = JR.ShapeRouterTables(
        shapes=j_build_shapes(words, flens),
        subs=j_build_subtable(F, normal, filter_slots, shared, slot_cap=G))
    msg_hash = r.randint(0, 1 << 31, (W, B)).astype(np.int32)
    cursors = r.randint(0, 7, G).astype(np.int32)
    if hot:
        cursors = ((1 << 31) - 1 - r.randint(0, 16, G)).astype(np.int32)
    return (tables, cursors, t.reshape(W, B, -1), tl.reshape(W, B).copy(),
            dol.reshape(W, B), msg_hash)


CASES = {
    # name: (fanout_cap, slot_cap, payload_cap, empty rows of sub-batch 2,
    #        window fixture's W and hot slots)
    "full": (8, 4, 4096, 0, 3, False),
    "underfilled": (8, 4, 4096, 24, 3, False),     # sub-batch 2 all padding
    "row_overflow": (8, 4, 24, 0, 3, False),
    "cap_overflow": (1, 1, 4096, 5, 3, False),
    "hot_wrap8": (8, 6, 4096, 0, 8, True),
}


@pytest.mark.parametrize("strategy", [STRATEGY_ROUND_ROBIN, STRATEGY_RANDOM,
                                      STRATEGY_STICKY, STRATEGY_HASH_TOPIC,
                                      STRATEGY_HASH_CLIENT])
@pytest.mark.parametrize("case", sorted(CASES))
def test_window_equals_jax(case, strategy):
    fan, slot, pcap, empty, W, hot = CASES[case]
    tables, cursors, t, tl, dol, mh = window_fixture(len(case), W=W, hot=hot)
    if empty:
        tl[2, -empty:] = 0                 # padding lanes match nothing
    kw = dict(fanout_cap=fan, slot_cap=slot, payload_cap=pcap)
    want = JR.route_window_full_compact(tables, cursors, t, tl, dol, mh,
                                        np.int32(strategy), **kw)
    pt = tables_from_numpy(tables.shapes, tables.subs, "cpu")
    args = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (cursors, t, tl, dol, mh)]
    got = TR.route_window(pt, *args[:5], strategy, **kw)
    pairs = [(getattr(got.res, k), getattr(want.res, k), k)
             for k in JR.RouteResult._fields]
    pairs += [(getattr(got.compact, k), getattr(want.compact, k), k)
              for k in ("offsets", "counts3", "payload", "row_overflow")]
    for g, w, name in pairs:
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name   # int32 / int8 / bool
        np.testing.assert_array_equal(g.numpy(), w, name)
    assert int(TR.route_digest(got.res)) == int(JR.route_digest(want.res))
    ro = got.compact.row_overflow.numpy()
    assert ro.any() == (case == "row_overflow")
    if case == "cap_overflow":
        assert got.res.overflow.any()
    if hot:
        # slots 1-3 recur in every step, and round robin wraps past 2^31
        assert (got.res.occur.numpy()[:, 1:4] > 0).all()
        if strategy == STRATEGY_ROUND_ROBIN:
            assert (got.res.new_cursors.numpy()[-1, 1:4] < 0).all()


def test_step_equals_first_window_row():
    tables, cursors, t, tl, dol, mh = window_fixture(4)
    pt = tables_from_numpy(tables.shapes, tables.subs, "cpu")
    c = torch.from_numpy(cursors)
    step = TR.route_step_shapes(pt, c, torch.from_numpy(t[0]),
                                torch.from_numpy(tl[0]),
                                torch.from_numpy(dol[0]),
                                torch.from_numpy(mh[0]), STRATEGY_ROUND_ROBIN,
                                fanout_cap=8, slot_cap=4)
    win = TR.route_window(pt, c, *(torch.from_numpy(x)
                                   for x in (t, tl, dol, mh)),
                          STRATEGY_ROUND_ROBIN, fanout_cap=8, slot_cap=4)
    for name in TR.RouteResult._fields:
        assert torch.equal(getattr(step, name), getattr(win.res, name)[0])
    assert win.compact is None


def test_tables_from_numpy_carries_jax_tables():
    tables = window_fixture(5)[0]
    pt = tables_from_numpy(tables.shapes, tables.subs, "cpu")
    for part in ("shapes", "subs"):
        for k, v in getattr(tables, part)._asdict().items():
            if v is None:
                continue
            got = getattr(getattr(pt, part), k)
            if torch.is_tensor(got):      # planes; counts become ints
                got = got.numpy()
                assert got.dtype == np.asarray(v).dtype, f"{part}.{k}"
            np.testing.assert_array_equal(got, np.asarray(v), f"{part}.{k}")


def engine_fixture(seed, n_filters=40, n_topics=90, max_levels=6):
    rng = random.Random(seed)
    filters = sorted({rand_filter(rng) for _ in range(n_filters)})
    subs, normal, groups = {}, {}, {}
    row = 0
    for f in filters:
        if rng.random() < 0.8:
            normal[f] = [(row + j, rng.randrange(64))
                         for j in range(rng.randrange(1, 4))]
            subs[f] = normal[f]
            row += 4
        if rng.random() < 0.3:
            g = f"g{rng.randrange(3)}"
            members = [(1000 + row + j, rng.randrange(64))
                       for j in range(rng.randrange(1, 4))]
            groups[(g, f)] = members
            subs[f"$share/{g}/{f}"] = members
            row += 4
    topics = [rand_topic(rng) for _ in range(n_topics)]
    topics += ["a/b/c/a/b/c/a/b", "$sys/a", "a/" * 7 + "a"]  # too long, '$'
    return subs, normal, groups, topics


@pytest.mark.parametrize("strategy", ["round_robin", "random", "hash_topic",
                                      "hash_clientid", "sticky"])
@pytest.mark.parametrize("config", ["roomy", "tight"])
def test_engine_plans_match_oracle(config, strategy):
    """roomy: no fallback, and round-robin picks equal the sequential
    per-group counter; tight: small caps, a tiny payload class and
    too-deep topics drive the dense and host fallbacks. Every strategy
    picks a member of the matched group."""
    subs, normal, groups, topics = engine_fixture(11)
    kw = dict(batch=16, window=2, max_levels=6, strategy=strategy)
    if config == "tight":
        kw.update(fanout_cap=2, slot_cap=1, payload_cap=8)
    else:
        kw.update(fanout_cap=16, slot_cap=8, payload_cap=4096)
        topics = [t for t in topics if len(JT.tokens(t)) <= 6]
    eng = RouteEngine.from_subscriptions(subs, device="cpu", **kw)
    publishers = np.arange(len(topics), dtype=np.int32) * 7919 \
        if strategy == "hash_clientid" else None
    plans = eng.route(topics, msg_hash=publishers)
    assert len(plans) == len(topics)
    cursor = {k: 0 for k in groups}
    for topic, plan in zip(topics, plans):
        hit = [f for f in eng.filters if JT.match(topic, f)]
        assert sorted(eng.filters[i] for i in plan.fids) == hit, topic
        want_rows = sorted(p for f in hit for p in normal.get(f, []))
        assert sorted(zip(plan.rows.tolist(), plan.opts.tolist())) \
            == want_rows, topic
        keys = [eng.slot_keys[s] for s in plan.shared_slots]
        assert sorted(keys) == sorted(k for k in groups if k[1] in hit)
        for k, r, o in zip(keys, plan.shared_rows, plan.shared_opts):
            members = groups[k]
            assert (int(r), int(o)) in members
            if config == "roomy" and strategy == "round_robin":
                assert (int(r), int(o)) == members[cursor[k] % len(members)]
                cursor[k] += 1
        assert plan.host == (len(JT.tokens(topic)) > 6) or config == "tight"
    if config == "tight":
        assert eng.stats["dense_windows"] > 0
        assert eng.stats["host_messages"] > 0
    else:
        assert eng.stats["host_messages"] == eng.stats["dense_windows"] == 0


def test_chip_smoke_main_path_on_cpu():
    """chip_smoke.py's main-path drive, rehearsed on the CPU at a small
    size: the known-answer checks, the plain-path comparison and the
    cursor threading all hold (the kernel launch counts stay 0 here)."""
    import chip_smoke
    b = chip_smoke.bench_engine(torch.device("cpu"), 5000, 256, 3, seed=7)
    r = chip_smoke.drive_main_path(b, timed_windows=2)
    assert r["launches"] == {"shape_match": 0, "prefix_sum": 0,
                             "ring_rotate": 0}
    assert tuple(r["n_entries"].shape) == (3, 256)
    stats = b["eng"].stats
    assert {k: stats[k] for k in ("windows", "dense_windows",
                                  "host_messages")} == {
        "windows": 4, "dense_windows": 0, "host_messages": 0}
    # the readback counters: every window's payload entries and bytes
    assert 0 < 4 * stats["csr_entries"] < stats["d2h_bytes"]
