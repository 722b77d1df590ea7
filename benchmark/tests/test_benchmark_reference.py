"""The plain reference against brute force at a small size: the grid
index against ``mqtt_match`` over every filter, the window plans against
a per-topic loop, and the comparison against readbacks broken on
purpose."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import traffic
from benchmark.population import Grid, subtable
from benchmark.reference import engine_ref
from benchmark.reference.matcher import GridIndex, mqtt_match

TEMPLATES = ["device/d{i}/+/n{n}/#", "a/{i}/b/{n}", "+/{i}/#",
             "{i}/{n}", "$SYS/{i}/+"]
TOPICS = ["device/d3/x/n4/t", "device/d3/x/n4", "device/d3/x/n4/t/u",
          "device/d3/x", "device/d9/x/n4/t", "device/d3/x/n9/t",
          "a/3/b/4", "a/3/b/4/c", "q/3", "q/3/z", "3/4", "3/4/5",
          "$SYS/2/q", "$SYS/2", "$q/3/z", "device/d3//n4/t", ""]


@pytest.mark.parametrize("template", TEMPLATES)
def test_grid_index_is_brute_force(template):
    ids, nums = 6, 7
    index = GridIndex(template, ids, nums)
    filters = [template.format(i=i, n=n) for i in range(ids)
               for n in range(nums)]
    for t in TOPICS:
        want = [f for f, flt in enumerate(filters) if mqtt_match(t, flt)]
        assert index.match(t) == want, (t, template)


def test_mqtt_match_rules():
    assert mqtt_match("a", "a/#") and mqtt_match("a/b/c", "a/#")
    assert mqtt_match("a/b", "a/+") and not mqtt_match("a/b/c", "a/+")
    assert not mqtt_match("$SYS/x", "#") and not mqtt_match("$SYS/x", "+/x")
    assert mqtt_match("$SYS/x", "$SYS/#") and mqtt_match("/x", "+/x")


CFG = {"population": {"template": "device/d{i}/+/n{n}/#", "ids": 40,
                      "nums": 30},
       "shared": {"percent": 50, "filters_per_group": 16, "members": 8}}


def brute_plans(topics, filters, st, cursors, W, B, fan_cap, slot_cap):
    """One topic at a time: every filter by brute force, then its rows and
    round-robin picks with the cursors threaded step by step."""
    cur = cursors.copy()
    out = []
    for w in range(W):
        occ = np.zeros_like(cur)
        for b in range(B):
            t = topics[w * B + b]
            fids = [f for f, flt in enumerate(filters) if mqtt_match(t, flt)]
            rows, picks = [], []
            for f in fids:
                a, z = st["sub_start"][f], st["sub_start"][f + 1]
                rows += [(int(r), int(o)) for r, o in
                         zip(st["sub_row"][a:z], st["sub_opts"][a:z])]
                for s in st["fs_slot"][st["fs_start"][f]:
                                       st["fs_start"][f + 1]]:
                    lo = st["shared_start"][s]
                    size = st["shared_start"][s + 1] - lo
                    j = lo + (cur[s] + occ[s]) % size
                    occ[s] += 1
                    picks.append((int(s), int(st["shared_row"][j]),
                                  int(st["shared_opts"][j])))
            out.append((fids, rows, picks))
        cur += occ
    return out, cur


@pytest.mark.parametrize("mix", [{"ids": {"zipf": 1.3}}, {"ids": "uniform"},
                                 {"ids": "uniform", "distinct": True}])
def test_window_plans_are_brute_force(mix):
    grid = Grid(CFG["population"])
    st = subtable(grid.n_filters, CFG["shared"])
    W, B = 3, 64
    (i, n), = traffic.window_ring(grid, dict(mix, window=W, batch=B,
                                             ring=1), 99)
    topics = traffic.topics("device/d{i}/x/n{n}/t", i.reshape(-1),
                            n.reshape(-1))
    index = GridIndex(CFG["population"]["template"], grid.ids, grid.nums)
    cur0 = np.arange(st["n_groups"], dtype=np.int64) * 3
    plans, cur = engine_ref.expected(index.match_many(topics), W, B, st,
                                     cur0, 4, 2)
    filters = [grid.filter(a, b) for a in range(grid.ids)
               for b in range(grid.nums)]
    want, want_cur = brute_plans(topics, filters, st, cur0, W, B, 4, 2)
    assert np.array_equal(cur, want_cur)
    for t, (fids, rows, picks) in enumerate(want):
        assert plans.fids[1][plans.fids[0] == t].tolist() == fids
        r = plans.rows
        assert list(zip(r[1][r[0] == t].tolist(),
                        r[2][r[0] == t].tolist())) == rows
        p = plans.picks
        sel = p[0] == t
        assert list(zip(p[1][sel].tolist(), p[2][sel].tolist(),
                        p[3][sel].tolist())) == picks
        assert plans.counts[t].tolist() == [len(fids), len(rows),
                                            len(picks)]


def as_readback(plans: engine_ref.Plans, W: int, B: int):
    """A program readback laid out as the CSR window (offsets, counts3,
    payload) that carries exactly these plans."""
    pay = [[] for _ in range(W)]
    offsets = np.zeros((W, B + 1), np.int64)
    for t in range(W * B):
        w, b = divmod(t, B)
        offsets[w, b] = len(pay[w])
        f = plans.fids[1][plans.fids[0] == t].tolist()
        sel = plans.rows[0] == t
        sp = plans.picks[0] == t
        pay[w] += f + plans.rows[1][sel].tolist() + plans.rows[2][sel] \
            .tolist() + plans.picks[1][sp].tolist() + plans.picks[2][sp] \
            .tolist() + plans.picks[3][sp].tolist()
        offsets[w, b + 1] = len(pay[w])
    P = max(map(len, pay))
    payload = np.full((W, P), -1, np.int64)
    for w in range(W):
        payload[w, :len(pay[w])] = pay[w]
    return SimpleNamespace(offsets=offsets,
                           counts3=plans.counts.reshape(W, B, 3),
                           payload=payload, row_overflow=np.zeros(W, bool),
                           overflow=plans.overflow.reshape(W, B),
                           dense=None)


def window(seed=3):
    grid = Grid(CFG["population"])
    st = subtable(grid.n_filters, CFG["shared"])
    W, B = 2, 48
    (i, n), = traffic.window_ring(grid, dict(ids={"zipf": 1.3}, window=W,
                                             batch=B, ring=1), seed)
    topics = traffic.topics("device/d{i}/x/n{n}/t", i.reshape(-1),
                            n.reshape(-1))
    index = GridIndex(CFG["population"]["template"], grid.ids, grid.nums)
    matched = index.match_many(topics)
    plans, _ = engine_ref.expected(matched, W, B, st,
                                   np.zeros(st["n_groups"], np.int64), 4, 2)
    return plans, matched, st, W, B


def test_compare_passes_the_same_plans_and_flags_each_change():
    plans, matched, st, W, B = window()
    rb = as_readback(plans, W, B)
    assert len(engine_ref.compare(plans, engine_ref.from_readback(rb, B),
                                  rb.offsets, W, B, rb.row_overflow)) == 0
    # one payload entry altered: that topic alone
    bad = as_readback(plans, W, B)
    bad.payload[1, bad.offsets[1, 5]] += 1
    got = engine_ref.compare(plans, engine_ref.from_readback(bad, B),
                             bad.offsets, W, B, bad.row_overflow)
    assert got.tolist() == [B + 5]
    # an offset moved
    bad = as_readback(plans, W, B)
    bad.offsets[0, 7] += 1
    assert 7 in engine_ref.compare(plans, engine_ref.from_readback(bad, B),
                                   bad.offsets, W, B, bad.row_overflow)
    # cursors not threaded: the picks of a later window differ
    later, _ = engine_ref.expected(matched, W, B, st,
                                   np.ones(st["n_groups"], np.int64), 4, 2)
    assert len(engine_ref.compare(later, plans)) > 0


def test_dense_readback_reads_the_same():
    plans, _m, _st, W, B = window(5)
    rb = as_readback(plans, W, B)
    MW, FC, SC = 2, 4, 2
    dense = [np.full((W, B, MW), -1), np.full((W, B, FC), -1),
             np.zeros((W, B, FC)), np.zeros((W, B)),
             np.full((W, B, SC), -1), np.full((W, B, SC), -1),
             np.zeros((W, B, SC))]
    for t in range(W * B):
        w, b = divmod(t, B)
        f = plans.fids[1][plans.fids[0] == t]
        dense[0][w, b, :len(f)] = f
        sel = plans.rows[0] == t
        dense[1][w, b, :sel.sum()] = plans.rows[1][sel]
        dense[2][w, b, :sel.sum()] = plans.rows[2][sel]
        dense[3][w, b] = sel.sum()
        sp = plans.picks[0] == t
        for k, col in ((4, 1), (5, 2), (6, 3)):
            dense[k][w, b, :sp.sum()] = plans.picks[col][sp]
    rb.row_overflow[:] = True
    rb.dense = tuple(dense)
    assert len(engine_ref.compare(plans, engine_ref.from_readback(rb, B),
                                  rb.offsets, W, B, rb.row_overflow)) == 0

