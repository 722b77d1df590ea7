"""The port's route window over a small Sparkplug B plant, held against
the benchmark's plain reference (``benchmark/reference/filterset_ref``
matching by the MQTT rules, ``engine_ref`` assembling the plans).

The plant is the ``spb3-5m-edges`` configuration's at 3 groups x 7 edge
nodes x 3 devices: the edge nodes' NCMD and DCMD filters, the hosts'
``spBv1.0/#``, the site filters, the 8-member historian group and the
``STATE`` filter. Windows of every message type go through
``RouteEngine.route_encoded`` and ``route``; plans compare as sets a
topic, picks in order, and the cursors after every window. The cases
cover NCMD's zero-level '#', a ``STATE`` topic whose fan-out overflows
the cap and is completed on the host, payload-capacity learning, and the
historian's cursor wrapping past 2^31.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.drivers.sparkplug import (build, encoder, slot_occurrences,
                                         wrap32)
from benchmark.reference import engine_ref
from benchmark.reference.filterset_ref import FilterSet
from benchmark.reference.matcher import mqtt_match
from benchmark.sparkplug import MESSAGE_TYPES, PAD, Plant

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind, name):
    with open(os.path.join(ROOT, "benchmark", kind, name + ".json")) as f:
        return json.load(f)


CFG = load("configs", "spb3-5m-edges")
MIX = load("traffic", "spb5m-report")
ENG = dict(CFG["engine"])
STATE = "spBv1.0/STATE/scada-primary"


def small_plant():
    return Plant(dict(CFG["population"], ids=7, nums=3, devices=3))


def every_topic(plant):
    """Every node and device topic of every message type, and STATE."""
    out = []
    for n in range(plant.nums):
        for i in range(plant.ids):
            for ty in MESSAGE_TYPES[:-1]:
                t = f"spBv1.0/g{n}/{ty}/e{i}"
                if ty.startswith("D"):
                    out += [f"{t}/d{d}" for d in range(plant.devices)]
                else:
                    out.append(t)
    return out + [STATE]


def reference(plant, fw, fl, topics):
    fs = FilterSet(fw, fl, plus=plant.plus, hash_=plant.hash, pad=PAD)
    words, lens = plant.encode(topics)
    return fs.match(words, lens)


def test_reference_matcher_is_brute_force():
    plant = small_plant()
    fw, fl = plant.filter_words()
    filters = [plant.filter_string(f) for f in range(plant.n_filters)]
    topics = every_topic(plant) + ["spBv1.0", "spBv1.0/g1", "spBv1.0/g1/NCMD"]
    counts, fids = reference(plant, fw, fl, topics)
    at = np.concatenate([[0], np.cumsum(counts)])
    for k, t in enumerate(topics):
        want = [f for f, flt in enumerate(filters) if mqtt_match(t, flt)]
        assert fids[at[k]:at[k + 1]].tolist() == want, t
    # NCMD's '#' matches zero levels; every topic matches spBv1.0/#
    ncmd = topics.index("spBv1.0/g2/NCMD/e5")
    assert "spBv1.0/g2/NCMD/e5/#" in [filters[f] for f in
                                      fids[at[ncmd]:at[ncmd + 1]]]
    assert (counts >= 1).all()


def route_windows(plant, eng, fw, fl, st, ring, start):
    """Route each ring window through route_encoded; the number of topics
    whose plans differ from the reference's and the windows whose
    cursors differ."""
    encode = encoder(plant, eng.intern, ENG["max_levels"])
    fs = FilterSet(fw, fl, plus=plant.plus, hash_=plant.hash, pad=PAD)
    W, B = ring[0][1].shape
    cur = np.asarray(start, np.int64)
    wrong = bad_cursors = 0
    for tw, tl in ring:
        rb = eng.route_encoded(*encode(tw, tl))
        m = fs.match(tw.reshape(W * B, -1), tl.reshape(-1))
        want, after = engine_ref.expected(m, W, B, st, cur, ENG["fanout_cap"],
                                          ENG["slot_cap"])
        got = engine_ref.from_readback(rb, B)
        wrong += len(engine_ref.compare(want, got, rb.offsets, W, B,
                                        rb.row_overflow))
        cur = wrap32(cur + slot_occurrences(m, st, ENG["slot_cap"], 1))
        assert np.array_equal(wrap32(after), cur)
        bad_cursors += int((eng.cursors.numpy() != cur).any())
    return wrong, bad_cursors


@pytest.mark.parametrize("payload_cap", [None, 1 << 14])
def test_windows_of_every_type_match_the_reference(payload_cap):
    """Windows with every message type at equal shares; with the default
    payload class the first window overflows it and is read dense, and
    the engine learns a class that fits."""
    plant = small_plant()
    eng, fw, fl, st = build(plant, ENG, device="cpu", batch=64, window=3,
                            payload_cap=payload_cap)
    mix = dict(MIX, window=3, batch=64, ring=4, message_types={
        t: 1 / 8 for t in MESSAGE_TYPES[:-1]})
    ring = plant.ring(mix, 2**31 + 17, traffic.rng_for)
    start = plant.start_cursors(2**31 + 17, traffic.rng_for)
    eng.cursors = torch.tensor(start.astype(np.int32))
    assert route_windows(plant, eng, fw, fl, st, ring, start) == (0, 0)
    assert eng.stats["windows"] == 4
    assert eng.stats["dense_windows"] == (1 if payload_cap is None else 0)
    # ~17-20 entries a topic: 2-3 filters, 6-7 rows, one pick
    per_topic = eng.stats["csr_entries"] / (4 * 3 * 64)
    assert 17 <= per_topic <= 20
    assert eng.stats["d2h_bytes"] > 4 * eng.stats["csr_entries"]


def test_historian_cursor_wraps_past_2_31():
    """The hot slot's cursor starts at 2^31 - 5 and every topic picks
    from it: the picks and cursors agree with the reference's across the
    int32 wrap (8 members: 2^32 is a multiple of the group's size)."""
    plant = small_plant()
    eng, fw, fl, st = build(plant, ENG, device="cpu", batch=4, window=2,
                            payload_cap=1 << 10)
    start = np.array([(1 << 31) - 5], np.int64)
    eng.cursors = torch.tensor(start.astype(np.int32))
    mix = dict(MIX, window=2, batch=4, ring=3)
    ring = plant.ring(mix, 9, traffic.rng_for)
    assert route_windows(plant, eng, fw, fl, st, ring, start) == (0, 0)
    assert int(eng.cursors[0]) == -(1 << 31) + 24 - 5


def test_route_completes_an_overflowing_state_topic_on_the_host():
    """route() over topic strings: the STATE topic's fan-out (every edge
    node and the primary host) overflows fanout_cap, so the host
    completes its plan; it keeps the historian member the window picked,
    so the picks and cursors run on as the reference threads them."""
    plant = small_plant()
    eng, fw, fl, st = build(plant, ENG, device="cpu", batch=16, window=2)
    topics = every_topic(plant)
    rng = np.random.default_rng(5)
    topics = [topics[k] for k in rng.permutation(len(topics))[:40]]
    topics = topics[:13] + [STATE] + topics[13:] + ["spBv1.0/g0/NCMD/e3"]
    start = np.array([123457], np.int64)
    eng.cursors = torch.tensor(start.astype(np.int32))
    plans = eng.route(topics)
    assert eng.stats["host_messages"] == 1
    assert [p.host for p in plans].index(True) == 13
    W, B = 2, 16
    cur = start
    for s in range(0, len(topics), W * B):
        chunk = topics[s:s + W * B]
        pad = chunk + ["spBv1.0/g0/NDATA/e0"] * (W * B - len(chunk))
        m = reference(plant, fw, fl, pad)
        n = len(chunk)
        m = (np.where(np.arange(W * B) < n, m[0], 0),
             m[1][:int(m[0][:n].sum())])
        want, _after = engine_ref.expected(m, W, B, st, cur,
                                           ENG["fanout_cap"], ENG["slot_cap"])
        for k, plan in enumerate(plans[s:s + n]):
            sel = want.fids[0] == k
            assert sorted(plan.fids.tolist()) == want.fids[1][sel].tolist()
            sel = want.rows[0] == k
            assert sorted(zip(plan.rows.tolist(), plan.opts.tolist())) == \
                sorted(zip(want.rows[1][sel].tolist(),
                           want.rows[2][sel].tolist()))
            sel = want.picks[0] == k
            assert list(zip(plan.shared_slots.tolist(),
                            plan.shared_rows.tolist(),
                            plan.shared_opts.tolist())) == list(zip(
                                *(c[sel].tolist() for c in want.picks[1:])))
        cur = wrap32(cur + slot_occurrences(m, st, ENG["slot_cap"], 1))
    assert eng.cursors.numpy().tolist() == cur.tolist()
    state = plans[13]
    # every edge node and the primary host, and the 4 hosts on spBv1.0/#
    assert len(state.rows) == plant.n_edge + 1 + 4 > ENG["fanout_cap"]
