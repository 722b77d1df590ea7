"""Port vs JAX reference: the trie-NFA matcher (``ops/match.match_batch``)
and the trie route step (``models/router_engine.route_step``).

Same tables (built by the JAX package), same encoded topics, exact
equality of matches, counts and overflow — including '$' topics,
zero-level '#' ("sport/#" matches "sport"), lens == 0 padding rows, and
frontier and match-cap overflow.
"""

import random

import numpy as np
import pytest
import torch

from emqx_tpu.models import router_engine as JR
from emqx_tpu.ops import match as JM
from emqx_tpu.ops.fanout import build_subtable as j_build_subtable
from emqx_tpu.ops.trie import build_tables as j_build_tables
from emqx_tpu_torch.convert import router_tables_from_numpy
from emqx_tpu_torch.models import router_engine as TR
from emqx_tpu_torch.ops import match as TM
from emqx_tpu_torch.ops.shared import STRATEGY_RANDOM, STRATEGY_ROUND_ROBIN
from emqx_tpu_torch.ops.trie import build_tables
from emqx_tpu_torch.utils import topic as T
from tests.test_torch_trie import encode
from tests.test_trie_match import rand_filter, rand_topic

torch.set_num_threads(1)


def fixture(seed, n_topics=96, L=8):
    rng = random.Random(seed)
    filters = sorted({rand_filter(rng) for _ in range(rng.randint(40, 200))}
                     | {"sport/#", "$sys/#", "#", "+/+", "$sys/+/x", "a/#",
                        "a/+", "+/b", "a/b"})
    intern, words, lens = encode(filters, L)
    topics = [rand_topic(rng) for _ in range(n_topics)]
    topics += ["sport", "sport/a", "$sys/a/x", "$sys", "a/b/c/a/b/c/a/b",
               "a/b"]
    enc, tl, dol, _ = TM.encode_topics(intern, [T.tokens(t) for t in topics],
                                       L)
    tl[:4] = 0                         # padding rows
    return filters, j_build_tables(words, lens), enc, tl, dol


def as_torch(tables):
    return router_tables_from_numpy(tables, j_build_subtable(1, {}, {}, {}),
                                    "cpu").trie


@pytest.mark.parametrize("caps", [(16, 64), (2, 64), (16, 3), (1, 1)])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_match_batch_equals_jax(seed, caps):
    F, M = caps
    _filters, tables, enc, tl, dol = fixture(seed)
    want = JM.match_batch(tables, enc, tl, dol, frontier_cap=F, match_cap=M)
    got = TM.match_batch(as_torch(tables), torch.from_numpy(enc),
                         torch.from_numpy(tl), torch.from_numpy(dol),
                         frontier_cap=F, match_cap=M)
    for name in ("matches", "counts", "overflow"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, name)
    if caps in ((2, 64), (16, 3), (1, 1)):
        assert got.overflow.any()
    assert not got.matches[:4].ge(0).any()      # padding rows match nothing


def test_match_semantics():
    filters = ["sport/#", "#", "+", "$sys/#", "a/+/c"]
    intern, words, lens = encode(filters)
    topics = ["sport", "$sys/x", "$sys", "a/b/c", "q"]
    enc, tl, dol, _ = TM.encode_topics(intern, [T.tokens(t) for t in topics],
                                       8)
    mr = TM.match_batch(as_torch(build_tables(words, lens)),
                        *map(torch.from_numpy, (enc, tl, dol)))
    got = [sorted(filters[i] for i in row if i >= 0)
           for row in mr.matches.tolist()]
    want = [sorted(f for f in filters if T.match(t, f)) for t in topics]
    assert got == want
    assert "sport/#" in got[0] and "#" not in got[1]


def test_edge_lookup_all_lanes():
    _f, tables, *_ = fixture(5)
    tt = as_torch(tables)
    parent = torch.from_numpy(np.asarray(tables.slot_parent))
    word = torch.from_numpy(np.asarray(tables.slot_word))
    occupied = parent >= 0
    child = TM.edge_lookup(tt, parent, word)
    want = JM.edge_lookup(tables, np.asarray(tables.slot_parent),
                          np.asarray(tables.slot_word))
    np.testing.assert_array_equal(child.numpy(), np.asarray(want))
    assert torch.equal(child[occupied],
                       torch.from_numpy(np.asarray(tables.slot_child))[
                           occupied])


@pytest.mark.parametrize("strategy", [STRATEGY_ROUND_ROBIN, STRATEGY_RANDOM])
def test_route_step_equals_jax(strategy):
    filters, tables, enc, tl, dol = fixture(7)
    r = np.random.RandomState(7)
    Fn = len(filters)
    normal = {f: [(int(r.randint(500)), int(r.randint(64)))
                  for _ in range(r.randint(0, 3))] for f in range(Fn)}
    G = 5
    fslots = {f: [int(r.randint(G))] for f in range(Fn) if r.rand() < 0.3}
    shared = {g: [(900 + 4 * g + j, 1) for j in range(g % 3 + 1)]
              for g in range(G)}
    subs = j_build_subtable(Fn, normal, fslots, shared, slot_cap=G)
    cursors = r.randint(0, 5, G).astype(np.int32)
    mh = r.randint(0, 1 << 30, len(tl)).astype(np.int32)
    kw = dict(frontier_cap=8, match_cap=16, fanout_cap=8, slot_cap=4)
    want = JR.route_step(JR.RouterTables(trie=tables, subs=subs), cursors,
                         enc, tl, dol, mh, np.int32(strategy), **kw)
    pt = router_tables_from_numpy(tables, subs, "cpu")
    got = TR.route_step(pt, *map(torch.from_numpy, (cursors, enc, tl, dol,
                                                    mh)), strategy, **kw)
    for name in JR.RouteResult._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
