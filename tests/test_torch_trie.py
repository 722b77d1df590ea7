"""Port vs JAX reference: the trie compiler (``ops/trie.build_tables``).

Random filter sets with '+', '#', '$'-rooted and empty levels, built by
both packages from the same interned words: every plane equal, exact.
"""

import random

import numpy as np
import pytest

from emqx_tpu.ops import intern as JI
from emqx_tpu.ops import trie as JTR
from emqx_tpu_torch.ops import trie as TTR
from emqx_tpu_torch.ops.intern import InternTable
from emqx_tpu_torch.utils import topic as T
from tests.test_trie_match import rand_filter

PLANES = ("slot_parent", "slot_word", "slot_child", "plus_child",
          "hash_child", "node_filter", "num_nodes", "num_edges")


def encode(filters, L=8):
    intern = InternTable()
    words = np.full((len(filters), L), JI.PAD, np.int32)
    lens = np.zeros(len(filters), np.int64)
    for i, f in enumerate(filters):
        ids = intern.encode_filter(T.tokens(f))
        words[i, :len(ids)] = ids
        lens[i] = len(ids)
    return intern, words, lens


def assert_same(got, want):
    for k in PLANES:
        g, w = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, k)
    assert got.cover is None


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_build_tables_equals_jax(seed):
    rng = random.Random(seed)
    filters = sorted({rand_filter(rng) for _ in range(rng.randint(20, 300))})
    filters += ["$sys/+", "$sys/#", "#", "+"]
    filters = sorted(set(filters))
    _, words, lens = encode(filters)
    assert_same(TTR.build_tables(words, lens), JTR.build_tables(words, lens))


@pytest.mark.parametrize("kw", [
    {"node_capacity": 1024, "slot_capacity": 4096},
    {"filter_ids": "reversed"},
    {"slot_capacity": 16},          # forces the capacity-doubling retry
])
def test_build_options_equal_jax(kw):
    rng = random.Random(9)
    filters = sorted({rand_filter(rng) for _ in range(200)})
    _, words, lens = encode(filters)
    if kw.get("filter_ids") == "reversed":
        kw = {"filter_ids": np.arange(len(filters))[::-1] + 5}
    assert_same(TTR.build_tables(words, lens, **kw),
                JTR.build_tables(words, lens, **kw))


def test_empty_and_duplicates():
    empty = np.zeros((0, 4), np.int32), np.zeros(0, np.int64)
    assert_same(TTR.build_tables(*empty), JTR.build_tables(*empty))
    _, words, lens = encode(["a/b", "a/b"])
    for mod in (TTR, JTR):
        with pytest.raises(ValueError, match="duplicate"):
            mod.build_tables(words, lens)


def test_mix_hash_equals_jax():
    r = np.random.RandomState(0)
    p = np.concatenate([[-1, 0, 2**31 - 1], r.randint(-1, 2**31 - 1, 500)])
    w = r.randint(0, 2**31 - 1, p.shape[0])
    np.testing.assert_array_equal(TTR.mix_hash(p.astype(np.int32), w),
                                  JTR.mix_hash(p.astype(np.int32), w))
