"""Port vs JAX reference: the inclusive int32 prefix sum (kernel 2's plain
path on the CPU) against prefix_sum_pallas in interpret mode. Exact."""

import numpy as np
import pytest
import torch

from emqx_tpu.ops.pallas_scan import prefix_sum_pallas
from emqx_tpu.ops.scan_ops import cumsum_blocked
from emqx_tpu_torch import device as D
from emqx_tpu_torch.ops import scan
from emqx_tpu_torch.ops.scan import (ScanPlan, prefix_sum, prefix_sum_ref,
                                     scan_plan)

# small CPU cases: one intra-op thread leaves the cores to the other
# test workers (torch would otherwise spin a thread per core)
torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 7, 128, 1000, 1024, 5000, 16384])
def test_equals_pallas(n):
    x = np.random.default_rng(n).integers(0, 3, n).astype(np.int32)
    want = np.asarray(prefix_sum_pallas(x, interpret=True))
    got = prefix_sum(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(cumsum_blocked(x)))


@pytest.mark.parametrize("shape", [(8, 3 * 1024 + 17), (300, 1), (50, 32),
                                   (50, 33)])
def test_rows_scan_independently(shape):
    x = np.random.default_rng(5).integers(-4, 9, shape).astype(np.int32)
    got = prefix_sum(torch.from_numpy(x)).numpy()
    for r in range(x.shape[0]):
        np.testing.assert_array_equal(
            got[r], np.asarray(prefix_sum_pallas(x[r], interpret=True)))


@pytest.mark.parametrize("n", [1025, 2 * 4096 + 3, 65536 + 17, 262144 + 5])
def test_long_1d_ragged_tail_equals_pallas(n):
    x = np.random.default_rng(n).integers(0, 3, n).astype(np.int32)
    want = np.asarray(prefix_sum_pallas(x, interpret=True))
    np.testing.assert_array_equal(prefix_sum(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("shape", [(40, 2), (40, 3), (40, 4), (40, 8),
                                   (40, 17), (40, 32), (40, 64),
                                   (8, 65536 + 17)])
def test_row_kinds_equal_pallas(shape):
    """The short (2-32), mid (64) and long-row kinds, row by row."""
    x = np.random.default_rng(shape[1]).integers(-4, 9, shape).astype(
        np.int32)
    got = prefix_sum(torch.from_numpy(x)).numpy()
    for r in range(x.shape[0]):
        np.testing.assert_array_equal(
            got[r], np.asarray(prefix_sum_pallas(x[r], interpret=True)))


# the cases of the card tests, then every shape the two main paths launch
# (shape-hash window: [1048576, 1] x3, the picks' [2097152] run ids and
# [312446, 8] cursor sums, [8, 131072]; a step's [262144] run ids; mesh:
# [1048576], NFA [524288, 2-32], [524288, 64], the exchange's stacked
# [32, 65536]); (R, n)
PLAN_SHAPES = [(1, 262144), (1, 1 << 20), (8, 65536), (8, 65536 + 17),
               (524288, 4), (8, 4), (1, 1), (1, 7), (1, 1000), (1, 1 << 24),
               (1 << 20, 1), (8, 131072), (524288, 2), (524288, 16),
               (524288, 32), (524288, 64), (32, 65536), (300, 33),
               (300, 1024), (300, 1025), (1000, 1025), (3, 10000),
               (1, 1 << 21), (312446, 8)]


def _covers(p, R, n):
    """The plan's one grid covers every element exactly once."""
    if p.path == "long":
        tile = scan.THREADS * p.items
        return (p.grid == R * p.tiles and p.tiles * tile >= n
                and (p.tiles - 1) * tile < n)
    return p.tiles == 1 and (p.grid - 1) * p.rows_per_block < R \
        <= p.grid * p.rows_per_block


@pytest.mark.parametrize("R,n", PLAN_SHAPES)
def test_launch_plan(R, n):
    p = scan_plan(R, n, True)
    assert isinstance(p, ScanPlan) and p.grid >= 1 and _covers(p, R, n)
    want = ("copy" if n == 1 else "short" if n <= 32 else
            "mid" if n <= 1024 else "long")
    assert p.path == want
    if p.path == "long" and p.tiles > 1:
        # one padded status word per (row, tile)
        assert p.state_words >= scan.STRIDE * R * p.tiles
    else:
        assert p.state_words == 0
    if p.path == "long" and R * -(-n // 1024) >= 2 * 132:
        assert p.grid >= 2 * 132                 # two tiles per SM or more
    if p.path == "long":
        # the smallest tile whose grid stays within a few waves
        assert p.grid <= scan.MAX_TILES or p.items == scan.LONG_ITEMS[-1]
        smaller = [i for i in scan.LONG_ITEMS if i < p.items]
        assert all(R * -(-n // (scan.THREADS * i)) > scan.MAX_TILES
                   for i in smaller)
    if p.path == "mid":
        assert p.items * 32 >= min(n, 64)        # a 64-wide row: one step
    # vector loads at the main path's aligned shapes; scalar where a row
    # starts off the 16-byte grid
    assert p.vec == {"copy": True, "short": True,
                     "mid": n % p.items == 0,
                     "long": n % 4 == 0 or R == 1}[p.path]
    assert not scan_plan(R, n, False).vec


def test_launch_plan_rank_scan():
    """A step's rank scan gets at least 128 tiles of at most 2048
    elements, one block each."""
    p = scan_plan(1, 262144, True)
    assert p.tiles >= 128 and scan.THREADS * p.items <= 2048
    assert (p.path, p.grid, p.vec) == ("long", p.tiles, True)


def test_launch_plan_window_pick_scans():
    """The shape-hash window's picks: the [2097152] rank scan gets tiles
    of at most 2048 elements within MAX_TILES, no more look-back words
    than its tiles; the [312446, 8] cursor sums take the short path, one
    row a thread, with no status words."""
    p = scan_plan(1, 1 << 21, True)
    assert (p.path, p.grid, p.vec) == ("long", p.tiles, True)
    assert scan.THREADS * p.items <= 2048 and p.tiles <= scan.MAX_TILES
    assert p.state_words == scan.STRIDE * p.tiles
    q = scan_plan(312446, 8, True)
    assert (q.path, q.items, q.state_words) == ("short", 8, 0)
    assert q.grid == -(-312446 // scan.THREADS)


def test_state_buffer_grows_and_wraps(monkeypatch):
    """One buffer per (device, stream): zeroed when made or grown, a new
    epoch per call, zeroed again when the epoch wraps."""
    monkeypatch.setattr(scan, "_STATES", {})
    dev = torch.device("cpu")
    a = scan._state(dev, 1, 10)
    assert a.epoch == 1 and a.words.numel() >= 10
    assert scan._state(dev, 1, 10) is a and a.epoch == 2
    assert scan._state(dev, 2, 10) is not a                # another stream
    big = scan._state(dev, 1, a.words.numel() + 1)
    assert big is not a and big.epoch == 1
    assert int(big.words.abs().sum()) == 0
    big.words.fill_(5)
    big.epoch = scan.EPOCH_WRAP - 1
    assert scan._state(dev, 1, 10) is big
    assert (big.epoch, int(big.words.abs().sum())) == (1, 0)


def test_launch_counts_by_shape():
    """A wrapper that passes its shape is counted by shape too; a reset
    clears both counts."""
    D.reset_launches()
    D.count_launch("prefix_sum", (8, 4))
    D.count_launch("prefix_sum", (8, 4))
    D.count_launch("prefix_sum", (262144,))
    D.count_launch("shape_match")
    assert D.LAUNCHES["prefix_sum"] == 3 and D.LAUNCHES["shape_match"] == 1
    assert D.LAUNCH_SHAPES["prefix_sum"] == {(8, 4): 2, (262144,): 1}
    D.reset_launches()
    assert D.LAUNCH_SHAPES["prefix_sum"] == {}
    assert set(D.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("fn", [prefix_sum, prefix_sum_ref])
def test_contract(fn):
    with pytest.raises(ValueError, match="2\\^24"):
        fn(torch.zeros((1 << 24) + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        fn(torch.zeros(4, dtype=torch.int64))
    assert fn(torch.zeros((3, 0), dtype=torch.int32)).shape == (3, 0)
