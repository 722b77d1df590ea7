"""The generators' sizes from the configuration files, and the traffic
mixes: the same seed gives the same inputs, every seed the same sizes."""

import json
import os

import numpy as np
import pytest

from benchmark import traffic
from benchmark.population import Grid, subtable

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind, name):
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def test_bench4_population_sizes():
    cfg = load("configs", "bench4-10m")
    grid = Grid(cfg["population"])
    assert grid.n_filters == 9_998_244
    st = subtable(grid.n_filters, cfg["shared"])
    assert st["n_groups"] == 312_446
    assert st["n_shared_filters"] == 4_999_122
    assert len(st["sub_row"]) == 9_998_244
    assert int(st["fs_start"][-1]) == 4_999_122
    assert len(st["shared_row"]) == 312_446 * 8
    # the last group holds the 2 filters left over
    assert int((st["fs_slot"] == 312_445).sum()) == 2


WINDOW_MIXES = ["w10m-zipf", "w10m-uniform"]


@pytest.mark.parametrize("name", WINDOW_MIXES)
def test_window_ring_is_the_seeds(name):
    grid = Grid(load("configs", "bench4-10m")["population"])
    mix = dict(load("traffic", name), batch=4096)
    a = traffic.window_ring(grid, mix, 2**31 + 11)
    b = traffic.window_ring(grid, mix, 2**31 + 11)
    c = traffic.window_ring(grid, mix, 7)
    assert len(a) == mix["ring"]
    for (ia, na), (ib, nb), (ic, nc) in zip(a, b, c):
        assert ia.shape == (mix["window"], 4096) == ic.shape
        assert np.array_equal(ia, ib) and np.array_equal(na, nb)
        assert not np.array_equal(ia, ic)
        assert ia.min() >= 0 and ia.max() < grid.ids
        assert na.min() >= 0 and na.max() < grid.nums


def shared_share(grid, i, n, F):
    return float(((i * grid.nums + n) < F * 50 // 100).mean())


def test_zipf_and_uniform_shares():
    grid = Grid(load("configs", "bench4-10m")["population"])
    F = grid.n_filters
    z = dict(load("traffic", "w10m-zipf"), batch=16384)
    u = dict(load("traffic", "w10m-uniform"), batch=16384)
    iz, nz = traffic.window_ring(grid, z, 5)[0]
    iu, nu = traffic.window_ring(grid, u, 5)[0]
    assert 0.89 < shared_share(grid, iz, nz, F) < 0.93
    assert 0.48 < shared_share(grid, iu, nu, F) < 0.52
    fid = (iu * grid.nums + nu).reshape(-1)
    assert len(np.unique(fid)) == fid.size          # distinct
    fz = (iz * grid.nums + nz).reshape(-1)
    assert len(np.unique(fz)) < fz.size             # repeats
