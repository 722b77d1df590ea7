"""The one traffic generator: every mix is a data file under ``traffic/``.

A mix draws grid points (i, n) of the configuration's population, each
becoming the topic ``topic`` (e.g. ``device/d{i}/x/n{n}/t``), which
matches exactly the filter (i, n). Keys of a mix:

- ``ids``: ``{"zipf": a}`` (``bench.py``'s ``device_topic_batch``: Zipf(a)
  minus one, clipped to the last id) or ``"uniform"``; ``nums`` is
  uniform. ``distinct``: every point of one window differs (drawn
  without replacement).
- Windows (``kind: "windows"``): ``window`` steps x ``batch`` topics a
  window, ``ring`` distinct windows made from the seed and cycled.

Every seed gives the same sizes; the seed changes only which points.
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for (seed, stream...); any whole seed."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) % (1 << 64), *stream])))


def draw(grid, mix: dict, rng, size: int):
    """``size`` grid points (i, n) as int64 arrays."""
    if mix.get("distinct"):
        fid = rng.choice(grid.n_filters, size=size, replace=False)
        return fid // grid.nums, fid % grid.nums
    ids = mix.get("ids", "uniform")
    if ids == "uniform":
        i = rng.integers(0, grid.ids, size)
    else:
        i = np.minimum(rng.zipf(float(ids["zipf"]), size) - 1, grid.ids - 1)
    n = rng.integers(0, grid.nums, size)
    return i.astype(np.int64), n.astype(np.int64)


def window_ring(grid, mix: dict, seed: int) -> list:
    """``ring`` windows, each (i [W, B], n [W, B])."""
    W, B = int(mix["window"]), int(mix["batch"])
    out = []
    for r in range(int(mix["ring"])):
        i, n = draw(grid, mix, rng_for(seed, 1, r), W * B)
        out.append((i.reshape(W, B), n.reshape(W, B)))
    return out


def topics(template: str, i, n) -> list:
    return [template.format(i=a, n=b) for a, b in
            zip(np.asarray(i).tolist(), np.asarray(n).tolist())]
