"""Subscription populations and publish batches for the port's drives.

``device_filter_set``, ``device_topic_batch`` and ``bench_subtable`` are
the port's own copies of the bench population of ``bench.py``
(:417-512): the reference harness's ``device/{id}/+/{num}/#`` filter set
(emqx_broker_bench.erl:25-34) scaled to ``subs``, Zipf-skewed publish
batches in which every topic matches exactly one filter
(fid = id * nums + num), and one subscriber per filter with the first
``shared_pct`` percent of filters also in 16-filter, 8-member ``$share``
groups. ``pattern_population`` is the six-pattern multi-shape population
of ``tests/test_pallas.py`` (:40-76) with scalable word ranges.
``cover_heavy_filters`` and ``concretize`` are copies of the reference
bench populations' (``tools/workloads.py:51-108``): umbrella filters
(``fleet/#``) that cover a fraction of narrower subscriptions, and one
concrete topic per filter.
"""

from __future__ import annotations

import numpy as np

from emqx_tpu_torch.ops import intern as I
from emqx_tpu_torch.ops.fanout import SubTable
from emqx_tpu_torch.ops.match import encode_topics


def device_filter_set(subs: int) -> dict:
    """device/{id}/+/{num}/# scaled to ~`subs` filters."""
    ids = max(64, int(np.sqrt(subs)))
    nums = max(1, subs // ids)
    F = ids * nums
    intern = I.InternTable()
    wd = intern.intern("device")
    id_ids = np.array([intern.intern(f"d{i}") for i in range(ids)], np.int32)
    num_ids = np.array([intern.intern(f"n{n}") for n in range(nums)],
                       np.int32)
    rows = np.zeros((F, 8), np.int32)
    lens = np.full(F, 5, np.int64)
    rows[:, 0] = wd
    rows[:, 1] = np.repeat(id_ids, nums)
    rows[:, 2] = I.PLUS
    rows[:, 3] = np.tile(num_ids, ids)
    rows[:, 4] = I.HASH
    return {"intern": intern, "rows": rows, "lens": lens, "ids": ids,
            "nums": nums, "id_ids": id_ids, "num_ids": num_ids, "wd": wd}


def device_topic_batch(fs: dict, rng, B: int):
    """One Zipf-skewed publish batch (encoded [B, 8] and lens [B]); every
    topic matches exactly one filter of device_filter_set."""
    intern = fs["intern"]
    x = intern.intern("x")
    tail = intern.intern("t")
    zipf = np.minimum(rng.zipf(1.3, size=B) - 1, fs["ids"] - 1)
    tp = np.zeros((B, 8), np.int32)
    tp[:, 0] = fs["wd"]
    tp[:, 1] = fs["id_ids"][zipf]
    tp[:, 2] = x
    tp[:, 3] = fs["num_ids"][rng.randint(0, fs["nums"], B)]
    tp[:, 4] = tail
    return tp, np.full(B, 5, np.int32)


def expected_fids(fs: dict, tp: np.ndarray) -> np.ndarray:
    """The one filter each device_topic_batch topic matches: id*nums+num
    (the id and num words were interned consecutively)."""
    return ((tp[:, 1] - fs["id_ids"][0]).astype(np.int64) * fs["nums"]
            + (tp[:, 3] - fs["num_ids"][0])).astype(np.int32)


def topic_strings(fs: dict, tp: np.ndarray, lens: np.ndarray) -> list:
    """Encoded topics back to their strings."""
    w = fs["intern"].word
    return ["/".join(w(int(x)) for x in row[:n]) for row, n in zip(tp, lens)]


def bench_subtable(F: int, shared_pct: int):
    """One subscriber per filter; the first shared_pct% of filters also in
    16-filter/8-member $share groups. Returns (SubTable of numpy arrays,
    n_groups)."""
    n_shared_filters = F * shared_pct // 100
    sub_start = np.arange(F + 1, dtype=np.int32)
    sub_row = np.arange(F, dtype=np.int32)
    sub_opts = np.ones(F, np.int8)
    group_of = np.arange(n_shared_filters, dtype=np.int32) // 16
    n_groups = max(1, int(group_of.max(initial=0)) + 1)
    fs_start = np.zeros(F + 1, np.int32)
    fs_start[1:n_shared_filters + 1] = 1
    np.cumsum(fs_start, out=fs_start)
    fs_slot = group_of if n_shared_filters else np.full(1, -1, np.int32)
    shared_start = np.arange(n_groups + 1, dtype=np.int32) * 8
    shared_row = F + np.arange(n_groups * 8, dtype=np.int32)
    shared_opts = np.ones(n_groups * 8, np.int8)
    return SubTable(sub_start, sub_row, sub_opts, fs_start, fs_slot,
                    shared_start, shared_row, shared_opts), n_groups


def pattern_population(rng, n_filters: int, n_topics: int, L: int = 8,
                       scale: int = 1):
    """The six filter patterns (incl. '$sys/...' and bare '#') and five
    topic patterns; word ranges grow with `scale` so large populations
    stay unique. rng: numpy Generator. Returns (intern, filter words
    [F, L], filter lens [F], topics [T, L], lens [T], is_dollar [T])."""
    intern = I.InternTable()
    r = rng.integers
    patterns = [
        lambda: [f"d{r(0, 80 * scale)}", "+", f"n{r(0, 100 * scale)}", "#"],
        lambda: [f"a{r(0, 400 * scale)}", "+"],
        lambda: [f"e{r(0, 80 * scale)}", f"x{r(0, 80 * scale)}"],
        lambda: ["+", f"y{r(0, 200 * scale)}"],
        lambda: ["$sys", f"s{r(0, 50 * scale)}"],
        lambda: ["#"],
    ]
    seen, filters = set(), []
    while len(filters) < n_filters:
        ws = patterns[r(0, len(patterns))]()
        k = "/".join(ws)
        if k not in seen:
            seen.add(k)
            filters.append(ws)
    words = np.full((len(filters), L), I.PAD, np.int32)
    flens = np.zeros(len(filters), np.int64)
    for i, ws in enumerate(filters):
        flens[i] = len(ws)
        words[i, :len(ws)] = intern.encode_filter(ws)
    tpats = [
        lambda: [f"d{r(0, 80 * scale)}", "m", f"n{r(0, 100 * scale)}", "t"],
        lambda: [f"a{r(0, 400 * scale)}", "z"],
        lambda: [f"e{r(0, 80 * scale)}", f"x{r(0, 80 * scale)}"],
        lambda: ["q", f"y{r(0, 200 * scale)}"],
        lambda: ["$sys", f"s{r(0, 50 * scale)}"],
    ]
    topics = [tpats[r(0, len(tpats))]() for _ in range(n_topics)]
    t, tl, dol, _ = encode_topics(intern, topics, L)
    return intern, words, flens, t, tl, dol


def mesh_population(subs: int, level_cap: int = 16) -> dict:
    """The mesh phase's population: ``device_filter_set`` as filter
    strings ``device/d{id}/+/n{num}/#`` with words padded to
    ``level_cap`` levels, and one normal subscriber per filter whose
    session id is the filter's population fid (id * nums + num), packed
    opts 1. No shared groups: a shared hit sends its window to the host
    gather."""
    fs = device_filter_set(subs)
    F = fs["ids"] * fs["nums"]
    words = np.full((F, level_cap), I.PAD, np.int32)
    words[:, :fs["rows"].shape[1]] = fs["rows"]
    filters = [f"device/d{i}/+/n{n}/#" for i in range(fs["ids"])
               for n in range(fs["nums"])]
    return {**fs, "F": F, "filters": filters, "words": words,
            "sub_start": np.arange(F + 1, dtype=np.int64),
            "sub_row": np.arange(F, dtype=np.int32),
            "sub_opts": np.ones(F, np.int8)}


def mesh_topic_batch(pop: dict, rng, B: int, level_cap: int = 16):
    """One Zipf-skewed window for the mesh population: encoded [B,
    level_cap] topics, lens [B], and each topic's one expected session
    (= its filter's population fid)."""
    tp, tl = device_topic_batch(pop, rng, B)
    wide = np.full((B, level_cap), I.PAD, np.int32)
    wide[:, :tp.shape[1]] = tp
    return wide, tl, expected_fids(pop, tp)


def cover_heavy_filters(n: int, *, cover_ratio: float = 0.5,
                        zipf_a: float = 1.4, max_depth: int = 8,
                        vocab: int = 97, seed: int = 7) -> list:
    """Cover-heavy population: ~`cover_ratio` of the `n` filters are
    covered by a broader umbrella filter in the set. Roots are
    trailing-'#' umbrellas (every third, at a Zipf-drawn depth) and
    standalone literal filters; covered filters extend an umbrella's
    prefix by 1-3 levels, with '+' levels by a bitmask of their index.
    Deterministic per (n, knobs, seed)."""
    if not 0 <= cover_ratio < 1:
        raise ValueError(f"cover_ratio {cover_ratio} outside [0, 1)")
    rng = np.random.RandomState(seed)
    n_cov = int(round(n * cover_ratio))
    n_roots = max(1, n - n_cov)
    filters = []
    umbrellas = []
    depths = 1 + (rng.zipf(zipf_a, size=n_roots) - 1) % max_depth
    for i in range(n_roots):
        depth = int(depths[i])
        levels = [f"d{i % vocab}"] + [f"u{i}l{li}"
                                      for li in range(1, depth)]
        if i % 3 == 0:
            umbrellas.append(levels)
            filters.append("/".join(levels) + "/#")
        else:
            filters.append("/".join(levels) + f"/t{i}")
    if not umbrellas:                  # tiny n: keep the ratio honest
        umbrellas.append(["d0"])
        filters[0] = "d0/#"
    for j in range(n_cov):
        base = umbrellas[j % len(umbrellas)]
        tail = []
        for e in range(j % 3):
            tail.append("+" if (j >> e) & 1 else f"m{j}e{e}")
        tail.append(f"c{j}")
        filters.append("/".join(base + tail))
    return filters


def concretize(f: str, salt: str = "x") -> str:
    """One concrete topic matching `f`: '+' levels become a positional
    literal, and a trailing '#' one extra concrete level."""
    return "/".join(p if p not in ("+", "#") else f"{salt}{i}"
                    for i, p in enumerate(f.split("/")))
