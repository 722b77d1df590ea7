"""The route window: ``emqx_tpu_torch.engine.RouteEngine.route_encoded``.

Set-up builds the engine once from the configuration's population
(``RouteEngine.from_columnar`` over the grid's words, interned through
the program's ``InternTable``, and the benchmark's subscriber table) and
a ring of windows from the seed, encoded as host numpy arrays as
columnar ingress would hand them: on a card in page-locked memory, as
the node's device engine stages its uploads (a pageable upload's copy
through the driver's staging buffers varied from process to process).
Every ring window routes once as the warm-up. The measured window then
routes ring windows back to back, one in flight, each timed from the
call until its readback is in host memory.

After the window the plain reference (``reference/engine_ref.py``)
works out, from the benchmark's own topic strings, the plans of a
sample of the routed windows drawn from the seed (and of the last one)
and the round-robin cursors after every window, and compares them with
the program's.
"""

from __future__ import annotations

import gc
import resource
import time

import numpy as np

from benchmark import common, traffic
from benchmark.population import Grid, subtable
from benchmark.reference import engine_ref
from benchmark.reference.matcher import GridIndex

SAMPLE = 3                 # routed windows checked besides the last
SLICE_WINDOWS = 24         # windows in the traced slice


def shape_levels(template: str):
    """(levels folded, trailing '#') of a filter template's shape."""
    lv = template.split("/")
    has_hash = lv[-1] == "#"
    return len(lv) - has_hash, has_hash


def encode_ring(ring: list, tmpl: str, intern, max_levels: int, pad: int,
                empty=np.empty):
    """Each ring window (i [W, B], n [W, B]) as the program's encoded
    arrays: topics [W, B, L] int32, lens [W, B] int32, dollar flags,
    message hashes, each made by ``empty(shape, dtype)``."""

    def full(shape, value, dtype):
        a = empty(shape, dtype)
        a.fill(value)
        return a

    levels = tmpl.split("/")
    if len(levels) > max_levels:
        raise ValueError(f"{tmpl}: deeper than {max_levels} levels")
    cols = {}
    out = []
    for i, n in ring:
        W, B = i.shape
        tp = full((W, B, max_levels), pad, np.int32)
        for k, lv in enumerate(levels):
            if "{i}" in lv or "{n}" in lv:
                key = "i" if "{i}" in lv else "n"
                if (k, key) not in cols:
                    top = int(max(r[0 if key == "i" else 1].max()
                                  for r in ring)) + 1
                    cols[(k, key)] = np.array(
                        [intern.lookup(lv.format(**{key: v}))
                         for v in range(top)], np.int32)
                tp[:, :, k] = cols[(k, key)][i if key == "i" else n]
            else:
                tp[:, :, k] = intern.lookup(lv)
        out.append((tp, full((W, B), len(levels), np.int32),
                    full((W, B), False, bool), full((W, B), 0, np.int32)))
    return out


class Faults:
    """The timed path broken underneath (``--fault``), to show that the
    comparison fails: ``stale_state`` hands every window the cursors the
    previous one started from; ``half_batch`` leaves the second half of
    every step's topics out (their lengths 0); ``altered_answer`` adds
    one to one payload entry of every window where it is read back;
    ``control`` judges, in the program's place, the reference's own
    plans with cursors that are not threaded between windows."""

    NAMES = ("stale_state", "half_batch", "altered_answer", "control")

    def __init__(self, name):
        if name is not None and name not in self.NAMES:
            raise ValueError(f"unknown fault {name!r} for this driver")
        self.name = name

    def call(self, eng, win):
        if self.name == "half_batch":
            tp, tl, dl, mh = win
            tl = tl.copy()
            tl[:, tl.shape[1] // 2:] = 0
            win = (tp, tl, dl, mh)
        cur = eng.cursors.clone() if self.name == "stale_state" else None
        rb = eng.route_encoded(*win)
        if cur is not None:
            eng.cursors = cur
        if self.name == "altered_answer" and rb.payload.shape[1]:
            rb.payload[0, 0] += 1
        return rb


def run(ctx) -> dict:
    import torch

    from emqx_tpu_torch import device as D
    from emqx_tpu_torch.engine import RouteEngine
    from emqx_tpu_torch.ops.fanout import SubTable
    from emqx_tpu_torch.ops.intern import HASH, PAD, PLUS, InternTable

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    eng_cfg = cfg["engine"]
    faults = Faults(ctx.fault)
    grid = Grid(cfg["population"])
    W, B = int(mix["window"]), int(mix["batch"])
    L = int(eng_cfg["max_levels"])
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_build = time.time()
    intern = InternTable()
    words, lens = grid.words(intern, PLUS, HASH, PAD, L)
    st = subtable(grid.n_filters, cfg["shared"])
    subs = SubTable(*(st[k] for k in SubTable._fields))
    eng = RouteEngine.from_columnar(
        words, lens, subs, intern, device=dev, batch=B, window=W,
        fanout_cap=int(eng_cfg["fanout_cap"]),
        slot_cap=int(eng_cfg["slot_cap"]),
        strategy=cfg["shared"]["strategy"], max_levels=L,
        payload_cap=int(eng_cfg["payload_cap"]))
    del words, lens
    sync()
    t_ring = time.time()
    ring_pts = traffic.window_ring(grid, mix, ctx.seed)

    def pinned(shape, dtype):
        return torch.empty(shape, dtype=torch.from_numpy(
            np.empty(0, dtype)).dtype, pin_memory=True).numpy()

    ring = encode_ring(ring_pts, mix["topic"], intern, L, PAD,
                       pinned if cuda else np.empty)
    t_warm = time.time()
    routed = []                              # ring index of every window
    for r, win in enumerate(ring):           # warm-up: every ring window
        faults.call(eng, win)
        routed.append(r)
    sync()
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    pick = traffic.rng_for(ctx.seed, 9)
    kept: dict = {}                          # routed index -> readback
    lat: list = []
    rec: dict = {"trace": None}
    sliced = False
    seconds = float(ctx.seconds)
    t_setup = time.time() - ctx.t_start
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        if ctx.trace and not sliced \
                and time.perf_counter() - t0 >= seconds / 3:
            sliced = True
            shapes0 = dict(D.LAUNCH_SHAPES["prefix_sum"])
            with common.profiled(True, rec, cuda):
                for j in range(SLICE_WINDOWS):
                    with torch.profiler.record_function("bench.route_encoded"):
                        faults.call(eng, ring[(k + j) % len(ring)])
                    routed.append((k + j) % len(ring))
            rec["launch_shapes"] = {
                s: c - shapes0.get(s, 0)
                for s, c in D.LAUNCH_SHAPES["prefix_sum"].items()
                if c - shapes0.get(s, 0)}
            k += SLICE_WINDOWS
            continue
        r = k % len(ring)
        ta = time.perf_counter()
        rb = faults.call(eng, ring[r])
        lat.append(time.perf_counter() - ta)
        idx = len(routed)
        routed.append(r)
        # a reservoir of SAMPLE windows drawn from the seed
        if len(kept) < SAMPLE:
            kept[idx] = rb
        else:
            j = int(pick.integers(0, len(lat)))
            if j < SAMPLE:
                kept.pop(sorted(kept)[j])
                kept[idx] = rb
        last = (idx, rb)
        k += 1
    elapsed = time.perf_counter() - t0
    cpu1 = resource.getrusage(resource.RUSAGE_SELF)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    cursors = eng.cursors.cpu().numpy().astype(np.int64)
    del eng, ring
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    kept[last[0]] = last[1]

    # --- the reference, after the window ---------------------------------
    index = GridIndex(cfg["population"]["template"], grid.ids, grid.nums)
    checks = common.Checks()
    fan_cap, slot_cap = int(eng_cfg["fanout_cap"]), int(eng_cfg["slot_cap"])
    G = st["n_groups"]
    occ, matched, ring_topics = [], [], []
    for i, n in ring_pts:
        ts = traffic.topics(mix["topic"], i.reshape(-1), n.reshape(-1))
        ring_topics.append(ts)
        cm, fids = index.match_many(ts)
        matched.append((cm, fids))
        f0 = st["fs_start"][fids]
        pos, _own = engine_ref.segments(f0, st["fs_start"][fids + 1] - f0)
        occ.append(np.bincount(st["fs_slot"][pos], minlength=G))
    cur = np.zeros(G, np.int64)
    wrong = checked = 0
    for idx, r in enumerate(routed):
        if idx in kept:
            want, _after = engine_ref.expected(
                matched[r], W, B, st, cur, fan_cap, slot_cap)
            if faults.name == "control":
                got, _c = engine_ref.expected(
                    matched[r], W, B, st, np.zeros(G, np.int64), fan_cap,
                    slot_cap)
                bad = engine_ref.compare(want, got)
            else:
                rb = kept[idx]
                got = engine_ref.from_readback(rb, B)
                bad = engine_ref.compare(want, got, rb.offsets, W, B,
                                         rb.row_overflow)
            wrong += len(bad)
            checked += W * B
        cur = cur + occ[r]
    if faults.name == "control":
        cursors = occ[routed[-1]].astype(np.int64)
    checks.add("topics_wrong", int(wrong), 0)
    checks.add("cursors_wrong", int((cursors != cur).sum()), 0)

    timed = len(lat)
    out = {
        "setup_s": t_setup,
        "attempted": timed * W * B,
        "failed": int(wrong),
        "checks": checks,
        "memory_peak_bytes": peak,
        "notes": {"windows": timed, "topics_checked": checked,
                  # the share of the window this process ran on the CPU
                  "cpu_share": (cpu1.ru_utime - cpu0.ru_utime
                                + cpu1.ru_stime - cpu0.ru_stime) / elapsed,
                  "window_s": elapsed,
                  "window_ms": {q: common.percentile(lat, q) * 1e3
                                for q in (50, 90, 99, 100)} if lat else None,
                  "setup_parts_s": {**ctx.marks,
                                    "start": t_build - ctx.t_start,
                                    "engine": t_ring - t_build,
                                    "ring": t_warm - t_ring,
                                    "warm": t_setup + ctx.t_start - t_warm}},
        "metrics": {
            "topic_matches_per_s": timed * W * B / elapsed
            if not ctx.trace else None,
            "window_p99_ms": common.percentile(lat, 99) * 1e3
            if lat else None},
    }
    if ctx.trace:
        lv, has_hash = shape_levels(cfg["population"]["template"])
        t_lv = len(mix["topic"].split("/"))
        compat = int(t_lv >= lv if has_hash else t_lv == lv)
        rec.update(windows=SLICE_WINDOWS, W=W, B=B, max_levels=L,
                   shape_levels=[lv], compatible=compat,
                   window_p99_ms=out["metrics"]["window_p99_ms"])
        out["record"] = rec
        tr = rec["trace"]
        if tr is not None:
            out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
            out["breakdown"] = {"device_ops": tr.top_device_ops(),
                                "idle_gaps": tr.gap_labels()}
    return out
