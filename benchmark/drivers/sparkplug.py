"""The route window over a Sparkplug B plant fleet:
``emqx_tpu_torch.engine.RouteEngine.route_encoded``.

Set-up keeps the process's host pages (``keep_host_pages``), builds the
plant of the configuration (``benchmark/sparkplug.py``:
every edge node's command filters, the hosts' ``spBv1.0/#``, the groups'
site filters, one shared historian group), maps its vocabulary into the
program's ``InternTable`` (filter words interned, topic words looked up
as the program encodes a PUBLISH), builds the engine once with
``RouteEngine.from_columnar``, sets the shared slots' round-robin
cursors to the start the mix draws from the seed, and makes a ring of
windows from the seed in page-locked host memory. Every ring window
routes once as the warm-up; the measured window then routes ring
windows back to back, one in flight, each timed from the call until its
readback is in host memory.

After the window the plain reference (``reference/filterset_ref.py``
matches every ring topic by the MQTT rules, ``reference/engine_ref.py``
assembles the plans) works out the plans of a sample of the routed
windows drawn from the seed, and of the last one, with the cursors
threaded through every routed window as the program's int32 (wrapping
modulo 2^32), and compares them with the program's: filters and rows as
sets a topic, picks in order, and the cursors after every window.
"""

from __future__ import annotations

import ctypes
import gc
import resource
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark import common, traffic
from benchmark.drivers.route_engine import Faults
from benchmark.reference import engine_ref
from benchmark.reference.filterset_ref import FilterSet
from benchmark.sparkplug import PAD as WORD_PAD
from benchmark.sparkplug import Plant

SAMPLE = 3                 # routed windows checked besides the last
SLICE_WINDOWS = 24         # windows in the traced slice
COUNTERS = ("d2h_bytes", "csr_entries")


def keep_host_pages():
    """Serve every host allocation of this process from glibc's heap and
    never give the heap back (``mallopt``: no mmap'd chunks, no trim).
    An array past glibc's largest mmap threshold (32 MiB), such as a
    pageable ~72 MB readback payload, is otherwise mapped fresh and
    faulted in page by page on every window, at a rate set by the host's
    other tenants; kept, the warm-up faults its pages in once and every
    later window reuses them."""
    libc = ctypes.CDLL("libc.so.6")
    m_trim_threshold, m_mmap_max = -1, -4
    ok = libc.mallopt(m_mmap_max, 0) and libc.mallopt(m_trim_threshold,
                                                      (1 << 31) - 1)
    if not ok:
        raise OSError("mallopt refused the heap settings")


def wrap32(x):
    """int64 values as the int32 they wrap to."""
    return (np.asarray(x, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)


def shapes_of(words: np.ndarray, lens: np.ndarray, plus: int, hash_: int):
    """(levels before any '#', ends in '#', first level '+') of each
    distinct shape of a filter set."""
    has_hash = words[np.arange(len(lens)), lens - 1] == hash_
    slen = lens - has_hash
    mask = np.zeros(len(lens), np.int64)
    for k in range(words.shape[1]):
        mask |= ((words[:, k] == plus) & (k < slen)).astype(np.int64) << k
    sig = np.unique((slen << 32) | (has_hash.astype(np.int64) << 31) | mask)
    return [(int(s >> 32), bool(s >> 31 & 1), bool(s & 1)) for s in sig]


def compatible(shapes: list, lens: np.ndarray, dollar: np.ndarray):
    """Each topic's count of shapes it can match (kernel 1's
    compatibility: levels, '#', and no wildcard root for '$')."""
    n = np.zeros(len(lens), np.int64)
    for slen, has_hash, plus_root in shapes:
        ok = (lens >= slen) if has_hash else (lens == slen)
        wild = plus_root or (has_hash and slen == 0)
        n += ok & (lens > 0) & ~(dollar & wild)
    return n


def slot_occurrences(matched, st: dict, slot_cap: int, n_slots: int):
    """Each shared slot's picks in a window: every matched filter's slots
    in order, at most ``slot_cap`` a topic."""
    cm, fids = matched
    owner = np.repeat(np.arange(len(cm)), cm)
    f0 = st["fs_start"][fids]
    pos, own = engine_ref.segments(f0, st["fs_start"][fids + 1] - f0)
    s_owner = owner[own]
    keep = engine_ref.run_ranks(s_owner) < slot_cap
    return np.bincount(st["fs_slot"][pos][keep], minlength=n_slots)


def build(plant: Plant, eng_cfg: dict, *, device, batch: int,
          window: int, payload_cap=None):
    """The program's engine over the plant (``RouteEngine.from_columnar``,
    the plant's filter words interned into its ``InternTable``), the
    plant's filter words and levels, and its subscriber table's arrays."""
    from emqx_tpu_torch.engine import RouteEngine
    from emqx_tpu_torch.ops.fanout import SubTable
    from emqx_tpu_torch.ops.intern import PAD, InternTable

    L = int(eng_cfg["max_levels"])
    vocab = plant.vocab
    fw, fl = plant.filter_words()
    if fw.shape[1] > L:
        raise ValueError(f"filters of {fw.shape[1]} levels > {L}")
    intern = InternTable()
    # the program's ids of the plant's words; the last entry maps its pad
    flut = np.full(len(vocab) + 1, PAD, np.int32)
    used = np.bincount(fw[fw != WORD_PAD], minlength=len(vocab))
    for u in np.flatnonzero(used).tolist():
        flut[u] = intern.intern(vocab[u])
    words = np.full((len(fl), L), PAD, np.int32)
    words[:, :fw.shape[1]] = flut[fw]
    st = plant.subtable()
    eng = RouteEngine.from_columnar(
        words, fl, SubTable(*(st[k] for k in SubTable._fields)), intern,
        device=device, batch=batch, window=window,
        fanout_cap=int(eng_cfg["fanout_cap"]),
        slot_cap=int(eng_cfg["slot_cap"]),
        strategy=plant.shared["strategy"], max_levels=L,
        payload_cap=payload_cap)
    return eng, fw, fl, st


def encoder(plant: Plant, intern, max_levels: int):
    """``encode(words, lens, empty)``: plant topics ([..., depth] word
    ids, [...] levels) as the program's encoded arrays (topics [..., L]
    int32, lens, dollar flags, message hashes, each made by
    ``empty(shape, dtype)``), topic words looked up in the program's
    intern table as it encodes a PUBLISH."""
    from emqx_tpu_torch.ops.intern import PAD

    vocab = plant.vocab
    tlut = np.array([intern.lookup(w) for w in vocab] + [PAD], np.int32)
    dollar_word = np.array([w.startswith("$") for w in vocab] + [False])

    def encode(tw, tl, empty=np.empty):
        shape = np.shape(tl)
        tp = empty(shape + (max_levels,), np.int32)
        tp.fill(PAD)
        tp[..., :tw.shape[-1]] = tlut[tw]
        lens, dl, mh = (empty(shape, t) for t in (np.int32, bool, np.int32))
        lens[...] = tl
        dl[...] = dollar_word[tw[..., 0]]
        mh.fill(0)
        return tp, lens, dl, mh

    return encode


def run(ctx) -> dict:
    import torch

    from emqx_tpu_torch import device as D

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    eng_cfg = cfg["engine"]
    faults = Faults(ctx.fault)
    plant = Plant(cfg["population"])
    W, B = int(mix["window"]), int(mix["batch"])
    L = int(eng_cfg["max_levels"])
    fan_cap, slot_cap = int(eng_cfg["fanout_cap"]), int(eng_cfg["slot_cap"])
    cuda = dev.type == "cuda"
    if cuda:
        keep_host_pages()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_build = time.time()
    eng, fw, fl, st = build(plant, eng_cfg, device=dev, batch=B, window=W,
                            payload_cap=int(eng_cfg["payload_cap"]))
    start = plant.start_cursors(ctx.seed, traffic.rng_for)
    eng.cursors = torch.as_tensor(start.astype(np.int32), device=dev)
    sync()
    t_ring = time.time()
    ring_pts = plant.ring(mix, ctx.seed, traffic.rng_for)
    encode = encoder(plant, eng.intern, L)

    def pinned(shape, dtype):
        if not cuda:
            return np.empty(shape, dtype)
        return torch.empty(shape, dtype=torch.from_numpy(
            np.empty(0, dtype)).dtype, pin_memory=True).numpy()

    ring = [encode(tw, tl, pinned) for tw, tl in ring_pts]
    ring_dollar = [win[2].reshape(-1).copy() for win in ring]
    t_warm = time.time()
    routed = []                              # ring index of every window
    after = []                               # the cursors after each one
    for r, win in enumerate(ring):           # warm-up: every ring window
        faults.call(eng, win)
        routed.append(r)
        after.append(eng.cursors)
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
            count0 = {c: eng.stats.get(c) for c in COUNTERS}
            with common.profiled(True, rec, cuda):
                for j in range(SLICE_WINDOWS):
                    with torch.profiler.record_function("bench.route_encoded"):
                        faults.call(eng, ring[(k + j) % len(ring)])
                    routed.append((k + j) % len(ring))
                    after.append(eng.cursors)
            rec["launch_shapes"] = {
                s: c - shapes0.get(s, 0)
                for s, c in D.LAUNCH_SHAPES["prefix_sum"].items()
                if c - shapes0.get(s, 0)}
            # the program's counters over the slice (None where it has none)
            for c in COUNTERS:
                v = eng.stats.get(c)
                rec[c] = v - count0[c] if v is not None \
                    and count0[c] is not None else None
            k += SLICE_WINDOWS
            continue
        r = k % len(ring)
        ta = time.perf_counter()
        rb = faults.call(eng, ring[r])
        lat.append(time.perf_counter() - ta)
        idx = len(routed)
        routed.append(r)
        after.append(eng.cursors)
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
    got_after = torch.stack(after).cpu().numpy().astype(np.int64)
    stats = dict(eng.stats)
    payload_cap = eng.payload_cap
    del eng, ring, after
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    kept[last[0]] = last[1]

    # --- the reference, after the window ---------------------------------
    t_ref = time.time()
    fs = FilterSet(fw, fl, plus=plant.plus, hash_=plant.hash, pad=WORD_PAD,
                   device=dev)
    checks = common.Checks()
    G = st["n_groups"]
    occ, matched, n_compat = [], [], []
    shapes = shapes_of(fw, fl, plant.plus, plant.hash)
    for (tw, tl), dl in zip(ring_pts, ring_dollar):
        m = fs.match(tw.reshape(W * B, -1), tl.reshape(-1), dl)
        matched.append(m)
        occ.append(slot_occurrences(m, st, slot_cap, G))
        n_compat.append(compatible(shapes, tl.reshape(-1), dl).mean())
    del fs
    if cuda:
        torch.cuda.empty_cache()
    cur = start.copy()
    before, want_after = {}, []
    for idx, r in enumerate(routed):
        if idx in kept:
            before[idx] = cur
        cur = wrap32(cur + occ[r])
        want_after.append(cur)

    def judge(idx):
        """The topics of routed window ``idx`` whose plans differ."""
        r = routed[idx]
        want, _c = engine_ref.expected(
            matched[r], W, B, st, before[idx], fan_cap, slot_cap)
        if faults.name == "control":
            got, _c = engine_ref.expected(
                matched[r], W, B, st, start, fan_cap, slot_cap)
            return len(engine_ref.compare(want, got))
        rb = kept[idx]
        return len(engine_ref.compare(want, engine_ref.from_readback(rb, B),
                                      rb.offsets, W, B, rb.row_overflow))

    # NumPy's sorts release the interpreter lock: one thread a window
    with ThreadPoolExecutor(len(kept)) as pool:
        wrong = sum(pool.map(judge, sorted(kept)))
    checked = len(kept) * W * B
    if faults.name == "control":
        # cursors not threaded: each window's from the start
        got_after = np.stack([wrap32(start + occ[r]) for r in routed])
    want_after = np.stack(want_after)
    checks.add("topics_wrong", int(wrong), 0)
    checks.add("cursors_wrong", int((got_after != want_after).sum()), 0)

    timed = len(lat)
    crossed = bool(((want_after[1:] < 0) & (want_after[:-1] >= 0)).any()
                   or ((want_after[0] < 0) & (start >= 0)).any())
    out = {
        "setup_s": t_setup,
        "attempted": timed * W * B,
        "failed": int(wrong),
        "checks": checks,
        "memory_peak_bytes": peak,
        "notes": {"windows": timed, "topics_checked": checked,
                  "cpu_share": (cpu1.ru_utime - cpu0.ru_utime
                                + cpu1.ru_stime - cpu0.ru_stime) / elapsed,
                  "window_s": elapsed,
                  "window_ms": {q: common.percentile(lat, q) * 1e3
                                for q in (50, 90, 99, 100)} if lat else None,
                  "filters": int(len(fl)), "shapes": len(shapes),
                  "payload_cap": int(payload_cap),
                  "entries_per_topic": stats["csr_entries"] / (
                      len(routed) * W * B) if "csr_entries" in stats
                  else None,
                  "start_cursor": int(start[0]),
                  "hot_cursor_crossed_2_31": crossed,
                  "reference_s": time.time() - t_ref,
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
        rec.update(windows=SLICE_WINDOWS, W=W, B=B, max_levels=L,
                   shape_levels=[s for s, _h, _p in shapes],
                   compatible=float(np.mean(n_compat)),
                   window_p99_ms=out["metrics"]["window_p99_ms"])
        out["record"] = rec
        tr = rec["trace"]
        if tr is not None:
            out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
            out["breakdown"] = {"device_ops": tr.top_device_ops(),
                                "idle_gaps": tr.gap_labels()}
    return out
