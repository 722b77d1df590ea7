"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. A CUDA kernel has no CPU mode, so these skip without a CUDA
device. They import no JAX, so they run where only torch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerance: exact (integer outputs).
"""

import numpy as np
import pytest
import torch

from emqx_tpu_torch.convert import tables_from_numpy
from emqx_tpu_torch.device import LAUNCH_SHAPES, LAUNCHES
from emqx_tpu_torch.models.router_engine import route_window
from emqx_tpu_torch.ops.exchange import ring_rotate, ring_rotate_ref
from emqx_tpu_torch.ops.fanout import build_subtable
from emqx_tpu_torch.ops.fold import launch_shape_match
from emqx_tpu_torch.ops.scan import prefix_sum, prefix_sum_ref
from emqx_tpu_torch.ops.shapes import (build_shape_tables, fold_ref,
                                       probe_ref, shape_match_ref)
from emqx_tpu_torch.workloads import pattern_population

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1,), (4095,), (4097,), (3, 10000),
                                   (8, 131072), (1 << 20, 1), (5000, 8),
                                   (300, 32), (300, 33), (300, 64),
                                   (300, 1024), (300, 1025), (262144,),
                                   (1 << 20,), (8, 65536), (8, 65536 + 17),
                                   (524288, 4), (8, 4), (1 << 21,),
                                   (312446, 8)])
def test_prefix_sum_kernel(cuda, shape):
    x = torch.randint(-3, 4, shape, device=cuda, dtype=torch.int32)
    before = LAUNCHES["prefix_sum"]
    at_shape = LAUNCH_SHAPES["prefix_sum"].get(shape, 0)
    assert torch.equal(prefix_sum(x), prefix_sum_ref(x))
    assert LAUNCHES["prefix_sum"] == before + 1
    assert LAUNCH_SHAPES["prefix_sum"][shape] == at_shape + 1


@pytest.mark.parametrize("shape", [(8, 65536), (1 << 20,), (1000, 64),
                                   (1000, 100), (4096, 8), (1 << 20, 1)])
def test_prefix_sum_unaligned_view(cuda, shape):
    """A view one element into its storage: every row start off the
    16-byte grid (long, mid, short and length-1 rows)."""
    flat = torch.randint(-3, 4, (int(np.prod(shape)) + 1,), device=cuda,
                         dtype=torch.int32)
    x = flat[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    assert torch.equal(prefix_sum(x), prefix_sum_ref(x))


@pytest.mark.parametrize("shape", [(1 << 20,), (8, 65536 + 17), (1000, 64),
                                   (4096, 8)])
def test_prefix_sum_wraparound(cuda, shape):
    """Running totals far past 2^31 wrap exactly as torch.cumsum's."""
    x = torch.randint(1 << 30, (1 << 31) - 1, shape, device=cuda,
                      dtype=torch.int32)
    assert torch.equal(prefix_sum(x),
                       torch.cumsum(x, dim=-1, dtype=torch.int32))


def test_prefix_sum_epoch_reuse(cuda):
    """2000 calls back to back on one state buffer, alternating two
    inputs: a status word of an older call never leaks into a newer one."""
    ab = (torch.randint(0, 3, (262144,), device=cuda, dtype=torch.int32),
          torch.randint(3, 9, (262144,), device=cuda, dtype=torch.int32))
    ys = [None, None]
    for i in range(2000):
        ys[i % 2] = prefix_sum(ab[i % 2])
    for k in range(2):
        assert torch.equal(ys[k], prefix_sum_ref(ab[k]))


def test_prefix_sum_state_growth(cuda):
    """Small, large and small long-row calls: the state buffer grows, and
    every call is exact before and after."""
    for shape in ((5000,), (1 << 24,), (5000,), (8, 131072), (1 << 22,),
                  (3000,)):
        x = torch.randint(0, 2, shape, device=cuda, dtype=torch.int32)
        assert torch.equal(prefix_sum(x), prefix_sum_ref(x))


def test_prefix_sum_two_streams(cuda):
    """Two streams scanning at once, each with its own state buffer."""
    xs = [torch.randint(0, 3, (1 << 22,), device=cuda, dtype=torch.int32),
          torch.randint(0, 3, (8, 131072), device=cuda, dtype=torch.int32)]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    outs = [None, None]
    for _ in range(50):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[k] = prefix_sum(xs[k])
    torch.cuda.synchronize()
    for k in range(2):
        assert torch.equal(outs[k], prefix_sum_ref(xs[k]))


def test_prefix_sum_in_cuda_graph(cuda):
    """Long rows (look-back status words) captured into a CUDA graph and
    replayed back to back with new inputs: each replay exact, and each
    replay counts its launches through the recording."""
    from emqx_tpu_torch.device import count_launch, recording_launches
    xs = [torch.randint(0, 3, (8, 131072), device=cuda, dtype=torch.int32)
          for _ in range(4)]
    static = xs[0].clone()
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    graph = torch.cuda.CUDAGraph()
    with recording_launches() as calls, torch.cuda.stream(stream):
        graph.capture_begin()
        out = prefix_sum(static)
        graph.capture_end()
    assert calls == [("prefix_sum", (8, 131072))]
    before = LAUNCHES["prefix_sum"]
    for x in xs:
        static.copy_(x)
        graph.replay()
        for name, shape in calls:
            count_launch(name, shape)
        torch.cuda.synchronize()
        assert torch.equal(out, prefix_sum_ref(x))
    assert LAUNCHES["prefix_sum"] == before + len(xs)


def test_pick_window_in_cuda_graph(cuda):
    """The shape-hash window's one-pass picks at the benchmark's size (W =
    8 steps of 131,072 x 2 slot lanes over 312,446 slots) captured into a
    CUDA graph: two kernel-2 launches, [2097152] and [312446, 8], and each
    replay with new slot ids and cursors equal to the plain pass."""
    from emqx_tpu_torch.device import recording_launches
    from emqx_tpu_torch.ops.shared import STRATEGY_ROUND_ROBIN, pick_window
    W, B, K, G = 8, 131072, 2, 312446
    starts = torch.arange(0, 8 * (G + 1), 8, dtype=torch.int32, device=cuda)
    starts[G // 2:] -= 8                       # an empty group
    members = starts[-1].item()
    subs = build_subtable(1, {}, {}, {}, slot_cap=1)._replace(
        shared_start=starts,
        shared_row=torch.arange(members, dtype=torch.int32, device=cuda),
        shared_opts=torch.zeros(members, dtype=torch.int8, device=cuda))

    def window(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        sids = torch.randint(-1, G, (W, B, K), generator=g, device=cuda,
                             dtype=torch.int32)
        cur = torch.randint(-(1 << 31), (1 << 31) - 1, (G,), generator=g,
                            device=cuda, dtype=torch.int32)
        mh = torch.randint(0, 1 << 31, (W, B), generator=g, device=cuda,
                           dtype=torch.int32)
        return sids, cur, mh

    static = window(0)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    graph = torch.cuda.CUDAGraph()
    with recording_launches() as calls, torch.cuda.stream(stream):
        graph.capture_begin()
        out = pick_window(subs, static[1], static[0], STRATEGY_ROUND_ROBIN,
                          static[2])
        graph.capture_end()
    assert calls == [("prefix_sum", (W * B * K,)), ("prefix_sum", (G, W))]
    for seed in (1, 2, 3):
        x = window(seed)
        for a, b in zip(static, x):
            a.copy_(b)
        graph.replay()
        torch.cuda.synchronize()
        want = pick_window(subs, x[1], x[0], STRATEGY_ROUND_ROBIN, x[2],
                           scan=prefix_sum_ref)
        for a, b in zip(out, want):
            assert torch.equal(a, b)


def _pattern_tables(dev, seed, n_filters=3000, n_topics=5000):
    rng = np.random.default_rng(seed)
    _i, words, flens, t, tl, dol = pattern_population(rng, n_filters,
                                                      n_topics, scale=3)
    tl = tl.copy()
    tl[:50] = 0
    F = len(flens)
    r = np.random.RandomState(seed)
    subs = build_subtable(
        F, {f: [(f, 1)] for f in range(F)},
        {f: [f % 7] for f in range(0, F, 3)},
        {g: [(10000 + 4 * g + j, 2) for j in range(g % 4 + 1)]
         for g in range(7)})
    tb = tables_from_numpy(build_shape_tables(words, flens), subs, dev)
    on = [torch.from_numpy(x).to(dev) for x in (t, tl, dol)]
    mh = torch.from_numpy(r.randint(0, 1 << 30, len(tl)).astype(np.int32))
    return tb, on, mh.to(dev)


@pytest.mark.parametrize("seed", [1, 2])
def test_shape_match_kernel(cuda, seed):
    tb, (t, tl, dol), _ = _pattern_tables(cuda, seed)
    m, c, *planes = launch_shape_match(tb.shapes, t, tl, dol,
                                       fold_planes=True)
    ref = fold_ref(tb.shapes, t, tl, dol)
    for a, b in zip(planes, ref):
        assert torch.equal(a, b)
    mr = probe_ref(tb.shapes, *ref)
    assert torch.equal(m, mr.matches) and torch.equal(c, mr.counts)
    assert int(c.sum()) > 0


def test_route_window_kernel_vs_plain(cuda):
    tb, (t, tl, dol), mh = _pattern_tables(cuda, 3, n_topics=4 * 1250)
    W = 4
    args = (t.reshape(W, -1, t.shape[1]), tl.reshape(W, -1),
            dol.reshape(W, -1), mh.reshape(W, -1))
    cur = torch.zeros(7, dtype=torch.int32, device=cuda)
    kw = dict(fanout_cap=4, slot_cap=2, payload_cap=1 << 14)
    k = route_window(tb, cur, *args, 0, **kw)
    p = route_window(tb, cur, *args, 0, match=shape_match_ref,
                     scan=prefix_sum_ref, **kw)
    for a, b in zip(k.res, p.res):
        assert torch.equal(a, b)
    for a, b in zip(k.compact, p.compact):
        assert torch.equal(a, b)


def test_route_engine_readbacks_are_pinned_and_their_own(cuda):
    """RouteEngine reads each window back into page-locked blocks of its
    own: a readback held across later windows keeps its planes, and each
    equals the plain copy of its window."""
    from emqx_tpu_torch.engine import RouteEngine

    subs = {f"plant/{g}/+/#": [(g, 1)] for g in range(40)}
    subs["$share/h/plant/#"] = [(100 + m, 1) for m in range(8)]
    subs["plant/#"] = [(200, 0), (201, 1)]
    eng = RouteEngine.from_subscriptions(subs, device=cuda, batch=256,
                                         window=2, fanout_cap=8, slot_cap=2,
                                         max_levels=8, payload_cap=1 << 12)
    topics = [f"plant/{k % 40}/n{k}/d{k % 3}" for k in range(512)]
    first = eng.route(topics[:256])
    kept = eng.route_encoded(*_encoded_window(eng, topics))
    snap = [a.copy() for a in kept[:5]]
    for _ in range(3):
        eng.route_encoded(*_encoded_window(eng, topics[::-1]))
    for a, b in zip(kept[:5], snap):
        assert np.array_equal(a, b)
    assert torch.from_numpy(kept.payload).is_pinned()
    assert [p.fids.tolist() for p in first] == [
        p.fids.tolist() for p in RouteEngine.from_subscriptions(
            subs, device="cpu", batch=256, window=2, fanout_cap=8,
            slot_cap=2, max_levels=8).route(topics[:256])]


def _encoded_window(eng, topics):
    """``topics`` as one encoded [W, B] window of ``eng``."""
    from emqx_tpu_torch.ops.match import encode_topics_str

    enc, lens, dollar, _long = encode_topics_str(eng.intern, topics,
                                                 eng.max_levels)
    W, B = eng.window, eng.batch
    return (enc.reshape(W, B, -1), lens.reshape(W, B), dollar.reshape(W, B),
            np.zeros((W, B), np.int32))


@pytest.mark.parametrize("rows", [24576, 1001])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_ring_rotate_kernel(cuda, rows, k):
    """One launch moves a 2 x 4 grid of [rows, 3] blocks k hops, equal to
    the plain version and to torch.roll; 1001 rows leave a scalar tail,
    and the offset view misaligns every block."""
    flat = torch.randint(-2 ** 31, 2 ** 31 - 1, (2 * 4 * rows * 3 + 1,),
                         device=cuda, dtype=torch.int32)
    for x in (flat[:-1].view(2, 4, rows, 3), flat[1:].view(2, 4, rows, 3)):
        blocks = [[x[d, r] for r in range(4)] for d in range(2)]
        before = LAUNCHES["ring_rotate"]
        got = ring_rotate(blocks, k)
        assert LAUNCHES["ring_rotate"] == before + 1
        want = ring_rotate_ref(blocks, k)
        rolled = torch.roll(x, k, dims=1)
        for d in range(2):
            for r in range(4):
                assert torch.equal(got[d][r], want[d][r])
                assert torch.equal(got[d][r], rolled[d, r])


def test_ring_rotate_two_cards(cuda):
    """A ring across two cards: each block lands on the other card through
    a peer write."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices for the peer write")
    a = torch.arange(3 * 777, dtype=torch.int32, device="cuda:0").view(-1, 3)
    b = (-a).to("cuda:1")
    got = ring_rotate([[a, b]], 1)
    assert got[0][1].device.index == 1 and got[0][0].device.index == 0
    assert torch.equal(got[0][1].cpu(), a.cpu())
    assert torch.equal(got[0][0].cpu(), b.cpu())


def test_mesh_step_and_exchange_kernel_vs_plain(cuda):
    """The mesh path on one card: step planes and ExchangeResult with the
    kernels equal the plain path."""
    from emqx_tpu_torch.parallel.serving import ShardedRouteEngine
    from emqx_tpu_torch.parallel.sharded import (make_exchange_step,
                                                 make_sharded_route_step)
    from emqx_tpu_torch.workloads import mesh_population, mesh_topic_batch
    pop = mesh_population(20000)
    eng = ShardedRouteEngine.from_columnar(
        pop["filters"], pop["words"], pop["lens"], pop["sub_start"],
        pop["sub_row"], pop["sub_opts"], pop["intern"], n_devices=8, dp=2,
        device=cuda, batch=4096)
    tp, tl, _ = mesh_topic_batch(pop, np.random.RandomState(0), 4096)
    staged = [torch.from_numpy(x).to(cuda) for x in (
        tp, tl, np.zeros(4096, bool), np.zeros(4096, np.int32))]
    cur = eng.cursors.clone()
    k = eng.step(eng.tables, cur, *staged, 0)
    p = make_sharded_route_step(eng.mesh, scan=prefix_sum_ref)(
        eng.tables, cur, *staged, 0)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    planes = (k.matches, k.rows, k.opts, k.shared_sids, k.overflow)
    ek = eng.exchange_step(2048)(*planes, eng.aux)
    ep = make_exchange_step(eng.mesh, seg_cap=2048, scan=prefix_sum_ref,
                            rotate=ring_rotate_ref)(*planes, eng.aux)
    for a, b in zip(ek, ep):
        assert torch.equal(a, b)
    assert int(ek.ok.min()) == 3


# ---- the routing layers' graph classes ------------------------------------

def _layers_node(cuda):
    """A port Node on the card at the reference's defaults with a small
    shape-hash population (plain and shared filters), built."""
    from emqx_tpu_torch.broker.node import Node

    class Sink:
        def deliver(self, f, m):
            return True

    node = Node({"broker": {}}, device=cuda)
    b = node.broker
    sids = [b.register(Sink(), f"c{i}") for i in range(8)]
    for i in range(40):
        for n in range(8):
            b.subscribe(sids[(i + n) % 8], f"dev/d{i}/+/n{n}/#", {"qos": 0})
            if (i + n) % 3 == 0:
                for k in range(2):
                    b.subscribe(sids[(i + k) % 8],
                                f"$share/g/dev/d{i}/+/n{n}/#", {"qos": 1})
    node.device_engine.rebuild()
    return node, sids


def _window(node, rng, n_hot, batches=8, batch=1024):
    """A fused window drawn from n_hot topics (more unique topics than the
    window's Bp of 1,024: the dedup plan does not engage)."""
    from emqx_tpu_torch.broker.message import make
    hot = ["dev/d%d/x/n%d" % (rng.randint(40), rng.randint(8))
           + "/t" * rng.randint(1, 13) for _ in range(n_hot)]
    lives = [[make("p", 0, hot[rng.randint(n_hot)], b"")
              for _ in range(batch)] for _ in range(batches)]
    h = node.device_engine.prepare_window(lives, gate_cold=False)
    return h


def _warm_class(eng, h):
    """Capture the graph of h's class (what the background warm does for a
    class the serving path asked for)."""
    Wp, Bp = h.enc[0].shape[:2]
    cls = (Wp, Bp, h.plan.Bm if h.plan is not None else None,
           h.delta.cap if h.delta is not None else None, h.pcap)
    if eng._graph_key(h.built, cls, eng._strategy()) not in eng._graphs:
        with torch.cuda.stream(eng._warm_stream):
            eng._warm_dispatch(h.built, eng._tables, eng._cursors, cls)
    return cls


def _eager_planes(eng, h, counts):
    """h's window run again eagerly with the kernels, from the cursors and
    the overlay version it started with: the host planes its readback
    took."""
    torch.cuda.synchronize()        # the engine stream's uploads
    ins = [torch.from_numpy(a).to(eng.device) for a in h.arrays]
    res, cp, dp, dcp = eng._unwrap(eng._program(
        h.built.backend, h.tables,
        h.delta.dev if h.delta is not None else None, h.cursors0, ins,
        h.strat, h.cls))
    return [t.cpu().numpy() for t in
            eng._plane_list(res, cp, dp, dcp, counts)]


def test_cached_and_delta_graphs_replay_exactly(cuda):
    """The cached class, the overlay class and both together replay as
    CUDA graphs bit-identical to the same windows run eagerly."""
    node, sids = _layers_node(cuda)
    eng = node.device_engine
    rng = np.random.RandomState(1)
    kinds = []
    for step in range(3):
        if step == 1:
            node.broker.subscribe(sids[0], "dev/d3/+/n2/t", {"qos": 0})
            node.broker.subscribe(sids[1], "dev/+/x/n5/#", {"qos": 1})
        h = _window(node, rng, n_hot=300 if step != 2 else 5000)
        _warm_class(eng, h)
        eng.dispatch(h)
        assert h.graphed
        counts = eng._wants_counts(h)
        want = _eager_planes(eng, h, counts)
        eng.materialize(h)
        got = [t.numpy() for t in h.host]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        kinds.append((h.plan is not None, h.delta is not None))
        eng.abandon(h)
    assert kinds == [(True, False), (True, True), (False, True)]


def test_capture_stream_is_no_engine_stream(cuda):
    """Graph captures run on a stream that no engine's serving or warm
    stream is, however many streams the engines draw: the pool of
    torch.cuda.Stream hands each of its streams out again every 32
    draws, and a capture on a stream another thread used made every
    later pin_memory raise (``chip_smoke.py --warm-stress``)."""
    from emqx_tpu_torch.broker.device_engine import _capture_stream
    cap = _capture_stream(cuda)
    assert _capture_stream(cuda) is cap
    drawn = {torch.cuda.Stream(cuda).cuda_stream for _ in range(96)}
    assert cap.cuda_stream not in drawn


def test_overlay_copied_in_flight_keeps_the_window_s_version(cuda):
    """Window 1 replays the overlay class's graph; a subscription changes
    the overlay and window 2 replays the same graph with the new version
    copied into its buffers before window 1 is read back: window 1's
    planes are those of its own version."""
    node, sids = _layers_node(cuda)
    eng = node.device_engine
    rng = np.random.RandomState(2)
    node.broker.subscribe(sids[0], "dev/d3/+/n2/t", {"qos": 0})
    h1 = _window(node, rng, n_hot=5000)
    cls = _warm_class(eng, h1)
    eng.dispatch(h1)
    node.broker.subscribe(sids[2], "dev/+/x/+/t", {"qos": 0})
    h2 = _window(node, rng, n_hot=5000)
    assert h2.delta is not h1.delta
    assert _warm_class(eng, h2) == cls       # the same graph, not captured
    eng.dispatch(h2)
    assert h1.graphed and h2.graphed
    for h in (h1, h2):
        want = _eager_planes(eng, h, eng._wants_counts(h))
        eng.materialize(h)
        for g, w in zip([t.numpy() for t in h.host], want):
            assert np.array_equal(g, w)
    # the new filter shows in window 2's overlay matches only
    assert int(h2.np_delta.counts.sum()) > int(h1.np_delta.counts.sum())
    eng.abandon(h1)
    eng.abandon(h2)


# ---- subscription covering on the card ------------------------------------

def _cover_node(cuda, n=3000):
    """A port Node on the card with covering on and a cover-heavy
    population (umbrellas d{k}/# own most filters): the roots match on
    the shape tables. One session holds every filter."""
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.workloads import cover_heavy_filters

    class Sink:
        def __init__(self):
            self.got = []

        def deliver(self, f, m):
            self.got.append((f, m.topic))
            return True

    node = Node({"broker": {"topic_dedup": False}}, device=cuda)
    filters = cover_heavy_filters(n, cover_ratio=0.6)
    node.sink = Sink()
    sid = node.broker.register(node.sink, "c")
    for f in filters:
        node.broker.subscribe(sid, f, {"qos": 0})
    eng = node.device_engine
    eng.rebuild()
    assert eng._built.cover is not None and eng._built.backend == "shapes"
    return node, filters


def _cover_window(node, rng, filters, extra=(), batch=1024):
    from emqx_tpu_torch.broker.message import make
    from emqx_tpu_torch.workloads import concretize
    topics = list(extra) + [concretize(filters[i]) for i in
                            rng.randint(0, len(filters), batch - len(extra))]
    return node.device_engine.prepare(
        [make("p", 0, t, b"") for t in topics], gate_cold=False)


def _append(node, filters):
    """One covered SUBSCRIBE: a new filter under a built umbrella root.
    Returns the new filter and a topic only it (and its root) matches."""
    eng = node.device_engine
    b = eng._built
    umb = next(b.fid_filter[f] for f in b.cover.roots.tolist()
               if b.fid_filter[f].endswith("/#"))
    new = umb[:-1] + "appended/leaf"
    node.broker.subscribe(node.broker.register(type(node.sink)(), "n"),
                          new, {"qos": 0})
    assert node.metrics.val("routing.cover.appends") >= 1
    assert eng.stats()["delta_filters"] == 0
    return new, new


def test_covered_graph_replays_exactly(cuda):
    """The covered shape-hash class replays as a CUDA graph bit-identical
    to the same window run eagerly, and equal to the plain path."""
    node, filters = _cover_node(cuda)
    eng = node.device_engine
    rng = np.random.RandomState(1)
    for _ in range(2):
        h = _cover_window(node, rng, filters)
        _warm_class(eng, h)
        eng.dispatch(h)
        assert h.graphed
        want = _eager_planes(eng, h, eng._wants_counts(h))
        eng.materialize(h)
        for g, w in zip([t.numpy() for t in h.host], want):
            assert np.array_equal(g, w)
        eng.abandon(h)


def test_append_between_replays_and_in_flight(cuda):
    """Window 1 replays; a covered SUBSCRIBE appends (the static append
    buffers rewritten on the engine stream) before window 1 is read
    back; window 2 replays the same graph. Each window's planes are
    those of its own append version: the appended fid shows in window 2
    only."""
    node, filters = _cover_node(cuda)
    eng = node.device_engine
    rng = np.random.RandomState(2)
    F = len(eng._built.fid_filter)
    b = eng._built
    umb = next(b.fid_filter[f] for f in b.cover.roots.tolist()
               if b.fid_filter[f].endswith("/#"))
    topic = umb[:-1] + "appended/leaf"
    h1 = _cover_window(node, rng, filters, extra=[topic] * 4)
    cls = _warm_class(eng, h1)
    eng.dispatch(h1)
    _append(node, filters)
    h2 = _cover_window(node, rng, filters, extra=[topic] * 4)
    assert _warm_class(eng, h2) == cls       # the same graph
    eng.dispatch(h2)
    assert h1.graphed and h2.graphed
    for h in (h1, h2):
        want = _eager_planes(eng, h, eng._wants_counts(h))
        eng.materialize(h)
        for g, w in zip([t.numpy() for t in h.host], want):
            assert np.array_equal(g, w)
    m1 = eng._dense_again(h1)[0].matches.cpu().numpy()
    m2 = eng._dense_again(h2)[0].matches.cpu().numpy()
    assert not (m1[0, :4] == F).any() and (m2[0, :4] == F).any(axis=1).all()
    eng.abandon(h1)
    eng.abandon(h2)


def test_csr_overflow_recompute_after_append(cuda):
    """A window dispatched before an append, recomputed eagerly (the CSR
    overflow path, _dense_again) after it: it reads the append version
    it was dispatched with, not the current one."""
    node, filters = _cover_node(cuda)
    eng = node.device_engine
    rng = np.random.RandomState(3)
    b = eng._built
    umb = next(b.fid_filter[f] for f in b.cover.roots.tolist()
               if b.fid_filter[f].endswith("/#"))
    topic = umb[:-1] + "appended/leaf"
    h = _cover_window(node, rng, filters, extra=[topic] * 4)
    _warm_class(eng, h)
    eng.dispatch(h)
    torch.cuda.synchronize()
    before = [x.clone() for x in h.res]
    _append(node, filters)
    res, _dp = eng._dense_again(h)
    for a, c in zip(before, res):
        assert torch.equal(a, c)
    eng.materialize(h)
    eng.abandon(h)


def test_cover_expand_kernel_scan_vs_plain(cuda):
    """The expansion behind the kernels (kernel 1's fold+probe on the
    roots, kernel 2 in the CSR gather) equals the plain path (the plain
    fold, prefix_sum_ref), on the shape tables and behind the trie."""
    from emqx_tpu_torch.convert import trie_from_numpy
    from emqx_tpu_torch.ops import cover as CV
    from emqx_tpu_torch.ops.intern import InternTable
    from emqx_tpu_torch.ops.match import encode_topics, match_batch
    from emqx_tpu_torch.ops.shapes import shape_match
    from emqx_tpu_torch.ops.trie import build_tables
    from emqx_tpu_torch.utils.topic import tokens
    from emqx_tpu_torch.workloads import concretize, cover_heavy_filters
    filters = sorted(set(cover_heavy_filters(2000, cover_ratio=0.6)))
    intern = InternTable()
    L = max(len(tokens(f)) for f in filters)
    rows = np.zeros((len(filters), L), np.int32)
    lens = np.zeros(len(filters), np.int64)
    for i, f in enumerate(filters):
        ids = intern.encode_filter(tokens(f))
        rows[i, :len(ids)] = ids
        lens[i] = len(ids)
    dollar = np.zeros(len(filters), bool)
    covers, inc = CV.detect_covers(rows, lens, dollar, device=cuda)
    owner = CV.assign_owners(covers, inc)
    roots = np.flatnonzero(owner < 0)
    fc = 1 << (len(filters) - 1).bit_length()
    topics = [concretize(f) for f in filters]
    enc, tl, dol, _ = encode_topics(intern, [tokens(t) for t in topics], L)
    ins = [torch.from_numpy(x).to(cuda) for x in (enc, tl, dol)]
    for keys in ("shape", "trie"):
        ct = CV.build_cover_tables(rows, lens, owner,
                                   getattr(CV, f"{keys}_order_keys")(
                                       rows, lens),
                                   fid_cap=fc, out_width=64, cand_cap=256)
        if keys == "shape":
            st = build_shape_tables(rows[roots], lens[roots],
                                    filter_ids=roots)._replace(cover=ct)
            t = tables_from_numpy(st, build_subtable(fc, {}, {}, {}),
                                  cuda).shapes
            before = LAUNCHES["prefix_sum"]
            got, want = shape_match(t, *ins), shape_match_ref(t, *ins)
        else:
            tr = trie_from_numpy(build_tables(
                rows[roots], lens[roots], filter_ids=roots)._replace(
                    cover=ct), cuda)
            before = LAUNCHES["prefix_sum"]
            got = match_batch(tr, *ins, frontier_cap=16, match_cap=64)
            want = match_batch(tr, *ins, frontier_cap=16, match_cap=64,
                               scan=prefix_sum_ref)
        assert LAUNCHES["prefix_sum"] > before
        for a, c in zip(got, want):
            assert torch.equal(a, c)
        assert (got.matches >= 0).sum() > len(filters)
