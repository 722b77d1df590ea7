"""Port vs JAX reference: fan-out, shared slots, member picks, rank/occur,
and the window's one-pass picks against W chained single-step picks.

Random subscriber tables and match planes from a seeded numpy RNG go
through both packages; every output plane must be EQUAL (exact),
including the overflow flags, new_cursors and occur.
"""

import numpy as np
import pytest
import torch

from emqx_tpu.ops import fanout as JF
from emqx_tpu.ops import shared as JSH
from emqx_tpu_torch.convert import tables_from_numpy
from emqx_tpu_torch.ops import fanout as PF
from emqx_tpu_torch.ops import scan as PS
from emqx_tpu_torch.ops import shared as PSH
from emqx_tpu_torch.ops.scan import prefix_sum_ref
from emqx_tpu_torch.ops.shapes import build_shape_tables

# small CPU cases: one intra-op thread leaves the cores to the other
# test workers (torch would otherwise spin a thread per core)
torch.set_num_threads(1)

PHI = 0x9E3779B1


def post_fixture(seed, F=40, G=9, B=64, M=4):
    """-> (JAX-built SubTable, port-built SubTable, matches [B, M], G).
    Slot 0 has no members; matches carry -1 holes."""
    rng = np.random.RandomState(seed)
    normal = {f: [(int(rng.randint(500)), int(rng.randint(64)))
                  for _ in range(rng.randint(0, 6))]
              for f in range(F) if rng.rand() < 0.8}
    filter_slots = {f: sorted(rng.choice(G, rng.randint(1, 3),
                                         replace=False).tolist())
                    for f in range(F) if rng.rand() < 0.5}
    shared = {g: [(1000 + 10 * g + j, int(rng.randint(64)))
                  for j in range(rng.randint(1, 5))] for g in range(1, G)}
    want = JF.build_subtable(F, normal, filter_slots, shared)
    got = PF.build_subtable(F, normal, filter_slots, shared)
    matches = rng.randint(-1, F, (B, M)).astype(np.int32)
    return want, got, matches, G


def port_subs(subs):
    st = build_shape_tables(np.array([[4]], np.int32), np.array([1]))
    return tables_from_numpy(st, subs, "cpu").subs


def eq(got, want, name=""):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_array_equal(got, np.asarray(want), name)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_subtable_equal(seed):
    want, got, _m, _g = post_fixture(seed)
    for k in JF.SubTable._fields:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        eq(a, b, k)


@pytest.mark.parametrize("cap", [1, 3, 16])
def test_fanout_and_slots_equal(cap):
    want_t, _g, matches, _G = post_fixture(cap)
    sub = port_subs(want_t)
    m = torch.from_numpy(matches)
    w = JF.fanout_normal(want_t, matches, fanout_cap=cap)
    g = PF.fanout_normal(sub, m, fanout_cap=cap)
    for name in ("rows", "opts", "counts", "overflow"):
        eq(getattr(g, name), getattr(w, name), name)
        assert getattr(g, name).dtype == torch.from_numpy(
            np.array(getattr(w, name))).dtype, name
    ws, wo = JF.shared_slots(want_t, matches, slot_cap=cap)
    gs, go = PF.shared_slots(sub, m, slot_cap=cap)
    eq(gs, ws, "sids")
    eq(go, wo, "slot overflow")
    if cap == 1:
        assert g.overflow.any() and go.any()


@pytest.mark.parametrize("strategy", sorted(PSH.STRATEGIES.values()))
@pytest.mark.parametrize("seed", [0, 1])
def test_pick_members_equal(strategy, seed):
    want_t, _g, matches, G = post_fixture(seed)
    sub = port_subs(want_t)
    sids, _ = JF.shared_slots(want_t, matches, slot_cap=3)
    sids = np.array(sids)
    rng = np.random.RandomState(100 + seed)
    cursors = rng.randint(0, 50, G).astype(np.int32)
    msg_hash = rng.randint(-(1 << 31), 1 << 31, len(sids)).astype(np.int64)
    # a hash whose (hash * PHI) ^ slot is INT32_MIN: abs() must keep it
    s0 = max(int(sids[0, 0]), 0)
    msg_hash[0] = ((0x80000000 ^ s0) * pow(PHI, -1, 1 << 32)) & 0xFFFFFFFF
    msg_hash = msg_hash.astype(np.uint32).view(np.int32)
    want = JSH.pick_members(want_t, cursors, sids, np.int32(strategy),
                            msg_hash)
    got = PSH.pick_members(sub, torch.from_numpy(cursors),
                           torch.from_numpy(sids), strategy,
                           torch.from_numpy(msg_hash))
    for name in JSH.SharedPickResult._fields:
        eq(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("B,K,G", [(64, 3, 17), (37, 3, 13), (5, 1, 2)])
def test_rank_equals_blocked(B, K, G):
    """The sorted rank equals the reference's blocked form everywhere,
    -1 entries included (rank 0), and occur is the per-slot total."""
    sids = np.random.RandomState(B).randint(-1, G, (B, K)).astype(np.int32)
    want_rank, want_occur = JSH._rank_and_occur_blocked(sids, G, block=8)
    rank, occur = PSH.rank_and_occur(torch.from_numpy(sids), G)
    eq(rank, want_rank, "rank")
    eq(occur, want_occur, "occur")
    assert (rank.numpy()[sids < 0] == 0).all()


def window_picks_fixture(seed, W, B=64):
    """A post_fixture table and a [W, B, K] window of slot ids (-1 padded,
    one step's first rows all padding; slot 0 has no members), with
    cursors, per-message hashes and the JAX-built table."""
    want_t, _g, _m, G = post_fixture(seed, B=B)
    rng = np.random.RandomState(200 + seed)
    sids = np.stack([np.asarray(JF.shared_slots(
        want_t, rng.randint(-1, 40, (B, 4)).astype(np.int32),
        slot_cap=3)[0]) for _ in range(W)])
    sids[W // 2, :B // 4] = -1
    cursors = rng.randint(0, 50, G).astype(np.int32)
    msg_hash = rng.randint(-(1 << 31), 1 << 31, (W, B)).astype(np.int32)
    return want_t, sids, cursors, msg_hash


def chained_picks(pick, cursors, sids, strategy, msg_hash):
    """W single-step picks, each reading the cursors the last one left,
    stacked [W, ...] field by field."""
    steps, cur = [], cursors
    for k in range(len(sids)):
        r = pick(cur, sids[k], strategy, msg_hash[k])
        steps.append([np.asarray(x) for x in r])
        cur = r.new_cursors
    return [np.stack(x) for x in zip(*steps)]


def recording_scan():
    """A scan that records each call's shape and defers to the plain
    version."""
    calls = []

    def scan(x):
        calls.append(tuple(x.shape))
        return prefix_sum_ref(x)
    return scan, calls


@pytest.mark.parametrize("W", [1, 3, 8])
@pytest.mark.parametrize("strategy", sorted(PSH.STRATEGIES.values()))
def test_pick_window_equals_chained_steps(strategy, W):
    """One pass over the window equals W chained single-step picks (the
    port's and the reference's) on every field, bit for bit, with one
    run-id scan at [W*B*K] and, for round robin, one at [G, W] (W = 1:
    the step's own scan alone)."""
    want_t, sids, cursors, mh = window_picks_fixture(W, W)
    sub = port_subs(want_t)
    G = len(cursors)
    scan, calls = recording_scan()
    got = PSH.pick_window(sub, torch.from_numpy(cursors),
                          torch.from_numpy(sids), strategy,
                          torch.from_numpy(mh), scan=scan)
    rr = W > 1 and strategy == PSH.STRATEGY_ROUND_ROBIN
    assert calls == [(sids.size,)] + ([(G, W)] if rr else [])
    port = chained_picks(
        lambda c, s, st, h: PSH.pick_members(
            sub, torch.as_tensor(c), torch.from_numpy(s), st,
            torch.from_numpy(h)), cursors, sids, strategy, mh)
    ref = chained_picks(
        lambda c, s, st, h: JSH.pick_members(want_t, c, s, np.int32(st), h),
        cursors, sids, strategy, mh)
    for i, name in enumerate(PSH.SharedPickResult._fields):
        eq(getattr(got, name), ref[i], name)
        eq(getattr(got, name), port[i], name)
    assert (got.rows.numpy()[sids < 0] == -1).all()


@pytest.mark.parametrize("groups", [2, 3])
@pytest.mark.parametrize("strategy", sorted(PSH.STRATEGIES.values()))
def test_pick_window_split_into_groups(monkeypatch, strategy, groups):
    """A window longer than kernel 2's MAX_LEN runs as the fewest groups
    of whole steps that fit, the cursors threaded between them: the same
    results as one pass, one pair of scans a group."""
    W, B = 8, 64
    want_t, sids, cursors, mh = window_picks_fixture(groups, W, B=B)
    sub = port_subs(want_t)
    args = (torch.from_numpy(cursors), torch.from_numpy(sids), strategy,
            torch.from_numpy(mh))
    whole = PSH.pick_window(sub, *args, scan=prefix_sum_ref)
    lane = sids[0].size                     # B * K lanes a step
    fit = -(-W // groups)                   # steps a group: 4 or 3
    monkeypatch.setattr(PS, "MAX_LEN", fit * lane + lane - 1)
    scan, calls = recording_scan()
    got = PSH.pick_window(sub, *args, scan=scan)
    sizes = [min(fit, W - k) for k in range(0, W, fit)]
    assert len(sizes) == groups
    rr = strategy == PSH.STRATEGY_ROUND_ROBIN
    assert calls == [s for n in sizes
                     for s in [(n * lane,)] + ([(len(cursors), n)]
                                               if rr and n > 1 else [])]
    for name in PSH.SharedPickResult._fields:
        assert torch.equal(getattr(got, name), getattr(whole, name)), name
