"""Port vs JAX reference: incremental capture of the single-chip engine.

With the delta overlay on, a compaction's capture is the previous
capture with only the filters touched since, and every shared filter,
re-read (``emqx_tpu/broker/device_engine.py:1049-1125``). Checked here:

- after churn — subscribes, unsubscribes, an opts update, a new shared
  member, and round-robin cursors advanced by dispatches with no
  ``note_*`` call — the incremental capture equals a full capture of the
  same state (the twin of ``tests/test_delta_overlay.py:318``), and the
  async capture equals the sync one;
- across crossed rebuild thresholds (the ``churn`` compaction, captured
  incrementally), the port's engine delivers what the reference's does,
  message by message and session by session, and ends with the same
  shared-group cursors.

Inputs come from a seed; comparisons are exact. Snapshot ids and other
per-process counters are not compared.
"""

import asyncio
import random

import pytest
import torch

from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu_torch.broker.message import make as tmake
from emqx_tpu_torch.broker.node import Node as TNode
from tests.test_torch_engine import JAX_BROKER

torch.set_num_threads(1)

SEED = 11
LAYERS = {"topic_dedup": True, "match_cache_size": 8192,
          "delta_overlay": True, "rebuild_threshold": 4}


class Sink:
    def __init__(self):
        self.got = []

    def deliver(self, topic_filter, msg):
        self.got.append((topic_filter, msg.topic, bytes(msg.payload)))
        return True


def _populate(node, n_sess: int = 6, n_filters: int = 24) -> list:
    b = node.broker
    sinks = [Sink() for _ in range(n_sess)]
    sids = [b.register(s, f"c{i}") for i, s in enumerate(sinks)]
    for i in range(n_filters):
        b.subscribe(sids[i % n_sess], f"dev/{i}/+", {"qos": i % 3})
    for g in range(3):
        for m in range(3):
            b.subscribe(sids[(g + m) % n_sess], f"$share/g{g}/job/{g}/+",
                        {"qos": 1})
    return sids, sinks


def _churn(node, sids, rng) -> None:
    """Seeded churn: new filters, deletes, an opts update, a new shared
    member and a member leaving."""
    b = node.broker
    for k in range(3):
        b.subscribe(sids[rng.randrange(len(sids))], f"new/{k}/#",
                    {"qos": 0})
    b.unsubscribe(sids[1 % len(sids)], "dev/1/+")
    b.subscribe(sids[3 % len(sids)], "dev/3/+", {"qos": 2})     # opts
    b.subscribe(sids[5 % len(sids)], "$share/g1/job/1/+", {"qos": 0})
    b.unsubscribe(sids[0], "$share/g0/job/0/+")


def _full_equals(node, inc) -> None:
    eng = node.device_engine
    full = eng._capture_state_sync()
    assert sorted(inc[0]) == sorted(full[0])
    assert sorted(inc[1]) == sorted(full[1])
    assert inc[2] == full[2]
    assert inc[3] == full[3]


def test_incremental_capture_equals_full_capture():
    node = TNode({"broker": dict(LAYERS, deliver_lanes=0)}, device="cpu")
    sids, _sinks = _populate(node)
    eng = node.device_engine
    eng.rebuild()
    assert eng._last_capture is not None and eng.journal_depth() == 0
    # dispatches advance the shared cursors with no note_* call
    for _ in range(4):
        eng.route_batch([tmake("p", 0, f"job/{g}/x", b"") for g in range(3)])
    cursors = {(f, g): grp.cursor for f, gs in node.broker.shared.items()
               for g, grp in gs.items()}
    assert any(cursors.values())
    _churn(node, sids, random.Random(SEED))
    assert eng.journal_depth() > 0
    inc = eng._capture_state_incremental()
    assert eng.journal_depth() == 0
    for f, gs in inc[3].items():
        for g, (_members, cur) in gs.items():
            assert cur == node.broker.shared[f][g].cursor
    _full_equals(node, inc)


def test_async_incremental_capture_equals_sync():
    node = TNode({"broker": dict(LAYERS, deliver_lanes=0)}, device="cpu")
    sids, _sinks = _populate(node)
    eng = node.device_engine
    eng.rebuild()
    eng.route_batch([tmake("p", 0, "job/2/x", b"")] * 5)
    _churn(node, sids, random.Random(SEED + 1))
    touched = set(eng._touched)
    got = asyncio.run(eng._capture_state_incremental_async(chunk=2))
    eng._touched = touched          # the sync twin re-reads the same set
    want = eng._capture_state_incremental()
    assert got == want
    _full_equals(node, got)


@pytest.mark.parametrize("strategy", ["round_robin", "hash_topic"])
def test_engine_twin_across_compactions(strategy):
    """Both engines route the same seeded batches while churn crosses the
    rebuild threshold several times; every compaction after the first
    build captures incrementally. Counts, every session's deliveries
    and the host cursors agree throughout."""
    conf = dict(LAYERS, shared_subscription_strategy=strategy)
    j = JNode({"broker": dict(JAX_BROKER, **conf)}, use_device=True)
    t = TNode({"broker": dict(conf, deliver_lanes=0)}, device="cpu")
    pops = [_populate(n) for n in (j, t)]
    rng = random.Random(SEED)
    makes = (jmake, tmake)
    n_incremental = 0
    for rnd in range(6):
        topics = [rng.choice([f"dev/{rng.randrange(30)}/x",
                              f"job/{rng.randrange(3)}/y",
                              f"new/{rng.randrange(4)}/z/w"])
                  for _ in range(24)]
        counts = [n.device_engine.route_batch(
            [mk("p", 0, tp, b"%d" % i) for i, tp in enumerate(topics)])
            for n, mk in zip((j, t), makes)]
        assert counts[0] == counts[1], rnd
        for a, b in zip(pops[0][1], pops[1][1]):
            assert a.got == b.got, rnd
        # churn past the threshold: the next route_batch compacts
        for node, (sids, _s) in zip((j, t), pops):
            rr = random.Random(SEED + rnd)
            for k in range(5):
                node.broker.subscribe(sids[rr.randrange(len(sids))],
                                      f"dev/{rr.randrange(24)}/+",
                                      {"qos": rr.randrange(3)})
            node.broker.subscribe(sids[rr.randrange(len(sids))],
                                  f"$share/g{rnd % 3}/job/{rnd % 3}/+",
                                  {"qos": 0})
        inc = t.device_engine._can_capture_incremental()
        n_incremental += inc
        assert j.device_engine._can_capture_incremental() == inc
    assert n_incremental >= 5
    assert t.metrics.val("routing.device.compactions") == \
        j.metrics.val("routing.device.compactions") >= 4
    cur = [{(f, g): grp.cursor for f, gs in n.broker.shared.items()
            for g, grp in gs.items()} for n in (j, t)]
    assert cur[0] == cur[1]
