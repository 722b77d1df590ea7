"""Port vs JAX reference: checkpoint and resume (``broker/persistence``).

A snapshot and a write-ahead log written by either package restore in
the other, to the same state: routes, retained messages with their
expiry, delayed messages, parked sessions. The WAL replays after the
snapshot, a snapshot truncates it, a retained delete is journaled, and a
torn tail is skipped. Inputs are the checkpoint cases of the reference's
``tests/test_persistence_apps.py``.
"""

import json
import os

import pytest

from emqx_tpu.apps.delayed import DelayedPublish as JDelayed
from emqx_tpu.apps.retainer import Retainer as JRetainer
from emqx_tpu.broker import persistence as jpers
from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.broker.session import Session as JSession
from emqx_tpu.broker.session import SessionConf as JSessionConf
from emqx_tpu.utils import replayq as jrq
from emqx_tpu_torch.apps.delayed import DelayedPublish as TDelayed
from emqx_tpu_torch.apps.retainer import Retainer as TRetainer
from emqx_tpu_torch.broker import persistence as tpers
from emqx_tpu_torch.broker.message import make as tmake
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.broker.session import Session as TSession
from emqx_tpu_torch.broker.session import SessionConf as TSessionConf
from emqx_tpu_torch.utils import replayq as trq


class Pkg:
    def __init__(self, which):
        self.which = which
        ref = which == "ref"
        self.pers = jpers if ref else tpers
        self.make = jmake if ref else tmake
        self.Session = JSession if ref else TSession
        self.SessionConf = JSessionConf if ref else TSessionConf
        self.Retainer = JRetainer if ref else TRetainer
        self.Delayed = JDelayed if ref else TDelayed

    def node(self, device_route=False):
        conf = {"broker": {"device_route": device_route}}
        if self.which == "ref":
            n = JNode(conf, use_device=device_route)
        else:
            n = TNode(conf, device="cpu")
        n.register_app(self.Retainer(n).load())
        n.register_app(self.Delayed(n).load())
        return n


PKGS = {"ref": Pkg("ref"), "port": Pkg("port")}
PAIRS = [(w, r) for w in PKGS for r in PKGS]


def restored(node, P) -> dict:
    """The durable state of a node, in a package-neutral form."""
    ret = node.get_app(P.Retainer)
    dl = node.get_app(P.Delayed)
    return {
        "routes": node.router.topics(),
        "retained": sorted((t, m.payload, m.qos, exp)
                           for t, m, exp in ret.storage.items()),
        "delayed": [(m.topic, m.payload) for _a, _s, m in dl.pending()],
        "sessions": {cid: s.to_wire()
                     for cid, s in sorted(node.cm._detached.items())},
    }


def populate(node, P):
    node.broker.subscribe(node.broker.register(object(), "c1"), "sub/+/t")
    node.broker.subscribe(node.broker.register(object(), "c2"),
                          "plain/topic")
    node.broker.publish(P.make("p", 1, "ret/1", b"keep",
                               flags={"retain": True}))
    node.broker.publish(P.make(
        "p", 0, "ret/2", b"\x00bin", flags={"retain": True},
        headers={"properties": {"message_expiry_interval": 600}}))
    node.broker.publish(P.make("p", 0, "$delayed/60/later", b"soon"))
    s = P.Session("park-1", P.SessionConf(session_expiry_interval=600))
    s.subscribe("a/b", {"qos": 1})
    s.enqueue([(P.make("x", 1, "a/b", b"queued"), {"qos": 1})])
    node.cm.park_session("park-1", s)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_snapshot_restores_in_either_package(tmp_path, writer, reader):
    W, R = PKGS[writer], PKGS[reader]
    d = str(tmp_path / "data")
    node = W.node()
    populate(node, W)
    W.pers.Persistence(node, d).save_snapshot()
    node2 = R.node()
    assert R.pers.Persistence(node2, d).load_snapshot()
    got = restored(node2, R)
    assert got == restored(node, W)
    assert "sub/+/t" in got["routes"] and got["delayed"] == [
        ("later", b"soon")]
    assert got["sessions"]["park-1"]["subscriptions"] == {"a/b": {"qos": 1}}


CLOCKS = {"ts", "id", "msgid", "node", "created_at", "fire_at",
          "expire_at"}


def scrub(o):
    """The document without its clock readings, ids and node name."""
    if isinstance(o, dict):
        return {k: scrub(v) for k, v in o.items() if k not in CLOCKS}
    if isinstance(o, list):
        return [scrub(v) for v in o]
    return o


def test_snapshot_file_equals_reference(tmp_path):
    """Both packages write the same JSON for the same state (the clock
    and the node name aside)."""
    docs = []
    for P in (PKGS["ref"], PKGS["port"]):
        d = str(tmp_path / P.which)
        node = P.node()
        populate(node, P)
        path = P.pers.Persistence(node, d).save_snapshot()
        with open(path) as f:
            doc = json.load(f)
        docs.append(scrub(doc))
    assert docs[1] == docs[0]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_wal_replays_in_either_package(tmp_path, writer, reader):
    W, R = PKGS[writer], PKGS[reader]
    d = str(tmp_path / "data")
    node = W.node()
    pers = W.pers.Persistence(node, d)
    assert W.pers.attach_retainer_journal(node)
    pers.save_snapshot()                    # empty snapshot
    node.broker.publish(W.make("p", 0, "wal/kept", b"v1",
                               flags={"retain": True}))
    node.broker.publish(W.make("p", 0, "wal/gone", b"v2",
                               flags={"retain": True}))
    node.get_app(W.Retainer).delete("wal/gone")
    pers.journal("route_add", topic="wal/+/route")
    pers.journal("route_add", topic="wal/dropped")
    pers.journal("route_del", topic="wal/dropped")
    pers.journal("no_such_op", topic="x")
    node2 = R.node()
    assert R.pers.Persistence(node2, d).load_snapshot()
    ret = node2.get_app(R.Retainer)
    assert ret.lookup("wal/kept").payload == b"v1"
    assert ret.lookup("wal/gone") is None
    assert node2.router.topics() == ["wal/+/route"]


@pytest.mark.parametrize("which", ["ref", "port"])
def test_snapshot_truncates_wal(tmp_path, which):
    P = PKGS[which]
    d = str(tmp_path / "data")
    node = P.node()
    pers = P.pers.Persistence(node, d)
    P.pers.attach_retainer_journal(node)
    node.broker.publish(P.make("p", 0, "t/1", b"x", flags={"retain": True}))
    assert pers.wal.count() == 1
    pers.save_snapshot()
    assert pers.wal.count() == 0
    node2 = P.node()
    P.pers.Persistence(node2, d).load_snapshot()
    assert node2.get_app(P.Retainer).lookup("t/1") is not None


def test_no_snapshot_replays_the_wal_alone(tmp_path):
    out = []
    for P in (PKGS["ref"], PKGS["port"]):
        d = str(tmp_path / P.which)
        node = P.node()
        pers = P.pers.Persistence(node, d)
        pers.journal("route_add", topic="only/wal")
        node2 = P.node()
        out.append((P.pers.Persistence(node2, d).load_snapshot(),
                    node2.router.topics()))
    assert out[1] == out[0] == (False, ["only/wal"])


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_replayq_segments_cross_and_skip_a_torn_tail(tmp_path, writer):
    W, R = (jrq, trq) if writer == "ref" else (trq, jrq)
    d = str(tmp_path / "q")
    q = W.ReplayQ(d, seg_bytes=64)
    items = [b"item-%d" % i * (i + 1) for i in range(12)]
    for it in items:
        q.append(it)
    segs = sorted(os.listdir(d))
    last = [s for s in segs if s.endswith(".q")][-1]
    with open(os.path.join(d, last), "ab") as f:
        f.write(b"\x00\x00\x01\x00torn")    # a write cut mid-item
    got, ref = R.ReplayQ(d, seg_bytes=64), W.ReplayQ(d, seg_bytes=64)
    assert got.count() == ref.count() == len(items)
    a, ack = got.pop(5)
    assert a == items[:5]
    got.ack(ack)
    assert W.ReplayQ(d, seg_bytes=64).pop(100)[0] == items[5:]


def test_port_load_recompiles_the_device_tables(tmp_path):
    """With the device path on, load_snapshot compiles the restored
    wildcard routes into the router's device tables."""
    P = PKGS["port"]
    d = str(tmp_path / "data")
    node = P.node()
    populate(node, P)
    P.pers.Persistence(node, d).save_snapshot()
    node2 = P.node(device_route=True)
    assert node2.router.use_device
    P.pers.Persistence(node2, d).load_snapshot()
    assert node2.router._built_row_to_filter == ["sub/+/t"]
    assert node2.router.match("sub/x/t") == ["sub/+/t"]
