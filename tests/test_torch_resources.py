"""Port vs JAX reference: the resource manager and the MQTT bridge.

Each scenario of the reference's ``tests/test_resources.py`` runs over the
reference's ``emqx_tpu/resources`` and ``utils/replayq.py`` (with its
``Node``, ``Listener`` and ``Client``) and over the port's copies, and the
two transcripts must be equal: the replay queue in memory and on disk,
the MQTT resource's lifecycle, its health loop through a remote outage,
the ``data_to_<id>`` rule action, the bridge's forward, ingress and
outage replay. Beside them, the state a bridge carries over a restart: a
queue directory the reference's ``MqttBridgeWorker`` filled while its
remote was down is replayed, in order, by the port's worker, and the
other way round. Waits are bounded polls, never fixed sleeps.
"""

import asyncio
import json
import socket
import types

import pytest
import torch

from emqx_tpu.broker.connection import Listener as JListener
from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.resources import MqttBridgeWorker as JBridge
from emqx_tpu.resources import ResourceManager as JRM
from emqx_tpu.rules import RuleEngine as JRuleEngine
from emqx_tpu.utils.replayq import ReplayQ as JReplayQ
from emqx_tpu_torch.broker.connection import Listener as TListener
from emqx_tpu_torch.broker.message import make as tmake
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.resources import MqttBridgeWorker as TBridge
from emqx_tpu_torch.resources import ResourceManager as TRM
from emqx_tpu_torch.rules import RuleEngine as TRuleEngine
from emqx_tpu_torch.utils.replayq import ReplayQ as TReplayQ

import emqx_tpu.resources.db  # noqa: F401,E402  (registers the DB types)
import emqx_tpu_torch.resources.db  # noqa: F401,E402

torch.set_num_threads(1)

NAME = "emqx_tpu@127.0.0.1"
TIMEOUT_S = 30

REF = types.SimpleNamespace(
    name="ref", ReplayQ=JReplayQ, RM=JRM, Bridge=JBridge, make=jmake,
    Listener=JListener, RuleEngine=JRuleEngine,
    node=lambda: JNode({}, use_device=False, name=NAME))
PORT = types.SimpleNamespace(
    name="port", ReplayQ=TReplayQ, RM=TRM, Bridge=TBridge, make=tmake,
    Listener=TListener, RuleEngine=TRuleEngine,
    node=lambda: TNode({"broker": {"device_route": False}}, device="cpu",
                       name=NAME))
PKGS = (REF, PORT)


def twin(script):
    """The script's result under the reference and under the port."""
    outs = [script(pkg) for pkg in PKGS]
    assert outs[0] == outs[1]
    return outs[1]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


async def until(cond, limit: float = 10.0) -> bool:
    """Poll `cond` every 20 ms for at most `limit` seconds."""
    loop = asyncio.get_running_loop()
    t_end = loop.time() + limit
    while not cond():
        if loop.time() > t_end:
            return False
        await asyncio.sleep(0.02)
    return True


class Capture:
    def __init__(self):
        self.msgs = []

    def deliver(self, f, m):
        self.msgs.append(m)
        return True


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------
# ReplayQ
# ---------------------------------------------------------------------
class TestReplayQ:
    def test_mem_mode(self):
        def script(P):
            q = P.ReplayQ()
            q.append(b"a")
            q.append(b"b")
            items, ref = q.pop(5)
            q.ack(ref)
            return items, q.is_empty(), q.count()
        assert twin(script) == ([b"a", b"b"], True, 0)

    def test_disk_append_pop_ack(self, tmp_path):
        def script(P):
            q = P.ReplayQ(str(tmp_path / P.name))
            for i in range(10):
                q.append(b"item-%d" % i)
            items, ref = q.pop(4)
            q.ack(ref)
            more, _ = q.pop(3)
            return items, more, q.count()
        out = twin(script)
        assert out[0] == [b"item-0", b"item-1", b"item-2", b"item-3"]
        assert out[1] == [b"item-4", b"item-5", b"item-6"]

    def test_unacked_items_survive_restart(self, tmp_path):
        def script(P):
            d = str(tmp_path / P.name)
            q = P.ReplayQ(d)
            for i in range(5):
                q.append(b"m%d" % i)
            _, ref = q.pop(2)
            q.ack(ref)
            popped, _ref = q.pop(2)      # popped but NOT acked
            q2 = P.ReplayQ(d)            # a crash and a restart
            items, ref = q2.pop(10)
            q2.ack(ref)
            return popped, items, P.ReplayQ(d).is_empty()
        assert twin(script) == ([b"m2", b"m3"], [b"m2", b"m3", b"m4"], True)

    def test_segment_rotation(self, tmp_path):
        def script(P):
            d = tmp_path / P.name
            q = P.ReplayQ(str(d), seg_bytes=64)
            for i in range(20):
                q.append(b"x" * 16)
            n = q.count()
            segs = sorted(p.name for p in d.iterdir())
            items, ref = q.pop(20)
            q.ack(ref)
            return n, segs, len(items), q.is_empty()
        out = twin(script)
        assert out[0] == out[2] == 20 and len(out[1]) > 1 and out[3]


# ---------------------------------------------------------------------
# The resource manager
# ---------------------------------------------------------------------
class TestResourceManager:
    def test_mqtt_resource_lifecycle(self):
        async def go(P):
            remote = P.node()
            lst = P.Listener(remote, bind="127.0.0.1", port=0)
            await lst.start()
            node = P.node()
            rm = P.RM(node, health_interval=0.1)
            res = await rm.create("r1", "mqtt", {"port": lst.port})
            out = [res.status, await res.health_check()]
            cap = Capture()
            remote.broker.subscribe(remote.broker.register(cap, "c"),
                                    "res/#")
            out.append(await res.query({"topic": "res/t",
                                        "payload": b"ping"}))
            assert await until(lambda: cap.msgs)
            out += [[m.payload for m in cap.msgs], rm.list()]
            out += [await rm.remove("r1"), await rm.remove("r1"), rm.list()]
            await lst.stop()
            return out
        out = twin(lambda P: run(go(P)))
        assert out[:4] == ["connected", True, True, [b"ping"]]
        assert out[5:] == [True, False, []]

    def test_unknown_type_rejected(self):
        def script(P):
            rm = P.RM(P.node())
            with pytest.raises(ValueError) as ei:
                run(rm.create("x", "nope", {}))
            return str(ei.value), sorted(rm.RESOURCE_TYPES)
        out = twin(script)
        assert out[0] == "unknown resource type nope"
        assert out[1] == ["http", "ldap", "mongo", "mqtt", "mysql", "pgsql",
                          "redis"]

    def test_rule_action_via_resource(self):
        async def go(P):
            remote = P.node()
            lst = P.Listener(remote, bind="127.0.0.1", port=0)
            await lst.start()
            cap = Capture()
            remote.broker.subscribe(remote.broker.register(cap, "c"),
                                    "sink/#")
            node = P.node()
            rm = P.RM(node)
            await rm.create("sink", "mqtt", {"port": lst.port})
            eng = P.RuleEngine(node).load()
            eng.create_rule(
                'SELECT payload.v as v, topic FROM "src/#"',
                [{"name": "data_to_sink",
                  "params": {"target_topic": "sink/${topic}",
                             "payload_tmpl": '{"fwd":${v}}'}},
                 {"name": "data_to_nowhere", "params": {}}])
            out = [rm.has_action("data_to_sink"),
                   rm.has_action("data_to_nowhere"), rm.has_action("sink")]
            node.broker.publish(P.make("p", 0, "src/a",
                                       json.dumps({"v": 9}).encode()))
            assert await until(lambda: cap.msgs)
            out += [(m.topic, json.loads(m.payload)) for m in cap.msgs]
            rule = eng.list_rules()[0]
            out.append({k: v for k, v in rule.metrics.counters.items()
                        if k.startswith("actions")})
            await rm.remove("sink")
            await lst.stop()
            return out
        out = twin(lambda P: run(go(P)))
        assert out[:4] == [True, False, False, ("sink/src/a", {"fwd": 9})]

    def test_health_loop_follows_an_outage(self):
        """The health loop (``health_interval`` shrunk to 0.05 s) flips an
        MQTT resource to disconnected when its remote stops, restarts it
        each pass, and reads connected again once the remote listens on
        the same port; ``stop_health_checks`` ends the loop."""
        async def go(P):
            port = _free_port()
            remote = P.node()
            lst = P.Listener(remote, bind="127.0.0.1", port=port)
            await lst.start()
            rm = P.RM(P.node(), health_interval=0.05)
            res = await rm.create("h", "mqtt", {"port": port})
            rm.start_health_checks()
            out = [res.status]
            await lst.stop()
            out.append(await until(lambda: res.status == "disconnected"))
            lst = P.Listener(remote, bind="127.0.0.1", port=port)
            await lst.start()
            out.append(await until(lambda: res.status == "connected"))
            rm.stop_health_checks()
            out.append(rm._health_task is None)
            await rm.remove("h")
            await lst.stop()
            return out
        assert twin(lambda P: run(go(P))) == ["connected", True, True, True]


# ---------------------------------------------------------------------
# The MQTT bridge
# ---------------------------------------------------------------------
class TestMqttBridge:
    def test_forward_and_ingress(self, tmp_path):
        async def go(P):
            remote = P.node()
            rlst = P.Listener(remote, bind="127.0.0.1", port=0)
            await rlst.start()
            local = P.node()
            bridge = P.Bridge(local, "b1", {
                "host": "127.0.0.1", "port": rlst.port,
                "forwards": ["out/#"],
                "subscriptions": [{"topic": "cmd/#", "qos": 1}],
                "forward_mountpoint": "from-local/",
                "receive_mountpoint": "from-remote/",
                "queue_dir": str(tmp_path / P.name),
                "reconnect_interval": 0.2})
            await bridge.start()
            assert await until(lambda: bridge.state == "connected")
            rcap = Capture()
            remote.broker.subscribe(
                remote.broker.register(rcap, "rc"), "from-local/#")
            local.broker.publish(P.make("c", 1, "out/temp", b"fwd"))
            assert await until(lambda: rcap.msgs)
            lcap = Capture()
            local.broker.subscribe(
                local.broker.register(lcap, "lc"), "from-remote/#")
            remote.broker.publish(P.make("r", 0, "cmd/go", b"ing"))
            assert await until(lambda: lcap.msgs)
            info = bridge.info()
            await bridge.stop()
            await rlst.stop()
            return ([(m.topic, m.payload, m.qos) for m in rcap.msgs],
                    [(m.topic, m.payload, m.from_) for m in lcap.msgs],
                    info, bridge.state)
        out = twin(lambda P: run(go(P)))
        assert out[0] == [("from-local/out/temp", b"fwd", 1)]
        assert out[1] == [("from-remote/cmd/go", b"ing", "bridge:b1")]

    def test_outage_buffers_and_replays(self, tmp_path):
        async def go(P):
            port = _free_port()
            local = P.node()
            bridge = P.Bridge(local, "b2", {
                "host": "127.0.0.1", "port": port, "forwards": ["q/#"],
                "queue_dir": str(tmp_path / P.name),
                "reconnect_interval": 0.2})
            await bridge.start()         # the remote is not up yet
            for i in range(5):
                local.broker.publish(P.make("c", 1, "q/m", b"%d" % i))
            out = [bridge.queue.count(), bridge.state != "connected"]
            remote = P.node()
            rlst = P.Listener(remote, bind="127.0.0.1", port=port)
            await rlst.start()
            rcap = Capture()
            remote.broker.subscribe(remote.broker.register(rcap, "rc"),
                                    "q/#")
            assert await until(lambda: len(rcap.msgs) == 5)
            assert await until(bridge.queue.is_empty)
            out += [[m.payload for m in rcap.msgs], bridge.queue.count()]
            await bridge.stop()
            await rlst.stop()
            return out
        assert twin(lambda P: run(go(P))) == [
            5, True, [b"0", b"1", b"2", b"3", b"4"], 0]

    def test_append_after_full_drain_stays_visible(self, tmp_path):
        def script(P):
            d = str(tmp_path / P.name)
            q = P.ReplayQ(d)
            q.append(b"a")
            first, ref = q.pop(10)
            q.ack(ref)
            empty = q.is_empty()
            q.append(b"b")               # appended AFTER the drain
            n = q.count()
            items, ref = q.pop(10)
            q.ack(ref)
            return first, empty, n, items, P.ReplayQ(d).is_empty()
        assert twin(script) == ([b"a"], True, 1, [b"b"], True)


# ---------------------------------------------------------------------
# The bridge's queue carried across the packages
# ---------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_bridge_queue_replays_in_the_other_package(tmp_path, writer):
    """A worker of one package queues 50 forwards (payloads of every byte
    value, QoS 0 and 1) while its remote is down and stops; a worker of
    the other package opened on the same queue directory sends them all
    to a live remote once, in publish order, and empties the queue."""
    W, R = (REF, PORT) if writer == "ref" else (PORT, REF)
    qdir = str(tmp_path / "bq")
    conf = {"host": "127.0.0.1", "forwards": ["c/#"], "queue_dir": qdir,
            "forward_mountpoint": "m/", "reconnect_interval": 0.1}
    sent = [(f"c/{k % 3}", bytes([k, 255 - k]) * (k + 1), k % 2)
            for k in range(50)]

    async def fill():
        local = W.node()
        bridge = W.Bridge(local, "carry", dict(conf, port=_free_port()))
        await bridge.start()
        for topic, payload, qos in sent:
            local.broker.publish(W.make("c", qos, topic, payload))
        n = bridge.queue.count()
        await bridge.stop()
        return n

    async def replay():
        remote = R.node()
        rlst = R.Listener(remote, bind="127.0.0.1", port=0)
        await rlst.start()
        rcap = Capture()
        remote.broker.subscribe(remote.broker.register(rcap, "rc"), "m/#")
        local = R.node()
        bridge = R.Bridge(local, "carry", dict(conf, port=rlst.port))
        await bridge.start()
        assert await until(lambda: len(rcap.msgs) >= len(sent))
        assert await until(bridge.queue.is_empty)
        await bridge.stop()
        await rlst.stop()
        return [(m.topic, m.payload, m.qos) for m in rcap.msgs]
    assert run(fill()) == len(sent)
    got = run(replay())
    assert got == [("m/" + t, p, q) for t, p, q in sent]


def test_append_between_pop_and_ack_is_kept(tmp_path):
    """A departure on purpose (the bridge appends while it drains): an
    item appended after a pop that emptied the write segment, and before
    that pop's ack, stays in the port's queue. The reference's pop moves
    its ack past the write segment, the ack deletes that segment, and the
    item is gone while the count still holds it (its bridge's drain loop
    then spins on an empty pop)."""
    def script(P):
        d = str(tmp_path / P.name)
        q = P.ReplayQ(d)
        q.append(b"a")
        items, ref = q.pop(10)
        q.append(b"b")               # arrives while "a" is in flight
        q.ack(ref)
        after, ref2 = q.pop(10)
        if ref2 is not None:
            q.ack(ref2)
        return items, q.count(), after, P.ReplayQ(d).count()
    ref, port = (script(P) for P in PKGS)
    # lost from disk (a reopened queue counts 0), still counted in memory
    assert ref == ([b"a"], 1, [], 0)
    assert port == ([b"a"], 0, [b"b"], 0)
