"""MQTT bridge: forward local topics to a remote broker and ingress
remote topics into the local one.

Parity: apps/emqx_bridge_mqtt/src/emqx_bridge_worker.erl — gen_statem
idle -> connecting -> connected (:41-49,81-82) with a replayq disk-backed
resend queue (:142-143,211-217): forwards are appended to the queue first
and drained to the remote with acks, so messages survive remote outages and
worker restarts; ingress subscriptions republish into the local broker
under a mountpoint prefix.

The port's copy of ``emqx_tpu/resources/bridge_mqtt.py``, over the
port's ``utils/replayq.py``: a queue directory written by either
package's worker replays in the other's. ``deliver`` encodes the message
at once (a columnar burst's payload may be a view of the read buffer
the next read reuses).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from emqx_tpu_torch.broker.message import Message, make
from emqx_tpu_torch.utils.replayq import ReplayQ

log = logging.getLogger("emqx_tpu_torch.bridge_mqtt")


class MqttBridgeWorker:
    def __init__(self, node, name: str, conf: dict):
        self.node = node
        self.name = name
        self.conf = conf
        self.state = "idle"                 # idle|connecting|connected
        self.forwards: list[str] = list(conf.get("forwards", []))
        self.subscriptions = list(conf.get("subscriptions", []))
        self.forward_mountpoint = conf.get("forward_mountpoint", "")
        self.receive_mountpoint = conf.get("receive_mountpoint", "")
        self.reconnect_interval = conf.get("reconnect_interval", 2.0)
        self.batch_size = conf.get("batch_size", 32)
        self.queue = ReplayQ(conf.get("queue_dir"),
                             seg_bytes=conf.get("seg_bytes", 10 << 20))
        self.client = None
        self.sid: Optional[int] = None
        self._tasks: list[asyncio.Task] = []
        self._stopping = False
        self._wakeup = asyncio.Event()

    # ---- local subscriber protocol (forward side) ----
    def deliver(self, topic_filter: str, msg: Message) -> bool:
        self.queue.append(json.dumps(msg.to_wire(),
                                     default=_b64).encode())
        self._wakeup.set()
        return True

    # ---- lifecycle ----
    async def start(self) -> None:
        self._stopping = False
        if self.forwards:
            self.sid = self.node.broker.register(
                self, f"bridge:{self.name}")
            for f in self.forwards:
                self.node.broker.subscribe(self.sid, f, {"qos": 1})
        self._tasks.append(asyncio.create_task(self._conn_loop()))
        self._tasks.append(asyncio.create_task(self._drain_loop()))

    async def stop(self) -> None:
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        self._tasks = []
        if self.sid is not None:
            self.node.broker.subscriber_down(self.sid)
            self.sid = None
        await self._disconnect()
        self.state = "idle"

    async def _disconnect(self) -> None:
        if self.client is not None:
            try:
                await self.client.disconnect()
            except Exception:  # noqa: BLE001
                pass
            self.client = None

    # ---- connection FSM ----
    async def _conn_loop(self) -> None:
        while not self._stopping:
            if self.state != "connected":
                await self._try_connect()
            await asyncio.sleep(self.reconnect_interval)

    async def _try_connect(self) -> None:
        from emqx_tpu_torch.client import Client
        self.state = "connecting"
        await self._disconnect()
        try:
            self.client = Client(
                host=self.conf.get("host", "127.0.0.1"),
                port=self.conf.get("port", 1883),
                clientid=self.conf.get("clientid",
                                       f"bridge-{self.name}"),
                username=self.conf.get("username"),
                password=self.conf.get("password"),
                clean_start=False,
                ssl=self.conf.get("ssl"))  # emqx-style client tls opts dict
            await self.client.connect()
            for sub in self.subscriptions:
                topic = sub["topic"] if isinstance(sub, dict) else sub
                qos = sub.get("qos", 1) if isinstance(sub, dict) else 1
                await self.client.subscribe(topic, qos=qos)
            self.state = "connected"
            self._wakeup.set()
            t = asyncio.create_task(self._ingress_loop())
            self._tasks.append(t)
            # prune finished ingress tasks so a flapping remote can't grow
            # the list without bound
            t.add_done_callback(
                lambda t: self._tasks.remove(t)
                if t in self._tasks else None)
            log.info("bridge %s connected to %s:%s", self.name,
                     self.conf.get("host"), self.conf.get("port"))
        except Exception as e:  # noqa: BLE001
            log.info("bridge %s connect failed: %s", self.name, e)
            self.state = "connecting"

    # ---- egress: drain replayq to remote ----
    async def _drain_loop(self) -> None:
        while not self._stopping:
            self._wakeup.clear()
            if self.state != "connected" or self.queue.is_empty():
                try:
                    await asyncio.wait_for(self._wakeup.wait(), 1.0)
                except asyncio.TimeoutError:
                    pass
                continue
            items, ref = self.queue.pop(self.batch_size)
            if not items:
                continue
            try:
                for raw in items:
                    wire = json.loads(raw)
                    await self.client.publish(
                        self.forward_mountpoint + wire["topic"],
                        _unb64(wire["payload"]),
                        qos=min(wire["qos"], 1))
                self.queue.ack(ref)
            except Exception as e:  # noqa: BLE001
                # remote died mid-batch: ref not acked, items replay
                log.info("bridge %s drain failed (%s); will replay",
                         self.name, e)
                self.state = "connecting"
                await asyncio.sleep(self.reconnect_interval)

    # ---- ingress: remote messages -> local broker ----
    async def _ingress_loop(self) -> None:
        client = self.client
        while not self._stopping and self.state == "connected" \
                and self.client is client:
            try:
                pkt = await client.recv(timeout=1.0)
            except asyncio.TimeoutError:
                continue
            except Exception:  # noqa: BLE001
                self.state = "connecting"
                return
            msg = make(f"bridge:{self.name}", pkt.qos,
                       self.receive_mountpoint + pkt.topic, pkt.payload)
            await self.node.broker.publish_async(msg)

    def info(self) -> dict:
        return {"name": self.name, "state": self.state,
                "queue_len": self.queue.count(),
                "forwards": self.forwards,
                "subscriptions": self.subscriptions}


def _b64(o):
    if isinstance(o, (bytes, bytearray, memoryview)):
        import base64
        return {"$b": base64.b64encode(bytes(o)).decode()}
    return repr(o)


def _unb64(v):
    if isinstance(v, dict) and "$b" in v:
        import base64
        return base64.b64decode(v["$b"])
    return v.encode() if isinstance(v, str) else bytes(v)
