"""The port's node process: ``python -m emqx_tpu_torch.run_node``.

Two OS processes (one on the CPU device engine, ``--device cpu``, one
host-only, ``--no-device``) join through ``--join`` and serve MQTT
clients across the node boundary both ways; killing one leaves the other
serving and its membership marks the dead node down.
Without ``--device cpu`` the process refuses to start when the host has
no card, as the reference's ``tools/run_node.py`` refuses bad flags.
"""

import asyncio
import os
import signal
import subprocess
import sys

import pytest
import torch

from emqx_tpu_torch import chaos_cluster as cc
from emqx_tpu_torch.client import Client
from emqx_tpu_torch.cluster.rpc import RpcNode
from emqx_tpu_torch.mqtt import packet as P

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture()
def two_nodes():
    procs: list = []
    try:
        a = cc.spawn_node("a@127.0.0.1", device="cpu", procs=procs)
        b = cc.spawn_node("b@127.0.0.1", join=f"127.0.0.1:{a['rpc']}",
                          device="cpu", host_only=True, procs=procs)
        yield a, b
    finally:
        for pr in procs:
            if pr["p"].poll() is None:
                pr["p"].send_signal(signal.SIGTERM)
        for pr in procs:
            try:
                pr["p"].wait(timeout=10)
            except subprocess.TimeoutExpired:
                pr["p"].kill()


async def _deliver_until(pub, sub, topic, payload, tries=100):
    for i in range(tries):
        await pub.publish(topic, payload, qos=0)
        try:
            return await asyncio.wait_for(sub.messages.get(), 0.2)
        except asyncio.TimeoutError:
            continue
    return None


async def _running(rpc_port):
    probe = RpcNode("probe@x", port=0)
    await probe.start()
    try:
        probe.add_peer("n", "127.0.0.1", rpc_port)
        info = await probe.call("n", "ekka.heartbeat", ["probe@x", None],
                                timeout=2)
        return sorted(k for k, v in info.items() if v["status"] == "running"
                      and not k.startswith("probe"))
    finally:
        await probe.stop()


def test_cross_process_pubsub_and_node_death(two_nodes):
    a, b = two_nodes

    async def go():
        assert await _running(a["rpc"]) == ["a@127.0.0.1", "b@127.0.0.1"]
        sub = Client(port=a["mqtt"], clientid="sub-a")
        await sub.connect()
        await sub.subscribe([("x/cross/#", P.SubOpts(qos=0))])
        pub = Client(port=b["mqtt"], clientid="pub-b")
        await pub.connect()
        got = await _deliver_until(pub, sub, "x/cross/1", b"hello")
        assert got is not None and got.payload == b"hello"

        sub2 = Client(port=b["mqtt"], clientid="sub-b")
        await sub2.connect()
        await sub2.subscribe([("y/back", P.SubOpts(qos=1))])
        pub2 = Client(port=a["mqtt"], clientid="pub-a")
        await pub2.connect()
        got2 = await _deliver_until(pub2, sub2, "y/back", b"rsvp")
        assert got2 is not None and got2.payload == b"rsvp"
        for c in (sub, pub, sub2, pub2):
            await c.disconnect()

        # b dies: a keeps serving, marks b down and drops its routes
        b["p"].kill()
        b["p"].wait(timeout=10)
        for _ in range(100):
            if await _running(a["rpc"]) == ["a@127.0.0.1"]:
                break
            await asyncio.sleep(0.1)
        assert await _running(a["rpc"]) == ["a@127.0.0.1"]
        c = Client(port=a["mqtt"], clientid="local-a")
        await c.connect()
        await c.subscribe([("alive/check", P.SubOpts(qos=1))])
        await c.publish("alive/check", b"ping", qos=1)
        got3 = await asyncio.wait_for(c.messages.get(), 5)
        assert got3.payload == b"ping"
        # y/back was b's route: a QoS 1 PUBLISH to it is still acked
        # (nothing waits on the dead node)
        assert await c.publish("y/back", b"gone", qos=1, timeout=5)
        await c.disconnect()

    asyncio.run(asyncio.wait_for(go(), 60))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_refuses_to_start_without_a_card():
    r = subprocess.run([sys.executable, "-m", "emqx_tpu_torch.run_node",
                        "--name", "x@127.0.0.1"],
                       capture_output=True, text=True, timeout=60, cwd=REPO)
    assert r.returncode != 0
    assert "READY" not in r.stdout
    assert "no CUDA device" in r.stderr


@pytest.mark.parametrize("argv", [["--join", "no-port"],
                                  ["--device", "tpu"],
                                  ["--config", "x.conf", "--mqtt-port", "1"]])
def test_bad_flags_exit_as_usage_errors(argv):
    r = subprocess.run([sys.executable, "-m", "emqx_tpu_torch.run_node",
                        "--device", "cpu"] + argv,
                       capture_output=True, text=True, timeout=60, cwd=REPO)
    assert r.returncode == 2
    assert "usage: python -m emqx_tpu_torch.run_node" in r.stderr
