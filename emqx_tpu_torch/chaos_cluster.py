"""Cluster chaos drive: node kills under continuous QoS 1 traffic, on OS
processes of ``python -m emqx_tpu_torch.run_node``.

The port's copy of ``tools/chaos_cluster.py``'s kill cycles (its SIGSTOP
cycles are not copied). A 3-process cluster where, each cycle, a
non-seed node is SIGKILLed mid-flood. Its clients re-home to a survivor
(a cross-node takeover of the same clientid against the dead owner), the
victim is restarted at new ports, and every cycle checks:

  1. CONNECT to any survivor completes fast — a dead peer must never
     park the clientid lock.
  2. QoS 1 publishes keep earning PUBACKs throughout the outage.
  3. The anchor subscriber (on the seed) resumes receiving within the
     bound — routes survive peer death.
  4. After the restart, membership converges back to 3 running nodes.
  5. A node restarted at NEW dynamic ports is deliverable-to again.
  6. A shared group with one member on the seed and one on a victim
     delivers each message exactly once at every steady state.

``lax`` multiplies every bound (the reference's ``CHAOS_LAX``) and
``device`` is the nodes' ``--device``. `run` returns each cycle's
readings: the re-homed CONNECT's seconds, the largest PUBACK wait of the
outage burst and the seconds from the kill until 3 nodes run again.

    python -m emqx_tpu_torch.chaos_cluster [cycles] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import random
import selectors
import subprocess
import sys
import time


def readline_deadline(p, timeout_s: float) -> str:
    """readline with a deadline: a node that boots but never prints READY
    fails, it does not hang the caller with an orphaned broker."""
    sel = selectors.DefaultSelector()
    sel.register(p.stdout, selectors.EVENT_READ)
    buf = b""
    deadline = time.monotonic() + timeout_s
    fd = p.stdout.fileno()
    while time.monotonic() < deadline:
        if not sel.select(timeout=0.2):
            continue
        chunk = os.read(fd, 4096)
        if not chunk:
            break
        buf += chunk
        if b"\n" in buf:
            return buf.split(b"\n", 1)[0].decode()
    p.kill()
    raise AssertionError(f"no READY line within {timeout_s}s: {buf!r}")


def spawn_node(name: str, join=None, device="cuda", procs=None,
               host_only: bool = False, timeout_s: float = 120):
    """Start one node process (``host_only``: ``--no-device``); returns
    {"p", "mqtt", "rpc", "name"}."""
    cmd = [sys.executable, "-m", "emqx_tpu_torch.run_node", "--name", name,
           "--device", device]
    if host_only:
        cmd.append("--no-device")
    if join:
        cmd += ["--join", join]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [x for x in [env.get("PYTHONPATH")] if x])
    if device == "cpu":
        # a CPU node's tensors are tiny: one intra-op thread each leaves
        # the host's cores to the other nodes and the caller
        env.setdefault("OMP_NUM_THREADS", "1")
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, env=env, cwd=root)
    rec = {"p": p, "name": name}
    if procs is not None:
        procs.append(rec)
    try:
        line = readline_deadline(p, timeout_s).strip()
        assert line.startswith("READY "), f"{name}: {line}"
    except BaseException:
        p.kill()
        raise
    _, mqtt, rpc = line.split()
    rec.update(mqtt=int(mqtt), rpc=int(rpc))
    return rec


def reap(procs) -> None:
    """Kill every node a drive spawned."""
    for pr in procs:
        if pr["p"].poll() is None:
            pr["p"].kill()
    for pr in procs:
        try:
            pr["p"].wait(5)
        except Exception:  # noqa: BLE001
            pass


async def connect_fast(port, clientid, lax):
    """Invariant 1: CONNECT to a live node completes inside 2 s (times
    lax) even right after a peer died (pre-nodedown-detection window)."""
    from emqx_tpu_torch.client import Client
    bound_s = 2.0 * lax
    c = Client(port=port, clientid=clientid)
    t0 = time.monotonic()
    await c.connect(timeout=bound_s + 3)
    dt = time.monotonic() - t0
    assert dt < bound_s, f"CONNECT took {dt:.1f}s (> {bound_s}s) on :{port}"
    c.connect_s = dt
    return c


QOS = 1
SEED = 42           # the victims' draw


def spawn_nodes(device="cuda", procs=None) -> tuple:
    """The drive's three nodes, each started once the one before it is
    READY (b and c join the seed): (seed, b, c)."""
    seed_node = spawn_node("a@127.0.0.1", device=device, procs=procs)
    join = f"127.0.0.1:{seed_node['rpc']}"
    b = spawn_node("b@127.0.0.1", join=join, device=device, procs=procs)
    c = spawn_node("c@127.0.0.1", join=join, device=device, procs=procs)
    return seed_node, b, c


async def drive(cycles: int, procs: list, lax: float = 1.0,
                device="cuda", nodes=None) -> list:
    """The kill cycles over `nodes` (``spawn_nodes``' three; started here
    when None)."""
    from emqx_tpu_torch.cluster.rpc import RpcNode
    from emqx_tpu_torch.mqtt import packet as P

    seed_node, b, c = nodes or spawn_nodes(device, procs)
    others = {"b@127.0.0.1": b, "c@127.0.0.1": c}
    rng = random.Random(SEED)
    readings: list = []

    anchor = await connect_fast(seed_node["mqtt"], "anchor", lax)
    await anchor.subscribe([("chaos/#", P.SubOpts(qos=QOS))])
    # shared-group members: one on the seed, one on a node the chaos will
    # kill
    share1 = await connect_fast(seed_node["mqtt"], "share-1", lax)
    await share1.subscribe([("$share/grp/shgrp/t", P.SubOpts(qos=QOS))])
    share2 = await connect_fast(b["mqtt"], "share-2", lax)
    await share2.subscribe([("$share/grp/shgrp/t", P.SubOpts(qos=QOS))])
    shared_epoch = 0

    def drain_shared():
        got = []
        for s in (share1, share2):
            while not s.messages.empty():
                got.append(s.messages.get_nowait().payload)
        return got

    async def check_shared(pub_client):
        """Invariant 6: a steady-state burst into the share group lands
        exactly once per message across the members, after a settle probe
        absorbs the post-heal transition (8 s, times lax)."""
        nonlocal shared_epoch
        shared_epoch += 1
        bound_s = 8.0 * lax
        drain_shared()
        t0 = time.monotonic()
        while time.monotonic() - t0 < bound_s:
            await pub_client.publish("shgrp/t", b"probe", qos=QOS,
                                     timeout=bound_s + 2)
            await asyncio.sleep(0.15)
            if b"probe" in drain_shared():
                break
        else:
            raise AssertionError("share group never resumed")
        mark = f"e{shared_epoch}-".encode()
        expected = [mark + str(i).encode() for i in range(10)]
        for p in expected:
            await pub_client.publish("shgrp/t", p, qos=QOS,
                                     timeout=bound_s + 2)
        got: list = []
        t0 = time.monotonic()
        while time.monotonic() - t0 < bound_s:
            got += [p for p in drain_shared() if p.startswith(mark)]
            if len(got) >= len(expected):
                break
            await asyncio.sleep(0.1)
        await asyncio.sleep(0.5 * lax)
        got += [p for p in drain_shared() if p.startswith(mark)]
        assert sorted(got) == sorted(expected), \
            f"shared group: want {len(expected)} exactly-once, got {got}"

    seq = 0
    received: set = set()

    async def drain_anchor():
        while not anchor.messages.empty():
            received.add(int(anchor.messages.get_nowait().payload))

    async def publish_burst(cl, n) -> float:
        """Invariant 2: every QoS 1 publish earns its PUBACK in 3 s (times
        lax); returns the largest wait."""
        nonlocal seq
        bound_s = 3.0 * lax
        worst = 0.0
        for _ in range(n):
            t0 = time.monotonic()
            await cl.publish("chaos/t", str(seq).encode(), qos=QOS,
                             timeout=bound_s + 2)
            dt = time.monotonic() - t0
            assert dt < bound_s, f"PUBACK took {dt:.1f}s"
            worst = max(worst, dt)
            seq += 1
            await asyncio.sleep(0)
        return worst

    async def wait_resume():
        """Invariant 3: the anchor sees new messages within 8 s (times
        lax)."""
        deadline_s = 8.0 * lax
        start_seq = seq
        pub2 = await connect_fast(seed_node["mqtt"], "probe-pub", lax)
        t0 = time.monotonic()
        while time.monotonic() - t0 < deadline_s:
            await publish_burst(pub2, 1)
            await asyncio.sleep(0.1)
            await drain_anchor()
            if any(s >= start_seq for s in received):
                await pub2.disconnect()
                return
        raise AssertionError(f"anchor got nothing new in {deadline_s}s")

    async def wait_members(n) -> None:
        """Invariant 4: membership converges to n running nodes within
        15 s (times lax)."""
        deadline_s = 15.0 * lax
        probe = RpcNode("probe@x", port=0)
        await probe.start()
        t0 = time.monotonic()
        try:
            probe.add_peer("seed", "127.0.0.1", seed_node["rpc"])
            last = None
            while time.monotonic() - t0 < deadline_s:
                try:
                    info = await probe.call("seed", "ekka.heartbeat",
                                            ["probe@x", None], timeout=2)
                    last = sorted(k for k, v in info.items()
                                  if v["status"] == "running"
                                  and not k.startswith("probe"))
                    if len(last) == n:
                        return
                except Exception:  # noqa: BLE001 — retry to the deadline
                    pass
                await asyncio.sleep(0.3)
            raise AssertionError(f"membership stuck at {last}, want {n}")
        finally:
            await probe.stop()

    pub = await connect_fast(b["mqtt"], "chaos-pub", lax)
    extra = await connect_fast(c["mqtt"], "extra-sub", lax)
    await extra.subscribe([("chaos/#", P.SubOpts(qos=1))])
    await publish_burst(pub, 20)
    await wait_resume()
    await check_shared(pub)

    for cycle in range(cycles):
        victim_name = rng.choice(list(others))
        victim = others[victim_name]
        print(f"[cycle {cycle}] kill -9 {victim_name}", flush=True)
        victim["p"].kill()
        victim["p"].wait(10)
        t_kill = time.monotonic()
        connect_s = None
        # clients that lived on the victim re-home to the seed with the
        # same clientid: a cross-node takeover while the old owner is an
        # undetected corpse
        if pub.port == victim["mqtt"]:
            pub = await connect_fast(seed_node["mqtt"], "chaos-pub", lax)
            connect_s = pub.connect_s
        if extra.port == victim["mqtt"]:
            extra = await connect_fast(seed_node["mqtt"], "extra-sub", lax)
            connect_s = max(connect_s or 0.0, extra.connect_s)
            await extra.subscribe([("chaos/#", P.SubOpts(qos=1))])
        if share2.port == victim["mqtt"]:
            share2 = await connect_fast(seed_node["mqtt"], "share-2", lax)
            connect_s = max(connect_s or 0.0, share2.connect_s)
            await share2.subscribe(
                [("$share/grp/shgrp/t", P.SubOpts(qos=QOS))])
        if connect_s is None:
            probe = await connect_fast(seed_node["mqtt"], f"kill-{cycle}",
                                       lax)
            connect_s = probe.connect_s
            await probe.disconnect()

        gap = await publish_burst(pub, 10)
        await wait_resume()

        fresh = spawn_node(victim_name, join=f"127.0.0.1:{seed_node['rpc']}",
                           device=device, procs=procs)
        others[victim_name] = fresh
        await wait_members(3)
        back_s = time.monotonic() - t_kill
        await publish_burst(pub, 10)
        await wait_resume()

        back = await connect_fast(fresh["mqtt"], f"back-{cycle}", lax)
        await back.subscribe([(f"back/{cycle}", P.SubOpts(qos=1))])
        t0 = time.monotonic()
        got_back = False
        while time.monotonic() - t0 < 8.0 * lax and not got_back:
            await pub.publish(f"back/{cycle}", b"x", qos=1, timeout=5)
            try:
                await asyncio.wait_for(back.messages.get(), 0.3)
                got_back = True
            except asyncio.TimeoutError:
                pass
        assert got_back, f"rejoined {victim_name} unreachable (stale peer)"
        await back.disconnect()
        await check_shared(pub)
        readings.append({"cycle": cycle,
                         "victim": victim_name, "connect_s": connect_s,
                         "puback_gap_s": gap, "to_3_running_s": back_s})
        print(f"[cycle {cycle}] healed, seq={seq}, "
              f"anchor_received={len(received)}", flush=True)

    await drain_anchor()
    missing = [s for s in range(seq) if s not in received]
    assert not missing, \
        f"anchor lost {len(missing)} messages: {missing[:10]}..."
    print(f"CHAOS OK: {cycles} cycles, {seq} published, "
          f"{len(received)} received, 0 lost", flush=True)
    for cl in (anchor, pub, extra, share1, share2):
        try:
            await cl.disconnect()
        except Exception:  # noqa: BLE001
            pass
    return readings


def run(cycles: int = 6, lax: float = 1.0, device="cuda", nodes=None,
        procs=None) -> list:
    """The whole drive (over `nodes`, started by the caller with
    ``spawn_nodes`` into `procs`, where given); every node it started, or
    was given, is gone when it returns."""
    procs = [] if procs is None else procs
    try:
        return asyncio.run(drive(cycles, procs, lax=lax, device=device,
                                 nodes=nodes))
    finally:
        reap(procs)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m emqx_tpu_torch.chaos_cluster")
    ap.add_argument("cycles", nargs="?", type=int, default=6)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--lax", type=float, default=1.0)
    a = ap.parse_args()
    for r in run(a.cycles, a.lax, a.device):
        print(r, flush=True)
