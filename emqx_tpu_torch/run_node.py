"""Boot one broker node of the port as an OS process, clustered.

The port's counterpart of ``tools/run_node.py``, with its flags and its
``READY <mqtt_port> <rpc_port>`` line:

    python -m emqx_tpu_torch.run_node --name a@127.0.0.1
        [--config etc/emqx.conf] [--mqtt-port 0] [--rpc-port 0]
        [--join host:port] [--no-device] [--device cuda|cpu]

``--device`` (default ``cuda``) is the card the node routes on; without
one the node refuses to start unless ``cpu`` is asked for. ``--no-device``
builds the host-only node (``broker.device_route = false``). ``--join``
joins the cluster a seed node belongs to; without it a config's
``cluster.discovery`` other than ``manual`` runs the autocluster. The
node prints the READY line once it serves, then runs until SIGTERM or
SIGINT. SIGUSR1 dumps every thread's stack to stderr, SIGUSR2 every
asyncio task's await chain.
"""

from __future__ import annotations

import argparse
import asyncio
import faulthandler
import signal
import sys


def _dump_tasks(loop) -> None:
    print(f"=== {len(asyncio.all_tasks(loop))} tasks ===", file=sys.stderr)
    for t in asyncio.all_tasks(loop):
        print(f"--- {t.get_name()}", file=sys.stderr)
        # walk the await chain (get_stack only shows the outer frame)
        obj = t.get_coro()
        depth = 0
        while obj is not None and depth < 40:
            fr = getattr(obj, "cr_frame", None) or \
                getattr(obj, "gi_frame", None)
            if fr is not None:
                print(f"    {fr.f_code.co_filename}:{fr.f_lineno} "
                      f"{fr.f_code.co_name}", file=sys.stderr)
            nxt = getattr(obj, "cr_await", None) or \
                getattr(obj, "gi_yieldfrom", None)
            if nxt is None:
                print(f"    -> awaiting {obj!r}"
                      if fr is None else f"    -> leaf {obj!r}",
                      file=sys.stderr)
            obj = nxt
            depth += 1
    sys.stderr.flush()


async def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m emqx_tpu_torch.run_node")
    ap.add_argument("--name", default="emqx_tpu_torch@127.0.0.1")
    ap.add_argument("--config", default=None)
    ap.add_argument("--mqtt-port", type=int, default=0)
    ap.add_argument("--rpc-port", type=int, default=0)
    ap.add_argument("--join", default=None, help="seed node host:port")
    ap.add_argument("--no-device", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from emqx_tpu_torch.broker.config import Config
    from emqx_tpu_torch.broker.connection import Listener
    from emqx_tpu_torch.broker.node import Node
    from emqx_tpu_torch.cluster import ClusterNode

    join_addr = None
    if args.join:
        host, sep, port = args.join.rpartition(":")
        if not sep or not host or not port.isdigit():
            ap.error(f"--join expects host:port, got {args.join!r}")
        join_addr = (host, int(port))
    if args.config and args.mqtt_port:
        ap.error("--mqtt-port has no effect with --config "
                 "(set the port in the config's listeners block)")

    config = Config.load_file(args.config) if args.config else Config()
    if args.no_device:
        config.put(("broker", "device_route"), False)
    node = Node(config, device=args.device, name=args.name)
    if args.config:
        listeners = await node.start_listeners()
        # advertise the first plain MQTT TCP listener (a ws port would
        # mislead a TCP harness)
        tcp = [lst for lst in listeners if isinstance(lst, Listener)]
        mqtt_port = tcp[0].port if tcp else 0
    else:
        lst = Listener(node, bind="127.0.0.1", port=args.mqtt_port)
        await lst.start()
        node.listeners.append(lst)
        mqtt_port = lst.port

    rpc_conf = node.config.get("rpc") or {}
    cluster_conf = node.config.get("cluster") or {}
    cn = ClusterNode(node, port=args.rpc_port,
                     cookie=cluster_conf.get("cookie", "emqxsecretcookie"),
                     rpc_mode=rpc_conf.get("mode", "async"))
    if rpc_conf.get("tcp_client_num"):
        cn.rpc.n_channels = int(rpc_conf["tcp_client_num"])
    await cn.start()
    if join_addr:
        await cn.join(*join_addr)
    elif cluster_conf.get("discovery", "manual") != "manual":
        # config-driven autocluster (static/dns/etcd/k8s/mcast seeds)
        from emqx_tpu_torch.cluster.discovery import autocluster
        await autocluster(cn)

    node.start_timers()
    if args.config:
        # config-driven feature apps and the management API (after the
        # cluster start, so the API sees the cluster view)
        await node.start_apps()
        await node.start_dashboard()
        await node.start_gateways()
    print(f"READY {mqtt_port} {cn.address[1]}", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    loop.add_signal_handler(signal.SIGUSR2, _dump_tasks, loop)
    await stop.wait()
    await cn.stop()
    await node.stop_listeners()
    node.stop_timers()
    eng = node.device_engine
    if eng is not None and hasattr(eng, "close"):
        eng.close()


if __name__ == "__main__":
    faulthandler.register(signal.SIGUSR1)
    asyncio.run(main())
