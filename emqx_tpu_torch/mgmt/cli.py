"""Management CLI: the emqx_ctl command surface.

Parity: emqx_ctl.erl (command registry) + emqx_mgmt_cli.erl:143-259 —
status, broker [stats|metrics], cluster join/leave/force-leave/status,
clients list/show/kick, routes list/show, subscriptions
list/show/add/del, plugins, vm, listeners, mgmt (API apps), banned, rules,
trace. Commands are async; output is returned as text (and printed by the
`emqx_ctl` entry point). The port's copy of ``emqx_tpu/mgmt/cli.py``;
``trace device`` drives the engine's torch.profiler trace of the card.
"""

from __future__ import annotations

from typing import Awaitable, Callable, Optional

from emqx_tpu_torch.mgmt.mgmt import Mgmt

Command = Callable[..., Awaitable[str]]


class Cli:
    def __init__(self, node, mgmt: Optional[Mgmt] = None, cluster=None,
                 app_auth=None):
        self.node = node
        self.cluster = cluster
        self.mgmt = mgmt or Mgmt(node, cluster)
        self.app_auth = app_auth
        self._commands: dict[str, tuple[Command, str]] = {}
        self._register_builtins()

    # ---- registry (emqx_ctl:register_command) ----
    def register_command(self, name: str, fn: Command, usage: str) -> None:
        self._commands[name] = (fn, usage)

    def unregister_command(self, name: str) -> None:
        self._commands.pop(name, None)

    async def run(self, argv: list[str]) -> str:
        if not argv or argv[0] in ("help", "--help"):
            return self.usage()
        cmd = self._commands.get(argv[0])
        if cmd is None:
            return f"unknown command {argv[0]!r}\n" + self.usage()
        try:
            return await cmd[0](argv[1:])
        except (_Usage, ValueError):
            # bad numeric args etc. print the usage line, not a traceback
            return cmd[1]

    def usage(self) -> str:
        lines = ["Usage:"]
        for name in sorted(self._commands):
            lines.append(f"  {self._commands[name][1]}")
        return "\n".join(lines)

    def _register_builtins(self) -> None:
        r = self.register_command
        r("status", self._status, "status                 # broker status")
        r("broker", self._broker,
          "broker [stats|metrics] # broker info/stats/metrics")
        r("cluster", self._cluster,
          "cluster join <host:port> | leave | force-leave <node> | status")
        r("clients", self._clients,
          "clients list | show <clientid> | kick <clientid>")
        r("routes", self._routes, "routes list | show <topic>")
        r("topics", self._routes, "topics list | show <topic>")
        r("subscriptions", self._subs,
          "subscriptions list | show <clientid> | "
          "add <clientid> <topic> <qos> | del <clientid> <topic>")
        r("plugins", self._plugins, "plugins list")
        r("listeners", self._listeners, "listeners              # list")
        r("vm", self._vm, "vm                     # runtime load/memory")
        r("banned", self._banned,
          "banned list | add <as> <who> [<seconds>] | del <as> <who>")
        r("rules", self._rules, "rules list | show <id> | delete <id>")
        r("mgmt", self._mgmt,
          "mgmt list | insert <app_id> <name> | delete <app_id>")
        r("trace", self._trace,
          "trace start client|topic <value> <file> | "
          "trace stop client|topic <value> | trace list | "
          "trace device start <dir> | trace device stop")

    # ---- commands ----
    async def _trace(self, args) -> str:
        """emqx_ctl trace analog, plus the device-side torch.profiler
        trace: `trace device start <dir>` records every route dispatch as
        a profiler range, so the card's kernels decompose from host time
        in the captured trace."""
        if not args:
            raise _Usage()
        if args[0] == "device":
            eng = getattr(self.node, "device_engine", None)
            if eng is None or not hasattr(eng, "start_device_trace"):
                return "device routing is not enabled on this node"
            if args[1:2] == ["start"] and len(args) == 3:
                ok = eng.start_device_trace(args[2])
                return ("device trace started" if ok
                        else "a device trace is already running")
            if args[1:2] == ["stop"]:
                eng.stop_device_trace()
                return "device trace stopped"
            raise _Usage()
        from emqx_tpu_torch.apps.tracer import Tracer
        tr = self.node.get_app(Tracer)
        if tr is None:
            tr = self.node.register_app(Tracer(self.node).load())
        if args[0] == "list":
            rows = tr.lookup_traces()
            if not rows:
                return "no traces"
            return "\n".join(f"{r['type']:<9} {r['value']:<24} {r['path']}"
                             for r in rows)
        if args[0] == "start" and len(args) == 4 \
                and args[1] in ("client", "topic"):
            kind = "clientid" if args[1] == "client" else "topic"
            return ("trace started" if tr.start_trace(kind, args[2], args[3])
                    else "already tracing that")
        if args[0] == "stop" and len(args) == 3 \
                and args[1] in ("client", "topic"):
            kind = "clientid" if args[1] == "client" else "topic"
            return ("trace stopped" if tr.stop_trace(kind, args[2])
                    else "no such trace")
        raise _Usage()

    async def _status(self, _args) -> str:
        info = (await self.mgmt.list_brokers())[0]
        return (f"Node {self.node.name} is started\n"
                f"emqx_tpu {info['version']} is running")

    async def _broker(self, args) -> str:
        if not args:
            b = (await self.mgmt.list_brokers())[0]
            return "\n".join(f"{k:<12}: {v}" for k, v in b.items())
        if args[0] == "stats":
            s = await self.mgmt.stats(aggregate=True)
            return "\n".join(f"{k:<40}: {v}" for k, v in sorted(s.items()))
        if args[0] == "metrics":
            m = await self.mgmt.metrics(aggregate=True)
            return "\n".join(f"{k:<40}: {v}" for k, v in sorted(m.items()))
        raise _Usage()

    async def _cluster(self, args) -> str:
        if not args:
            raise _Usage()
        if self.cluster is None:
            return "node is not running in cluster mode"
        if args[0] == "status":
            info = self.cluster.info()
            return "\n".join(
                [f"Cluster status: {len(info['members'])} node(s)"] +
                [f"  {n}: {m['status']}"
                 for n, m in sorted(info["members"].items())])
        if args[0] == "join" and len(args) == 2:
            host, _, port = args[1].partition(":")
            await self.cluster.join(host, int(port or 5370))
            return f"Join the cluster successfully.\n" \
                   f"Cluster status: {self.cluster.info()['members']}"
        if args[0] == "leave" and len(args) == 1:
            await self.cluster.leave()
            return "Leave the cluster successfully."
        if args[0] == "force-leave" and len(args) == 2:
            await self.cluster.membership.force_leave(args[1])
            return f"Remove the node from cluster successfully: {args[1]}"
        raise _Usage()

    async def _clients(self, args) -> str:
        if args and args[0] == "list":
            rows = await self.mgmt.list_clients()
            return "\n".join(
                f"Client({c['clientid']}, username={c.get('username')}, "
                f"node={c.get('node')}, connected={c.get('connected')})"
                for c in rows) or "(none)"
        if len(args) == 2 and args[0] == "show":
            c = await self.mgmt.lookup_client(args[1])
            return f"Client({c})" if c else "Not Found."
        if len(args) == 2 and args[0] == "kick":
            ok = await self.mgmt.kick_client(args[1])
            return "ok" if ok else "Not Found."
        raise _Usage()

    async def _routes(self, args) -> str:
        if args and args[0] == "list":
            return "\n".join(f"{r['topic']} -> {','.join(r['node'])}"
                             for r in self.mgmt.list_routes()) or "(none)"
        if len(args) == 2 and args[0] == "show":
            r = self.mgmt.lookup_route(args[1])
            return f"{r['topic']} -> {','.join(r['node'])}" if r \
                else "Not Found."
        raise _Usage()

    async def _subs(self, args) -> str:
        if args and args[0] == "list":
            rows = await self.mgmt.list_subscriptions()
            return "\n".join(
                f"{s['clientid']} -> {s['topic']} (qos={s['qos']})"
                for s in rows) or "(none)"
        if len(args) == 2 and args[0] == "show":
            rows = await self.mgmt.client_subscriptions(args[1])
            return "\n".join(
                f"{s['clientid']} -> {s['topic']} (qos={s['qos']})"
                for s in rows) or "(none)"
        if len(args) == 4 and args[0] == "add":
            rc = await self.mgmt.subscribe_client(args[1], args[2],
                                                  int(args[3]))
            if rc is None:
                return "Error: client not found"
            return "ok" if rc <= 2 else f"Error: reason code 0x{rc:02x}"
        if len(args) == 3 and args[0] == "del":
            ok = self.mgmt.unsubscribe_client(args[1], args[2])
            return "ok" if ok else "Error: client not found"
        raise _Usage()

    async def _plugins(self, _args) -> str:
        plugins = getattr(self.node, "plugins", None)
        if plugins is None:
            return "(none)"
        return "\n".join(
            f"Plugin({p['name']}, enabled={p['enabled']})"
            for p in plugins.list()) or "(none)"

    async def _listeners(self, _args) -> str:
        out = []
        for l in self.node.listeners:
            out.append(f"{getattr(l, 'protocol', 'mqtt:tcp')} on "
                       f"{getattr(l, 'bind', '0.0.0.0')}:"
                       f"{getattr(l, 'port', 0)}\n"
                       f"  current_conn: {getattr(l, 'current_conns', 0)}")
        return "\n".join(out) or "(none)"

    async def _vm(self, _args) -> str:
        import os
        import resource
        usage = resource.getrusage(resource.RUSAGE_SELF)
        try:
            la = os.getloadavg()
        except OSError:
            la = (0, 0, 0)
        return (f"cpu/load1: {la[0]:.2f}\ncpu/load5: {la[1]:.2f}\n"
                f"cpu/load15: {la[2]:.2f}\n"
                f"memory/rss_kb: {usage.ru_maxrss}")

    async def _banned(self, args) -> str:
        if args and args[0] == "list":
            return "\n".join(
                f"banned {b.kind} {b.value} by {b.by} until "
                f"{b.until or 'forever'}"
                for b in self.node.banned.all()) or "(none)"
        if len(args) >= 3 and args[0] == "add":
            dur = float(args[3]) if len(args) > 3 else None
            self.node.banned.create(args[1], args[2], by="cli",
                                    duration=dur)
            return "ok"
        if len(args) == 3 and args[0] == "del":
            return "ok" if self.node.banned.delete(args[1], args[2]) \
                else "Not Found."
        raise _Usage()

    async def _rules(self, args) -> str:
        eng = getattr(self.node, "rule_engine", None)
        if eng is None:
            return "rule engine not loaded"
        if args and args[0] == "list":
            return "\n".join(
                f"Rule({r.id}, enabled={r.enabled}): {r.sql}"
                for r in eng.list_rules()) or "(none)"
        if len(args) == 2 and args[0] == "show":
            r = eng.get_rule(args[1])
            return str(r.to_map()) if r else "Not Found."
        if len(args) == 2 and args[0] == "delete":
            return "ok" if eng.delete_rule(args[1]) else "Not Found."
        raise _Usage()

    async def _mgmt(self, args) -> str:
        if self.app_auth is None:
            return "mgmt auth not configured"
        if args and args[0] == "list":
            return "\n".join(f"app_id: {a['app_id']}, name: {a['name']}, "
                             f"status: {a['status']}"
                             for a in self.app_auth.list_apps()) or "(none)"
        if len(args) == 3 and args[0] == "insert":
            secret = self.app_auth.add_app(args[1], args[2])
            return f"AppSecret: {secret}"
        if len(args) == 2 and args[0] == "delete":
            return "ok" if self.app_auth.del_app(args[1]) else "Not Found."
        raise _Usage()


class _Usage(Exception):
    pass


async def main(argv: Optional[list[str]] = None, device=None) -> str:
    """`python -m emqx_tpu_torch.mgmt.cli <cmd> ...` against a local dev
    node: the host-only node (``device_route: false``), on ``cuda``
    unless `device` says otherwise."""
    import sys

    from emqx_tpu_torch.broker.node import Node
    node = Node({"broker": {"device_route": False}}, device=device)
    cli = Cli(node)
    out = await cli.run(argv if argv is not None else sys.argv[1:])
    print(out)
    return out


if __name__ == "__main__":
    import asyncio
    import sys
    asyncio.run(main(sys.argv[1:]))
