"""Cluster discovery strategies + autocluster.

The port's copy of ``emqx_tpu/cluster/discovery.py`` (the port imports nothing
from ``emqx_tpu``).

Parity: ekka autocluster as configured by emqx_machine
(/root/reference/apps/emqx_machine/src/emqx_machine_schema.erl:66-111 —
strategies manual | static | mcast | dns | etcd | k8s, plus
cluster_autoheal/cluster_autoclean which live in
emqx_tpu/cluster/membership.py). Each strategy resolves to a list of
(host, port) seed addresses; `autocluster` joins the local ClusterNode to
every discovered peer, and registry/announce strategies (etcd, mcast)
publish the local node first so cold-started clusters can find each
other.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
from typing import Callable, Optional

log = logging.getLogger("emqx_tpu_torch.discovery")


class Discovery:
    """Behaviour: discover() -> list of (host, port) seeds."""

    strategy = "manual"

    async def discover(self) -> list[tuple[str, int]]:
        return []


class ManualDiscovery(Discovery):
    """No automatic discovery; nodes join via explicit `join` (the
    reference's default)."""

    strategy = "manual"


class StaticDiscovery(Discovery):
    """Fixed seed list: ["host:port", ...] or [(host, port), ...]."""

    strategy = "static"

    def __init__(self, seeds: list):
        self._seeds = []
        for s in seeds:
            if isinstance(s, str):
                host, sep, port = s.rpartition(":")
                if not sep or not host or not port.isdigit():
                    raise ValueError(
                        f"static discovery seed {s!r} must be "
                        f"\"host:port\" (IPv6: \"[addr]:port\")")
                self._seeds.append((host.strip("[]"), int(port)))
            else:
                self._seeds.append((s[0], int(s[1])))

    async def discover(self) -> list[tuple[str, int]]:
        return list(self._seeds)


class DnsDiscovery(Discovery):
    """A-record discovery: every address behind `name` is a peer on
    `port` (emqx_machine_schema dns strategy: name + app)."""

    strategy = "dns"

    def __init__(self, name: str, port: int,
                 resolver: Optional[Callable] = None):
        self.name = name
        self.port = port
        self._resolver = resolver      # injectable for tests

    async def discover(self) -> list[tuple[str, int]]:
        if self._resolver is not None:
            addrs = self._resolver(self.name)
            if asyncio.iscoroutine(addrs):
                addrs = await addrs
        else:
            try:
                infos = await asyncio.get_running_loop().getaddrinfo(
                    self.name, self.port)
            except OSError as e:
                log.warning("dns discovery for %s failed: %s",
                            self.name, e)
                return []
            addrs = sorted({i[4][0] for i in infos})
        return [(a, self.port) for a in addrs]


class EtcdDiscovery(Discovery):
    """etcd v3 kv range over the HTTP/JSON gateway: peers register
    themselves under `<prefix>/<cluster>/nodes/<name>` with value
    "host:port" (the ekka etcd strategy's key scheme)."""

    strategy = "etcd"

    def __init__(self, server: str, prefix: str = "emqxcl",
                 cluster_name: str = "emqx_tpu", timeout: float = 5.0):
        self.server = server.rstrip("/")
        self.prefix = prefix
        self.cluster_name = cluster_name
        self.timeout = timeout

    def _range_key(self) -> tuple[str, str]:
        key = f"{self.prefix}/{self.cluster_name}/nodes/"
        end = key[:-1] + chr(ord(key[-1]) + 1)
        return key, end

    async def discover(self) -> list[tuple[str, int]]:
        from emqx_tpu_torch.utils.http import request
        key, end = self._range_key()
        body = json.dumps({
            "key": base64.b64encode(key.encode()).decode(),
            "range_end": base64.b64encode(end.encode()).decode(),
        }).encode()
        try:
            resp = await request(
                "POST", self.server + "/v3/kv/range", body=body,
                headers={"content-type": "application/json"},
                timeout=self.timeout)
            kvs = resp.json().get("kvs", [])
        except Exception as e:  # noqa: BLE001
            log.warning("etcd discovery failed: %s", e)
            return []
        out = []
        for kv in kvs:
            val = base64.b64decode(kv.get("value", "")).decode()
            host, _, port = val.rpartition(":")
            if host and port.isdigit():
                out.append((host, int(port)))
        return out

    async def register(self, host: str, port: int, node_name: str,
                       ttl: int = 60) -> Optional[str]:
        """Publish the local node under the discovery prefix, bound to a
        TTL lease so a crashed node's address expires (the ekka etcd
        strategy's node_ttl). Returns the lease id for keepalive."""
        from emqx_tpu_torch.utils.http import request
        lease_id = None
        try:
            resp = await request(
                "POST", self.server + "/v3/lease/grant",
                body=json.dumps({"TTL": ttl}).encode(),
                headers={"content-type": "application/json"},
                timeout=self.timeout)
            lease_id = resp.json().get("ID")
        except Exception as e:  # noqa: BLE001 (older gateway: no lease)
            log.warning("etcd lease grant failed (registering without "
                        "TTL): %s", e)
        key = f"{self.prefix}/{self.cluster_name}/nodes/{node_name}"
        body = {"key": base64.b64encode(key.encode()).decode(),
                "value": base64.b64encode(
                    f"{host}:{port}".encode()).decode()}
        if lease_id is not None:
            body["lease"] = lease_id
        try:
            await request("POST", self.server + "/v3/kv/put",
                          body=json.dumps(body).encode(),
                          headers={"content-type": "application/json"},
                          timeout=self.timeout)
        except Exception as e:  # noqa: BLE001 — degrade like discover()
            log.warning("etcd registration failed (node stays "
                        "unregistered): %s", e)
            return None
        return lease_id

    async def keepalive_loop(self, lease_id: str, ttl: int = 60) -> None:
        """Refresh the registration lease every ttl/3 seconds."""
        from emqx_tpu_torch.utils.http import request
        while True:
            await asyncio.sleep(max(1, ttl // 3))
            try:
                await request(
                    "POST", self.server + "/v3/lease/keepalive",
                    body=json.dumps({"ID": lease_id}).encode(),
                    headers={"content-type": "application/json"},
                    timeout=self.timeout)
            except Exception as e:  # noqa: BLE001
                log.warning("etcd lease keepalive failed: %s", e)


class K8sDiscovery(Discovery):
    """Kubernetes endpoints discovery: every ready address of
    `service_name` in `namespace` is a peer (emqx_machine_schema k8s
    strategy: apiserver + service_name + namespace + address_type)."""

    strategy = "k8s"

    def __init__(self, apiserver: str, service_name: str,
                 namespace: str = "default", port: int = 4370,
                 token: Optional[str] = None, timeout: float = 5.0):
        self.apiserver = apiserver.rstrip("/")
        self.service_name = service_name
        self.namespace = namespace
        self.port = port
        self.token = token
        self.timeout = timeout

    async def discover(self) -> list[tuple[str, int]]:
        from emqx_tpu_torch.utils.http import request
        url = (f"{self.apiserver}/api/v1/namespaces/{self.namespace}"
               f"/endpoints/{self.service_name}")
        headers = {}
        if self.token:
            headers["authorization"] = f"Bearer {self.token}"
        try:
            resp = await request("GET", url, headers=headers,
                                 timeout=self.timeout)
            doc = resp.json()
        except Exception as e:  # noqa: BLE001
            log.warning("k8s discovery failed: %s", e)
            return []
        out = []
        for subset in doc.get("subsets", []):
            port = self.port
            for p in subset.get("ports", []):
                if p.get("name") in (None, "ekka", "cluster"):
                    port = p.get("port", port)
            for addr in subset.get("addresses", []):
                ip = addr.get("ip")
                if ip:
                    out.append((ip, port))
        return out


class McastDiscovery(Discovery):
    """UDP multicast probe/response (the ekka mcast strategy: addr +
    ports + ttl + loop + iface, emqx_machine_schema cluster.mcast block).
    Every node runs responders joined to the group on each configured
    port; discover() multicasts a probe to every port and collects
    unicast replies for `wait_s`. The reply carries the peer's
    advertised RPC address, so the probe socket needs no group
    membership of its own."""

    strategy = "mcast"
    _MAGIC = b"EMQXTPU-MCAST1"

    def __init__(self, addr: str = "239.192.0.1", port=45369,
                 cluster_name: str = "emqx_tpu", ttl: int = 1,
                 loop_enable: bool = True, iface: str = "0.0.0.0",
                 wait_s: float = 1.0):
        self.addr = addr
        self.ports = [int(p) for p in
                      (port if isinstance(port, (list, tuple)) else [port])]
        if not self.ports:
            raise ValueError("mcast discovery needs at least one port")
        self.port = self.ports[0]
        self.cluster_name = cluster_name
        self.ttl = ttl
        self.loop_enable = loop_enable
        self.iface = iface
        self.wait_s = wait_s
        self._responders: list[asyncio.DatagramTransport] = []

    # one definition of the wire format — an exact-match compare on the
    # responder side means any drift between builder copies silently
    # breaks discovery
    def _probe(self) -> bytes:
        return self._MAGIC + b" PROBE " + self.cluster_name.encode()

    def _reply_prefix(self) -> bytes:
        return self._MAGIC + b" NODE " + self.cluster_name.encode() + b" "

    def _mcast_opts(self, s) -> None:
        import socket
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, self.ttl)
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP,
                     1 if self.loop_enable else 0)
        if self.iface != "0.0.0.0":
            # multihomed host: transmit on the configured interface, not
            # the default route
            s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_IF,
                         socket.inet_aton(self.iface))

    def _group_sock(self, bind_port: int):
        import socket
        import struct
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if hasattr(socket, "SO_REUSEPORT"):  # several nodes per host
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            s.bind(("", bind_port))
            mreq = struct.pack("4s4s", socket.inet_aton(self.addr),
                               socket.inet_aton(self.iface))
            s.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
            self._mcast_opts(s)
            s.setblocking(False)
            return s
        except OSError:
            s.close()
            raise

    async def start_responder(self, host: str, port: int) -> None:
        """Join the group on every configured port and answer probes for
        our cluster with the advertised RPC address. Idempotent."""
        if self._responders:
            return
        probe = self._probe()
        reply = self._reply_prefix() + f"{host}:{port}".encode()

        class _Responder(asyncio.DatagramProtocol):
            def connection_made(self, transport):
                self.transport = transport

            def datagram_received(self, data, addr):
                if data == probe:
                    self.transport.sendto(reply, addr)

        loop = asyncio.get_running_loop()
        for bind_port in self.ports:
            transport, _ = await loop.create_datagram_endpoint(
                _Responder, sock=self._group_sock(bind_port))
            self._responders.append(transport)

    def stop_responder(self) -> None:
        for t in self._responders:
            t.close()
        self._responders = []

    async def discover(self) -> list[tuple[str, int]]:
        import socket
        loop = asyncio.get_running_loop()
        found: set[tuple[str, int]] = set()
        want = self._reply_prefix()

        class _Collector(asyncio.DatagramProtocol):
            def datagram_received(self, data, addr):
                if not data.startswith(want):
                    return
                hp = data[len(want):].decode(errors="replace")
                h, _, p = hp.rpartition(":")
                if h and p.isdigit():
                    found.add((h, int(p)))

            def error_received(self, exc):
                # asyncio routes sendto OSErrors here, not to the caller
                # (e.g. ENETUNREACH: no multicast route)
                log.warning("mcast discovery failed: %s", exc)

        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self._mcast_opts(s)
            s.setblocking(False)
        except OSError:
            s.close()
            raise
        transport, _ = await loop.create_datagram_endpoint(
            _Collector, sock=s)
        try:
            for p in self.ports:
                transport.sendto(self._probe(), (self.addr, p))
            await asyncio.sleep(self.wait_s)
        finally:
            transport.close()
        return sorted(found)


def from_config(conf: dict,
                resolver: Optional[Callable] = None) -> Discovery:
    """Build the configured strategy from the `cluster` config section
    (emqx_machine_schema cluster.discovery + per-strategy blocks)."""
    strategy = (conf or {}).get("discovery", "manual")
    if strategy == "manual":
        return ManualDiscovery()
    if strategy == "static":
        return StaticDiscovery(conf.get("nodes") or conf.get("seeds") or [])
    if strategy == "dns":
        dconf = conf.get("dns") or {}
        return DnsDiscovery(dconf.get("name", conf.get("name", "")),
                            int(dconf.get("port", 4370)),
                            resolver=resolver)
    if strategy == "etcd":
        econf = conf.get("etcd") or {}
        return EtcdDiscovery(econf.get("server", "http://127.0.0.1:2379"),
                             econf.get("prefix", "emqxcl"),
                             conf.get("name", "emqx_tpu"))
    if strategy == "mcast":
        mconf = conf.get("mcast") or {}
        ports = mconf.get("ports", 45369)
        if isinstance(ports, list) and not ports:
            raise ValueError("cluster.mcast.ports must not be empty")
        return McastDiscovery(
            addr=mconf.get("addr", "239.192.0.1"),
            port=ports,
            cluster_name=conf.get("name", "emqx_tpu"),
            ttl=int(mconf.get("ttl", 1)),
            loop_enable=bool(mconf.get("loop", True)),
            iface=mconf.get("iface", "0.0.0.0"))
    if strategy == "k8s":
        kconf = conf.get("k8s") or {}
        return K8sDiscovery(
            kconf.get("apiserver", "http://127.0.0.1:8080"),
            kconf.get("service_name", "emqx"),
            kconf.get("namespace", "default"),
            int(kconf.get("port", 4370)), kconf.get("token"))
    raise ValueError(f"unknown discovery strategy {strategy!r}")


async def autocluster(cluster_node, discovery: Optional[Discovery] = None,
                      resolver: Optional[Callable] = None) -> int:
    """Resolve seeds via the configured strategy and join each
    (emqx_machine_app start_autocluster). Returns the number of peers
    joined."""
    if discovery is None:
        discovery = from_config(
            cluster_node.node.config.get("cluster") or {},
            resolver=resolver)
    me = cluster_node.address
    if isinstance(discovery, McastDiscovery):
        # announce-style strategy: answer the group's probes from now on;
        # ClusterNode.stop() closes the responder via this handle
        await discovery.start_responder(me[0], me[1])
        cluster_node._mcast_discovery = discovery
    if isinstance(discovery, EtcdDiscovery):
        # registry-style strategies need the local node published BEFORE
        # discovering, or a cold-started cluster finds nobody
        lease = await discovery.register(me[0], me[1],
                                         cluster_node.name)
        if lease is not None:
            task = asyncio.ensure_future(discovery.keepalive_loop(lease))
            prev = getattr(cluster_node, "_discovery_task", None)
            if prev is not None:
                prev.cancel()
            cluster_node._discovery_task = task
    seeds = await discovery.discover()
    joined = 0
    for host, port in seeds:
        if (host, port) == me:
            continue
        try:
            await cluster_node.join(host, port)
            joined += 1
        except Exception as e:  # noqa: BLE001
            log.warning("autocluster join %s:%d failed: %s", host, port, e)
    return joined
