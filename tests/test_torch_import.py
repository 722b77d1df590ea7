"""The port stands alone: every emqx_tpu_torch module (and chip_smoke.py,
and the fake database servers it boots) imports with jax and emqx_tpu
made unimportable, and the entry points
refuse to run without CUDA unless the caller asks for the CPU."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

# small CPU cases: one intra-op thread leaves the cores to the other
# test workers (torch would otherwise spin a thread per core)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "emqx_tpu_torch", "emqx_tpu_torch.device", "emqx_tpu_torch.convert",
    "emqx_tpu_torch.engine", "emqx_tpu_torch.workloads",
    "emqx_tpu_torch.utils.topic", "emqx_tpu_torch.ops.intern",
    "emqx_tpu_torch.ops.match", "emqx_tpu_torch.ops.build",
    "emqx_tpu_torch.ops.fold", "emqx_tpu_torch.ops.scan",
    "emqx_tpu_torch.ops.shapes", "emqx_tpu_torch.ops.fanout",
    "emqx_tpu_torch.ops.shared", "emqx_tpu_torch.ops.compact",
    "emqx_tpu_torch.models.router_engine", "emqx_tpu_torch.ops.trie",
    "emqx_tpu_torch.ops.exchange", "emqx_tpu_torch.parallel.mesh",
    "emqx_tpu_torch.parallel.sharded", "emqx_tpu_torch.parallel.serving",
    "emqx_tpu_torch.utils.hocon", "emqx_tpu_torch.mqtt",
    "emqx_tpu_torch.mqtt.constants", "emqx_tpu_torch.mqtt.packet",
    "emqx_tpu_torch.mqtt.frame", "emqx_tpu_torch.broker",
    "emqx_tpu_torch.broker.message", "emqx_tpu_torch.broker.hooks",
    "emqx_tpu_torch.broker.metrics", "emqx_tpu_torch.broker.config",
    "emqx_tpu_torch.broker.router", "emqx_tpu_torch.broker.pubsub",
    "emqx_tpu_torch.broker.session", "emqx_tpu_torch.broker.inflight",
    "emqx_tpu_torch.broker.mqueue", "emqx_tpu_torch.broker.cm",
    "emqx_tpu_torch.broker.limiter", "emqx_tpu_torch.broker.channel",
    "emqx_tpu_torch.broker.connection", "emqx_tpu_torch.broker.deliver",
    "emqx_tpu_torch.broker.supervise", "emqx_tpu_torch.broker.batcher",
    "emqx_tpu_torch.broker.device_engine", "emqx_tpu_torch.broker.node",
    "emqx_tpu_torch.client", "emqx_tpu_torch.ops.delta",
    "emqx_tpu_torch.broker.match_cache", "emqx_tpu_torch.ops.cover",
    "emqx_tpu_torch.broker.telemetry", "emqx_tpu_torch.broker.hbm_ledger",
    "emqx_tpu_torch.native", "emqx_tpu_torch.broker.trace",
    "emqx_tpu_torch.broker.latency", "emqx_tpu_torch.broker.alarm",
    "emqx_tpu_torch.broker.overload", "emqx_tpu_torch.chaos",
    "emqx_tpu_torch.utils.logger", "emqx_tpu_torch.utils.tls",
    "emqx_tpu_torch.broker.banned", "emqx_tpu_torch.broker.monitor",
    "emqx_tpu_torch.broker.congestion", "emqx_tpu_torch.broker.ws",
    "emqx_tpu_torch.version", "emqx_tpu_torch.broker.persistence",
    "emqx_tpu_torch.apps", "emqx_tpu_torch.apps.retainer",
    "emqx_tpu_torch.apps.delayed", "emqx_tpu_torch.apps.rewrite",
    "emqx_tpu_torch.apps.topic_metrics",
    "emqx_tpu_torch.apps.event_message", "emqx_tpu_torch.apps.boot",
    "emqx_tpu_torch.apps.sys", "emqx_tpu_torch.apps.tracer",
    "emqx_tpu_torch.apps.dashboard", "emqx_tpu_torch.mgmt",
    "emqx_tpu_torch.mgmt.httpd", "emqx_tpu_torch.mgmt.mgmt",
    "emqx_tpu_torch.mgmt.apps", "emqx_tpu_torch.mgmt.api",
    "emqx_tpu_torch.mgmt.cli", "emqx_tpu_torch.utils.aio",
    "emqx_tpu_torch.utils.http", "emqx_tpu_torch.utils.replayq",
    "emqx_tpu_torch.cluster", "emqx_tpu_torch.cluster.rpc",
    "emqx_tpu_torch.cluster.membership", "emqx_tpu_torch.cluster.store",
    "emqx_tpu_torch.cluster.cluster", "emqx_tpu_torch.cluster.discovery",
    "emqx_tpu_torch.run_node", "emqx_tpu_torch.chaos_cluster",
    "emqx_tpu_torch.utils.passwd", "emqx_tpu_torch.utils.scram",
    "emqx_tpu_torch.apps.authn", "emqx_tpu_torch.apps.authn_db",
    "emqx_tpu_torch.apps.authz", "emqx_tpu_torch.rules",
    "emqx_tpu_torch.rules.maps", "emqx_tpu_torch.rules.funcs",
    "emqx_tpu_torch.rules.sqlparser", "emqx_tpu_torch.rules.runtime",
    "emqx_tpu_torch.rules.events", "emqx_tpu_torch.rules.metrics",
    "emqx_tpu_torch.rules.actions", "emqx_tpu_torch.rules.registry",
    "emqx_tpu_torch.utils.bson", "emqx_tpu_torch.connectors",
    "emqx_tpu_torch.connectors.pool", "emqx_tpu_torch.connectors.redis",
    "emqx_tpu_torch.connectors.mysql", "emqx_tpu_torch.connectors.pgsql",
    "emqx_tpu_torch.connectors.mongo", "emqx_tpu_torch.connectors.ldap",
    "emqx_tpu_torch.resources", "emqx_tpu_torch.resources.resource",
    "emqx_tpu_torch.resources.db", "emqx_tpu_torch.resources.bridge_mqtt",
    "emqx_tpu_torch.apps.authz_db", "emqx_tpu_torch.utils.wirecodec",
    "emqx_tpu_torch.utils.psk", "emqx_tpu_torch.apps.plugins",
    "emqx_tpu_torch.apps.prometheus", "emqx_tpu_torch.apps.statsd",
    "emqx_tpu_torch.apps.telemetry", "emqx_tpu_torch.apps.protos",
    "emqx_tpu_torch.apps.protos.exhook_pb2", "emqx_tpu_torch.apps.exhook",
    "emqx_tpu_torch.gateway", "emqx_tpu_torch.gateway.ctx",
    "emqx_tpu_torch.gateway.registry", "emqx_tpu_torch.gateway.mqttsn",
    "emqx_tpu_torch.gateway.stomp", "emqx_tpu_torch.gateway.coap",
    "emqx_tpu_torch.gateway.lwm2m_objects", "emqx_tpu_torch.gateway.lwm2m",
    "emqx_tpu_torch.gateway.protos",
    "emqx_tpu_torch.gateway.protos.exproto_pb2",
    "emqx_tpu_torch.gateway.exproto", "emqx_tpu_torch.quic",
    "emqx_tpu_torch.quic.packet", "emqx_tpu_torch.quic.frames",
    "emqx_tpu_torch.quic.tls13", "emqx_tpu_torch.quic.connection",
    "emqx_tpu_torch.quic.client", "tests.test_torch_fake_db",
    "chip_smoke",
]
# the modules that need grpc and protobuf: a host without them (the card's
# has neither) still imports every other module
NEEDS_GRPC = {"emqx_tpu_torch.apps.protos.exhook_pb2",
              "emqx_tpu_torch.apps.exhook",
              "emqx_tpu_torch.gateway.protos.exproto_pb2",
              "emqx_tpu_torch.gateway.exproto"}


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['emqx_tpu'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]\n"
        "       or m.startswith(('jax.', 'jaxlib', 'emqx_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_the_port_boots_without_grpc_or_protobuf():
    """With grpc and google.protobuf unimportable as well as jax and
    emqx_tpu, every module but the four that need them imports, the
    gateway registry registers the four gateways that need no grpc (an
    exproto block then raises the reference's unknown type), and a node
    boots its apps and a STOMP gateway."""
    code = (
        "import asyncio, importlib, sys\n"
        "for m in ('jax', 'emqx_tpu', 'grpc', 'google.protobuf'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {sorted(set(MODULES) - NEEDS_GRPC)!r}:\n"
        "    importlib.import_module(m)\n"
        f"for m in {sorted(NEEDS_GRPC)!r}:\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "        raise AssertionError(m)\n"
        "    except ImportError:\n"
        "        pass\n"
        "from emqx_tpu_torch.broker.node import Node\n"
        "from emqx_tpu_torch.gateway.registry import GatewayRegistry\n"
        "node = Node({'broker': {'device_route': False}, 'gateway': "
        "{'stomp': {'port': 0}}}, device='cpu')\n"
        "reg = GatewayRegistry.with_builtins(node)\n"
        "assert sorted(reg._types) == ['coap', 'lwm2m', 'mqttsn', "
        "'stomp'], reg._types\n"
        "async def go():\n"
        "    apps = await node.start_apps()\n"
        "    gws = await node.start_gateways()\n"
        "    try:\n"
        "        await reg.load('exproto', {})\n"
        "    except ValueError as e:\n"
        "        err = str(e)\n"
        "    await node.stop_listeners()\n"
        "    return ([type(a).__name__ for a in apps],\n"
        "            [type(g).__name__ for g in gws], err, reg.list())\n"
        "out = asyncio.run(go())\n"
        "assert out == (['Retainer', 'DelayedPublish'], ['StompGateway'],\n"
        "               'unknown gateway type exproto', []), out\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None\n"
        "       and m.startswith(('grpc', 'google.protobuf', 'jax.',\n"
        "                         'emqx_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_protos_are_the_references_bytes():
    """The two generated protobuf modules and their .proto sources are
    byte-identical to the reference's: both packages register the same
    descriptors in protobuf's one default pool and speak the same wire."""
    for rel in ("apps/protos/exhook.proto", "apps/protos/exhook_pb2.py",
                "gateway/protos/exproto.proto",
                "gateway/protos/exproto_pb2.py"):
        with open(os.path.join(REPO, "emqx_tpu", rel), "rb") as f:
            ref = f.read()
        with open(os.path.join(REPO, "emqx_tpu_torch", rel), "rb") as f:
            assert f.read() == ref, rel


def test_columnar_ingress_loads_only_the_ports_library():
    """With jax and emqx_tpu unimportable, a columnar read burst and a
    native topic encode run on the port's own host library, built from
    emqx_tpu_torch/csrc/host_native.cpp; the reference's
    native/libemqx_native.so is never loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['emqx_tpu'] = None\n"
        "from emqx_tpu_torch import native\n"
        "from emqx_tpu_torch.mqtt import packet as P\n"
        "from emqx_tpu_torch.mqtt.frame import FrameParser, serialize\n"
        "from emqx_tpu_torch.ops.intern import InternTable\n"
        "from emqx_tpu_torch.ops.match import encode_topics_str\n"
        "blob = b''.join(serialize(P.Publish(topic=f't/{i}', payload=b'x' "
        "* 40), 4) for i in range(200))\n"
        "items = FrameParser(version=4).feed_columnar(blob)\n"
        "assert type(items[0]).__name__ == 'PublishBurst', items[:1]\n"
        "t = InternTable(); t.intern('t')\n"
        "encode_topics_str(t, ['t/1'], 16)\n"
        "assert type(t.mirror_handle()) is int\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert native.available() and 'libhost_native-' in maps\n"
        "assert 'libemqx_native' not in maps\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


class TestDefaultDevice:
    """Without CUDA, the default device raises; device='cpu' runs."""

    @pytest.fixture(autouse=True)
    def _no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_resolve_device(self):
        from emqx_tpu_torch.device import resolve_device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        assert resolve_device("cpu").type == "cpu"

    def test_engine_and_convert(self):
        from emqx_tpu_torch.convert import tables_from_numpy
        from emqx_tpu_torch.engine import RouteEngine
        from emqx_tpu_torch.ops.fanout import build_subtable
        from emqx_tpu_torch.ops.shapes import build_shape_tables
        st = build_shape_tables(np.array([[4, 1]], np.int32), np.array([2]))
        sub = build_subtable(1, {0: [(1, 0)]}, {}, {})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tables_from_numpy(st, sub)
        assert tables_from_numpy(st, sub, "cpu").shapes.buckets.device.type \
            == "cpu"
        subs = {"a/+": [(1, 0)]}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RouteEngine.from_subscriptions(subs)
        plan = RouteEngine.from_subscriptions(subs, device="cpu").route(
            ["a/b"])[0]
        assert list(plan.fids) == [0] and list(plan.rows) == [1]

    def test_node_and_device_engine(self):
        from emqx_tpu_torch.broker.device_engine import DeviceRouteEngine
        from emqx_tpu_torch.broker.node import Node
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Node()
        node = Node(device="cpu")
        assert node.device_engine.device.type == "cpu"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceRouteEngine(node)

    def test_mesh_and_sharded_engine(self):
        from emqx_tpu_torch.parallel.mesh import make_mesh
        from emqx_tpu_torch.parallel.serving import ShardedRouteEngine
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(8, dp=2)
        subs = {"a/+": [(1, 0)]}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedRouteEngine.from_subscriptions(subs, n_devices=2)
        eng = ShardedRouteEngine.from_subscriptions(
            subs, n_devices=2, device="cpu", batch=2)
        plan = eng.route(["a/b"])[0]
        assert list(plan.rows) == [1]
        assert eng.filters[int(plan.fids[0])] == "a/+"

    def test_mesh_server_under_node(self):
        """The multichip node (ShardedRouteServer) defaults to the card as
        the single-chip node does; a mesh without a device given is
        placed on cuda:0 and raises here."""
        from emqx_tpu_torch.broker.node import Node
        from emqx_tpu_torch.parallel.serving import ShardedRouteServer
        conf = {"broker": {"multichip": {"enable": True, "devices": 8,
                                         "dp": 2}}}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Node(conf)
        node = Node(conf, device="cpu")
        assert isinstance(node.device_engine, ShardedRouteServer)
        assert node.device_engine.device.type == "cpu"
        bare = types.SimpleNamespace(broker=node.broker)   # no device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedRouteServer(bare)


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line when CUDA
    is absent (as on this CPU-only test host)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
