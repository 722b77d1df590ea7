"""Port vs JAX reference: the end-to-end latency SLO observatory.

The same inputs go through the reference (``emqx_tpu.broker.latency``) and
the port (``emqx_tpu_torch.broker.latency``): the knobs and the
objective's resolver, errors included (config only: the reference's
environment knobs are unset); one seeded (qos, path, seconds) sequence,
with the sampling clamp set and restored part way and the clocks faked,
gives the same section, burn rates, breaches, exemplars, breach-hook calls
and ``slo_breach`` events; twin Nodes over TCP (``tests/test_torch_trace``'s
drive: columnar bursts, the chooser held on the device) record the same
sample counts by (qos, path) on both legs; the observatory-off twin
delivers identically and has no observatory anywhere; and the batcher-less
host path (``Broker.publish_async``) records ``host`` on both legs.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from emqx_tpu.broker import latency as JL
from emqx_tpu.broker import trace as JT
from emqx_tpu.broker.hooks import Hooks as JHooks
from emqx_tpu.broker.message import make as jmake
from emqx_tpu.broker.metrics import Metrics as JMetrics
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu_torch.broker import latency as TL
from emqx_tpu_torch.broker import trace as TT
from emqx_tpu_torch.broker.hooks import Hooks as THooks
from emqx_tpu_torch.broker.message import make as tmake
from emqx_tpu_torch.broker.metrics import Metrics as TMetrics
from emqx_tpu_torch.broker.node import Node as TNode
from tests.test_torch_trace import BURST_N, BURSTS, ENV_KNOBS, twin_run

torch.set_num_threads(1)

SEED = 20261017


@pytest.fixture(autouse=True)
def _config_only(monkeypatch):
    """The reference's env knobs are not ported: only config decides."""
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------
@pytest.mark.parametrize("value", [None, True, False, 0, 1])
def test_observatory_knob_equals_reference(value):
    assert TL.resolve_latency_observatory(value) \
        is JL.resolve_latency_observatory(value)


@pytest.mark.parametrize("value", [None, 1, 3, "2.5", 0.5, 500])
def test_objective_equals_reference(value):
    assert TL.resolve_slo_route_p99_ms(value) \
        == JL.resolve_slo_route_p99_ms(value)


@pytest.mark.parametrize("value", ["fast", 0, -1, "0", [1]])
def test_objective_errors_equal_reference(value):
    for resolve in (TL.resolve_slo_route_p99_ms,
                    JL.resolve_slo_route_p99_ms):
        with pytest.raises(ValueError):
            resolve(value)


# ---------------------------------------------------------------------
# one seeded sequence through both observatories
# ---------------------------------------------------------------------
class Clocks:
    """Fake monotonic and wall clocks, advanced by the sequence."""

    def __init__(self):
        self.mono = 50_000.0
        self.wall = 1.7e9

    def monotonic(self) -> float:
        return self.mono

    def time(self) -> float:
        return self.wall

    def advance(self, s: float) -> None:
        self.mono += s
        self.wall += s


def _drive(L, T, Metrics, Hooks, make, monkeypatch, seed: int,
           objective) -> dict:
    clocks = Clocks()
    monkeypatch.setattr(time, "monotonic", clocks.monotonic)
    monkeypatch.setattr(time, "time", clocks.time)
    hooks = Hooks()
    fired = []
    hooks.add("latency.breach", lambda ex: fired.append(dict(ex)))
    metrics = Metrics()
    rec = T.FlightRecorder(metrics, cap=256, sample=0)
    rec.epoch_perf, rec.epoch_wall = 0.0, 1.7e9
    obs = L.LatencyObservatory(metrics, hooks=hooks, recorder=rec,
                               objective_ms=objective)
    rng = np.random.default_rng(seed)
    traces = [0] + [rec.new_trace() for _ in range(4)]
    burns = []
    n = 1500
    for i in range(n):
        if i == n // 2:
            obs.clamp = 4          # the governor's sampling clamp
        elif i == 3 * n // 4:
            obs.clamp = 1
        qos = int(rng.integers(3))
        path = str(rng.choice(JL.PATHS))
        m = make("p", qos, f"t/{int(rng.integers(50))}", b"")
        s = float(rng.lognormal(np.log(objective / 1000 / 3), 1.2))
        obs.record_routed(m, path, s,
                          trace=traces[int(rng.integers(len(traces)))])
        obs.record_delivered(m, path, s * float(rng.uniform(1, 3)))
        if rng.random() < 0.02:
            clocks.advance(float(rng.uniform(0, 40)))
            burns.append(obs.burn_rates())
        if i == n // 3:
            first = obs.section()
            obs.reset()
    monkeypatch.undo()
    hists = {k: (list(h.counts), h.count)
             for k, h in metrics.histograms().items()
             if k.startswith("pipeline.latency.")}
    return {"first": first, "section": obs.section(),
            "burn": obs.burn_rates(), "burns": burns,
            "breaches": obs.breaches, "samples": obs.samples,
            "clamped": obs.clamped, "exemplars": list(obs.exemplars),
            "hook": (obs.hook_fires, obs.hook_throttled), "fired": fired,
            "events": [(s.trace_id, s.name, s.track, s.meta)
                       for s in rec.spans()],
            "counter": metrics.val("pipeline.latency.breaches"),
            "hists": hists}


@pytest.mark.parametrize("seed,objective", [(0, 2.0), (1, 0.5), (2, 40)])
def test_sequence_equals_reference(monkeypatch, seed, objective):
    j = _drive(JL, JT, JMetrics, JHooks, jmake, monkeypatch, seed,
               objective)
    t = _drive(TL, TT, TMetrics, THooks, tmake, monkeypatch, seed,
               objective)
    for k in j:
        assert t[k] == j[k], k
    assert j["breaches"] > 0 and j["exemplars"] and j["events"]
    assert j["clamped"] > 0 and j["hook"][1] > 0
    assert j["section"]["slo"]["verdict"] in ("met", "breached")


# ---------------------------------------------------------------------
# twin nodes over TCP
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def tcp_twins():
    return {"jax": twin_run(True), "torch": twin_run(False),
            "torch_off": twin_run(False, latency_observatory=False)}


def _counts(sec: dict) -> dict:
    return {leg: {k: v["count"] for k, v in sec[leg].items()}
            for leg in ("routed", "delivered")}


def test_tcp_twin_sample_counts_equal_reference(tcp_twins):
    jn, jr = tcp_twins["jax"]
    tn, tr = tcp_twins["torch"]
    assert tr["got"] == jr["got"]
    js = jn.latency_observatory.section()
    ts = tn.latency_observatory.section()
    assert _counts(ts) == _counts(js)
    total = BURSTS * BURST_N
    # every PUBLISH carried its burst's ingress stamp; every 4th is QoS 1
    assert sum(_counts(ts)["routed"].values()) == total
    assert sum(v for k, v in _counts(ts)["routed"].items()
               if k.startswith("q1.")) == total // 4
    assert all(k.split(".")[1] in ("device", "device_cached")
               for k in _counts(ts)["routed"])
    assert ts["slo"]["samples"] == js["slo"]["samples"] == total
    assert ts["slo"]["verdict"] == "met"        # objective 60 s
    assert tn.pipeline_telemetry.snapshot()["latency"]["schema"] \
        == js["schema"]


def test_latency_off_twin_delivers_identically(tcp_twins):
    tn, tr = tcp_twins["torch"]
    off, ro = tcp_twins["torch_off"]
    assert ro["got"] == tr["got"]
    assert off.latency_observatory is None
    assert off.broker.latency_obs is None
    assert off.publish_batcher.obs is None
    assert "latency" not in off.pipeline_telemetry.snapshot(full=True)
    assert off.metrics.val("pipeline.latency.breaches") == 0
    assert not [k for k in off.metrics.histograms()
                if k.startswith("pipeline.latency.")]


# ---------------------------------------------------------------------
# the batcher-less host path
# ---------------------------------------------------------------------
class _Sink:
    def __init__(self):
        self.got = []

    def deliver(self, topic_filter, msg):
        self.got.append((msg.topic, bytes(msg.payload)))
        return True


def test_host_path_records_host_as_reference():
    out = []
    for node, make in ((JNode(use_device=True), jmake),
                       (TNode(device="cpu"), tmake)):
        s = _Sink()
        sid = node.broker.register(s, "c0")
        node.broker.subscribe(sid, "h/+", {"qos": 1})

        async def go():
            counts = []
            for k in range(16):
                m = make("p", k % 3, "h/a", b"%d" % k)
                m.ingress_ns = time.perf_counter_ns() - 1000
                counts.append(await node.broker.publish_async(m))
            # an unstamped message is not recorded
            counts.append(await node.broker.publish_async(
                make("p", 1, "h/b", b"")))
            return counts

        counts = asyncio.run(go())
        sec = node.latency_observatory.section()
        out.append((counts, _counts(sec), s.got))
        node.publish_batcher.close()
    assert out[1] == out[0]
    assert out[1][1]["routed"] == {"q0.host": 6, "q1.host": 5,
                                   "q2.host": 5}
    assert out[1][1]["delivered"] == out[1][1]["routed"]
