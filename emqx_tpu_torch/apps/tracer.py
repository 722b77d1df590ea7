"""Per-client / per-topic debug tracing to file.

Parity: apps/emqx/src/emqx_tracer.erl — `start_trace({clientid,C}|{topic,T},
Level, File)` installs a filtered handler capturing matching publish and
client lifecycle events (emqx_tracer.erl:66-75+); `stop_trace` removes it,
`lookup_traces` lists active traces. The OTP-logger-filter mechanism
becomes hook callbacks writing formatted lines.

Slow-batch tracing: pipeline telemetry fires the `batch.slow` hook when a
publish batch's oldest-enqueue→completion span exceeds the configurable
`broker.slow_batch_threshold_ms`; the tracer logs every such event at
WARNING and mirrors it into any `start_trace("slow_batch", ...)` files —
the stage-level flight recorder a dead bench round needs. The port's copy
of ``emqx_tpu/apps/tracer.py``.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, TextIO

from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.utils import topic as T

log = logging.getLogger("emqx_tpu_torch.tracer")


class Trace:
    def __init__(self, kind: str, value: str, path: str):
        if kind not in ("clientid", "topic", "slow_batch"):
            raise ValueError(f"bad trace kind {kind!r}")
        self.kind = kind
        self.value = value
        self.path = path
        self._fh: Optional[TextIO] = open(path, "a")

    def matches_msg(self, msg: Message) -> bool:
        if self.kind == "slow_batch":
            return False
        if self.kind == "clientid":
            return msg.from_ == self.value
        return T.match(msg.topic, self.value)

    def matches_client(self, clientid: str) -> bool:
        return self.kind == "clientid" and clientid == self.value

    def write(self, line: str) -> None:
        if self._fh:
            ts = time.strftime("%Y-%m-%d %H:%M:%S")
            self._fh.write(f"{ts} {line}\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class Tracer:
    def __init__(self, node):
        self.node = node
        self._traces: dict[tuple[str, str], Trace] = {}
        # (monotonic ts, overlap, top bubbles) — the slow-batch causal
        # context is re-analyzed at most once per _SLOW_CTX_TTL_S
        self._slow_ctx: Optional[tuple] = None

    _SLOW_CTX_TTL_S = 5.0

    def load(self) -> "Tracer":
        h = self.node.hooks
        h.add("message.publish", self.on_message_publish, priority=-500,
              tag="tracer")
        h.add("client.connected", self.on_client_connected, tag="tracer")
        h.add("client.disconnected", self.on_client_disconnected,
              tag="tracer")
        h.add("session.subscribed", self.on_session_subscribed, tag="tracer")
        h.add("batch.slow", self.on_batch_slow, tag="tracer")
        h.add("pipeline.pin_stale", self.on_pin_stale, tag="tracer")
        h.add("latency.breach", self.on_latency_breach, tag="tracer")
        h.add("overload.shed", self.on_overload_shed, tag="tracer")
        return self

    def unload(self) -> None:
        for hp in ("message.publish", "client.connected",
                   "client.disconnected", "session.subscribed",
                   "batch.slow", "pipeline.pin_stale",
                   "latency.breach", "overload.shed"):
            self.node.hooks.delete(hp, "tracer")
        for t in self._traces.values():
            t.close()
        self._traces.clear()

    # ---- mgmt API (emqx_tracer:start_trace/stop_trace/lookup_traces) ----
    def start_trace(self, kind: str, value: str, path: str) -> bool:
        key = (kind, value)
        if key in self._traces:
            return False
        self._traces[key] = Trace(kind, value, path)
        return True

    def stop_trace(self, kind: str, value: str) -> bool:
        t = self._traces.pop((kind, value), None)
        if t is None:
            return False
        t.close()
        return True

    def lookup_traces(self) -> list[dict]:
        return [{"type": k, "value": v, "path": t.path}
                for (k, v), t in self._traces.items()]

    # ---- hooks ----
    def on_message_publish(self, msg: Message):
        for t in self._traces.values():
            if t.matches_msg(msg):
                t.write(f"PUBLISH from={msg.from_} topic={msg.topic} "
                        f"qos={msg.qos} retain={int(msg.retain)} "
                        f"payload={msg.payload[:128]!r}")
        return ("ok", msg)

    def on_client_connected(self, clientinfo: dict, conninfo) -> None:
        cid = clientinfo.get("clientid", "")
        for t in self._traces.values():
            if t.matches_client(cid):
                t.write(f"CONNECTED clientid={cid} "
                        f"username={clientinfo.get('username')} "
                        f"peer={clientinfo.get('peername')}")

    def on_client_disconnected(self, clientinfo: dict, reason) -> None:
        cid = clientinfo.get("clientid", "")
        for t in self._traces.values():
            if t.matches_client(cid):
                t.write(f"DISCONNECTED clientid={cid} reason={reason}")

    def on_batch_slow(self, info: dict) -> None:
        """`batch.slow` hook (broker.telemetry.record_total): a publish
        batch exceeded the slow-batch threshold — always logged, and
        mirrored into active slow_batch trace files. With the
        flight recorder on, the line carries the causal context the
        triage order reads first: the dispatch↔materialize overlap and
        the top bubble attribution of the recent windows (so a slow
        batch names WHERE its time went before anyone opens a metric
        dashboard)."""
        line = ("SLOW_BATCH " +
                " ".join(f"{k}={info[k]}" for k in sorted(info)))
        rec = getattr(self.node, "flight_recorder", None)
        if rec is not None:
            try:
                # a degraded pipeline makes EVERY batch slow — the
                # full-ring analysis runs on the event loop, so reuse
                # the last one for _SLOW_CTX_TTL_S instead of paying
                # O(ring) per batch exactly when the broker is slow
                now = time.monotonic()
                ctx = self._slow_ctx
                if ctx is None or now - ctx[0] > self._SLOW_CTX_TTL_S:
                    a = rec.analyze(per_window=1)
                    ctx = self._slow_ctx = (
                        now,
                        (a.get("overlap") or {}).get(
                            "dispatch_materialize"),
                        (a.get("bubbles") or {}).get("top") or [])
                _ts, ov, top = ctx
                if ov is not None:
                    line += f" overlap={ov}"
                if top:
                    line += " top_bubble=%s:%.3fs" % tuple(top[0])
            except Exception:  # noqa: BLE001 — context is best-effort
                pass
        log.warning("%s", line)
        for t in self._traces.values():
            if t.kind == "slow_batch":
                t.write(line)

    def on_latency_breach(self, ex: dict) -> None:
        """`latency.breach` hook (broker.latency): a message
        exceeded the ingress→routed SLO objective. The exemplar carries
        its window's flight-recorder trace id, so the log line names
        the CAUSAL CHAIN of the exact slow message — queue wait vs
        dispatch vs materialize vs lane backpressure — not an
        aggregate. The observatory throttles the hook to one fire per
        second, so a degraded pipeline (every message breaching) logs
        one chain per second, never one per message."""
        line = ("SLO_BREACH " +
                " ".join(f"{k}={ex[k]}" for k in sorted(ex)))
        rec = getattr(self.node, "flight_recorder", None)
        tid = ex.get("trace_id")
        if rec is not None and tid:
            try:
                spans = sorted(
                    (s for s in rec.spans()
                     if s.trace_id == tid and s.t1 > s.t0
                     and s.name not in ("window", "message")),
                    key=lambda s: s.t0)
                chain = ",".join(f"{s.name}:{s.dur * 1000:.1f}ms"
                                 for s in spans[:12])
                if chain:
                    line += f" chain={chain}"
            except Exception:  # noqa: BLE001 — context is best-effort
                pass
        log.warning("%s", line)

    def on_overload_shed(self, info: dict) -> None:
        """`overload.shed` hook (broker.overload): the
        governor armed (or unwound) a shed action — or disconnected a
        top-offender connection. One WARNING line per transition (arms
        are grade-change-edge-triggered, never per-message), so the
        log reads as the ladder's movement history."""
        log.warning("OVERLOAD_SHED %s",
                    " ".join(f"{k}={info[k]}" for k in sorted(info)))

    def on_pin_stale(self, info: dict) -> None:
        """`pipeline.pin_stale` hook (broker.hbm_ledger): a
        dispatch handle has pinned its snapshot longer than
        broker.pin_warn_windows prepared windows — stale pins
        silently block snapshot swaps AND hold the old snapshot's
        HBM, so the leak is logged the moment it crosses the
        threshold instead of surfacing as a mystery rebuild stall."""
        log.warning("STALE_PIN %s",
                    " ".join(f"{k}={info[k]}" for k in sorted(info)))

    def on_session_subscribed(self, clientinfo: dict, topic: str,
                              subopts: dict) -> None:
        cid = clientinfo.get("clientid", "")
        for t in self._traces.values():
            if t.matches_client(cid) or (t.kind == "topic"
                                         and T.match(topic, t.value)):
                t.write(f"SUBSCRIBE clientid={cid} topic={topic} "
                        f"qos={subopts.get('qos', 0)}")
