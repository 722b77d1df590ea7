"""Prometheus exporter.

Parity: apps/emqx_prometheus — collector turning broker metrics/stats/VM
info into the Prometheus text exposition format, a REST endpoint
(`GET /api/v5/prometheus/stats`), and an optional push-gateway timer
(emqx_prometheus.erl push mode).
"""

from __future__ import annotations

import asyncio
import logging
import resource
import time
from typing import Optional

log = logging.getLogger("emqx_tpu_torch.prometheus")


def _san(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _lbl(value: str) -> str:
    """Escape a label VALUE per the exposition format (backslash first,
    then quote and newline)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_le(bound: float) -> str:
    """Prometheus `le` label rendering: +Inf for the overflow bucket,
    shortest-repr floats otherwise."""
    if bound == float("inf"):
        return "+Inf"
    return repr(bound)


def collect(node) -> str:
    """Render the node's counters/gauges/histograms in text exposition
    format. Each metric family declares `# TYPE` exactly once (a family
    with several samples — labeled rule metrics, histogram bucket
    series — shares the one declaration), histogram buckets are
    cumulative and end in `+Inf`, and label values are escaped."""
    out: list[str] = []
    declared: set[str] = set()

    def declare(name: str, kind: str, help_: str = "") -> None:
        if name in declared:
            return
        declared.add(name)
        if help_:
            out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {kind}")

    def emit(name: str, value, kind: str = "counter",
             help_: str = "") -> None:
        declare(name, kind, help_)
        out.append(f"{name} {value}")

    for name, val in sorted(node.metrics.all().items()):
        emit(f"emqx_{_san(name)}", val, "counter")
    for name, val in sorted(node.stats.sample().items()):
        emit(f"emqx_{_san(name)}", val, "gauge")
    # pipeline (and any other) histograms: _bucket{le}/_sum/_count series
    for name, h in sorted(node.metrics.histograms().items()):
        fam = f"emqx_{_san(name)}"
        declare(fam, "histogram")
        # one cumulative() pass is the scrape's consistent view: _count
        # must equal the +Inf bucket even when an executor thread
        # observes mid-collect (reading h.count separately could exceed
        # the bucket series and fail ingester consistency checks)
        cum = h.cumulative()
        for bound, c in cum:
            out.append(f'{fam}_bucket{{le="{_fmt_le(bound)}"}} {c}')
        out.append(f"{fam}_sum {h.sum}")
        out.append(f"{fam}_count {cum[-1][1]}")
    ru = resource.getrusage(resource.RUSAGE_SELF)
    emit("emqx_vm_used_memory_kb", ru.ru_maxrss, "gauge",
         "resident set size")
    emit("emqx_vm_cpu_time_seconds",
         round(ru.ru_utime + ru.ru_stime, 3), "counter")
    eng = getattr(node, "rule_engine", None)
    if eng is not None:
        # group by FAMILY first: the exposition format requires all
        # samples of one family consecutive under its single TYPE line
        # (per-rule emission interleaved families when >1 rule existed)
        fams: dict[str, list[str]] = {}
        for r in eng.list_rules():
            rid = _lbl(_san(r.id))
            for k, v in r.metrics.counters.items():
                fams.setdefault(f"emqx_rule_{_san(k)}", []).append(
                    f'{{rule="{rid}"}} {v}')
        for fam in sorted(fams):
            declare(fam, "counter")
            out.extend(fam + s for s in fams[fam])
    return "\n".join(out) + "\n"


class PrometheusApp:
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        c = dict(node.config.get("prometheus") or {})
        c.update(conf or {})
        self.push_gateway = c.get("push_gateway_server")  # http://host:port
        self.interval = c.get("interval", 15.0)
        self.job_name = c.get("job_name", "emqx_tpu")
        self._task: Optional[asyncio.Task] = None

    def load(self) -> "PrometheusApp":
        self.node.prometheus = self
        if self.push_gateway:
            self._task = asyncio.get_running_loop().create_task(
                self._push_loop())
        return self

    def unload(self) -> None:
        if self._task:
            self._task.cancel()
        if getattr(self.node, "prometheus", None) is self:
            self.node.prometheus = None

    def collect_text(self) -> str:
        return collect(self.node)

    async def _push_loop(self) -> None:
        from emqx_tpu_torch.utils.http import request
        url = (f"{self.push_gateway}/metrics/job/{self.job_name}"
               f"/instance/{self.node.name}")
        while True:
            await asyncio.sleep(self.interval)
            try:
                await request("POST", url,
                              headers={"content-type": "text/plain"},
                              body=self.collect_text().encode(),
                              timeout=5)
            except Exception as e:  # noqa: BLE001
                log.debug("prometheus push failed: %s", e)


def register_api(srv, node) -> None:
    """Mount GET /api/v5/prometheus/stats on the mgmt HTTP server."""
    async def prom_stats(_req):
        return 200, collect(node).encode()
    srv.route("GET", "/api/v5/prometheus/stats", prom_stats)
    srv.route("GET", "/metrics", prom_stats)   # standard scrape path
