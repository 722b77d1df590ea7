"""OS/VM resource monitors feeding the alarm manager.

Parity: apps/emqx/src/emqx_os_mon.erl (sysmem/procmem high watermarks →
alarms, emqx_os_mon.erl:28-31), emqx_vm_mon.erl (process-count watermark)
and emqx_vm.erl introspection. Readings come from /proc (Linux) and the
`resource`/`os` modules — no psutil in this build.

The port's copy of ``emqx_tpu/broker/monitor.py``: the node builds it from
``sysmon.os`` and ticks it on every ``sweep``. The readings are the host's
(the process's resident memory, not the card's).
"""

from __future__ import annotations

import os
import resource
from typing import Optional


def sys_memory() -> tuple[int, int]:
    """(used_bytes, total_bytes) from /proc/meminfo; (0, 0) if unreadable."""
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                info[k.strip()] = int(v.split()[0]) * 1024
        total = info.get("MemTotal", 0)
        avail = info.get("MemAvailable", info.get("MemFree", 0))
        return total - avail, total
    except OSError:
        return 0, 0


def proc_memory() -> int:
    """This process's RSS in bytes."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError):
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def cpu_load() -> float:
    """1-minute loadavg normalized by core count (0..1-ish)."""
    try:
        return os.getloadavg()[0] / (os.cpu_count() or 1)
    except OSError:
        return 0.0


class OsMon:
    """Watermark checks run from Node housekeeping (`tick`)."""

    def __init__(self, alarms, conf: Optional[dict] = None):
        c = dict(conf or {})
        self.alarms = alarms
        self.sysmem_high = float(c.get("sysmem_high_watermark", 0.70))
        self.procmem_high = float(c.get("procmem_high_watermark", 0.05))
        self.cpu_high = float(c.get("cpu_high_watermark", 0.80))
        self.cpu_low = float(c.get("cpu_low_watermark", 0.60))

    def tick(self) -> None:
        used, total = sys_memory()
        if total:
            usage = used / total
            self.alarms.ensure(
                "high_system_memory_usage", usage > self.sysmem_high,
                {"usage": round(usage, 4),
                 "high_watermark": self.sysmem_high},
                f"system memory usage {usage:.1%}")
            pusage = proc_memory() / total
            self.alarms.ensure(
                "high_process_memory_usage", pusage > self.procmem_high,
                {"usage": round(pusage, 4),
                 "high_watermark": self.procmem_high},
                f"broker process memory usage {pusage:.1%}")
        load = cpu_load()
        if self.alarms.is_active("high_cpu_usage"):
            if load < self.cpu_low:
                self.alarms.deactivate("high_cpu_usage")
        elif load > self.cpu_high:
            self.alarms.activate("high_cpu_usage",
                                 {"usage": round(load, 4)},
                                 f"cpu load {load:.1%}")

    def info(self) -> dict:
        used, total = sys_memory()
        return {"sysmem_used": used, "sysmem_total": total,
                "procmem": proc_memory(), "cpu_load": cpu_load(),
                "pid": os.getpid()}
