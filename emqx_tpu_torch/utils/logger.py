"""Logging: JSON/text formatters with per-client metadata scoping.

Parity: emqx_logger.erl + emqx_logger_jsonfmt.erl /
emqx_logger_textfmt.erl — the reference scopes every log line inside a
connection process with clientid/peername metadata and offers a JSON
formatter for machine ingestion. asyncio has no process dictionary, so
the metadata rides a contextvar that each connection task sets once
(set_metadata_clientid / set_metadata_peername); a logging.Filter copies
it onto every record emitted from that task's context.

The port's copy of ``emqx_tpu/utils/logger.py``: its handler sinks the
``emqx_tpu_torch`` namespace, the port's loggers.
"""

from __future__ import annotations

import contextvars
import json
import logging
import time
from typing import Any, Optional

_log_metadata: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "emqx_log_metadata", default={})


def set_metadata(**kv: Any) -> None:
    md = dict(_log_metadata.get())
    md.update(kv)
    _log_metadata.set(md)


def set_metadata_clientid(clientid: str) -> None:
    set_metadata(clientid=clientid)


def set_metadata_peername(peername: str) -> None:
    set_metadata(peername=peername)


def clear_metadata() -> None:
    _log_metadata.set({})


class MetadataFilter(logging.Filter):
    """Attach the task-scoped metadata to every record."""

    def filter(self, record: logging.LogRecord) -> bool:
        for k, v in _log_metadata.get().items():
            if not hasattr(record, k):
                setattr(record, k, v)
        record.emqx_metadata = _log_metadata.get()
        return True


_STD_ATTRS = frozenset(vars(logging.makeLogRecord({})))


class JsonFormatter(logging.Formatter):
    """One JSON object per line: time/level/msg + metadata + extras
    (emqx_logger_jsonfmt.erl best_effort_json)."""

    def format(self, record: logging.LogRecord) -> str:
        out: dict[str, Any] = {
            "time": int(record.created * 1_000_000),    # µs like the ref
            "level": record.levelname.lower(),
            "msg": record.getMessage(),
            "logger": record.name,
        }
        for k, v in vars(record).items():
            if k in _STD_ATTRS or k in ("emqx_metadata", "message"):
                continue
            out[k] = v
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        try:
            return json.dumps(out, default=_best_effort)
        except (TypeError, ValueError):
            return json.dumps({"time": out["time"], "level": out["level"],
                               "msg": str(out.get("msg"))})


def _best_effort(v: Any) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return repr(v)


class TextFormatter(logging.Formatter):
    """`2021-… [level] clientid@peername: msg` (emqx_logger_textfmt)."""

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S",
                           time.localtime(record.created))
        md = getattr(record, "emqx_metadata", None) or {}
        who = ""
        if md.get("clientid") or md.get("peername"):
            who = (f" {md.get('clientid', '')}"
                   f"@{md.get('peername', '')}:")
        base = (f"{ts}.{int(record.msecs):03d} "
                f"[{record.levelname.lower()}]{who} {record.getMessage()}")
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


def setup(level: int = logging.INFO, fmt: str = "text",
          stream=None) -> logging.Handler:
    """Install a root handler for the emqx_tpu_torch namespace."""
    handler = logging.StreamHandler(stream)
    handler.setFormatter(JsonFormatter() if fmt == "json"
                         else TextFormatter())
    handler.addFilter(MetadataFilter())
    root = logging.getLogger("emqx_tpu_torch")
    root.addHandler(handler)
    root.setLevel(level)
    # this handler is the namespace's sink: without this, records also
    # propagate to any root handler and print twice
    root.propagate = False
    return handler


_configured = False


def setup_from_config(conf: dict) -> Optional[logging.Handler]:
    """Boot-time wiring from the `log` config block (node.py calls this;
    idempotent per process so test fixtures creating many Nodes don't
    stack handlers)."""
    global _configured
    if _configured or not (conf or {}).get("enable", False):
        return None
    _configured = True
    level = getattr(logging, str(conf.get("level", "warning")).upper(),
                    logging.WARNING)
    return setup(level=level, fmt=conf.get("formatter", "text"))
