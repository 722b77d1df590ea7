"""Config store: schema-defaulted nested map with zone overrides.

Parity: emqx_config.erl (get/put with zone- and listener-scoped lookups,
emqx_config.erl:63-100) + the mqtt/zone portions of emqx_schema.erl. The
port's copy of ``emqx_tpu/broker/config.py``: the same ``DEFAULTS`` tree
(every root section, the feature apps' and those of layers the port does
not have yet among them, so ``to_dict`` and what ``update`` persists
equal the reference's), with the HOCON file boot (``Config.load_file``,
the ``emqx_override.conf`` beside the file) and the runtime-update
handlers (``register_handler``, ``update``) that persist through
``emqx_tpu_torch.utils.hocon.dumps``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Optional

from emqx_tpu_torch.utils import hocon

# schema defaults — the reference's emqx_schema.erl zone/mqtt roots
DEFAULTS: dict = {
    "mqtt": {
        "max_packet_size": 1024 * 1024,
        "max_clientid_len": 65535,
        "max_topic_levels": 128,
        "max_qos_allowed": 2,
        "max_topic_alias": 65535,
        "retain_available": True,
        "wildcard_subscription": True,
        "shared_subscription": True,
        "ignore_loop_deliver": False,
        "strict_mode": False,
        "response_information": "",
        "server_keepalive": 0,           # 0 = accept client value
        "keepalive_backoff": 0.75,
        "max_subscriptions": 0,
        "upgrade_qos": False,
        "max_inflight": 32,
        "retry_interval": 30,
        "max_awaiting_rel": 100,
        "await_rel_timeout": 300,
        "session_expiry_interval": 7200,
        "max_mqueue_len": 1000,
        "mqueue_priorities": {},
        "mqueue_default_priority": "lowest",
        "mqueue_store_qos0": True,
        "use_username_as_clientid": False,
        "peer_cert_as_username": None,
        "idle_timeout": 15,
    },
    "broker": {
        "sys_msg_interval": 60,
        "sys_heartbeat_interval": 30,
        "shared_subscription_strategy": "round_robin",
        "shared_dispatch_ack_enabled": False,
        "route_batch_clean": True,
        # None = the built-in 256 (device_engine.resolve_rebuild_threshold)
        "rebuild_threshold": None,
        "device_min_batch": 4,
        # None = min(4, cpus) (broker/deliver.resolve_deliver_lanes); 0
        # is the inline delivery loop
        "deliver_lanes": None,
        # max outstanding delivery plans before the batcher's consumer
        # blocks (backpressure up through _inflight to submit/enqueue)
        "deliver_lane_depth": 8,
        # fault-domain supervision (broker/supervise.py): fault
        # injection points, circuit breakers and the degradation ladder,
        # the window journal and the stage watchdogs. None = on
        # (resolve_supervise); false builds no supervisor anywhere
        "supervise": None,
        # consecutive faults before a stage's circuit breaker opens
        # (None = 3, supervise.resolve_breaker_threshold)
        "supervise_threshold": None,
        # the flight recorder (broker/trace.py; None = on)
        "trace": None,
        # per-message span sampling 1-in-N (None = 256; 0 disables
        # message spans, window spans stay on)
        "trace_sample": None,
        # flight-recorder ring capacity, in spans
        "trace_ring": 4096,
        # the HBM ledger (broker/hbm_ledger.py; None = on)
        "hbm_ledger": None,
        # None = on (broker/connection.resolve_columnar_ingress); false
        # restores the per-packet PUBLISH ingress path exactly —
        # parser.feed, per-packet handle_in, one accept loop, no
        # `ingress` telemetry section
        "columnar_ingress": None,
        # SO_REUSEPORT acceptor lanes per TCP listener (None = min(4,
        # cpus); must be >= 1; columnar_ingress false forces 1)
        "ingress_lanes": None,
        # the latency observatory (broker/latency.py; None = on)
        "latency_observatory": None,
        # end-to-end objective in ms for the ingress->routed p99 (None =
        # 2.0; must be > 0)
        "slo_route_p99_ms": None,
        # the overload governor (broker/overload.py; None = on)
        "overload": None,
        # the mesh's device exchange (parallel/serving.py; None = on)
        "device_exchange": None,
        # stale-pin threshold in windows (None = 64; must be > 0)
        "pin_warn_windows": None,
        "perf": {"trie_compaction": True},
    },
    "zones": {},                 # zone name -> {mqtt: {...}} overrides
    "listeners": {},             # name -> {type,bind,zone,...}
    "authn": {"enable": False, "chain": []},
    "authz": {"no_match": "allow", "deny_action": "ignore", "sources": []},
    "retainer": {
        "enable": True, "max_retained_messages": 0,
        "max_payload_size": 1024 * 1024, "msg_expiry_interval": 0,
        "msg_clear_interval": 0,
    },
    "delayed": {"enable": True, "max_delayed_messages": 0},
    "rewrite": [],               # [{action,source,re,dest}]
    "topic_metrics": [],         # topic filters to meter
    "event_message": {e: False for e in (
        "client_connected", "client_disconnected", "session_subscribed",
        "session_unsubscribed", "message_delivered", "message_acked",
        "message_dropped")},
    "flapping_detect": {
        "enable": False, "max_count": 15, "window_time": 60,
        "ban_time": 300,
    },
    "force_shutdown": {"max_mqueue_len": 10000, "max_awaiting_rel": 0},
    "conn_congestion": {"enable_alarm": False,
                        "min_alarm_sustain_duration": 60},
    "rate_limit": {
        "max_conn_rate": 0,          # new connections/sec per listener
        "conn_messages_in": 0,       # packets/sec per connection
        "conn_bytes_in": 0,          # bytes/sec per connection
        "quota_messages_routing": 0,  # publishes/sec per connection
    },
    "alarm": {"size_limit": 1000, "validity_period": 86400},
    "log": {"enable": False, "level": "warning", "formatter": "text"},
    "sysmon": {"os": {"sysmem_high_watermark": 0.7,
                      "procmem_high_watermark": 0.05}},
    "rule_engine": {"rules": []},
    "cluster": {"name": "emqx_tpu", "discovery": "manual", "nodes": []},
    "rpc": {"mode": "async", "tcp_client_num": 4},
}


def deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def check_schema(conf: dict, schema: Optional[dict] = None,
                 path: str = "") -> list[str]:
    """Type-check a config against the DEFAULTS tree
    (the hocon_schema:check_plain analog). Duration strings ("30s") and
    size strings ("1MB") are coerced in place where the schema default is
    numeric; unknown keys are allowed (feature apps read their own
    sections). Returns a list of error strings."""
    schema = DEFAULTS if schema is None else schema
    errors: list[str] = []
    for key, val in list(conf.items()):
        here = f"{path}.{key}" if path else key
        if key not in schema:
            continue
        want = schema[key]
        if isinstance(want, dict) and path not in ("zones", "listeners"):
            if not isinstance(val, dict):
                errors.append(f"{here}: expected object, got "
                              f"{type(val).__name__}")
            elif here not in ("zones", "listeners", "mqueue_priorities"):
                errors.extend(check_schema(val, want, here))
            continue
        if isinstance(want, bool):
            if not isinstance(val, bool):
                errors.append(f"{here}: expected bool, got {val!r}")
            continue
        if isinstance(want, (int, float)) and not isinstance(want, bool):
            if isinstance(val, str):
                coerced = hocon.parse_duration(val)
                if coerced is None:
                    coerced = hocon.parse_size(val)
                if coerced is None:
                    errors.append(f"{here}: expected number, got {val!r}")
                else:
                    conf[key] = type(want)(coerced) \
                        if isinstance(want, int) and \
                        float(coerced).is_integer() else coerced
            elif isinstance(val, bool) or \
                    not isinstance(val, (int, float)):
                errors.append(f"{here}: expected number, got {val!r}")
            continue
        if isinstance(want, str) and val is not None and \
                not isinstance(val, str):
            errors.append(f"{here}: expected string, got {val!r}")
        if isinstance(want, list) and not isinstance(val, list):
            errors.append(f"{here}: expected array, got {val!r}")
    return errors


class Config:
    def __init__(self, overrides: Optional[dict] = None,
                 override_file: Optional[str] = None):
        self._c = deep_merge(copy.deepcopy(DEFAULTS), overrides or {})
        self.override_file = override_file
        self._overrides: dict = {}
        self._handlers: list[tuple[tuple, Any]] = []

    @classmethod
    def load_file(cls, path: str,
                  override_file: Optional[str] = None) -> "Config":
        """Boot from an etc/emqx.conf-style HOCON file, applying the
        persisted runtime-override file on top (emqx_config:init_load).
        Raises ValueError on schema type errors."""
        conf = hocon.load(path)
        if override_file is None:
            override_file = os.path.join(
                os.path.dirname(path) or ".", "emqx_override.conf")
        persisted: dict = {}
        if os.path.exists(override_file):
            persisted = hocon.load(override_file)
            conf = deep_merge(conf, persisted)
        errors = check_schema(conf)
        if errors:
            raise ValueError("config schema errors: " + "; ".join(errors))
        out = cls(conf, override_file=override_file)
        # seed with what is already on disk so the next update() rewrite
        # does not discard overrides persisted by previous runs
        out._overrides = persisted
        return out

    # ---- runtime updates (emqx_config_handler) ----
    def register_handler(self, path: "tuple | list", handler) -> None:
        """handler(path, new_value, config) called before the update is
        applied for any update at or under `path`; raising vetoes it."""
        self._handlers.append((tuple(path), handler))

    def update(self, path: "tuple | list", value: Any,
               persist: bool = True) -> None:
        """Apply a runtime config update through registered handlers and
        persist it to the override file (emqx_config_handler:update +
        save_to_override_conf)."""
        path = tuple(path)
        for prefix, handler in self._handlers:
            if path[:len(prefix)] == prefix or prefix[:len(path)] == path:
                handler(path, value, self)
        self.put(path, value)
        cur = self._overrides
        for p in path[:-1]:
            cur = cur.setdefault(p, {})
        cur[path[-1]] = value
        if persist and self.override_file:
            with open(self.override_file, "w", encoding="utf-8") as f:
                f.write(hocon.dumps(self._overrides))

    def get(self, *path, default: Any = None) -> Any:
        """get('mqtt') or get('mqtt', 'max_inflight')."""
        cur: Any = self._c
        for p in path:
            if not isinstance(cur, dict) or p not in cur:
                return default if default is not None else (
                    {} if len(path) == 1 else None)
            cur = cur[p]
        return cur

    def put(self, path: "tuple | list", value: Any) -> None:
        cur = self._c
        for p in path[:-1]:
            cur = cur.setdefault(p, {})
        cur[path[-1]] = value

    def get_zone(self, zone: Optional[str], *path, default: Any = None) -> Any:
        """Zone-scoped lookup falling back to global (emqx_config:get_zone_conf)."""
        if zone:
            zconf = self._c.get("zones", {}).get(zone, {})
            cur: Any = zconf
            found = True
            for p in path:
                if not isinstance(cur, dict) or p not in cur:
                    found = False
                    break
                cur = cur[p]
            if found:
                return cur
        return self.get(*path, default=default)

    def mqtt(self, zone: Optional[str] = None) -> dict:
        base = self.get("mqtt")
        if zone:
            return deep_merge(base, self._c.get("zones", {})
                              .get(zone, {}).get("mqtt", {}))
        return base

    def to_dict(self) -> dict:
        return copy.deepcopy(self._c)
