"""Rule registry + engine: CRUD, hook wiring, per-event dispatch.

Parity: emqx_rule_registry.erl (rule table) + emqx_rule_engine.erl
(create_rule) + the hook bridging in emqx_rule_events.erl:47-51 (one hook
per event present in any enabled rule's FROM clause). message.publish rules
additionally topic-filter on their FROM patterns before running SQL
(emqx_rule_runtime:apply_rules per-rule topic match).

The port's copy of ``emqx_tpu/rules/registry.py``. A ``message.publish``
rule runs inside the batcher's hook fold (``PublishBatcher._fold_hooks``),
one call a message; a republish goes out through ``broker.publish_soon``
and routes on the host path, as in the reference.
"""

from __future__ import annotations

import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from emqx_tpu_torch.rules import events as EV
from emqx_tpu_torch.rules.actions import run_action
from emqx_tpu_torch.rules.metrics import RuleMetrics
from emqx_tpu_torch.rules.runtime import apply_sql
from emqx_tpu_torch.rules.sqlparser import parse_sql
from emqx_tpu_torch.utils import topic as T

log = logging.getLogger("emqx_tpu_torch.rules")

HOOK_TAG = "rule_engine"


@dataclass
class Rule:
    id: str
    sql: str
    ast: dict
    actions: list[dict]                  # [{"name":..., "params": {...}}]
    enabled: bool = True
    description: str = ""
    created_at: int = 0
    metrics: RuleMetrics = field(default_factory=RuleMetrics)

    @property
    def events(self) -> list[str]:
        return sorted({EV.event_name(t) for t in self.ast["from"]})

    def publish_filters(self) -> list[str]:
        """Non-$events FROM topics (message.publish topic filters)."""
        return [t for t in self.ast["from"]
                if EV.event_name(t) == "message.publish"]

    def to_map(self) -> dict:
        return {"id": self.id, "sql": self.sql, "enabled": self.enabled,
                "description": self.description,
                "created_at": self.created_at,
                "actions": [dict(a) for a in self.actions],
                "for": self.ast["from"],
                "metrics": self.metrics.to_map()}


class RuleEngine:
    def __init__(self, node):
        self.node = node
        self.rules: dict[str, Rule] = {}
        # event -> set of rule ids (emqx_rule_registry's rules_for)
        self._by_event: dict[str, set[str]] = {}
        self._hooked: set[str] = set()

    # ---- lifecycle ----
    def load(self) -> "RuleEngine":
        self.node.rule_engine = self
        return self

    def unload(self) -> None:
        for event in list(self._hooked):
            self._unhook(event)
        self.rules.clear()
        self._by_event.clear()
        if getattr(self.node, "rule_engine", None) is self:
            self.node.rule_engine = None

    # ---- CRUD (emqx_rule_engine:create_rule) ----
    def create_rule(self, sql: str, actions: list[dict],
                    rule_id: Optional[str] = None, enabled: bool = True,
                    description: str = "") -> Rule:
        ast = parse_sql(sql)
        rid = rule_id or f"rule:{uuid.uuid4().hex[:8]}"
        if rid in self.rules:
            raise ValueError(f"rule {rid} already exists")
        rule = Rule(id=rid, sql=sql, ast=ast, actions=list(actions),
                    enabled=enabled, description=description,
                    created_at=int(time.time() * 1000))
        self.rules[rid] = rule
        for event in rule.events:
            self._by_event.setdefault(event, set()).add(rid)
            if enabled:
                self._hook(event)
        return rule

    def delete_rule(self, rule_id: str) -> bool:
        rule = self.rules.pop(rule_id, None)
        if rule is None:
            return False
        for event, ids in list(self._by_event.items()):
            ids.discard(rule_id)
            if not ids:
                del self._by_event[event]
                self._unhook(event)
        return True

    def enable_rule(self, rule_id: str, enabled: bool) -> None:
        self.rules[rule_id].enabled = enabled
        if enabled:
            for event in self.rules[rule_id].events:
                self._hook(event)

    def get_rule(self, rule_id: str) -> Optional[Rule]:
        return self.rules.get(rule_id)

    def list_rules(self) -> list[Rule]:
        return sorted(self.rules.values(), key=lambda r: r.id)

    def tick_metrics(self) -> None:
        for r in self.rules.values():
            r.metrics.tick()

    # ---- hook wiring ----
    def _hook(self, event: str) -> None:
        if event in self._hooked:
            return
        self._hooked.add(event)
        handler = {
            "message.publish": self._on_publish,
            "client.connected": self._on_connected,
            "client.disconnected": self._on_disconnected,
            "session.subscribed": self._on_subscribed,
            "session.unsubscribed": self._on_unsubscribed,
            "message.delivered": self._on_delivered,
            "message.acked": self._on_acked,
            "message.dropped": self._on_dropped,
        }[event]
        self.node.hooks.add(event, handler, tag=HOOK_TAG, priority=-99)

    def _unhook(self, event: str) -> None:
        if event in self._hooked:
            self._hooked.discard(event)
            self.node.hooks.delete(event, HOOK_TAG)

    # ---- dispatch ----
    def _apply(self, event: str, columns: dict,
               publish_topic: Optional[str] = None) -> None:
        for rid in sorted(self._by_event.get(event, ())):
            rule = self.rules.get(rid)
            if rule is None or not rule.enabled:
                continue
            if publish_topic is not None:
                pats = rule.publish_filters()
                if pats and not any(T.match(publish_topic, p)
                                    for p in pats):
                    continue
            self._apply_one(rule, columns)

    def _apply_one(self, rule: Rule, columns: dict) -> None:
        m = rule.metrics
        m.inc("sql.matched")
        try:
            outs = apply_sql(rule.ast, columns)
        except Exception:  # noqa: BLE001 — SQL eval errors are per-rule stats
            m.inc("sql.failed")
            m.inc("sql.failed.exception")
            log.debug("rule %s sql failed", rule.id, exc_info=True)
            return
        if not outs:
            m.inc("sql.failed")
            m.inc("sql.failed.no_result")
            return
        m.inc("sql.passed")
        envs = {"rule_id": rule.id, "event": columns.get("event"),
                "__republished": columns.get("__republished", False)}
        for out in outs:
            for action in rule.actions:
                try:
                    run_action(self.node, action["name"],
                               action.get("params", {}), out, envs)
                    m.inc("actions.success")
                except Exception:  # noqa: BLE001
                    m.inc("actions.error")
                    log.debug("rule %s action %s failed", rule.id,
                              action["name"], exc_info=True)

    # ---- hook handlers (arg shapes per this broker's hookpoints) ----
    def _on_publish(self, msg):
        if msg.topic.startswith("$SYS/"):
            return
        cols = EV.columns_publish(msg)
        cols["__republished"] = bool(msg.get_header("__republished"))
        self._apply("message.publish", cols, publish_topic=msg.topic)

    def _on_connected(self, clientinfo, info):
        self._apply("client.connected",
                    EV.columns_connected(clientinfo, info or {}))

    def _on_disconnected(self, clientinfo, reason):
        self._apply("client.disconnected",
                    EV.columns_disconnected(clientinfo, reason))

    def _on_subscribed(self, clientinfo, topic, subopts):
        self._apply("session.subscribed",
                    EV.columns_sub_unsub("session.subscribed", clientinfo,
                                         topic, subopts))

    def _on_unsubscribed(self, clientinfo, topic):
        self._apply("session.unsubscribed",
                    EV.columns_sub_unsub("session.unsubscribed",
                                         clientinfo, topic))

    def _on_delivered(self, clientid, msg):
        self._apply("message.delivered", EV.columns_delivered(clientid, msg))

    def _on_acked(self, clientinfo, msg):
        cid = clientinfo.get("clientid") if isinstance(clientinfo, dict) \
            else clientinfo
        self._apply("message.acked", EV.columns_acked(cid, msg))

    def _on_dropped(self, msg, reason):
        self._apply("message.dropped", EV.columns_dropped(msg, reason))

    # ---- sql test (emqx_rule_sqltester) ----
    def test_sql(self, sql: str, context: dict) -> list[dict]:
        """Dry-run a SQL statement against a sample event context."""
        ast = parse_sql(sql)
        event = dict(context)
        event.setdefault("event", "message_publish")
        return apply_sql(ast, event)
