"""Topic rewrite rules for publish and subscribe.

Parity: apps/emqx_modules/src/emqx_rewrite.erl — ordered rules
{action pub|sub|all, source filter, regex, dest template}; a topic that
matches both the MQTT filter and the regex is rewritten to the template
with $1..$N substituted from regex capture groups; rules fold in order,
each seeing the previous rewrite's output. Hooks: `message.publish` (pub),
`client.subscribe` / `client.unsubscribe` (sub). The port's copy of
``emqx_tpu/apps/rewrite.py``.
"""

from __future__ import annotations

import re
from typing import Optional

from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.utils import topic as T

_VAR = re.compile(r"\$(\d+)")


class RewriteRule:
    def __init__(self, action: str, source: str, regex: str, dest: str):
        if action not in ("publish", "subscribe", "all"):
            raise ValueError(f"bad rewrite action {action!r}")
        self.action = action
        self.source = source
        self.re = re.compile(regex)
        self.dest = dest

    def apply(self, topic: str) -> Optional[str]:
        if not T.match(topic, self.source):
            return None
        m = self.re.match(topic)
        if m is None:
            return None
        groups = m.groups()

        def sub(v: "re.Match[str]") -> str:
            i = int(v.group(1))
            return groups[i - 1] if 0 < i <= len(groups) else v.group(0)

        return _VAR.sub(sub, self.dest)


class TopicRewrite:
    def __init__(self, node, rules: Optional[list] = None):
        self.node = node
        raw = rules if rules is not None else (
            node.config.get("rewrite") or [])
        self.rules = [r if isinstance(r, RewriteRule) else RewriteRule(
            r.get("action", "all"), r["source"], r["re"], r["dest"])
            for r in raw]

    def load(self) -> "TopicRewrite":
        self.node.hooks.add("message.publish", self.on_message_publish,
                            priority=900, tag="rewrite")
        self.node.hooks.add("client.subscribe", self.on_client_subscribe,
                            tag="rewrite")
        self.node.hooks.add("client.unsubscribe", self.on_client_unsubscribe,
                            tag="rewrite")
        return self

    def unload(self) -> None:
        for h in ("message.publish", "client.subscribe",
                  "client.unsubscribe"):
            self.node.hooks.delete(h, "rewrite")

    def _rewrite(self, topic: str, action: str) -> str:
        for rule in self.rules:
            if rule.action not in (action, "all"):
                continue
            new = rule.apply(topic)
            if new is not None:
                topic = new
        return topic

    # ---- hooks ----
    def on_message_publish(self, msg: Message):
        if msg.topic.startswith("$SYS/"):
            return ("ok", msg)
        new = self._rewrite(msg.topic, "publish")
        if new != msg.topic:
            msg.topic = new
        return ("ok", msg)

    def _rewrite_filter(self, tf: str) -> str:
        """Rewrite the real part, preserving any $share/$queue prefix."""
        try:
            real, opts = T.parse(tf)
        except T.TopicError:
            return tf
        new = self._rewrite(real, "subscribe")
        if new == real:
            return tf
        group = opts.get("share")
        if group == "$queue":
            return f"$queue/{new}"
        if group:
            return f"$share/{group}/{new}"
        return new

    def on_client_subscribe(self, clientinfo, props, filters):
        return ("ok", [(self._rewrite_filter(tf), o) for tf, o in filters])

    def on_client_unsubscribe(self, clientinfo, props, filters):
        return ("ok", [self._rewrite_filter(tf) for tf in filters])
