"""Built-in rule actions.

Parity: emqx_rule_actions.erl — inspect (console trace), republish
(template topic/payload/qos re-publish with loop protection), do_nothing;
data-to-bridge actions resolve through the resources layer by resource
id. Templates use ${var.path} placeholders like
emqx_rule_utils:preproc_tmpl.

The port's copy of ``emqx_tpu/rules/actions.py``. The port has no
resources layer yet: an action that is not built in raises
``ActionError("unknown action ...")`` while ``node.resources`` is absent,
as the reference does.
"""

from __future__ import annotations

import json
import logging
import re
from typing import Any, Callable

from emqx_tpu_torch.broker.message import make
from emqx_tpu_torch.rules.maps import nested_get, parse_path

log = logging.getLogger("emqx_tpu_torch.rules.actions")

_TMPL_RE = re.compile(r"\$\{([^}]+)\}")


def render_template(tmpl: str, columns: dict) -> str:
    """'${payload.x}' substitution (emqx_rule_utils:proc_tmpl)."""
    def sub(m):
        val = nested_get(columns, parse_path(m.group(1)))
        if val is None:
            return "undefined"
        if isinstance(val, (dict, list)):
            return json.dumps(val, separators=(",", ":"))
        if isinstance(val, bytes):
            return val.decode("utf-8", "replace")
        if isinstance(val, bool):
            return "true" if val else "false"
        return str(val)
    return _TMPL_RE.sub(sub, tmpl)


class ActionError(Exception):
    pass


def act_inspect(node, params: dict, columns: dict, envs: dict) -> None:
    log.info("[inspect] selected=%s envs=%s params=%s",
             columns, envs.get("event"), params)


def act_do_nothing(node, params: dict, columns: dict, envs: dict) -> None:
    return None


def act_republish(node, params: dict, columns: dict, envs: dict) -> None:
    """Re-publish with ${}-templated topic/payload/qos; republishing a
    message that itself came from a republish is refused to stop loops
    (emqx_rule_actions republish checks the republish-by flag)."""
    if envs.get("__republished"):
        log.warning("republish loop stopped for rule %s", envs.get("rule_id"))
        raise ActionError("republish loop detected")   # -> actions.error
    topic = render_template(params.get("target_topic", "repub/${topic}"),
                            columns)
    payload = render_template(params.get("payload_tmpl", "${payload}"),
                              columns)
    qos_t = params.get("target_qos", 0)
    if isinstance(qos_t, str):
        qos_t = int(render_template(qos_t, columns) or 0)
    qos = columns.get("qos", 0) if qos_t == -1 else qos_t
    msg = make(str(columns.get("clientid") or "rule_engine"), int(qos),
               topic, payload.encode(),
               headers={"republish_by": envs.get("rule_id")})
    msg.set_header("__republished", True)
    node.broker.publish_soon(msg)


BUILTIN_ACTIONS: dict[str, Callable] = {
    "inspect": act_inspect,
    "do_nothing": act_do_nothing,
    "republish": act_republish,
}


def run_action(node, name: str, params: dict, columns: dict,
               envs: dict) -> Any:
    fn = BUILTIN_ACTIONS.get(name)
    if fn is None:
        # resource-backed actions (data_to_*) dispatch via the resources app
        resources = getattr(node, "resources", None)
        if resources is not None and resources.has_action(name):
            return resources.run_action(name, params, columns, envs)
        raise ActionError(f"unknown action {name!r}")
    return fn(node, params, columns, envs)
