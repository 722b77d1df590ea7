"""Rule engine: SQL-on-events stream processing.

Parity: apps/emqx_rule_engine (emqx_rule_sqlparser.erl via dep rulesql,
emqx_rule_events.erl, emqx_rule_funcs.erl, emqx_rule_runtime.erl,
emqx_rule_registry.erl, emqx_rule_metrics.erl). SQL statements select and
transform event columns, filter with WHERE, optionally explode arrays with
FOREACH/DO/INCASE, and feed actions (republish, inspect, bridges).

The port's copy of ``emqx_tpu/rules/__init__.py``.
"""

from emqx_tpu_torch.rules.registry import Rule, RuleEngine
from emqx_tpu_torch.rules.runtime import apply_rule
from emqx_tpu_torch.rules.sqlparser import SqlError, parse_sql

__all__ = ["Rule", "RuleEngine", "apply_rule", "parse_sql", "SqlError"]
