"""Rule runtime: evaluate a parsed SQL statement against event columns.

Parity: emqx_rule_runtime.erl — apply_rule pipeline: (FOREACH | SELECT)
columns -> WHERE filter -> per-output action invocation. Column references
resolve against the event map first, then against already-selected output
(so `SELECT payload.x as x, x + 1 as y` works, like select_and_transform's
fold). The special var `item` (or the FOREACH alias) binds the current array
element inside DO/INCASE.

The port's copy of ``emqx_tpu/rules/runtime.py``.
"""

from __future__ import annotations

from typing import Any, Optional

from emqx_tpu_torch.rules import funcs
from emqx_tpu_torch.rules.maps import nested_get, nested_put


class EvalError(Exception):
    pass


def _resolve_var(path: list, scopes: list[dict]) -> Any:
    head = path[0]
    for scope in scopes:
        if isinstance(scope, dict) and head in scope:
            return nested_get(scope[head], path[1:]) if path[1:] \
                else scope[head]
    return None


def _eval_path(path: list, scopes: list[dict]) -> list:
    """Evaluate ('idx', expr) segments to concrete ('idx', int)."""
    out = []
    for seg in path:
        if isinstance(seg, tuple) and seg[0] == "idx":
            out.append(("idx", int(eval_expr(seg[1], scopes))))
        else:
            out.append(seg)
    return out


def eval_expr(ast: Any, scopes: list[dict]) -> Any:
    tag = ast[0]
    if tag == "lit":
        return ast[1]
    if tag == "var":
        return _resolve_var(_eval_path(ast[1], scopes), scopes)
    if tag == "call":
        name = ast[1]
        if not ast[2] and name in funcs.COLUMN_FUNCS:
            # zero-arg column accessors: qos(), topic(), clientid(), ...
            col = funcs.COLUMN_FUNCS[name]
            if name == "flags":
                return _resolve_var([col], scopes) or {}
            return _resolve_var([col], scopes)
        if name == "flag" and len(ast[2]) == 1:
            fl = _resolve_var(["flags"], scopes) or {}
            return bool(fl.get(funcs._s(eval_expr(ast[2][0], scopes))))
        return funcs.call(name, [eval_expr(a, scopes) for a in ast[2]])
    if tag == "neg":
        return -eval_expr(ast[1], scopes)
    if tag == "not":
        return not _truthy(eval_expr(ast[1], scopes))
    if tag == "and":
        return _truthy(eval_expr(ast[1], scopes)) and \
            _truthy(eval_expr(ast[2], scopes))
    if tag == "or":
        return _truthy(eval_expr(ast[1], scopes)) or \
            _truthy(eval_expr(ast[2], scopes))
    if tag == "bin":
        return _binop(ast[1], eval_expr(ast[2], scopes),
                      eval_expr(ast[3], scopes))
    if tag == "case":
        for cond, then in ast[1]:
            if _truthy(eval_expr(cond, scopes)):
                return eval_expr(then, scopes)
        return eval_expr(ast[2], scopes) if ast[2] is not None else None
    raise EvalError(f"bad ast node {tag!r}")


def _truthy(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if v in ("true", "false"):
        return v == "true"
    raise EvalError(f"non-boolean in condition: {v!r}")


def _cmp_norm(v):
    return v


def _binop(op: str, a: Any, b: Any) -> Any:
    if op == "=":
        return _loose_eq(a, b)
    if op in ("<>", "!="):
        return not _loose_eq(a, b)
    if op == "=~":
        import re
        return bool(re.search(funcs._s(b), funcs._s(a)))
    if op in (">", "<", ">=", "<="):
        if isinstance(a, str) and isinstance(b, str):
            pass
        else:
            a, b = funcs._num(a), funcs._num(b)
        return {"<": a < b, ">": a > b, ">=": a >= b, "<=": a <= b}[op]
    if op == "%":
        op = "mod"
    return funcs.call(op, [a, b])


def _loose_eq(a: Any, b: Any) -> bool:
    if type(a) is type(b):
        return a == b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b
    # string/number coercion ('1' = 1) like rulesql's compare
    try:
        return funcs._num(a) == funcs._num(b)
    except (TypeError, ValueError):
        return funcs._s(a) == funcs._s(b)


def select_fields(fields: list, scopes: list[dict]) -> dict:
    out: dict = {}
    # selected columns become visible to later fields and WHERE
    eval_scopes = [out] + scopes
    for expr, alias in fields:
        if expr == ("*",):
            for scope in reversed(scopes):
                out.update(scope)
            continue
        val = eval_expr(expr, eval_scopes)
        if alias:
            tmp = nested_put(out, list(alias), val)
            out.clear()
            out.update(tmp)
        else:
            key = _default_alias(expr)
            out[key] = val
    return out


def _default_alias(expr) -> str:
    if expr[0] == "var":
        last = expr[1][-1]
        return expr[1][0] if isinstance(last, tuple) else str(last)
    if expr[0] == "call":
        return expr[1]
    return "value"


def apply_sql(ast: dict, event: dict) -> list[dict]:
    """Run one statement against one event's columns.

    Returns the list of output column maps (0 or 1 for SELECT; one per
    array element for FOREACH). Empty list = WHERE/INCASE filtered out."""
    scopes = [event]
    where = ast.get("where")
    if ast["type"] == "select":
        out = select_fields(ast["fields"], scopes)
        if where is not None and not _truthy(eval_expr(where,
                                                       [out] + scopes)):
            return []
        return [out]

    # FOREACH
    if where is not None and not _truthy(eval_expr(where, scopes)):
        return []
    seq = eval_expr(ast["foreach"], scopes)
    if isinstance(seq, (str, bytes)):
        import json
        try:
            seq = json.loads(seq)
        except ValueError:
            return []
    if not isinstance(seq, list):
        return []
    alias = ast.get("alias") or "item"
    outs = []
    for elem in seq:
        item_scope = {alias: elem, "item": elem}
        sc = [item_scope] + scopes
        if ast.get("incase") is not None and \
                not _truthy(eval_expr(ast["incase"], sc)):
            continue
        if ast.get("do"):
            outs.append(select_fields(ast["do"], sc))
        else:
            outs.append(elem if isinstance(elem, dict) else {"item": elem})
    return outs


def apply_rule(rule, event: dict) -> list[dict]:
    """Convenience: rule has a compiled `.ast`."""
    return apply_sql(rule.ast, event)
