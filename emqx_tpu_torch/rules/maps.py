"""Nested map/array access for rule SQL columns.

Parity: emqx_rule_maps.erl — nested_get/nested_put over dotted paths with
1-based array indexing (`a.b[1].c`). Paths are lists whose segments are
either string keys or ('idx', i) entries (i already evaluated, 1-based;
negative counts from the end like the reference's `[-1]`).

The port's copy of ``emqx_tpu/rules/maps.py``.
"""

from __future__ import annotations

import json
import re
from typing import Any

_PATH_RE = re.compile(r"([^.\[\]]+)|\[(-?\d+)\]")


def parse_path(path: str) -> list:
    """'a.b[1].c' -> ['a', 'b', ('idx', 1), 'c']."""
    out: list = []
    for m in _PATH_RE.finditer(path):
        if m.group(1) is not None:
            out.append(m.group(1))
        else:
            out.append(("idx", int(m.group(2))))
    return out


def _idx(seg) -> Any:
    return seg[1] if isinstance(seg, tuple) and seg[0] == "idx" else None


def nested_get(obj: Any, path: list, default: Any = None) -> Any:
    cur = obj
    for seg in path:
        i = _idx(seg)
        if i is not None:
            if not isinstance(cur, list):
                return default
            j = i - 1 if i > 0 else i        # 1-based; negatives from end
            if -len(cur) <= j < len(cur):
                cur = cur[j]
            else:
                return default
        else:
            if isinstance(cur, (str, bytes)):
                # lazy JSON decode on nested access (the runtime's
                # may_decode_payload behavior for the payload column)
                try:
                    cur = json.loads(cur)
                except (ValueError, TypeError):
                    return default
            if isinstance(cur, dict):
                if seg in cur:
                    cur = cur[seg]
                else:
                    return default
            else:
                return default
    return cur


def nested_put(obj: Any, path: list, value: Any) -> Any:
    if not path:
        return value
    seg, rest = path[0], path[1:]
    i = _idx(seg)
    if i is not None:
        lst = list(obj) if isinstance(obj, list) else []
        j = i - 1 if i > 0 else len(lst) + i
        while len(lst) <= j:
            lst.append(None)
        lst[j] = nested_put(lst[j], rest, value)
        return lst
    m = dict(obj) if isinstance(obj, dict) else {}
    m[seg] = nested_put(m.get(seg), rest, value)
    return m
