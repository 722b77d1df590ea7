"""HOCON-lite: the configuration file format loader.

The port's copy of ``emqx_tpu/utils/hocon.py``. The reference boots from
HOCON files through the hocon dep (emqx_config:init_load,
apps/emqx/src/emqx_config.erl:20-27; emqx_machine_app load_config_files).
This implements the HOCON subset those files use:

- objects `{}` (root braces optional), arrays `[]`
- `k = v`, `k: v`, `k { ... }`, dotted path keys `a.b.c = v`
- `k += v` array append
- duplicate object keys deep-merge; later scalars win
- comments `#` / `//`, trailing commas, newline-separated values
- quoted / triple-quoted / unquoted strings, numbers, bool, null
- durations ("10s", "2m", "1h", "1d", "100ms") and byte sizes
  ("16KB", "1MB") via coercion helpers used by the schema check
- `include "relative/path.conf"`
- substitutions `${a.b.c}` (from the document root) and optional
  `${?NAME}` (document root, then environment, else dropped)

`loads`/`load` produce plain dicts; `dumps` renders a dict back (used to
persist runtime overrides, the emqx_override.conf analog).
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional


class HoconError(ValueError):
    pass


_DURATION_RE = re.compile(
    r"^(\d+(?:\.\d+)?)(ms|s|m|h|d|w)$")
_SIZE_RE = re.compile(r"^(\d+(?:\.\d+)?)(kb|mb|gb|b)$", re.IGNORECASE)
_DURATION_UNITS = {"ms": 0.001, "s": 1, "m": 60, "h": 3600, "d": 86400,
                   "w": 604800}
_SIZE_UNITS = {"b": 1, "kb": 1024, "mb": 1024 ** 2, "gb": 1024 ** 3}


def parse_duration(s: str) -> Optional[float]:
    """"30s" -> 30.0; "100ms" -> 0.1; None when not a duration string."""
    m = _DURATION_RE.match(s.strip())
    if not m:
        return None
    val = float(m.group(1)) * _DURATION_UNITS[m.group(2)]
    return val


def parse_size(s: str) -> Optional[int]:
    """"16KB" -> 16384; None when not a size string."""
    m = _SIZE_RE.match(s.strip())
    if not m:
        return None
    return int(float(m.group(1)) * _SIZE_UNITS[m.group(2).lower()])


class _Sub:
    """Unresolved ${path} marker."""

    __slots__ = ("path", "optional")

    def __init__(self, path: str, optional: bool):
        self.path = path
        self.optional = optional


class _Parser:
    def __init__(self, text: str, basedir: str = "."):
        self.s = text
        self.n = len(text)
        self.i = 0
        self.basedir = basedir

    # ---- low-level ----
    def _err(self, msg: str) -> HoconError:
        line = self.s.count("\n", 0, self.i) + 1
        return HoconError(f"line {line}: {msg}")

    def _peek(self) -> str:
        return self.s[self.i] if self.i < self.n else ""

    def _skip_ws(self, newlines: bool = True) -> None:
        while self.i < self.n:
            c = self.s[self.i]
            if c == "#" or self.s[self.i:self.i + 2] == "//":
                while self.i < self.n and self.s[self.i] != "\n":
                    self.i += 1
            elif c in " \t\r" or (newlines and c == "\n"):
                self.i += 1
            else:
                break

    # ---- tokens ----
    def _quoted(self) -> str:
        if self.s.startswith('"""', self.i):
            end = self.s.find('"""', self.i + 3)
            if end < 0:
                raise self._err("unterminated triple-quoted string")
            out = self.s[self.i + 3:end]
            self.i = end + 3
            return out
        assert self.s[self.i] == '"'
        self.i += 1
        out = []
        while self.i < self.n:
            c = self.s[self.i]
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                self.i += 1
                esc = self.s[self.i]
                out.append({"n": "\n", "t": "\t", "r": "\r", '"': '"',
                            "\\": "\\", "/": "/"}.get(esc, esc))
                self.i += 1
            else:
                out.append(c)
                self.i += 1
        raise self._err("unterminated string")

    def _key(self) -> str:
        self._skip_ws()
        if self._peek() == '"':
            return self._quoted()
        start = self.i
        while self.i < self.n and self.s[self.i] not in " \t\n=:{+":
            self.i += 1
        key = self.s[start:self.i].strip()
        if not key:
            raise self._err("expected a key")
        return key

    def _unquoted_value(self, stop_extra: str) -> Any:
        start = self.i
        while self.i < self.n:
            c = self.s[self.i]
            if c in "\n#" + stop_extra or self.s[self.i:self.i + 2] == "//":
                break
            self.i += 1
        raw = self.s[start:self.i].strip()
        return _coerce_scalar(raw, self._err)

    # ---- values ----
    def _value(self, stop_extra: str = "") -> Any:
        self._skip_ws(newlines=False)
        c = self._peek()
        if c == "{":
            return self._object()
        if c == "[":
            return self._array()
        if c == '"':
            s = self._quoted()
            # adjacent-string concatenation is rare in emqx confs; a quoted
            # string is the whole value
            return s
        if self.s.startswith("${", self.i):
            end = self.s.index("}", self.i)
            inner = self.s[self.i + 2:end]
            self.i = end + 1
            optional = inner.startswith("?")
            return _Sub(inner[1:] if optional else inner, optional)
        return self._unquoted_value(stop_extra)

    def _array(self) -> list:
        assert self._peek() == "["
        self.i += 1
        out: list = []
        while True:
            self._skip_ws()
            if self._peek() == "":
                raise self._err("unterminated array")
            if self._peek() == "]":
                self.i += 1
                return out
            out.append(self._value(stop_extra=",]"))
            self._skip_ws(newlines=False)
            if self._peek() == ",":
                self.i += 1

    def _object(self, root: bool = False) -> dict:
        if not root:
            assert self._peek() == "{"
            self.i += 1
        out: dict = {}
        while True:
            self._skip_ws()
            c = self._peek()
            if c == "":
                if root:
                    return out
                raise self._err("unterminated object")
            if c == "}":
                if root:
                    raise self._err("unexpected '}'")
                self.i += 1
                return out
            if c == ",":
                self.i += 1
                continue
            # include statement
            if self.s.startswith("include", self.i) and \
                    self.s[self.i + 7:self.i + 8] in (" ", "\t", '"'):
                self.i += 7
                self._skip_ws(newlines=False)
                if self._peek() != '"':
                    raise self._err("include expects a quoted path")
                rel = self._quoted()
                path = os.path.join(self.basedir, rel)
                with open(path, "r", encoding="utf-8") as f:
                    sub = _Parser(f.read(),
                                  os.path.dirname(path) or ".")._object(
                                      root=True)
                _merge_into(out, sub)
                continue
            key = self._key()
            self._skip_ws(newlines=False)
            append = False
            if self.s.startswith("+=", self.i):
                append = True
                self.i += 2
            elif self._peek() in "=:":
                self.i += 1
            elif self._peek() != "{":
                raise self._err(f"expected '=', ':' or '{{' after {key!r}")
            val = self._value(stop_extra=",}")
            _assign(out, key.split("."), val, append, self._err)


def _coerce_scalar(raw: str, err) -> Any:
    if raw == "":
        raise err("empty value")
    low = raw.lower()
    if low in ("true", "on", "yes"):
        return True
    if low in ("false", "off", "no"):
        return False
    if low == "null":
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def _assign(obj: dict, path: list[str], val: Any, append: bool,
            err) -> None:
    cur = obj
    for p in path[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = cur[p] = {}
        cur = nxt
    leaf = path[-1]
    if append:
        existing = cur.get(leaf)
        if existing is None:
            cur[leaf] = [val]
        elif isinstance(existing, list):
            existing.append(val)
        else:
            raise err(f"cannot += into non-array key {leaf!r}")
    elif isinstance(val, dict) and isinstance(cur.get(leaf), dict):
        _merge_into(cur[leaf], val)
    else:
        cur[leaf] = val


def _merge_into(base: dict, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge_into(base[k], v)
        else:
            base[k] = v


def _lookup(root: dict, path: str) -> Any:
    cur: Any = root
    for p in path.split("."):
        if not isinstance(cur, dict) or p not in cur:
            raise KeyError(path)
        cur = cur[p]
    return cur


def _resolve(node: Any, root: dict) -> Any:
    if isinstance(node, _Sub):
        try:
            val = _lookup(root, node.path)
            return _resolve(val, root) if isinstance(val, (_Sub, dict, list)) \
                else val
        except KeyError:
            env = os.environ.get(node.path)
            if env is not None:
                return _coerce_scalar(env, HoconError)
            if node.optional:
                return None
            raise HoconError(f"unresolved substitution ${{{node.path}}}")
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            rv = _resolve(v, root)
            if not (isinstance(v, _Sub) and v.optional and rv is None):
                out[k] = rv
        return out
    if isinstance(node, list):
        return [_resolve(v, root) for v in node
                if not (isinstance(v, _Sub) and v.optional
                        and _try_resolve(v, root) is None)]
    return node


def _try_resolve(sub: _Sub, root: dict):
    try:
        return _resolve(sub, root)
    except HoconError:
        return None


def loads(text: str, basedir: str = ".") -> dict:
    raw = _Parser(text, basedir)._object(root=True)
    return _resolve(raw, raw)


def load(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read(), os.path.dirname(path) or ".")


# ---------------------------------------------------------------------------
# rendering (override persistence)
# ---------------------------------------------------------------------------

_BARE_RE = re.compile(r"^[A-Za-z0-9_\-]+$")


def _render(val: Any, indent: int) -> str:
    pad = "  " * indent
    if isinstance(val, dict):
        if not val:
            return "{}"
        inner = "".join(
            f"{pad}  {_render_key(k)} = {_render(v, indent + 1)}\n"
            for k, v in val.items())
        return "{\n" + inner + pad + "}"
    if isinstance(val, list):
        return "[" + ", ".join(_render(v, indent) for v in val) + "]"
    if isinstance(val, bool):
        return "true" if val else "false"
    if val is None:
        return "null"
    if isinstance(val, (int, float)):
        return str(val)
    s = str(val)
    # only render bare if the parser would read the SAME string back:
    # "0", "true", "off" etc. coerce to typed values on load, which would
    # silently change a string's type across an override persist/reload
    # cycle (found by the dumps→loads property test)
    if _BARE_RE.match(s) and isinstance(_coerce_scalar(s, HoconError), str):
        return s
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _render_key(k: str) -> str:
    return k if _BARE_RE.match(k) else '"' + k + '"'


def dumps(conf: dict) -> str:
    return "".join(f"{_render_key(k)} = {_render(v, 0)}\n"
                   for k, v in conf.items())
