"""Rule-SQL function library.

Parity: emqx_rule_funcs.erl exports (arithmetic/math/bits/type/string/map/
array/hash/codec/date/kv groups). Functions operate on decoded column
values: str for binaries, int/float for numbers, dict for maps, list for
arrays, None for null/undefined. Missing args and type errors surface as
exceptions — the runtime counts them per rule ('failed.exception', as the
reference's metrics do).

The port's copy of ``emqx_tpu/rules/funcs.py``.
"""

from __future__ import annotations

import base64
import hashlib
import json
import math
import re
import time
from datetime import datetime, timezone
from typing import Any

# global kv store (emqx_rule_funcs kv_store_* — an ets table there)
_KV: dict[str, Any] = {}


def _num(x):
    if isinstance(x, bool):
        raise TypeError("boolean is not a number")
    if isinstance(x, (int, float)):
        return x
    if isinstance(x, str):
        return float(x) if "." in x else int(x)
    raise TypeError(f"not a number: {x!r}")


def _s(x) -> str:
    if isinstance(x, bytes):
        return x.decode("utf-8", "replace")
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, (dict, list)):
        return json.dumps(x, separators=(",", ":"))
    if x is None:
        return "undefined"
    return str(x)


def _b(x) -> bytes:
    if isinstance(x, bytes):
        return x
    return _s(x).encode()


# ---- arithmetic (str + str concatenates, mirroring '+'/2) ----
def f_add(a, b):
    if isinstance(a, (str, bytes)) and isinstance(b, (str, bytes)):
        return _s(a) + _s(b)
    return _num(a) + _num(b)


def f_sub(a, b):
    return _num(a) - _num(b)


def f_mul(a, b):
    return _num(a) * _num(b)


def f_div(a, b):
    return _num(a) / _num(b)


def f_intdiv(a, b):
    return int(_num(a)) // int(_num(b))


def f_mod(a, b):
    return int(_num(a)) % int(_num(b))


def f_eq(a, b):
    return a == b


# ---- date helpers ----
_UNITS = {"second": 1, "millisecond": 10**3, "microsecond": 10**6,
          "nanosecond": 10**9}


def _now_ts(unit: str = "second") -> int:
    return time.time_ns() * _UNITS[unit] // 10**9


def _ts_to_rfc3339(ts: int, unit: str = "second") -> str:
    secs = ts / _UNITS[unit]
    dt = datetime.fromtimestamp(secs, tz=timezone.utc)
    if unit == "second":
        return dt.strftime("%Y-%m-%dT%H:%M:%S+00:00")
    return dt.isoformat().replace("+00:00", "") + "+00:00" \
        if dt.tzinfo else dt.isoformat()


def _rfc3339_to_ts(s: str, unit: str = "second") -> int:
    dt = datetime.fromisoformat(_s(s).replace("Z", "+00:00"))
    return int(dt.timestamp() * _UNITS[unit])


def f_subbits(bits, *args):
    """subbits(Bytes, Len) | (Bytes, Start, Len) |
    (Bytes, Start, Len, Type, Signedness, Endianness); Start is 1-based."""
    data = _b(bits)
    val = int.from_bytes(data, "big")
    total = len(data) * 8
    if len(args) == 1:
        start, length = 1, int(args[0])
        ty, signed, endian = "integer", "unsigned", "big"
    elif len(args) == 2:
        start, length = int(args[0]), int(args[1])
        ty, signed, endian = "integer", "unsigned", "big"
    else:
        start, length = int(args[0]), int(args[1])
        ty, signed, endian = (_s(args[2]), _s(args[3]), _s(args[4]))
    if start < 1 or start - 1 + length > total:
        return None
    shift = total - (start - 1) - length
    chunk = (val >> shift) & ((1 << length) - 1)
    if ty == "float":
        import struct
        nbytes = length // 8
        fmt = {4: "f", 8: "d"}[nbytes]
        bo = ">" if endian == "big" else "<"
        # chunk IS the wire bytes read big-endian; endianness applies only
        # to how those wire bytes are interpreted
        return struct.unpack(bo + fmt, chunk.to_bytes(nbytes, "big"))[0]
    if endian == "little":
        nbytes = (length + 7) // 8
        chunk = int.from_bytes(chunk.to_bytes(nbytes, "big"), "little")
    if signed == "signed" and chunk >= (1 << (length - 1)):
        chunk -= 1 << length
    return chunk


def _pad(s, length, side="trailing", char=" "):
    s, length, char = _s(s), int(length), _s(char)
    fill = char * max(0, length - len(s))
    # multi-char fills are truncated to exactly reach length (string:pad)
    fill = fill[:max(0, length - len(s))]
    if side == "leading":
        return fill + s
    if side == "both":
        half = (length - len(s))
        left = (char * length)[:half // 2]
        right = (char * length)[:half - half // 2]
        return left + s + right
    return s + fill


def _split(s, sep=None, where=None):
    s = _s(s)
    if sep is None:
        return [t for t in s.split() if t]
    sep = _s(sep)
    if where == "leading":
        parts = s.split(sep, 1)
        return parts if len(parts) > 1 else [s]
    if where == "trailing":
        parts = s.rsplit(sep, 1)
        return parts if len(parts) > 1 else [s]
    return [t for t in s.split(sep) if t != ""]


def _nested_get_path(path_str, m, default=None):
    # arg order per map_get(Key, Map[, Default])
    from emqx_tpu_torch.rules.maps import nested_get, parse_path
    return nested_get(m, parse_path(_s(path_str)), default)


def _nested_put_path(path_str, val, m):
    from emqx_tpu_torch.rules.maps import nested_put, parse_path
    return nested_put(dict(m if isinstance(m, dict) else {}),
                      parse_path(_s(path_str)), val)


def _sprintf(fmt, *args):
    """sprintf_s with Erlang io_lib ~s/~p/~w/~b controls."""
    out, i, ai = [], 0, 0
    fmt = _s(fmt)
    while i < len(fmt):
        c = fmt[i]
        if c == "~" and i + 1 < len(fmt):
            ctl = fmt[i + 1]
            if ctl in "spwb":
                out.append(_s(args[ai]) if ctl in "sb"
                           else json.dumps(args[ai], default=repr))
                ai += 1
                i += 2
                continue
            if ctl == "n":
                out.append("\n")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


FUNCS: dict[str, Any] = {
    # arithmetic
    "+": f_add, "-": f_sub, "*": f_mul, "/": f_div,
    "div": f_intdiv, "mod": f_mod, "eq": f_eq,
    # math
    "abs": lambda x: abs(_num(x)),
    "acos": lambda x: math.acos(_num(x)),
    "acosh": lambda x: math.acosh(_num(x)),
    "asin": lambda x: math.asin(_num(x)),
    "asinh": lambda x: math.asinh(_num(x)),
    "atan": lambda x: math.atan(_num(x)),
    "atanh": lambda x: math.atanh(_num(x)),
    "ceil": lambda x: math.ceil(_num(x)),
    "cos": lambda x: math.cos(_num(x)),
    "cosh": lambda x: math.cosh(_num(x)),
    "exp": lambda x: math.exp(_num(x)),
    "floor": lambda x: math.floor(_num(x)),
    "fmod": lambda x, y: math.fmod(_num(x), _num(y)),
    "log": lambda x: math.log(_num(x)),
    "log10": lambda x: math.log10(_num(x)),
    "log2": lambda x: math.log2(_num(x)),
    "power": lambda x, y: math.pow(_num(x), _num(y)),
    "round": lambda x: round(_num(x)),
    "sin": lambda x: math.sin(_num(x)),
    "sinh": lambda x: math.sinh(_num(x)),
    "sqrt": lambda x: math.sqrt(_num(x)),
    "tan": lambda x: math.tan(_num(x)),
    "tanh": lambda x: math.tanh(_num(x)),
    # bits
    "bitnot": lambda x: ~int(_num(x)),
    "bitand": lambda a, b: int(_num(a)) & int(_num(b)),
    "bitor": lambda a, b: int(_num(a)) | int(_num(b)),
    "bitxor": lambda a, b: int(_num(a)) ^ int(_num(b)),
    "bitsl": lambda a, n: int(_num(a)) << int(_num(n)),
    "bitsr": lambda a, n: int(_num(a)) >> int(_num(n)),
    "bitsize": lambda b: len(_b(b)) * 8,
    "byteside": lambda b: len(_b(b)),
    "bytesize": lambda b: len(_b(b)),
    "subbits": f_subbits,
    # type conversion
    "str": _s,
    "str_utf8": _s,
    "bool": lambda x: {"true": True, "false": False, True: True,
                       False: False, 1: True, 0: False}[
                           x if isinstance(x, (bool, int)) else _s(x)],
    "int": lambda x: int(float(x)) if isinstance(x, str) and "." in x
        else (1 if x is True else 0 if x is False else int(x)),
    "float": lambda x: float(_num(x)),
    "map": lambda x: x if isinstance(x, dict) else json.loads(_s(x)),
    "bin2hexstr": lambda b: _b(b).hex().upper(),
    "hexstr2bin": lambda s: bytes.fromhex(_s(s)),
    # type validation
    "is_null": lambda x: x is None,
    "is_not_null": lambda x: x is not None,
    "is_str": lambda x: isinstance(x, str),
    "is_bool": lambda x: isinstance(x, bool),
    "is_int": lambda x: isinstance(x, int) and not isinstance(x, bool),
    "is_float": lambda x: isinstance(x, float),
    "is_num": lambda x: isinstance(x, (int, float))
        and not isinstance(x, bool),
    "is_map": lambda x: isinstance(x, dict),
    "is_array": lambda x: isinstance(x, list),
    # strings
    "lower": lambda s: _s(s).lower(),
    "upper": lambda s: _s(s).upper(),
    "trim": lambda s: _s(s).strip(),
    "ltrim": lambda s: _s(s).lstrip(),
    "rtrim": lambda s: _s(s).rstrip(),
    "reverse": lambda s: _s(s)[::-1],
    "strlen": lambda s: len(_s(s)),
    "substr": lambda s, start, length=None: (
        _s(s)[int(start):] if length is None
        else _s(s)[int(start):int(start) + int(length)]),
    "split": _split,
    "tokens": lambda s, seps, opt=None: (
        [t for t in re.split("|".join(re.escape(c) for c in _s(seps)),
                             _s(s).replace("\n", "" if opt == "nocrlf"
                                           else "\n")
                             .replace("\r", "" if opt == "nocrlf" else "\r"))
         if t]),
    "concat": lambda a, b: _s(a) + _s(b),
    "sprintf_s": _sprintf,
    "pad": _pad,
    "replace": lambda s, p, r, where=None: (
        _s(s).replace(_s(p), _s(r)) if where in (None, "all")
        else _s(s).replace(_s(p), _s(r), 1) if where == "leading"
        else _s(r).join(_s(s).rsplit(_s(p), 1))),
    "regex_match": lambda s, rx: bool(re.search(_s(rx), _s(s))),
    "regex_replace": lambda s, rx, r: re.sub(_s(rx), _s(r), _s(s)),
    "ascii": lambda c: ord(_s(c)[0]),
    "find": lambda s, sub, where=None: (
        (lambda st, sb: st[st.rfind(sb):] if where == "trailing"
         and sb in st else st[st.find(sb):] if sb in st else "")(
             _s(s), _s(sub))),
    # maps
    "map_new": lambda: {},
    "map_get": _nested_get_path,
    "map_put": _nested_put_path,
    "mget": _nested_get_path,
    "mput": _nested_put_path,
    # arrays (nth is 1-based like lists:nth)
    "nth": lambda n, lst: lst[int(n) - 1] if 0 < int(n) <= len(lst)
        else None,
    "length": lambda lst: len(lst),
    "sublist": lambda *a: (a[1][:int(a[0])] if len(a) == 2
                           else a[2][int(a[0]) - 1:int(a[0]) - 1 + int(a[1])]),
    "first": lambda lst: lst[0] if lst else None,
    "last": lambda lst: lst[-1] if lst else None,
    "contains": lambda x, lst: x in lst,
    # hashes (hex strings like emqx_misc:bin_to_hexstr)
    "md5": lambda x: hashlib.md5(_b(x)).hexdigest(),
    "sha": lambda x: hashlib.sha1(_b(x)).hexdigest(),
    "sha256": lambda x: hashlib.sha256(_b(x)).hexdigest(),
    # encode/decode
    "base64_encode": lambda x: base64.b64encode(_b(x)).decode(),
    "base64_decode": lambda x: base64.b64decode(_b(x)),
    "json_encode": lambda x: json.dumps(x, default=_s,
                                        separators=(",", ":")),
    "json_decode": lambda x: json.loads(_s(x)),
    "term_encode": lambda x: base64.b64encode(
        json.dumps(x, default=_s).encode()).decode(),
    "term_decode": lambda x: json.loads(base64.b64decode(_b(x))),
    # dates
    "now_rfc3339": lambda unit="second": _ts_to_rfc3339(_now_ts(_s(unit)),
                                                        _s(unit)),
    "unix_ts_to_rfc3339": lambda ts, unit="second":
        _ts_to_rfc3339(int(ts), _s(unit)),
    "rfc3339_to_unix_ts": lambda s, unit="second":
        _rfc3339_to_ts(s, _s(unit)),
    "now_timestamp": lambda unit="second": _now_ts(_s(unit)),
    "timezone_to_second": lambda tz: _tz_seconds(tz),
    # kv / "proc dict" (rule-engine-global kv table)
    "proc_dict_get": lambda k: _KV.get(_s(k)),
    "proc_dict_put": lambda k, v: _KV.__setitem__(_s(k), v),
    "proc_dict_del": lambda k: _KV.pop(_s(k), None) and None,
    "kv_store_get": lambda k, d=None: _KV.get(_s(k), d),
    "kv_store_put": lambda k, v: (_KV.__setitem__(_s(k), v), v)[1],
    "kv_store_del": lambda k: _KV.pop(_s(k), None) and None,
    "null": lambda: None,
    # topic-filter membership (emqx_rule_funcs contains_topic/2,3 +
    # contains_topic_match/2,3): first arg is a topic-filter array —
    # either plain strings or {"topic": ..., "qos": ...} maps
    "contains_topic": lambda fs, t, qos=None:
        _find_topic_filter(fs, t, False, qos),
    "contains_topic_match": lambda fs, t, qos=None:
        _find_topic_filter(fs, t, True, qos),
}

# message-column accessor functions (emqx_rule_funcs qos/1, topic/1,
# payload/1, clientid/1, username/1, clientip/peerhost/1, msgid/1,
# flags/1, flag/2): zero-arg in SQL — the runtime resolves them from the
# event columns in scope (see rules/runtime.py eval_expr 'call')
COLUMN_FUNCS: dict[str, str] = {
    "clientid": "clientid", "username": "username", "topic": "topic",
    "payload": "payload", "qos": "qos", "clientip": "peerhost",
    "peerhost": "peerhost", "msgid": "id", "flags": "flags",
}


def _find_topic_filter(filters, topic, wildcard: bool, qos=None) -> bool:
    from emqx_tpu_torch.utils import topic as T
    t = _s(topic)
    for f in filters or []:
        if isinstance(f, dict):
            filt, fqos = _s(f.get("topic")), f.get("qos")
        else:
            filt, fqos = _s(f), None
        hit = T.match(t, filt) if wildcard else filt == t
        if hit and (qos is None or fqos == qos):
            return True
    return False


def _tz_seconds(tz) -> int:
    s = _s(tz)
    if s in ("Z", "z", "local"):
        return 0
    sign = -1 if s[0] == "-" else 1
    hh, _, mm = s.lstrip("+-").partition(":")
    return sign * (int(hh) * 3600 + int(mm or 0))


def call(name: str, args: list) -> Any:
    fn = FUNCS.get(name)
    if fn is None:
        raise NameError(f"unknown sql function {name!r}")
    return fn(*args)
