"""Rule-SQL parser.

Parity: emqx_rule_sqlparser.erl + the rulesql dep grammar. Supported:

  SELECT <field> [, <field>]* FROM "topic" [, "topic"]* [WHERE <cond>]
  FOREACH <expr> [AS <var>] [DO <field>,...] [INCASE <cond>]
      FROM "topic"[,...] [WHERE <cond>]

Fields: `*`, expressions with `AS` aliases (dotted aliases build nested
maps). Expressions: literals, dotted/indexed vars (`payload.data[1].x`,
1-based like nth/2), function calls, arithmetic (+ - * / div mod), string
comparison and `=`/`<>`/`!=`/`>=`/`<=`/`>`/`<`/`=~`, and/or/not,
CASE WHEN ... THEN ... [ELSE ...] END, parentheses.

AST is plain tuples so compiled rules are picklable/printable:
  ('lit', v) ('var', [seg|('idx', expr)...]) ('call', name, [args])
  ('bin', op, l, r) ('neg', e) ('not', e) ('and', l, r) ('or', l, r)
  ('case', [(when, then)...], else|None) ('*',)

The port's copy of ``emqx_tpu/rules/sqlparser.py``.
"""

from __future__ import annotations

import re
from typing import Any, Optional

KEYWORDS = {"select", "from", "where", "foreach", "do", "incase", "as",
            "case", "when", "then", "else", "end", "and", "or", "not",
            "true", "false", "null", "div", "mod"}

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+|\d+)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<name>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<op><>|!=|>=|<=|=~|[=<>+\-*/%(),.\[\]])
""", re.VERBOSE)


class SqlError(Exception):
    pass


def _tokenize(sql: str) -> list[tuple[str, str]]:
    out = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SqlError(f"bad token at: {sql[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "name" and text.lower() in KEYWORDS:
            out.append(("kw", text.lower()))
        else:
            out.append((kind, text))
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, sql: str):
        self.toks = _tokenize(sql)
        self.pos = 0

    def peek(self):
        return self.toks[self.pos]

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def accept(self, kind: str, text: Optional[str] = None) -> bool:
        k, v = self.peek()
        if k == kind and (text is None or v == text):
            self.pos += 1
            return True
        return False

    def expect(self, kind: str, text: Optional[str] = None) -> str:
        k, v = self.next()
        if k != kind or (text is not None and v != text):
            raise SqlError(f"expected {text or kind}, got {v!r}")
        return v

    # ---- statement ----
    def parse(self) -> dict:
        k, v = self.peek()
        if k == "kw" and v == "select":
            return self._select()
        if k == "kw" and v == "foreach":
            return self._foreach()
        raise SqlError("statement must start with SELECT or FOREACH")

    def _select(self) -> dict:
        self.expect("kw", "select")
        fields = self._fields()
        topics = self._from()
        cond = self._where()
        self.expect("eof")
        return {"type": "select", "fields": fields, "from": topics,
                "where": cond}

    def _foreach(self) -> dict:
        self.expect("kw", "foreach")
        expr = self._expr()
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("name")
        do_fields = None
        if self.accept("kw", "do"):
            do_fields = self._fields()
        incase = None
        if self.accept("kw", "incase"):
            incase = self._expr()
        topics = self._from()
        cond = self._where()
        self.expect("eof")
        return {"type": "foreach", "foreach": expr, "alias": alias,
                "do": do_fields, "incase": incase, "from": topics,
                "where": cond}

    def _fields(self) -> list[tuple[Any, Optional[list[str]]]]:
        fields = [self._field()]
        while self.accept("op", ","):
            fields.append(self._field())
        return fields

    def _field(self):
        if self.accept("op", "*"):
            return (("*",), None)
        expr = self._expr()
        alias = None
        if self.accept("kw", "as"):
            alias = [self.expect("name")]
            while self.accept("op", "."):
                alias.append(self.expect("name"))
        return (expr, alias)

    def _from(self) -> list[str]:
        self.expect("kw", "from")
        topics = [self._topic()]
        while self.accept("op", ","):
            topics.append(self._topic())
        return topics

    def _topic(self) -> str:
        k, v = self.next()
        if k != "str":
            raise SqlError(f"FROM expects a quoted topic, got {v!r}")
        return _unquote(v)

    def _where(self):
        if self.accept("kw", "where"):
            return self._expr()
        return None

    # ---- expressions (precedence climbing) ----
    def _expr(self):
        return self._or()

    def _or(self):
        left = self._and()
        while self.accept("kw", "or"):
            left = ("or", left, self._and())
        return left

    def _and(self):
        left = self._not()
        while self.accept("kw", "and"):
            left = ("and", left, self._not())
        return left

    def _not(self):
        if self.accept("kw", "not"):
            return ("not", self._not())
        return self._cmp()

    def _cmp(self):
        left = self._add()
        k, v = self.peek()
        if k == "op" and v in ("=", "<>", "!=", ">", "<", ">=", "<=", "=~"):
            self.next()
            return ("bin", v, left, self._add())
        return left

    def _add(self):
        left = self._mul()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                left = ("bin", v, left, self._mul())
            else:
                return left

    def _mul(self):
        left = self._unary()
        while True:
            k, v = self.peek()
            if (k == "op" and v in ("*", "/", "%")) or \
                    (k == "kw" and v in ("div", "mod")):
                self.next()
                left = ("bin", v, left, self._unary())
            else:
                return left

    def _unary(self):
        if self.accept("op", "-"):
            return ("neg", self._unary())
        return self._primary()

    def _primary(self):
        k, v = self.peek()
        if k == "num":
            self.next()
            return ("lit", float(v) if "." in v else int(v))
        if k == "str":
            self.next()
            return ("lit", _unquote(v))
        if k == "kw":
            if v in ("true", "false"):
                self.next()
                return ("lit", v == "true")
            if v == "null":
                self.next()
                return ("lit", None)
            if v == "case":
                return self._case()
            raise SqlError(f"unexpected keyword {v!r}")
        if k == "op" and v == "(":
            self.next()
            e = self._expr()
            self.expect("op", ")")
            return e
        if k == "name":
            self.next()
            if self.accept("op", "("):
                args = []
                if not self.accept("op", ")"):
                    args.append(self._expr())
                    while self.accept("op", ","):
                        args.append(self._expr())
                    self.expect("op", ")")
                return ("call", v.lower(), args)
            return ("var", self._path(v))
        raise SqlError(f"unexpected token {v!r}")

    def _case(self):
        self.expect("kw", "case")
        whens = []
        while self.accept("kw", "when"):
            cond = self._expr()
            self.expect("kw", "then")
            whens.append((cond, self._expr()))
        if not whens:
            raise SqlError("CASE needs at least one WHEN")
        els = self._expr() if self.accept("kw", "else") else None
        self.expect("kw", "end")
        return ("case", whens, els)

    def _path(self, head: str) -> list:
        segs: list = [head]
        while True:
            if self.accept("op", "."):
                segs.append(self.expect("name"))
            elif self.accept("op", "["):
                segs.append(("idx", self._expr()))
                self.expect("op", "]")
            else:
                return segs


def _unquote(s: str) -> str:
    body = s[1:-1]
    return re.sub(r"\\(.)", r"\1", body)


def parse_sql(sql: str) -> dict:
    """Parse one rule-SQL statement into its AST dict."""
    return _Parser(sql).parse()
