"""Topic algebra: tokenize, validate, wildcard-match, $share/$queue parsing.

A copy of the parts of ``emqx_tpu/utils/topic.py`` the port needs (the
port imports nothing from ``emqx_tpu``). Pure functions; ``match`` is the
host oracle and the host fallback of ``engine.RouteEngine``; ``levels``,
``prepend`` and ``feed_var`` serve the broker channel.

Semantics (emqx_topic.erl): levels split on ``/`` and empty levels are
real; ``+`` matches exactly one level, ``#`` the remaining levels
including zero; a topic NAME whose first byte is ``$`` never matches a
filter whose first byte is ``+`` or ``#``.
"""

from __future__ import annotations

from typing import Iterable, Optional

MAX_TOPIC_LEN = 65535

PLUS = "+"
HASH = "#"
SHARE_PREFIX = "$share/"
QUEUE_PREFIX = "$queue/"


class TopicError(ValueError):
    """Invalid topic name or filter. `.code` mirrors the reference's error atoms."""

    def __init__(self, code: str, topic: str = ""):
        super().__init__(f"{code}: {topic!r}" if topic else code)
        self.code = code
        self.topic = topic


def tokens(topic: str) -> list[str]:
    """Split a topic into levels on '/'. '' yields ['']."""
    return topic.split("/")


def wildcard(topic: "str | Iterable[str]") -> bool:
    """Does the topic filter contain '+' or '#' as a whole level?"""
    ws = tokens(topic) if isinstance(topic, str) else topic
    return any(w == PLUS or w == HASH for w in ws)


def match(name: "str | list[str]", filt: "str | list[str]") -> bool:
    """Match a topic *name* against a topic *filter*.

    Accepts strings or pre-split word lists. The `$`-exclusion rule applies
    only when both are strings (root-level check on the raw first byte).
    """
    if isinstance(name, str) and isinstance(filt, str):
        if name[:1] == "$" and filt[:1] in (PLUS, HASH):
            return False
        return match_words(tokens(name), tokens(filt))
    n = tokens(name) if isinstance(name, str) else name
    f = tokens(filt) if isinstance(filt, str) else filt
    return match_words(n, f)


def match_words(n: list[str], f: list[str]) -> bool:
    """Word-level match; no `$` special-casing (caller's concern)."""
    i, j, ln, lf = 0, 0, len(n), len(f)
    while True:
        if j >= lf:
            return i >= ln
        fw = f[j]
        if fw == HASH:
            # '#' must be last in a valid filter; matches any tail incl. empty
            return True
        if i >= ln:
            return False
        if fw == PLUS or n[i] == fw:
            i += 1
            j += 1
        else:
            return False


def validate(topic: str, kind: str = "filter") -> bool:
    """Validate a topic filter or name; raises TopicError, returns True.

    kind: 'filter' (wildcards allowed) or 'name' (no wildcards).
    """
    if kind not in ("filter", "name"):
        raise ValueError(f"kind must be 'filter' or 'name', got {kind!r}")
    if topic == "":
        raise TopicError("empty_topic")
    if len(topic.encode("utf-8")) > MAX_TOPIC_LEN:
        raise TopicError("topic_too_long", topic)
    ws = tokens(topic)
    last = len(ws) - 1
    for i, w in enumerate(ws):
        if w == HASH:
            if i != last:
                raise TopicError("topic_invalid_#", topic)
        elif w != PLUS and w != "" \
                and any(c in ("#", "+", "\x00") for c in w):
            raise TopicError("topic_invalid_char", topic)
    if kind == "name" and wildcard(ws):
        raise TopicError("topic_name_error", topic)
    return True


def parse(topic_filter: str, options: Optional[dict] = None) -> tuple[str, dict]:
    """Strip `$share/<group>/` / `$queue/` prefixes → (real_filter, options).

    options gains {'share': <group>} for shared subscriptions ('$queue' group
    for the $queue form). Nested share prefixes are invalid.
    """
    options = dict(options or {})
    if topic_filter.startswith(QUEUE_PREFIX):
        if "share" in options:
            raise TopicError("invalid_topic_filter", topic_filter)
        return parse(topic_filter[len(QUEUE_PREFIX):], {**options, "share": "$queue"})
    if topic_filter.startswith(SHARE_PREFIX):
        if "share" in options:
            raise TopicError("invalid_topic_filter", topic_filter)
        rest = topic_filter[len(SHARE_PREFIX):]
        group, sep, filt = rest.partition("/")
        if not sep:
            raise TopicError("invalid_topic_filter", topic_filter)
        if "+" in group or "#" in group:
            raise TopicError("invalid_topic_filter", topic_filter)
        return parse(filt, {**options, "share": group})
    return topic_filter, options


def levels(topic: str) -> int:
    return len(tokens(topic))


def join(ws: Iterable[str]) -> str:
    return "/".join(ws)


def prepend(prefix: Optional[str], topic: str) -> str:
    """Prepend a mountpoint prefix, ensuring exactly one '/' between parts."""
    if not prefix:
        return topic
    if prefix.endswith("/"):
        return prefix + topic
    return prefix + "/" + topic


def feed_var(var: str, val: str, topic: str) -> str:
    """Replace each whole level equal to `var` (e.g. '%c') with `val`."""
    return join(val if w == var else w for w in tokens(topic))
