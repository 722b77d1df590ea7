"""Authorization (ACL) sources evaluated in order behind `client.authorize`.

Parity: apps/emqx_authz — sources checked in order; each returns allow /
deny / nomatch (emqx_authz.erl authorize/5); `no_match` config decides the
terminal default; per-client decision cache (emqx_authz_cache.erl).

Rule format (FileSource) mirrors the reference's acl rules
(emqx_authz_rule.erl): permit allow|deny; who all | {username} |
{clientid} | {ipaddr CIDR}; action publish|subscribe|all; topics are
filters supporting %c/%u placeholders and {"eq": t} literal matching.

The port's copy of ``emqx_tpu/apps/authz.py``. The channel applies the
verdict (``authz.deny_action``: ignore or disconnect).
"""

from __future__ import annotations

import ipaddress
import time
from collections import OrderedDict
from typing import Awaitable, Callable, Optional

from emqx_tpu_torch.broker.hooks import HP_AUTHZ
from emqx_tpu_torch.utils import topic as T

ALLOW, DENY, NOMATCH = "allow", "deny", "nomatch"


class Rule:
    def __init__(self, permit: str, who="all", action: str = "all",
                 topics: Optional[list] = None):
        if permit not in (ALLOW, DENY):
            raise ValueError(f"bad permit {permit!r}")
        if action not in ("publish", "subscribe", "all"):
            raise ValueError(f"bad action {action!r}")
        self.permit = permit
        self.who = who
        self.action = action
        self.topics = topics if topics is not None else ["#"]

    def _who_match(self, clientinfo: dict) -> bool:
        w = self.who
        if w == "all":
            return True
        if isinstance(w, dict):
            if "username" in w:
                return clientinfo.get("username") == w["username"]
            if "clientid" in w:
                return clientinfo.get("clientid") == w["clientid"]
            if "ipaddr" in w:
                peer = clientinfo.get("peername")
                if not peer:
                    return False
                try:
                    return ipaddress.ip_address(peer[0]) in \
                        ipaddress.ip_network(w["ipaddr"], strict=False)
                except ValueError:
                    return False
            if "and" in w:
                return all(Rule(self.permit, sub)._who_match(clientinfo)
                           for sub in w["and"])
            if "or" in w:
                return any(Rule(self.permit, sub)._who_match(clientinfo)
                           for sub in w["or"])
        return False

    def _topic_match(self, clientinfo: dict, topic: str) -> bool:
        for t in self.topics:
            if isinstance(t, dict) and "eq" in t:
                if topic == t["eq"]:
                    return True
                continue
            filt = (t.replace("%c", clientinfo.get("clientid") or "")
                     .replace("%u", clientinfo.get("username") or ""))
            if T.match(topic, filt):
                return True
        return False

    def check(self, clientinfo: dict, action: str, topic: str) -> str:
        if self.action not in (action, "all"):
            return NOMATCH
        if not self._who_match(clientinfo):
            return NOMATCH
        if not self._topic_match(clientinfo, topic):
            return NOMATCH
        return self.permit


class FileSource:
    """Ordered static rules (the reference's acl.conf file source)."""

    name = "file"

    def __init__(self, rules: list):
        self.rules = [r if isinstance(r, Rule) else Rule(
            r.get("permit", "allow"), r.get("who", "all"),
            r.get("action", "all"), r.get("topics")) for r in rules]

    def authorize(self, clientinfo: dict, action: str, topic: str) -> str:
        for r in self.rules:
            v = r.check(clientinfo, action, topic)
            if v != NOMATCH:
                return v
        return NOMATCH


class ClientAclSource:
    """Per-client ACL granted by the authenticator (JWT acl claim —
    emqx_authn_jwt acl_claim_name)."""

    name = "client_acl"

    def authorize(self, clientinfo: dict, action: str, topic: str) -> str:
        acl = clientinfo.get("acl")
        if not acl:
            return NOMATCH
        key = {"publish": "pub", "subscribe": "sub"}[action]
        for filt in list(acl.get(key, [])) + list(acl.get("all", [])):
            f = (filt.replace("%c", clientinfo.get("clientid") or "")
                     .replace("%u", clientinfo.get("username") or ""))
            if T.match(topic, f):
                return ALLOW
        return DENY      # acl present but no grant → deny (reference)


class HTTPSource:
    """External HTTP ACL service (emqx_authz_http.erl)."""

    name = "http"

    def __init__(self, url: str, method: str = "post",
                 body: Optional[dict] = None,
                 headers: Optional[dict] = None, timeout: float = 5.0,
                 transport: Optional[Callable[..., Awaitable]] = None):
        self.url = url
        self.method = method
        self.body = body or {"username": "%u", "clientid": "%c",
                             "action": "%A", "topic": "%t"}
        self.headers = headers or {}
        self.timeout = timeout
        self._transport = transport

    async def authorize_async(self, clientinfo: dict, action: str,
                              topic: str) -> str:
        from emqx_tpu_torch.utils.http import templated_request
        peer = clientinfo.get("peername")
        subs = {"%u": clientinfo.get("username") or "",
                "%c": clientinfo.get("clientid") or "",
                "%A": action, "%t": topic,
                "%a": str(peer[0]) if peer else ""}
        try:
            resp = await templated_request(
                self.method, self.url, self.body, subs,
                headers=self.headers, timeout=self.timeout,
                transport=self._transport)
        except Exception:
            return NOMATCH
        if resp.status == 204:
            return ALLOW
        if resp.status != 200:
            return NOMATCH
        try:
            result = resp.json().get("result", "allow")
        except Exception:
            return ALLOW
        return {"allow": ALLOW, "deny": DENY}.get(result, NOMATCH)


class AuthzCache:
    """Per-client (action, topic) → decision LRU with TTL
    (emqx_authz_cache.erl / the authz_cache zone config)."""

    def __init__(self, max_size: int = 32, ttl: float = 60.0):
        self.max_size = max_size
        self.ttl = ttl
        self._c: "OrderedDict[tuple, tuple[str, float]]" = OrderedDict()

    def get(self, key: tuple) -> Optional[str]:
        ent = self._c.get(key)
        if ent is None:
            return None
        verdict, ts = ent
        if time.monotonic() - ts > self.ttl:
            del self._c[key]
            return None
        self._c.move_to_end(key)
        return verdict

    def put(self, key: tuple, verdict: str) -> None:
        if key in self._c:
            self._c.move_to_end(key)
        self._c[key] = (verdict, time.monotonic())
        while len(self._c) > self.max_size:
            self._c.popitem(last=False)

    def drain(self) -> None:
        self._c.clear()


class Authz:
    """The `client.authorize` hook: folds sources in order."""

    def __init__(self, node, sources: Optional[list] = None,
                 no_match: Optional[str] = None,
                 cache_enable: bool = True):
        self.node = node
        conf = node.config.get("authz") or {}
        self.no_match = no_match or conf.get("no_match", "allow")
        self.sources = list(sources or [])
        self.cache_enable = cache_enable
        self._caches: dict[str, AuthzCache] = {}

    def load(self) -> "Authz":
        self.node.hooks.add("client.authorize", self.on_authorize,
                            priority=HP_AUTHZ, tag="authz")
        # drain the per-client cache when its channel goes away, else the
        # cache dict grows one entry per clientid ever seen
        self.node.hooks.add("client.disconnected", self._on_disconnected,
                            tag="authz")
        return self

    def unload(self) -> None:
        self.node.hooks.delete("client.authorize", "authz")
        self.node.hooks.delete("client.disconnected", "authz")

    def _on_disconnected(self, clientinfo: dict, reason) -> None:
        self.drop_cache(clientinfo.get("clientid", ""))

    def add_source(self, s, front: bool = False) -> None:
        if front:
            self.sources.insert(0, s)
        else:
            self.sources.append(s)

    def _cache(self, clientid: str) -> AuthzCache:
        c = self._caches.get(clientid)
        if c is None:
            c = self._caches[clientid] = AuthzCache()
        return c

    def drop_cache(self, clientid: str) -> None:
        self._caches.pop(clientid, None)

    async def on_authorize(self, clientinfo: dict, action: str, topic: str,
                           acc):
        if not self.sources:
            return ("ok", acc)
        cid = clientinfo.get("clientid", "")
        cache = self._cache(cid) if self.cache_enable else None
        if cache is not None:
            hit = cache.get((action, topic))
            if hit is not None:
                self.node.metrics.inc("client.authorize.cache_hit")
                return ("stop", hit)
        verdict = self.no_match
        for s in self.sources:
            if hasattr(s, "authorize_async"):
                v = await s.authorize_async(clientinfo, action, topic)
            else:
                v = s.authorize(clientinfo, action, topic)
            if v != NOMATCH:
                verdict = v
                break
        if cache is not None:
            cache.put((action, topic), verdict)
        return ("stop", verdict)
