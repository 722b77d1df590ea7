"""Authentication chain: ordered authenticators behind `client.authenticate`.

Parity: apps/emqx_authn — a per-node chain of authenticators evaluated in
order (emqx_authn.erl authenticate/2): each returns `ok` (accept, possibly
with is_superuser/mountpoint), `deny`, or `ignore` (fall through). If the
chain is enabled and every authenticator ignores, the client is denied
(the reference's terminal `{error, not_authorized}`).

Authenticators:
- `BuiltinDB`  — username/clientid + hashed password store
  (simple_authn/emqx_authn_mnesia.erl)
- `JWTAuthenticator` — HS256/384/512 JWT in the password field with claim
  checks (emqx_authn_jwt.erl)
- `HTTPAuthenticator` — POST/GET to an external service
  (emqx_authn_http.erl); async transport is injectable for tests

The port's copy of ``emqx_tpu/apps/authn.py``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac as _hmac
import json
import time
from typing import Awaitable, Callable, Optional

from emqx_tpu_torch.broker.hooks import HP_AUTHN
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.utils import passwd as PW

OK, IGNORE, DENY = "ok", "ignore", "deny"


class BuiltinDB:
    """Username(or clientid)/password store with per-user salt.

    Parity: emqx_authn_mnesia.erl — user_id_type username|clientid,
    password_hash_algorithm, add/delete/update/lookup user API.
    """

    name = "password_based:built_in_database"

    def __init__(self, user_id_type: str = "username",
                 algorithm: str = "sha256",
                 salt_position: str = "prefix"):
        self.user_id_type = user_id_type
        self.algorithm = algorithm
        self.salt_position = salt_position
        self._users: dict[str, dict] = {}

    # ---- user management (emqx_authn_mnesia add_user/...) ----
    def add_user(self, user_id: str, password: str,
                 is_superuser: bool = False) -> None:
        salt = "" if self.algorithm == "plain" else PW.gen_salt()
        self._users[user_id] = {
            "password_hash": PW.hash_password(
                self.algorithm, password.encode(), salt, self.salt_position),
            "salt": salt, "is_superuser": is_superuser}

    def delete_user(self, user_id: str) -> bool:
        return self._users.pop(user_id, None) is not None

    def lookup_user(self, user_id: str) -> Optional[dict]:
        u = self._users.get(user_id)
        return dict(u, user_id=user_id) if u else None

    def list_users(self) -> list[str]:
        return list(self._users)

    def update_user(self, user_id: str, password: Optional[str] = None,
                    is_superuser: Optional[bool] = None) -> bool:
        if user_id not in self._users:
            return False
        if password is not None:
            self.add_user(user_id, password,
                          self._users[user_id]["is_superuser"])
        if is_superuser is not None:
            self._users[user_id]["is_superuser"] = is_superuser
        return True

    # ---- chain interface ----
    def authenticate(self, clientinfo: dict, password: Optional[bytes]):
        uid = (clientinfo.get("username") if self.user_id_type == "username"
               else clientinfo.get("clientid"))
        if not uid:
            return IGNORE, {}
        u = self._users.get(uid)
        if u is None:
            return IGNORE, {}
        if PW.check_password(self.algorithm, u["password_hash"], password,
                             u["salt"], self.salt_position):
            return OK, {"is_superuser": u["is_superuser"]}
        return DENY, {}


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class JWTAuthenticator:
    """HMAC-signed JWT carried in the MQTT password field.

    Parity: emqx_authn_jwt.erl — algorithm hmac-based, `verify_claims`
    pairs where the expected value supports %u (username) and %c
    (clientid) substitution; exp/nbf always enforced.
    """

    name = "jwt"
    _ALGOS = {"HS256": hashlib.sha256, "HS384": hashlib.sha384,
              "HS512": hashlib.sha512}

    def __init__(self, secret: str, algorithm: str = "HS256",
                 verify_claims: Optional[dict] = None,
                 acl_claim_name: str = "acl"):
        if algorithm not in self._ALGOS:
            raise ValueError(f"unsupported jwt algorithm {algorithm}")
        self.secret = secret.encode()
        self.algorithm = algorithm
        self.verify_claims = dict(verify_claims or {})
        self.acl_claim_name = acl_claim_name

    def _verify(self, token: str) -> Optional[dict]:
        try:
            head_s, payload_s, sig_s = token.split(".")
            header = json.loads(_b64url_decode(head_s))
            if header.get("alg") != self.algorithm:
                return None
            digest = self._ALGOS[self.algorithm]
            expect = _hmac.new(self.secret,
                               f"{head_s}.{payload_s}".encode(),
                               digest).digest()
            if not _hmac.compare_digest(expect, _b64url_decode(sig_s)):
                return None
            claims = json.loads(_b64url_decode(payload_s))
            # a validly-signed scalar/array payload is still not a claims
            # object — treat as unusable, not as a crash
            return claims if isinstance(claims, dict) else None
        except Exception:
            return None

    def authenticate(self, clientinfo: dict, password: Optional[bytes]):
        if not password:
            return IGNORE, {}
        claims = self._verify(password.decode("utf-8", "replace"))
        if claims is None:
            return IGNORE, {}
        now = time.time()
        if "exp" in claims and now >= float(claims["exp"]):
            return DENY, {}
        if "nbf" in claims and now < float(claims["nbf"]):
            return DENY, {}
        for name, expected in self.verify_claims.items():
            want = (str(expected)
                    .replace("%u", clientinfo.get("username") or "")
                    .replace("%c", clientinfo.get("clientid") or ""))
            if str(claims.get(name)) != want:
                return DENY, {}
        extra = {"is_superuser": bool(claims.get("is_superuser", False))}
        if self.acl_claim_name in claims:
            extra["acl"] = claims[self.acl_claim_name]
        return OK, extra


class HTTPAuthenticator:
    """External HTTP service decides; body carries %-substituted params.

    Parity: emqx_authn_http.erl — result read from the response JSON
    `result` field (allow/deny/ignore) or the HTTP status (200 allow,
    204 allow, 4xx ignore).
    """

    name = "password_based:http"

    def __init__(self, url: str, method: str = "post",
                 body: Optional[dict] = None,
                 headers: Optional[dict] = None,
                 timeout: float = 5.0,
                 transport: Optional[Callable[..., Awaitable]] = None):
        self.url = url
        self.method = method
        self.body = body or {"username": "%u", "clientid": "%c",
                             "password": "%P"}
        self.headers = headers or {}
        self.timeout = timeout
        self._transport = transport

    async def authenticate_async(self, clientinfo: dict,
                                 password: Optional[bytes]):
        from emqx_tpu_torch.utils.http import templated_request
        peer = clientinfo.get("peername")
        subs = {"%u": clientinfo.get("username") or "",
                "%c": clientinfo.get("clientid") or "",
                "%P": (password or b"").decode("utf-8", "replace"),
                "%a": str(peer[0]) if peer else "",
                "%p": str(peer[1]) if peer else ""}
        try:
            resp = await templated_request(
                self.method, self.url, self.body, subs,
                headers=self.headers, timeout=self.timeout,
                transport=self._transport)
        except Exception:
            return IGNORE, {}
        if resp.status == 204:
            return OK, {}
        if resp.status != 200:
            return IGNORE, {}
        try:
            data = resp.json()
        except Exception:
            return OK, {}
        result = data.get("result", "allow")
        if result in ("allow", "ok"):
            extra = {"is_superuser": bool(data.get("is_superuser", False))}
            return OK, extra
        if result == "ignore":
            return IGNORE, {}
        return DENY, {}

    def authenticate(self, clientinfo: dict, password: Optional[bytes]):
        # sync path (hook context): HTTP authn needs the async pipeline;
        # the chain calls authenticate_async when available
        return IGNORE, {}


class AuthnChain:
    """The `client.authenticate` hook: folds authenticators in order."""

    def __init__(self, node, authenticators: Optional[list] = None,
                 enable: Optional[bool] = None):
        self.node = node
        conf = node.config.get("authn") or {}
        self.enable = conf.get("enable", False) if enable is None else enable
        self.authenticators = list(authenticators or [])

    def load(self) -> "AuthnChain":
        self.node.hooks.add("client.authenticate", self.on_authenticate,
                            priority=HP_AUTHN, tag="authn")
        for a in self.authenticators:
            self._register_enhanced(a)
        return self

    def unload(self) -> None:
        self.node.hooks.delete("client.authenticate", "authn")
        for a in self.authenticators:
            if getattr(a, "mechanism", None):
                getattr(self.node, "enhanced_authn", {}) \
                    .pop(a.mechanism, None)

    def _register_enhanced(self, a) -> None:
        """Authenticators with a `mechanism` (SCRAM) also serve the MQTT5
        AUTH-packet exchange; the channel finds them by method name."""
        mech = getattr(a, "mechanism", None)
        if mech:
            if not hasattr(self.node, "enhanced_authn"):
                self.node.enhanced_authn = {}
            self.node.enhanced_authn[mech] = a

    def add_authenticator(self, a) -> None:
        self.authenticators.append(a)
        self._register_enhanced(a)

    def remove_authenticator(self, name: str) -> bool:
        n = len(self.authenticators)
        removed = [a for a in self.authenticators if a.name == name]
        self.authenticators = [a for a in self.authenticators
                               if a.name != name]
        for a in removed:       # also stop serving its AUTH exchanges
            if getattr(a, "mechanism", None):
                getattr(self.node, "enhanced_authn", {}) \
                    .pop(a.mechanism, None)
        return len(self.authenticators) < n

    async def on_authenticate(self, clientinfo: dict, acc):
        if not self.enable or not self.authenticators:
            return ("ok", acc)
        password = (acc or {}).get("password")
        for a in self.authenticators:
            if hasattr(a, "authenticate_async"):
                verdict, extra = await a.authenticate_async(clientinfo,
                                                            password)
            else:
                verdict, extra = a.authenticate(clientinfo, password)
            if verdict == OK:
                self.node.metrics.inc("client.auth.success")
                return ("stop", dict({"ok": True}, **extra))
            if verdict == DENY:
                self.node.metrics.inc("client.auth.failure")
                return ("stop", {"ok": False,
                                 "rc": C.RC_BAD_USER_NAME_OR_PASSWORD})
        self.node.metrics.inc("client.auth.failure")
        return ("stop", {"ok": False, "rc": C.RC_NOT_AUTHORIZED})
