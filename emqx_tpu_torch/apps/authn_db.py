"""Database-backed authenticators + SCRAM enhanced auth.

Parity: apps/emqx_authn/src/simple_authn/emqx_authn_{mysql,pgsql,mongodb}.erl
and enhanced_authn/emqx_enhanced_authn_scram_mnesia.erl. Each
password-based authenticator resolves `${mqtt-username}` /
`${mqtt-clientid}` / `${mqtt-password}` / `${ip-address}` / `${cert-*}`
placeholders in a configured query/selector, fetches the stored
password_hash (+salt, is_superuser) through a db resource, and verifies
with the configured hash algorithm — returning `ignore` on empty results
or query errors so the chain can fall through, `deny` on a bad password
(the reference's bad_username_or_password).

The port's copy of ``emqx_tpu/apps/authn_db.py``.
"""

from __future__ import annotations

import re
from typing import Optional

from emqx_tpu_torch.utils import passwd as PW
from emqx_tpu_torch.utils.scram import (ScramError, ScramServer,
                                        make_credentials)

OK, IGNORE, DENY = "ok", "ignore", "deny"

_PLACEHOLDER_RE = re.compile(r"\$\{([a-zA-Z0-9\-_]+)\}")


def resolve_placeholder(name: str, clientinfo: dict,
                        password: Optional[bytes]) -> Optional[str]:
    """emqx_authn_utils:replace_placeholder/2 variable set."""
    if name == "mqtt-username":
        return clientinfo.get("username")
    if name == "mqtt-clientid":
        return clientinfo.get("clientid")
    if name == "mqtt-password":
        return (password or b"").decode("utf-8", "replace")
    if name == "ip-address":
        peer = clientinfo.get("peername")
        return str(peer[0]) if peer else None
    if name == "cert-subject":
        return clientinfo.get("dn")
    if name == "cert-common-name":
        return clientinfo.get("cn")
    return None


def parse_query(query: str, style: str) -> tuple[str, list[str]]:
    """Extract ${...} placeholders; rewrite to `?` (mysql) or `$n` (pgsql)
    parameter markers (emqx_authn_mysql/pgsql parse_query)."""
    names: list[str] = []

    def _sub(m: re.Match) -> str:
        names.append(m.group(1))
        return "?" if style == "mysql" else f"${len(names)}"

    return _PLACEHOLDER_RE.sub(_sub, query), names


def _fill_params(names: list[str], clientinfo: dict,
                 password: Optional[bytes]) -> Optional[list]:
    params = []
    for n in names:
        v = resolve_placeholder(n, clientinfo, password)
        if v is None:
            return None          # cannot_get_variable → ignore
        params.append(v)
    return params


class _SqlAuthenticator:
    """Shared SELECT-row authenticator over a sql resource
    (emqx_authn_mysql.erl / emqx_authn_pgsql.erl check_password)."""

    style = "mysql"

    def __init__(self, resource, query: str,
                 algorithm: str = "sha256", salt_position: str = "prefix",
                 query_timeout: float = 5.0):
        self.resource = resource
        self.query, self.placeholders = parse_query(query, self.style)
        self.algorithm = algorithm
        self.salt_position = salt_position
        self.query_timeout = query_timeout

    async def authenticate_async(self, clientinfo: dict,
                                 password: Optional[bytes]):
        params = _fill_params(self.placeholders, clientinfo, password)
        if params is None:
            return IGNORE, {}
        try:
            columns, rows = await self.resource.query(
                ("sql", self.query, params))
        except Exception:  # noqa: BLE001
            return IGNORE, {}
        if not rows:
            return IGNORE, {}
        selected = dict(zip(columns, rows[0]))
        return _check_selected(selected, password, self.algorithm,
                               self.salt_position)


def _check_selected(selected: dict, password: Optional[bytes],
                    algorithm: str, salt_position: str):
    stored = selected.get("password_hash")
    if stored is None:
        return DENY, {}
    ok = PW.check_password(algorithm, str(stored), password,
                           str(selected.get("salt") or ""), salt_position)
    if not ok:
        return DENY, {}
    return OK, {"is_superuser": _truthy(selected.get("is_superuser"))}


def _truthy(v) -> bool:
    if isinstance(v, str):
        return v not in ("", "0", "false", "False")
    return bool(v)


class MysqlAuthenticator(_SqlAuthenticator):
    name = "password_based:mysql"
    style = "mysql"


class PgsqlAuthenticator(_SqlAuthenticator):
    name = "password_based:postgresql"
    style = "pgsql"


class MongoAuthenticator:
    """Selector-doc authenticator (emqx_authn_mongodb.erl)."""

    name = "password_based:mongodb"

    def __init__(self, resource, collection: str = "mqtt_user",
                 selector: Optional[dict] = None,
                 password_hash_field: str = "password_hash",
                 salt_field: str = "salt",
                 is_superuser_field: str = "is_superuser",
                 algorithm: str = "sha256", salt_position: str = "prefix"):
        self.resource = resource
        self.collection = collection
        self.selector = selector or {"username": "${mqtt-username}"}
        self.password_hash_field = password_hash_field
        self.salt_field = salt_field
        self.is_superuser_field = is_superuser_field
        self.algorithm = algorithm
        self.salt_position = salt_position

    def _render_selector(self, clientinfo: dict,
                         password: Optional[bytes]) -> Optional[dict]:
        out = {}
        for k, v in self.selector.items():
            if isinstance(v, str):
                m = _PLACEHOLDER_RE.fullmatch(v)
                if m:
                    rv = resolve_placeholder(m.group(1), clientinfo,
                                             password)
                    if rv is None:
                        return None
                    v = rv
            out[k] = v
        return out

    async def authenticate_async(self, clientinfo: dict,
                                 password: Optional[bytes]):
        sel = self._render_selector(clientinfo, password)
        if sel is None:
            return IGNORE, {}
        try:
            docs = await self.resource.query(("find", self.collection, sel))
        except Exception:  # noqa: BLE001
            return IGNORE, {}
        if not docs:
            return IGNORE, {}
        doc = docs[0]
        stored = doc.get(self.password_hash_field)
        if stored is None:
            return DENY, {}
        selected = {"password_hash": stored,
                    "salt": doc.get(self.salt_field) or "",
                    "is_superuser": doc.get(self.is_superuser_field, False)}
        return _check_selected(selected, password, self.algorithm,
                               self.salt_position)


class ScramAuthenticator:
    """MQTT5 enhanced authentication, mechanism SCRAM-SHA-1/256/512.

    Parity: emqx_enhanced_authn_scram_mnesia.erl — local user store of
    (stored_key, server_key, salt) credentials; the channel drives the
    AUTH-packet exchange through begin_/continue_enhanced_auth. The
    authenticate() chain entry ignores password-based credentials so it
    composes with other authenticators in one chain.
    """

    def __init__(self, algorithm: str = "sha256",
                 iteration_count: int = 4096):
        self.algorithm = algorithm
        self.iteration_count = iteration_count
        self._users: dict[str, dict] = {}

    @property
    def name(self) -> str:
        return "scram:built_in_database"

    @property
    def mechanism(self) -> str:
        return f"SCRAM-SHA-{'1' if self.algorithm == 'sha1' else self.algorithm[3:]}"

    # ---- user management (add_user/delete_user/lookup_user API) ----
    def add_user(self, username: str, password: str,
                 is_superuser: bool = False) -> None:
        cred = make_credentials(password, self.algorithm,
                                self.iteration_count)
        cred["is_superuser"] = is_superuser
        self._users[username] = cred

    def delete_user(self, username: str) -> bool:
        return self._users.pop(username, None) is not None

    def lookup_user(self, username: str) -> Optional[dict]:
        u = self._users.get(username)
        return dict(u, username=username) if u else None

    def list_users(self) -> list[str]:
        return list(self._users)

    # ---- enhanced-auth surface driven by the channel ----
    def begin_enhanced_auth(self, auth_data: bytes) -> tuple[bytes, object]:
        """client-first -> (server-first challenge, opaque state)."""
        server = ScramServer(self._users.get, self.algorithm)
        challenge = server.challenge(auth_data.decode("utf-8", "replace"))
        return challenge.encode(), server

    def continue_enhanced_auth(self, auth_data: bytes,
                               state: object) -> tuple[bytes, dict]:
        """client-final -> (server-final, extra) or raises ScramError."""
        server: ScramServer = state
        server_final = server.finish(auth_data.decode("utf-8", "replace"))
        cred = self._users.get(server.username) or {}
        extra = {"is_superuser": bool(cred.get("is_superuser", False)),
                 "username": server.username}
        return server_final.encode(), extra

    # ---- chain interface: not a password authenticator ----
    def authenticate(self, clientinfo: dict, password: Optional[bytes]):
        return IGNORE, {}


class LdapAuthenticator:
    """LDAP bind authentication (round-2 VERDICT item 9): resolve the
    client to a DN by a filter search, then attempt a simple bind with
    the presented password — success authenticates. Parity: the
    reference's eldap-backed authn (emqx_connector_ldap.erl providing the
    transport; the search+bind flow is the classic LDAP auth pattern its
    deployments use).

    filter_tmpl supports `(attr=${placeholder})` and `(&(..)(..)...)`
    with the same placeholder set as the SQL authenticators
    (resolve_placeholder). Search runs on a service connection (bound as
    `bind_dn` when given); the credential check binds on a FRESH
    connection so the service bind is never downgraded.
    """

    name = "password_based:ldap"

    def __init__(self, host: str = "127.0.0.1", port: int = 389,
                 base_dn: str = "",
                 filter_tmpl: str = "(uid=${mqtt-username})",
                 bind_dn: Optional[str] = None, bind_password: str = "",
                 superuser_attr: str = "isSuperuser", ssl=None,
                 timeout: float = 5.0):
        self.host = host
        self.port = port
        self.base_dn = base_dn
        self.filter_tmpl = filter_tmpl
        self.bind_dn = bind_dn
        self.bind_password = bind_password
        self.superuser_attr = superuser_attr
        self.ssl = ssl
        self.timeout = timeout

    def _client(self):
        from emqx_tpu_torch.connectors.ldap import LdapClient
        return LdapClient(host=self.host, port=self.port, ssl=self.ssl,
                          connect_timeout=self.timeout)

    def _build_filter(self, clientinfo: dict,
                      password: Optional[bytes]) -> Optional[bytes]:
        from emqx_tpu_torch.connectors import ldap as L

        def build(expr: str) -> Optional[bytes]:
            expr = expr.strip()
            if not (expr.startswith("(") and expr.endswith(")")):
                raise ValueError(f"bad LDAP filter {expr!r}")
            inner = expr[1:-1]
            if inner.startswith("&"):
                parts, depth, start = [], 0, None
                for i, ch in enumerate(inner):
                    if ch == "(":
                        if depth == 0:
                            start = i
                        depth += 1
                    elif ch == ")":
                        depth -= 1
                        if depth == 0:
                            parts.append(inner[start:i + 1])
                subs = [build(p) for p in parts]
                if any(s is None for s in subs):
                    return None
                return L.f_and(*subs)
            attr, _, val = inner.partition("=")
            m = re.fullmatch(r"\$\{([^}]+)\}", val.strip())
            if m:
                rv = resolve_placeholder(m.group(1), clientinfo, password)
                if rv is None:
                    return None
                val = rv if isinstance(rv, str) else rv.decode()
            return L.f_eq(attr.strip(), val)

        return build(self.filter_tmpl)

    async def authenticate_async(self, clientinfo: dict,
                                 password: Optional[bytes]):
        from emqx_tpu_torch.connectors import ldap as L
        if not password:
            return IGNORE, {}
        try:
            filt = self._build_filter(clientinfo, password)
        except ValueError:
            return IGNORE, {}
        if filt is None:
            return IGNORE, {}
        try:
            svc = self._client()
            await svc.connect()
            try:
                if self.bind_dn:
                    await svc.bind(self.bind_dn, self.bind_password)
                entries = await svc.search(
                    self.base_dn, L.SCOPE_SUB, filt,
                    attributes=[self.superuser_attr], size_limit=1)
            finally:
                await svc.close()
        except Exception:  # noqa: BLE001 — unreachable/refused: next in chain
            return IGNORE, {}
        if not entries:
            return IGNORE, {}
        dn = entries[0]["dn"]
        su_vals = entries[0].get(self.superuser_attr, [])
        try:
            cred = self._client()
            await cred.connect()
            try:
                await cred.bind(dn, password.decode("utf-8", "replace"))
            finally:
                await cred.close()
        except L.LdapError:
            return DENY, {}
        except Exception:  # noqa: BLE001
            return IGNORE, {}
        return OK, {"is_superuser": bool(su_vals)
                    and _truthy(su_vals[0])}


__all__ = ["MysqlAuthenticator", "PgsqlAuthenticator",
           "MongoAuthenticator", "ScramAuthenticator", "LdapAuthenticator",
           "ScramError", "parse_query", "resolve_placeholder"]
