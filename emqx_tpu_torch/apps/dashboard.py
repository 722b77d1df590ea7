"""Dashboard: admin users + token auth + overview endpoints.

Parity: apps/emqx_dashboard — admin user table with hashed passwords
(emqx_dashboard_admin.erl: add/remove/change_password/check, default
admin/public seeded at boot), login issuing a bearer token the HTTP layer
accepts, and the overview data the web UI renders (the reference fetches
the static asset bundle at build time — here the landing endpoint serves
the JSON the UI would consume). The port's copy of
``emqx_tpu/apps/dashboard.py``, serving the same ``assets/dashboard.html``.
"""

from __future__ import annotations

import hashlib
import os
import secrets
import time
from typing import Optional

TOKEN_TTL_S = 3600


def _hash(password: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", password.encode(), salt, 10000)


class DashboardAdmin:
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        c = dict(node.config.get("dashboard") or {})
        c.update(conf or {})
        self._users: dict[str, dict] = {}
        self._tokens: dict[str, tuple[str, float]] = {}  # tok -> (user, exp)
        self.add_user(c.get("default_username", "admin"),
                      c.get("default_password", "public"),
                      "administrator", replace=True)
        node.dashboard = self

    # ---- users (emqx_dashboard_admin) ----
    def add_user(self, username: str, password: str, desc: str = "",
                 replace: bool = False) -> None:
        if username in self._users and not replace:
            raise ValueError("user already exists")
        salt = os.urandom(16)
        self._users[username] = {"salt": salt,
                                 "hash": _hash(password, salt),
                                 "desc": desc,
                                 "created_at": int(time.time())}

    def remove_user(self, username: str) -> bool:
        if len(self._users) <= 1:
            raise ValueError("cannot remove the last admin")
        return self._users.pop(username, None) is not None

    def change_password(self, username: str, old: str, new: str) -> bool:
        if not self.check(username, old):
            return False
        self.add_user(username, new,
                      self._users[username]["desc"], replace=True)
        return True

    def check(self, username: str, password: str) -> bool:
        u = self._users.get(username)
        if u is None:
            return False
        return secrets.compare_digest(u["hash"],
                                      _hash(password, u["salt"]))

    def users(self) -> list[dict]:
        return [{"username": n, "description": u["desc"]}
                for n, u in self._users.items()]

    # ---- tokens ----
    def sign_token(self, username: str, password: str) -> Optional[str]:
        if not self.check(username, password):
            return None
        tok = secrets.token_urlsafe(32)
        self._tokens[tok] = (username, time.time() + TOKEN_TTL_S)
        return tok

    def verify_token(self, token: str) -> Optional[str]:
        ent = self._tokens.get(token)
        if ent is None:
            return None
        user, exp = ent
        if time.time() > exp:
            del self._tokens[token]
            return None
        return user

    def destroy_token(self, token: str) -> bool:
        return self._tokens.pop(token, None) is not None

    # ---- HTTP auth hook for mgmt HttpServer (basic or bearer) ----
    def auth_check(self, user: str, secret: str) -> bool:
        if user == "__bearer__":
            return self.verify_token(secret) is not None
        return self.check(user, secret)


def register_api(srv, node, admin: DashboardAdmin, mgmt=None) -> None:
    """Mount dashboard endpoints on a mgmt HttpServer."""
    from emqx_tpu_torch.mgmt.httpd import ApiError

    # the web UI itself + login are reachable without credentials (the
    # page drives the token flow); everything else stays behind auth
    srv.auth_exempt = tuple(
        set(srv.auth_exempt) | {"/", "/dashboard", "/api/v5/login"})

    async def index(_req):
        return 200, (_ui_html(), "text/html; charset=utf-8")
    srv.route("GET", "/", index)
    srv.route("GET", "/dashboard", index)

    async def login(req):
        body = req.json() or {}
        tok = admin.sign_token(body.get("username", ""),
                               body.get("password", ""))
        if tok is None:
            raise ApiError(401, "BAD_USERNAME_OR_PWD")
        return {"token": tok, "license": {"edition": "opensource"},
                "version": _version()}
    srv.route("POST", "/api/v5/login", login)

    async def logout(req):
        hdr = req.headers.get("authorization", "")
        if hdr.lower().startswith("bearer "):
            admin.destroy_token(hdr[7:].strip())
        return 204, b""
    srv.route("POST", "/api/v5/logout", logout)

    async def users(_req):
        return admin.users()
    srv.route("GET", "/api/v5/users", users)

    async def add_user(req):
        body = req.json() or {}
        try:
            admin.add_user(body["username"], body["password"],
                           body.get("description", ""))
        except ValueError as e:
            raise ApiError(409, "ALREADY_EXISTS", str(e))
        return 201, {"username": body["username"]}
    srv.route("POST", "/api/v5/users", add_user)

    async def del_user(req):
        try:
            ok = admin.remove_user(req.params["username"])
        except ValueError as e:
            raise ApiError(400, "BAD_REQUEST", str(e))
        if not ok:
            raise ApiError(404, "NOT_FOUND")
        return 204, b""
    srv.route("DELETE", "/api/v5/users/:username", del_user)

    async def change_pwd(req):
        body = req.json() or {}
        if not admin.change_password(req.params["username"],
                                     body.get("old_pwd", ""),
                                     body.get("new_pwd", "")):
            raise ApiError(400, "BAD_USERNAME_OR_PWD")
        return 204, b""
    srv.route("PUT", "/api/v5/users/:username/change_pwd", change_pwd)

    async def overview(_req):
        stats = node.stats.sample()
        return {
            "node": node.name, "version": _version(),
            "uptime": int(time.monotonic()),
            "connections": stats.get("connections.count", 0),
            "topics": stats.get("topics.count", 0),
            "subscriptions": stats.get("subscriptions.count", 0),
            "retained": stats.get("retained.count", 0),
            "received": node.metrics.val("messages.received"),
            "sent": node.metrics.val("messages.sent"),
            # structured views the built-in UI renders
            "stats": stats,
            "metrics": node.metrics.all(),
        }
    srv.route("GET", "/api/v5/overview", overview)


def _version() -> str:
    from emqx_tpu_torch.version import __version__
    return __version__


_UI_CACHE: Optional[bytes] = None


def _ui_html() -> bytes:
    """The single-file web UI (parity: the reference serves a prebuilt
    dashboard bundle, scripts/get-dashboard.sh + emqx_dashboard)."""
    global _UI_CACHE
    if _UI_CACHE is None:
        path = os.path.join(os.path.dirname(__file__), "assets",
                            "dashboard.html")
        with open(path, "rb") as f:
            _UI_CACHE = f.read()
    return _UI_CACHE
