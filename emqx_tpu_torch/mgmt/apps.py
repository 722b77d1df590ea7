"""API application credentials (app id / secret).

Parity: emqx_mgmt_auth.erl — add_app/del_app/list_apps/is_authorized; the
REST listener authenticates HTTP basic credentials against this table
(`mgmt insert/lookup/update/delete/list` CLI, emqx_mgmt_cli.erl:64-106).
The port's copy of ``emqx_tpu/mgmt/apps.py``.
"""

from __future__ import annotations

import secrets
import time
from typing import Optional


class AppAuth:
    def __init__(self):
        self.apps: dict[str, dict] = {}

    def add_app(self, app_id: str, name: str,
                secret: Optional[str] = None, desc: str = "",
                status: bool = True,
                expired: Optional[int] = None) -> str:
        if app_id in self.apps:
            raise ValueError("already_existed")
        secret = secret or secrets.token_urlsafe(24)
        self.apps[app_id] = {"app_id": app_id, "name": name,
                             "secret": secret, "desc": desc,
                             "status": status, "expired": expired,
                             "created_at": int(time.time())}
        return secret

    def del_app(self, app_id: str) -> bool:
        return self.apps.pop(app_id, None) is not None

    def update_app(self, app_id: str, status: bool) -> bool:
        app = self.apps.get(app_id)
        if app is None:
            return False
        app["status"] = status
        return True

    def lookup_app(self, app_id: str) -> Optional[dict]:
        app = self.apps.get(app_id)
        if app is None:
            return None
        return {k: v for k, v in app.items() if k != "secret"}

    def list_apps(self) -> list[dict]:
        return [{k: v for k, v in a.items() if k != "secret"}
                for a in self.apps.values()]

    def is_authorized(self, app_id: str, secret: str) -> bool:
        app = self.apps.get(app_id)
        if app is None or not app["status"]:
            return False
        if app["expired"] is not None and time.time() > app["expired"]:
            return False
        return secrets.compare_digest(app["secret"], secret)
