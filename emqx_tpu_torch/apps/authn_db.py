"""SCRAM enhanced authentication (the MQTT5 AUTH exchange).

Parity: enhanced_authn/emqx_enhanced_authn_scram_mnesia.erl.

The port's copy of ``ScramAuthenticator`` from ``emqx_tpu/apps/authn_db.py``
(its lines 186-248). The rest of that file — the placeholder helpers and
the MySQL, PostgreSQL, MongoDB and LDAP authenticators — waits for the
connectors and resources (ROADMAP.md Queue A item 20(d)).
"""

from __future__ import annotations

from typing import Optional

from emqx_tpu_torch.utils.scram import ScramServer, make_credentials

OK, IGNORE, DENY = "ok", "ignore", "deny"


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
