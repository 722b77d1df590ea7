"""SCRAM (RFC 5802) client + server state machines, SHA-1/SHA-256.

Parity: the reference's enhanced-auth SCRAM backend
(apps/emqx_authn/src/enhanced_authn/emqx_enhanced_authn_scram_mnesia.erl,
delegating to the esasl dep) — here a self-contained implementation used
by three consumers: the MQTT5 enhanced-auth authenticator, the PostgreSQL
connector (SCRAM-SHA-256 SASL auth), and the MongoDB connector
(saslStart/saslContinue).

Credential storage is the standard server-side tuple
(stored_key, server_key, salt, iteration_count) — the plaintext password
never persists, matching the scram_user_credentail record.

The port's copy of ``emqx_tpu/utils/scram.py``, with the same three
consumers there (``apps/authn_db.ScramAuthenticator``,
``connectors/pgsql.py``, ``connectors/mongo.py``).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
from typing import Optional

ALGOS = {"sha1": hashlib.sha1, "sha256": hashlib.sha256,
         "sha512": hashlib.sha512}


def _h(algo: str, data: bytes) -> bytes:
    return ALGOS[algo](data).digest()


def _hmac(algo: str, key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, ALGOS[algo]).digest()


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def salted_password(algo: str, password: bytes, salt: bytes,
                    iterations: int) -> bytes:
    return hashlib.pbkdf2_hmac(algo, password, salt, iterations)


def derive_keys(algo: str, salted: bytes) -> tuple[bytes, bytes]:
    """-> (stored_key, server_key)"""
    client_key = _hmac(algo, salted, b"Client Key")
    server_key = _hmac(algo, salted, b"Server Key")
    return _h(algo, client_key), server_key


def make_credentials(password: str, algo: str = "sha256",
                     iterations: int = 4096,
                     salt: Optional[bytes] = None) -> dict:
    """Server-side stored credential for a new user."""
    salt = salt if salt is not None else os.urandom(16)
    salted = salted_password(algo, password.encode(), salt, iterations)
    stored_key, server_key = derive_keys(algo, salted)
    return {"stored_key": stored_key, "server_key": server_key,
            "salt": salt, "iteration_count": iterations, "algorithm": algo}


def _nonce() -> str:
    return base64.b64encode(os.urandom(18)).decode()


def _parse_attrs(msg: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in msg.split(","):
        if len(part) >= 2 and part[1] == "=":
            out[part[0]] = part[2:]
    return out


def _saslname_decode(name: str) -> str:
    return name.replace("=2C", ",").replace("=3D", "=")


def _saslname_encode(name: str) -> str:
    return name.replace("=", "=3D").replace(",", "=2C")


class ScramError(Exception):
    pass


class ScramClient:
    """Client side: first() -> server-first -> final() -> verify server."""

    def __init__(self, username: str, password: str, algo: str = "sha256",
                 nonce: Optional[str] = None):
        self.algo = algo
        self.username = username
        self.password = password
        self.cnonce = nonce or _nonce()
        self._client_first_bare = ""
        self._auth_message = b""
        self._server_signature = b""

    def first(self) -> str:
        self._client_first_bare = \
            f"n={_saslname_encode(self.username)},r={self.cnonce}"
        return "n,," + self._client_first_bare

    def final(self, server_first: str) -> str:
        attrs = _parse_attrs(server_first)
        nonce = attrs.get("r", "")
        if not nonce.startswith(self.cnonce):
            raise ScramError("server nonce does not extend client nonce")
        salt = base64.b64decode(attrs["s"])
        iters = int(attrs["i"])
        channel = base64.b64encode(b"n,,").decode()
        final_bare = f"c={channel},r={nonce}"
        self._auth_message = ",".join(
            [self._client_first_bare, server_first, final_bare]).encode()
        salted = salted_password(self.algo, self.password.encode(),
                                 salt, iters)
        client_key = _hmac(self.algo, salted, b"Client Key")
        stored_key = _h(self.algo, client_key)
        signature = _hmac(self.algo, stored_key, self._auth_message)
        proof = _xor(client_key, signature)
        server_key = _hmac(self.algo, salted, b"Server Key")
        self._server_signature = _hmac(self.algo, server_key,
                                       self._auth_message)
        return final_bare + ",p=" + base64.b64encode(proof).decode()

    def verify_server(self, server_final: str) -> bool:
        attrs = _parse_attrs(server_final)
        if "e" in attrs:
            return False
        got = base64.b64decode(attrs.get("v", ""))
        return hmac.compare_digest(got, self._server_signature)


class ScramServer:
    """Server side: challenge(client-first) -> server-first;
    finish(client-final) -> server-final (or raise ScramError).

    `lookup` maps username -> credential dict from make_credentials
    (or None for unknown users).
    """

    def __init__(self, lookup, algo: str = "sha256",
                 nonce: Optional[str] = None):
        self.lookup = lookup
        self.algo = algo
        self.snonce = nonce or _nonce()
        self.username = ""
        self._cred: Optional[dict] = None
        self._client_first_bare = ""
        self._server_first = ""
        self._nonce = ""

    def challenge(self, client_first: str) -> str:
        if client_first.startswith(("n,,", "y,,")):
            bare = client_first[3:]
        elif client_first.startswith(("n,", "y,")):
            # gs2 header with authzid: strip up to the 2nd comma
            bare = client_first.split(",", 2)[2]
        else:
            raise ScramError("channel binding not supported")
        attrs = _parse_attrs(bare)
        if "n" not in attrs or "r" not in attrs:
            raise ScramError("malformed client-first message")
        self.username = _saslname_decode(attrs["n"])
        self._client_first_bare = bare
        self._cred = self.lookup(self.username)
        if self._cred is None:
            raise ScramError("unknown user")
        if self._cred.get("algorithm", self.algo) != self.algo:
            raise ScramError("algorithm mismatch")
        self._nonce = attrs["r"] + self.snonce
        salt_b64 = base64.b64encode(self._cred["salt"]).decode()
        self._server_first = (f"r={self._nonce},s={salt_b64},"
                              f"i={self._cred['iteration_count']}")
        return self._server_first

    def finish(self, client_final: str) -> str:
        attrs = _parse_attrs(client_final)
        if attrs.get("r") != self._nonce:
            raise ScramError("nonce mismatch")
        proof = base64.b64decode(attrs.get("p", ""))
        final_bare = client_final[:client_final.rindex(",p=")]
        auth_message = ",".join(
            [self._client_first_bare, self._server_first,
             final_bare]).encode()
        stored_key = self._cred["stored_key"]
        signature = _hmac(self.algo, stored_key, auth_message)
        client_key = _xor(proof, signature)
        if not hmac.compare_digest(_h(self.algo, client_key), stored_key):
            raise ScramError("invalid proof")
        server_sig = _hmac(self.algo, self._cred["server_key"], auth_message)
        return "v=" + base64.b64encode(server_sig).decode()
