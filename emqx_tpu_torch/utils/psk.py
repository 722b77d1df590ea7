"""TLS-PSK identity store.

Parity: apps/emqx/src/emqx_psk.erl — a table of identity -> pre-shared key
bootstrapped from a colon-separated file, consulted by the TLS handshake's
psk lookup. Python's ssl module grows PSK callbacks in 3.13
(`SSLContext.set_psk_server_callback`); on earlier runtimes the store and
its file format are fully functional and `attach()` reports unsupported,
matching how the reference gates quicer/bcrypt behind build profiles.
"""

from __future__ import annotations

import binascii
import ssl
from typing import Optional


class PskStore:
    def __init__(self):
        self._keys: dict[str, bytes] = {}

    # file format (emqx_psk.erl init/bootstrap): one "identity:hexkey" per
    # line, '#' comments allowed
    def load_file(self, path: str, separator: str = ":") -> int:
        n = 0
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ident, _, key = line.partition(separator)
                if not key:
                    continue
                self.insert(ident.strip(), key.strip())
                n += 1
        return n

    def insert(self, identity: str, hexkey: str) -> None:
        self._keys[identity] = binascii.unhexlify(hexkey)

    def delete(self, identity: str) -> bool:
        return self._keys.pop(identity, None) is not None

    def lookup(self, identity: str) -> Optional[bytes]:
        return self._keys.get(identity)

    def all(self) -> list[str]:
        return sorted(self._keys)

    # ---- ssl integration (requires python >= 3.13) ----------------------
    @staticmethod
    def supported() -> bool:
        return hasattr(ssl.SSLContext, "set_psk_server_callback")

    def attach(self, ctx: ssl.SSLContext) -> bool:
        """Install the identity lookup on a server context; False when the
        runtime's ssl module has no PSK support."""
        if not self.supported():
            return False
        ctx.set_psk_server_callback(
            lambda identity: self.lookup(identity or "") or b"")
        return True
