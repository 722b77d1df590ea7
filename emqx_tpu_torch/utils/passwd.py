"""Password hashing/verification for the built-in authentication DB.

Parity: apps/emqx/src/emqx_passwd.erl — algorithms plain, md5, sha, sha256,
sha512, pbkdf2, with salt prefix/suffix placement. bcrypt (a C NIF in the
reference's cloud profile, rebar.config.erl:15-16) is gated: used when a
bcrypt module is importable, otherwise rejected at config time.

The port's copy of ``emqx_tpu/utils/passwd.py``; bcrypt stays optional
exactly as there.
"""

from __future__ import annotations

import hashlib
import hmac
import os
from typing import Optional

ALGORITHMS = ("plain", "md5", "sha", "sha256", "sha512", "pbkdf2", "bcrypt")

try:                                    # optional C-backed bcrypt
    import bcrypt as _bcrypt            # pragma: no cover
except ImportError:
    _bcrypt = None


def gen_salt(n: int = 16) -> str:
    return os.urandom(n).hex()


def hash_password(algo: str, password: bytes, salt: str = "",
                  salt_position: str = "prefix",
                  iterations: int = 4096, dk_length: int = 32) -> str:
    """Returns the hex digest (or bcrypt hash string)."""
    if algo == "plain":
        return password.decode("utf-8", "surrogateescape")
    if algo == "bcrypt":
        if _bcrypt is None:
            raise ValueError("bcrypt not available in this build")
        return _bcrypt.hashpw(password, salt.encode() if salt
                              else _bcrypt.gensalt()).decode()
    if algo == "pbkdf2":
        dk = hashlib.pbkdf2_hmac("sha256", password, salt.encode(),
                                 iterations, dklen=dk_length)
        return dk.hex()
    salted = (salt.encode() + password if salt_position == "prefix"
              else password + salt.encode())
    if algo == "md5":
        return hashlib.md5(salted).hexdigest()
    if algo == "sha":
        return hashlib.sha1(salted).hexdigest()
    if algo == "sha256":
        return hashlib.sha256(salted).hexdigest()
    if algo == "sha512":
        return hashlib.sha512(salted).hexdigest()
    raise ValueError(f"unknown password hash algorithm {algo!r}")


def check_password(algo: str, stored: str, password: Optional[bytes],
                   salt: str = "", salt_position: str = "prefix",
                   iterations: int = 4096, dk_length: int = 32) -> bool:
    if password is None:
        return False
    if algo == "bcrypt":
        if _bcrypt is None:
            return False
        try:
            return _bcrypt.checkpw(password, stored.encode())
        except ValueError:
            return False
    got = hash_password(algo, password, salt, salt_position, iterations,
                        dk_length)
    return hmac.compare_digest(got, stored)
