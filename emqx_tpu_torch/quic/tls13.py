"""Minimal TLS 1.3 (RFC 8446) handshake engine for QUIC.

Implements exactly the profile QUIC v1 needs (RFC 9001): the handshake
messages ride CRYPTO frames (no record layer), one cipher suite
(TLS_AES_128_GCM_SHA256), one group (x25519), server auth via
rsa_pss_rsae_sha256 or ecdsa_secp256r1_sha256. Both roles are
implemented (the reference's msquic provides both; the client side here
drives tests and the MQTT bridge).

The engine is sans-IO: feed_crypto(level, bytes) consumes handshake
bytes; outputs accumulate in `pending` as (level, bytes) and derived
traffic secrets in `secrets` as level -> (client_secret, server_secret).
Levels: 0 initial, 1 handshake, 2 application (1-RTT).

The port's copy of ``emqx_tpu/quic/tls13.py``: the same constants
and behaviour, with its imports pointed at ``emqx_tpu_torch``.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct
from typing import Optional

from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, padding, rsa
from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey, X25519PublicKey)

INITIAL, HANDSHAKE, APPLICATION = 0, 1, 2

TLS_AES_128_GCM_SHA256 = 0x1301
GROUP_X25519 = 0x001D
SIG_RSA_PSS_SHA256 = 0x0804
SIG_ECDSA_P256_SHA256 = 0x0403

EXT_SNI = 0
EXT_SUPPORTED_GROUPS = 10
EXT_SIG_ALGS = 13
EXT_ALPN = 16
EXT_SUPPORTED_VERSIONS = 43
EXT_PSK_MODES = 45
EXT_KEY_SHARE = 51
EXT_QUIC_TP = 0x39

HT_CLIENT_HELLO = 1
HT_SERVER_HELLO = 2
HT_ENCRYPTED_EXTENSIONS = 8
HT_CERTIFICATE = 11
HT_CERTIFICATE_VERIFY = 15
HT_FINISHED = 20


def _system_cafile() -> Optional[str]:
    """Best-effort system trust bundle path (OpenSSL default paths plus
    the usual distro locations)."""
    import os
    import ssl
    paths = ssl.get_default_verify_paths()
    for p in (paths.cafile, paths.openssl_cafile,
              "/etc/ssl/certs/ca-certificates.crt",
              "/etc/pki/tls/certs/ca-bundle.crt",
              "/etc/ssl/cert.pem"):
        if p and os.path.isfile(p):
            return p
    return None


class TlsError(Exception):
    def __init__(self, msg: str, alert: int = 40):   # handshake_failure
        self.alert = alert
        super().__init__(msg)


# ---------------------------------------------------------------------------
# HKDF (RFC 5869 + RFC 8446 §7.1), SHA-256 only
# ---------------------------------------------------------------------------

def hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt or b"\x00" * 32, ikm, hashlib.sha256).digest()


def hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out, block, i = b"", b"", 1
    while len(out) < length:
        block = hmac.new(prk, block + info + bytes([i]),
                         hashlib.sha256).digest()
        out += block
        i += 1
    return out[:length]


def hkdf_expand_label(secret: bytes, label: str, context: bytes,
                      length: int) -> bytes:
    lab = b"tls13 " + label.encode()
    info = (struct.pack(">H", length) + bytes([len(lab)]) + lab
            + bytes([len(context)]) + context)
    return hkdf_expand(secret, info, length)


def derive_secret(secret: bytes, label: str, transcript: bytes) -> bytes:
    return hkdf_expand_label(secret, label, transcript, 32)


_EMPTY_HASH = hashlib.sha256(b"").digest()


# ---------------------------------------------------------------------------
# wire helpers
# ---------------------------------------------------------------------------

def _v8(b: bytes) -> bytes:
    return bytes([len(b)]) + b


def _v16(b: bytes) -> bytes:
    return struct.pack(">H", len(b)) + b


def _v24(b: bytes) -> bytes:
    return len(b).to_bytes(3, "big") + b


def _hs_msg(htype: int, body: bytes) -> bytes:
    return bytes([htype]) + _v24(body)


def _ext(etype: int, body: bytes) -> bytes:
    return struct.pack(">HH", etype, len(body)) + body


def _parse_exts(data: bytes) -> dict[int, bytes]:
    out: dict[int, bytes] = {}
    pos = 0
    while pos + 4 <= len(data):
        et, ln = struct.unpack_from(">HH", data, pos)
        out[et] = data[pos + 4:pos + 4 + ln]
        pos += 4 + ln
    return out


class _HsBuffer:
    """Reassembles the CRYPTO byte stream into handshake messages."""

    def __init__(self):
        self.buf = b""

    def feed(self, data: bytes) -> list[tuple[int, bytes, bytes]]:
        self.buf += data
        out = []
        while len(self.buf) >= 4:
            htype = self.buf[0]
            ln = int.from_bytes(self.buf[1:4], "big")
            if len(self.buf) < 4 + ln:
                break
            raw = self.buf[:4 + ln]
            out.append((htype, self.buf[4:4 + ln], raw))
            self.buf = self.buf[4 + ln:]
        return out


class _Base:
    def __init__(self):
        self.pending: list[tuple[int, bytes]] = []
        self.secrets: dict[int, tuple[bytes, bytes]] = {}
        self.transcript = hashlib.sha256()
        self.complete = False
        self.alpn: Optional[str] = None
        self.peer_transport_params: Optional[bytes] = None
        self._buffers = {INITIAL: _HsBuffer(), HANDSHAKE: _HsBuffer(),
                         APPLICATION: _HsBuffer()}
        self._hs_secret = b""
        self._master = b""
        self._client_hs = b""
        self._server_hs = b""

    def _send(self, level: int, raw: bytes) -> None:
        self.pending.append((level, raw))

    def _th(self) -> bytes:
        return self.transcript.copy().digest()

    def _derive_hs(self, shared: bytes) -> None:
        early = hkdf_extract(b"", b"\x00" * 32)
        derived = derive_secret(early, "derived", _EMPTY_HASH)
        self._hs_secret = hkdf_extract(derived, shared)
        th = self._th()
        self._client_hs = derive_secret(self._hs_secret, "c hs traffic", th)
        self._server_hs = derive_secret(self._hs_secret, "s hs traffic", th)
        self.secrets[HANDSHAKE] = (self._client_hs, self._server_hs)
        d2 = derive_secret(self._hs_secret, "derived", _EMPTY_HASH)
        self._master = hkdf_extract(d2, b"\x00" * 32)

    def _derive_app(self) -> None:
        th = self._th()   # transcript through server Finished
        cap = derive_secret(self._master, "c ap traffic", th)
        sap = derive_secret(self._master, "s ap traffic", th)
        self.secrets[APPLICATION] = (cap, sap)

    @staticmethod
    def _finished_mac(traffic_secret: bytes, th: bytes) -> bytes:
        fk = hkdf_expand_label(traffic_secret, "finished", b"", 32)
        return hmac.new(fk, th, hashlib.sha256).digest()

    @staticmethod
    def _cv_content(th: bytes, server: bool) -> bytes:
        role = b"server" if server else b"client"
        return (b"\x20" * 64 + b"TLS 1.3, " + role
                + b" CertificateVerify\x00" + th)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class Tls13Server(_Base):
    def __init__(self, certfile: str, keyfile: str,
                 alpn_protocols: list[str],
                 transport_params: bytes):
        super().__init__()
        from cryptography import x509
        with open(certfile, "rb") as f:
            pem = f.read()
        self._certs = x509.load_pem_x509_certificates(pem)
        with open(keyfile, "rb") as f:
            self._key = serialization.load_pem_private_key(f.read(), None)
        self._alpn_offer = alpn_protocols
        self._tp = transport_params
        self._client_finished_due = False

    def feed_crypto(self, level: int, data: bytes) -> None:
        for htype, body, raw in self._buffers[level].feed(data):
            if htype == HT_CLIENT_HELLO and level == INITIAL \
                    and not self._hs_secret:
                self._on_client_hello(body, raw)
            elif htype == HT_FINISHED and level == HANDSHAKE \
                    and self._client_finished_due:
                expect = self._finished_mac(self._client_hs, self._th())
                if not hmac.compare_digest(body, expect):
                    raise TlsError("bad client Finished", 51)
                self.transcript.update(raw)
                self._client_finished_due = False
                self.complete = True
            else:
                raise TlsError(f"unexpected handshake message {htype} "
                               f"at level {level}", 10)

    def _on_client_hello(self, body: bytes, raw: bytes) -> None:
        pos = 2 + 32                                  # version + random
        sid_len = body[pos]
        session_id = body[pos + 1:pos + 1 + sid_len]
        pos += 1 + sid_len
        cs_len = struct.unpack_from(">H", body, pos)[0]
        suites = [struct.unpack_from(">H", body, pos + 2 + i)[0]
                  for i in range(0, cs_len, 2)]
        pos += 2 + cs_len
        pos += 1 + body[pos]                          # compression methods
        ext_len = struct.unpack_from(">H", body, pos)[0]
        exts = _parse_exts(body[pos + 2:pos + 2 + ext_len])

        if TLS_AES_128_GCM_SHA256 not in suites:
            raise TlsError("no common cipher suite", 71)
        sv = exts.get(EXT_SUPPORTED_VERSIONS, b"")
        if b"\x03\x04" not in sv:
            raise TlsError("TLS 1.3 not offered", 70)
        peer_pub = None
        ks = exts.get(EXT_KEY_SHARE, b"")
        if len(ks) >= 2:
            kpos = 2
            while kpos + 4 <= len(ks):
                grp, ln = struct.unpack_from(">HH", ks, kpos)
                if grp == GROUP_X25519 and ln == 32:
                    peer_pub = ks[kpos + 4:kpos + 36]
                kpos += 4 + ln
        if peer_pub is None:
            raise TlsError("no x25519 key share", 40)
        if EXT_QUIC_TP in exts:
            self.peer_transport_params = exts[EXT_QUIC_TP]
        alpn = exts.get(EXT_ALPN)
        chosen = None
        if alpn is not None and len(alpn) >= 2:
            apos = 2
            offered = []
            while apos < len(alpn):
                ln = alpn[apos]
                offered.append(alpn[apos + 1:apos + 1 + ln].decode())
                apos += 1 + ln
            for p in self._alpn_offer:
                if p in offered:
                    chosen = p
                    break
            if chosen is None:
                raise TlsError("no common ALPN protocol", 120)
        self.alpn = chosen

        self.transcript.update(raw)
        priv = X25519PrivateKey.generate()
        shared = priv.exchange(X25519PublicKey.from_public_bytes(peer_pub))
        my_pub = priv.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)

        sh_exts = (_ext(EXT_SUPPORTED_VERSIONS, b"\x03\x04")
                   + _ext(EXT_KEY_SHARE,
                          struct.pack(">HH", GROUP_X25519, 32) + my_pub))
        sh_body = (b"\x03\x03" + os.urandom(32) + _v8(session_id)
                   + struct.pack(">H", TLS_AES_128_GCM_SHA256) + b"\x00"
                   + _v16(sh_exts))
        sh = _hs_msg(HT_SERVER_HELLO, sh_body)
        self.transcript.update(sh)
        self._send(INITIAL, sh)
        self._derive_hs(shared)

        # EncryptedExtensions + Certificate + CertificateVerify + Finished
        ee_exts = _ext(EXT_QUIC_TP, self._tp)
        if chosen:
            ee_exts += _ext(EXT_ALPN, _v16(_v8(chosen.encode())))
        flight = _hs_msg(HT_ENCRYPTED_EXTENSIONS, _v16(ee_exts))
        self.transcript.update(flight)

        entries = b"".join(
            _v24(c.public_bytes(serialization.Encoding.DER)) + b"\x00\x00"
            for c in self._certs)
        cert = _hs_msg(HT_CERTIFICATE, b"\x00" + _v24(entries))
        self.transcript.update(cert)
        flight += cert

        content = self._cv_content(self._th(), server=True)
        if isinstance(self._key, rsa.RSAPrivateKey):
            sig = self._key.sign(
                content,
                padding.PSS(mgf=padding.MGF1(hashes.SHA256()),
                            salt_length=hashes.SHA256.digest_size),
                hashes.SHA256())
            alg = SIG_RSA_PSS_SHA256
        elif isinstance(self._key, ec.EllipticCurvePrivateKey):
            sig = self._key.sign(content, ec.ECDSA(hashes.SHA256()))
            alg = SIG_ECDSA_P256_SHA256
        else:
            raise TlsError("unsupported server key type", 80)
        cv = _hs_msg(HT_CERTIFICATE_VERIFY,
                     struct.pack(">H", alg) + _v16(sig))
        self.transcript.update(cv)
        flight += cv

        fin = _hs_msg(HT_FINISHED,
                      self._finished_mac(self._server_hs, self._th()))
        self.transcript.update(fin)
        flight += fin
        self._send(HANDSHAKE, flight)
        self._derive_app()
        self._client_finished_due = True


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class Tls13Client(_Base):
    def __init__(self, server_name: str, alpn_protocols: list[str],
                 transport_params: bytes, cafile: Optional[str] = None,
                 verify: str = "required"):
        """verify='required' (default): the server chain MUST validate
        against `cafile`, or the system trust store when cafile is None —
        there is no silent fall-through to unauthenticated encryption.
        verify='none' is an explicit opt-out (test rigs, pinned
        deployments) and logs loudly. The reference gets the same default
        from msquic/platform validation."""
        super().__init__()
        self.server_name = server_name
        self._alpn = alpn_protocols
        self._tp = transport_params
        if verify not in ("required", "none"):
            raise ValueError(f"verify must be 'required' or 'none', "
                             f"got {verify!r}")
        self._verify = verify
        if verify == "required" and cafile is None:
            cafile = _system_cafile()
            if cafile is None:
                raise ValueError(
                    "no CA bundle found: pass cafile=..., or opt out "
                    "explicitly with verify='none'")
        if verify == "none":
            import logging
            logging.getLogger("emqx.quic").warning(
                "QUIC TLS verify='none': server certificate and hostname "
                "are NOT verified (connection is encrypted but "
                "unauthenticated)")
            cafile = None
        self._cafile = cafile
        self._priv = X25519PrivateKey.generate()
        self._server_cert = None

    def start(self) -> None:
        pub = self._priv.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        exts = b""
        if self.server_name:
            host = self.server_name.encode()
            exts += _ext(EXT_SNI, _v16(b"\x00" + _v16(host)))
        exts += _ext(EXT_SUPPORTED_GROUPS,
                     _v16(struct.pack(">H", GROUP_X25519)))
        exts += _ext(EXT_SIG_ALGS, _v16(struct.pack(
            ">HH", SIG_RSA_PSS_SHA256, SIG_ECDSA_P256_SHA256)))
        exts += _ext(EXT_SUPPORTED_VERSIONS, b"\x02\x03\x04")
        exts += _ext(EXT_PSK_MODES, b"\x01\x01")
        exts += _ext(EXT_KEY_SHARE, _v16(
            struct.pack(">HH", GROUP_X25519, 32) + pub))
        if self._alpn:
            exts += _ext(EXT_ALPN, _v16(b"".join(
                _v8(p.encode()) for p in self._alpn)))
        exts += _ext(EXT_QUIC_TP, self._tp)
        body = (b"\x03\x03" + os.urandom(32) + _v8(os.urandom(32))
                + _v16(struct.pack(">H", TLS_AES_128_GCM_SHA256))
                + b"\x01\x00" + _v16(exts))
        ch = _hs_msg(HT_CLIENT_HELLO, body)
        self.transcript.update(ch)
        self._send(INITIAL, ch)

    def feed_crypto(self, level: int, data: bytes) -> None:
        for htype, body, raw in self._buffers[level].feed(data):
            if htype == HT_SERVER_HELLO and level == INITIAL:
                self._on_server_hello(body, raw)
            elif level == HANDSHAKE and htype == HT_ENCRYPTED_EXTENSIONS:
                self.transcript.update(raw)
                exts = _parse_exts(body[2:])
                if EXT_QUIC_TP in exts:
                    self.peer_transport_params = exts[EXT_QUIC_TP]
                if EXT_ALPN in exts:
                    a = exts[EXT_ALPN]
                    self.alpn = a[3:3 + a[2]].decode()
            elif level == HANDSHAKE and htype == HT_CERTIFICATE:
                self._on_certificate(body, raw)
            elif level == HANDSHAKE and htype == HT_CERTIFICATE_VERIFY:
                self._on_cert_verify(body, raw)
            elif level == HANDSHAKE and htype == HT_FINISHED:
                self._on_server_finished(body, raw)
            else:
                raise TlsError(f"unexpected handshake message {htype} "
                               f"at level {level}", 10)

    def _on_server_hello(self, body: bytes, raw: bytes) -> None:
        pos = 2 + 32
        pos += 1 + body[pos]                         # session id echo
        suite = struct.unpack_from(">H", body, pos)[0]
        if suite != TLS_AES_128_GCM_SHA256:
            raise TlsError("server chose unsupported suite", 47)
        pos += 3                                     # suite + compression
        ext_len = struct.unpack_from(">H", body, pos)[0]
        exts = _parse_exts(body[pos + 2:pos + 2 + ext_len])
        ks = exts.get(EXT_KEY_SHARE, b"")
        grp, ln = struct.unpack_from(">HH", ks, 0)
        if grp != GROUP_X25519 or ln != 32:
            raise TlsError("server key share not x25519", 47)
        self.transcript.update(raw)
        shared = self._priv.exchange(
            X25519PublicKey.from_public_bytes(ks[4:36]))
        self._derive_hs(shared)

    def _on_certificate(self, body: bytes, raw: bytes) -> None:
        from cryptography import x509
        self.transcript.update(raw)
        pos = 1 + body[0]                            # certificate context
        list_end = pos + 3 + int.from_bytes(body[pos:pos + 3], "big")
        pos += 3
        chain = []
        while pos + 3 <= list_end:
            ln = int.from_bytes(body[pos:pos + 3], "big")
            chain.append(
                x509.load_der_x509_certificate(body[pos + 3:pos + 3 + ln]))
            pos += 3 + ln
            elen = struct.unpack(">H", body[pos:pos + 2])[0]
            pos += 2 + elen                          # per-entry extensions
        if not chain:
            raise TlsError("empty certificate chain", 42)
        self._server_cert = chain[0]
        if self._cafile:
            self._verify_chain(chain)

    @staticmethod
    def _is_ca(cert) -> bool:
        """RFC 5280 §4.2.1.9/.3: a cert may act as an issuer only with
        basicConstraints CA=true and (when KeyUsage is present)
        keyCertSign. Without this check any holder of an ordinary
        end-entity cert from a trusted CA could sign a fake leaf for an
        arbitrary hostname and MITM the connection."""
        from cryptography import x509
        try:
            bc = cert.extensions.get_extension_for_class(
                x509.BasicConstraints).value
            if not bc.ca:
                return False
        except x509.ExtensionNotFound:
            return False
        try:
            ku = cert.extensions.get_extension_for_class(
                x509.KeyUsage).value
            if not ku.key_cert_sign:
                return False
        except x509.ExtensionNotFound:
            pass
        return True

    def _verify_chain(self, chain: list) -> None:
        """Leaf -> (intermediates) -> trusted CA, plus validity period,
        intermediate CA constraints (basicConstraints/keyUsage) and
        hostname (SAN dNSName, wildcard leftmost label; CN fallback)."""
        import datetime

        from cryptography import x509
        with open(self._cafile, "rb") as f:
            cas = x509.load_pem_x509_certificates(f.read())
        now = datetime.datetime.now(datetime.timezone.utc)
        for cert in chain:
            if not (cert.not_valid_before_utc <= now
                    <= cert.not_valid_after_utc):
                raise TlsError("certificate outside validity period", 45)
        # walk up: each link verified by the next chain entry or a root;
        # wire-supplied intermediates must satisfy the CA constraints
        cur = chain[0]
        rest = chain[1:]
        trusted = False
        for _ in range(len(chain) + 1):
            for ca in cas:
                try:
                    cur.verify_directly_issued_by(ca)
                    trusted = True
                    break
                except Exception:  # noqa: BLE001
                    continue
            if trusted:
                break
            nxt = None
            for cand in rest:
                if not self._is_ca(cand):
                    continue
                try:
                    cur.verify_directly_issued_by(cand)
                    nxt = cand
                    break
                except Exception:  # noqa: BLE001
                    continue
            if nxt is None:
                break
            cur = nxt
            rest = [c for c in rest if c is not nxt]
        if not trusted:
            raise TlsError("server certificate not issued by trusted CA",
                           42)
        # hostname check OUTSIDE the issuer-probe try blocks — its
        # TlsError must surface, not read as an issuer mismatch
        self._check_hostname(chain[0])

    def _check_hostname(self, leaf) -> None:
        if not self.server_name:
            return
        from cryptography import x509
        from cryptography.x509.oid import NameOID
        names: list[str] = []
        try:
            san = leaf.extensions.get_extension_for_class(
                x509.SubjectAlternativeName).value
            names = list(san.get_values_for_type(x509.DNSName)) + \
                [str(ip) for ip in san.get_values_for_type(x509.IPAddress)]
        except x509.ExtensionNotFound:
            cn = leaf.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
            names = [cn[0].value] if cn else []
        want = self.server_name.lower()
        for name in names:
            n = name.lower()
            if n == want:
                return
            if n.startswith("*.") and "." in want and \
                    want.split(".", 1)[1] == n[2:]:
                return
        raise TlsError(
            f"hostname {self.server_name!r} not in certificate "
            f"({names})", 42)

    def _on_cert_verify(self, body: bytes, raw: bytes) -> None:
        alg = struct.unpack_from(">H", body, 0)[0]
        sig_len = struct.unpack_from(">H", body, 2)[0]
        sig = body[4:4 + sig_len]
        content = self._cv_content(self._th(), server=True)
        pub = self._server_cert.public_key()
        try:
            if alg == SIG_RSA_PSS_SHA256:
                pub.verify(
                    sig, content,
                    padding.PSS(mgf=padding.MGF1(hashes.SHA256()),
                                salt_length=hashes.SHA256.digest_size),
                    hashes.SHA256())
            elif alg == SIG_ECDSA_P256_SHA256:
                pub.verify(sig, content, ec.ECDSA(hashes.SHA256()))
            else:
                raise TlsError(f"unsupported signature alg {alg:#x}", 47)
        except TlsError:
            raise
        except Exception as e:  # noqa: BLE001
            raise TlsError(f"CertificateVerify failed: {e}", 42)
        self.transcript.update(raw)

    def _on_server_finished(self, body: bytes, raw: bytes) -> None:
        expect = self._finished_mac(self._server_hs, self._th())
        if not hmac.compare_digest(body, expect):
            raise TlsError("bad server Finished", 51)
        self.transcript.update(raw)
        self._derive_app()
        fin = _hs_msg(HT_FINISHED,
                      self._finished_mac(self._client_hs, self._th()))
        self.transcript.update(fin)
        self._send(HANDSHAKE, fin)
        self.complete = True
