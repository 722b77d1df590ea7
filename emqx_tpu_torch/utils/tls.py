"""TLS helpers: listener/client SSLContext construction + peer-cert info.

Parity: apps/emqx/src/emqx_tls_lib.erl (version/cipher selection) and the
listener ssl option blocks of emqx_schema.erl / emqx_listeners.erl:126-138
(certfile/keyfile/cacertfile/verify/fail_if_no_peer_cert). The reference
rides Erlang's ssl app; here the asyncio TLS transport consumes a stdlib
`ssl.SSLContext` built from the same option names.

The port's copy of ``emqx_tpu/utils/tls.py``. ``generate_self_signed``
imports ``cryptography`` when it is called, as the reference does; a host
without it makes its certificates another way (``openssl``).
"""

from __future__ import annotations

import ssl
from typing import Optional

_VERSION_MAP = {
    "tlsv1.2": ssl.TLSVersion.TLSv1_2,
    "tlsv1.3": ssl.TLSVersion.TLSv1_3,
}


def _apply_versions(ctx: ssl.SSLContext, versions) -> None:
    if not versions:
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        return
    vs = [_VERSION_MAP[v.lower()] for v in versions if v.lower()
          in _VERSION_MAP]
    if vs:
        ctx.minimum_version = min(vs)
        ctx.maximum_version = max(vs)


def make_server_context(opts: dict) -> ssl.SSLContext:
    """Listener ssl options -> server SSLContext.

    opts keys (emqx_schema ssl block names): certfile, keyfile, password,
    cacertfile, verify ('verify_none' | 'verify_peer'),
    fail_if_no_peer_cert, versions (['tlsv1.2','tlsv1.3']), ciphers.
    """
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(opts["certfile"], opts.get("keyfile"),
                        password=opts.get("password"))
    _apply_versions(ctx, opts.get("versions"))
    if opts.get("ciphers"):
        ctx.set_ciphers(":".join(opts["ciphers"])
                        if isinstance(opts["ciphers"], list)
                        else opts["ciphers"])
    if opts.get("cacertfile"):
        ctx.load_verify_locations(opts["cacertfile"])
    if opts.get("verify") == "verify_peer":
        # fail_if_no_peer_cert=false maps to OPTIONAL client certs
        ctx.verify_mode = (ssl.CERT_REQUIRED
                           if opts.get("fail_if_no_peer_cert")
                           else ssl.CERT_OPTIONAL)
    else:
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


def make_client_context(opts: Optional[dict] = None) -> ssl.SSLContext:
    """Client-side context (MQTT bridge egress, test clients)."""
    opts = opts or {}
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    _apply_versions(ctx, opts.get("versions"))
    if opts.get("cacertfile"):
        ctx.load_verify_locations(opts["cacertfile"])
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.check_hostname = bool(opts.get("server_name_indication", False))
    else:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    if opts.get("certfile"):
        ctx.load_cert_chain(opts["certfile"], opts.get("keyfile"),
                            password=opts.get("password"))
    return ctx


def peer_cert_info(transport_or_writer) -> Optional[dict]:
    """Extract the client certificate (dict form) from a TLS transport.

    Returns None on plain TCP or when no client cert was presented.
    Used by the channel for peer_cert_as_username/clientid
    (emqx_channel peer-cert enrichment; emqx_schema.erl zone opts).
    """
    get = getattr(transport_or_writer, "get_extra_info", None)
    if get is None:
        return None
    cert = get("peercert")
    if not cert:
        return None
    out = {"raw": cert}
    for rdn in cert.get("subject", ()):  # ((('commonName','x'),), ...)
        for k, v in rdn:
            out.setdefault(k, v)
    return out


def cert_field(info: Optional[dict], source: str) -> Optional[str]:
    """Map a peer_cert_as_* source to a value: 'cn' | 'dn'."""
    if not info:
        return None
    if source == "cn":
        return info.get("commonName")
    if source == "dn":
        subj = info.get("raw", {}).get("subject", ())
        return ",".join(f"{k}={v}" for rdn in subj for k, v in rdn)
    return None


# ---- self-signed material (dev listeners + test suites) -----------------

def generate_self_signed(dirpath: str, cn: str = "emqx-tpu",
                         *, ca_cn: str = "emqx-tpu-ca",
                         client_cn: Optional[str] = None) -> dict:
    """Write a CA + server cert (+ optional client cert) under `dirpath`.

    Returns {'cacertfile', 'certfile', 'keyfile'[, 'client_certfile',
    'client_keyfile']}. Test-suite parity: the reference ships static
    certs in apps/emqx/etc/certs; here they are generated on demand.
    """
    import datetime
    import os

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    os.makedirs(dirpath, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)

    def _key():
        return rsa.generate_private_key(public_exponent=65537, key_size=2048)

    def _name(common):
        return x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, common)])

    def _write(path, data):
        with open(os.path.join(dirpath, path), "wb") as f:
            f.write(data)
        return os.path.join(dirpath, path)

    def _pem_key(k):
        return k.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption())

    ca_key = _key()
    ca_cert = (x509.CertificateBuilder()
               .subject_name(_name(ca_cn)).issuer_name(_name(ca_cn))
               .public_key(ca_key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now - datetime.timedelta(days=1))
               .not_valid_after(now + datetime.timedelta(days=365))
               .add_extension(x509.BasicConstraints(ca=True,
                                                    path_length=None),
                              critical=True)
               .sign(ca_key, hashes.SHA256()))
    out = {"cacertfile": _write("ca.pem", ca_cert.public_bytes(
        serialization.Encoding.PEM))}

    def _issue(common, keyfile, certfile, san_localhost=False):
        k = _key()
        builder = (x509.CertificateBuilder()
                   .subject_name(_name(common)).issuer_name(_name(ca_cn))
                   .public_key(k.public_key())
                   .serial_number(x509.random_serial_number())
                   .not_valid_before(now - datetime.timedelta(days=1))
                   .not_valid_after(now + datetime.timedelta(days=365)))
        if san_localhost:
            import ipaddress
            builder = builder.add_extension(
                x509.SubjectAlternativeName(
                    [x509.DNSName("localhost"),
                     x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
                critical=False)
        cert = builder.sign(ca_key, hashes.SHA256())
        return (_write(keyfile, _pem_key(k)),
                _write(certfile, cert.public_bytes(
                    serialization.Encoding.PEM)))

    out["keyfile"], out["certfile"] = _issue(cn, "server.key", "server.pem",
                                             san_localhost=True)
    if client_cn:
        out["client_keyfile"], out["client_certfile"] = _issue(
            client_cn, "client.key", "client.pem")
    return out
