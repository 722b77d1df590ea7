"""Port vs JAX reference: MQTT over QUIC (``emqx_tpu_torch/quic/``).

A twin of every test in ``tests/test_quic.py``. Where the inputs are
fixed (varints, RFC 9001 initial secrets and keys, protected packets,
frames, the Retry integrity tag, transport parameters) the port's bytes
must equal the reference's. Where a key or a secret is random
(handshakes, refusals, deliveries) the outcomes must be equal: the same
scenario runs once through each package and the two results compare
equal. Interop runs both ways (the port's client against the reference's
listener and the reference's client against the port's), and one
transfer of more than ``CONN_WINDOW`` over one stream runs in each
package on a clean path and on one that drops every 20th datagram. The
nodes are host-only (``use_device=False`` / ``device_route: false`` on
``device="cpu"``); every scenario runs under a deadline.
"""

import asyncio
import hashlib
import time
import types

import pytest
import torch

from emqx_tpu import client as jclient
from emqx_tpu.broker.node import Node as JNode
from emqx_tpu.mqtt import constants as JC
from emqx_tpu.quic import client as jqclient
from emqx_tpu.quic import connection as jqc
from emqx_tpu.quic import frames as jF
from emqx_tpu.quic import packet as jP
from emqx_tpu.quic import tls13 as jT
from emqx_tpu.utils.tls import generate_self_signed
from emqx_tpu_torch import client as tclient
from emqx_tpu_torch.broker.node import Node as TNode
from emqx_tpu_torch.mqtt import constants as TC
from emqx_tpu_torch.quic import client as tqclient
from emqx_tpu_torch.quic import connection as tqc
from emqx_tpu_torch.quic import frames as tF
from emqx_tpu_torch.quic import packet as tP
from emqx_tpu_torch.quic import tls13 as tT

torch.set_num_threads(1)

TIMEOUT_S = 30
BIG_BYTES = (4 << 20) + (1 << 19)       # past CONN_WINDOW (4 MiB)

REF = types.SimpleNamespace(
    F=jF, QC=jqc,
    QuicClientConnection=jqclient.QuicClientConnection,
    QuicListener=jqc.QuicListener, Client=jclient.Client, C=JC,
    node=lambda: JNode(use_device=False),
    node_from_file=lambda p: JNode.from_config_file(p, use_device=False))
PORT = types.SimpleNamespace(
    F=tF, QC=tqc,
    QuicClientConnection=tqclient.QuicClientConnection,
    QuicListener=tqc.QuicListener, Client=tclient.Client, C=TC,
    node=lambda: TNode({"broker": {"device_route": False}}, device="cpu"),
    node_from_file=lambda p: TNode.from_config_file(p, device="cpu"))
PKGS = (REF, PORT)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return generate_self_signed(str(tmp_path_factory.mktemp("quic-certs")))


def run(coro, timeout=TIMEOUT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def both(scenario, *args, timeout=TIMEOUT_S):
    """The scenario's result through the reference, then the port."""
    return [run(scenario(pkg, *args), timeout) for pkg in PKGS]


async def _pair(qc):
    return qc.open_stream()


async def _listener(pkg, certs, node=None, **kw):
    lst = pkg.QuicListener(node if node is not None else pkg.node(),
                           bind="127.0.0.1", port=0,
                           certfile=certs["certfile"],
                           keyfile=certs["keyfile"], **kw)
    await asyncio.wait_for(lst.start(), 5)
    return lst


async def _dial(pkg, lst, **kw):
    kw.setdefault("verify", "none")
    qc = pkg.QuicClientConnection(port=lst.port, **kw)
    await asyncio.wait_for(qc.connect(), 10)
    return qc


def _frames(out) -> list:
    """Parsed frames as (type name, fields): comparable across packages."""
    return [(type(f).__name__, tuple(f)) for f in out]


# ---------- codec units: byte equality ----------

@pytest.mark.parametrize("v", [0, 1, 63, 64, 16383, 16384, (1 << 30) - 1,
                               1 << 30, (1 << 62) - 1])
def test_varint_equals_reference(v):
    enc = tP.enc_varint(v)
    assert enc == jP.enc_varint(v)
    assert tP.dec_varint(enc, 0) == jP.dec_varint(enc, 0) == (v, len(enc))


def test_rfc9001_initial_secrets_equal_reference():
    dcid = bytes.fromhex("8394c8f03e515708")
    c, s = tP.initial_secrets(dcid)
    assert (c, s) == jP.initial_secrets(dcid)
    assert c.hex() == ("c00cf151ca5be075ed0ebfb5c80323c4"
                       "2d6b7db67881289af4008f1f6c357aea")
    assert s.hex() == ("3c199828fd139efd216c155ad844cc81"
                       "fb82fa8d7446fa7d78be803acdda951b")
    for secret in (c, s):
        tk, jk = tP.derive_keys(secret), jP.derive_keys(secret)
        assert (tk.iv, tk.hp) == (jk.iv, jk.hp)
        assert tk.aead.encrypt(jk.iv, b"sealed", b"ad") == \
            jk.aead.encrypt(jk.iv, b"sealed", b"ad")
        assert tT.hkdf_expand_label(secret, "quic key", b"", 16) == \
            jT.hkdf_expand_label(secret, "quic key", b"", 16)
    assert tT.hkdf_expand_label(c, "quic key", b"", 16).hex() == \
        "1f369613dd76d5467730efcbe3b1a22d"
    keys = tP.derive_keys(c)
    assert keys.iv.hex() == "fa044b2f42a3fd3b46fb255c"
    assert keys.hp.hex() == "9f50449e04a0e810283a1e9933adedd2"


@pytest.mark.parametrize("ptype", [tP.PT_INITIAL, tP.PT_HANDSHAKE,
                                   tP.PT_ONE_RTT])
def test_packet_protection_equals_reference(ptype):
    c, _s = tP.initial_secrets(b"\x01" * 8)
    tkeys, jkeys = tP.derive_keys(c), jP.derive_keys(c)
    dcid, scid = b"\xaa" * 8, b"\xbb" * 8
    payload = b"\x01" + b"\x00" * 40
    token = b"tok" if ptype == tP.PT_INITIAL else b""
    raw = tP.encode_packet(ptype, tP.QUIC_V1, dcid, scid, 7, payload,
                           tkeys, token=token)
    assert raw == jP.encode_packet(ptype, jP.QUIC_V1, dcid, scid, 7,
                                   payload, jkeys, token=token)
    hdr = tP.peek_header(raw, 0, 8)
    assert hdr == jP.peek_header(raw, 0, 8)
    pt, got_dcid, got_scid, _tok, pn_off, end = hdr
    assert pt == ptype and got_dcid == dcid
    if ptype != tP.PT_ONE_RTT:
        assert got_scid == scid
    # each package opens the other's packet
    pkt = tP.decode_packet(raw, 0, pt, pn_off, end, tkeys, -1)
    ref = jP.decode_packet(raw, 0, pt, pn_off, end, jkeys, -1)
    assert (pkt.pn, pkt.payload) == (ref.pn, ref.payload) == (7, payload)


def test_tampered_packet_rejected_in_both():
    c, _ = tP.initial_secrets(b"\x02" * 8)
    raw = bytearray(tP.encode_packet(tP.PT_ONE_RTT, tP.QUIC_V1,
                                     b"\xcc" * 8, b"", 1,
                                     b"\x01" + b"\x00" * 30,
                                     tP.derive_keys(c)))
    raw[-1] ^= 0xFF
    pt, _dcid, _, _, pn_off, end = tP.peek_header(bytes(raw), 0, 8)
    for P in (tP, jP):
        with pytest.raises(P.PacketError):
            P.decode_packet(bytes(raw), 0, pt, pn_off, end,
                            P.derive_keys(c), -1)


def _frame_payload(F) -> bytes:
    return (F.encode_crypto(5, b"CRYPTO")
            + F.encode_stream(4, 10, b"DATA", fin=True)
            + F.encode_ack(9, [(7, 9), (2, 4)])
            + F.encode_close(3, "bye", app=True)
            + F.encode_handshake_done()
            + F.encode_max_data(1 << 22)
            + F.encode_max_stream_data(4, 1 << 20)
            + bytes([F.FT_PING]))


def test_frames_equal_reference():
    payload = _frame_payload(tF)
    assert payload == _frame_payload(jF)
    out = tF.parse_frames(payload)
    assert _frames(out) == _frames(jF.parse_frames(payload))
    assert tuple(next(f for f in out if isinstance(f, tF.Crypto))) == \
        (5, b"CRYPTO")
    assert tuple(next(f for f in out if isinstance(f, tF.Stream))) == \
        (4, 10, b"DATA", True)
    ack = next(f for f in out if isinstance(f, tF.Ack))
    assert ack.largest == 9 and ack.ranges == [(7, 9), (2, 4)]


def test_unknown_frame_raises_in_both():
    for F in (tF, jF):
        with pytest.raises(F.FrameError):
            F.parse_frames(bytes([0x3F]))


def test_transport_params_equal_reference():
    params = {tP.TP_ORIGINAL_DCID: b"\x11" * 8,
              tP.TP_INITIAL_SCID: b"\x22" * 8,
              tP.TP_MAX_IDLE_TIMEOUT: tP.enc_varint(30000),
              tP.TP_MAX_UDP_PAYLOAD: tP.enc_varint(1350),
              tP.TP_MAX_DATA: tP.enc_varint(tqc.CONN_WINDOW),
              tP.TP_MAX_STREAM_DATA_BIDI_LOCAL:
                  tP.enc_varint(tqc.STREAM_WINDOW),
              tP.TP_MAX_STREAMS_BIDI: tP.enc_varint(16),
              tP.TP_RETRY_SCID: b"\x33" * 8}
    enc = tP.encode_transport_params(params)
    assert enc == jP.encode_transport_params(params)
    assert tP.decode_transport_params(enc) == \
        jP.decode_transport_params(enc)


def test_constants_equal_reference():
    names = ("CID_LEN", "MAX_DATAGRAM", "STREAM_WINDOW", "CONN_WINDOW",
             "MAX_STREAMS_BIDI", "CRYPTO_BUFFER_MAX", "PTO_S",
             "IDLE_TIMEOUT_S", "INITIAL_CWND", "MIN_CWND",
             "LOSS_PN_THRESHOLD", "AMPLIFICATION_LIMIT")
    assert [getattr(tqc, n) for n in names] == \
        [getattr(jqc, n) for n in names]


def test_retry_integrity_tag_equals_reference():
    odcid = b"\x11" * 8
    retry = tP.encode_retry(tP.QUIC_V1, b"\xaa" * 8, b"\xbb" * 8, odcid,
                            b"tok")
    assert retry == jP.encode_retry(jP.QUIC_V1, b"\xaa" * 8, b"\xbb" * 8,
                                    odcid, b"tok")
    bad = bytearray(retry)
    bad[-20] ^= 0xFF
    for P in (tP, jP):
        assert P.decode_retry(retry, odcid) == (b"\xbb" * 8, b"tok")
        assert P.decode_retry(retry, b"\x22" * 8) is None
        assert P.decode_retry(bytes(bad), odcid) is None


# ---------- the TLS 1.3 engine: equal outcomes ----------

def _handshake(T, certs, cafile=None, server_name="localhost",
               srv_cls=None, cli_cls=None):
    """A server of `srv_cls` against a client of `cli_cls` (both T's by
    default): CRYPTO data exchanged in memory."""
    tp = b"\x01\x01\x05"
    srv = (srv_cls or T.Tls13Server)(certs["certfile"], certs["keyfile"],
                                     ["mqtt"], tp)
    cli = (cli_cls or T.Tls13Client)(
        server_name, ["mqtt"], tp, cafile=cafile,
        verify="required" if cafile else "none")
    cli.start()
    for _ in range(4):
        if srv.complete and cli.complete:
            break
        for lvl, d in cli.pending:
            srv.feed_crypto(lvl, d)
        cli.pending.clear()
        for lvl, d in srv.pending:
            cli.feed_crypto(lvl, d)
        srv.pending.clear()
    return srv, cli


def _outcome(fn):
    """What a call raised (type name, message, alert) or returned."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001
        return (type(e).__name__, str(e), getattr(e, "alert", None))


@pytest.mark.parametrize("pair", ["port", "port-server", "port-client"])
def test_tls13_handshake_secrets_agree(certs, pair):
    """The port with itself and with the reference on either side: both
    ends complete with equal secrets, ALPN and transport parameters."""
    srv_cls = jT.Tls13Server if pair == "port-client" else tT.Tls13Server
    cli_cls = jT.Tls13Client if pair == "port-server" else tT.Tls13Client
    srv, cli = _handshake(tT, certs, cafile=certs["cacertfile"],
                          srv_cls=srv_cls, cli_cls=cli_cls)
    assert srv.complete and cli.complete
    assert srv.secrets[tT.HANDSHAKE] == cli.secrets[tT.HANDSHAKE]
    assert srv.secrets[tT.APPLICATION] == cli.secrets[tT.APPLICATION]
    assert srv.alpn == cli.alpn == "mqtt"
    assert srv.peer_transport_params == b"\x01\x01\x05"


def test_untrusted_ca_refused_as_reference(certs, tmp_path):
    other = generate_self_signed(str(tmp_path / "other"), ca_cn="evil-ca")
    got = [_outcome(lambda T=T: _handshake(T, certs,
                                           cafile=other["cacertfile"]))
           for T in (jT, tT)]
    assert got[0][0] == "TlsError" and got[1] == got[0]


def test_hostname_mismatch_refused_as_reference(certs):
    got = [_outcome(lambda T=T: _handshake(
        T, certs, cafile=certs["cacertfile"],
        server_name="evil.example.com")) for T in (jT, tT)]
    assert got[0][0] == "TlsError" and "hostname" in got[0][1]
    assert got[1] == got[0]


def test_ip_san_accepted_as_reference(certs):
    for T in (jT, tT):
        _srv, cli = _handshake(T, certs, cafile=certs["cacertfile"],
                               server_name="127.0.0.1")
        assert cli.complete


def test_no_common_alpn_refused_as_reference(certs):
    def go(T):
        srv = T.Tls13Server(certs["certfile"], certs["keyfile"], ["mqtt"],
                            b"\x01\x01\x05")
        cli = T.Tls13Client("x", ["h3"], b"\x01\x01\x05", verify="none")
        cli.start()
        for lvl, d in cli.pending:
            srv.feed_crypto(lvl, d)
    got = [_outcome(lambda T=T: go(T)) for T in (jT, tT)]
    assert got[0][0] == "TlsError" and got[1] == got[0]


# ---------- end-to-end MQTT over QUIC: equal outcomes ----------

async def _connect_sub_pub(pkg, certs):
    node = pkg.node()
    lst = await _listener(pkg, certs, node)
    qc = await _dial(pkg, lst, verify="required",
                     cafile=certs["cacertfile"])
    c = pkg.Client(clientid="q1", proto_ver=pkg.C.MQTT_V5,
                   conn_factory=lambda: _pair(qc))
    ack = await c.connect()
    await c.subscribe("quic/t", qos=1)
    pub = await c.publish("quic/t", b"payload-q", qos=1)
    m = await c.recv(timeout=10)
    await c.publish("quic/t", b"q0", qos=0)
    m0 = await c.recv(timeout=10)
    await asyncio.wait_for(c.disconnect(), 5)
    qc.close(0, "done", app=True)
    await asyncio.wait_for(lst.stop(), 5)
    return {"alpn": qc.tls.alpn, "connack": ack.reason_code,
            "puback": pub.reason_code, "got": [(m.topic, m.payload, m.qos),
                                               (m0.topic, m0.payload)],
            "connected": node.metrics.val("client.connected")}


def test_connect_sub_pub_equals_reference(certs):
    want, got = both(_connect_sub_pub, certs)
    assert got == want
    assert got["connack"] == 0 and got["connected"] == 1


async def _two_connections(pkg, certs):
    lst = await _listener(pkg, certs)
    qa, qb = await _dial(pkg, lst), await _dial(pkg, lst)
    conns = lst.current_conns
    sub = pkg.Client(clientid="qsub", conn_factory=lambda: _pair(qa))
    await sub.connect()
    await sub.subscribe("qq/#")
    # a second MQTT session on another stream of the same connection
    sub2 = pkg.Client(clientid="qsub2", conn_factory=lambda: _pair(qa))
    await sub2.connect()
    await sub2.subscribe("qq/2")
    pub = pkg.Client(clientid="qpub", conn_factory=lambda: _pair(qb))
    await pub.connect()
    await pub.publish("qq/2", b"fanout")
    got = [(await sub.recv(timeout=10)).payload,
           (await sub2.recv(timeout=10)).payload]
    for c in (sub, sub2, pub):
        await asyncio.wait_for(c.disconnect(), 5)
    qa.close(0, "", app=True)
    qb.close(0, "", app=True)
    for _ in range(200):
        if lst.current_conns == 0:
            break
        await asyncio.sleep(0.01)
    left = lst.current_conns
    await asyncio.wait_for(lst.stop(), 5)
    return {"conns": conns, "got": got, "left": left}


def test_two_connections_and_streams_equal_reference(certs):
    want, got = both(_two_connections, certs)
    assert got == want == {"conns": 2, "got": [b"fanout", b"fanout"],
                           "left": 0}


async def _large_payload(pkg, certs):
    lst = await _listener(pkg, certs)
    qc = await _dial(pkg, lst)
    c = pkg.Client(clientid="qbig", conn_factory=lambda: _pair(qc))
    await c.connect()
    await c.subscribe("big/t", qos=1)
    payload = bytes(range(256)) * 256        # 64 KiB
    await c.publish("big/t", payload, qos=1)
    m = await c.recv(timeout=15)
    await asyncio.wait_for(c.disconnect(), 5)
    qc.close(0, "", app=True)
    await asyncio.wait_for(lst.stop(), 5)
    return hashlib.sha256(m.payload).hexdigest()


def test_large_payload_fragmentation_equals_reference(certs):
    want, got = both(_large_payload, certs)
    assert got == want == hashlib.sha256(
        bytes(range(256)) * 256).hexdigest()


async def _flow_control(pkg, certs):
    lst = await _listener(pkg, certs)
    qc = await _dial(pkg, lst)
    c = pkg.Client(clientid="qfc", conn_factory=lambda: _pair(qc))
    await c.connect()
    await c.subscribe("fc/t", qos=1)
    payload = b"F" * 20000          # 5x the stream window
    await c.publish("fc/t", payload, qos=1, timeout=20)
    m = await c.recv(timeout=20)
    await asyncio.wait_for(c.disconnect(), 5)
    qc.close(0, "", app=True)
    await asyncio.wait_for(lst.stop(), 5)
    return len(m.payload), m.payload == payload


def test_flow_control_replenishes_equals_reference(certs, monkeypatch):
    """A 4 KiB stream window: the 20,000-byte PUBLISH stalls on the
    advertised limit and resumes on MAX_STREAM_DATA credit, in both."""
    for QC in (jqc, tqc):
        monkeypatch.setattr(QC, "STREAM_WINDOW", 4096)
        monkeypatch.setattr(QC, "CONN_WINDOW", 16384)
    want, got = both(_flow_control, certs, timeout=40)
    assert got == want == (20000, True)


async def _idle_reap(pkg, certs):
    lst = await _listener(pkg, certs)
    qc = await _dial(pkg, lst)
    before = lst.current_conns
    qc.transport.close()            # the client goes silent
    qc.transport = None
    for _ in range(300):
        if lst.current_conns == 0:
            break
        await asyncio.sleep(0.01)
    after = lst.current_conns
    await asyncio.wait_for(lst.stop(), 5)
    return before, after


def test_idle_timeout_reaps_connection_as_reference(certs, monkeypatch):
    for QC in (jqc, tqc):
        monkeypatch.setattr(QC, "IDLE_TIMEOUT_S", 0.3)
        monkeypatch.setattr(QC, "PTO_S", 0.05)
    want, got = both(_idle_reap, certs)
    assert got == want == (1, 0)


async def _from_config(pkg, path):
    node = pkg.node_from_file(path)
    [lst] = await asyncio.wait_for(node.start_listeners(), 5)
    qc = await _dial(pkg, lst)
    c = pkg.Client(clientid="qc", conn_factory=lambda: _pair(qc))
    ack = await c.connect()
    await asyncio.wait_for(c.disconnect(), 5)
    qc.close(0, "", app=True)
    await asyncio.wait_for(node.stop_listeners(), 5)
    batcher = getattr(node, "publish_batcher", None)
    if batcher is not None:
        await batcher.stop()
        batcher.close()
    return type(lst).__name__, lst.protocol, ack.reason_code


def test_quic_listener_from_config_equals_reference(certs, tmp_path):
    conf = tmp_path / "emqx.conf"
    conf.write_text(
        'listeners.q { type = quic, bind = "127.0.0.1", port = 0\n'
        f'  ssl {{ certfile = "{certs["certfile"]}", '
        f'keyfile = "{certs["keyfile"]}" }} }}\n')
    want, got = both(_from_config, str(conf))
    assert got == want == ("QuicListener", "mqtt:quic", 0)


@pytest.mark.parametrize("ssl_block", ["", "ssl { certfile = \"c.pem\" }"])
def test_quic_listener_without_keys_raises_as_reference(tmp_path,
                                                         ssl_block):
    conf = tmp_path / "emqx.conf"
    conf.write_text(f"listeners.q {{ type = quic, port = 0\n{ssl_block} }}\n")

    async def go(pkg):
        node = pkg.node_from_file(str(conf))
        with pytest.raises(ValueError) as e:
            await node.start_listeners()
        await node.stop_listeners()
        return str(e.value)
    want, got = both(go)
    assert got == want == "quic listener 'q' needs ssl.certfile and " \
                          "ssl.keyfile"


# ---------- certificate chains ----------

def _mk_chain(tmp_path):
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    now = datetime.datetime.now(datetime.timezone.utc)

    def key():
        return ec.generate_private_key(ec.SECP256R1())

    def name(cn):
        return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])

    def build(cn, issuer_cn, pubkey, signer, ca=None, san=None):
        b = (x509.CertificateBuilder()
             .subject_name(name(cn)).issuer_name(name(issuer_cn))
             .public_key(pubkey)
             .serial_number(x509.random_serial_number())
             .not_valid_before(now - datetime.timedelta(days=1))
             .not_valid_after(now + datetime.timedelta(days=30)))
        if ca is not None:
            b = b.add_extension(
                x509.BasicConstraints(ca=ca, path_length=None),
                critical=True)
        if san:
            b = b.add_extension(x509.SubjectAlternativeName(
                [x509.DNSName(san)]), critical=False)
        return b.sign(signer, hashes.SHA256())

    ca_key, ee_key, fake_key = key(), key(), key()
    inter_key, leaf_key = key(), key()
    ca = build("test-ca", "test-ca", ca_key.public_key(), ca_key, ca=True)
    ee = build("victim-ee", "test-ca", ee_key.public_key(), ca_key,
               ca=False, san="victim.example")
    fake = build("localhost", "victim-ee", fake_key.public_key(), ee_key,
                 san="localhost")
    inter = build("test-inter", "test-ca", inter_key.public_key(), ca_key,
                  ca=True)
    leaf = build("localhost", "test-inter", leaf_key.public_key(),
                 inter_key, san="localhost")
    cafile = str(tmp_path / "ca.pem")
    with open(cafile, "wb") as f:
        f.write(ca.public_bytes(serialization.Encoding.PEM))
    return cafile, fake, ee, leaf, inter


def test_chain_checks_equal_reference(tmp_path):
    """An end-entity certificate is no issuer; a real intermediate is."""
    cafile, fake, ee, leaf, inter = _mk_chain(tmp_path)
    got = {}
    for T in (jT, tT):
        cli = T.Tls13Client("localhost", ["mqtt"], b"", cafile=cafile)
        got[T.__name__] = (_outcome(lambda: cli._verify_chain([fake, ee])),
                           _outcome(lambda: cli._verify_chain([leaf,
                                                               inter])))
    want, port = got.values()
    assert port == want
    assert want[0][0] == "TlsError" and want[1] == ("ok", None)


async def _verify_by_default(pkg, certs):
    lst = await _listener(pkg, certs)
    qc = pkg.QuicClientConnection(port=lst.port)
    try:
        await qc.connect(timeout=5)
        out = "connected"
    except Exception as e:  # noqa: BLE001
        out = type(e).__name__
    finally:
        qc.close(0, "", app=True)
        await asyncio.wait_for(lst.stop(), 5)
    return out


def test_verify_required_by_default_as_reference(certs):
    want, got = both(_verify_by_default, certs)
    assert got == want != "connected"


def test_verify_mode_validated_as_reference():
    got = [_outcome(lambda T=T: T.Tls13Client("x", [], b"", verify="maybe"))
           for T in (jT, tT)]
    assert got[0][0] == "ValueError" and got[1] == got[0]


# ---------- hardening ----------

async def _retry(pkg, certs):
    lst = await _listener(pkg, certs, retry=True)
    qc = await _dial(pkg, lst)
    c = pkg.Client(clientid="qr", conn_factory=lambda: _pair(qc))
    ack = await c.connect()
    await asyncio.wait_for(c.disconnect(), 5)
    qc.close(0, "", app=True)
    await asyncio.wait_for(lst.stop(), 5)
    return qc._saw_retry, len(qc.initial_token), ack.reason_code


def test_retry_roundtrip_equals_reference(certs):
    want, got = both(_retry, certs)
    assert got == want and got[0] and got[1] and got[2] == 0


async def _token(pkg, certs):
    lst = await _listener(pkg, certs, retry=True)
    tok = lst._mint_token(b"\x01" * 8, ("10.0.0.1", 1234))
    out = (lst._check_token(tok, ("10.0.0.1", 9)),
           lst._check_token(tok, ("10.0.0.2", 9)),
           lst._check_token(tok[:-1], ("10.0.0.1", 9)), len(tok))
    await asyncio.wait_for(lst.stop(), 5)
    return out


def test_token_bound_to_address_as_reference(certs):
    want, got = both(_token, certs)
    assert got == want == (b"\x01" * 8, None, None, 9 + 8 + 16)


async def _amplification(pkg, certs):
    lst = await _listener(pkg, certs)
    sent, grabbed = [], []

    class FakeTransport:
        def sendto(self, data, addr=None):
            sent.append(len(data))

        def get_extra_info(self, *a, **k):
            return ("127.0.0.1", 0)

        def close(self):
            pass

    class Grab:
        def sendto(self, data, addr=None):
            grabbed.append(data)

    qc = pkg.QuicClientConnection(port=1, verify="none")
    qc.transport = Grab()
    qc.tls.start()
    qc._pump_tls()
    qc.flush()
    rx = sum(len(g) for g in grabbed)
    real = lst._transport
    lst._transport = FakeTransport()
    for g in grabbed:
        lst._on_datagram(g, ("198.51.100.7", 4433))
    lst._transport = real
    await asyncio.wait_for(lst.stop(), 5)
    return len(grabbed), rx, bool(sent), sum(sent) <= 3 * rx


def test_anti_amplification_cap_as_reference(certs):
    want, got = both(_amplification, certs)
    assert got[2:] == want[2:] == (True, True)
    assert got[:2] == want[:2]


async def _spoof(pkg, certs):
    lst = await _listener(pkg, certs)
    qc = await _dial(pkg, lst)
    [conn] = set(lst._conns.values())
    good = conn.addr
    lst._on_datagram(bytes([0x40]) + conn.dcid + b"\x00" * 32,
                     ("203.0.113.9", 1))
    moved = conn.addr != good
    qc.close(0, "", app=True)
    await asyncio.wait_for(lst.stop(), 5)
    return moved


def test_spoofed_datagram_cannot_move_address_as_reference(certs):
    assert both(_spoof, certs) == [False, False]


async def _flow_violation(pkg, certs, frame_fn):
    lst = await _listener(pkg, certs)
    qc = await _dial(pkg, lst)
    [conn] = set(lst._conns.values())
    conn._on_stream_frame(frame_fn(pkg))
    out = conn.closed, conn.close_reason
    qc.close(0, "", app=True)
    await asyncio.wait_for(lst.stop(), 5)
    return out


def test_stream_flow_violation_closes_as_reference(certs):
    want, got = both(_flow_violation, certs, lambda pkg: pkg.F.Stream(
        0, pkg.QC.STREAM_WINDOW + 10_000, b"x", False))
    assert got == want == (True, "stream flow-control credit exceeded")


def test_stream_limit_enforced_as_reference(certs):
    want, got = both(_flow_violation, certs, lambda pkg: pkg.F.Stream(
        4 * pkg.QC.MAX_STREAMS_BIDI, 0, b"x", False))
    assert got == want == (True, "stream limit exceeded")


class Dropper:
    """A transport that counts the datagrams it is asked to send and
    drops every `every`-th (none at 0); the rest go through."""

    def __init__(self, inner, every: int):
        self.inner = inner
        self.every = every
        self.n = self.dropped = 0

    def sendto(self, data, addr=None):
        self.n += 1
        if self.every and self.n % self.every == 0:
            self.dropped += 1
            return
        self.inner.sendto(data, addr)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def drop_both_ways(lst, qc, every: int) -> tuple:
    """Every `every`-th datagram of the client's and of its server
    connection's dropped."""
    [conn] = set(lst._conns.values())
    qc.transport = Dropper(qc.transport, every)
    conn.transport = Dropper(conn.transport, every)
    return qc.transport, conn.transport


async def _lossy(pkg, certs):
    lst = await _listener(pkg, certs)
    qc = await _dial(pkg, lst)
    drops = drop_both_ways(lst, qc, 3)
    c = pkg.Client(clientid="lossy", proto_ver=pkg.C.MQTT_V5,
                   conn_factory=lambda: _pair(qc))
    ack = await c.connect()
    await c.subscribe("lossy/t", qos=1)
    for i in range(20):
        await c.publish("lossy/t", b"m%d" % i, qos=1, timeout=20)
    got = [(await asyncio.wait_for(c.messages.get(), 20)).payload
           for _ in range(20)]
    await asyncio.sleep(0.2)        # a duplicate would land by now
    dup = c.messages.qsize()
    await asyncio.wait_for(c.disconnect(), 5)
    qc.close(0, "", app=True)
    await asyncio.wait_for(lst.stop(), 5)
    return {"connack": ack.reason_code, "got": got, "dup": dup,
            "dropped": all(d.dropped for d in drops)}


def test_loss_recovery_under_drops_equals_reference(certs):
    """Every 3rd datagram dropped both ways: 20 QoS 1 messages delivered
    once and in order through packet-threshold and PTO retransmission."""
    want, got = both(_lossy, certs, timeout=60)
    assert got["got"] == want["got"] == [b"m%d" % i for i in range(20)]
    assert got["connack"] == want["connack"] == 0
    assert got["dup"] == want["dup"] == 0
    assert got["dropped"] and want["dropped"]


async def _newreno(pkg, certs):
    lst = await _listener(pkg, certs)
    qc = await _dial(pkg, lst)
    cw0 = qc.cwnd
    qc._congestion_event(time.monotonic())
    cw1 = qc.cwnd
    qc._congestion_event(time.monotonic() - 10)  # same recovery window
    out = (cw0, cw1, qc.cwnd, cw1 == max(cw0 // 2, pkg.QC.MIN_CWND))
    qc.close(0, "", app=True)
    await asyncio.wait_for(lst.stop(), 5)
    return out


def test_newreno_halves_on_loss_as_reference(certs):
    want, got = both(_newreno, certs)
    assert got == want and got[3] and got[2] == got[1]


class Late:
    """A transport that hands every datagram to its socket `delay` s
    after it was sent: the ACKs of a peer whose loop runs late."""

    def __init__(self, inner, delay: float):
        self.inner = inner
        self.delay = delay

    def sendto(self, data, addr=None):
        asyncio.get_running_loop().call_later(self.delay, self.inner.sendto,
                                              data, addr)

    def __getattr__(self, name):
        return getattr(self.inner, name)


async def _late_acks(pkg, certs):
    """400 pipelined PUBLISHes (every 4th QoS 1) while the listener's
    side sends everything 0.5 s late (past PTO_S): the PUBACKs owed after
    8 s, the client's datagrams by then, its cwnd and blocked bytes."""
    lst = await _listener(pkg, certs)
    qc = await _dial(pkg, lst)
    c = pkg.Client(clientid="late", conn_factory=lambda: _pair(qc))
    await c.connect()
    [conn] = set(lst._conns.values())
    conn.transport = Late(conn.transport, 2 * pkg.QC.PTO_S - 0.1)
    qc.transport = Dropper(qc.transport, 0)
    acks = [f for k in range(400) if (f := c.publish_start(
        "late/t", b"x" * 60, qos=1 if k % 4 == 0 else 0)) is not None]
    _done, owed = await asyncio.wait(acks, timeout=8)
    out = {"owed": len(owed), "cwnd": qc.cwnd, "sent": qc.transport.n,
           "blocked": sum(len(d) for d, _fin in qc._blocked_tx.values())}
    qc.close(0, "", app=True)
    await asyncio.wait_for(lst.stop(), 5)
    return out


def test_late_acks_stall_the_reference_not_the_port(certs):
    """The port's one departure (``emqx_tpu_torch/quic/connection.py``):
    in the reference a payload re-sent on the PTO forgets its first
    packet number, so ACKs later than PTO_S free nothing in flight; cwnd
    sits at MIN_CWND with data queued behind it, the stream stalls, and
    every tick re-sends the whole flight. The port credits an ACK of any
    copy to the copy still in flight and backs the PTO off."""
    ref, port = both(_late_acks, certs)
    assert ref["owed"] > 0 and ref["blocked"] > 0
    assert ref["cwnd"] == jqc.MIN_CWND
    assert port["owed"] == 0 and port["blocked"] == 0
    assert 4 * port["sent"] < ref["sent"]


# ---------- interop, both ways ----------

async def _interop(srv_pkg, cli_pkg, certs):
    """MQTT 5 over `cli_pkg`'s QUIC client and Client into `srv_pkg`'s
    listener and node: CONNECT, SUBSCRIBE, 50 QoS 1 PUBLISHes."""
    node = srv_pkg.node()
    lst = await _listener(srv_pkg, certs, node)
    qc = cli_pkg.QuicClientConnection(port=lst.port, verify="required",
                                      cafile=certs["cacertfile"],
                                      server_name="localhost")
    await asyncio.wait_for(qc.connect(), 10)
    sub = cli_pkg.Client(clientid="isub", proto_ver=cli_pkg.C.MQTT_V5,
                         conn_factory=lambda: _pair(qc))
    pub = cli_pkg.Client(clientid="ipub", proto_ver=cli_pkg.C.MQTT_V5,
                         conn_factory=lambda: _pair(qc))
    acks = [(await sub.connect()).reason_code,
            (await pub.connect()).reason_code]
    sa = await sub.subscribe("interop/#", qos=1)
    pubacks = [(await pub.publish(f"interop/{i % 3}", b"i%d" % i, qos=1,
                                  timeout=10)).reason_code
               for i in range(50)]
    got = [(m.topic, m.payload, m.qos) for m in
           [await sub.recv(timeout=10) for _ in range(50)]]
    await asyncio.sleep(0.2)        # a duplicate would land by now
    dup = sub.messages.qsize()
    for c in (sub, pub):
        await asyncio.wait_for(c.disconnect(), 5)
    qc.close(0, "", app=True)
    await asyncio.wait_for(lst.stop(), 5)
    return {"acks": acks, "suback": list(sa.reason_codes),
            "pubacks": pubacks, "got": got, "dup": dup,
            "alpn": qc.tls.alpn}


@pytest.mark.parametrize("way", ["port-client-ref-listener",
                                 "ref-client-port-listener"])
def test_interop_equals_reference(certs, way):
    srv, cli = (REF, PORT) if way.startswith("port-client") else (PORT, REF)
    want = run(_interop(REF, REF, certs))
    got = run(_interop(srv, cli, certs))
    assert got == want
    assert got["got"] == [(f"interop/{i % 3}", b"i%d" % i, 1)
                          for i in range(50)]
    assert got["dup"] == 0 and got["acks"] == [0, 0]


# ---------- one stream past CONN_WINDOW ----------

async def _big_transfer(pkg, certs, drop_every):
    """BIG_BYTES over one client stream into a listener whose stream
    handler reads a length prefix and that many bytes, then answers with
    their SHA-256: past STREAM_WINDOW and CONN_WINDOW, so the transfer
    lives on MAX_STREAM_DATA and MAX_DATA credit."""
    seen = {}

    class Sink(pkg.QuicListener):
        async def _run_mqtt_connection(self, reader, writer):
            n = int.from_bytes(await reader.readexactly(8), "big")
            data = await reader.readexactly(n)
            seen["n"] = len(data)
            writer.write(hashlib.sha256(data).digest())

    lst = Sink(None, bind="127.0.0.1", port=0, certfile=certs["certfile"],
               keyfile=certs["keyfile"])
    await asyncio.wait_for(lst.start(), 5)
    qc = await _dial(pkg, lst)
    drops = drop_both_ways(lst, qc, drop_every) if drop_every else ()
    payload = hashlib.sha256(b"seed").digest() * (BIG_BYTES // 32)
    reader, writer = qc.open_stream()
    writer.write(len(payload).to_bytes(8, "big") + payload)
    digest = await asyncio.wait_for(reader.readexactly(32), 90)
    qc.close(0, "", app=True)
    await asyncio.wait_for(lst.stop(), 5)
    return {"n": seen.get("n"), "equal": digest == hashlib.sha256(
        payload).digest(),
        "dropped": bool(drops) and all(d.dropped for d in drops)}


@pytest.mark.parametrize("drop_every", [0, 20])
def test_big_stream_transfer_equals_reference(certs, drop_every):
    want, got = both(_big_transfer, certs, drop_every, timeout=120)
    for r in (want, got):
        assert r["n"] == BIG_BYTES - BIG_BYTES % 32 and r["equal"]
        assert r["n"] > tqc.CONN_WINDOW > tqc.STREAM_WINDOW
        assert r["dropped"] == bool(drop_every)
