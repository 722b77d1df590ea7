"""QUIC v1 packet protection + header codec (RFC 9000 §17, RFC 9001 §5).

Long headers (Initial / Handshake) and short headers (1-RTT); AEAD is
AES-128-GCM with per-level keys derived from the TLS traffic secrets via
the "quic key"/"quic iv"/"quic hp" labels; header protection is an
AES-ECB mask over a 16-byte ciphertext sample.

The port's copy of ``emqx_tpu/quic/packet.py``: the same constants
and behaviour, with its imports pointed at ``emqx_tpu_torch``.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from emqx_tpu_torch.quic.tls13 import hkdf_expand_label, hkdf_extract

QUIC_V1 = 0x00000001
# RFC 9001 §5.2
INITIAL_SALT_V1 = bytes.fromhex(
    "38762cf7f55934b34d179ae6a4c80cadccbb7f0a")

PT_INITIAL, PT_ZERO_RTT, PT_HANDSHAKE, PT_RETRY = 0, 1, 2, 3
PT_ONE_RTT = 4


# ---------------------------------------------------------------------------
# varints (RFC 9000 §16)
# ---------------------------------------------------------------------------

def enc_varint(v: int) -> bytes:
    if v < 0x40:
        return bytes([v])
    if v < 0x4000:
        return struct.pack(">H", 0x4000 | v)
    if v < 0x40000000:
        return struct.pack(">I", 0x80000000 | v)
    return struct.pack(">Q", 0xC000000000000000 | v)


def dec_varint(data: bytes, pos: int) -> tuple[int, int]:
    first = data[pos]
    klass = first >> 6
    n = 1 << klass
    v = first & 0x3F
    for i in range(1, n):
        v = (v << 8) | data[pos + i]
    return v, pos + n


class Keys(NamedTuple):
    aead: AESGCM
    iv: bytes
    hp: bytes       # header-protection key (AES-128)


def derive_keys(secret: bytes) -> Keys:
    key = hkdf_expand_label(secret, "quic key", b"", 16)
    iv = hkdf_expand_label(secret, "quic iv", b"", 12)
    hp = hkdf_expand_label(secret, "quic hp", b"", 16)
    return Keys(aead=AESGCM(key), iv=iv, hp=hp)


def initial_secrets(dcid: bytes) -> tuple[bytes, bytes]:
    """-> (client_initial_secret, server_initial_secret) per RFC 9001."""
    initial = hkdf_extract(INITIAL_SALT_V1, dcid)
    client = hkdf_expand_label(initial, "client in", b"", 32)
    server = hkdf_expand_label(initial, "server in", b"", 32)
    return client, server


def _nonce(iv: bytes, pn: int) -> bytes:
    return (int.from_bytes(iv, "big") ^ pn).to_bytes(12, "big")


def _hp_mask(hp_key: bytes, sample: bytes) -> bytes:
    enc = Cipher(algorithms.AES(hp_key), modes.ECB()).encryptor()
    return enc.update(sample)[:5]


class Packet(NamedTuple):
    ptype: int                 # PT_*
    dcid: bytes
    scid: bytes                # long headers only
    pn: int
    payload: bytes
    token: bytes               # initial only


def encode_packet(ptype: int, version: int, dcid: bytes, scid: bytes,
                  pn: int, payload: bytes, keys: Keys,
                  token: bytes = b"", key_phase: int = 0) -> bytes:
    """Build + protect one packet. Packet numbers always encode 4 bytes
    (legal per RFC 9000 §17.1; simplifies decode on loss-free paths)."""
    pn_bytes = struct.pack(">I", pn & 0xFFFFFFFF)
    if ptype == PT_ONE_RTT:
        first = 0x40 | ((key_phase & 1) << 2) | 0x03   # pn_len-1 = 3
        header = bytes([first]) + dcid + pn_bytes
        pn_off = 1 + len(dcid)
    else:
        first = 0xC0 | (ptype << 4) | 0x03
        header = (bytes([first]) + struct.pack(">I", version)
                  + bytes([len(dcid)]) + dcid + bytes([len(scid)]) + scid)
        if ptype == PT_INITIAL:
            header += enc_varint(len(token)) + token
        length = 4 + len(payload) + 16                 # pn + body + tag
        header += enc_varint(length)
        pn_off = len(header)
        header += pn_bytes
    ct = keys.aead.encrypt(_nonce(keys.iv, pn), payload, header)
    out = bytearray(header + ct)
    sample = bytes(out[pn_off + 4:pn_off + 20])
    mask = _hp_mask(keys.hp, sample)
    out[0] ^= mask[0] & (0x0F if ptype != PT_ONE_RTT else 0x1F)
    for i in range(4):
        out[pn_off + i] ^= mask[1 + i]
    return bytes(out)


class PacketError(Exception):
    pass


# ---- Retry packets (RFC 9000 §17.2.5 + RFC 9001 §5.8 integrity tag) ----
# fixed v1 key/nonce from RFC 9001 §5.8
RETRY_KEY = bytes.fromhex("be0c690b9f66575a1d766b54e368c84e")
RETRY_NONCE = bytes.fromhex("461599d35d632bf2239825bb")


def _retry_pseudo(odcid: bytes, retry_no_tag: bytes) -> bytes:
    return bytes([len(odcid)]) + odcid + retry_no_tag


def encode_retry(version: int, dcid: bytes, scid: bytes, odcid: bytes,
                 token: bytes) -> bytes:
    """Build a Retry packet (server -> client, address validation)."""
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    first = 0xC0 | (PT_RETRY << 4)
    pkt = (bytes([first]) + struct.pack(">I", version)
           + bytes([len(dcid)]) + dcid + bytes([len(scid)]) + scid + token)
    tag = AESGCM(RETRY_KEY).encrypt(RETRY_NONCE, b"",
                                    _retry_pseudo(odcid, pkt))
    return pkt + tag


def decode_retry(datagram: bytes, odcid: bytes):
    """Parse + integrity-check a Retry. -> (scid, token) or None when the
    tag does not verify (RFC 9001 §5.8: MUST discard on mismatch)."""
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    if len(datagram) < 23 or (datagram[0] & 0xB0) != 0xB0:
        return None
    p = 5
    dlen = datagram[p]
    p += 1 + dlen
    if p >= len(datagram):
        return None
    slen = datagram[p]
    scid = datagram[p + 1:p + 1 + slen]
    p += 1 + slen
    if p + 16 > len(datagram):
        return None
    token = datagram[p:-16]
    tag = datagram[-16:]
    try:
        AESGCM(RETRY_KEY).decrypt(
            RETRY_NONCE, tag, _retry_pseudo(odcid, datagram[:-16]))
    except Exception:  # noqa: BLE001 — invalid tag: discard
        return None
    return scid, token


def peek_header(datagram: bytes, pos: int,
                short_dcid_len: int) -> tuple[int, bytes, bytes, bytes, int, int]:
    """Parse the unprotected parts: -> (ptype, dcid, scid, token,
    pn_offset, end). `end` = index one past this packet in the datagram."""
    first = datagram[pos]
    if first & 0x80:
        ptype = (first >> 4) & 0x03
        p = pos + 5
        dlen = datagram[p]
        dcid = datagram[p + 1:p + 1 + dlen]
        p += 1 + dlen
        slen = datagram[p]
        scid = datagram[p + 1:p + 1 + slen]
        p += 1 + slen
        token = b""
        if ptype == PT_INITIAL:
            tlen, p = dec_varint(datagram, p)
            token = datagram[p:p + tlen]
            p += tlen
        length, p = dec_varint(datagram, p)
        return ptype, dcid, scid, token, p, p + length
    dcid = datagram[pos + 1:pos + 1 + short_dcid_len]
    return PT_ONE_RTT, dcid, b"", b"", pos + 1 + short_dcid_len, \
        len(datagram)


def decode_packet(datagram: bytes, pos: int, ptype: int, pn_off: int,
                  end: int, keys: Keys, largest_pn: int) -> Packet:
    """Unprotect + decrypt one packet located by peek_header."""
    buf = bytearray(datagram[pos:end])
    rel_pn = pn_off - pos
    sample = bytes(buf[rel_pn + 4:rel_pn + 20])
    if len(sample) < 16:
        raise PacketError("short sample")
    mask = _hp_mask(keys.hp, sample)
    buf[0] ^= mask[0] & (0x0F if ptype != PT_ONE_RTT else 0x1F)
    pn_len = (buf[0] & 0x03) + 1
    for i in range(pn_len):
        buf[rel_pn + i] ^= mask[1 + i]
    truncated = int.from_bytes(buf[rel_pn:rel_pn + pn_len], "big")
    pn = _decode_pn(truncated, pn_len * 8, largest_pn)
    header = bytes(buf[:rel_pn + pn_len])
    ct = bytes(buf[rel_pn + pn_len:])
    try:
        payload = keys.aead.decrypt(_nonce(keys.iv, pn), ct, header)
    except Exception as e:  # noqa: BLE001 — InvalidTag
        raise PacketError(f"decrypt failed: {e}")
    return Packet(ptype=ptype, dcid=b"", scid=b"", pn=pn,
                  payload=payload, token=b"")


def _decode_pn(truncated: int, bits: int, largest: int) -> int:
    """RFC 9000 appendix A.3 packet-number reconstruction."""
    expected = largest + 1
    win = 1 << bits
    hwin = win // 2
    mask = win - 1
    cand = (expected & ~mask) | truncated
    if cand <= expected - hwin and cand < (1 << 62) - win:
        return cand + win
    if cand > expected + hwin and cand >= win:
        return cand - win
    return cand


# ---------------------------------------------------------------------------
# transport parameters (RFC 9000 §18)
# ---------------------------------------------------------------------------

TP_MAX_IDLE_TIMEOUT = 0x01
TP_MAX_UDP_PAYLOAD = 0x03
TP_MAX_DATA = 0x04
TP_MAX_STREAM_DATA_BIDI_LOCAL = 0x05
TP_MAX_STREAM_DATA_BIDI_REMOTE = 0x06
TP_MAX_STREAM_DATA_UNI = 0x07
TP_MAX_STREAMS_BIDI = 0x08
TP_MAX_STREAMS_UNI = 0x09
TP_INITIAL_SCID = 0x0F
TP_ORIGINAL_DCID = 0x00
TP_RETRY_SCID = 0x10


def encode_transport_params(params: dict[int, "int | bytes"]) -> bytes:
    out = b""
    for k, v in params.items():
        body = v if isinstance(v, (bytes, bytearray)) else enc_varint(v)
        out += enc_varint(k) + enc_varint(len(body)) + bytes(body)
    return out


def decode_transport_params(data: bytes) -> dict[int, bytes]:
    out: dict[int, bytes] = {}
    pos = 0
    while pos < len(data):
        k, pos = dec_varint(data, pos)
        ln, pos = dec_varint(data, pos)
        out[k] = data[pos:pos + ln]
        pos += ln
    return out
