"""QUIC v1 frame codec (RFC 9000 §19) — the subset MQTT-over-QUIC uses.

PADDING, PING, ACK, CRYPTO, STREAM (all offset/len/fin variants),
MAX_DATA/MAX_STREAM_DATA/MAX_STREAMS, CONNECTION_CLOSE (transport + app),
HANDSHAKE_DONE, NEW_CONNECTION_ID (parsed + ignored), RESET_STREAM,
STOP_SENDING.

The port's copy of ``emqx_tpu/quic/frames.py``: the same constants
and behaviour, with its imports pointed at ``emqx_tpu_torch``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from emqx_tpu_torch.quic.packet import dec_varint, enc_varint

FT_PADDING = 0x00
FT_PING = 0x01
FT_ACK = 0x02
FT_ACK_ECN = 0x03
FT_RESET_STREAM = 0x04
FT_STOP_SENDING = 0x05
FT_CRYPTO = 0x06
FT_NEW_TOKEN = 0x07
FT_STREAM = 0x08          # ..0x0F with OFF/LEN/FIN bits
FT_MAX_DATA = 0x10
FT_MAX_STREAM_DATA = 0x11
FT_MAX_STREAMS_BIDI = 0x12
FT_MAX_STREAMS_UNI = 0x13
FT_NEW_CONNECTION_ID = 0x18
FT_RETIRE_CONNECTION_ID = 0x19
FT_CONNECTION_CLOSE = 0x1C
FT_CONNECTION_CLOSE_APP = 0x1D
FT_HANDSHAKE_DONE = 0x1E


class Crypto(NamedTuple):
    offset: int
    data: bytes


class Stream(NamedTuple):
    stream_id: int
    offset: int
    data: bytes
    fin: bool


class Ack(NamedTuple):
    largest: int
    delay: int
    ranges: list[tuple[int, int]]    # [(lo, hi)] descending


class Close(NamedTuple):
    error_code: int
    frame_type: Optional[int]        # None for app close
    reason: str


class ResetStream(NamedTuple):
    stream_id: int
    error_code: int
    final_size: int


class MaxData(NamedTuple):
    value: int


class MaxStreamData(NamedTuple):
    stream_id: int
    value: int


class HandshakeDone(NamedTuple):
    pass


class Ping(NamedTuple):
    pass


def encode_crypto(offset: int, data: bytes) -> bytes:
    return (bytes([FT_CRYPTO]) + enc_varint(offset)
            + enc_varint(len(data)) + data)


def encode_stream(stream_id: int, offset: int, data: bytes,
                  fin: bool = False) -> bytes:
    ftype = FT_STREAM | 0x02 | (0x04 if offset else 0) | (1 if fin else 0)
    out = bytes([ftype]) + enc_varint(stream_id)
    if offset:
        out += enc_varint(offset)
    return out + enc_varint(len(data)) + data


def encode_ack(largest: int, ranges: list[tuple[int, int]],
               delay: int = 0) -> bytes:
    """ranges: [(lo, hi)] sorted descending by hi; largest == ranges[0][1]."""
    lo0, hi0 = ranges[0]
    out = (bytes([FT_ACK]) + enc_varint(largest) + enc_varint(delay)
           + enc_varint(len(ranges) - 1) + enc_varint(hi0 - lo0))
    prev_lo = lo0
    for lo, hi in ranges[1:]:
        out += enc_varint(prev_lo - hi - 2) + enc_varint(hi - lo)
        prev_lo = lo
    return out


def encode_close(error_code: int, reason: str = "",
                 frame_type: int = 0, app: bool = False) -> bytes:
    r = reason.encode()
    out = bytes([FT_CONNECTION_CLOSE_APP if app else FT_CONNECTION_CLOSE])
    out += enc_varint(error_code)
    if not app:
        out += enc_varint(frame_type)
    return out + enc_varint(len(r)) + r


def encode_handshake_done() -> bytes:
    return bytes([FT_HANDSHAKE_DONE])


def encode_max_data(v: int) -> bytes:
    return bytes([FT_MAX_DATA]) + enc_varint(v)


def encode_max_stream_data(sid: int, v: int) -> bytes:
    return bytes([FT_MAX_STREAM_DATA]) + enc_varint(sid) + enc_varint(v)


class FrameError(Exception):
    pass


def parse_frames(payload: bytes) -> list:
    """-> list of frame tuples (PADDING/PING folded away except one Ping
    marker so the caller knows to ack)."""
    out: list = []
    pos = 0
    n = len(payload)
    saw_ping = False
    while pos < n:
        ftype = payload[pos]
        pos += 1
        if ftype == FT_PADDING:
            continue
        if ftype == FT_PING:
            saw_ping = True
            continue
        if ftype in (FT_ACK, FT_ACK_ECN):
            largest, pos = dec_varint(payload, pos)
            delay, pos = dec_varint(payload, pos)
            count, pos = dec_varint(payload, pos)
            first, pos = dec_varint(payload, pos)
            ranges = [(largest - first, largest)]
            lo = largest - first
            for _ in range(count):
                gap, pos = dec_varint(payload, pos)
                length, pos = dec_varint(payload, pos)
                hi = lo - gap - 2
                ranges.append((hi - length, hi))
                lo = hi - length
            if ftype == FT_ACK_ECN:
                for _ in range(3):
                    _, pos = dec_varint(payload, pos)
            out.append(Ack(largest=largest, delay=delay, ranges=ranges))
        elif ftype == FT_CRYPTO:
            off, pos = dec_varint(payload, pos)
            ln, pos = dec_varint(payload, pos)
            out.append(Crypto(offset=off, data=payload[pos:pos + ln]))
            pos += ln
        elif FT_STREAM <= ftype <= FT_STREAM | 0x07:
            sid, pos = dec_varint(payload, pos)
            off = 0
            if ftype & 0x04:
                off, pos = dec_varint(payload, pos)
            if ftype & 0x02:
                ln, pos = dec_varint(payload, pos)
            else:
                ln = n - pos
            out.append(Stream(stream_id=sid, offset=off,
                              data=payload[pos:pos + ln],
                              fin=bool(ftype & 0x01)))
            pos += ln
        elif ftype == FT_RESET_STREAM:
            sid, pos = dec_varint(payload, pos)
            ec, pos = dec_varint(payload, pos)
            fs, pos = dec_varint(payload, pos)
            out.append(ResetStream(stream_id=sid, error_code=ec,
                                   final_size=fs))
        elif ftype == FT_STOP_SENDING:
            _sid, pos = dec_varint(payload, pos)
            _ec, pos = dec_varint(payload, pos)
        elif ftype == FT_MAX_DATA:
            v, pos = dec_varint(payload, pos)
            out.append(MaxData(value=v))
        elif ftype == FT_MAX_STREAM_DATA:
            sid, pos = dec_varint(payload, pos)
            v, pos = dec_varint(payload, pos)
            out.append(MaxStreamData(stream_id=sid, value=v))
        elif ftype in (FT_MAX_STREAMS_BIDI, FT_MAX_STREAMS_UNI):
            _, pos = dec_varint(payload, pos)
        elif ftype == FT_NEW_CONNECTION_ID:
            _seq, pos = dec_varint(payload, pos)
            _ret, pos = dec_varint(payload, pos)
            ln = payload[pos]
            pos += 1 + ln + 16          # cid + stateless reset token
        elif ftype == FT_RETIRE_CONNECTION_ID:
            _, pos = dec_varint(payload, pos)
        elif ftype == FT_NEW_TOKEN:
            ln, pos = dec_varint(payload, pos)
            pos += ln
        elif ftype in (FT_CONNECTION_CLOSE, FT_CONNECTION_CLOSE_APP):
            ec, pos = dec_varint(payload, pos)
            ft = None
            if ftype == FT_CONNECTION_CLOSE:
                ft, pos = dec_varint(payload, pos)
            ln, pos = dec_varint(payload, pos)
            reason = payload[pos:pos + ln].decode("utf-8", "replace")
            pos += ln
            out.append(Close(error_code=ec, frame_type=ft, reason=reason))
        elif ftype == FT_HANDSHAKE_DONE:
            out.append(HandshakeDone())
        else:
            raise FrameError(f"unknown frame type 0x{ftype:02x}")
    if saw_ping:
        out.append(Ping())
    return out
