"""QUIC client endpoint: drives the conformance tests and gives the MQTT
bridge a QUIC dialing option (the reference bundles emqtt-over-quicer for
the same purposes).

`QuicClientConnection.connect()` performs the full handshake;
`open_stream()` returns (StreamReader, writer) shaped like asyncio's TCP
pair, so `emqx_tpu_torch.client.Client` can run MQTT over it unchanged.

The port's copy of ``emqx_tpu/quic/client.py``: the same constants
and behaviour, with its imports pointed at ``emqx_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import os
from typing import Optional

from emqx_tpu_torch.quic import frames as F
from emqx_tpu_torch.quic import packet as P
from emqx_tpu_torch.quic import tls13 as T
from emqx_tpu_torch.quic.connection import (CID_LEN, CONN_WINDOW, MAX_DATAGRAM,
                                      STREAM_WINDOW, QuicConnectionBase,
                                      _QuicStreamWriter, _RecvStream)


class QuicClientConnection(QuicConnectionBase):
    is_client = True

    def __init__(self, host: str = "127.0.0.1", port: int = 14567,
                 server_name: Optional[str] = None,
                 cafile: Optional[str] = None,
                 verify: str = "required"):
        """Server certificate verification defaults ON (against `cafile`
        or the system trust store); pass verify='none' to opt out
        explicitly (logged loudly by the TLS engine)."""
        self.host = host
        self.port = port
        if server_name is None:
            server_name = host        # RFC 6125: verify what we dialed
        scid = os.urandom(CID_LEN)
        odcid = os.urandom(CID_LEN)
        super().__init__(None, (host, port), scid=scid, dcid=odcid)
        tp = P.encode_transport_params({
            P.TP_INITIAL_SCID: scid,
            P.TP_MAX_IDLE_TIMEOUT: P.enc_varint(30000),
            P.TP_MAX_UDP_PAYLOAD: P.enc_varint(MAX_DATAGRAM),
            P.TP_MAX_DATA: P.enc_varint(CONN_WINDOW),
            P.TP_MAX_STREAM_DATA_BIDI_LOCAL: P.enc_varint(STREAM_WINDOW),
            P.TP_MAX_STREAM_DATA_BIDI_REMOTE: P.enc_varint(STREAM_WINDOW),
            P.TP_MAX_STREAMS_BIDI: P.enc_varint(16),
            P.TP_MAX_STREAMS_UNI: P.enc_varint(0),
        })
        self.tls = T.Tls13Client(server_name, ["mqtt"], tp, cafile=cafile,
                                 verify=verify)
        self._setup_initial_keys(odcid)
        self._next_stream_id = 0
        self._readers: dict[int, asyncio.StreamReader] = {}

    async def connect(self, timeout: float = 10.0) -> None:
        loop = asyncio.get_running_loop()
        conn = self

        class _Proto(asyncio.DatagramProtocol):
            def datagram_received(self, data, addr):
                try:
                    conn.datagram_received(data)
                except Exception:  # noqa: BLE001
                    conn.close(1, "client internal error")

        self.transport, _ = await loop.create_datagram_endpoint(
            _Proto, remote_addr=(self.host, self.port))
        self.addr = None          # connected UDP socket: sendto(addr=None)
        self.tls.start()
        self._pump_tls()
        self.start_pto()
        self.flush()
        await asyncio.wait_for(self.handshake_done, timeout)

    def _after_tls_progress(self) -> None:
        if self.tls.complete and not self.handshake_done.done():
            self.handshake_done.set_result(True)

    def _on_handshake_done_frame(self) -> None:
        # server confirmed; initial/handshake keys can be dropped
        self.keys_rx.pop(0, None)
        self.keys_tx.pop(0, None)

    def open_stream(self) -> tuple[asyncio.StreamReader, _QuicStreamWriter]:
        sid = self._next_stream_id
        self._next_stream_id += 4
        reader = asyncio.StreamReader()
        self._readers[sid] = reader
        self.streams_rx[sid] = _RecvStream()
        writer = _QuicStreamWriter(self, sid)
        return reader, writer

    def _on_stream_frame(self, fr: F.Stream) -> None:
        rs = self.streams_rx.get(fr.stream_id)
        reader = self._readers.get(fr.stream_id)
        if rs is None or reader is None:
            return
        if not self._enforce_stream_flow(fr, rs):
            return
        data = rs.reassembly.feed(fr.offset, fr.data)
        if fr.fin:
            rs.fin_at = fr.offset + len(fr.data)
        if data:
            rs.delivered += len(data)
            reader.feed_data(data)
            self._replenish_rx(fr.stream_id, rs, self.spaces[2])
        if rs.fin_at is not None and rs.reassembly.next >= rs.fin_at:
            reader.feed_eof()

    def _on_closed(self) -> None:
        super()._on_closed()
        for reader in self._readers.values():
            if not reader.at_eof():
                reader.feed_eof()
        if self.transport is not None:
            self.transport.close()
            self.transport = None
