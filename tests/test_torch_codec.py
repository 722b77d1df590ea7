"""Port vs JAX reference: the MQTT codec (``emqx_tpu_torch/mqtt``).

Every control packet type, v3.1.1 and v5 (properties included), is
serialized by both codecs to equal bytes; each byte stream (one packet, and
all of them concatenated) is fed to both parsers in small chunks — the TCP
segmentation case — and must give equal packets, field for field.
"""

import dataclasses

import pytest

from emqx_tpu.mqtt import constants as JC
from emqx_tpu.mqtt import frame as JF
from emqx_tpu.mqtt import packet as JP
from emqx_tpu_torch.mqtt import constants as TC
from emqx_tpu_torch.mqtt import frame as TF
from emqx_tpu_torch.mqtt import packet as TP

V4, V5 = JC.MQTT_V4, JC.MQTT_V5

PROPS5 = {"user_property": [("k", "v"), ("a", "b")],
          "message_expiry_interval": 30, "content_type": "text/plain",
          "correlation_data": b"\x00\x01", "response_topic": "r/t"}

# (packet class name, fields, protocol version); SubOpts and Will values
# are spelled as ("SubOpts", {...}) / ("Will", {...}) and built per package
SPECS = [
    ("Connect", dict(clientid="c1", keepalive=30, username="u",
                     password=b"pw"), V4),
    ("Connect", dict(proto_ver=V5, clean_start=False, clientid="c2",
                     properties={"session_expiry_interval": 60,
                                 "receive_maximum": 10},
                     will=("Will", dict(topic="w/t", payload=b"bye", qos=1,
                                        retain=True,
                                        properties={"will_delay_interval":
                                                    5}))), V5),
    ("Connack", dict(session_present=True), V4),
    ("Connack", dict(reason_code=0x87,
                     properties={"assigned_client_identifier": "x",
                                 "topic_alias_maximum": 8}), V5),
    ("Publish", dict(topic="a/b", payload=b"hello", qos=0), V4),
    ("Publish", dict(topic="a/b/c", payload=b"\x00" * 300, qos=1,
                     packet_id=7, retain=True), V4),
    ("Publish", dict(topic="x", payload=b"p", qos=2, packet_id=65535,
                     dup=True, properties=dict(PROPS5, topic_alias=3)), V5),
    ("Puback", dict(packet_id=1), V4),
    ("Puback", dict(packet_id=2, reason_code=0x10,
                    properties={"reason_string": "no"}), V5),
    ("Pubrec", dict(packet_id=3), V4),
    ("Pubrel", dict(packet_id=4), V4),
    ("Pubrel", dict(packet_id=4, reason_code=0x92), V5),
    ("Pubcomp", dict(packet_id=5), V4),
    ("Subscribe", dict(packet_id=9, filters=[
        ("a/+", ("SubOpts", dict(qos=1))),
        ("$share/g/b/#", ("SubOpts", dict(qos=2)))]), V4),
    ("Subscribe", dict(packet_id=10, filters=[
        ("c/#", ("SubOpts", dict(qos=1, nl=1, rap=1, rh=2)))],
        properties={"subscription_identifier": [42]}), V5),
    ("Suback", dict(packet_id=9, reason_codes=[1, 2, 0x80]), V4),
    ("Suback", dict(packet_id=10, reason_codes=[0x01],
                    properties={"reason_string": "ok"}), V5),
    ("Unsubscribe", dict(packet_id=11, filters=["a/+", "b/#"]), V4),
    ("Unsuback", dict(packet_id=11), V4),
    ("Unsuback", dict(packet_id=12, reason_codes=[0, 0x11]), V5),
    ("Pingreq", {}, V4),
    ("Pingresp", {}, V4),
    ("Disconnect", {}, V4),
    ("Disconnect", dict(reason_code=0x8E,
                        properties={"session_expiry_interval": 0}), V5),
    ("Auth", dict(reason_code=0x18,
                  properties={"authentication_method": "SCRAM-SHA-256",
                              "authentication_data": b"abc"}), V5),
]


def build(pkg, name, fields):
    def val(v):
        if isinstance(v, tuple) and v and v[0] in ("SubOpts", "Will"):
            return getattr(pkg, v[0])(**v[1])
        return v
    kw = {k: val(v) for k, v in fields.items()}
    if "filters" in kw:
        kw["filters"] = [x if isinstance(x, str) else (x[0], val(x[1]))
                         for x in kw["filters"]]
    return getattr(pkg, name)(**kw)


def as_data(pkt):
    return (type(pkt).__name__, dataclasses.asdict(pkt))


def parse_chunked(parser, data, step):
    out = []
    for i in range(0, len(data), step):
        out.extend(parser.feed(data[i:i + step]))
    return out


def test_constants_copied():
    assert TC.PROPERTIES == JC.PROPERTIES
    assert TC.PACKET_TYPE_NAMES == JC.PACKET_TYPE_NAMES
    assert {k: getattr(TC, k) for k in dir(JC) if k.startswith("RC_")} == \
        {k: getattr(JC, k) for k in dir(JC) if k.startswith("RC_")}


@pytest.mark.parametrize("name,fields,ver", SPECS,
                         ids=[f"{s[0]}-v{s[2]}-{i}"
                              for i, s in enumerate(SPECS)])
def test_serialize_and_parse_equal(name, fields, ver):
    jp, tp = build(JP, name, fields), build(TP, name, fields)
    jb, tb = JF.serialize(jp, ver), TF.serialize(tp, ver)
    assert jb == tb
    for step in (1, 3, 7, len(jb)):
        jparsed = parse_chunked(JF.FrameParser(version=ver), jb, step)
        tparsed = parse_chunked(TF.FrameParser(version=ver), tb, step)
        assert [as_data(p) for p in jparsed] == \
            [as_data(p) for p in tparsed]
        assert len(tparsed) == 1


@pytest.mark.parametrize("ver", [V4, V5])
def test_stream_of_every_packet(ver):
    """All packets of one version back to back, split at every small
    chunk size, parse to the same sequence on both sides; a server-side
    parser infers the version from the CONNECT."""
    specs = [s for s in SPECS if s[2] == ver or s[2] == V4 and ver == V5
             and s[0] not in ("Connect",)]
    jb = b"".join(JF.serialize(build(JP, n, f), ver) for n, f, _ in specs)
    tb = b"".join(TF.serialize(build(TP, n, f), ver) for n, f, _ in specs)
    assert jb == tb
    for step in (2, 5, 64):
        j = parse_chunked(JF.FrameParser(version=ver), jb, step)
        t = parse_chunked(TF.FrameParser(version=ver), tb, step)
        assert [as_data(p) for p in j] == [as_data(p) for p in t]
        assert len(t) == len(specs)
    conn = TF.serialize(build(TP, "Connect", SPECS[1][1]), V5)
    got = TF.FrameParser().feed(conn)
    assert got[0].proto_ver == V5


@pytest.mark.parametrize("bad", [b"\x00\x00", b"\x30\xff\xff\xff\xff\x01",
                                 b"\x60\x02\x00\x01"])
def test_malformed_frames_raise_alike(bad):
    """Reserved type, an over-long varint and bad PUBREL flags raise
    FrameError with the same code on both sides."""
    errs = []
    for F in (JF, TF):
        with pytest.raises(F.FrameError) as ei:
            F.FrameParser(version=V4).feed(bad)
        errs.append(ei.value.code)
    assert errs[0] == errs[1]
