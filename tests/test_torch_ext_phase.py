"""chip_smoke.py's phase 20 (extension, export and the protocol
gateways) rehearsed on the CPU at a reduced size: the shipped file booted
with the stomp, mqttsn, coap and lwm2m gateway blocks (exproto and an
exhook server too, since grpc imports here), the dashboard with the
Prometheus scrape on it, a StatsD app and a telemetry reporter aimed at
receivers in this process and one plugin from a module file; 5,000
filters beside 8 STOMP, 4 MQTT-SN and 2 CoAP subscribers, a 2,000-message
flood, the gateways' ingress, an LwM2M endpoint's 100 read commands, and
every gateway socket closed by stop_listeners. The phase holds the
chooser on the device engine for its flood and the LwM2M commands, here
as on the card."""

import torch

import chip_smoke as cs

torch.set_num_threads(1)


def test_chip_smoke_ext_on_cpu():
    r = cs.ext_drive(torch.device("cpu"), n_filters=5000, total=2000,
                     window=(2, 256))
    a, b, c, d = r["a"], r["b"], r["c"], r["d"]
    grpc = r["grpc"]
    assert r["apps"] == ["Retainer", "DelayedPublish"] + (
        ["Exhook"] if grpc else [])
    assert [g["name"] for g in r["gateways"]] == sorted(
        ["stomp", "mqttsn", "coap", "lwm2m"] + (["exproto"] if grpc else []))
    f = a["flood"]
    assert f["delivered"] == 2000 and a["device_msg_share"] >= 0.9
    assert f["lane_rows"] > 0 and a["window_err"] == 0
    assert all(got == want and want > 0
               for got, want in a["gateway_clients"].values())
    assert len(a["gateway_clients"]) == 14 and a["stomp_in_order"]
    assert b["exactly_once"] and b["received"] == b["want"] == 2201
    assert b["mqttsn_pubacks"] == {0: 1000}
    assert b["coap_codes"] == {"2.04": 200}
    assert b["counters"] == {"messages.publish": 2201,
                             "routing.host.messages": 0,
                             "routing.device.messages": 0,
                             "routing.device.batches": 0}
    assert c["replies"] == 100 and c["replies_ok"]
    assert c["device_routed"] >= 90
    assert c["sessions_left"] == ([], False)
    assert len(d["scrapes"]) == 3 and d["after"][0] == d["after"][1]
    assert d["statsd"]["deltas"] == d["statsd"]["want"] == f["sent"]
    assert d["telemetry"]["reports"] == 1
    assert d["plugins"]["list"] == "Plugin(phase20, enabled=True)"
    assert [e[0] for e in d["plugins"]["events"]] == ["load", "unload"]
    if grpc:
        assert a["exhook_publishes"] == a["exhook_want"] > 0
    assert r["end"] == {"registry": [], "stomp_accepts": False,
                        "udp_closed": True}
