"""chip_smoke.py's phase 18 (the secured node) rehearsed on the CPU at a
reduced size: the shipped file booted with the authn chain (built-in
users, JWT, SCRAM), the file ACL (no_match deny) and the two rules;
5,000 filters subscribed by logged-in clients, a 2,000-message flood
with 100 denied QoS 1 PUBLISHes mixed in, the refusals and the rules
API. The chooser is pinned to the device engine (on the CPU the host
path wins it)."""

import torch

import chip_smoke as cs

torch.set_num_threads(1)


def test_chip_smoke_secure_on_cpu():
    r = cs.secure_drive(torch.device("cpu"), n_filters=5000, total=2000,
                        window=(2, 256), pin_device=True)
    a, b, c = r["a"], r["b"], r["c"]
    assert r["apps"] == ["Retainer", "DelayedPublish", "RuleEngine",
                         "AuthnChain", "Authz"]
    assert r["enhanced_authn"] == ["SCRAM-SHA-256"]
    f = a["flood"]
    assert f["delivered"] == 2000 and f["device_share"] >= 0.9
    assert f["forbidden_rcs"] == [0x87] * 100
    q1 = 8 * len(range(0, 2000 // 8, 4))      # every 4th at QoS 1
    assert a["r_q1"]["sql.matched"] == 2000
    assert a["r_q1"]["sql.passed"] == a["r_q1"]["actions.success"] == q1
    # the republishes, then one rules/conn/<id> for each of 8 publishers,
    # the SCRAM client and 16 subscribers
    assert a["rules_received"] == a["rules_want"] == q1 + 8 + 1 + 16
    assert a["republish_host_routes"] == q1
    assert a["counters"]["client.authorize"] >= 2000
    assert a["window_err"] == 0
    assert b["refused"] == {"bad_password_v5": 0x86,
                            "bad_password_v311": 4,
                            "jwt_bad_signature": 0x87,
                            "scram_bad_password": 0x87}
    assert b["suback_outside_acl"] == [0x87]
    assert c["fired"] == {"sql.matched": 64, "sql.passed": 64,
                          "actions.success": 64}
    assert (c["delete"], c["get_after"]) == (204, 404)
