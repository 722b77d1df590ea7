"""chip_smoke.py's phase 19 (the database-backed node) rehearsed on the
CPU at a reduced size: the shipped file booted with the MySQL,
PostgreSQL and LDAP authn chain, the Redis and PostgreSQL ACL and r_up's
data_to_up action against this process's fake servers; 5,000 filters
subscribed by MySQL logins, a 2,000-message flood with 100 denied QoS 1
PUBLISHes mixed in, the MQTT bridge through a remote outage, the LDAP
and wrong-password logins, and every resource closed by stop_listeners.
The chooser is pinned to the device engine (on the CPU the host path
wins it)."""

import torch

import chip_smoke as cs

torch.set_num_threads(1)


def test_chip_smoke_db_on_cpu():
    r = cs.db_drive(torch.device("cpu"), n_filters=5000, total=2000,
                    window=(2, 256), pin_device=True)
    a, b, c = r["a"], r["b"], r["c"]
    assert r["apps"] == ["Retainer", "DelayedPublish", "RuleEngine",
                         "AuthnChain", "Authz"]
    assert sorted((x["id"], x["type"], x["status"]) for x in r["resources"]) \
        == [("authn_0_mysql", "mysql", "connected"),
            ("authn_1_postgresql", "pgsql", "connected"),
            ("authz_0_redis", "redis", "connected"),
            ("authz_1_postgresql", "pgsql", "connected"),
            ("up", "mqtt", "connected")]
    f = a["flood"]
    q1 = 8 * len(range(0, 2000 // 8, 4))      # every 4th at QoS 1
    assert f["delivered"] == 2000 and f["device_share"] >= 0.9
    assert f["forbidden_rcs"] == [0x87] * 100
    assert a["remote_got"] == a["remote_distinct"] == q1
    assert a["r_up"] == {"sql.matched": a["r_up"]["sql.matched"],
                         "sql.passed": q1, "actions.success": q1}
    assert a["window_err"] == 0
    assert b["queued_in_outage"] == cs.DB_BRIDGE_DOWN == 500
    assert b["remote_during_outage"] == cs.DB_BRIDGE_UP == 1000
    assert b["remote_got"] == 1500 and b["in_order_once"] and b["topics_ok"]
    assert b["ingress"] == cs.DB_BRIDGE_IN == 50
    assert c["connacks"] == {"ldap_ok": 0, "ldap_wrong": 0x86,
                             "mysql_wrong": 0x86}
    assert c["resources_after_stop"] == 0
    assert all(o == cl and o > 0 for o, cl in c["connections"].values())
    q = r["queries"]
    assert q["got"] == q["want"]
    assert q["connects"] == {"pgsql": 8, "mysql": 18, "ldap": 2}
    assert q["want"]["pgsql_acl"] == 100 and q["authz_misses"] >= 2000
