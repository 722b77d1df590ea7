"""chip_smoke.py's phase 17 (the cluster on the card) rehearsed on the
CPU at a reduced size: 5,000 filters, a 2,000-message flood over two
clustered nodes, one kill cycle of the chaos drive over three
``python -m emqx_tpu_torch.run_node --device cpu`` processes, checkpoint
and resume with 2,000 retained and 200 log entries, and 1,024 messages
through a mesh node under a cluster. The choosers are pinned to the
device engine (on the CPU the host path wins them)."""

import torch

import chip_smoke as cs

torch.set_num_threads(1)


def test_chip_smoke_cluster_on_cpu():
    r = cs.cluster_drive(torch.device("cpu"), n_filters=5000, total=2000,
                         restore_total=1024, retained=2000, wal_ops=200,
                         mesh_total=1024, cycles=1, pin_device=True)
    a, b, c, d = r["a"], r["b"], r["c"], r["d"]
    assert a["flood"]["delivered"] == 2000
    for snap in a["snapshots"]:
        assert snap["filters"] == a["filters"]
        assert snap["remote_members"] == a["shared_filters"]
    for p in a["nodes"]:
        assert p["remote_shared"] > 0 and p["forwards_sent"] > 0
        assert p["forwards_received"]["dispatch"] > 0
    assert a["sync"]["from_peer"] == a["subscriptions"]
    assert a["single_add"]["lost"] == 0
    assert [x["cycle"] for x in b["cycles"]] == [0]
    assert c["restored"]["retained"] == 2200
    assert c["replay"]["replayed"] == 2200
    assert c["flood"]["delivered"] == c["flood"]["original_delivered"] > 0
    assert c["flood"]["received"] == c["flood"]["delivered"]
    assert d["remote_shared"] > 0 and d["exchange_windows"] == 0
    assert d["precluded"] == d["windows"]
