"""Cluster layer: membership, replicated metadata, data-plane RPC.

The port's copy of ``emqx_tpu/cluster/__init__.py`` (the port imports nothing
from ``emqx_tpu``).

Parity map (SURVEY.md §2.4 P4-P7, §5.8):
  - rpc.py        -> gen_rpc (key-pinned TCP channels; emqx_rpc.erl:20-60)
  - membership.py -> ekka membership/discovery (emqx_machine_schema.erl:66-111)
  - store.py      -> ekka_mnesia replicated tables (single-writer op log,
                     SURVEY.md §7 "cluster semantics without mnesia")
  - cluster.py    -> glue: route replication (emqx_router.erl ram_copies),
                     cross-node forwarding (emqx_broker.erl:262-280),
                     cluster-wide shared-sub dispatch, cm registry, locker
"""

from emqx_tpu_torch.cluster.cluster import ClusterNode
from emqx_tpu_torch.cluster.membership import Membership
from emqx_tpu_torch.cluster.rpc import RpcNode
from emqx_tpu_torch.cluster.store import ClusterStore

__all__ = ["ClusterNode", "Membership", "RpcNode", "ClusterStore"]
