"""The port's broker runtime: the single-chip serving path.

Listener → connection → channel → PublishBatcher → DeviceRouteEngine →
sessions → socket, as ``emqx_tpu/broker`` wires it, with the device route
window running on the card through the port's kernels. Every module here
is the port's own copy of its ``emqx_tpu/broker`` counterpart (or, for the
engine and the node, a rewrite on PyTorch); nothing is imported from the
JAX package.
"""
