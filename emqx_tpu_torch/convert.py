"""Carry built routing tables across: numpy planes → the port's tensors.

For a broker the routing tables are the state. ``tables_from_numpy``
takes the ``ShapeTables`` and ``SubTable`` that either package's host-side
table build returns (named tuples of numpy arrays — the JAX package's
``build_shape_tables`` / ``build_subtable`` or the port's copies) and
uploads them, dtypes unchanged, to ``device``. ``router_tables_from_numpy``
does the same for the trie backend's ``TrieTables`` + ``SubTable``, and
``stacked_from_numpy`` for a per-shard pytree stacked on a leading route
axis (``parallel.sharded.stack_tables``). Subscription-covering state
(``ops.cover.CoverTables`` on a table's ``cover`` field) rides along
through ``cover_from_numpy``.

Access control carries state too: ``load_auth_records`` fills the port's
built-in user store and SCRAM credential store from the reference's
records, given as plain dicts, with their salts and hashes unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from emqx_tpu_torch.device import resolve_device
from emqx_tpu_torch.models.router_engine import (RouterTables,
                                                 ShapeRouterTables)
from emqx_tpu_torch.ops.cover import CoverTables, host_facts, note_host
from emqx_tpu_torch.ops.fanout import SubTable
from emqx_tpu_torch.ops.shapes import ShapeTables
from emqx_tpu_torch.ops.trie import TrieTables

_SHAPE_PLANES = ("shape_plus_mask", "shape_len", "shape_has_hash",
                 "shape_wild_root", "buckets")


def tree_map(fn, tree):
    """Apply fn to every leaf of a (nested) NamedTuple of tables; None
    leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    return fn(tree)


def _upload(dev):
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return up


def cover_from_numpy(ct, device=None):
    """Upload host-built subscription-covering tables (either package's
    ``CoverTables`` of numpy arrays) to ``device``, dtypes unchanged;
    None stays None."""
    if ct is None:
        return None
    up = _upload(resolve_device(device))
    out = CoverTables(*[up(getattr(ct, k)) for k in CoverTables._fields])
    facts = host_facts(ct)
    note_host(out.vlens, "depth", facts["depth"])
    note_host(out.exp_start, "seg", facts["seg"])
    return out


def trie_from_numpy(trie, device=None) -> TrieTables:
    """Upload host-built trie tables to ``device`` (``cuda`` by default).
    The node/edge counts become 0-d tensors."""
    dev = resolve_device(device)
    up = _upload(dev)
    return TrieTables(*[up(getattr(trie, k))
                        for k in TrieTables._fields[:-1]],
                      cover=cover_from_numpy(getattr(trie, "cover", None),
                                             dev))


def router_tables_from_numpy(trie, subs, device=None) -> RouterTables:
    """Upload host-built trie and subscriber tables to ``device`` (``cuda``
    by default)."""
    dev = resolve_device(device)
    sub = SubTable(*[_upload(dev)(getattr(subs, k)) for k in SubTable._fields])
    return RouterTables(trie=trie_from_numpy(trie, dev), subs=sub)


def stacked_from_numpy(stacked, device=None):
    """Upload a stacked per-shard pytree (``RouterTables`` or
    ``ShapeRouterTables`` of [R, ...] numpy planes) to ``device``, every
    leaf a tensor with its leading route axis."""
    return tree_map(_upload(resolve_device(device)), stacked)


def tables_from_numpy(shapes, subs, device=None) -> ShapeRouterTables:
    """Upload host-built shape and subscriber tables to ``device``
    (``cuda`` by default; raises without CUDA unless ``device='cpu'``)."""
    dev = resolve_device(device)
    up = _upload(dev)
    st = ShapeTables(**{k: up(getattr(shapes, k)) for k in _SHAPE_PLANES},
                     n_shapes=int(shapes.n_shapes),
                     n_filters=int(shapes.n_filters),
                     cover=cover_from_numpy(getattr(shapes, "cover", None),
                                            dev))
    sub = SubTable(*[up(getattr(subs, k)) for k in SubTable._fields])
    return ShapeRouterTables(shapes=st, subs=sub)


def load_auth_records(builtin=None, users=None, scram=None,
                      credentials=None) -> None:
    """Fill the port's authentication stores from the reference's records.

    ``users`` maps a user id to ``{"password_hash", "salt",
    "is_superuser"}`` (a ``BuiltinDB``'s records) and is copied into
    ``builtin`` (an ``apps.authn.BuiltinDB``); ``credentials`` maps a
    username to a SCRAM credential (``stored_key``, ``server_key``,
    ``salt``, ``iteration_count``, ``algorithm``, ``is_superuser``, as
    ``utils.scram.make_credentials`` and ``ScramAuthenticator.add_user``
    make it) and is copied into ``scram`` (an
    ``apps.authn_db.ScramAuthenticator``). The salts and hashes are taken
    as they are, so both packages accept and refuse the same passwords.
    """
    for uid, rec in (users or {}).items():
        builtin._users[uid] = {"password_hash": str(rec["password_hash"]),
                               "salt": str(rec.get("salt", "")),
                               "is_superuser": bool(rec.get("is_superuser",
                                                            False))}
    for name, cred in (credentials or {}).items():
        scram._users[name] = {
            "stored_key": bytes(cred["stored_key"]),
            "server_key": bytes(cred["server_key"]),
            "salt": bytes(cred["salt"]),
            "iteration_count": int(cred["iteration_count"]),
            "algorithm": cred.get("algorithm", scram.algorithm),
            "is_superuser": bool(cred.get("is_superuser", False))}
