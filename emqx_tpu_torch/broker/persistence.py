"""Checkpoint/resume: durable state snapshot + write-ahead op log.
Parity: SURVEY.md §5.4 — the reference has no whole-broker checkpoint;
durability is per-subsystem (retained/delayed in mnesia disc copies,
sessions via takeover, bridge egress via replayq). The TPU-era design makes
the device tables SOFT state rebuilt from a host-side durable log: snapshot
= the authoritative host structures (routes, retained, delayed, parked
sessions) serialized to disk; resume = load snapshot, replay the op log
written since, then recompile the device trie from the restored routes.
Log entries ride the replayq segment format (fsync'd, torn-tail safe).
The port's copy of ``emqx_tpu/broker/persistence.py``: the same JSON
snapshot and the same replayq segments, so a snapshot and a log written by
either package restore in the other. The codec (``_enc`` / ``_dec`` /
``_dec_deep``) also serves the retainer's disc journal
(``apps/retainer.DiscStorage``).
"""

from __future__ import annotations
import base64
import json
import logging
import os
import time
from typing import Optional

from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.broker.session import Session
from emqx_tpu_torch.utils.replayq import ReplayQ

log = logging.getLogger("emqx_tpu_torch.persistence")

SNAPSHOT = "snapshot.json"
WAL_DIR = "wal"

def _enc(o):
    if isinstance(o, (bytes, bytearray)):
        return {"$b": base64.b64encode(bytes(o)).decode()}
    raise TypeError(repr(o))

def _dec(v):
    if isinstance(v, dict) and "$b" in v:
        return base64.b64decode(v["$b"])
    return v

def _dec_deep(o):
    if isinstance(o, dict):
        if "$b" in o and len(o) == 1:
            return _dec(o)
        return {k: _dec_deep(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_dec_deep(v) for v in o]
    return o

class Persistence:
    """Attach to a Node: journals retained/delayed/route mutations and
    snapshots+restores the whole durable state."""

    def __init__(self, node, data_dir: str):
        self.node = node
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.wal = ReplayQ(os.path.join(data_dir, WAL_DIR))
        node.persistence = self
    # ---- write-ahead log ----
    def journal(self, op: str, **fields) -> None:
        fields["op"] = op
        self.wal.append(json.dumps(fields, default=_enc).encode())

    # ---- snapshot ----
    def save_snapshot(self) -> str:
        """Serialize durable state; truncates the WAL (entries are now
        reflected in the snapshot)."""
        node = self.node
        from emqx_tpu_torch.apps.delayed import DelayedPublish
        from emqx_tpu_torch.apps.retainer import Retainer
        snap: dict = {"version": 1, "ts": int(time.time() * 1000),
                      "node": node.name}
        snap["routes"] = {
            "exact": sorted(node.router.exact),
            "wildcards": sorted(node.router.wildcards)}
        retainer = node.get_app(Retainer)
        if retainer is not None:
            snap["retained"] = [
                {"msg": m.to_wire(), "expire_at": exp}
                for _t, m, exp in retainer.storage.items()]
        delayed = node.get_app(DelayedPublish)
        if delayed is not None:
            snap["delayed"] = [
                {"msg": m.to_wire(), "fire_at": at}
                for at, _seq, m in delayed.pending()]
        snap["sessions"] = {
            cid: s.to_wire() for cid, s in node.cm._detached.items()}
        path = os.path.join(self.data_dir, SNAPSHOT)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, default=_enc)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # WAL reset: everything journaled so far is inside the snapshot
        items, ref = self.wal.pop(1 << 30)
        if ref is not None:
            self.wal.ack(ref)
        return path
    def load_snapshot(self) -> bool:
        """Restore state from disk; then replay WAL entries written after
        the snapshot. Returns False when no snapshot exists."""
        path = os.path.join(self.data_dir, SNAPSHOT)
        try:
            with open(path) as f:
                snap = _dec_deep(json.load(f))
        except FileNotFoundError:
            snap = None
        if snap is not None:
            self._apply_snapshot(snap)
        # WAL replay (ops since the snapshot)
        items, _ref = self.wal.pop(1 << 30)
        for raw in items:
            try:
                self._apply_wal(_dec_deep(json.loads(raw)))
            except Exception:  # noqa: BLE001 — one bad entry never blocks boot
                log.exception("WAL entry replay failed")
        # recompile the device tables from the restored route set
        if self.node.router.use_device and self.node.router.wildcards:
            self.node.router.rebuild()
        return snap is not None

    def _apply_snapshot(self, snap: dict) -> None:
        node = self.node
        from emqx_tpu_torch.apps.delayed import DelayedPublish
        from emqx_tpu_torch.apps.retainer import Retainer
        for t in snap.get("routes", {}).get("exact", []):
            node.router.add_route(t)
        for t in snap.get("routes", {}).get("wildcards", []):
            node.router.add_route(t)
        retainer = node.get_app(Retainer)
        if retainer is not None:
            for ent in snap.get("retained", []):
                msg = Message.from_wire(ent["msg"])
                retainer.storage.insert(msg.topic, msg,
                                        ent.get("expire_at"))
        delayed = node.get_app(DelayedPublish)
        if delayed is not None:
            now = int(time.time() * 1000)
            for ent in snap.get("delayed", []):
                msg = Message.from_wire(ent["msg"])
                delayed.restore(msg, max(ent["fire_at"], now + 1))
        for cid, wire in snap.get("sessions", {}).items():
            sess = Session.from_wire(wire)
            node.cm.park_session(cid, sess)

    def _apply_wal(self, entry: dict) -> None:
        node = self.node
        op = entry.get("op")
        from emqx_tpu_torch.apps.retainer import Retainer
        if op == "retain":
            retainer = node.get_app(Retainer)
            if retainer is not None:
                msg = Message.from_wire(entry["msg"])
                retainer.storage.insert(msg.topic, msg,
                                        entry.get("expire_at"))
        elif op == "retain_del":
            retainer = node.get_app(Retainer)
            if retainer is not None:
                retainer.delete(entry["topic"])
        elif op == "route_add":
            node.router.add_route(entry["topic"])
        elif op == "route_del":
            node.router.delete_route(entry["topic"])
        else:
            log.warning("unknown WAL op %r", op)

def attach_retainer_journal(node) -> bool:
    """Hook the retainer so every retained set/delete is WAL-journaled
    (the mnesia disc_copies analog)."""
    from emqx_tpu_torch.apps.retainer import Retainer
    retainer = node.get_app(Retainer)
    pers = getattr(node, "persistence", None)
    if retainer is None or pers is None:
        return False
    orig_insert, orig_delete = retainer._insert, retainer.delete

    def insert(msg):
        ok = orig_insert(msg)
        if ok:
            pers.journal("retain", msg=msg.to_wire(),
                         expire_at=retainer._expire_at(msg))
        return ok
    def delete(topic):
        ok = orig_delete(topic)
        if ok:
            pers.journal("retain_del", topic=topic)
        return ok
    retainer._insert = insert
    retainer.delete = delete
    return True
