"""Global ordered-callback hook registry.

Parity: emqx_hooks.erl — priority-ordered callback chains behind every
extension point (`client.*`, `session.*`, `message.*` hookpoints), with
`run` (fire-and-forget chain, callback may `stop`) and `run_fold`
(accumulator threads through, callback may `{stop,Acc}`) semantics
(emqx_hooks.erl:161-196).

Callbacks return:
  None / "ok"            → continue with unchanged acc
  ("ok", acc)            → continue with new acc (run_fold)
  "stop"                 → stop the chain
  ("stop", acc)          → stop with new acc (run_fold)
"""

from __future__ import annotations

import bisect
import inspect
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# Highest-priority built-in hooks (reference ?HP_* in emqx_hooks.hrl)
HP_AUTHN = 1000
HP_AUTHZ = 1000
HP_RETAINER = 0
HP_RULE_ENGINE = -10
HP_LOWEST = -1000

# The reference's 20 hookpoints (exhook.proto:27-69 / emqx_hooks usage sites)
HOOKPOINTS = [
    "client.connect", "client.connack", "client.connected",
    "client.disconnected", "client.authenticate", "client.authorize",
    "client.subscribe", "client.unsubscribe",
    "session.created", "session.subscribed", "session.unsubscribed",
    "session.resumed", "session.discarded", "session.takenover",
    "session.terminated",
    "message.publish", "message.delivered", "message.acked",
    "message.dropped",
    "alarm.activated", "alarm.deactivated",
    "delivery.dropped", "delivery.completed",
]


@dataclass(order=True)
class Callback:
    sort_key: tuple = field(init=False, repr=False)
    priority: int
    seq: int
    action: Callable = field(compare=False)
    filter: Optional[Callable] = field(compare=False, default=None)
    tag: Optional[str] = field(compare=False, default=None)

    def __post_init__(self):
        # higher priority first; FIFO within a priority (emqx_hooks.erl:74-83)
        self.sort_key = (-self.priority, self.seq)


class Hooks:
    """One registry instance per broker node (the reference's ETS table)."""

    def __init__(self):
        self._chains: dict[str, list[Callback]] = {}
        self._lock = threading.Lock()
        self._seq = 0

    def add(self, name: str, action: Callable, priority: int = 0,
            filter: Optional[Callable] = None,
            tag: Optional[str] = None) -> None:
        """Parity: emqx_hooks:add/2,3,4."""
        with self._lock:
            self._seq += 1
            cb = Callback(priority=priority, seq=self._seq, action=action,
                          filter=filter, tag=tag)
            chain = self._chains.setdefault(name, [])
            bisect.insort(chain, cb)

    def delete(self, name: str, action_or_tag: Any) -> None:
        """Parity: emqx_hooks:del/2 — by callable or by tag."""
        with self._lock:
            chain = self._chains.get(name, [])
            self._chains[name] = [
                cb for cb in chain
                if cb.action is not action_or_tag and cb.tag != action_or_tag]

    def lookup(self, name: str) -> list[Callback]:
        return list(self._chains.get(name, []))

    def run(self, name: str, args: tuple = ()) -> None:
        """Parity: emqx_hooks:run/2 — no accumulator, 'stop' halts chain."""
        for cb in self._chains.get(name, ()):
            if cb.filter and not cb.filter(*args):
                continue
            res = cb.action(*args)
            if res == "stop" or (isinstance(res, tuple) and res[:1] == ("stop",)):
                return

    @staticmethod
    def _fold_step(res: Any, acc: Any) -> tuple[bool, Any]:
        """Interpret one callback result → (stop?, new_acc).

        None/'ok' keep acc; 'stop' halts; ('ok'|'stop', acc) thread/halt
        with a new acc; any bare value becomes the new acc."""
        if res is None or res == "ok":
            return False, acc
        if res == "stop":
            return True, acc
        if isinstance(res, tuple) and len(res) == 2:
            verb, new_acc = res
            if verb == "ok":
                return False, new_acc
            if verb == "stop":
                return True, new_acc
        return False, res

    def run_fold(self, name: str, args: tuple, acc: Any) -> Any:
        """Parity: emqx_hooks:run_fold/3 — threads acc; ('stop',acc) halts.

        Async callbacks (exhook) are skipped here — they only take effect
        on the awaited paths (run_fold_async / Broker.publish_async)."""
        for cb in self._chains.get(name, ()):
            if cb.filter and not cb.filter(*args, acc):
                continue
            res = cb.action(*args, acc)
            if inspect.isawaitable(res):
                res.close()
                continue
            stop, acc = self._fold_step(res, acc)
            if stop:
                return acc
        return acc

    async def run_fold_async(self, name: str, args: tuple, acc: Any) -> Any:
        """run_fold that awaits coroutine callbacks (HTTP authn/authz,
        exhook gRPC — the reference blocks the channel process for these;
        here the connection task awaits without blocking the loop)."""
        for cb in self._chains.get(name, ()):
            if cb.filter and not cb.filter(*args, acc):
                continue
            res = cb.action(*args, acc)
            if inspect.isawaitable(res):
                res = await res
            stop, acc = self._fold_step(res, acc)
            if stop:
                return acc
        return acc
