"""Alarm lifecycle with history + hooks.

The port's copy of ``emqx_tpu/broker/alarm.py``; the overload governor
raises its ``overload`` and ``overload_stuck`` alarms here.

Parity: apps/emqx/src/emqx_alarm.erl — `activate(Name, Details)` /
`deactivate(Name)` maintain an activated table and a size-capped
deactivated history (emqx_alarm.erl:58-69); transitions run the
`alarm.activated` / `alarm.deactivated` hookpoints.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Alarm:
    name: str
    details: dict = field(default_factory=dict)
    message: str = ""
    activate_at: float = field(default_factory=time.time)
    deactivate_at: Optional[float] = None

    def to_map(self) -> dict:
        return {"name": self.name, "details": self.details,
                "message": self.message,
                "activate_at": int(self.activate_at * 1000),
                "deactivate_at": (None if self.deactivate_at is None
                                  else int(self.deactivate_at * 1000))}


class AlarmManager:
    def __init__(self, hooks=None, size_limit: int = 1000,
                 validity_period: float = 24 * 3600.0):
        self.hooks = hooks
        self.size_limit = size_limit
        self.validity_period = validity_period
        self._activated: dict[str, Alarm] = {}
        self._history: list[Alarm] = []

    def activate(self, name: str, details: Optional[dict] = None,
                 message: str = "") -> bool:
        """Returns False if already active (emqx_alarm returns
        {error, already_existed})."""
        if name in self._activated:
            return False
        a = Alarm(name, dict(details or {}), message or name)
        self._activated[name] = a
        if self.hooks is not None:
            self.hooks.run("alarm.activated", (a.to_map(),))
        return True

    def deactivate(self, name: str) -> bool:
        a = self._activated.pop(name, None)
        if a is None:
            return False
        a.deactivate_at = time.time()
        self._history.append(a)
        while len(self._history) > self.size_limit:
            self._history.pop(0)
        if self.hooks is not None:
            self.hooks.run("alarm.deactivated", (a.to_map(),))
        return True

    def ensure(self, name: str, active: bool,
               details: Optional[dict] = None, message: str = "") -> None:
        """Edge-triggered helper for watermark monitors."""
        if active:
            self.activate(name, details, message)
        else:
            self.deactivate(name)

    def is_active(self, name: str) -> bool:
        return name in self._activated

    def get_alarms(self, which: str = "all") -> list[dict]:
        act = [a.to_map() for a in self._activated.values()]
        if which == "activated":
            return act
        hist = [a.to_map() for a in self._history]
        if which == "deactivated":
            return hist
        return act + hist

    def delete_all_deactivated(self) -> int:
        n = len(self._history)
        self._history.clear()
        return n

    def tick(self) -> None:
        """Expire deactivated history past validity_period."""
        cutoff = time.time() - self.validity_period
        self._history = [a for a in self._history
                         if (a.deactivate_at or 0) >= cutoff]
