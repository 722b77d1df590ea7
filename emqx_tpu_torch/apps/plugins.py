"""Plugin system: load/unload external feature modules.

Parity: emqx_plugins.erl — app-based plugins loaded at boot from a config
list (`plugins.load/0` emqx_plugins.erl:44-47), load/unload at runtime,
state listed by CLI/API. A plugin is a Python module (import path) exposing
`load(node, conf) -> instance` and the instance exposing `unload()` — the
shape of the reference's plugin-template application callbacks
(lib-extra/emqx_plugin_template).
"""

from __future__ import annotations

import importlib
import logging
from typing import Any, Optional

log = logging.getLogger("emqx_tpu_torch.plugins")


class Plugins:
    def __init__(self, node, conf: Optional[dict] = None):
        self.node = node
        c = dict(node.config.get("plugins") or {})
        c.update(conf or {})
        # [{"name": ..., "module": "pkg.mod", "config": {...},
        #   "enabled": true}]
        self.declared = list(c.get("load", []))
        self._loaded: dict[str, Any] = {}
        node.plugins = self

    def load_all(self) -> int:
        """Boot-time load of every enabled declared plugin."""
        n = 0
        for decl in self.declared:
            if decl.get("enabled", True):
                try:
                    self.load(decl["name"], decl["module"],
                              decl.get("config"))
                    n += 1
                except Exception:  # noqa: BLE001 — one bad plugin never
                    log.exception("plugin %s failed to load",
                                  decl.get("name"))   # blocks the boot
        return n

    def load(self, name: str, module_path: str,
             conf: Optional[dict] = None) -> Any:
        if name in self._loaded:
            raise ValueError(f"plugin {name} already loaded")
        mod = importlib.import_module(module_path)
        if not hasattr(mod, "load"):
            raise ValueError(f"{module_path} has no load(node, conf)")
        inst = mod.load(self.node, conf or {})
        self._loaded[name] = inst
        log.info("plugin %s loaded from %s", name, module_path)
        return inst

    def unload(self, name: str) -> bool:
        inst = self._loaded.pop(name, None)
        if inst is None:
            return False
        unload = getattr(inst, "unload", None)
        if unload is not None:
            try:
                unload()
            except Exception:  # noqa: BLE001
                log.exception("plugin %s unload failed", name)
        return True

    def unload_all(self) -> None:
        for name in list(self._loaded):
            self.unload(name)

    def is_loaded(self, name: str) -> bool:
        return name in self._loaded

    def list(self) -> list[dict]:
        out = []
        seen = set()
        for decl in self.declared:
            name = decl["name"]
            seen.add(name)
            out.append({"name": name, "module": decl["module"],
                        "enabled": name in self._loaded})
        for name in self._loaded:
            if name not in seen:
                out.append({"name": name, "module": "?",
                            "enabled": True})
        return out
