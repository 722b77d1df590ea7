"""Duration and byte-size coercion for config values.

The port's copy of the two helpers of ``emqx_tpu/utils/hocon.py`` that the
config schema check uses ("30s" -> 30.0, "16KB" -> 16384). The HOCON file
loader itself is not part of the port.
"""

from __future__ import annotations

import re
from typing import Optional

_DURATION_RE = re.compile(
    r"^(\d+(?:\.\d+)?)(ms|s|m|h|d|w)$")
_SIZE_RE = re.compile(r"^(\d+(?:\.\d+)?)(kb|mb|gb|b)$", re.IGNORECASE)
_DURATION_UNITS = {"ms": 0.001, "s": 1, "m": 60, "h": 3600, "d": 86400,
                   "w": 604800}
_SIZE_UNITS = {"b": 1, "kb": 1024, "mb": 1024 ** 2, "gb": 1024 ** 3}


def parse_duration(s: str) -> Optional[float]:
    """"30s" -> 30.0; "100ms" -> 0.1; None when not a duration string."""
    m = _DURATION_RE.match(s.strip())
    if not m:
        return None
    val = float(m.group(1)) * _DURATION_UNITS[m.group(2)]
    return val


def parse_size(s: str) -> Optional[int]:
    """"16KB" -> 16384; None when not a size string."""
    m = _SIZE_RE.match(s.strip())
    if not m:
        return None
    return int(float(m.group(1)) * _SIZE_UNITS[m.group(2).lower()])
