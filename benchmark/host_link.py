"""The host link of one NVIDIA H100 SXM and the least time of a readback.

The card reaches host memory over PCIe Gen5 x16: 64 GB/s a direction
(128 GB/s both ways, NVIDIA's data sheet). The least time of a window's
readback is the bytes it copies into host memory over that rate.
"""

from __future__ import annotations

D2H_BYTES_PER_S = 64e9


def readback_s(n_bytes: float) -> float:
    return n_bytes / D2H_BYTES_PER_S
