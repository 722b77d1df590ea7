"""Mesh construction: a ('dp', 'route') grid of torch devices.

Counterpart of ``emqx_tpu/parallel/mesh.py`` (``make_mesh`` :12). The JAX
package is single-controller — one process drives every shard — and the
port keeps that model: a mesh is a ``[dp][route]`` grid of
``torch.device``s, and several shards may share one card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from emqx_tpu_torch.device import resolve_device


class Mesh(NamedTuple):
    """grid[d][r] is the device of shard (dp row d, route shard r)."""
    grid: tuple

    @property
    def dp(self) -> int:
        return len(self.grid)

    @property
    def route(self) -> int:
        return len(self.grid[0])

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "route": self.route}

    def devices(self) -> list:
        """The distinct devices of the grid, in grid order."""
        out: list = []
        for row in self.grid:
            for d in row:
                if d not in out:
                    out.append(d)
        return out


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              route: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('dp', 'route') mesh.

    Same split rules as the reference: all shards on 'route' by default,
    a given dp or route takes the rest, and ``dp * route != n_devices``
    raises ValueError. ``devices`` lists one device per shard (repeats
    allowed); without it every shard lives on ``cuda:0`` (or wherever a
    lone ``devices=[dev]`` entry says), and n_devices counts shards.
    """
    if devices is not None and len(devices) == 1 and n_devices:
        devs = [resolve_device(devices[0])] * n_devices
    elif devices is not None:
        devs = [resolve_device(d) for d in devices]
    else:
        if n_devices is None:
            n_devices = (dp or 1) * (route or 1)
        devs = [resolve_device("cuda:0")] * n_devices
    n = n_devices or len(devs)
    devs = devs[:n]
    if len(devs) < n:
        raise ValueError(f"{n} shards asked for, {len(devs)} devices given")
    if dp is None and route is None:
        dp, route = 1, n
    elif dp is None:
        dp = n // route
    elif route is None:
        route = n // dp
    if dp * route != n:
        raise ValueError(f"dp({dp}) * route({route}) != n_devices({n})")
    return Mesh(grid=tuple(tuple(torch.device(devs[d * route + r])
                                 for r in range(route))
                           for d in range(dp)))
