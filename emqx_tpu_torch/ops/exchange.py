"""Kernel 3: ``ring_rotate`` — rotate blocks k hops around the route ring.

Counterpart of ``emqx_tpu/ops/pallas_exchange.py``: ``ring_rotate`` (:47)
and its remote-DMA kernel ``_rotate_pallas`` (:67). ``blocks`` is a
``[dp][route]`` grid of equal-shape int32 tensors, one per shard; after
the call ``out[d][(r + k) % R]`` holds ``blocks[d][r]`` — the permutation
of the reference's ``ppermute`` (:63-64): each shard sends to the shard k
positions to its right.

``ring_rotate`` launches ``csrc/ring_rotate.cu`` once per source card per
call (the source holds the design and its bound); ``ring_rotate_ref`` is
the plain version, one ``copy_`` per block. Both write into ``out`` when
given — the exchange passes the receivers' recv slots, so the copy lands
where the merge reads it. CPU tensors take the plain version; CUDA
tensors launch the kernel or raise. Rotation never goes through
``torch.distributed``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from emqx_tpu_torch.device import count_launch
from emqx_tpu_torch.ops.build import check, library

MAX_PAIRS = 64     # pairs per launch in csrc/ring_rotate.cu

_P = ctypes.c_void_p


@functools.cache
def _bind():
    lib = library("ring_rotate")
    fn = lib.ring_rotate_launch
    ptrs = ctypes.POINTER(_P)
    fn.argtypes = [ptrs, ptrs, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   _P]
    fn.restype = ctypes.c_int
    peer = lib.ring_enable_peer
    peer.argtypes = [ctypes.c_int, ctypes.c_int]
    peer.restype = ctypes.c_int
    return fn, peer


@functools.cache
def enable_peer(device: int, peer: int) -> None:
    """Map card `peer`'s memory into card `device` (once per pair);
    raises if the pair cannot peer."""
    err = _bind()[1](device, peer)
    if err == -1:
        raise RuntimeError(f"ring_rotate: cuda:{device} cannot access "
                           f"cuda:{peer} as a peer")
    check(err, f"ring_rotate: enable peer cuda:{device} -> cuda:{peer}")


def _out_grid(blocks, out):
    """The destination grid: given, or fresh tensors each on the device of
    the shard it belongs to."""
    if out is not None:
        return out
    return [[torch.empty_like(row[r]) for r in range(len(row))]
            for row in blocks]


def _pairs(blocks, k: int, out):
    R = len(blocks[0])
    for d, row in enumerate(blocks):
        for r, src in enumerate(row):
            yield src, out[d][(r + k) % R]


def ring_rotate_ref(blocks, k: int, out=None):
    """The plain version: ``out[d][(r + k) % R].copy_(blocks[d][r])``."""
    out = _out_grid(blocks, out)
    for src, dst in _pairs(blocks, k, out):
        dst.copy_(src)
    return out


def _check(blocks, out) -> tuple:
    first = blocks[0][0]
    for row, orow in zip(blocks, out):
        if len(row) != len(blocks[0]) or len(orow) != len(row):
            raise ValueError("ring_rotate: ragged shard grid")
        for t in (*row, *orow):
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError("ring_rotate: blocks must be contiguous "
                                 "int32")
            if t.numel() != first.numel():
                raise ValueError("ring_rotate: blocks differ in size")
            if t.device.type != first.device.type:
                raise ValueError("ring_rotate: CPU and CUDA blocks mixed")
    return first.device.type, first.numel()


def ring_rotate(blocks, k: int, out=None):
    """Rotate a [dp][route] grid of blocks k hops around the route ring:
    ``out[d][(r + k) % R]`` receives ``blocks[d][r]``. Returns ``out``."""
    out = _out_grid(blocks, out)
    kind, n = _check(blocks, out)
    if kind == "cpu":
        return ring_rotate_ref(blocks, k, out)
    if kind != "cuda":
        raise ValueError(f"ring_rotate: unsupported device {kind}")
    by_src: dict = {}
    for src, dst in _pairs(blocks, k, out):
        by_src.setdefault(src.device.index, []).append((src, dst))
    launch = _bind()[0]
    for dev, pairs in by_src.items():
        stream = torch.cuda.current_stream(dev)
        peers = sorted({dst.device.index for _, dst in pairs} - {dev})
        for p in peers:
            enable_peer(dev, p)
            # the destination's stream is done with its buffer first
            stream.wait_stream(torch.cuda.current_stream(p))
        for i in range(0, len(pairs), MAX_PAIRS):
            chunk = pairs[i:i + MAX_PAIRS]
            srcs = (_P * len(chunk))(*(s.data_ptr() for s, _ in chunk))
            dsts = (_P * len(chunk))(*(t.data_ptr() for _, t in chunk))
            err = launch(srcs, dsts, len(chunk), n, dev, stream.cuda_stream)
            check(err, "ring_rotate")
            count_launch("ring_rotate")
        for p in peers:
            # the destination reads its slots only after the copy
            torch.cuda.current_stream(p).wait_stream(stream)
            for _, dst in pairs:
                if dst.device.index == p:
                    dst.record_stream(stream)
    return out
