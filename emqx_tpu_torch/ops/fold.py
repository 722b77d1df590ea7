"""Kernel 1: ``shape_match`` — the shape-hash fold fused with the probe.

Replaces ``emqx_tpu/ops/pallas_fold.py`` ``shape_fold_pallas`` (kernel
body ``_fold_kernel``), which computed the fold, the two-choice homes and
the compat mask on the TPU and left the two ``buckets[home]`` row-gathers
of ``_probe_buckets`` to XLA because Mosaic has no large-table vector
gather. The CUDA kernel (``csrc/shape_match.cu``) does all of it: one
thread per topic, the topic's words in registers, a loop over the
(<= 32) shapes with their metadata and seeds in shared memory, then the
two bucket rows read as six 16-byte loads each. It writes ``matches
[B, NSc]`` and ``counts [B]`` directly, and optionally the five fold
planes so the fold itself can be held against ``fold_ref``.

Bound: memory. Per topic it must read its words (L*4 B), length and
'$' flag, one 96 B bucket row per compatible shape (two where the first
row misses) and write 4*NSc + 4 B. At the bench shape (L=8, NSc=1) that
is ~190 B per topic, ~25 MB per 131072-topic batch, ~7.5 us at
3.35 TB/s; the 10M-filter bucket table (2^21 rows x 96 B = 201 MB) is
four times the 50 MB L2, so the rows come from HBM. The design reads
each row once as whole 16-byte vectors, skips the row reads for
incompatible lanes and the second row after a first-row hit, and keeps
every hash intermediate in registers.

The plain version is ``shapes.shape_match_ref`` (fold_ref + probe_ref).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from emqx_tpu_torch.device import count_launch
from emqx_tpu_torch.ops.build import check, library

MAX_LEVELS = 20   # shape tables support at most 20 levels
MAX_SHAPES = 32   # DEFAULT_SHAPE_CAP; the kernel keeps shapes in smem
ROW_INTS = 24     # 3 * BK int32 per bucket row

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _bind():
    fn = library("shape_match").shape_match_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                   _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _need(t: torch.Tensor, dtype, what: str) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"shape_match: {what} must be a contiguous CUDA "
                         f"{dtype} tensor, got {t.dtype} on {t.device}")


def launch_shape_match(st, topics: torch.Tensor, lens: torch.Tensor,
                       is_dollar: torch.Tensor, *, fold_planes: bool = False):
    """Launch the fused fold+probe kernel on the current stream.

    Returns (matches [B, NSc], counts [B]) int32, plus the five fold
    planes (h1, h2, b1, b2, compat) [B, NSc] int32 when ``fold_planes``.
    """
    B, L = topics.shape
    NSc = st.shape_plus_mask.shape[0]
    NB = st.buckets.shape[0]
    _need(topics, torch.int32, "topics")
    _need(lens, torch.int32, "lens")
    _need(is_dollar, torch.bool, "is_dollar")
    for name in ("shape_plus_mask", "shape_len", "shape_has_hash",
                 "shape_wild_root", "buckets"):
        _need(getattr(st, name), torch.int32, name)
    if L > MAX_LEVELS or NSc > MAX_SHAPES:
        raise ValueError(f"shape_match: L={L} > {MAX_LEVELS} or "
                         f"NSc={NSc} > {MAX_SHAPES}")
    if NB & (NB - 1) or st.buckets.shape[1] != ROW_INTS:
        raise ValueError("shape_match: buckets must be [pow2, 24]")
    if st.buckets.data_ptr() % 16:
        raise ValueError("shape_match: buckets must be 16-byte aligned")
    dev = topics.device
    matches = torch.empty((B, NSc), dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    planes = [torch.empty((B, NSc), dtype=torch.int32, device=dev)
              for _ in range(5)] if fold_planes else []
    if B == 0:
        return (matches, counts, *planes)
    fn = _bind()
    ptrs = [p.data_ptr() for p in planes] if planes else [None] * 5
    err = fn(topics.data_ptr(), lens.data_ptr(), is_dollar.data_ptr(),
             st.shape_plus_mask.data_ptr(), st.shape_len.data_ptr(),
             st.shape_has_hash.data_ptr(), st.shape_wild_root.data_ptr(),
             st.buckets.data_ptr(), matches.data_ptr(), counts.data_ptr(),
             *ptrs, B, L, NSc, NB,
             torch.cuda.current_stream(dev).cuda_stream)
    check(err, "shape_match")
    count_launch("shape_match", (B, L))
    return (matches, counts, *planes)
