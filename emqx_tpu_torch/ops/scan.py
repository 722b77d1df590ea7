"""Kernel 2: ``prefix_sum`` — inclusive int32 scan along the last dim.

Replaces ``emqx_tpu/ops/pallas_scan.py`` ``prefix_sum_pallas`` (kernel
body ``_scan_kernel``) and stands in for its XLA twin
``emqx_tpu/ops/scan_ops.py`` ``cumsum_blocked``. On the port's main paths
it serves every scan: the compaction's batch-axis offsets
(``ops/compact.py``, ``[W, B]``) and its hole closing (``[W*B, M]``), the
fan-out segment offsets (``ops/fanout.py``, ``[W*B, M]``), the
shared-subscription run ids (``ops/shared.py``, ``[W*B*K]`` a window,
``[B*K]`` a step) and the window's cursor sums along its steps
(``[G, W]``), the trie NFA's emission and rank scans (``ops/match.py``)
and the mesh exchange's segment and rank scans (``parallel/sharded.py``).
The CUDA source (``csrc/prefix_sum.cu``) holds the design and its bound;
this module holds the launch plan (``scan_plan``), so the CPU tests can
check it, and the look-back status words, one buffer per (device,
stream) — or, for a launch captured into a CUDA graph, one of its own
that the graph re-zeroes.

Contract shared with the reference: int32 in, int32 out, exact while the
running total stays below 2^24 (past it both wrap modulo 2^32, as
``torch.cumsum`` does), ``ValueError`` for a scanned length above 2^24.
The plain version is ``torch.cumsum`` (``prefix_sum_ref``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from emqx_tpu_torch.device import count_launch
from emqx_tpu_torch.ops.build import check, library

MAX_LEN = 1 << 24
THREADS = 256            # threads per block, every path
SHORT, MID = 32, 1024    # the widest row of the short and of the mid path
LONG_ITEMS = (4, 8, 16)  # elements per thread of a long tile, smallest first
MAX_TILES = 8192         # about eight waves of resident blocks on an H100
STRIDE = 4               # 64-bit words per status word (one 32-byte sector)
EPOCH_WRAP = 1 << 30     # the status word keeps 30 bits of epoch
_PATH_CODE = {"copy": 0, "short": 1, "mid": 2, "long": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint


class ScanPlan(NamedTuple):
    """The one kernel launch that scans an [R, n] input."""
    path: str          # copy (n == 1), short (n <= 32), mid (<= 1024), long
    items: int         # elements per thread (short: the row, one per thread)
    vec: bool          # 16-byte loads and stores (int2 for mid items 2)
    rows_per_block: int
    tiles: int         # blocks per row (long), else 1
    grid: int          # blocks of THREADS threads
    state_words: int   # 64-bit words of look-back status (0: none)


@functools.lru_cache(maxsize=1024)
def scan_plan(R: int, n: int, aligned: bool) -> ScanPlan:
    """The launch for R rows of n int32; ``aligned``: input and output
    start on a 16-byte boundary."""
    if n == 1:
        return ScanPlan("copy", 4, aligned, THREADS * 4, 1,
                        -(-R // (THREADS * 4)), 0)
    if n <= SHORT:
        return ScanPlan("short", n, aligned, THREADS, 1, -(-R // THREADS), 0)
    if n <= MID:
        # two rows per warp at items 2: a 64-wide row is one step, and a
        # warp keeps two rows' loads in flight
        items, rpw = (2, 2) if n <= 64 else (4, 1)
        rows = THREADS // 32 * rpw
        return ScanPlan("mid", items, aligned and n % items == 0, rows, 1,
                        -(-R // rows), 0)
    # the smallest tile that keeps the grid within a few waves: the tiles
    # load in parallel, and at these sizes the look-back chain, not the
    # per-tile work, sets the time
    for items in LONG_ITEMS:
        tiles = -(-n // (THREADS * items))
        if R * tiles <= MAX_TILES:
            break
    # a row starts 16-byte aligned when the base does and n % 4 == 0;
    # a single row's tail is masked per element
    vec = aligned and (n % 4 == 0 or R == 1)
    grid = R * tiles
    return ScanPlan("long", items, vec, 1, tiles, grid,
                    STRIDE * grid if tiles > 1 else 0)


class _State:
    """The look-back status words of one (device, stream), one per (row,
    tile) of a call; each call takes a new epoch."""
    __slots__ = ("words", "epoch")

    def __init__(self, words: torch.Tensor):
        self.words, self.epoch = words, 0


_STATES: dict[tuple[int, int], _State] = {}


def _state(dev: torch.device, stream: int, need: int) -> _State:
    key = (dev.index, stream)
    st = _STATES.get(key)
    if st is None or st.words.numel() < need:
        # zeroed on the caller's stream, the only one that uses it
        old = st.words.numel() if st is not None else 0
        st = _State(torch.zeros(max(need, 2 * old, 4096), dtype=torch.int64,
                                device=dev))
        _STATES[key] = st
    st.epoch += 1
    if st.epoch >= EPOCH_WRAP:
        st.words.zero_()
        st.epoch = 1
    return st


@functools.cache
def _bind():
    lib = library("prefix_sum")
    fn = lib.prefix_sum_launch
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _P]
    fn.restype = ctypes.c_int
    empty = lib.prefix_sum_empty_launch
    empty.argtypes = [_I, _P]
    empty.restype = ctypes.c_int
    return fn, empty


def _check_input(x: torch.Tensor) -> None:
    if x.dtype != torch.int32:
        raise ValueError(f"prefix_sum: expected int32, got {x.dtype}")
    if x.dim() == 0:
        raise ValueError("prefix_sum: expected at least one dimension")
    if x.shape[-1] > MAX_LEN:
        raise ValueError(
            f"prefix_sum: length {x.shape[-1]} exceeds the exact bound 2^24")


def prefix_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``torch.cumsum`` along the last dim, int32."""
    _check_input(x)
    return torch.cumsum(x, dim=-1, dtype=torch.int32)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along the last dimension of ``x``.

    A CUDA tensor launches the kernel once on the current stream; a CPU
    tensor runs ``prefix_sum_ref``.
    """
    if x.device.type == "cpu":
        return prefix_sum_ref(x)
    _check_input(x)
    if x.device.type != "cuda":
        raise ValueError(f"prefix_sum: unsupported device {x.device}")
    x = x.contiguous()
    n = x.shape[-1]
    R = x.numel() // n if n else 0
    y = torch.empty_like(x)
    if R == 0 or n == 0:
        return y
    p = scan_plan(R, n, x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    st = None
    if p.state_words and torch.cuda.is_current_stream_capturing():
        # captured into a CUDA graph, the launch replays with the epoch it
        # was captured with: it gets status words of its own, zeroed by
        # the graph itself before every replay
        st = _State(torch.zeros(p.state_words, dtype=torch.int64,
                                device=x.device))
        st.epoch = 1
    elif p.state_words:
        st = _state(x.device, stream, p.state_words)
    err = _bind()[0](
        x.data_ptr(), y.data_ptr(), st and st.words.data_ptr(), R, n,
        _PATH_CODE[p.path], p.items, int(p.vec), p.grid, p.tiles,
        st.epoch if st else 0, stream)
    check(err, "prefix_sum")
    count_launch("prefix_sum", tuple(x.shape))
    return y


def empty_kernel(grid: int, device=None) -> None:
    """Launch an empty kernel of ``grid`` blocks of THREADS threads on the
    current stream: the launch floor a scan is timed against, not part of
    any scan."""
    stream = torch.cuda.current_stream(device).cuda_stream
    check(_bind()[1](grid, stream), "prefix_sum empty kernel")
