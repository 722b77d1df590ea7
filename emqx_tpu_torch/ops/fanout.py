"""PUBLISH fan-out: matched filters → subscriber delivery rows.

Counterpart of ``emqx_tpu/ops/fanout.py``: subscribers live in one
columnar table (filter id → contiguous row range) and the fan-out of a
whole batch is a per-row searchsorted over per-topic segment offsets.
Overflowing topics are flagged for the host fallback.

Gathers clamp their indices into range, as JAX's gathers do, so an index
the reference would clamp never trips a device-side bounds assert.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from emqx_tpu_torch.ops.scan import prefix_sum


class SubTable(NamedTuple):
    """Columnar subscriber store (numpy after ``build_subtable``, torch
    tensors after ``convert.tables_from_numpy``).

    sub_start: [F+1] CSR offsets per filter id (F = filter capacity).
    sub_row:   [S] session row per subscription entry.
    sub_opts:  [S] int8 packed subopts: qos | nl<<2 | rap<<3 | rh<<4.
    fs_start:  [F+1] CSR offsets: filter id → shared-slot list.
    fs_slot:   [FS] shared-slot ids ((group, filter) pairs get dense ids).
    shared_start: [G+1] CSR offsets: shared slot → member list.
    shared_row:   [SM] session row per shared member.
    shared_opts:  [SM] int8 packed subopts per shared member.
    """

    sub_start: object
    sub_row: object
    sub_opts: object
    fs_start: object
    fs_slot: object
    shared_start: object
    shared_row: object
    shared_opts: object


class FanoutResult(NamedTuple):
    rows: torch.Tensor      # [B, D] session rows, -1 padded
    opts: torch.Tensor      # [B, D] packed subopts
    counts: torch.Tensor    # [B] true delivery count (may exceed D)
    overflow: torch.Tensor  # [B] bool


def take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[idx] with idx clamped into range (JAX gather semantics for
    the non-negative indices used here); `values` 1-D. The index keeps
    its dtype (no int64 copy of an int32 index plane)."""
    flat = idx.clamp(0, values.shape[0] - 1).reshape(-1)
    return values.index_select(0, flat).view(idx.shape)


def _segment_expand(starts: torch.Tensor, values: torch.Tensor,
                    seg_ids: torch.Tensor, cap: int, scan=prefix_sum):
    """Expand CSR segments selected per batch row into fixed-width outputs.

    starts: [F+1] CSR. values: [S]. seg_ids: [B, M] segment ids, -1 padded.
    Returns (out [B, cap] gathered values (-1 pad), idx [B, cap] flat
    indices into `values` (-1 pad), counts [B], overflow [B]).
    """
    B, M = seg_ids.shape
    valid = seg_ids >= 0
    safe = seg_ids.clamp(0, starts.shape[0] - 2)
    seg_lo = torch.where(valid, take(starts, safe), 0)
    seg_len = torch.where(valid, take(starts, safe + 1) - seg_lo, 0)
    ends = scan(seg_len.to(torch.int32))                       # [B, M]
    offs = ends - seg_len
    total = ends[:, -1]
    d = torch.arange(cap, dtype=torch.int32, device=seg_ids.device)
    # first segment whose inclusive end exceeds d
    seg_of = torch.searchsorted(ends, d.expand(B, cap).contiguous(),
                                right=True, out_int32=True)
    seg_of = seg_of.clamp(max=M - 1).long()
    in_range = d[None, :] < total[:, None]
    lo = torch.gather(seg_lo, 1, seg_of)
    off = torch.gather(offs, 1, seg_of)
    idx = torch.where(in_range, lo + (d[None, :] - off), -1).to(torch.int32)
    out = torch.where(in_range, take(values, idx), -1).to(values.dtype)
    return out, idx, total, total > cap


def fanout_normal(table: SubTable, matches: torch.Tensor, *,
                  fanout_cap: int = 128, scan=prefix_sum) -> FanoutResult:
    """Gather normal (non-shared) subscriber rows for matched filters.

    matches: [B, M] matched filter ids, -1 padded.
    """
    rows, idx, counts, overflow = _segment_expand(
        table.sub_start, table.sub_row, matches, fanout_cap, scan)
    opts = torch.where(idx >= 0, take(table.sub_opts, idx),
                       torch.zeros((), dtype=table.sub_opts.dtype,
                                   device=idx.device))
    return FanoutResult(rows=rows, opts=opts, counts=counts, overflow=overflow)


def shared_slots(table: SubTable, matches: torch.Tensor, *,
                 slot_cap: int = 16, scan=prefix_sum):
    """Expand matched filters into shared-subscription slot ids.

    Returns (sids [B, slot_cap] shared-slot ids (-1 pad), overflow [B]).
    """
    sids, _idx, _counts, overflow = _segment_expand(
        table.fs_start, table.fs_slot, matches, slot_cap, scan)
    return sids, overflow


def _csr(n_segs: int, seg_map: dict, cap_rows: int):
    """dict seg→list[(a, b)] → (starts [n_segs+1], a[], b[]) padded to cap."""
    starts = np.zeros(n_segs + 1, np.int32)
    for s, entries in seg_map.items():
        starts[s + 1] = len(entries)
    np.cumsum(starts, out=starts)
    total = int(starts[-1])
    cap = max(cap_rows, total, 1)
    a = np.full(cap, -1, np.int32)
    b = np.zeros(cap, np.int32)
    for s, entries in seg_map.items():
        lo = starts[s]
        for i, (x, y) in enumerate(entries):
            a[lo + i] = x
            b[lo + i] = y
    return starts, a, b


def build_subtable(filter_cap: int,
                   normal: dict,
                   filter_slots: dict,
                   shared_members: dict,
                   slot_cap: int = 1,
                   sub_rows_cap: int = 1,
                   fs_rows_cap: int = 1,
                   member_rows_cap: int = 1) -> SubTable:
    """Host-side build: python dicts → columnar SubTable (numpy arrays).

    normal: filter id → list[(session_row, packed_opts)].
    filter_slots: filter id → list[shared_slot_id].
    shared_members: shared_slot_id → list[(session_row, packed_opts)].
    The *_cap arguments set minimum array capacities.
    """
    sub_start, sub_row, sub_opts = _csr(filter_cap, normal, sub_rows_cap)
    fs_map = {f: [(s, 0) for s in slots] for f, slots in filter_slots.items()}
    fs_start, fs_slot, _ = _csr(filter_cap, fs_map, fs_rows_cap)
    n_slots = max(slot_cap, 1 + max(shared_members.keys(), default=-1),
                  1 + int(fs_slot.max(initial=-1)))
    shared_start, shared_row, shared_opts = _csr(n_slots, shared_members,
                                                 member_rows_cap)
    # packed subopts fit 6 bits: int8 planes
    return SubTable(sub_start=sub_start, sub_row=sub_row,
                    sub_opts=sub_opts.astype(np.int8),
                    fs_start=fs_start, fs_slot=fs_slot,
                    shared_start=shared_start, shared_row=shared_row,
                    shared_opts=shared_opts.astype(np.int8))
