"""Peaks of one NVIDIA H100 and the least time of each hand-written kernel.

The least time of a launch is the larger of its bytes over the HBM rate
and its operations over the integer ALU rate (NVIDIA's data sheet, SXM
part at 700 W; the kernels do 32-bit integer work outside the tensor
cores). Bytes count each input byte read once and each output byte
written once, from the cell's shapes: what the work needs, whatever the
kernel reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

# the shape-hash table's bucket row: BK filter entries, each a pair of
# 32-bit level hashes and a 32-bit filter id, read as one row
BK = 8
BUCKET_ROW_BYTES = 3 * BK * 4


def least_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S)


def shape_match_s(n_topics: int, max_levels: int, shape_levels: list,
                  compatible: int) -> float:
    """Kernel 1 (fold and probe) over ``n_topics`` topics of
    ``max_levels`` 32-bit words: the topics, their lengths and dollar
    flags read once; one bucket row for each topic and compatible shape
    (``compatible`` rows a topic); one 32-bit match slot for each topic
    and shape and one count written. Operations: ~12 integer operations
    a folded level for the hash pair and ~100 for seeds, homes,
    compatibility and the slot compares, for each shape."""
    n_shapes = len(shape_levels)
    n_bytes = n_topics * (max_levels * 4 + 4 + 1) \
        + n_topics * compatible * BUCKET_ROW_BYTES \
        + n_topics * n_shapes * 4 + n_topics * 4
    n_ops = n_topics * sum(12 * lv + 100 for lv in shape_levels)
    return least_s(n_bytes, n_ops)


def prefix_sum_s(shape) -> float:
    """Kernel 2 (an int32 inclusive scan along the last axis): every
    element read once and written once, one add each."""
    n = 1
    for d in shape:
        n *= int(d)
    return least_s(2 * n * 4, n)
