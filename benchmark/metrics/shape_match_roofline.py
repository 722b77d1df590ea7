"""Kernel 1 (``csrc/shape_match.cu``): the least time of a launch over the
cell's shapes (``roofline.shape_match_s``: one window's W x B topics,
one bucket row for each topic and compatible shape) against the
kernel's mean device time a launch in the traced slice, in percent."""

from benchmark import roofline


def read(rec):
    tr = rec.get("trace")
    times = tr.kernels(r"shape_match_kernel") if tr is not None else []
    if not times:
        return None
    least = roofline.shape_match_s(rec["W"] * rec["B"], rec["max_levels"],
                                   rec["shape_levels"], rec["compatible"])
    return 100.0 * least / (sum(times) / len(times))
