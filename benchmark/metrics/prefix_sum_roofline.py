"""Kernel 2 (``csrc/prefix_sum.cu``): the least time of every launch in
the traced slice, from the shapes the program counted them at
(``emqx_tpu_torch.device.LAUNCH_SHAPES``, read around the slice), summed,
against the summed device time of the kernel's entries, in percent."""

from benchmark import roofline

KERNEL = r"\bps_(?:copy|short|mid|long)\b"


def read(rec):
    tr = rec.get("trace")
    shapes = rec.get("launch_shapes") or {}
    times = tr.kernels(KERNEL) if tr is not None else []
    if not times or not shapes:
        return None
    least = sum(roofline.prefix_sum_s(s) * c for s, c in shapes.items())
    return 100.0 * least / sum(times)
