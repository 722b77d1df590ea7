"""The device's idle share of the traced slice: 1 minus the union of its
kernel, copy and set intervals over the slice's span, in percent."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
