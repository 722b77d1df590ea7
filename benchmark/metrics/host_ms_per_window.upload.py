"""Host time a window in the program's ``route.upload`` range: the host
arrays' uploads to the device (``RouteEngine.route_encoded``). The
durations of the ranges that start in the traced slice, summed, over its
windows, in milliseconds."""

RANGE = "route.upload"


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("windows"):
        return None
    us = [b - a for a, b, c, n in tr.host
          if c == "user_annotation" and n == RANGE and tr.t0 <= a < tr.t1]
    return sum(us) / 1e3 / rec["windows"] if us else None
