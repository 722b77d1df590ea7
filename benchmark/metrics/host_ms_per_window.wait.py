"""Host time a window in the program's ``route.wait`` range: the host
blocked until the window's device work is done, first inside
``route.readback`` (``RouteEngine.route_encoded``). The durations of the
ranges that start in the traced slice, summed, over its windows, in
milliseconds."""

RANGE = "route.wait"


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("windows"):
        return None
    us = [b - a for a, b, c, n in tr.host
          if c == "user_annotation" and n == RANGE and tr.t0 <= a < tr.t1]
    return sum(us) / 1e3 / rec["windows"] if us else None
