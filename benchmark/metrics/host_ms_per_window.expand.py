"""Host time a window in the program's ``route.expand`` range: normal
fan-out and shared-slot expansion, once over the window's W x B lanes
(``models/router_engine._post_window``). The durations of the ranges
that start in the traced slice, summed, over its windows, in
milliseconds."""

RANGE = "route.expand"


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("windows"):
        return None
    us = [b - a for a, b, c, n in tr.host
          if c == "user_annotation" and n == RANGE and tr.t0 <= a < tr.t1]
    return sum(us) / 1e3 / rec["windows"] if us else None
