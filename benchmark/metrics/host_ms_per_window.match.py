"""Host time a window in the program's ``route.match`` range: kernel 1
(``csrc/shape_match.cu``) and its cover expansion
(``models/router_engine.route_window``). The durations of the ranges
that start in the traced slice, summed, over its windows, in
milliseconds."""

RANGE = "route.match"


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("windows"):
        return None
    us = [b - a for a, b, c, n in tr.host
          if c == "user_annotation" and n == RANGE and tr.t0 <= a < tr.t1]
    return sum(us) / 1e3 / rec["windows"] if us else None
