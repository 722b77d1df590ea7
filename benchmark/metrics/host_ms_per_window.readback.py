"""Host time a window in the program's ``route.readback`` range, its self
time: the cursor hand-off and every copy into host memory
(``RouteEngine.route_encoded``), less the ``route.wait`` range inside it.
Over the readback ranges that start in the traced slice, summed, over its
windows, in milliseconds."""

RANGE, CHILD = "route.readback", "route.wait"


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("windows"):
        return None
    spans = [(a, b, n) for a, b, c, n in tr.host
             if c == "user_annotation" and n in (RANGE, CHILD)
             and tr.t0 <= a < tr.t1]
    own = [(a, b) for a, b, n in spans if n == RANGE]
    waits = [(a, b) for a, b, n in spans if n == CHILD]
    if not own:
        return None
    us = sum(b - a - sum(wb - wa for wa, wb in waits if a <= wa and wb <= b)
             for a, b in own)
    return us / 1e3 / rec["windows"]
