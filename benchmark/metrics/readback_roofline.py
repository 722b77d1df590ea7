"""The readback of ``RouteEngine.route_encoded`` against the host link:
the least time of the bytes the program counted into host memory over
the traced slice (its ``d2h_bytes`` counter, ``host_link.readback_s``)
against the slice's device-to-host copy time, in percent."""

from benchmark import host_link


def read(rec):
    tr = rec.get("trace")
    n = rec.get("d2h_bytes")
    t = tr.copies("DtoH") if tr is not None else []
    if not n or not t:
        return None
    return 100.0 * host_link.readback_s(n) / sum(t)
