"""The readback of ``RouteEngine.route_encoded``: device-to-host copy time
in the traced slice, over its windows, in milliseconds."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("windows"):
        return None
    t = tr.copies("DtoH")
    return 1e3 * sum(t) / rec["windows"] if t else None
