"""The readback of ``RouteEngine.route_encoded``: the bytes the program
counted into host memory over the traced slice (its ``d2h_bytes``
counter), over the slice's W x B topics a window; nothing where the
slice copied nothing from a device."""


def read(rec):
    tr = rec.get("trace")
    n = rec.get("d2h_bytes")
    if not n or not rec.get("windows") or tr is None \
            or not tr.copies("DtoH"):
        return None
    return n / (rec["windows"] * rec["W"] * rec["B"])
