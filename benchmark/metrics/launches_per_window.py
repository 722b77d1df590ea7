"""The route window (``models/router_engine.route_window``): CUDA kernels
the traced slice ran, over the windows in it."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("windows"):
        return None
    n = tr.n_kernels()
    return n / rec["windows"] if n else None
