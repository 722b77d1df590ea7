"""The route window's tail: the 99th percentile over every window of the
traced run outside its profiled slice, each timed from the call to
``RouteEngine.route_encoded`` until its readback is in host memory, in
milliseconds."""


def read(rec):
    return rec.get("window_p99_ms")
