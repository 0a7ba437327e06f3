"""Device ms of the nearest-neighbour search a request: every kernel
launched inside the benchmark's ``nn`` span around ``neighbours_of_best``
in the traced requests."""


def read(res, cell):
    tr = res.traces.get("requests")
    if tr is None:
        return None
    sec = tr.device_seconds_in_span("portbench.nn")
    return 1000.0 * sec / res.window["trace_requests"] if sec else None
