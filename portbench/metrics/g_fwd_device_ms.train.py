"""Device ms of one G forward at the step's batch (training mode, no
gradients), profiled from outside the step: every kernel launched inside
the benchmark's ``g_fwd`` span, over the repetitions."""


def read(res, cell):
    tr = res.traces.get("g_fwd")
    if tr is None:
        return None
    sec = tr.device_seconds_in_span("portbench.g_fwd")
    return 1000.0 * sec / res.window["forward_profile_reps"] if sec else None
