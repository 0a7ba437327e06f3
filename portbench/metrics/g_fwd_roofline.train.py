"""G's upsample-convs in one forward at the step's batch: their counted
least time (portbench/counts.py: distinct taps, each byte once, the peak
of the step's precision) over the device time of every kernel launched
inside them (the benchmark's ``upconv`` spans, hooks on each
``UpsampleConv`` module), whatever implements them."""

from portbench.drive_train import upconv_least_seconds


def read(res, cell):
    tr = res.traces.get("g_fwd")
    if tr is None:
        return None
    sec = tr.device_seconds_in_span("portbench.upconv")
    if not sec:
        return None
    reps = res.window["forward_profile_reps"]
    return 100.0 * upconv_least_seconds(cell) * reps / sec
