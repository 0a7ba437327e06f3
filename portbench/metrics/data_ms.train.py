"""Host ms a step in the benchmark's span around each epoch's copy of its
reals to the device and their conversion (the loader's feed), over the
untraced window."""


def read(res, cell):
    spans = res.spans.get("data")
    if not spans or cell.traffic.get("kind") != "train":
        return None
    return 1000.0 * sum(spans) / (len(spans) * res.window["steps_per_epoch"])
