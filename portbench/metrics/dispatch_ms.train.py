"""Host ms a step inside the program's epoch call (the steps' dispatch,
including any wait for the launch queue), over the untraced window."""


def read(res, cell):
    spans = res.spans.get("dispatch")
    if not spans or cell.traffic.get("kind") != "train":
        return None
    return 1000.0 * sum(spans) / (len(spans) * res.window["steps_per_epoch"])
