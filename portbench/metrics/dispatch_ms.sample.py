"""Host ms inside each request's calls (``sample_and_rank`` and
``neighbours_of_best``) before its synchronize, over the untraced
window."""


def read(res, cell):
    spans = res.spans.get("dispatch")
    if not spans or cell.traffic.get("kind") != "sample":
        return None
    return 1000.0 * sum(spans) / len(spans)
