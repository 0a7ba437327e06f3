"""The share of the traced training window in which no operation ran on
the card (torch.profiler's kernels, copies and sets)."""


def read(res, cell):
    if cell.traffic.get("kind") != "train" or not res.window_s:
        return None
    return 100.0 * (1.0 - res.busy_s / res.window_s)
