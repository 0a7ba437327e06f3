"""The whole pipeline's share of the card's peak: the counted FLOPs of a
request (G and D forward on every sample, the search of the best against
the corpus; portbench/counts.py) over the window's time a request, over
the peak of the request's precision (f32: the TF32 tensor-core rate)."""

from portbench import counts as C
from portbench.drive_sample import request_macs


def read(res, cell):
    if cell.traffic.get("kind") != "sample" or not res.window.get("requests"):
        return None
    request_s = res.window["seconds"] / res.window["requests"]
    return (100.0 * 2.0 * request_macs(cell) / request_s
            / C.PEAK_FLOPS[cell.traffic["dtype"]])
