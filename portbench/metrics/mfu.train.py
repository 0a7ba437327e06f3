"""The whole training step's share of the card's peak: the counted model
FLOPs of a step (portbench/counts.py, from the configuration's operation
tables) over the window's time a step, over the peak of the step's
precision (f32: the TF32 tensor-core rate)."""

from portbench import counts as C
from portbench.drive_train import step_macs


def read(res, cell):
    if cell.traffic.get("kind") != "train" or not res.window.get("steps"):
        return None
    step_s = res.window["seconds"] / res.window["steps"]
    flops = 2.0 * step_macs(cell)
    return 100.0 * flops / step_s / C.PEAK_FLOPS[cell.traffic["dtype"]]
