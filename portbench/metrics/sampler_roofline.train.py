"""The port's bilinear sampler kernels in the traced epoch: the bytes
bound of the samplings the configuration's steps make (portbench/counts.py)
over the device time of the kernels found by their names. Nothing is read
where the trace's launches of a pass are not what the steps make (another
route, or a kernel renamed)."""

import re

from portbench.drive_train import sampler_least_seconds_per_step

# the kernels of catgen_torch/csrc/bilinear_sample.cu and
# bilinear_sample_bwd.cu, by pass
PASSES = {
    "forward": re.compile(r"\bsample_per_(value|pixel|pixel_staged|"
                          r"quad_staged|quad_bf16)\b"),
    "dcoords": re.compile(r"\bdcoords_(per_warp|per_pixel|staged|"
                          r"per_quad_bf16)\b"),
    "dimg": re.compile(r"\bdimg_(per_sample|gather|per_channel)\b"),
}


def read(res, cell):
    tr = res.traces.get("epoch")
    if tr is None:
        return None
    steps = res.window["trace_steps"]
    want = sampler_least_seconds_per_step(cell)
    kernels = tr.kernels_in_span("portbench.dispatch")
    bound = spent = 0.0
    for name, pattern in PASSES.items():
        found = [d for k, d in kernels if pattern.search(k)]
        launches, least = want[name]
        if len(found) != launches * steps:
            return None
        bound += least * steps
        spent += sum(found)
    return 100.0 * bound / spent if spent else None
