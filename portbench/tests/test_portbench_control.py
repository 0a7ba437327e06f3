"""The control on the card: the plain reference put in the program's place
in TF32 (the nearest precision below the configurations' f32) has to come
out as not correct against each cell's limits, while the program on the
same seed comes out correct. Needs the card; run there with

    python3 -m pytest portbench/tests/test_portbench_control.py -m cuda
"""

import os

import pytest

from portbench.tests.tiny import REPO

CELLS = ["train32.f32", "train64.f32", "sample32.nn100k"]
SEED = 2718281829


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control reads TF32, which "
                    "only the card has")
    from catgen_torch.cli.common import resolve_device
    from catgen_torch.kernels.build import load_library

    device = resolve_device("cuda:0")
    load_library()
    return device


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(card, workload):
    from portbench import cell as cells
    from portbench import control

    cell = cells.load_cell(REPO, workload)
    if cell.traffic["kind"] == "train":
        r = control.train_readings(cell, SEED, card, faults=True)
    else:
        r = control.sample_readings(cell, SEED, card, control=True)
    lim = cell.limits

    def fails(nums):
        return any(v > lim[k] for k, v in nums.items())

    assert not fails(r["program"][0]), r["program"]
    assert fails(r["control_tf32"][0]), r["control_tf32"]
    if "fault_half_batch" in r:
        assert fails(r["fault_half_batch"][0]), r["fault_half_batch"]


def test_the_control_test_is_collected_everywhere():
    assert os.path.isdir(os.path.join(REPO, "portbench", "limits"))
