"""The numeric mode the port's CLIs run in (catgen_torch/cli/common.py::
resolve_device): catgen's ``--dtype f32`` has every convolution and matmul
in full f32 and repeats its bits from a seed, and its bf16 dots sum in
f32, so the CLIs turn TF32 off for cuDNN and for matmuls, turn off
cuBLAS's reduced-precision sums of bf16 products, and take cuDNN's
deterministic algorithms with no autotuning, on whatever device they run.
Here on the CPU: the flags as ``resolve_device`` and each CLI leave them,
from the opposite settings."""

import pytest
import torch
import torch_port_helpers  # noqa: F401  (torch's threads per xdist worker)

from catgen_torch.cli import common
from catgen_torch.cli import pretrain_g as pretrain_cli
from catgen_torch.cli import sample as sample_cli
from catgen_torch.cli import train as train_cli
from catgen_torch.cli import train_v as train_v_cli
from catgen_torch.train import harness

ARGS = ["--device", "cpu", "--fixture", "16", "--batchSize", "4",
        "--N_epoch", "8"]
FLAGS = (("cudnn", "allow_tf32", False), ("cuda.matmul", "allow_tf32", False),
         ("cuda.matmul", "allow_bf16_reduced_precision_reduction", False),
         ("cudnn", "deterministic", True), ("cudnn", "benchmark", False))


def _owner(path):
    owner = torch.backends
    for part in path.split("."):
        owner = getattr(owner, part)
    return owner


@pytest.fixture
def opposite_mode():
    """Every flag set against the mode for the test, restored after it."""
    before = [getattr(_owner(p), a) for p, a, _ in FLAGS]
    for p, a, want in FLAGS:
        setattr(_owner(p), a, not want)
    yield
    for (p, a, _), value in zip(FLAGS, before):
        setattr(_owner(p), a, value)


def _mode():
    return {f"{p}.{a}": getattr(_owner(p), a) for p, a, _ in FLAGS}


WANT = {f"{p}.{a}": want for p, a, want in FLAGS}


def test_resolve_device_sets_the_mode(opposite_mode):
    assert common.resolve_device("cpu") == torch.device("cpu")
    assert _mode() == WANT


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    save = str(tmp_path_factory.mktemp("mode"))
    train_cli.main(ARGS + ["--epochs", "1", "--save", save])
    return save


@pytest.mark.parametrize("cli", ["train", "sample", "train_v",
                                 "pretrain_g"])
def test_cli_runs_in_the_mode(trained, opposite_mode, tmp_path, cli,
                              monkeypatch):
    # the V CLI on catgen's test-size overlay bank (tests/test_v_subsystem)
    monkeypatch.setattr(harness, "OVERLAY_BANK", dict(n=8, n_points=500))
    flags = ARGS + ["--epochs", "1", "--save", str(tmp_path)]
    if cli == "train":
        train_cli.main(flags)
    elif cli == "train_v":
        train_v_cli.main(flags)
    elif cli == "pretrain_g":
        pretrain_cli.main(flags)
    else:
        sample_cli.main(["--save", trained, "--count", "16", "--device",
                         "cpu", "--out", str(tmp_path)])
    assert _mode() == WANT
