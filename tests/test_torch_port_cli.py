"""The port's training CLI (catgen_torch/cli/train.py) on the CPU at a tiny
size: it writes the metrics, the grids and a catgen-format checkpoint that
catgen loads and the port's sample CLI reads; it resumes from its own
checkpoint; and it refuses every flag whose machinery is not ported."""

import json
import os

import jax
import numpy as np
import pytest

from catgen import models as cmodels
from catgen.io import checkpoint as cckpt
from catgen.train import gan as cgan
from catgen_torch.cli import sample as sample_cli
from catgen_torch.cli import train as train_cli
from catgen_torch.io import checkpoint as tckpt
from torch_port_helpers import IMG

ARGS = ["--device", "cpu", "--fixture", "16", "--batchSize", "4",
        "--N_epoch", "8"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    save = str(tmp_path_factory.mktemp("train"))
    harness = train_cli.main(ARGS + ["--epochs", "1", "--save", save,
                                     "--augment"])
    return save, harness


def _events(save):
    with open(os.path.join(save, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_writes_metrics_grids_and_checkpoint(trained):
    save, harness = trained
    events = _events(save)
    epochs = [e for e in events if e["event"] == "epoch"]
    assert len(epochs) == 1
    assert all(np.isfinite(epochs[0][k]) for k in ("loss_d", "loss_g"))
    viz = [e for e in events if e["event"] == "viz"][0]
    assert 0.0 <= viz["d_probe_pattern"] <= 1.0 and viz["nn_l2"] > 0
    for d in ("images", "images_good", "images_bad", "images_real"):
        assert os.path.getsize(os.path.join(save, d, "epoch_000001.png"))
    assert harness.state.epoch == 2 and harness.state.step == 4
    meta = tckpt.load_meta(os.path.join(save, "adversarial.ckpt"))
    assert meta["epoch"] == 2 and meta["config"]["n_epoch"] == 8


def test_catgen_loads_the_port_checkpoint(trained):
    save, harness = trained
    g = cmodels.create_G_decoder_upsampling32c(IMG, 100)
    d = cmodels.create_D32_st3(IMG)
    template = cgan.ckpt_template(g, d, cgan.GanConfig(acc_window=20),
                                  jax.random.PRNGKey(0), IMG)
    state, meta = cckpt.load(os.path.join(save, "adversarial.ckpt"),
                             template)
    assert int(state.epoch) == 2 and int(state.step) == 4
    assert int(state.d_opt.step) == 4 and int(state.acc_count) == 4
    bias = state.g_params["12_Conv"]["bias"]
    np.testing.assert_array_equal(
        np.asarray(bias), harness.state.g.state_dict()["12_Conv.bias"])


def test_sample_cli_reads_the_checkpoint(trained):
    save, _ = trained
    runs = sample_cli.main(["--save", save, "--count", "64", "--device",
                            "cpu", "--neighbours", "--out",
                            os.path.join(save, "samples")])
    assert runs[0]["images"].shape == (64, 32, 32, 3)
    assert os.path.getsize(os.path.join(save, "samples",
                                        "run0_neighbours.png"))


def test_resume_continues_from_the_checkpoint(trained, tmp_path):
    save, harness = trained
    path = os.path.join(save, "adversarial.ckpt")
    resumed = train_cli.main(ARGS + ["--epochs", "1", "--save",
                                     str(tmp_path), "--network", path,
                                     "--N_epoch", "16"])
    # N_epoch 16 keeps the gate window at 20; the step and epoch go on
    assert resumed.state.epoch == 3 and resumed.state.step == 4 + 8
    rebuilt = train_cli.main(ARGS + ["--epochs", "0", "--save",
                                     str(tmp_path / "b"), "--network", path,
                                     "--rebuildOptstate"])
    assert int(rebuilt.state.d_opt.step) == 0 and rebuilt.state.epoch == 2


@pytest.mark.parametrize("flags", [
    ["--devices", "2"], ["--dtype", "bf16"], ["--collapseDetect"],
    ["--weightsVisFreq", "1"], ["--profile", "trace"], ["v_ckpt"],
    ["g_pretrained"]])
def test_unported_flags_raise(tmp_path, flags):
    if flags == ["v_ckpt"]:
        open(tmp_path / "v_3x32x32.ckpt", "wb").close()
        flags = []
    elif flags == ["g_pretrained"]:
        open(tmp_path / "g_pretrained_3x32x32_nd100.ckpt", "wb").close()
        flags = []
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        train_cli.main(ARGS + ["--epochs", "1", "--save", str(tmp_path)]
                       + flags)
