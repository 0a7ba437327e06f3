"""catgen's 16px workflow through the port's CLIs on the CPU at a tiny size,
in one --save: cli.train_v --scale 16 (V16; the overlay bank at catgen's
test size), cli.pretrain_g --scale 16 (G_enc16 + G16up), cli.train
--scale 16 (G16up against the default D, D32_st3, which pools the 16x16
input to 8x8 before its branches) picking up both files, cli.sample and
cli.eval_quality reading its checkpoint (with V's ratings); then
``--G g16up --D d16_st3``; and every key of the --G and --D choices
training one step at catgen's scale for it (tests/test_models.py)."""

import json
import math
import os

import pytest

from catgen_torch import models as tmodels
from catgen_torch.cli import eval_quality as eval_cli
from catgen_torch.cli import pretrain_g as pretrain_cli
from catgen_torch.cli import sample as sample_cli
from catgen_torch.cli import train as train_cli
from catgen_torch.cli import train_v as train_v_cli
from catgen_torch.io import checkpoint as tckpt
from catgen_torch.train import harness as tharness

ARGS = ["--device", "cpu", "--fixture", "16", "--batchSize", "4",
        "--N_epoch", "8", "--scale", "16"]


def _events(save, name="train_metrics.jsonl"):
    with open(os.path.join(save, name)) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    save = str(tmp_path_factory.mktemp("workflow16"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tharness, "OVERLAY_BANK", dict(n=8, n_points=500))
        train_v_cli.main(ARGS + ["--epochs", "1", "--save", save])
    pretrain_cli.main(ARGS + ["--epochs", "1", "--save", save])
    gan = train_cli.main(ARGS + ["--epochs", "1", "--save", save,
                                 "--augment"])
    return save, gan


def test_16px_workflow_picks_up_v_and_the_pretrained_g(workflow):
    save, gan = workflow
    assert os.path.exists(os.path.join(save, "v_3x16x16.ckpt"))
    assert os.path.exists(os.path.join(save,
                                       "g_pretrained_3x16x16_nd100.ckpt"))
    names = [e["event"] for e in _events(save)]
    assert names[:3] == ["pretrained_g_loaded", "v_loaded", "setup"]
    assert gan.state.g.seq_name == "G16up"
    assert gan.state.d.seq_name == "D32_st3"
    epoch = [e for e in _events(save) if e["event"] == "epoch"][0]
    assert all(math.isfinite(epoch[k]) for k in ("loss_d", "loss_g"))
    meta = tckpt.load_meta(os.path.join(save, "adversarial.ckpt"))
    assert meta["config"]["scale"] == 16


def test_16px_sample_and_eval_quality_read_the_checkpoint(workflow):
    save, _ = workflow
    runs = sample_cli.main(["--save", save, "--count", "32", "--device",
                            "cpu", "--neighbours"])
    assert tuple(runs[0]["images"].shape) == (32, 16, 16, 3)
    rep = eval_cli.main(["--device", "cpu", "--save", save, "--samples",
                         "32"])
    assert rep["image_shape"] == [16, 16, 3] and rep["finite"]
    assert set(rep["v_rating"]) == {"all", "best50_by_d", "worst50_by_d"}
    assert os.path.exists(os.path.join(save, "quality_report.json"))


def test_16px_train_with_d16_st3(tmp_path):
    gan = train_cli.main(ARGS + ["--epochs", "1", "--save", str(tmp_path),
                                 "--G", "g16up", "--D", "d16_st3",
                                 "--augment"])
    assert gan.state.d.seq_name == "D16_st3"
    epoch = [e for e in _events(str(tmp_path)) if e["event"] == "epoch"][0]
    assert all(math.isfinite(epoch[k]) for k in ("loss_d", "loss_g"))


def _scale(name: str) -> int:
    """catgen's scale for a registry key (tests/test_models.py)."""
    return 64 if "64" in name else 16 if "16" in name else 32


# every --G key against the default D, every --D key against the default
# G, at the key's scale (refine64 is an image-to-image stage, not a G)
CHOICES = ([("--G", k) for k in sorted(tmodels.G_REGISTRY)
            if k != "refine64"]
           + [("--D", k) for k in sorted(tmodels.D_REGISTRY)])


@pytest.mark.parametrize("flag,name", CHOICES)
def test_every_registry_choice_trains_a_step(tmp_path, flag, name):
    args = ["--device", "cpu", "--fixture", "4", "--batchSize", "2",
            "--N_epoch", "2", "--epochs", "1", "--visFreq", "9",
            "--scale", str(_scale(name)), "--save", str(tmp_path), flag,
            name]
    if name == "d64":
        args += ["--G", "g64_stack"]
    gan = train_cli.main(args)
    assert gan.state.step > 0
    epoch = [e for e in _events(str(tmp_path)) if e["event"] == "epoch"][0]
    assert all(math.isfinite(epoch[k]) for k in ("loss_d", "loss_g"))
