"""The rest of the training harness in the port against catgen on the CPU:
the collapse detector and ``scan_metrics`` (``eval/collapse.py``) on
catgen's archived trajectories and on made-up streams, the detector
stopping a run in the harness (``collapse.json``,
``adversarial_collapsed.ckpt``, exit code 42), ``--profile``,
``apply_with_intermediates`` and the activation grids for D32_st3 and D64,
and the offline dataset pipeline (``data/offline.py``,
``cli/generate_dataset.py``) on a keypoint corpus of fixture faces.

Tolerances: the detector's reports equal catgen's; activations within
1e-5 of the largest (f32 convolutions summed in another order); the
grids' PNGs within one 8-bit level (the same activations normalized and
rounded); the offline pipeline's files byte for byte.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from catgen import models as cmodels
from catgen.cli import generate_dataset as c_gen_cli
from catgen.core.module import apply_with_intermediates as c_inters
from catgen.data import fixture as cfixture
from catgen.data import offline as coffline
from catgen.eval import collapse as ccollapse
from catgen.io.activations import save_activation_grids as c_grids
from catgen_torch import models as tmodels
from catgen_torch.cli import generate_dataset as gen_cli
from catgen_torch.cli import train as train_cli
from catgen_torch.core.module import apply_with_intermediates as t_inters
from catgen_torch.core.module import reset_parameters
from catgen_torch.data import offline as toffline
from catgen_torch.eval import collapse as tcollapse
from catgen_torch.io import checkpoint as tckpt
from catgen_torch.io.activations import save_activation_grids as t_grids
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.train import harness as tharness
from catgen_torch.train.harness import save_variables

from torch_port_helpers import np_tree, perturb

TRAJECTORIES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "data", "trajectories", "*.jsonl.gz")))
ARGS = ["--device", "cpu", "--fixture", "16", "--batchSize", "4",
        "--N_epoch", "8"]


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", TRAJECTORIES,
                         ids=[os.path.basename(p).split(".")[0]
                              for p in TRAJECTORIES])
def test_scan_metrics_matches_catgen(path):
    want = ccollapse.scan_metrics(path)
    assert tcollapse.scan_metrics(path) == want
    # the trajectories' names say how each run ended
    name = os.path.basename(path)
    assert want["collapsed"] == ("healthy" not in name), want


def test_the_archive_holds_every_verdict():
    reasons = {ccollapse.scan_metrics(p)["reason"] for p in TRAJECTORIES}
    assert {"nan", "probe_pinned", "far_from_data", None} == reasons


def _stream(seed, n=200):
    """A made-up run: epochs and visualizations whose signals wander in
    and out of every detector's range."""
    rng = np.random.RandomState(seed)
    for epoch in range(n):
        acc = float(np.clip(0.9 + 0.1 * rng.randn(), 0, 1))
        loss_g = float(rng.choice([2.0, 9.0, np.nan], p=[0.6, 0.395,
                                                         0.005]))
        yield ("epoch", epoch, acc, loss_g)
        if epoch % 2 == 0:
            yield ("viz", epoch, float(rng.rand()), float(rng.rand()),
                   float(rng.rand() * 0.4), float(rng.rand() * 0.1),
                   float(1.0 + rng.rand()) if rng.rand() < 0.8 else None)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("config", [
    {}, {"min_epoch": 0, "k_epochs": 2, "k_viz": 1},
    {"min_epoch": 10, "acc_hi": 0.9, "loss_g_hi": 5.0, "nn_min_epoch": 20}],
    ids=["default", "eager", "low"])
def test_detector_matches_catgen_on_made_up_streams(seed, config):
    dets = [m.CollapseDetector(m.CollapseConfig(**config))
            for m in (ccollapse, tcollapse)]
    for event in _stream(seed):
        for det in dets:
            if event[0] == "epoch":
                det.observe_epoch(*event[1:])
            else:
                det.observe_viz(*event[1:])
    assert dets[1].report() == dets[0].report()
    assert dets[1].history == dets[0].history


# ---------------------------------------------------------------------------
# the detector in the harness
# ---------------------------------------------------------------------------


def _poisoned_pretrained_g(save):
    """A pretrained-G file whose output conv's bias is NaN: the run picks it
    up and its first epoch's loss_g is NaN."""
    g = tmodels.create_G_decoder_upsampling32c((32, 32, 3), 100)
    reset_parameters(g, torch.Generator().manual_seed(0))
    with torch.no_grad():
        g.get_submodule("12_Conv").bias.fill_(float("nan"))
    os.makedirs(save, exist_ok=True)
    save_variables(g, os.path.join(save, "g_pretrained_3x32x32_nd100.ckpt"),
                   {"epoch": 0})


def _eager_detector(monkeypatch):
    """The harness's detector fires d_runaway once two epochs (from epoch
    1) have acc_d >= 0 and loss_g >= 0, which every epoch has."""
    config = tcollapse.CollapseConfig(min_epoch=1, k_epochs=2, acc_hi=0.0,
                                      loss_g_hi=0.0)
    monkeypatch.setattr(tharness, "CollapseDetector",
                        lambda: tcollapse.CollapseDetector(config))


@pytest.mark.parametrize("reason", ["nan", "d_runaway"])
def test_a_collapse_stops_the_run_with_code_42(tmp_path, monkeypatch,
                                               reason):
    save = str(tmp_path)
    if reason == "nan":
        _poisoned_pretrained_g(save)
    else:
        _eager_detector(monkeypatch)
    with pytest.raises(SystemExit) as stop:
        train_cli.main(ARGS + ["--epochs", "4", "--save", save,
                               "--collapseDetect"])
    assert stop.value.code == 42
    with open(os.path.join(save, "collapse.json")) as f:
        report = json.load(f)
    fired = {"nan": 1, "d_runaway": 2}[reason]
    assert report["collapsed"] and report["reason"] == reason
    assert report["fired_epoch"] == fired
    # the verdict is read before the next epoch trains
    assert report["aborted_at_epoch"] == fired + 1
    assert set(report["config"]) == set(
        ccollapse.CollapseDetector().report()["config"])
    collapsed = os.path.join(save, "adversarial_collapsed.ckpt")
    assert tckpt.load_meta(collapsed)["epoch"] == fired + 1
    # the last healthy snapshot is not overwritten (the cadence is 30)
    assert not os.path.exists(os.path.join(save, "adversarial.ckpt"))
    events = [json.loads(line) for line in
              open(os.path.join(save, "train_metrics.jsonl"))]
    detected = [e for e in events if e["event"] == "collapse_detected"]
    assert [(e["reason"], e["fired_epoch"]) for e in detected] == [
        (reason, fired)]
    assert len([e for e in events if e["event"] == "epoch"]) == fired


def test_a_collapse_in_the_last_epoch_is_caught(tmp_path, monkeypatch):
    # the loop's check runs before an epoch; the run's end checks again
    _eager_detector(monkeypatch)
    with pytest.raises(SystemExit) as stop:
        train_cli.main(ARGS + ["--epochs", "2", "--save", str(tmp_path),
                               "--collapseDetect"])
    assert stop.value.code == 42
    with open(tmp_path / "collapse.json") as f:
        assert json.load(f)["aborted_at_epoch"] == 3


# ---------------------------------------------------------------------------
# --profile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("epochs", [1, 2])
def test_profile_traces_one_epoch(tmp_path, epochs):
    """The second epoch is traced (the first with one epoch); it counts
    against --epochs."""
    save = str(tmp_path)
    out = os.path.join(save, "trace")
    harness = train_cli.main(ARGS + ["--epochs", str(epochs), "--save",
                                     save, "--profile", out])
    assert harness.state.epoch == epochs + 1
    assert os.listdir(out) == [f"epoch_{epochs:06d}.trace.json"]
    with open(os.path.join(out, os.listdir(out)[0])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("conv" in n for n in names)     # the step's ops are there


# ---------------------------------------------------------------------------
# apply_with_intermediates and the activation grids
# ---------------------------------------------------------------------------


D_MODELS = {"d32_st3": ("create_D32_st3", (32, 32, 3), 4.0),
            "d64": ("create_D64", (64, 64, 3), 4.5)}


@pytest.mark.parametrize("name", sorted(D_MODELS))
def test_intermediates_and_grids_match_catgen(name, tmp_path):
    create, img, gain = D_MODELS[name]
    cm = getattr(cmodels, create)(img)
    v = np_tree(cm.init(jax.random.PRNGKey(0), (1,) + img))
    perturb(v, np.random.RandomState(0), gain=gain)
    tm = getattr(tmodels, create)(img)
    tm.load_state_dict(catgen_to_state_dict(v["params"], v["state"]))
    x = np.random.RandomState(1).rand(2, *img).astype(np.float32)

    y, _, want = c_inters(cm, v, jnp.asarray(x))
    tm.train()
    got_y, got = t_inters(tm, torch.tensor(x))
    assert tm.training                        # the mode is restored
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-6),
                                   err_msg=n)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), rtol=0,
                               atol=1e-5)

    c_files = c_grids(cm, v, jnp.asarray(x[:1]), str(tmp_path / "c"))
    t_files = t_grids(tm, torch.tensor(x[:1]), str(tmp_path / "t"))
    assert [os.path.basename(f) for f in t_files] == \
        [os.path.basename(f) for f in c_files]
    for cf, tf in zip(c_files, t_files):
        a = np.asarray(Image.open(tf), np.int16)
        b = np.asarray(Image.open(cf), np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, tf


# ---------------------------------------------------------------------------
# the offline dataset pipeline
# ---------------------------------------------------------------------------


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def raw_corpus(tmp_path_factory):
    """A keypoint corpus of drawn fixture faces (``make_fixture_images``'
    drawing, rotated, with .cat files), written by catgen."""
    root = tmp_path_factory.mktemp("raw")
    cfixture.write_keypoint_corpus(str(root / "c"), n=4, size=96, seed=3)
    return str(root)


@pytest.mark.parametrize("workers", [0, 2])
def test_offline_pipeline_writes_catgens_files(raw_corpus, tmp_path, workers):
    src = os.path.join(raw_corpus, "c")
    want = coffline.generate_dataset(src, str(tmp_path / "c"),
                                     augmentations=3, scale=64)
    got = toffline.generate_dataset(src, str(tmp_path / "t"),
                                    augmentations=3, scale=64,
                                    workers=workers)
    assert got == want == (4, 4 + 4 * 4)
    c, t = _tree(tmp_path / "c"), _tree(tmp_path / "t")
    assert sorted(c) == sorted(t) and c == t
    assert "out_aug_64x64/000003_003.jpg" in t


def test_generate_dataset_cli_and_debug_draws(raw_corpus, tmp_path):
    src = os.path.join(raw_corpus, "c")
    gen_cli.main(["--path", src, "--out", str(tmp_path / "t"),
                  "--augmentations", "2", "--scale", "32",
                  "--debug-draw", "1"])
    c_gen_cli.main(["--path", src, "--out", str(tmp_path / "c"),
                    "--augmentations", "2", "--scale", "32",
                    "--debug-draw", "1"])
    c, t = _tree(tmp_path / "c"), _tree(tmp_path / "t")
    assert c == t
    assert len([k for k in t if k.startswith("debug_draw")]) == 4
    assert len([k for k in t if k.startswith("out_aug_32x32")]) == 12
