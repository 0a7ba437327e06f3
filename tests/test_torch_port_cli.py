"""The port's training CLI (catgen_torch/cli/train.py) on the CPU at a tiny
size: it writes the metrics, the grids and a catgen-format checkpoint that
catgen loads and the port's sample CLI reads; it resumes from its own
checkpoint; --collapseDetect, --weightsVisFreq and --profile do their
work; its data-parallel flags train on two gloo ranks, or a world of
one, and refuse more CUDA ranks than cards. Then
the reference's workflow in one --save: cli.train_v, cli.pretrain_g, and
cli.train picking up both files (the overlay bank at catgen's test size,
tests/test_v_subsystem.py, in place of the full 1000 x 10000 walk)."""

import json
import os
import socket

import jax
import numpy as np
import pytest
import torch

from catgen import models as cmodels
from catgen.io import checkpoint as cckpt
from catgen.train import gan as cgan
from catgen_torch.cli import pretrain_g as pretrain_cli
from catgen_torch.cli import sample as sample_cli
from catgen_torch.cli import train as train_cli
from catgen_torch.cli import train_v as train_v_cli
from catgen_torch.io import checkpoint as tckpt
from catgen_torch.train import harness as tharness
from catgen_torch.train import pretrainer as tpre
from torch_port_helpers import IMG

ARGS = ["--device", "cpu", "--fixture", "16", "--batchSize", "4",
        "--N_epoch", "8"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    save = str(tmp_path_factory.mktemp("train"))
    harness = train_cli.main(ARGS + ["--epochs", "1", "--save", save,
                                     "--augment"])
    return save, harness


def _events(save, name="train_metrics.jsonl"):
    with open(os.path.join(save, name)) as f:
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


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


DP_CHECKPOINTS = {train_cli: "adversarial.ckpt",
                  train_v_cli: "v_3x32x32.ckpt",
                  pretrain_cli: "g_pretrained_3x32x32_nd100.ckpt"}


@pytest.mark.parametrize("cli,flags", [
    (train_cli, ["--devices", "2"]),
    (pretrain_cli, ["--coordinator", "PORT", "--numProcesses", "1",
                    "--processId", "0"]),
    (train_v_cli, ["--coordinator", "PORT", "--numProcesses", "1"])],
    ids=["train-devices2", "pretrain-coordinator", "train_v-coordinator"])
def test_data_parallel_flags_train(tmp_path, monkeypatch, cli, flags):
    """--devices 2 --device cpu trains on two gloo ranks started by the
    CLI (its harness stays in their processes); a coordinator with one
    process runs a world of one here. Either way one checkpoint, rank
    0's, is written. (The harnesses' two-rank runs, V's and the
    pretrainer's too, are tests/test_torch_port_dist.py's.)"""
    save = str(tmp_path)
    flags = [f"localhost:{_free_port()}" if f == "PORT" else f
             for f in flags]
    monkeypatch.setattr(tharness, "OVERLAY_BANK", dict(n=8, n_points=500))
    out = cli.main(ARGS + ["--epochs", "1", "--save", save] + flags)
    devices = 2 if "--devices" in flags else 1
    if devices > 1:
        assert out is None
    else:
        assert out.dp and out.hc.n_devices == 1 and out.state.epoch == 2
    assert not torch.distributed.is_initialized()
    path = os.path.join(save, DP_CHECKPOINTS[cli])
    meta = tckpt.load_meta(path)
    assert meta["epoch"] == 2
    logs = [n for n in os.listdir(save) if n.endswith("_metrics.jsonl")]
    events = _events(save, logs[0])
    assert [e["event"] for e in events].count("checkpoint_saved") == 1
    assert [e["n_devices"] for e in events if e["event"] == "setup"
            and "n_devices" in e] in ([], [devices])


@pytest.mark.parametrize("flags,match", [
    (["--devices", "2", "--device", "cuda"], "card"),
    (["--devices", "2", "--device", "cuda:0"], "pass --device cuda"),
    (["--numProcesses", "2"], "need --coordinator")])
def test_data_parallel_flags_refuse(tmp_path, flags, match):
    """More CUDA ranks than cards (NCCL puts one rank on a card), a card
    index for several ranks, and the multi-host flags without a
    coordinator are refused before anything starts."""
    with pytest.raises(SystemExit, match=match):
        train_cli.main(ARGS + ["--epochs", "1", "--save", str(tmp_path)]
                       + flags)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags", [
    ["--collapseDetect"], ["--weightsVisFreq", "1"],
    ["--profile", "trace"]])
def test_harness_flags_do_their_work(tmp_path, flags):
    """The flags that the CLI once refused: the detector watches a healthy
    run to its end, D's activation grids are written at each
    visualization, and the second epoch's trace is written."""
    save = str(tmp_path)
    if flags[0] == "--profile":
        flags = ["--profile", os.path.join(save, "trace")]
    harness = train_cli.main(ARGS + ["--epochs", "2", "--save", save]
                             + flags)
    assert harness.state.epoch == 3
    if flags[0] == "--collapseDetect":
        assert harness.collapse is not None
        assert harness.collapse.verdict is None
        assert not os.path.exists(os.path.join(save, "collapse.json"))
        assert [e["epoch"] for e in _events(save)
                if e["event"] == "viz"] == [1, 2, 3]
    elif flags[0] == "--weightsVisFreq":
        for epoch in (1, 2):
            out = os.path.join(save, "activations", f"epoch_{epoch:06d}")
            assert len(os.listdir(out)) == 13     # D32_st3's children
    else:
        trace = os.path.join(save, "trace", "epoch_000002.trace.json")
        with open(trace) as f:
            assert json.load(f)["traceEvents"]


def test_train_cli_runs_in_bf16_and_the_sample_cli_reads_it(tmp_path):
    # catgen's --dtype bf16 (compute_dtype=bfloat16): activations in bf16,
    # parameters and optimizer states f32 in the checkpoint
    save = str(tmp_path)
    harness = train_cli.main(ARGS + ["--epochs", "1", "--save", save,
                                     "--dtype", "bf16", "--augment"])
    assert harness.gc.compute_dtype == torch.bfloat16
    epoch = [e for e in _events(save) if e["event"] == "epoch"][0]
    assert all(np.isfinite(epoch[k]) for k in ("loss_d", "loss_g"))
    with np.load(os.path.join(save, "adversarial.ckpt")) as z:
        assert z[".g_params['00_Dense']['kernel']"].dtype == np.float32
        assert z[".g_state['04_BatchNorm']['mean']"].dtype == np.float32
    runs = sample_cli.main(["--save", save, "--count", "16", "--device",
                            "cpu", "--out", os.path.join(save, "samples")])
    assert runs[0]["images"].shape == (16, 32, 32, 3)
    assert bool(torch.isfinite(runs[0]["images"]).all())


KERNEL_ROUTES = {
    "ladder": dict(upsample_impl="pallas", fused_ladder=True,
                   ladder_bwd="pallas"),
    "per_layer_pallas": dict(upsample_impl="pallas", fused_ladder=False,
                             upsample_bwd="pallas"),
    "per_layer_hybrid": dict(upsample_impl="pallas", fused_ladder=False,
                             upsample_bwd="hybrid"),
    "fused_prefix": dict(st_conv_impl="fused")}


@pytest.mark.parametrize("route", sorted(KERNEL_ROUTES))
def test_kernel_routes_refuse_bf16(tmp_path, route):
    """Each kernel route trains in bf16 on the CPU (``--dtype bf16``) on
    the kernels' bf16 plain versions, launching no kernel, and writes
    the default route's checkpoint: parameters and BatchNorm statistics
    in f32. The name is the one this test had when these routes refused
    bf16; it is kept so that the test's record carries on."""
    from catgen_torch.kernels import bilinear, fused_upsample_conv, st_conv
    from catgen_torch.kernels import config as kconfig

    fused_upsample_conv.reset_launches()
    bilinear.reset_launches()
    before = (st_conv.LAUNCHES, st_conv.BF16_LAUNCHES)
    with kconfig.using(**KERNEL_ROUTES[route]):
        harness = train_cli.main(ARGS + ["--epochs", "1", "--save",
                                         str(tmp_path), "--dtype", "bf16"])
    assert harness.gc.compute_dtype == torch.bfloat16
    assert harness.state.step == 4
    epoch = [e for e in _events(str(tmp_path)) if e["event"] == "epoch"][0]
    assert all(np.isfinite(epoch[k]) for k in ("loss_d", "loss_g"))
    with np.load(os.path.join(str(tmp_path), "adversarial.ckpt")) as z:
        assert z[".g_params['03_UpsampleConv']['kernel']"].dtype == \
            np.float32
        for stat in ("mean", "var"):
            assert z[f".g_state['04_BatchNorm']['{stat}']"].dtype == \
                np.float32
    assert sum(fused_upsample_conv.launches().values()) == 0
    assert sum(bilinear.launches().values()) == 0
    assert (st_conv.LAUNCHES, st_conv.BF16_LAUNCHES) == before


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    """cli.train_v, cli.pretrain_g, then cli.train in one --save."""
    save = str(tmp_path_factory.mktemp("workflow"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tharness, "OVERLAY_BANK", dict(n=8, n_points=500))
        v = train_v_cli.main(ARGS + ["--epochs", "2", "--saveFreq", "1",
                                     "--save", save])
    pre = pretrain_cli.main(ARGS + ["--epochs", "2", "--saveFreq", "3",
                                    "--save", save])
    gan = train_cli.main(ARGS + ["--epochs", "1", "--save", save])
    return save, v, pre, gan


def test_train_v_cli_writes_its_epochs_grids_and_checkpoint(workflow):
    save, v, _, _ = workflow
    events = _events(save, "train_v_metrics.jsonl")
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [1, 2]
    viz = [e for e in events if e["event"] == "viz"]
    assert [e["judged_real"] + e["judged_fake"] for e in viz] == [100, 100]
    assert any(os.path.exists(os.path.join(save, d, "epoch_000002.png"))
               for d in ("v_judged_real", "v_judged_fake"))
    assert tckpt.load_meta(os.path.join(save, "v_3x32x32.ckpt"))[
        "epoch"] == 3
    assert v.state.step == 4 and len(v.choices) == 2


def test_pretrain_g_cli_saves_the_decoder_at_the_end(workflow):
    save, _, pre, _ = workflow
    events = _events(save, "pretrain_metrics.jsonl")
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [1, 2]
    assert os.path.getsize(os.path.join(save, "reconstructions",
                                        "epoch_000002.png"))
    # save_freq 3 never fires in 2 epochs: the final save writes epoch 3
    path = os.path.join(save, "g_pretrained_3x32x32_nd100.ckpt")
    assert tckpt.load_meta(path)["epoch"] == 3
    assert not os.path.exists(path + ".old")
    assert pre.state.step == 4


def test_train_cli_picks_up_v_and_the_pretrained_g(workflow):
    save, v, pre, gan = workflow
    events = _events(save)
    names = [e["event"] for e in events]
    assert names[:3] == ["pretrained_g_loaded", "v_loaded", "setup"]
    viz = [e for e in events if e["event"] == "viz"][0]
    for k in ("v_rating_all", "v_rating_good", "v_rating_bad"):
        assert 0.0 <= viz[k] <= 1.0
    assert gan.plot_data == [[1, viz["v_rating_all"], viz["v_rating_good"],
                              viz["v_rating_bad"]]]
    meta = tckpt.load_meta(os.path.join(save, "adversarial.ckpt"))
    assert meta["plot_data"] == gan.plot_data
    for k, t in v.state.v.state_dict().items():
        assert torch.equal(gan.v.state_dict()[k], t), k


def test_train_cli_starts_g_from_the_pretrained_decoder(workflow, tmp_path):
    save, _, pre, _ = workflow
    import shutil
    for name in ("g_pretrained_3x32x32_nd100.ckpt", "fixture"):
        src = os.path.join(save, name)
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(
            src, os.path.join(str(tmp_path), name))
    gan = train_cli.main(ARGS + ["--epochs", "0", "--save", str(tmp_path)])
    want = tpre.extract_decoder(pre.state.ae).state_dict()
    for k, t in gan.state.g.state_dict().items():
        assert torch.equal(t, want[k]), k
    assert gan.v is None
    assert [e["event"] for e in _events(str(tmp_path))][:3] == [
        "pretrained_g_loaded", "v_missing", "setup"]
