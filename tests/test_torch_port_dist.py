"""The port's data parallelism (catgen_torch/dist) on two gloo ranks of
the CPU, against catgen's DP step and against the port's single-process
steps on the concatenated batch.

One group of two ranks is spawned for the whole module
(``tests/torch_dist_ranks.py::run_all``); each case reads its part of the
ranks' results. The single-process steps run here first: their draws,
recorded, are cut into each rank's (``dist.parity``) and handed to the
ranks, so both sides compute the same function. Tolerances:

  * catgen's zeroed-G pair (tests/test_dist.py) against catgen's 2-device
    DP step: D after its SGD update within rtol 2e-4, atol 2e-5 (catgen's
    own bounds for its DP step against its single step);
  * the port's DP step against its single step on the concatenated batch
    (the GAN step on the default and ladder routes, the V step, the AE
    step): losses within rtol 1e-5, confusion counts equal, gradients
    within 1e-4 of each leaf's largest (``assert_grads_close``), weights
    after the Adam step within 2e-5 except where a gradient within its
    tolerance of zero may flip Adam's first move
    (``assert_adam_step_close``), BatchNorm statistics within 2e-5;
  * every case's state bit-equal across the ranks (``assert_replicated``
    on the ranks).

The two steps split the batch differently, so they round differently, and
a gradient is not continuous where a PReLU's, a LeakyReLU's or a max
pool's choice (or a sampler tap) sits within rounding of its switch: there
one step takes the other slope, and that element's gradient moves by a
part of itself. At this size about 0.4 of G32up-c's first-stage PReLU
inputs a step lie that close to 0. The inputs keep the switches they can
out of reach (``perturb``'s ST heads, D's SGD update below); the rest is
the data's, and the seeds are ones whose data put no input there: seed 3
for the GAN and V steps, seed 5 for the AE step. At the AE step's seed 3
one input of its first decoder stage's PReLU flips and the gradients move
up to 300 times the bound (seeds 7 and 11: 4 and 200 times); at the GAN
step's seed 13 they move up to 7 times on either route, while G's
backward through the synced BatchNorm on a linear loss, with no flip,
agrees within 0.05 of the bound on the same weights.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks_mod
from catgen import dist as cdist
from catgen import nn as cnn
from catgen.train import gan as cgan
from catgen_torch import models
from catgen_torch.core.module import reset_parameters
from catgen_torch.core.random import Draws
from catgen_torch.data.fixture import write_fixture_dataset
from catgen_torch.dist import dp, launch, mesh
from catgen_torch.dist.parity import RecordingDraws, gan_pairs
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.kernels import config as kconfig
from catgen_torch.train import gan, pretrainer, v_trainer
from torch_port_helpers import (assert_adam_step_close, assert_grads_close,
                                bn_fed_biases, capture_grads, np_tree,
                                port_grads_to_numpy)

WORLD = 2
BATCH = 4                 # per rank: 2 reals and 2 fakes
IMG = ranks_mod.IMG
LOSS_RTOL = 1e-5
G_GAIN, D_GAIN = 1.0, 2.0   # chip_smoke.py's well-conditioned weights
# D's update in the GAN cases: Adam's first step moves a weight by +-lr
# wherever its gradient is not zero, so a D gradient within rounding of
# zero would differ by 2*lr between the two steps, and the G phase would
# then differentiate through two different Ds. SGD keeps D's update linear
# in its gradient (catgen's tests/test_dist.py uses SGD for the same
# reason); G's update, the V step's and the AE step's are Adam's.
D_OPTIMIZER = "sgd"


def perturb(model: torch.nn.Module, seed: int, gain: float) -> None:
    """Seeded weights that make the step do real work (chip_smoke.py's
    ``perturb``): the port's init, conv and dense kernels scaled by
    ``gain``, noisy BatchNorm statistics, and ST heads with noisy biases
    and zero weights. The grids are then not the identity, but they come
    from no batched product, so the DP step and the single step sample at
    the same coordinates bit for bit: with noisy head weights the batch
    split rounds the grids differently, and a coordinate within rounding
    of a pixel edge moves the sampler's d_coords by a whole tap."""
    gen = torch.Generator().manual_seed(seed)
    reset_parameters(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".head" in name:
                noise = torch.randn(p.shape, generator=gen)
                p.copy_(torch.zeros_like(p) if name.endswith("weight")
                        else p + noise * 0.2)
            elif name.endswith("weight"):
                p.mul_(gain)
        for name, b in model.named_buffers():
            if name.endswith("mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
            elif name.endswith("var"):
                b.copy_(torch.rand(b.shape, generator=gen) * 1.5 + 0.5)


def snapshot(*named) -> dict:
    return {f"{p}.{k}": v.detach().clone().numpy()
            for p, m in named for k, v in m.state_dict().items()}


def prefixed(grads: dict, prefix: str) -> dict:
    return {f"{prefix}.{k}": v for k, v in grads.items()}


def single_gan(route: dict, seed: int):
    """The port's single step on the global batch: the inputs for the
    ranks and what their step must match."""
    g = models.create_G_decoder_upsampling32c(IMG, 100)
    d = models.create_D32_st3(IMG)
    perturb(g, seed, G_GAIN)
    perturb(d, seed + 1, D_GAIN)
    spec = {"g": {k: v.clone() for k, v in g.state_dict().items()},
            "d": {k: v.clone() for k, v in d.state_dict().items()},
            "batch": BATCH, "d_optimizer": D_OPTIMIZER,
            "reals": np.random.RandomState(seed).rand(
                WORLD * BATCH // 2, *IMG).astype(np.float32)}
    config = gan.GanConfig(batch_size=WORLD * BATCH, augment=True,
                           d_optimizer=D_OPTIMIZER)
    state = gan.init_state(g, d, config)
    before = snapshot(("g", g), ("d", d))
    draws = RecordingDraws(Draws(torch.Generator().manual_seed(seed + 2)))
    grads = []
    with capture_grads(gan.optim, grads, port_grads_to_numpy), \
            kconfig.using(**route):
        m = gan.make_train_step(g, d, config)(
            state, torch.from_numpy(spec["reals"]), draws)
    spec["records"] = draws.records
    spec["pairs"] = gan_pairs(draws.records, BATCH // 2, WORLD, 100)
    want = {"metrics": {k: float(v) for k, v in m._asdict().items()},
            "grads": grads, "before": before,
            "state": snapshot(("g", g), ("d", d)),
            "zero": {"g": bn_fed_biases(g), "d": bn_fed_biases(d)},
            "penalties": {"d": (config.d_l1, config.d_l2, config.d_clamp),
                          "g": (config.g_l1, config.g_l2, config.g_clamp)}}
    return spec, want


def single_v(seed: int):
    v = models.create_V32(IMG)
    perturb(v, seed, 2.0)
    rng = np.random.RandomState(seed)
    spec = {"v": {k: x.clone() for k, x in v.state_dict().items()},
            "batch": BATCH,
            "reals": rng.rand(WORLD * BATCH // 2, *IMG).astype(np.float32),
            "fakes": rng.rand(WORLD * BATCH // 2, *IMG).astype(np.float32)}
    config = v_trainer.VConfig(batch_size=WORLD * BATCH)
    state = v_trainer.init_state(v, config)
    before = snapshot(("v", v))
    draws = RecordingDraws(Draws(torch.Generator().manual_seed(seed + 1)))
    grads = []
    with capture_grads(v_trainer.optim, grads, port_grads_to_numpy):
        m = v_trainer.make_train_step(v, config)(
            state, torch.from_numpy(spec["reals"]),
            torch.from_numpy(spec["fakes"]), draws)
    spec["records"] = draws.records
    want = {"metrics": {k: float(x) for k, x in m._asdict().items()},
            "grads": grads, "before": before, "state": snapshot(("v", v)),
            "zero": bn_fed_biases(v),
            "penalties": (config.v_l1, config.v_l2, config.v_clamp)}
    return spec, want


def single_ae(seed: int):
    ae = models.create_G_autoencoder(IMG, 100)
    perturb(ae, seed, 1.0)
    spec = {"ae": {k: x.clone() for k, x in ae.state_dict().items()},
            "batch": BATCH,
            "images": np.random.RandomState(seed).rand(
                WORLD * BATCH, *IMG).astype(np.float32)}
    config = pretrainer.PretrainConfig(batch_size=WORLD * BATCH)
    state = pretrainer.init_state(ae, config)
    before = snapshot(("ae", ae))
    grads = []
    with capture_grads(pretrainer.optim, grads, port_grads_to_numpy):
        loss = pretrainer.make_train_step(ae, config)(
            state, torch.from_numpy(spec["images"]))
    want = {"loss": float(loss), "grads": grads, "before": before,
            "state": snapshot(("ae", ae)), "zero": bn_fed_biases(ae),
            "penalties": (config.g_l1, config.g_l2, config.g_clamp)}
    return spec, want


def catgen_tiny():
    """catgen's tests/test_dist.py pair with G zeroed, its DP step on a
    2-device mesh: the ranks' inputs and catgen's D after the step."""
    g = cnn.Sequential([
        cnn.Dense(16), cnn.BatchNorm(axis_name="data"), cnn.PReLU(),
        cnn.Dense(64), cnn.Sigmoid(), cnn.Reshape(ranks_mod.TINY_IMG),
    ], name="tinyG")
    d = cnn.Sequential([cnn.Flatten(), cnn.Dense(16), cnn.PReLU(),
                        cnn.Dense(1), cnn.Sigmoid()], name="tinyD")
    config = cgan.GanConfig(batch_size=8, noise_dim=ranks_mod.TINY_NOISE,
                            acc_window=4, d_optimizer="sgd",
                            g_optimizer="sgd", d_lr=0.1, g_lr=0.0,
                            d_clamp=0.0, d_l2=0.0, g_clamp=0.0,
                            axis_name="data")
    state = cgan.init_state(g, d, config, jax.random.PRNGKey(0),
                            ranks_mod.TINY_IMG)
    state = state._replace(g_params=jax.tree_util.tree_map(
        jnp.zeros_like, state.g_params))
    reals = np.random.RandomState(0).rand(
        WORLD * 4, *ranks_mod.TINY_IMG).astype(np.float32)
    mesh2 = cdist.make_mesh(WORLD)
    step = cdist.make_dp_train_step(g, d, config, mesh2)
    after, _ = step(cdist.replicate(state, mesh2),
                    cdist.shard_batch(jnp.asarray(reals), mesh2),
                    jax.random.PRNGKey(5))
    spec = {"g": catgen_to_state_dict(np_tree(state.g_params),
                                      np_tree(state.g_state)),
            "d": catgen_to_state_dict(np_tree(state.d_params),
                                      np_tree(state.d_state)),
            "batch": 8, "reals": reals}
    want = {f"d.{k}": v.numpy() for k, v in catgen_to_state_dict(
        np_tree(after.d_params), np_tree(after.d_state)).items()}
    return spec, want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(what the single-process steps and catgen gave, the two ranks'
    results, the harnesses' directories)."""
    root = tmp_path_factory.mktemp("dist")
    corpus = str(root / "corpus")
    write_fixture_dataset(corpus, n=32, size=64, seed=11)
    spec, want = {}, {}
    spec["tiny"], want["tiny"] = catgen_tiny()
    for name, route in (("default", {}), ("ladder", ranks_mod.LADDER)):
        spec[f"gan_{name}"], want[f"gan_{name}"] = single_gan(route, 3)
    spec["v"], want["v"] = single_v(3)
    spec["ae"], want["ae"] = single_ae(5)
    spec["harness"] = {
        "corpus": corpus, "bank": dict(n=8, n_points=500),
        **{k: str(root / k) for k in ("gan_save", "v_save", "ae_save")}}
    got = launch.launch(ranks_mod.run_all, WORLD, args=(spec,),
                        device="cpu", timeout_s=300.0)
    return want, got, spec["harness"]


def test_rank_streams_differ_and_rank_zero_keeps_the_seed(world):
    """catgen's per-device RNG (tests/test_dist.py::
    test_per_device_rng_differs): each rank its own stream; rank 0's is
    the single-process one, so a world of one draws what one process
    draws."""
    _, got, _ = world
    assert [r["rank"] for r in got] == [0, 1]
    assert [r["world"] for r in got] == [WORLD, WORLD]
    assert got[0]["seed"] == 11 and got[1]["seed"] != 11
    assert not np.array_equal(got[0]["stream"], got[1]["stream"])
    np.testing.assert_array_equal(
        got[0]["stream"], torch.rand(4, generator=torch.Generator()
                                     .manual_seed(11)).numpy())


def test_zeroed_g_update_matches_catgen_dp_step(world):
    want, got, _ = world
    for r in got:
        assert r["tiny"]["count"] == WORLD * 8     # the global batch
        for k, v in want["tiny"].items():
            np.testing.assert_allclose(r["tiny"]["d"][k], v, rtol=2e-4,
                                       atol=2e-5, err_msg=k)


def _metrics_close(got: dict, want: dict) -> None:
    for k, v in want.items():
        if k in ("tp_real", "tn_fake", "fp", "fn", "d_trained"):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= LOSS_RTOL * abs(v), (k, got[k], v)


@pytest.mark.parametrize("route", ["default", "ladder"])
def test_gan_step_matches_the_single_step_on_the_concatenated_batch(
        world, route):
    want, got, _ = world
    want, mine = want[f"gan_{route}"], got[0][f"gan_{route}"]
    for r in got:
        _metrics_close(r[f"gan_{route}"]["metrics"], want["metrics"])
    for i, name in enumerate("dg"):
        assert_grads_close(mine["grads"][i], want["grads"][i],
                           zero=want["zero"][name])
        pick = {k: v for k, v in want["state"].items()
                if k.startswith(name + ".")}
        assert_adam_step_close(
            {k: mine["state"][k] for k in pick}, pick,
            prefixed(want["grads"][i], name), want["before"],
            want["penalties"][name],
            zero={f"{name}.{k}" for k in want["zero"][name]})


@pytest.mark.parametrize("route", ["default", "ladder"])
def test_gan_step_all_reduces_as_designed(world, route):
    """One all-reduce per synced BatchNorm (ladder block) pass, one per
    phase's gradients, one for the metrics (``all_reduces_per_gan_step``):
    G32up-c's 3 stages, D32_st3 has no BatchNorm."""
    _, got, _ = world
    for r in got:
        case = r[f"gan_{route}"]
        assert case["all_reduces"] == case["expected_all_reduces"] == 3 + 1 \
            + 2 * 3 + 1 + 1


def test_v_step_matches_the_single_step(world):
    want, got, _ = world
    want, mine = want["v"], got[0]["v"]
    for r in got:
        _metrics_close(r["v"]["metrics"], want["metrics"])
    assert_grads_close(mine["grads"][0], want["grads"][0], zero=want["zero"])
    assert_adam_step_close(mine["state"], want["state"],
                           prefixed(want["grads"][0], "v"), want["before"],
                           want["penalties"],
                           zero={f"v.{k}" for k in want["zero"]})


def test_ae_step_matches_the_single_step(world):
    want, got, _ = world
    want, mine = want["ae"], got[0]["ae"]
    for r in got:
        assert abs(r["ae"]["loss"] - want["loss"]) <= LOSS_RTOL * want["loss"]
    assert_grads_close(mine["grads"][0], want["grads"][0], zero=want["zero"])
    assert_adam_step_close(mine["state"], want["state"],
                           prefixed(want["grads"][0], "ae"), want["before"],
                           want["penalties"],
                           zero={f"ae.{k}" for k in want["zero"]})


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_gan_harness_dp_epoch_checkpoint_and_resume(world):
    """catgen's test_harness_dp_epoch_and_checkpoint: an epoch over the
    global batch, one checkpoint (rank 0's), a resume that re-replicates
    and trains on."""
    _, got, dirs = world
    for r in got:
        h = r["harness"]
        assert h["gan_epoch"]["epoch"] == 1 and h["gan_epoch"]["loss_d"] > 0
        assert h["gan_resumed_epoch"] == 2 and h["gan_epoch2"]["epoch"] == 2
        assert h["decoder_used"] == "native"
    assert got[0]["harness"]["gan_epoch"] == {
        **got[1]["harness"]["gan_epoch"],
        **{k: got[0]["harness"]["gan_epoch"][k]
           for k in ("sec", "ms_per_sample", "imgs_per_sec")}}
    events = _events(os.path.join(dirs["gan_save"], "train_metrics.jsonl"))
    saved = [e for e in events if e["event"] == "checkpoint_saved"]
    assert len(saved) == 1 and saved[0]["epoch"] == 2
    setups = [e for e in events if e["event"] == "setup"]
    assert [e["n_devices"] for e in setups] == [WORLD, WORLD]
    # 32 examples at a global half batch of 8: 4 steps of 2 x 8 images
    epochs = [e for e in events if e["event"] == "epoch"]
    assert len(epochs) == 2
    assert [e["imgs_per_sec"] > 0 for e in epochs] == [True, True]
    for name in ("images", "images_good", "images_bad", "images_real"):
        assert os.listdir(os.path.join(dirs["gan_save"], name))


def test_v_harness_dp(world):
    """catgen's test_v_harness_dp; the host's generator choices are the
    same on both ranks."""
    _, got, dirs = world
    for r in got:
        assert r["harness"]["v_epoch"]["epoch"] == 1
        assert 0.0 <= r["harness"]["v_epoch"]["acc"] <= 1.0
    assert got[0]["harness"]["v_choices"] == got[1]["harness"]["v_choices"]
    assert os.path.exists(os.path.join(dirs["v_save"], "v_3x16x16.ckpt"))


def test_pretrain_harness_dp(world):
    """catgen's test_pretrain_harness_dp."""
    _, got, dirs = world
    for r in got:
        s1, s2 = r["harness"]["ae_epochs"]
        assert s2["mse"] <= s1["mse"] * 1.5
    assert os.path.exists(os.path.join(dirs["ae_save"],
                                       "g_pretrained_3x16x16_nd100.ckpt"))


def test_dp_builders_refuse_unsynced_models_and_need_a_group():
    """catgen's ``_with_axis`` guard: a DP step rebinds a config without
    its axis, refuses BatchNorms that would not sync, and needs a group."""
    g, d = ranks_mod.tiny_g(None), ranks_mod.tiny_d()
    with pytest.raises(ValueError, match="synced"):
        dp.make_dp_train_step(g, d, ranks_mod.tiny_config(8))
    with pytest.raises(RuntimeError, match="no process group"):
        dp.make_dp_train_step(ranks_mod.tiny_g(mesh.DATA_AXIS), d,
                              ranks_mod.tiny_config(8))


def test_eval_quality_refuses_the_data_parallel_flags(tmp_path):
    """cli.eval_quality evaluates on one device: --devices and the
    multi-host flags, which it shares with the training CLIs, are
    refused, not ignored."""
    from catgen_torch.cli import eval_quality

    for flags in (["--devices", "2"], ["--coordinator", "localhost:1"]):
        with pytest.raises(SystemExit, match="one device"):
            eval_quality.main(["--device", "cpu", "--save", str(tmp_path)]
                              + flags)
