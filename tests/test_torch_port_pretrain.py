"""The port's G pretrainer (catgen_torch/train/pretrainer.py, the 32px and
16px G autoencoders of catgen_torch/models/zoo.py) against catgen's on
the CPU, and the files that tie the three programs together: the V
checkpoint and
the pretrained G, written by either package and picked up by the other's
GAN harness with the same weights and the same V ratings.

The autoencoder draws nothing at random, so catgen's step runs compiled,
as catgen runs it.
Tolerances, f32 on both sides: forwards 1e-5 absolute; the step as
tests/test_torch_port_train.py holds the GAN step (loss rtol 1e-5,
gradients per leaf within 1e-4 of the leaf's largest, parameters and
BatchNorm statistics after the step atol 2e-5), with the two allowances
tests/test_torch_port_v.py explains for a full-width model: the biases in
front of a BatchNorm are rounding noise on both sides, and Adam's first
step may go the other way where the gradient's sign is rounding; weights
read from a checkpoint equal bit for bit; V ratings 1e-5 absolute.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import models as cmodels
from catgen import optim as copt
from catgen.data.loader import ImageDataset as CDataset
from catgen.io import checkpoint as cckpt
from catgen.train import gan as cgan
from catgen.train import harness as charness
from catgen.train import pretrainer as cpre
from catgen_torch import models as tmodels
from catgen_torch import optim as topt
from catgen_torch.data.fixture import write_fixture_dataset
from catgen_torch.data.loader import ImageDataset as TDataset
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.train import gan as tgan
from catgen_torch.train import harness as tharness
from catgen_torch.train import pretrainer as tpre

from torch_port_helpers import (IMG, NOISE_DIM, assert_adam_step_close,
                                assert_grads_close, bn_fed_biases,
                                capture_grads, catgen_grads_to_port,
                                catgen_pair, np_tree, perturb,
                                port_grads_to_numpy)

ATOL = 1e-5


IMG16 = (16, 16, 3)


def _images(n, seed, img=IMG):
    return np.random.RandomState(seed).rand(n, *img).astype(np.float32)


def catgen_ae(seed=0, enc_gain=1.0, dec_gain=1.0, img=IMG):
    """catgen's autoencoder at ``img`` with perturbed weights (the
    encoder's kernels scaled by ``enc_gain``, the decoder's by
    ``dec_gain``)."""
    ae = cmodels.create_G_autoencoder(img, NOISE_DIM)
    variables = np_tree(ae.init(jax.random.PRNGKey(seed), (1,) + img))
    rng = np.random.RandomState(seed)
    for name, gain in zip(sorted(variables["params"]), (enc_gain, dec_gain)):
        perturb({"params": variables["params"][name],
                 "state": variables["state"][name]}, rng, gain=gain)
    return ae, variables


def port_ae(variables, img=IMG):
    ae = tmodels.create_G_autoencoder(img, NOISE_DIM)
    ae.load_state_dict(catgen_to_state_dict(variables["params"],
                                            variables["state"]), strict=True)
    return ae


def _sd(variables):
    return {k: v.numpy() for k, v in catgen_to_state_dict(
        np_tree(variables["params"]), np_tree(variables["state"])).items()}


def _autoencoder_matches_catgen(img, seed):
    """The port's autoencoder at ``img`` against catgen's: train and eval
    forwards, the BatchNorm statistics the train forward moved, and the
    reconstruction (eval) after it."""
    cae, variables = catgen_ae(seed=seed, img=img)
    tae = port_ae(variables, img)
    assert isinstance(tpre.extract_decoder(tae),
                      type(tmodels.create_G(img, NOISE_DIM)))
    x = _images(4, seed + 1, img)
    apply = jax.jit(cae.apply, static_argnames=("train",))
    for train in (False, True):
        want, new_state = apply(variables, jnp.asarray(x), train=train)
        tae.train(train)
        with torch.no_grad():
            got = tae(torch.tensor(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=f"train={train}")
    # the train forward moved the BatchNorm statistics as catgen's did
    want = _sd({"params": variables["params"], "state": new_state})
    for k, t in tae.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    moved = {"params": variables["params"], "state": new_state}
    recon = np.asarray(apply(moved, jnp.asarray(x), train=False)[0])
    assert np.ptp(recon) > 1e-3        # not a flat image
    np.testing.assert_allclose(
        tpre.reconstruct(tae, torch.tensor(x)).numpy(), recon,
        rtol=0, atol=ATOL)
    return tae


def test_autoencoder_matches_catgen_in_train_and_eval():
    _autoencoder_matches_catgen(IMG, seed=2)


def test_16px_autoencoder_is_refused():
    """The 16px autoencoder, G_enc16 (its flatten 4x4x64 after two pools)
    and G16up, whose reconstruction matches catgen's; its decoder is the
    16px default G."""
    tae = _autoencoder_matches_catgen(IMG16, seed=6)
    assert tpre.decoder_child_name(tae) == "01_G16up"


# Gains where both f32 gradients are well conditioned. The BatchNorm
# variance, E[x^2] - E[x]^2 in f32 in both packages, loses digits where a
# channel's mean is large against its spread, as at the decoder's first
# stage at other gains: there the two packages' gradients, each off a
# float64 run of the same step, differ from each other far beyond 1e-4 of
# a leaf's largest, as their sums round differently.
ENC_GAIN, DEC_GAIN = 4.0, 1.0


def _pretrain_step_matches_catgen(img, n_zero):
    """One autoencoder step at batch 4 at ``img``, with G_L2 and G_L1 on;
    ``n_zero`` biases feed a BatchNorm."""
    config = dict(batch_size=4, g_l1=1e-4, g_l2=1e-3)
    cae, variables = catgen_ae(seed=1, enc_gain=ENC_GAIN,
                               dec_gain=DEC_GAIN, img=img)
    c_config = cpre.PretrainConfig(**config)
    state = cpre.init_state(cae, c_config, jax.random.PRNGKey(0), img)
    state = state._replace(params=variables["params"],
                           state=variables["state"])
    tae = port_ae(variables, img)
    t_config = tpre.PretrainConfig(**config)
    t_state = tpre.init_state(tae, t_config)
    x = _images(4, 11, img)
    # catgen's step compiled, as catgen runs it, with its raw gradients
    # returned beside its results
    traced = []
    real = copt.clamp_and_penalize

    def spy(grads, *args, **kwargs):
        traced.append(grads)
        return real(grads, *args, **kwargs)

    def step_and_grads(state, images, key):
        new, loss = cpre.make_train_step(cae, c_config)(state, images, key)
        return new, loss, traced[-1]

    with mock.patch.object(copt, "clamp_and_penalize", spy):
        new, c_loss, grads = jax.jit(step_and_grads)(
            state, jnp.asarray(x), jax.random.PRNGKey(1))
    c_grads = [catgen_grads_to_port(grads)]
    t_grads = []
    with capture_grads(topt, t_grads, port_grads_to_numpy):
        t_loss = tpre.make_train_step(tae, t_config)(t_state,
                                                     torch.tensor(x))
    np.testing.assert_allclose(float(t_loss), float(c_loss), rtol=1e-5)
    zero = bn_fed_biases(tae)
    assert len(zero) == n_zero
    assert_grads_close(t_grads[0], c_grads[0], zero=zero)
    before = {k: v.numpy() for k, v in catgen_to_state_dict(
        variables["params"], {}).items()}
    assert_adam_step_close(
        {k: v.numpy() for k, v in tae.state_dict().items()},
        _sd({"params": new.params, "state": new.state}), c_grads[0],
        before, (t_config.g_l1, t_config.g_l2, t_config.g_clamp),
        zero=zero)
    assert t_state.step == int(new.step) == 1


def test_pretrain_step_matches_catgen_at_full_width():
    _pretrain_step_matches_catgen(IMG, 8)  # 5 in the encoder, 3 upsample-convs


def test_16px_pretrain_step_matches_catgen():
    _pretrain_step_matches_catgen(IMG16, 7)  # 5 in G_enc16, 2 in G16up


def test_epoch_steps_each_batch_and_counts_the_epoch():
    _, variables = catgen_ae()
    a, b = port_ae(variables), port_ae(variables)
    config = tpre.PretrainConfig(batch_size=2)
    batches = torch.tensor(_images(4, 6).reshape((2, 2) + IMG))
    sa = tpre.init_state(a, config)
    losses = tpre.make_train_epoch(a, config)(sa, batches)
    sb = tpre.init_state(b, config)
    step = tpre.make_train_step(b, config)
    assert torch.equal(losses, torch.stack([step(sb, x) for x in batches]))
    assert (sa.epoch, sa.step) == (2, 2)


def test_decoder_export_is_a_standalone_g():
    _, variables = catgen_ae(seed=4)
    tae = port_ae(variables)
    assert tpre.decoder_child_name(tae) == "01_G32up_c"
    g = tmodels.create_G(IMG, NOISE_DIM)
    assert set(tpre.extract_decoder(tae).state_dict()) == set(
        g.state_dict())
    fresh = port_ae(catgen_ae(seed=5)[1])
    tpre.insert_decoder(fresh, tpre.extract_decoder(tae).state_dict())
    for k, t in tpre.extract_decoder(fresh).state_dict().items():
        assert torch.equal(t, tpre.extract_decoder(tae).state_dict()[k])


# ---------------------------------------------------------------------------
# the files between the programs, both ways
# ---------------------------------------------------------------------------


def test_port_checkpoints_load_in_catgen(tmp_path):
    """The port's PretrainHarness and VHarness files, read by catgen's
    loader against catgen's templates."""
    corpus = str(tmp_path / "fixture")
    write_fixture_dataset(corpus, n=8)
    hc = tharness.HarnessConfig(save_dir=str(tmp_path), n_epoch=4)
    data = TDataset([corpus], device=torch.device("cpu"))
    pre = tharness.PretrainHarness(hc, tpre.PretrainConfig(batch_size=2),
                                   data, torch.device("cpu"))
    pre.train(1)
    g = cmodels.create_G(IMG, NOISE_DIM)
    template = g.init(jax.random.PRNGKey(0), (1, NOISE_DIM))
    got, meta = cckpt.load(os.path.join(str(tmp_path), cckpt.
                                        g_pretrained_filename(3, 32, 32,
                                                              100)),
                           template)
    assert meta["epoch"] == 2
    want = tpre.extract_decoder(pre.state.ae).state_dict()
    for k, v in catgen_to_state_dict(np_tree(got["params"]),
                                     np_tree(got["state"])).items():
        assert torch.equal(v, want[k]), k
    v = tmodels.create_V(IMG)
    tharness.save_variables(v, str(tmp_path / "v.ckpt"), {"epoch": 7})
    cv = cmodels.create_V(IMG)
    got, meta = cckpt.load(str(tmp_path / "v.ckpt"),
                           cv.init(jax.random.PRNGKey(0), (1,) + IMG))
    assert meta["epoch"] == 7
    for k, t in catgen_to_state_dict(np_tree(got["params"]),
                                     np_tree(got["state"])).items():
        assert torch.equal(t, v.state_dict()[k]), k


@pytest.fixture(scope="module")
def both_harnesses(tmp_path_factory):
    """catgen's V and pretrained G written by catgen into one save
    directory, and by the port into another; the port's GanHarness starts
    in catgen's files and catgen's GanHarness in the port's. D's weights
    (perturbed, so that the scores have no ties) and the visualization
    noise are catgen's on both sides."""
    root = tmp_path_factory.mktemp("pickup")
    corpus = str(root / "fixture")
    write_fixture_dataset(corpus, n=16)
    _, _, gv, dv = catgen_pair(seed=7)
    cv = cmodels.create_V(IMG)
    vv = np_tree(cv.init(jax.random.PRNGKey(8), (1,) + IMG))
    perturb(vv, np.random.RandomState(8), gain=2.0)
    v_name = cckpt.v_filename(3, 32, 32)
    g_name = cckpt.g_pretrained_filename(3, 32, 32, NOISE_DIM)
    by_catgen, by_port = str(root / "catgen"), str(root / "port")
    cckpt.save(os.path.join(by_catgen, v_name), vv, {"epoch": 3})
    cckpt.save(os.path.join(by_catgen, g_name), gv, {"epoch": 2})
    tv = tmodels.create_V(IMG)
    tv.load_state_dict(catgen_to_state_dict(vv["params"], vv["state"]))
    tg = tmodels.create_G(IMG, NOISE_DIM)
    tg.load_state_dict(catgen_to_state_dict(gv["params"], gv["state"]))
    tharness.save_variables(tv, os.path.join(by_port, v_name), {"epoch": 3})
    tharness.save_variables(tg, os.path.join(by_port, g_name), {"epoch": 2})

    c = charness.GanHarness(
        charness.HarnessConfig(save_dir=by_port, n_epoch=8),
        cgan.GanConfig(batch_size=4), CDataset([corpus]))
    c.state = c.state._replace(d_params=dv["params"], d_state=dv["state"])
    t = tharness.GanHarness(
        tharness.HarnessConfig(save_dir=by_catgen, n_epoch=8),
        tgan.GanConfig(batch_size=4), TDataset([corpus],
                                               device=torch.device("cpu")),
        torch.device("cpu"))
    t.state.d.load_state_dict(catgen_to_state_dict(dv["params"],
                                                   dv["state"]))
    t.vis_noise = torch.tensor(np.asarray(c.vis_noise))
    return c, t, gv, vv


def _events(save, name="train_metrics.jsonl"):
    import json
    with open(os.path.join(save, name)) as f:
        return [json.loads(line)["event"] for line in f]


def test_each_gan_harness_picks_up_the_others_files(both_harnesses):
    c, t, gv, vv = both_harnesses
    for k, want in _sd(gv).items():
        assert np.array_equal(t.state.g.state_dict()[k].numpy(), want), k
    for k, want in _sd(vv).items():
        assert np.array_equal(t.v.state_dict()[k].numpy(), want), k
    for got, want in ((_sd({"params": c.state.g_params,
                            "state": c.state.g_state}), _sd(gv)),
                      (_sd(c.v_vars), _sd(vv))):
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    assert _events(t.hc.save_dir)[:3] == ["pretrained_g_loaded", "v_loaded",
                                          "setup"]


def test_v_ratings_equal_catgens(both_harnesses):
    c, t, _, _ = both_harnesses
    scores = torch.sort(tgan.discriminate(t.state.d, tgan.generate(
        t.state.g, t.vis_noise))).values
    assert float(scores[50] - scores[49]) > 1e-4, "D's halves tie"
    fields = t.visualize()
    c.visualize()
    want = c.plot_data[-1]
    got = [fields["epoch"], fields["v_rating_all"], fields["v_rating_good"],
           fields["v_rating_bad"]]
    assert t.plot_data == [got] and got[0] == want[0] == 1
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=ATOL)
    assert got[2] != got[3]
