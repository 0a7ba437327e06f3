"""The port's GAN train step (catgen_torch/train/gan.py) against catgen's
``make_train_step`` on small models built from the same layers in both
packages: a G with BatchNorm and a D with a spatial-transformer prefix and
both dropouts. catgen runs eagerly; every draw it makes (noise,
augmentation, dropout masks) is recorded and handed to the port in the
same order, and each optimizer update's raw gradients are captured on both
sides. The transformer heads start off the identity, so no sample lies
exactly on an image edge (where catgen's CPU sampler and the port differ
by design: tests/test_torch_port_bilinear.py).

Tolerances, f32 on both sides: losses and accuracies rtol 1e-5; gradients
per leaf within 1e-4 of the leaf's largest; parameters, optimizer moments
and BN statistics atol 2e-5; confusion counts, the gate's decision and
step counters exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import nn as cnn
from catgen import optim as copt
from catgen.train import gan as cgan
from catgen_torch import optim as topt
from catgen_torch.core.module import Sequential as TSequential
from catgen_torch.core.random import Draws
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.nn import layers as tl
from catgen_torch.nn.spatial_transformer import SpatialTransformer
from catgen_torch.train import gan as tgan

from torch_port_helpers import (ReplayDraws, assert_grads_close,
                                capture_grads, catgen_grads_to_port, np_tree,
                                perturb, port_grads_to_numpy,
                                record_jax_draws)

IMG = (8, 8, 2)
NOISE = 8
BATCH = 8
RTOL, ATOL = 1e-5, 2e-5


def catgen_models():
    g = cnn.Sequential([
        cnn.Dense(32), cnn.BatchNorm(), cnn.PReLU(),
        cnn.Dense(IMG[0] * IMG[1] * IMG[2]), cnn.Sigmoid(),
        cnn.Reshape(IMG)], name="tinyG")
    d = cnn.Sequential([
        cnn.SpatialTransformer(True, True, True),
        cnn.Conv(4, (3, 3)), cnn.PReLU(), cnn.SpatialDropout(0.2),
        cnn.Flatten(), cnn.Dropout(0.5), cnn.Dense(1), cnn.Sigmoid()],
        name="tinyD")
    return g, d


def port_models():
    h, w, c = IMG
    g = TSequential([
        tl.Dense(NOISE, 32), tl.BatchNorm(32), tl.PReLU(),
        tl.Dense(32, h * w * c), tl.Sigmoid(), tl.Reshape(IMG)],
        name="tinyG")
    d = TSequential([
        SpatialTransformer(IMG, True, True, True),
        tl.Conv(c, 4, (3, 3)), tl.PReLU(), tl.SpatialDropout(0.2),
        tl.Flatten(), tl.Dropout(0.5), tl.Dense(h * w * 4, 1),
        tl.Sigmoid()], name="tinyD")
    return g, d


class Pair:
    """catgen's and the port's step over the same weights and config."""

    def __init__(self, **config):
        config = dict(dict(batch_size=BATCH, noise_dim=NOISE, acc_window=3),
                      **config)
        self.c_config = cgan.GanConfig(**config)
        self.t_config = tgan.GanConfig(**config)
        cg, cd = catgen_models()
        state = cgan.init_state(cg, cd, self.c_config,
                                jax.random.PRNGKey(0), IMG)
        gv = np_tree({"params": state.g_params, "state": state.g_state})
        dv = np_tree({"params": state.d_params, "state": state.d_state})
        rng = np.random.RandomState(1)
        perturb(gv, rng, gain=1.0)
        perturb(dv, rng, gain=1.0)
        self.c_state = state._replace(
            g_params=gv["params"], g_state=gv["state"],
            d_params=dv["params"], d_state=dv["state"])
        self.c_step = cgan.make_train_step(cg, cd, self.c_config)
        tg, td = port_models()
        tg.load_state_dict(catgen_to_state_dict(gv["params"], gv["state"]))
        td.load_state_dict(catgen_to_state_dict(dv["params"], dv["state"]))
        self.t_state = tgan.init_state(tg, td, self.t_config)
        self.t_step = tgan.make_train_step(tg, td, self.t_config)

    def step(self, reals: np.ndarray, seed: int):
        """One step on both sides; returns (catgen metrics, port metrics,
        catgen grads, port grads), grads per update in order."""
        c_grads, t_grads = [], []
        with record_jax_draws() as draws, \
                capture_grads(copt, c_grads, catgen_grads_to_port):
            self.c_state, cm = self.c_step(self.c_state, jnp.asarray(reals),
                                           jax.random.PRNGKey(seed))
        replay = ReplayDraws(draws)
        with capture_grads(topt, t_grads, port_grads_to_numpy):
            tm = self.t_step(self.t_state, torch.tensor(reals), replay)
        assert not replay.records, "catgen drew more than the port"
        return cm, tm, c_grads, t_grads

    def assert_state_close(self):
        c, t = self.c_state, self.t_state
        for module, params, state in ((t.g, c.g_params, c.g_state),
                                      (t.d, c.d_params, c.d_state)):
            want = catgen_to_state_dict(np_tree(params), np_tree(state))
            got = module.state_dict()
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           rtol=0, atol=ATOL, err_msg=k)
        for t_opt, c_opt in ((t.g_opt, c.g_opt), (t.d_opt, c.d_opt)):
            for field, value in zip(type(t_opt)._fields, t_opt):
                want = getattr(c_opt, field)
                if isinstance(value, dict):
                    want = catgen_to_state_dict(np_tree(want), {})
                    for k in value:
                        np.testing.assert_allclose(
                            value[k].numpy(), want[k].numpy(), rtol=0,
                            atol=ATOL, err_msg=f"{field} {k}")
                else:
                    assert int(value) == int(want), field
        np.testing.assert_allclose(t.acc_buffer.numpy(),
                                   np.asarray(c.acc_buffer), rtol=RTOL)
        assert (t.acc_count, t.acc_index, t.step) == (
            int(c.acc_count), int(c.acc_index), int(c.step))


def assert_metrics_close(cm, tm):
    for name in ("loss_d", "loss_g", "acc_d", "acc_avg"):
        np.testing.assert_allclose(float(getattr(tm, name)),
                                   float(getattr(cm, name)), rtol=RTOL,
                                   err_msg=name)
    for name in ("d_trained", "tp_real", "tn_fake", "fp", "fn"):
        assert float(getattr(tm, name)) == float(getattr(cm, name)), name


def _reals(n, seed, normalized=False):
    x = np.random.RandomState(seed).rand(n, *IMG).astype(np.float32)
    return x * 2.0 - 1.0 if normalized else x


CASES = {
    "default": dict(),
    "gate_closed": dict(d_max_acc=0.0),
    "gate_window": dict(d_max_acc=0.55, acc_window=2),
    "d_iterations_2": dict(d_iterations=2),
    "bce_torch": dict(bce="torch"),
    "bce_clip": dict(bce="clip"),
    "g_frozen": dict(g_frozen_children=("00_Dense",), g_l2=1e-2,
                     g_l1=1e-3),
    "g_bn_fixed_in_d": dict(g_bn_advance_in_d=False),
    "augment": dict(augment=True),
    "normalized_augment": dict(augment=True, normalized_inputs=True),
    # sgd for the other optimizer path of the step. adagrad's and
    # rmsprop's first steps are +-lr*const whatever |g| is, so a gradient
    # near zero (G's bias in front of BatchNorm is rounding noise) turns
    # rounding into full-size steps; they are held against catgen in
    # tests/test_torch_port_optim.py instead
    "sgd": dict(d_optimizer="sgd", d_sgd_momentum=0.5, g_optimizer="sgd"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_match_catgen(case):
    config = CASES[case]
    pair = Pair(**config)
    g_before = {k: v.clone() for k, v in pair.t_state.g.state_dict().items()}
    half = BATCH // 2 * config.get("d_iterations", 1)
    steps = 3 if "acc_window" in config else 2   # the gate window wraps
    for i in range(steps):
        reals = _reals(half, seed=10 + i,
                       normalized=config.get("normalized_inputs", False))
        cm, tm, c_grads, t_grads = pair.step(reals, seed=20 + i)
        assert_metrics_close(cm, tm)
        assert len(c_grads) == len(t_grads) == config.get(
            "d_iterations", 1) + 1
        for got, want in zip(t_grads, c_grads):
            assert_grads_close(got, want)
        pair.assert_state_close()
    if case == "gate_closed":
        assert int(pair.t_state.d_opt.step) == 0
        assert float(tm.d_trained) == 0.0
    if case == "g_frozen":
        for k, v in pair.t_state.g.state_dict().items():
            assert torch.equal(v, g_before[k]) == k.startswith("00_Dense."), k


def test_step_leaves_d_grads_untouched_and_counts_steps():
    pair = Pair()
    draws = Draws(torch.Generator().manual_seed(0))
    m = pair.t_step(pair.t_state, torch.tensor(_reals(BATCH // 2, 1)),
                    draws)
    assert all(p.grad is None for p in pair.t_state.d.parameters())
    assert all(p.grad is None for p in pair.t_state.g.parameters())
    assert pair.t_state.step == 1 and int(pair.t_state.d_opt.step) == 1
    assert sum(float(x) for x in m[5:]) == BATCH


def test_epoch_stacks_step_metrics():
    a, b = Pair(), Pair()
    reals = torch.tensor(np.stack([_reals(BATCH // 2, s) for s in (1, 2)]))
    epoch = tgan.make_train_epoch(a.t_state.g, a.t_state.d, a.t_config)
    m = epoch(a.t_state, reals, Draws(torch.Generator().manual_seed(3)))
    draws = Draws(torch.Generator().manual_seed(3))
    steps = [b.t_step(b.t_state, r, draws) for r in reals]
    assert a.t_state.epoch == 2 and a.t_state.step == 2
    for i, s in enumerate(steps):
        assert all(torch.equal(x[i], y) for x, y in zip(m, s))


def test_bad_configs_raise():
    g, d = port_models()
    with pytest.raises(KeyError, match="not a top-level G child"):
        tgan.make_train_step(g, d, tgan.GanConfig(
            g_frozen_children=("99_Nope",)))
    with pytest.raises(ValueError, match="bce"):
        tgan.make_train_step(g, d, tgan.GanConfig(bce="hinge"))
    step = tgan.make_train_step(g, d, tgan.GanConfig(batch_size=BATCH,
                                                     noise_dim=NOISE))
    state = tgan.init_state(g, d, tgan.GanConfig())
    with pytest.raises(ValueError, match="reals"):
        step(state, torch.zeros((BATCH,) + IMG),
             Draws(torch.Generator()))


def test_port_config_fields_are_catgens():
    ported = {f.name for f in dataclasses.fields(tgan.GanConfig)}
    catgen = {f.name for f in dataclasses.fields(cgan.GanConfig)}
    # every field, the DP axis (axis_name) included
    assert ported == catgen
