"""One ``make_train_step`` on the upsample-conv kernel route: a narrow G
built as a ``FusedDecoderSequential`` of upsample-conv stages, on the
ladder route and on the per-layer route (``upsample_bwd="pallas"``),
against catgen's step on its Pallas route in interpret mode, with
catgen's draws replayed in the port. On the CPU the port runs the
kernels' plain versions.

Tolerances, f32 on both sides, as tests/test_torch_port_train.py holds a
step (losses rtol 1e-5; parameters, moments and statistics atol 2e-5;
gradients per leaf within 1e-4 of the leaf's largest), but with a floor
of 1e-5 of the update's largest gradient: the upsample biases' gradient,
a sum of g over every output pixel that BatchNorm makes cancel to zero,
is rounding noise of ~1.6e-6 of the largest on both sides (G trains with
sgd here, so that noise moves its weights by lr x the noise, where
Adam's first step would move them by ~lr either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import nn as cnn
from catgen import optim as copt
from catgen.nn.fused import FusedDecoderSequential as CFused
from catgen.train import gan as cgan
from catgen_torch import optim as topt
from catgen_torch.core.module import Sequential as TSequential
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.kernels import config as tconfig
from catgen_torch.kernels import fused_upsample_conv as fuc
from catgen_torch.kernels.upsample_conv import UpsampleConv
from catgen_torch.nn import layers as tl
from catgen_torch.nn.fused import FusedDecoderSequential
from catgen_torch.train import gan as tgan

from torch_port_helpers import (LADDER, PER_LAYER, ReplayDraws,  # noqa: F401
                                assert_grads_close, capture_grads,
                                catgen_grads_to_port, catgen_route, np_tree,
                                perturb, port_grads_to_numpy,
                                record_jax_draws)

SMALL = (16, 16, 2)
NOISE, BATCH = 8, 8


def catgen_models():
    g = CFused([
        cnn.Dense(4 * 4 * 8), cnn.PReLU(), cnn.Reshape((4, 4, 8)),
        cnn.UpsampleConv(8, (3, 3)), cnn.BatchNorm(), cnn.PReLU(),
        cnn.UpsampleConv(6, (5, 5)), cnn.BatchNorm(), cnn.PReLU(),
        cnn.Conv(SMALL[2], (3, 3)), cnn.Sigmoid()], name="ladderG")
    d = cnn.Sequential([
        cnn.Conv(4, (3, 3)), cnn.PReLU(), cnn.Flatten(), cnn.Dense(1),
        cnn.Sigmoid()], name="tinyD")
    return g, d


def port_models():
    h, w, c = SMALL
    g = FusedDecoderSequential([
        tl.Dense(NOISE, 4 * 4 * 8), tl.PReLU(), tl.Reshape((4, 4, 8)),
        UpsampleConv(8, 8, (3, 3)), tl.BatchNorm(8), tl.PReLU(),
        UpsampleConv(8, 6, (5, 5)), tl.BatchNorm(6), tl.PReLU(),
        tl.Conv(6, c, (3, 3)), tl.Sigmoid()], name="ladderG")
    d = TSequential([
        tl.Conv(c, 4, (3, 3)), tl.PReLU(), tl.Flatten(),
        tl.Dense(h * w * 4, 1), tl.Sigmoid()], name="tinyD")
    return g, d


@pytest.mark.parametrize("route", ["ladder", "per_layer"])
def test_train_step_matches_catgen(catgen_route, route):
    choices = LADDER if route == "ladder" else PER_LAYER
    catgen_route(**choices)
    # G on sgd: Adam's first step moves a weight by ~lr whatever the size
    # of its gradient, and the upsample biases' gradient is rounding noise
    config = dict(batch_size=BATCH, noise_dim=NOISE, acc_window=3,
                  g_optimizer="sgd")
    c_config, t_config = cgan.GanConfig(**config), tgan.GanConfig(**config)
    cg, cd = catgen_models()
    state = cgan.init_state(cg, cd, c_config, jax.random.PRNGKey(0), SMALL)
    gv = np_tree({"params": state.g_params, "state": state.g_state})
    dv = np_tree({"params": state.d_params, "state": state.d_state})
    rng = np.random.RandomState(1)
    perturb(gv, rng, gain=1.0)
    perturb(dv, rng, gain=1.0)
    c_state = state._replace(g_params=gv["params"], g_state=gv["state"],
                             d_params=dv["params"], d_state=dv["state"])
    tg, td = port_models()
    tg.load_state_dict(catgen_to_state_dict(gv["params"], gv["state"]))
    td.load_state_dict(catgen_to_state_dict(dv["params"], dv["state"]))
    t_state = tgan.init_state(tg, td, t_config)
    t_step = tgan.make_train_step(tg, td, t_config)
    reals = np.random.RandomState(2).rand(BATCH // 2, *SMALL).astype(
        np.float32)

    c_grads, t_grads = [], []
    with record_jax_draws() as draws, \
            capture_grads(copt, c_grads, catgen_grads_to_port):
        c_state, cm = cgan.make_train_step(cg, cd, c_config)(
            c_state, jnp.asarray(reals), jax.random.PRNGKey(3))
    fuc.reset_launches()
    with tconfig.using(**choices), \
            capture_grads(topt, t_grads, port_grads_to_numpy):
        tm = t_step(t_state, torch.tensor(reals), ReplayDraws(draws))
    # CPU tensors take the plain versions: no kernel was launched
    assert sum(fuc.launches().values()) == 0
    for name in ("loss_d", "loss_g", "acc_d", "acc_avg"):
        np.testing.assert_allclose(float(getattr(tm, name)),
                                   float(getattr(cm, name)), rtol=1e-5,
                                   err_msg=name)
    assert len(c_grads) == len(t_grads) == 2
    for got, want in zip(t_grads, c_grads):
        assert_grads_close(got, want, floor=1e-5)
    for module, params, st in ((tg, c_state.g_params, c_state.g_state),
                               (td, c_state.d_params, c_state.d_state)):
        want = catgen_to_state_dict(np_tree(params), np_tree(st))
        got = module.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=2e-5, err_msg=k)
