"""Full-width G32up-c on the port's boundary-fused ladder
(catgen_torch/nn/fused.py on the upsample-conv kernel route) against
catgen's Pallas ladder in interpret mode, with the weights carried across
by ``io/convert.py``, at batch 2: the train-mode forward (images and
BatchNorm running statistics), the eval forward, and the gradients of a
fixed loss with respect to every G leaf under ``ladder_bwd="pallas"``. On
the CPU the port runs the kernels' plain versions. One train step on each
route is in test_torch_port_kernel_route_step.py.

Tolerances, f32 on both sides: images within 1e-5 (absolute; sigmoid
outputs); BatchNorm statistics within 1e-5 relative to each buffer's
largest; gradients per leaf within 1e-4 of the leaf's largest (plus 1e-6
of the largest gradient, for leaves that are rounding noise: the
upsample biases in front of BatchNorm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from catgen import models as cmodels
from catgen_torch import models as tmodels
from catgen_torch.io.convert import catgen_to_state_dict, state_dict_to_catgen
from catgen_torch.kernels import config as tconfig
from catgen_torch.train import gan as tgan

from torch_port_helpers import (IMG, LADDER, NOISE_DIM,  # noqa: F401
                                assert_grads_close, catgen_grads_to_port,
                                catgen_route, np_tree, perturb)


def _g32(seed=0):
    g = cmodels.create_G_decoder_upsampling32c(IMG, NOISE_DIM)
    gv = np_tree(g.init(jax.random.PRNGKey(seed), (1, NOISE_DIM)))
    perturb(gv, np.random.RandomState(seed), gain=1.0)
    tg = tmodels.create_G_decoder_upsampling32c(IMG, NOISE_DIM)
    tg.load_state_dict(catgen_to_state_dict(gv["params"], gv["state"]),
                       strict=True)
    return g, gv, tg


def _buffers_close(port, catgen_state):
    want = catgen_to_state_dict({}, np_tree(catgen_state))
    for k, v in want.items():
        got = port.state_dict()[k].numpy()
        bound = 1e-5 * max(float(np.abs(v.numpy()).max()), 1e-6)
        assert np.abs(got - v.numpy()).max() <= bound, k


def test_g32_train_forward_and_bn_state_match_catgen(catgen_route):
    catgen_route(**LADDER)
    g, gv, tg = _g32()
    z = np.random.RandomState(1).uniform(-1, 1, (2, NOISE_DIM)).astype(
        np.float32)
    want, new_state = g.apply(gv, jnp.asarray(z), train=True,
                              rng=jax.random.PRNGKey(1))
    with tconfig.using(**LADDER), torch.no_grad():
        got = tg.train()(torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    _buffers_close(tg, new_state)


def test_g32_eval_forward_matches_catgen(catgen_route):
    catgen_route(**LADDER)
    g, gv, tg = _g32(2)
    z = np.random.RandomState(3).uniform(-1, 1, (2, NOISE_DIM)).astype(
        np.float32)
    want, _ = g.apply(gv, jnp.asarray(z), train=False)
    with tconfig.using(**LADDER):
        got = tgan.generate(tg, torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_g32_gradients_match_catgen(catgen_route):
    catgen_route(**LADDER)
    g, gv, tg = _g32(4)
    r = np.random.RandomState(5)
    z = r.uniform(-1, 1, (2, NOISE_DIM)).astype(np.float32)
    tgt = r.rand(2, *IMG).astype(np.float32)

    def loss(params):
        y, _ = g.apply({"params": params, "state": gv["state"]},
                       jnp.asarray(z), train=True, rng=jax.random.PRNGKey(1))
        return jnp.mean((y - tgt) ** 2)

    want = catgen_grads_to_port(jax.grad(loss)(gv["params"]))
    tg.train()
    with tconfig.using(**LADDER):
        torch.mean((tg(torch.tensor(z)) - torch.tensor(tgt)) ** 2).backward()
    got = {k: p.grad.numpy() for k, p in tg.named_parameters()}
    assert_grads_close(got, want)
    # the names did not change: after a ladder-route step the state
    # converts to catgen's leaves and back, key for key
    params, state = state_dict_to_catgen(tg.state_dict())
    assert set(catgen_to_state_dict(params, state)) == set(
        catgen_to_state_dict(gv["params"], gv["state"]))
