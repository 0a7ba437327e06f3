"""The port's layers and small pieces against catgen's, on the CPU.

Each case builds the catgen layer and its port counterpart, carries
catgen's (perturbed) weights over with catgen_torch.io.convert, feeds both
the same numpy input and compares. Unless a case says otherwise the
tolerance is rtol 1e-5 / atol 1e-5: both sides compute in f32 with the
same formulas and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import nn as cnn
from catgen.core import initializers as cinit
from catgen.core.module import Sequential as CSequential
from catgen.data import color as ccolor
from catgen.data import fixture as cfixture
from catgen.data import ops as cops
from catgen.io import grids as cgrids
from catgen.kernels import upsample_conv as cuc
from catgen.nn import spatial_transformer as cst
from catgen_torch.core import initializers as tinit
from catgen_torch.core.module import Sequential as TSequential
from catgen_torch.core.module import reset_parameters
from catgen_torch.core.random import Draws
from catgen_torch.data import color as tcolor
from catgen_torch.data import fixture as tfixture
from catgen_torch.data import ops as tops
from catgen_torch.io import grids as tgrids
from catgen_torch.io.convert import (catgen_to_state_dict, kernel_to_weight,
                                     state_dict_to_catgen)
from catgen_torch.kernels import upsample_conv as tuc
from catgen_torch.nn import layers as tl
from catgen_torch.nn import spatial_transformer as tst

from torch_port_helpers import np_tree, perturb

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(layer, variables):
    layer.load_state_dict(catgen_to_state_dict(variables["params"],
                                               variables["state"]),
                          strict=True)
    return layer


def _run_pair(c_layer, t_layer, shape, train=False, seed=0):
    rng = np.random.RandomState(seed)
    variables = np_tree(c_layer.init(jax.random.PRNGKey(seed), shape))
    perturb(variables, rng)
    x = rng.normal(0.0, 1.0, shape).astype(np.float32)
    # one jitted program compiles faster than catgen's ops one by one
    want, new_state = jax.jit(lambda v, x: c_layer.apply(
        v, x, train=train))(variables, jnp.asarray(x))
    t_layer = _port(t_layer, variables)
    t_layer.train(train)
    with torch.no_grad():
        got = t_layer(torch.tensor(x))
    return np.asarray(want), got.numpy(), new_state, t_layer


LAYERS = {
    "dense": (lambda: cnn.Dense(5), lambda: tl.Dense(12, 5), (3, 12)),
    "conv3_cin3": (lambda: cnn.Conv(8, (3, 3)), lambda: tl.Conv(3, 8, (3, 3)),
                   (2, 9, 7, 3)),
    "conv5": (lambda: cnn.Conv(6, (5, 5)), lambda: tl.Conv(8, 6, (5, 5)),
              (2, 8, 8, 8)),
    "conv7": (lambda: cnn.Conv(5, (7, 7)), lambda: tl.Conv(4, 5, (7, 7)),
              (2, 8, 8, 4)),
    "batchnorm_nhwc": (lambda: cnn.BatchNorm(), lambda: tl.BatchNorm(6),
                       (4, 5, 5, 6)),
    "batchnorm_nf": (lambda: cnn.BatchNorm(), lambda: tl.BatchNorm(7),
                     (6, 7)),
    "prelu": (lambda: cnn.PReLU(), lambda: tl.PReLU(), (3, 4, 4, 5)),
    "leaky_relu": (lambda: cnn.LeakyReLU(), lambda: tl.LeakyReLU(),
                   (3, 4, 4, 5)),
    "sigmoid": (lambda: cnn.Sigmoid(), lambda: tl.Sigmoid(), (3, 7)),
    "dropout_eval": (lambda: cnn.Dropout(0.5), lambda: tl.Dropout(0.5),
                     (3, 7)),
    "spatial_dropout_eval": (lambda: cnn.SpatialDropout(0.2),
                             lambda: tl.SpatialDropout(0.2), (2, 4, 4, 6)),
    "maxpool": (lambda: cnn.MaxPool(2), lambda: tl.MaxPool(2), (2, 8, 6, 5)),
    "avgpool": (lambda: cnn.AvgPool(2), lambda: tl.AvgPool(2), (2, 8, 6, 5)),
    "flatten": (lambda: cnn.Flatten(), lambda: tl.Flatten(), (2, 3, 4, 5)),
    "reshape": (lambda: cnn.Reshape((4, 4, 6)), lambda: tl.Reshape((4, 4, 6)),
                (2, 96)),
    "upsample_conv3": (lambda: cnn.UpsampleConv(6, (3, 3)),
                       lambda: tuc.UpsampleConv(5, 6, (3, 3)), (2, 4, 4, 5)),
    "upsample_conv5": (lambda: cnn.UpsampleConv(4, (5, 5)),
                       lambda: tuc.UpsampleConv(3, 4, (5, 5)), (2, 4, 5, 3)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_eval_matches_catgen(name):
    c_fn, t_fn, shape = LAYERS[name]
    want, got, _, _ = _run_pair(c_fn(), t_fn(), shape)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(4, 5, 5, 6), (6, 7)])
def test_batchnorm_train_matches_catgen(shape):
    want, got, new_state, t_layer = _run_pair(
        cnn.BatchNorm(), tl.BatchNorm(shape[-1]), shape, train=True)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(t_layer.mean.numpy(),
                               np.asarray(new_state["mean"]), **TOL)
    np.testing.assert_allclose(t_layer.var.numpy(),
                               np.asarray(new_state["var"]), **TOL)


@pytest.mark.parametrize("cls,mask_axes", [(tl.Dropout, ()),
                                           (tl.SpatialDropout, (1, 2))])
def test_dropout_train_semantics(cls, mask_axes):
    # torch's and jax's random streams differ, so the masks are not
    # compared; the inverted-dropout semantics are
    layer = cls(0.25).train()
    x = torch.rand(8, 4, 4, 16) + 0.5
    with pytest.raises(ValueError, match="draws"):
        layer(x)
    layer.draws = Draws(torch.Generator().manual_seed(0))
    y = layer(x)
    kept = y != 0
    torch.testing.assert_close(y[kept], (x / 0.75)[kept])
    assert 0.5 < kept.float().mean().item() < 0.95
    if mask_axes:       # one decision per (sample, channel)
        assert torch.equal(kept, kept[:, :1, :1, :].expand_as(kept))
    again = cls(0.25).train()
    tl.set_draws(again, Draws(torch.Generator().manual_seed(0)))
    assert torch.equal(again(x), y)


@pytest.mark.parametrize("method", sorted(cinit._SCALES))
def test_initializer_scales_and_bounds(method):
    for fan_in, fan_out in ((27, 576), (20480, 256)):
        assert tinit.SCALES[method](fan_in, fan_out) == pytest.approx(
            cinit._SCALES[method](fan_in, fan_out), rel=1e-12)
    w = torch.empty(64, 32, 3, 3)
    tinit.uniform_fan(method)(w, 32 * 9, 64 * 9,
                              torch.Generator().manual_seed(0))
    std = cinit._SCALES[method](32 * 9, 64 * 9)
    assert w.abs().max().item() <= std
    assert w.abs().max().item() > 0.98 * std
    assert abs(w.mean().item()) < 0.05 * std


def test_reset_parameters_is_seeded_and_keeps_identity_heads():
    def make():
        st = tst.SpatialTransformer((16, 16, 4), True, True, True)
        reset_parameters(st, torch.Generator().manual_seed(3))
        return st

    a, b = make(), make()
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.count_nonzero(a.head.weight) == 0
    assert a.head.bias.tolist() == [0.0, 1.0, 0.0, 0.0]
    assert torch.count_nonzero(a.loc.get_submodule("01_Conv").weight) > 0


@pytest.mark.parametrize("k", [3, 5])
def test_upsample2_conv_matches_catgen(k):
    rng = np.random.RandomState(k)
    x = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)
    kernel = rng.normal(size=(k, k, 6, 7)).astype(np.float32)
    want = np.asarray(cuc.upsample2_conv(jnp.asarray(x), jnp.asarray(kernel)))
    weight = torch.tensor(kernel_to_weight(kernel))
    got = tuc.upsample2_conv(torch.tensor(x), weight).numpy()
    ref = tuc.upsample2_conv_reference(torch.tensor(x), weight).numpy()
    assert got.shape == (2, 8, 10, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    for d in (0, 1):
        for e in (0, 1):
            ck_c, pad_c = cuc.collapse_weights(jnp.asarray(kernel), d, e)
            ck_t, pad_t = tuc.collapse_weights(weight, d, e)
            assert pad_t == pad_c
            np.testing.assert_allclose(
                ck_t.numpy(), kernel_to_weight(np.asarray(ck_c)), **TOL)


@pytest.mark.parametrize("flags", [(True, False, False), (True, True, True),
                                   (False, True, False), (False, False, True),
                                   (False, False, False)])
def test_affine_matrix_and_grids_match_catgen(flags):
    n_params = (flags[0] + flags[1] + 2 * flags[2]) or 6
    params = np.random.RandomState(0).normal(
        0.0, 0.5, (3, n_params)).astype(np.float32)
    want = np.asarray(cst.affine_matrix(jnp.asarray(params), *flags))
    theta = tst.affine_matrix(torch.tensor(params), *flags)
    np.testing.assert_allclose(theta.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tst.affine_grid_rows(theta, 6, 5).numpy(),
        np.asarray(cst.affine_grid_rows(jnp.asarray(want), 6, 5)), **TOL)
    np.testing.assert_allclose(
        tst.affine_grid(theta, 6, 5).numpy(),
        np.asarray(cst.affine_grid(jnp.asarray(want), 6, 5)), **TOL)


def _small_tail(cin):
    return (CSequential([cnn.Conv(8, (3, 3)), cnn.PReLU()], name="st_tail"),
            TSequential([tl.Conv(cin, 8, (3, 3)), tl.PReLU()],
                        name="st_tail"))


STS = {
    "spatial_transformer": (
        lambda: cst.SpatialTransformer(True, True, True),
        lambda: tst.SpatialTransformer((16, 16, 4), True, True, True),
        (2, 16, 16, 4)),
    "fused_st_conv_prelu": (
        lambda: cst.FusedSTConvPReLU(cst.SpatialTransformer(True, False,
                                                            False),
                                     cnn.Conv(8, (3, 3)), cnn.PReLU()),
        lambda: tst.FusedSTConvPReLU(
            tst.SpatialTransformer((16, 12, 3), True, False, False),
            tl.Conv(3, 8, (3, 3)), tl.PReLU()),
        (2, 16, 12, 3)),
    "fused_st_branches": (
        lambda: cst.FusedSTBranches([_small_tail(6)[0] for _ in range(3)],
                                    _small_tail(6)[0]),
        lambda: tst.FusedSTBranches([_small_tail(6)[1] for _ in range(3)],
                                    _small_tail(6)[1], (8, 8, 6)),
        (2, 8, 8, 6)),
}


@pytest.mark.parametrize("name", sorted(STS))
def test_spatial_transformer_modules_match_catgen(name):
    # perturbed heads: the grids rotate, scale and shift past the edges
    c_fn, t_fn, shape = STS[name]
    want, got, _, _ = _run_pair(c_fn(), t_fn(), shape, seed=2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_sequential_child_names_match_catgen():
    c = CSequential([cnn.Dense(4), cnn.PReLU(),
                     CSequential([cnn.Dense(2)], name="inner")], name="outer")
    t = TSequential([tl.Dense(3, 4), tl.PReLU(),
                     TSequential([tl.Dense(4, 2)], name="inner")],
                    name="outer")
    variables = c.init(jax.random.PRNGKey(0), (1, 3))
    assert [n for n, _ in t.named_children()] == list(variables["params"])
    assert set(t.state_dict()) == set(catgen_to_state_dict(
        np_tree(variables["params"]), np_tree(variables["state"])))


def test_convert_round_trip():
    layer = cnn.Conv(4, (3, 3))
    variables = np_tree(layer.init(jax.random.PRNGKey(0), (1, 5, 5, 2)))
    bn = np_tree(cnn.BatchNorm().init(jax.random.PRNGKey(1), (1, 3)))
    params = {"00_Conv": variables["params"], "01_BatchNorm": bn["params"]}
    state = {"00_Conv": {}, "01_BatchNorm": bn["state"]}
    sd = catgen_to_state_dict(params, state)
    assert tuple(sd["00_Conv.weight"].shape) == (4, 2, 3, 3)
    p2, s2 = state_dict_to_catgen(sd)
    for tree, back in ((params, p2), (state, s2)):
        want = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
        got = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(back)[0]}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("space", ["rgb", "y", "yuv", "hsl"])
def test_color_spaces_match_catgen(space):
    x = np.random.RandomState(0).rand(2, 5, 4, 3).astype(np.float32)
    fwd = np.asarray(ccolor.rgb_to_colorspace(jnp.asarray(x), space))
    got = tcolor.rgb_to_colorspace(torch.tensor(x), space)
    np.testing.assert_allclose(got.numpy(), fwd, **TOL)
    back = np.asarray(ccolor.colorspace_to_rgb(jnp.asarray(fwd), space))
    np.testing.assert_allclose(
        tcolor.colorspace_to_rgb(got, space).numpy(), back, **TOL)
    assert tcolor.channels(space) == ccolor.channels(space)


def test_downscale2_matches_catgen():
    x = np.random.RandomState(0).rand(2, 8, 6, 3).astype(np.float32)
    np.testing.assert_allclose(
        tops.downscale2(torch.tensor(x)).numpy(),
        np.asarray(cops.downscale2(jnp.asarray(x))), **TOL)


def test_fixture_and_grids_equal_catgen():
    imgs = tfixture.make_fixture_images(3, size=32, seed=5)
    np.testing.assert_array_equal(imgs,
                                  cfixture.make_fixture_images(3, 32, 5))
    f = imgs.astype(np.float32) / 255.0
    np.testing.assert_array_equal(tgrids.to_grid(f, nrow=2, epoch=17),
                                  cgrids.to_grid(f, nrow=2, epoch=17))
    np.testing.assert_array_equal(tgrids.to_grid(f[..., :1]),
                                  cgrids.to_grid(f[..., :1]))


def test_registries_hold_only_the_ported_pair():
    from catgen_torch import models

    assert set(models.G_REGISTRY) == {"g32up_c", "default", "g64_stack",
                                      "refine64"}
    assert set(models.D_REGISTRY) == {"d32_st3", "default", "d64"}
    for registry, key in ((models.G_REGISTRY, "g16up"),
                          (models.D_REGISTRY, "d32")):
        with pytest.raises(NotImplementedError, match="Queue A item 10"):
            registry[key]
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        models.create_G((16, 16, 3), 100)


def test_cached_constants_serve_autograd_after_inference():
    # the collapse matrices and base grids are cached per device; one made
    # first under inference mode must still be savable for backward
    x = torch.rand(1, 4, 4, 3)
    w = torch.rand(5, 3, 5, 5)
    theta = torch.rand(2, 2, 3)
    with torch.inference_mode():
        tuc.upsample2_conv(x, w)
        tst.affine_grid_rows(theta, 7, 6)
    w.requires_grad_(True)
    theta.requires_grad_(True)
    tuc.upsample2_conv(x, w).sum().backward()
    tst.affine_grid_rows(theta, 7, 6).sum().backward()
    assert w.grad is not None and theta.grad is not None
