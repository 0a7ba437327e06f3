"""D's fused [input ST -> conv3x3 -> PReLU] prefix in the port
(catgen_torch/kernels/st_conv.py) on the CPU, against catgen: its split
composition (XLA bilinear_sample + conv_general_dilated, f32) and its
Pallas kernel (kernels/pallas_st_conv.py) in interpret mode.

On CPU tensors ``st_conv_prelu`` runs its plain version; the autograd
Function (``_STConvPReLU``, the CUDA kernel's backward formula) runs here
with the plain forward and the plain sampler backward, so both are held
against catgen.

Tolerances:
  * against the split composition, f32 on both sides, the same formulas
    in another summation order: forward atol 1e-5; each gradient within
    1e-4 of its largest value;
  * against the interpret-mode kernel, which rounds the sampled tile and
    the weights to bf16 and stores z in bf16: catgen's own test and
    tolerances (tests/test_st_conv_fused.py), 5e-2 forward and 4e-2 of
    each gradient's scale for the gradients of sum(out**2). (Under a
    random cotangent the bf16 z moves the PReLU's kinks: catgen's VJP
    then differs from its own split reference by up to ~20%.)
With the identity transform every output pixel samples exactly at an
image pixel, where bilinear interpolation has a kink: which side's slope
d_theta takes is decided by the last bit of each coordinate (and, on the
border, by the clip's derivative: 0.5 in catgen's XLA sampler, 1 in v4
and the port, ROADMAP Queue C). The identity cases therefore hold every
gradient but d_theta.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import models as cmodels
from catgen import nn as cnn
from catgen import optim as copt
from catgen.kernels.pallas_st_conv import st_conv_prelu as c_st_conv_prelu
from catgen.nn.spatial_transformer import (FusedSTConvPReLU, affine_grid,
                                          bilinear_sample)
from catgen.train import gan as cgan
from catgen_torch import models as tmodels
from catgen_torch import optim as topt
from catgen_torch.core.module import Sequential as TSequential
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.kernels import config as tconfig
from catgen_torch.kernels import st_conv
from catgen_torch.nn import layers as tl
from catgen_torch.nn import spatial_transformer as tst
from catgen_torch.train import gan as tgan

from torch_port_helpers import (ReplayDraws, assert_grads_close,
                                capture_grads, catgen_grads_to_port,
                                np_tree, perturb,
                                port_grads_to_numpy, record_jax_draws)

NAMES = ("d_img", "d_theta", "d_kernel", "d_bias", "d_alpha")
# (name, n, h, w, c, f, channelwise slope, identity theta)
CASES = [("shared", 3, 16, 16, 3, 8, False, False),
         ("channelwise", 3, 16, 16, 3, 8, True, False),
         ("identity", 2, 16, 16, 3, 8, False, True),
         ("h_ne_w_f40", 2, 12, 16, 3, 40, True, False)]


def _reference(img, theta, kernel, bias, alpha):
    """catgen's split composition, f32."""
    grid = affine_grid(theta, img.shape[1], img.shape[2])
    s = bilinear_sample(img, grid)
    z = jax.lax.conv_general_dilated(
        s, kernel, (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
    a = alpha if alpha.size == 1 else alpha.reshape(1, 1, 1, -1)
    return jnp.where(z >= 0, z, a * z)


def _inputs(seed, n, h, w, c, f, channelwise, identity):
    rng = np.random.RandomState(seed)
    img = rng.rand(n, h, w, c).astype(np.float32)
    ang = rng.uniform(-0.5, 0.5, n)
    scale = rng.uniform(0.85, 1.15, n)
    cos, sin = np.cos(ang) * scale, np.sin(ang) * scale
    theta = np.stack([np.stack([cos, -sin, rng.uniform(-0.1, 0.1, n)], -1),
                      np.stack([sin, cos, rng.uniform(-0.1, 0.1, n)], -1)],
                     axis=1).astype(np.float32)
    if identity:
        theta = np.tile(np.eye(2, 3, dtype=np.float32), (n, 1, 1))
    kernel = (rng.randn(3, 3, c, f) * 0.2).astype(np.float32)
    bias = (rng.randn(f) * 0.1).astype(np.float32)
    alpha = (rng.rand(f if channelwise else 1) * 0.5 + 0.05).astype(
        np.float32)
    g = rng.randn(n, h, w, f).astype(np.float32)
    return (img, theta, kernel, bias, alpha), g


def _port_grads(fn, args, g):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.tensor(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _catgen_grads(fn, args, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _close(got, want, rel, name):
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-3)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: {err} > {rel} x {scale}"


PORT_FNS = {"plain": st_conv.st_conv_prelu_plain,
            "function": st_conv._STConvPReLU.apply}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_and_function_match_catgen_split(case):
    _, *shape, channelwise, identity = case
    args, g = _inputs(0, *shape, channelwise, identity)
    want, want_grads = _catgen_grads(_reference, args, g)
    for label, fn in PORT_FNS.items():
        out, grads = _port_grads(fn, args, g)
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-5,
                                   err_msg=label)
        for name, a, b in zip(NAMES, grads, want_grads):
            if identity and name == "d_theta":
                continue       # decided by rounding at the kinks, above
            _close(a, b, 1e-4, f"{label} {name}")


@pytest.mark.parametrize("channelwise", [False, True],
                         ids=["shared", "channelwise"])
@pytest.mark.parametrize("identity", [False, True],
                         ids=["affine", "identity"])
def test_function_matches_catgen_interpret(channelwise, identity):
    args, _ = _inputs(1, 2, 12, 16, 3, 8, channelwise, identity)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(c_st_conv_prelu(*jargs, True))
    want_grads = jax.grad(
        lambda *a: jnp.sum(c_st_conv_prelu(*a, True) ** 2),
        argnums=tuple(range(5)))(*jargs)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = st_conv._STConvPReLU.apply(*ts)
    grads = torch.autograd.grad((out ** 2).sum(), ts)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=5e-2,
                               atol=5e-2)
    for name, a, b in zip(NAMES, grads, want_grads):
        if identity and name == "d_theta":
            continue
        _close(a.numpy(), np.asarray(b), 4e-2, name)


@pytest.fixture
def catgen_st_conv(monkeypatch):
    """Sets catgen's ST-conv selector (and interpret mode) for this test
    only: ``catgen_st_conv("fused")``."""
    from catgen.kernels import config as kconfig

    def use(impl):
        monkeypatch.setattr(kconfig, "st_conv_impl", impl)
        monkeypatch.setattr(kconfig, "st_conv_interpret", impl == "fused")
    return use


@pytest.fixture
def function_route(monkeypatch):
    """The port's fused route through the autograd Function on the CPU
    (the kernel's backward formula with the plain pieces), counting its
    calls."""
    calls = []

    def fused(*args):
        calls.append(args[0].shape)
        return st_conv._STConvPReLU.apply(*args)

    monkeypatch.setattr(tst, "st_conv_prelu", fused)
    return calls


def test_d32_st3_fused_route_matches_catgen(catgen_st_conv, function_route):
    # D32_st3 at 16x16x3, batch 2, perturbed weights and ST heads; the
    # port's fused route against catgen's split route (atol 1e-5, as
    # test_torch_port_models.py holds D) and against its fused kernel
    # interpreted (catgen's 5e-2)
    image = (16, 16, 3)
    d = cmodels.create_D32_st3(image)
    # jitted: catgen's eager init and apply take seconds each here
    dv = np_tree(jax.jit(d.init, static_argnums=1)(jax.random.PRNGKey(4),
                                                   (1,) + image))
    perturb(dv, np.random.RandomState(4))
    td = tmodels.create_D32_st3(image)
    td.load_state_dict(catgen_to_state_dict(dv["params"], dv["state"]))
    td.eval()
    x = np.random.RandomState(5).rand(2, *image).astype(np.float32)
    want = {}
    for impl in ("split", "fused"):
        catgen_st_conv(impl)
        want[impl] = np.asarray(jax.jit(
            lambda v, a: d.apply(v, a, train=False)[0])(dv, jnp.asarray(x)))
    with tconfig.using(st_conv_impl="fused"), torch.no_grad():
        got = td(torch.tensor(x)).numpy()
    assert len(function_route) == 1
    assert abs(float(want["split"][0, 0] - want["split"][1, 0])) > 1e-3
    np.testing.assert_allclose(got, want["split"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want["fused"], rtol=0, atol=5e-2)


IMG = (8, 12, 3)
NOISE, BATCH = 8, 4


def _step_models():
    """A small G (dense -> sigmoid image) and a small D that opens with
    D32_st3's prefix [rotation-only ST -> conv3x3 -> PReLU], in catgen and
    in the port."""
    h, w, c = IMG
    cg = cnn.Sequential([cnn.Dense(h * w * c), cnn.Sigmoid(),
                         cnn.Reshape(IMG)], name="tinyG")
    cd = cnn.Sequential([
        FusedSTConvPReLU(cnn.SpatialTransformer(True, False, False),
                             cnn.Conv(6, (3, 3)), cnn.PReLU()),
        cnn.Flatten(), cnn.Dense(1), cnn.Sigmoid()], name="tinyD")
    tg = TSequential([tl.Dense(NOISE, h * w * c), tl.Sigmoid(),
                      tl.Reshape(IMG)], name="tinyG")
    td = TSequential([
        tst.FusedSTConvPReLU(tst.SpatialTransformer(IMG, True, False, False),
                             tl.Conv(c, 6, (3, 3)), tl.PReLU()),
        tl.Flatten(), tl.Dense(h * w * 6, 1), tl.Sigmoid()], name="tinyD")
    return cg, cd, tg, td


def test_train_step_fused_route_matches_catgen(catgen_st_conv,
                                               function_route):
    """One train step with D32_st3's prefix on the port's fused route (the
    Function's forward and backward) against catgen's step on its split
    route, at tests/test_torch_port_train.py's tolerances: losses rtol
    1e-5, gradients 1e-4 of each leaf's largest, parameters atol 2e-5.
    (catgen's fused kernel rounds z to bf16, which moves the PReLU's kinks:
    its own step then differs from its split step by ~10% on the slope's
    gradient, so it is held at the op level above, with catgen's loss.)"""
    catgen_st_conv("split")
    config = dict(batch_size=BATCH, noise_dim=NOISE, acc_window=3)
    c_config, t_config = cgan.GanConfig(**config), tgan.GanConfig(**config)
    cg, cd, tg, td = _step_models()
    state = cgan.init_state(cg, cd, c_config, jax.random.PRNGKey(0), IMG)
    gv = np_tree({"params": state.g_params, "state": state.g_state})
    dv = np_tree({"params": state.d_params, "state": state.d_state})
    rng = np.random.RandomState(1)
    perturb(gv, rng, gain=1.0)
    perturb(dv, rng, gain=2.0)
    c_state = state._replace(g_params=gv["params"], g_state=gv["state"],
                             d_params=dv["params"], d_state=dv["state"])
    tg.load_state_dict(catgen_to_state_dict(gv["params"], gv["state"]))
    td.load_state_dict(catgen_to_state_dict(dv["params"], dv["state"]))
    t_state = tgan.init_state(tg, td, t_config)
    reals = np.random.RandomState(2).rand(BATCH // 2, *IMG).astype(
        np.float32)

    c_grads, t_grads = [], []
    with record_jax_draws() as draws, \
            capture_grads(copt, c_grads, catgen_grads_to_port):
        c_state, cm = cgan.make_train_step(cg, cd, c_config)(
            c_state, jnp.asarray(reals), jax.random.PRNGKey(3))
    with tconfig.using(st_conv_impl="fused"), \
            capture_grads(topt, t_grads, port_grads_to_numpy):
        tm = tgan.make_train_step(tg, td, t_config)(
            t_state, torch.tensor(reals), ReplayDraws(draws))
    # the D phase's D forward and the G phase's took the fused route
    assert len(function_route) == 2
    for name in ("loss_d", "loss_g", "acc_d", "acc_avg"):
        np.testing.assert_allclose(float(getattr(tm, name)),
                                   float(getattr(cm, name)), rtol=1e-5,
                                   err_msg=name)
    assert len(c_grads) == len(t_grads) == 2
    for got, want in zip(t_grads, c_grads):
        assert_grads_close(got, want)
    for module, params, st in ((tg, c_state.g_params, c_state.g_state),
                               (td, c_state.d_params, c_state.d_state)):
        want = catgen_to_state_dict(np_tree(params), np_tree(st))
        got = module.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=2e-5, err_msg=k)


def test_route_selection_and_can_fuse(function_route):
    # the default route is split; fused where catgen's _can_fuse allows
    # (3x3 'same' conv, image larger than 2x2), else split again
    assert tconfig.resolve_st_conv_impl() == "split"
    prefix = tst.FusedSTConvPReLU(tst.SpatialTransformer((8, 8, 3), True,
                                                         False, False),
                                  tl.Conv(3, 4, (3, 3)), tl.PReLU())
    x = torch.rand(2, 8, 8, 3)
    split = prefix(x)
    with tconfig.using(st_conv_impl="fused"):
        fused = prefix(x)
    assert len(function_route) == 1
    assert not prefix._can_fuse(torch.empty(2, 2, 8, 3))
    torch.testing.assert_close(fused, split, rtol=0, atol=1e-6)
    wide = tst.FusedSTConvPReLU(tst.SpatialTransformer((8, 8, 3), True,
                                                       False, False),
                                tl.Conv(3, 4, (5, 5)), tl.PReLU())
    with tconfig.using(st_conv_impl="fused"):
        wide(x)
    assert len(function_route) == 1


def test_cpu_tensors_take_the_plain_version():
    args, _ = _inputs(2, 2, 8, 8, 3, 4, False, False)
    ts = [torch.tensor(a) for a in args]
    before = st_conv.LAUNCHES
    out = st_conv.st_conv_prelu(*ts)
    assert st_conv.LAUNCHES == before
    assert torch.equal(out, st_conv.st_conv_prelu_plain(*ts))


@pytest.mark.parametrize("bad", ["dtype", "kernel_shape", "alpha_shape",
                                 "contiguous", "device"])
def test_launch_checks_inputs(bad):
    # "meta" tensors carry shape, dtype and strides but no data: every
    # check before the device check runs without a card
    dev = "meta"
    img = torch.empty((2, 8, 8, 3), device=dev)
    theta = torch.empty((2, 2, 3), device=dev)
    kernel = torch.empty((3, 3, 3, 4), device=dev)
    bias = torch.empty((4,), device=dev)
    alpha = torch.empty((1,), device=dev)
    err, match = ValueError, None
    if bad == "dtype":
        img, err = img.double(), TypeError
    elif bad == "kernel_shape":
        kernel = torch.empty((3, 3, 4, 4), device=dev)
    elif bad == "alpha_shape":
        alpha = torch.empty((3,), device=dev)
    elif bad == "contiguous":
        img = img.transpose(1, 2)
    else:
        match = "needs CUDA tensors"
    with pytest.raises(err, match=match) as info:
        st_conv.launch(img, theta, kernel, bias, alpha)
    if bad != "device":
        assert "needs CUDA tensors" not in str(info.value)
