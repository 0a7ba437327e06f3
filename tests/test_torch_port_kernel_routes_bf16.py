"""The kernel routes in bf16 (catgen's ``compute_dtype=bfloat16``) on the
CPU, against catgen: G's upsample-conv kernels (rows 3-6 of the port's
kernel table: ``kernels/fused_upsample_conv.py``), D's fused ST-conv prefix
(row 7: ``kernels/st_conv.py``), the ladder, and one bf16 train step on
each kernel route. catgen's Pallas kernels run in interpret mode; the
port runs the kernels' bf16 plain versions (the arithmetic the bf16 CUDA
kernels implement). Inputs are numpy arrays from seeds, rounded to bf16
and handed to both sides.

Tolerances:
  * rows 3-6: y, dx, dW and db (bf16) within 1 bf16 unit at catgen's value
    plus 2^-16 of the largest; the statistics and the transform's
    gradients (f32) within 1e-4 of the largest. Both sides take the f32
    sums of the same bf16 products and round at the same places; only the
    order of the f32 sums differs;
  * row 7: catgen's own 5e-2 (tests/test_st_conv_fused.py): the port's
    samples are v4's coordinates with f32 lerps rounded once, catgen's
    kernel multiplies bf16 weight masks;
  * the ladder: images within 2^-6 of the largest (two stages of one-ulp
    differences), the f32 BatchNorm statistics rtol 1e-2;
  * the steps: tests/test_torch_port_bf16.py's bounds (losses rtol 2e-2;
    gradients within 0.1 of the leaf plus 0.05 of the largest; a bias in
    front of a BatchNorm, rounding noise on both sides, within 0.5 of the
    largest).
catgen's ladder and steps run compiled (``jax.jit``, as it trains), its
draws and gradients taken out through ordered debug callbacks and the
draws replayed in the port, as tests/test_torch_port_bf16.py runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import nn as cnn
from catgen.kernels import pallas_upsample_conv as c_up
from catgen.kernels import pallas_upsample_conv_bwd as c_up_bwd
from catgen.kernels.pallas_st_conv import st_conv_prelu as c_st_conv_prelu
from catgen.nn.fused import FusedDecoderSequential as CFused
from catgen.nn.spatial_transformer import FusedSTConvPReLU as CFusedST
from catgen.train import gan as cgan
from catgen_torch import optim as topt
from catgen_torch.core.module import Sequential as TSequential
from catgen_torch.io.convert import catgen_to_state_dict, kernel_to_weight
from catgen_torch.kernels import config as tconfig
from catgen_torch.kernels import fused_upsample_conv as fuc
from catgen_torch.kernels import st_conv
from catgen_torch.kernels.upsample_conv import UpsampleConv
from catgen_torch.nn import layers as tl
from catgen_torch.nn import spatial_transformer as tst
from catgen_torch.nn.fused import FusedDecoderSequential
from catgen_torch.train import gan as tgan

from test_torch_port_bf16 import (BF16, STEP_RTOL, assert_bf16_close,
                                  assert_bf16_grads_close, f32, replayed,
                                  run_traced, to_bf16, traced_with_callbacks)
from torch_port_helpers import (LADDER, PER_LAYER,  # noqa: F401
                                bn_fed_biases, capture_grads, catgen_route,
                                np_tree, perturb, port_grads_to_numpy,
                                upsample_inputs)

ONE_ULP, FLOOR, SUMS = 1, 2.0 ** -16, 1e-4
# (n, h, w, cin, cout, k): k3 and k5, cin off the 16-byte vector of 8 bf16
SHAPES = [(2, 4, 5, 9, 12, 3), (2, 3, 4, 16, 10, 5)]
# catgen's kernels compiled (eager interpret mode takes seconds)
C_FORWARD = jax.jit(c_up.upsample2_conv_fused, static_argnames=("interpret",))
C_BLOCK = jax.jit(c_up.upsample2_conv_block_fused,
                  static_argnames=("with_stats", "interpret"))
C_BACKWARD = jax.jit(c_up_bwd.upsample2_conv_backward,
                     static_argnames=("interpret",))
C_BLOCK_BACKWARD = jax.jit(c_up_bwd.fused_block_backward,
                           static_argnames=("interpret",))


def _inputs(seed, shape, alpha_n=1):
    """upsample_inputs rounded to bf16 (the stats cotangents stay f32):
    numpy for catgen (bf16 arrays), tensors for the port (bf16)."""
    n, h, w, cin, cout, k = shape
    v = upsample_inputs(seed, n, h, w, cin, cout, k, alpha_n)
    v = {k_: (a if k_ in ("gs1", "gs2") else to_bf16(a))
         for k_, a in v.items()}
    c = {k_: jnp.asarray(a, jnp.float32 if k_ in ("gs1", "gs2") else BF16)
         for k_, a in v.items()}
    t = {k_: torch.tensor(kernel_to_weight(a) if k_ == "kern" else a)
         for k_, a in v.items()}
    t = {k_: (a if k_ in ("gs1", "gs2") else a.bfloat16())
         for k_, a in t.items()}
    return c, t


def _close(got, want, name):
    """bf16 values within one ulp + 2^-16 of the largest, f32 sums within
    1e-4 of the largest."""
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        assert_bf16_close(got, want, ONE_ULP, FLOOR, name)
        return
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, name
    bound = SUMS * max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= bound, name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prelu", [False, True])
def test_row3_forward_matches_catgen(shape, prelu):
    c, t = _inputs(10, shape, shape[4])
    want = C_FORWARD(c["x"], c["kern"], c["bias"],
                     c["alpha"] if prelu else None, interpret=True)
    got = fuc.upsample2_conv_fused(t["x"], t["kern"], t["bias"],
                                   t["alpha"] if prelu else None)
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    _close(got, want, "y")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_stats", [True, False])
def test_row4_block_matches_catgen(shape, with_stats):
    c, t = _inputs(11, shape, shape[3])
    names = ("bias", "scale", "shift", "alpha")
    want = C_BLOCK(c["x"], c["kern"], *(c[a] for a in names),
                   with_stats=with_stats, interpret=True)
    got = fuc.upsample2_conv_block_fused(t["x"], t["kern"],
                                         *(t[a] for a in names),
                                         with_stats=with_stats)
    if not with_stats:
        got, want = (got,), (want,)
    for name, a, b in zip(("y", "s1", "s2"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("shape", SHAPES)
def test_row5_backward_matches_catgen(shape):
    c, t = _inputs(12, shape)
    want = C_BACKWARD(c["x"], c["kern"], c["gy"], interpret=True)
    got = fuc.upsample2_conv_backward(t["x"], t["kern"], t["gy"])
    for name, a, b in zip(("dx", "dweight", "dbias"), got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == BF16, name
        if name == "dweight":
            b = kernel_to_weight(f32(b))
        _close(a, b, name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", ["scalar", "channelwise"])
def test_row6_block_backward_matches_catgen(shape, alpha):
    c, t = _inputs(13, shape, 1 if alpha == "scalar" else shape[3])
    y = C_BLOCK(c["x"], c["kern"], c["bias"], c["scale"], c["shift"],
                c["alpha"], with_stats=False, interpret=True)
    # the transform's constants as f32 arrays of their bf16 values: the
    # same arithmetic, and catgen then leaves its f32 gradients unrounded
    tr = [c[a].astype(jnp.float32) for a in ("scale", "shift", "alpha")]
    want = C_BLOCK_BACKWARD(c["x"], *tr, c["kern"], y, c["gy"], c["gs1"],
                            c["gs2"], interpret=True)
    got = fuc.fused_block_backward(
        t["x"], t["scale"], t["shift"], t["alpha"], t["kern"],
        torch.tensor(f32(y)).bfloat16(), t["gy"], t["gs1"], t["gs2"])
    for name, a, b in zip(("dx", "dscale", "dshift", "dalpha", "dweight",
                           "dbias"), got, want):
        if name == "dweight":
            b = kernel_to_weight(f32(b))
        _close(a, b, name)
    assert got[0].dtype == got[4].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in (*got[1:4], got[5]))


def test_block_autograd_rounds_like_catgens_vjp():
    # the Function's cotangents are catgen's custom VJP's: the f32 sums
    # rounded to their inputs' dtype (bf16 here), dalpha summed for a
    # shared slope
    c, t = _inputs(14, SHAPES[0], 1)
    leaves = [t[a].clone().requires_grad_() for a in
              ("x", "scale", "shift", "alpha", "kern", "bias")]
    with tconfig.using(ladder_bwd="pallas"):
        y, s1, s2 = fuc.upsample2_conv_block(*leaves)
        (torch.sum(y.float() * t["gy"].float()) + torch.sum(s1 * t["gs1"])
         + torch.sum(s2 * t["gs2"])).backward()
    assert all(a.grad.dtype == torch.bfloat16 for a in leaves)
    assert leaves[3].grad.shape == (1,)
    # the same cotangents as the kernel's plain version, rounded once
    want = fuc.block_backward_plain(
        t["x"], t["scale"], t["shift"], t["alpha"], t["kern"], y.detach(),
        t["gy"], t["gs1"], t["gs2"])
    for leaf, w in zip(leaves, (want[0], want[1], want[2], want[3].sum(),
                                want[4], want[5])):
        assert torch.equal(leaf.grad, w.reshape(leaf.shape).bfloat16())


# ---------------------------------------------------------------------------
# row 7: D's fused prefix
# ---------------------------------------------------------------------------


def _st_inputs(seed, n=2, h=12, w=16, c=3, f=8, channelwise=True):
    rng = np.random.RandomState(seed)
    img = to_bf16(rng.rand(n, h, w, c).astype(np.float32))
    ang = rng.uniform(-0.5, 0.5, n)
    scale = rng.uniform(0.85, 1.15, n)
    cos, sin = np.cos(ang) * scale, np.sin(ang) * scale
    theta = np.stack([np.stack([cos, -sin, rng.uniform(-0.1, 0.1, n)], -1),
                      np.stack([sin, cos, rng.uniform(-0.1, 0.1, n)], -1)],
                     axis=1).astype(np.float32)
    kernel = (rng.randn(3, 3, c, f) * 0.2).astype(np.float32)
    # |bias| in [0.0625, 0.5): a shift of 2^-14 is below half its bf16 unit
    bias = (rng.choice([-1, 1], f) * rng.uniform(0.0625, 0.5, f)).astype(
        np.float32)
    alpha = (rng.rand(f if channelwise else 1) * 0.5 + 0.05).astype(
        np.float32)
    return img, theta, kernel, bias, alpha


@pytest.mark.parametrize("channelwise", [False, True],
                         ids=["shared", "channelwise"])
def test_row7_plain_and_vjp_match_catgen(channelwise):
    args = _st_inputs(20, channelwise=channelwise)
    jargs = [jnp.asarray(args[0], BF16)] + [jnp.asarray(a) for a in args[1:]]
    want = jax.jit(c_st_conv_prelu, static_argnums=5)(*jargs, True)
    assert want.dtype == BF16
    want_grads = jax.jit(jax.grad(
        lambda *a: jnp.sum(c_st_conv_prelu(*a, True).astype(jnp.float32)
                           ** 2), argnums=tuple(range(5))))(*jargs)
    ts = [torch.tensor(args[0]).bfloat16()] + [torch.tensor(a)
                                               for a in args[1:]]
    plain = st_conv.st_conv_prelu_plain(*ts)
    leaves = [a.clone().requires_grad_() for a in ts]
    out = st_conv.st_conv_prelu(*leaves)
    assert out.dtype == plain.dtype == torch.bfloat16
    assert torch.equal(out, plain)
    grads = torch.autograd.grad((out.float() ** 2).sum(), leaves)
    np.testing.assert_allclose(f32(out), f32(want), rtol=5e-2, atol=5e-2)
    for name, a, b in zip(("d_img", "d_theta", "d_kernel", "d_bias",
                           "d_alpha"), grads, want_grads):
        assert a.dtype == (torch.bfloat16 if name == "d_img"
                           else torch.float32), name
        scale = max(float(np.abs(f32(b)).max()), 1e-3)
        assert float(np.abs(f32(a) - f32(b)).max()) <= 5e-2 * scale, name


def test_row7_rounds_where_catgens_kernel_rounds():
    img, theta, kernel, bias, alpha = (torch.tensor(a) for a in
                                       _st_inputs(21))
    img = img.bfloat16()
    out, samp, z = st_conv._forward_plain(img, theta, kernel, bias, alpha)
    assert out.dtype == samp.dtype == z.dtype == torch.bfloat16
    # z is the f32 sum plus the f32 bias, rounded: a bias off the bf16
    # grid moves it (catgen does not round the bias here)
    shifted = bias + 2.0 ** -14
    z2 = st_conv._forward_plain(img, theta, kernel, shifted, alpha)[2]
    assert not torch.equal(z, z2)
    # the weights are rounded to bf16 in the forward; the backward's dS
    # takes the unrounded f32 kernel, as catgen's VJP
    rounded = kernel.bfloat16().float()
    assert not torch.equal(kernel, rounded)
    g = torch.ones_like(out)

    def grads(k):
        leaves = [img.clone().requires_grad_(), theta, k, bias, alpha]
        o = st_conv.st_conv_prelu(*leaves)
        return o, torch.autograd.grad(o, [leaves[0]], g)[0]

    (o1, d1), (o2, d2) = grads(kernel), grads(rounded)
    assert torch.equal(o1, o2)
    assert not torch.equal(d1, d2)
    leaves = [img, theta.clone().requires_grad_(),
              kernel.clone().requires_grad_(), bias.clone().requires_grad_(),
              alpha.clone().requires_grad_()]
    dth, dk, db, da = torch.autograd.grad(st_conv.st_conv_prelu(*leaves),
                                          leaves[1:], g)
    assert dth.dtype == dk.dtype == db.dtype == da.dtype == torch.float32


# ---------------------------------------------------------------------------
# the ladder, and one bf16 train step on each kernel route
# ---------------------------------------------------------------------------

SMALL = (16, 16, 2)
NOISE, BATCH = 8, 8


def _g_models():
    """A narrow ladder G (stage widths 6 -> 8 -> 6, k3 and k5) and a tiny
    D, in catgen and in the port."""
    cg = CFused([
        cnn.Dense(4 * 4 * 6), cnn.PReLU(), cnn.Reshape((4, 4, 6)),
        cnn.UpsampleConv(8, (3, 3)), cnn.BatchNorm(), cnn.PReLU(),
        cnn.UpsampleConv(6, (5, 5)), cnn.BatchNorm(), cnn.PReLU(),
        cnn.Conv(SMALL[2], (3, 3)), cnn.Sigmoid()], name="ladderG")
    cd = cnn.Sequential([
        cnn.Conv(4, (3, 3)), cnn.PReLU(), cnn.Flatten(), cnn.Dense(1),
        cnn.Sigmoid()], name="tinyD")
    h, w, c = SMALL
    tg = FusedDecoderSequential([
        tl.Dense(NOISE, 4 * 4 * 6), tl.PReLU(), tl.Reshape((4, 4, 6)),
        UpsampleConv(6, 8, (3, 3)), tl.BatchNorm(8), tl.PReLU(),
        UpsampleConv(8, 6, (5, 5)), tl.BatchNorm(6), tl.PReLU(),
        tl.Conv(6, c, (3, 3)), tl.Sigmoid()], name="ladderG")
    td = TSequential([
        tl.Conv(c, 4, (3, 3)), tl.PReLU(), tl.Flatten(),
        tl.Dense(h * w * 4, 1), tl.Sigmoid()], name="tinyD")
    return cg, cd, tg, td


def _d_prefix_models():
    """A tiny dense G and a D that opens with D32_st3's prefix [rotation
    ST -> conv3x3 -> PReLU], in catgen and in the port."""
    h, w, c = SMALL
    cg = cnn.Sequential([cnn.Dense(h * w * c), cnn.Sigmoid(),
                         cnn.Reshape(SMALL)], name="tinyG")
    cd = cnn.Sequential([
        CFusedST(cnn.SpatialTransformer(True, False, False),
                 cnn.Conv(6, (3, 3)), cnn.PReLU()),
        cnn.Flatten(), cnn.Dense(1), cnn.Sigmoid()], name="tinyD")
    tg = TSequential([tl.Dense(NOISE, h * w * c), tl.Sigmoid(),
                      tl.Reshape(SMALL)], name="tinyG")
    td = TSequential([
        tst.FusedSTConvPReLU(tst.SpatialTransformer(SMALL, True, False,
                                                    False),
                             tl.Conv(c, 6, (3, 3)), tl.PReLU()),
        tl.Flatten(), tl.Dense(h * w * 6, 1), tl.Sigmoid()], name="tinyD")
    return cg, cd, tg, td


def _load(c_module, t_module, seed):
    """catgen's init of the G c_module, perturbed, loaded into t_module:
    returns the catgen variables."""
    v = np_tree(c_module.init(jax.random.PRNGKey(seed), (1, NOISE)))
    perturb(v, np.random.RandomState(seed), gain=1.0)
    t_module.load_state_dict(catgen_to_state_dict(v["params"], v["state"]))
    return v


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_ladder_matches_catgen(catgen_route, train):
    catgen_route(**LADDER)
    cg, _, tg, _ = _g_models()
    gv = _load(cg, tg, 30)
    z = to_bf16(np.random.RandomState(31).uniform(
        -1, 1, (4, NOISE)).astype(np.float32))
    want, new_state = jax.jit(lambda v, x: cg.apply(v, x, train=train))(
        gv, jnp.asarray(z, BF16))
    assert want.dtype == BF16
    fuc.reset_launches()
    with tconfig.using(**LADDER), torch.no_grad():
        got = tg.train(train)(torch.tensor(z).bfloat16())
    assert got.dtype == torch.bfloat16
    assert sum(fuc.launches().values()) == 0     # CPU: the plain versions
    assert_bf16_close(got, want, 0, 2.0 ** -6, "ladder")
    want_state = catgen_to_state_dict({}, np_tree(new_state))
    for k, v in want_state.items():
        np.testing.assert_allclose(tg.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-2, atol=1e-4, err_msg=k)


ROUTES = {"ladder": (LADDER, {}),
          "per_layer_pallas": (PER_LAYER, {}),
          "per_layer_hybrid": (dict(PER_LAYER, upsample_bwd="hybrid"), {}),
          "fused_prefix": ({}, dict(st_conv_impl="fused"))}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bf16_train_step_matches_catgen(catgen_route, monkeypatch, route):
    up, st = ROUTES[route]
    catgen_route(**up)
    if st:
        from catgen.kernels import config as kconfig
        monkeypatch.setattr(kconfig, "st_conv_impl", "fused")
        monkeypatch.setattr(kconfig, "st_conv_interpret", True)
    cg, cd, tg, td = _d_prefix_models() if st else _g_models()
    config = dict(batch_size=BATCH, noise_dim=NOISE, acc_window=3,
                  g_optimizer="sgd")
    c_config = cgan.GanConfig(**config, compute_dtype=BF16)
    t_config = tgan.GanConfig(**config, compute_dtype=torch.bfloat16)
    state = cgan.init_state(cg, cd, c_config, jax.random.PRNGKey(0), SMALL)
    gv = np_tree({"params": state.g_params, "state": state.g_state})
    dv = np_tree({"params": state.d_params, "state": state.d_state})
    rng = np.random.RandomState(1)
    perturb(gv, rng, gain=1.0)
    perturb(dv, rng, gain=1.0)
    c_state = state._replace(g_params=gv["params"], g_state=gv["state"],
                             d_params=dv["params"], d_state=dv["state"])
    tg.load_state_dict(catgen_to_state_dict(gv["params"], gv["state"]))
    td.load_state_dict(catgen_to_state_dict(dv["params"], dv["state"]))
    t_state = tgan.init_state(tg, td, t_config)
    reals = np.random.RandomState(2).rand(BATCH // 2, *SMALL).astype(
        np.float32)

    draws, c_grads, t_grads = [], [], []
    with traced_with_callbacks(draws, c_grads):
        _, cm = run_traced(jax.jit(cgan.make_train_step(cg, cd, c_config)),
                           c_state, jnp.asarray(reals),
                           jax.random.PRNGKey(3))
    fuc.reset_launches()
    before = (st_conv.LAUNCHES, st_conv.BF16_LAUNCHES)
    replay = replayed(draws)
    with tconfig.using(**up, **st), \
            capture_grads(topt, t_grads, port_grads_to_numpy):
        tm = tgan.make_train_step(tg, td, t_config)(
            t_state, torch.tensor(reals), replay)
    assert not replay.records, "catgen drew more than the port"
    # CPU tensors take the plain versions: no kernel was launched
    assert sum(fuc.launches().values()) == 0
    assert (st_conv.LAUNCHES, st_conv.BF16_LAUNCHES) == before
    for name in ("loss_d", "loss_g", "acc_d"):
        np.testing.assert_allclose(float(getattr(tm, name)),
                                   float(getattr(cm, name)),
                                   rtol=STEP_RTOL, err_msg=name)
    assert len(c_grads) == len(t_grads) == 2
    assert_bf16_grads_close(t_grads[0], c_grads[0])
    assert_bf16_grads_close(t_grads[1], c_grads[1], bn_fed_biases(tg))
    for p in list(tg.parameters()) + list(td.parameters()):
        assert p.dtype == torch.float32


# ---------------------------------------------------------------------------
# a CUDA tensor on each route without the kernels: it raises, and nothing
# falls back to the plain version or to f32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bf16_cuda_tensors_without_the_kernels_raise(monkeypatch, route):
    # "meta" tensors stand in for CUDA ones (is_cuda patched): shapes and
    # dtypes but no data, so a fallback to a plain version would return a
    # meta tensor instead of raising
    def missing():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True))
    monkeypatch.setattr(fuc, "load_library", missing)
    monkeypatch.setattr(st_conv, "load_library", missing)
    up, st = ROUTES[route]
    _, _, tg, td = _d_prefix_models() if st else _g_models()
    model, shape = (td, (2,) + SMALL) if st else (tg, (2, NOISE))
    model.to("meta").train()
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    fuc.reset_launches()
    before = (st_conv.LAUNCHES, st_conv.BF16_LAUNCHES)
    with tconfig.using(**up, **st), \
            pytest.raises(RuntimeError, match="no kernel library"):
        model(x)
    assert sum(fuc.launches().values()) == 0
    assert (st_conv.LAUNCHES, st_conv.BF16_LAUNCHES) == before
