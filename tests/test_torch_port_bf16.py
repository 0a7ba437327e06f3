"""The port's bf16 compute path (``GanConfig.compute_dtype=torch.bfloat16``,
``VConfig.compute_dtype``) against catgen's bf16 path on the CPU, with the
same numpy inputs and catgen's draws replayed: each place catgen rounds to
bf16 (the layers' casts, the grids, the sampler), G32up-c and D32_st3,
one GAN step and a 5-step loss trajectory, one V step, the noise's range
and the checkpoint's metadata.

Both sides keep parameters, optimizer states and BatchNorm statistics in
f32 and round activations to bf16 at the same places; they differ where
the two frameworks sum in another order before rounding (a dot product,
a convolution, a mean) and where catgen's XLA sampler rounds every lerp
to bf16 while the port's (v4's arithmetic) rounds once. Tolerances, in
units of the bf16 spacing at the catgen value (``ulps``) plus a share of
the largest catgen value (``floor``), stated per comparison:

  * elementwise layers (PReLU, LeakyReLU with its slope rounded to bf16,
    the dropouts with 1/keep rounded to bf16, BatchNorm's affine): bit for
    bit;
  * Dense, Conv, the collapsed upsample-conv, BatchNorm in training (f32
    statistics summed in another order): 1 ulp + 2^-8 of the largest;
  * the sampler, plain bf16 version against catgen's v4 kernel in
    interpret mode: v4's own tolerance (rtol 2e-2, atol 1e-2,
    tests/test_torch_port_bilinear.py); against catgen's XLA sampler in
    bf16, which also rounds the pixel coordinate to bf16 (v4 and the port
    compute it in f32 from the bf16 normalized coordinate; ROADMAP Queue
    C): 2^-3 pixel times the image's range, plus 4 x 2^-8;
  * G32up-c and D32_st3 at full width, batch 2: 2^-6 of the largest
    output (a dozen layers of one-ulp differences);
  * the GAN and V steps: losses rtol 2e-2; gradients per leaf within 0.1
    of the leaf's largest plus 0.05 of the update's largest (the spatial
    transformers' localization nets learn only through d_coords, sums of
    bf16 values that cancel: their leaves differ by up to 0.33 of
    themselves and 0.06 of the largest on a step at this size); a gradient
    that is zero in exact arithmetic (a bias in front of a BatchNorm) is
    a sum of thousands of bf16 cotangents, rounding noise on both sides
    (catgen's reaches 0.23 of the largest in V16 at batch 8), within 0.5
    of the largest;
    parameters as the f32 tests' Adam check with those gradient bounds;
    the 5-step trajectory's losses rtol 5e-2.

The layers run catgen eagerly, one operation at a time, as written; the
models and steps run catgen compiled (``jax.jit``, as it trains), on its
accelerator route for the samplers (the v4 kernel, in interpret mode),
with its draws and gradients taken out through ordered debug callbacks.
"""

import contextlib
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from catgen import nn as cnn
from catgen import optim as copt
from catgen.io import checkpoint as cckpt
from catgen.kernels.pallas_bilinear_v4 import \
    bilinear_sample_rows as v4_sample_rows
from catgen.nn.spatial_transformer import bilinear_sample as jax_sample
from catgen.train import gan as cgan
from catgen.train import v_trainer as cvt
from catgen_torch import optim as topt
from catgen_torch.cli import train as train_cli
from catgen_torch.core.module import Sequential as TSequential
from catgen_torch.core.random import Draws
from catgen_torch.io import checkpoint as tckpt
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.kernels import bilinear
from catgen_torch.kernels.upsample_conv import UpsampleConv
from catgen_torch.nn import layers as tl
from catgen_torch.nn.spatial_transformer import SpatialTransformer
from catgen_torch.train import gan as tgan
from catgen_torch.train import v_trainer as tvt

from test_torch_port_train import Pair, catgen_models, _reals
from test_torch_port_v import catgen_v, port_v
from torch_port_helpers import (IMG, NOISE_DIM, ReplayDraws,
                                assert_adam_step_close, assert_grads_close,
                                bn_fed_biases, capture_grads,
                                catgen_grads_to_port, catgen_pair, np_tree,
                                port_grads_to_numpy, port_pair,
                                record_jax_draws)

BF16 = jnp.bfloat16


def to_bf16(a):
    """numpy f32 -> the f32 values of its bf16 rounding (what both sides
    are handed)."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(BF16)
                      .astype(jnp.float32))


def f32(x):
    """A catgen array or port tensor as numpy f32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_bf16_close(got, want, ulps, floor, what=""):
    """|got - want| <= ulps x the bf16 spacing at want + floor x max|want|
    (ulps = floor = 0: bit for bit)."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    mag = np.maximum(np.abs(want), 2.0 ** -126)
    spacing = np.exp2(np.floor(np.log2(mag)) - 7)
    bound = ulps * spacing + floor * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= bound).all(), (
        f"{what}: {(err > bound).sum()} of {err.size} beyond the bound, "
        f"worst {(err - bound).max():.3e} over it")


@pytest.fixture
def catgen_v4(monkeypatch):
    """catgen's samplers on its accelerator route (CATGEN_SAMPLER_IMPL=mxu,
    the v4 kernel), in interpret mode on the CPU."""
    from catgen.kernels import config as kconfig
    from catgen.kernels import pallas_bilinear_v4 as v4

    kernel = v4.bilinear_sample_rows
    monkeypatch.setattr(kconfig, "sampler_impl", "mxu")
    monkeypatch.setattr(kconfig, "sampler_kernel", "v4")
    monkeypatch.setattr(v4, "bilinear_sample_rows",
                        lambda img, rows, out_hw, interpret=False:
                        kernel(img, rows, out_hw, True))


@contextlib.contextmanager
def traced_with_callbacks(draws: list, grads: list):
    """While a catgen function is traced for ``jax.jit``: every
    ``jax.random`` draw, and the gradients handed to the optimizer (as
    {port name: numpy}), are appended to ``draws`` and ``grads`` when the
    compiled function runs, in program order (ordered debug callbacks);
    the caller empties the lists between runs."""
    real = {k: getattr(jax.random, k)
            for k in ("uniform", "bernoulli", "normal", "randint")}
    clamp = copt.clamp_and_penalize

    def wrap(kind):
        def draw(*args, **kwargs):
            out = real[kind](*args, **kwargs)
            jax.debug.callback(
                lambda v: draws.append((kind, np.asarray(v))), out,
                ordered=True)
            return out
        return draw

    def spy(g, *args, **kwargs):
        jax.debug.callback(lambda t: grads.append(catgen_grads_to_port(t)),
                           g, ordered=True)
        return clamp(g, *args, **kwargs)

    with mock.patch.multiple(jax.random, **{k: wrap(k) for k in real}), \
            mock.patch.object(copt, "clamp_and_penalize", spy):
        yield


def run_traced(fn, *args):
    """``fn(*args)`` with its pending callbacks delivered."""
    out = fn(*args)
    jax.block_until_ready(out)
    jax.effects_barrier()
    return out


def replayed(records):
    """catgen's recorded draws as the port takes them: bf16 arrays as the
    f32 values they hold (torch does not read ml_dtypes' bfloat16)."""
    return ReplayDraws([(k, a.astype(np.float32) if a.dtype == BF16 else a)
                        for k, a in records])


# ---------------------------------------------------------------------------
# the layers' cast sites, one layer at a time
# ---------------------------------------------------------------------------

# name: (catgen layer, port layer, input shape, train, ulps, floor)
LAYERS = {
    "dense": (lambda: cnn.Dense(16), lambda: tl.Dense(24, 16), (4, 24),
              False, 1, 2.0 ** -8),
    "conv": (lambda: cnn.Conv(8, (3, 3)), lambda: tl.Conv(5, 8, (3, 3)),
             (2, 6, 6, 5), False, 1, 2.0 ** -8),
    "upsample_conv": (lambda: cnn.UpsampleConv(6, (3, 3)),
                      lambda: UpsampleConv(5, 6, (3, 3)), (2, 3, 4, 5),
                      False, 1, 2.0 ** -8),
    "batchnorm_eval": (lambda: cnn.BatchNorm(), lambda: tl.BatchNorm(8),
                       (4, 3, 3, 8), False, 0, 0.0),
    "batchnorm_train": (lambda: cnn.BatchNorm(), lambda: tl.BatchNorm(8),
                        (4, 3, 3, 8), True, 1, 2.0 ** -8),
    "prelu": (lambda: cnn.PReLU(), tl.PReLU, (4, 3, 3, 8), False, 0, 0.0),
    "leaky_relu": (lambda: cnn.LeakyReLU(), tl.LeakyReLU, (4, 3, 3, 8),
                   False, 0, 0.0),
    "dropout": (lambda: cnn.Dropout(0.2), lambda: tl.Dropout(0.2),
                (4, 3, 3, 8), True, 0, 0.0),
    "spatial_dropout": (lambda: cnn.SpatialDropout(0.3),
                        lambda: tl.SpatialDropout(0.3), (4, 3, 3, 8), True,
                        0, 0.0),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_casts_match_catgen(name):
    make_c, make_t, shape, train, ulps, floor = LAYERS[name]
    rng = np.random.RandomState(3)
    c_seq = cnn.Sequential([make_c()], name="one")
    variables = np_tree(c_seq.init(jax.random.PRNGKey(0), shape))
    for leaf in ("mean", "var", "alpha"):    # off their init values
        for tree in (variables["params"], variables["state"]):
            for sub in tree.values():
                if leaf in sub:
                    sub[leaf] = (rng.uniform(0.5, 2.0, sub[leaf].shape)
                                 if leaf == "var" else rng.normal(
                                     0.0, 0.3, sub[leaf].shape)
                                 ).astype(np.float32)
    x = to_bf16(rng.normal(0.0, 1.0, shape).astype(np.float32))
    with record_jax_draws() as draws:
        want, c_state = c_seq.apply(variables, jnp.asarray(x, BF16),
                                    train=train, rng=jax.random.PRNGKey(1))
    assert want.dtype == BF16
    t_seq = TSequential([make_t()], name="one")
    t_seq.load_state_dict(catgen_to_state_dict(variables["params"],
                                               variables["state"]))
    tl.set_draws(t_seq, replayed(draws))
    t_seq.train(train)
    got = t_seq(torch.tensor(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want, ulps, floor, name)
    if name == "batchnorm_train":   # the f32 running statistics
        st = np_tree(c_state)["00_BatchNorm"]
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                t_seq.state_dict()[f"00_BatchNorm.{k}"].numpy(), st[k],
                rtol=1e-5, atol=1e-6)


def test_constants_round_to_bf16_as_catgens_weak_types():
    # 1/3 and 1/0.8 differ from their bf16 roundings: an f32 constant would
    # move some products by one bf16 unit
    x = torch.tensor(to_bf16(np.linspace(-4, 0, 4097, dtype=np.float32)))
    xb = x.bfloat16()
    want = f32(jnp.asarray(f32(xb), BF16) * (1.0 / 3.0))
    assert_bf16_close(tl.LeakyReLU()(xb), np.where(f32(xb) >= 0, f32(xb),
                                                   want), 0, 0.0)
    assert not torch.equal((xb * (1.0 / 3.0)).float(), torch.tensor(want))


def test_spatial_transformer_rounds_its_grid_to_bf16():
    # catgen's transformer: the head in bf16, theta in f32, the coordinate
    # rows rounded to bf16, then the v4 kernel (in interpret mode here).
    # The port's rows are catgen's within one bf16 unit plus 2^-8 of the
    # largest (catgen compiled keeps some of the head's sums in f32); its
    # output is the plain sampler's at its rows, and that sampler at
    # catgen's rows is within v4's tolerance of catgen's output.
    # (catgen's CPU route, XLA's gathers, also computes the pixel
    # coordinate in bf16: ROADMAP Queue C.)
    from catgen.core.module import child_variables
    from catgen.nn.spatial_transformer import (affine_grid_rows,
                                               affine_matrix)

    shape = (2, 16, 16, 4)
    c_st = cnn.SpatialTransformer(True, True, True)
    variables = np_tree(c_st.init(jax.random.PRNGKey(2), shape))
    rng = np.random.RandomState(4)
    head = variables["params"]["head"]
    head["kernel"] = rng.normal(0, 0.05, head["kernel"].shape).astype(
        np.float32)
    head["bias"] = (head["bias"] + rng.normal(0, 0.2, head["bias"].shape)
                    ).astype(np.float32)
    x = to_bf16(rng.rand(*shape).astype(np.float32))

    @jax.jit
    def catgen_st(variables, x):
        feats, _ = c_st.loc.apply(child_variables(variables, "loc"), x)
        params, _ = c_st.head.apply(child_variables(variables, "head"),
                                    feats)
        theta = affine_matrix(params.astype(jnp.float32), *c_st.flags)
        rows = affine_grid_rows(theta, 16, 16).astype(BF16)
        return rows, v4_sample_rows(x, rows, (16, 16), True)

    rows, want = catgen_st(variables, jnp.asarray(x, BF16))

    t_st = SpatialTransformer(shape[1:], True, True, True)
    t_st.load_state_dict(catgen_to_state_dict(variables["params"],
                                              variables["state"]))
    xt = torch.tensor(x).bfloat16()
    t_rows = bilinear.affine_grid_rows(t_st.eval().theta(xt), 16,
                                       16).bfloat16()
    assert_bf16_close(t_rows, rows, 1, 2.0 ** -8, "rows")
    got = t_st(xt)
    assert torch.equal(got, bilinear.bilinear_sample_rows_plain(
        xt, t_rows, (16, 16)).reshape(got.shape))
    at_catgens = bilinear.bilinear_sample_rows_plain(
        xt, torch.tensor(f32(rows)).bfloat16(), (16, 16))
    np.testing.assert_allclose(f32(at_catgens), f32(want), rtol=2e-2,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# the sampler's bf16 plain version (the bf16 kernels' arithmetic)
# ---------------------------------------------------------------------------

SAMPLER_SHAPES = [(2, 32, 32, 3, 32, 32), (2, 16, 16, 64, 48, 16)]
# how far catgen's XLA sampler in bf16 may sample from the port's point, in
# pixels (its bf16 pixel coordinate, see below), times the image's range,
# plus four roundings of a value below 1 (its three lerps, the port's one)
XLA_PIXEL = 2.0 ** -3


def _sampler_inputs(shape, seed):
    n, h, w, c, ho, wo = shape
    rng = np.random.RandomState(seed)
    img = to_bf16(rng.rand(n, h, w, c).astype(np.float32))
    rows = to_bf16(rng.uniform(-1.2, 1.2, (n, 2, ho * wo)).astype(
        np.float32))
    g = to_bf16(rng.uniform(-1, 1, (n, ho, wo, c)).astype(np.float32))
    return img, rows, g


def _grid(rows, ho, wo):
    return rows.transpose(0, 2, 1).reshape(rows.shape[0], ho, wo, 2)


@pytest.mark.parametrize("shape", SAMPLER_SHAPES)
def test_plain_bf16_sampler_matches_catgens_v4_and_xla(shape):
    n, h, w, c, ho, wo = shape
    img, rows, g = _sampler_inputs(shape, seed=5)
    t_img = torch.tensor(img).bfloat16().requires_grad_(True)
    t_rows = torch.tensor(rows).bfloat16().requires_grad_(True)
    got = bilinear.bilinear_sample_rows(t_img, t_rows, (ho, wo))
    assert got.dtype == torch.bfloat16
    got.backward(torch.tensor(g).bfloat16())
    assert t_img.grad.dtype == t_rows.grad.dtype == torch.bfloat16
    # v4 in interpret mode: forward and both gradients, v4's tolerance
    ci, cr = jnp.asarray(img, BF16), jnp.asarray(rows, BF16)

    @jax.jit
    def v4_and_vjp(a, b, cot):
        out, vjp = jax.vjp(
            lambda a, b: v4_sample_rows(a, b, (ho, wo), True), a, b)
        return (out, *vjp(cot))

    out, d_img, d_rows = v4_and_vjp(ci, cr, jnp.asarray(g, BF16))
    assert out.dtype == d_img.dtype == d_rows.dtype == BF16
    for mine, theirs in ((got, out), (t_img.grad, d_img),
                         (t_rows.grad, d_rows)):
        np.testing.assert_allclose(f32(mine), f32(theirs), rtol=2e-2,
                                   atol=1e-2 * max(1.0, float(
                                       np.abs(f32(theirs)).max())))
    # catgen's XLA sampler in bf16 (its CPU route) also rounds the pixel
    # coordinate: (c + 1) to 2^-7, then (c + 1) * 0.5 * (h - 1) to 8
    # significant bits, so it samples up to 2^-3 pixel away at 32 px
    want = jax_sample(ci, jnp.asarray(_grid(rows, ho, wo), BF16))
    np.testing.assert_allclose(f32(got), f32(want), rtol=0,
                               atol=XLA_PIXEL * np.ptp(img) + 4 * 2.0 ** -8)


def test_plain_bf16_sampler_is_the_f32_plain_rounded_once():
    shape = SAMPLER_SHAPES[1]
    img, rows, g = _sampler_inputs(shape, seed=6)
    out_hw = shape[4:]
    bf = [torch.tensor(a).bfloat16() for a in (img, rows, g)]
    fl = [torch.tensor(a) for a in (img, rows, g)]
    assert torch.equal(
        bilinear.bilinear_sample_rows_plain(*bf[:2], out_hw),
        bilinear.bilinear_sample_rows_plain(*fl[:2], out_hw).bfloat16())
    for got, want in zip(
            bilinear.bilinear_sample_rows_backward_plain(*bf, out_hw),
            bilinear.bilinear_sample_rows_backward_plain(*fl, out_hw)):
        assert torch.equal(got, want.bfloat16())


# ---------------------------------------------------------------------------
# the flagship pair at full width, and the steps
# ---------------------------------------------------------------------------


def test_g32up_c_and_d32_st3_bf16_forwards_match_catgen(catgen_v4):
    g, d, gv, dv = catgen_pair(seed=0)
    tg, td = port_pair(gv, dv)
    rng = np.random.RandomState(1)
    noise = to_bf16(rng.uniform(-1, 1, (2, NOISE_DIM)).astype(np.float32))
    images = jax.jit(lambda v, x: g.apply(v, x, train=False)[0])(
        gv, jnp.asarray(noise, BF16))
    assert images.dtype == BF16
    with torch.inference_mode():
        got = tg(torch.tensor(noise).bfloat16())
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, images, 0, 2.0 ** -6, "G32up-c")
    d_in = np.concatenate([f32(images)[:1],
                           to_bf16(rng.rand(1, *IMG).astype(np.float32))])
    scores = jax.jit(lambda v, x: d.apply(v, x, train=False)[0])(
        dv, jnp.asarray(d_in, BF16))
    with torch.inference_mode():
        got = td(torch.tensor(d_in).bfloat16())
    assert abs(float(f32(scores)[0, 0] - f32(scores)[1, 0])) > 1e-2
    assert_bf16_close(got, scores, 0, 2.0 ** -6, "D32_st3")


class Bf16Pair(Pair):
    """test_torch_port_train's Pair with both steps in bf16, catgen's
    compiled: its draws and gradients come out through callbacks."""

    def __init__(self, **config):
        super().__init__(**config)
        self.draws, self.grads = [], []
        cg, cd = catgen_models()
        c_config = self.c_config.__class__(
            **{**self.c_config.__dict__, "compute_dtype": BF16})
        self.c_step = jax.jit(cgan.make_train_step(cg, cd, c_config))
        self.t_config = self.t_config.__class__(
            **{**self.t_config.__dict__, "compute_dtype": torch.bfloat16})
        self.t_step = tgan.make_train_step(self.t_state.g, self.t_state.d,
                                           self.t_config)

    def step(self, reals, seed):
        del self.draws[:], self.grads[:]
        with traced_with_callbacks(self.draws, self.grads):
            self.c_state, cm = run_traced(
                self.c_step, self.c_state, jnp.asarray(reals),
                jax.random.PRNGKey(seed))
        assert self.draws[0][1].dtype == BF16      # catgen's bf16 noise
        replay, t_grads = replayed(self.draws), []
        with capture_grads(topt, t_grads, port_grads_to_numpy):
            tm = self.t_step(self.t_state, torch.tensor(reals), replay)
        assert not replay.records, "catgen drew more than the port"
        return cm, tm, list(self.grads), t_grads


STEP_RTOL, GRAD_REL, GRAD_FLOOR, TRAJ_RTOL = 2e-2, 0.1, 0.05, 5e-2
BF16_ZERO = 0.5


def assert_bf16_grads_close(port, catgen, zero=()):
    """The bf16 gradient bounds above; ``zero``: leaves that are rounding
    noise on both sides."""
    top = max(np.abs(v).max() for v in catgen.values())
    for k in zero:
        for side, g in (("port", port[k]), ("catgen", catgen[k])):
            assert np.abs(g).max() <= BF16_ZERO * top, (k, side)
    rest = set(catgen) - set(zero)
    assert_grads_close({k: port[k] for k in rest},
                       {k: catgen[k] for k in rest}, rel=GRAD_REL,
                       floor=GRAD_FLOOR * top / max(
                           np.abs(catgen[k]).max() for k in rest))


@pytest.mark.parametrize("augment", [False, True])
def test_bf16_step_matches_catgen(catgen_v4, augment):
    pair = Bf16Pair(augment=augment)
    before = {k: v.numpy().copy() for k, v in
              pair.t_state.d.state_dict().items()}
    cm, tm, c_grads, t_grads = pair.step(_reals(4, 10), seed=20)
    for name in ("loss_d", "loss_g", "acc_d"):
        np.testing.assert_allclose(float(getattr(tm, name)),
                                   float(getattr(cm, name)),
                                   rtol=STEP_RTOL, err_msg=name)
    assert float(tm.tp_real + tm.tn_fake + tm.fp + tm.fn) == 8
    assert len(c_grads) == len(t_grads) == 2
    zero = bn_fed_biases(pair.t_state.g, "")
    assert zero == {"00_Dense.bias"}
    assert_bf16_grads_close(t_grads[0], c_grads[0])
    assert_bf16_grads_close(t_grads[1], c_grads[1], zero)
    want = catgen_to_state_dict(np_tree(pair.c_state.d_params),
                                np_tree(pair.c_state.d_state))
    assert_adam_step_close(
        {k: v.numpy() for k, v in pair.t_state.d.state_dict().items()},
        {k: v.numpy() for k, v in want.items()}, c_grads[0],
        {k: before[k] for k in c_grads[0]},
        (pair.c_config.d_l1, pair.c_config.d_l2, pair.c_config.d_clamp),
        atol=2e-4, rel=GRAD_REL, floor=GRAD_FLOOR)
    for p in pair.t_state.g.parameters():   # parameters stay f32
        assert p.dtype == torch.float32


def test_bf16_loss_trajectory_matches_catgen(catgen_v4):
    pair = Bf16Pair(augment=True)
    losses = []
    for i in range(5):
        cm, tm, _, _ = pair.step(_reals(4, 30 + i), seed=40 + i)
        losses.append([(float(cm.loss_d), float(tm.loss_d)),
                       (float(cm.loss_g), float(tm.loss_g))])
    want, got = np.array(losses)[..., 0], np.array(losses)[..., 1]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert pair.t_state.step == 5


def test_bf16_v_step_matches_catgen():
    shape, config = (16, 16, 3), dict(batch_size=8)
    cv, variables = catgen_v("v16", shape, seed=1)
    c_config = cvt.VConfig(**config, compute_dtype=BF16)
    state = cvt.init_state(cv, c_config, jax.random.PRNGKey(0), shape)
    state = state._replace(params=variables["params"],
                           state=variables["state"])
    tv = port_v("v16", shape, variables)
    t_config = tvt.VConfig(**config, compute_dtype=torch.bfloat16)
    t_state = tvt.init_state(tv, t_config)
    rng = np.random.RandomState(8)
    reals, fakes = (rng.rand(4, *shape).astype(np.float32) for _ in "rf")
    draws, c_grads, t_grads = [], [], []
    with traced_with_callbacks(draws, c_grads):
        _, cm = run_traced(jax.jit(cvt.make_train_step(cv, c_config)),
                           state, jnp.asarray(reals), jnp.asarray(fakes),
                           jax.random.PRNGKey(4))
    with capture_grads(topt, t_grads, port_grads_to_numpy):
        tm = tvt.make_train_step(tv, t_config)(
            t_state, torch.tensor(reals), torch.tensor(fakes),
            replayed(draws))
    np.testing.assert_allclose(float(tm.loss), float(cm.loss),
                               rtol=STEP_RTOL)
    assert_bf16_grads_close(t_grads[0], c_grads[0], bn_fed_biases(tv))


# ---------------------------------------------------------------------------
# the noise, the CLI's checkpoint
# ---------------------------------------------------------------------------


def test_bf16_noise_lies_on_catgens_grid_in_minus_one_to_one():
    noise = tgan.draw_noise(Draws(torch.Generator().manual_seed(0)),
                            (4096, 100), torch.bfloat16)
    assert noise.dtype == torch.bfloat16
    v = noise.float()
    assert float(v.min()) >= -1.0 and float(v.max()) < 1.0
    catgen = f32(jax.random.uniform(jax.random.PRNGKey(0), (4096, 100), BF16,
                                    -1.0, 1.0))
    assert set(np.unique(v.numpy())) == set(np.unique(catgen))
    assert len(np.unique(catgen)) == 128         # k/64 - 1, k < 128
    # catgen's own draws, replayed, are kept as they are
    replay = ReplayDraws([("uniform", catgen)])
    assert np.array_equal(
        tgan.draw_noise(replay, catgen.shape, torch.bfloat16).float(),
        catgen)


def test_bf16_cli_checkpoint_has_no_compute_dtype_and_catgen_reads_it(
        tmp_path):
    harness = train_cli.main(["--device", "cpu", "--fixture", "16",
                              "--batchSize", "4", "--N_epoch", "8",
                              "--epochs", "1", "--dtype", "bf16",
                              "--save", str(tmp_path)])
    assert harness.gc.compute_dtype == torch.bfloat16
    path = str(tmp_path / "adversarial.ckpt")
    meta = tckpt.load_meta(path)
    assert "compute_dtype" not in meta["gan_config"]
    assert meta["gan_config"]["bce"] is None
    g, d = catgen_pair(seed=0)[:2]
    template = cgan.ckpt_template(
        g, d, cgan.GanConfig(acc_window=20, compute_dtype=BF16),
        jax.random.PRNGKey(0), IMG)
    state, c_meta = cckpt.load(path, template)
    assert int(state.step) == harness.state.step == 4
    np.testing.assert_array_equal(
        np.asarray(state.g_params["12_Conv"]["bias"]),
        harness.state.g.state_dict()["12_Conv.bias"].numpy())
