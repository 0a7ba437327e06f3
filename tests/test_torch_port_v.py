"""The port's V subsystem against catgen's on the CPU: the overlay bank,
the masks and the four synthetic-fake generators
(catgen_torch/train/synthetic.py), the dispatchers, V16 and V32 at full
width, one V train step (catgen_torch/train/v_trainer.py) and V's
ratings.

catgen runs eagerly where it draws; every draw it makes (the generators'
integers, uniforms and bits, the dropout masks) is recorded and handed to
the port in catgen's order (``ReplayDraws``). The branch choices come from
the same host ``RandomState`` on both sides.

Tolerances, f32 on both sides: the bank bit for bit; masks and generated
images 1e-5 absolute (the blur's sums and the warp's lerps in another
order); V's outputs 1e-5 absolute; the V step as
tests/test_torch_port_train.py holds the GAN step: loss and accuracy rtol
1e-5, confusion counts exact, gradients per leaf within 1e-4 of the
leaf's largest, parameters and BatchNorm statistics after the step atol
2e-5. Two things the GAN parity tests' small models do not show follow
from V's width: the biases in front of a BatchNorm have an exactly zero
gradient, which f32 sums leave at up to ~3e-6 of the step's largest
gradient on either side (both are held to 1e-5 of it); and Adam's first
step moves each weight by about lr*sign(g), so where catgen's penalized
gradient is within the gradient tolerance of zero, rounding may move a
weight the other way, by up to 2*lr (``assert_adam_step_close``).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import models as cmodels
from catgen import optim as copt
from catgen.train import synthetic as csyn
from catgen.train import v_trainer as cvt
from catgen_torch import models as tmodels
from catgen_torch import optim as topt
from catgen_torch.core.random import Draws
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.train import synthetic as tsyn
from catgen_torch.train import v_trainer as tvt

from torch_port_helpers import (IMG, ReplayDraws, assert_adam_step_close,
                                assert_grads_close, bn_fed_biases,
                                capture_grads, catgen_grads_to_port, np_tree,
                                perturb, port_grads_to_numpy,
                                record_jax_draws)

ATOL = 1e-5
SMALL = (16, 16, 3)


@pytest.fixture(scope="module")
def bank():
    """catgen's test-size bank (tests/test_v_subsystem.py), 32 px."""
    return np.asarray(csyn.build_overlay_bank(32, 32, n=8, n_points=500,
                                              seed=0))


def _reals(n, seed, shape=IMG):
    r = np.random.RandomState(seed)
    return (r.rand(n, *shape) * 0.8 + 0.1).astype(np.float32)


def _replayed(fn_catgen, fn_port):
    """catgen's result (drawing under record) and the port's (replaying
    those draws), as numpy."""
    with record_jax_draws() as draws:
        want = np.asarray(fn_catgen())
    replay = ReplayDraws(draws)
    got = fn_port(replay).numpy()
    assert not replay.records, "catgen drew more than the port"
    return got, want


def _assert_images(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got.min() >= -1e-6 and got.max() <= 1.0 + 1e-6


# ---------------------------------------------------------------------------
# bank and masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,n,n_points,seed", [
    (16, 16, 8, 500, 0), (32, 32, 8, 500, 1), (20, 12, 5, 300, 7)])
def test_overlay_bank_equals_catgen_bit_for_bit(h, w, n, n_points, seed):
    want = np.asarray(csyn.build_overlay_bank(h, w, n=n, n_points=n_points,
                                              seed=seed))
    got = tsyn.build_overlay_bank(h, w, n=n, n_points=n_points, seed=seed)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [0, 3, 4, 10])
def test_blur_matches_catgen(size):
    masks = np.random.RandomState(size).rand(3, 32, 32).astype(np.float32)
    want = np.asarray(csyn.blur(jnp.asarray(masks), size))
    got = tsyn.blur(torch.tensor(masks), size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if size:
        np.testing.assert_allclose(
            tsyn.gaussian_kernel(size).numpy(),
            np.asarray(csyn.gaussian_kernel(size)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("n,size", [(1, 4), (3, 10)])
def test_gaussian_overlays_match_catgen(bank, n, size):
    got, want = _replayed(
        lambda: csyn.gaussian_overlays(jax.random.PRNGKey(n), bank, n, size),
        lambda d: tsyn.gaussian_overlays(d, torch.tensor(bank), n, size))
    _assert_images(got, want)


@pytest.mark.parametrize("n,hw", [(1, (32, 32)), (3, (12, 20))])
def test_pixelwise_overlays_match_catgen(n, hw):
    got, want = _replayed(
        lambda: csyn.pixelwise_overlays(jax.random.PRNGKey(5), n, *hw),
        lambda d: tsyn.pixelwise_overlays(d, n, *hw))
    _assert_images(got, want)
    assert (got == 0).any() and (got > 0).any()


# ---------------------------------------------------------------------------
# generators and dispatch
# ---------------------------------------------------------------------------


def _generator_pair(name, bank, reals):
    """(catgen call, port call) of one generator on 4 images."""
    r1, r2 = reals[:4], reals[4:]
    cb, tb = jnp.asarray(bank), torch.tensor(bank)
    key = jax.random.PRNGKey(11)
    if name == "mix":
        return (lambda: csyn.synthetic_mix(key, jnp.asarray(r1),
                                           jnp.asarray(r2), cb),
                lambda d: tsyn.synthetic_mix(d, torch.tensor(r1),
                                             torch.tensor(r2), tb))
    if name == "warp":
        return (lambda: csyn.synthetic_warp(key, jnp.asarray(r1), cb),
                lambda d: tsyn.synthetic_warp(d, torch.tensor(r1), tb))
    if name == "stamp":
        return (lambda: csyn.synthetic_stamp(key, jnp.asarray(r1), cb),
                lambda d: tsyn.synthetic_stamp(d, torch.tensor(r1), tb))
    return (lambda: csyn.synthetic_random(key, cb, 4, 32, 32, 3),
            lambda d: tsyn.synthetic_random(d, tb, 4, 32, 32, 3))


@pytest.mark.parametrize("name", ["mix", "warp", "stamp", "random"])
def test_generators_match_catgen(bank, name):
    got, want = _replayed(*_generator_pair(name, bank, _reals(8, 3)))
    _assert_images(got, want)
    np.testing.assert_allclose(got.max(axis=(1, 2, 3)), 1.0, atol=1e-6)


def test_warp_flow_reaches_past_every_edge(bank):
    """The warp's flow runs past the image on every side (the kernel's
    edge clamp), up to 5 px."""
    seen = []
    real = tsyn.warp_flow

    def spy(img, flow):
        seen.append(flow)
        return real(img, flow)

    with mock.patch.object(tsyn, "warp_flow", spy):
        for seed in range(4):
            tsyn.synthetic_warp(Draws(torch.Generator().manual_seed(seed)),
                                torch.tensor(_reals(8, seed)),
                                torch.tensor(bank))
    flow = torch.stack(seen)
    ys = torch.arange(32.0)[:, None] + flow[..., 0]
    xs = torch.arange(32.0)[None, :] + flow[..., 1]
    assert ys.min() < 0 and xs.min() < 0 and ys.max() > 31 and xs.max() > 31
    assert flow.abs().max() <= 5.0


@pytest.mark.parametrize("branch", range(4))
@pytest.mark.parametrize("submix", [False, True])
def test_batch_generator_matches_catgen(bank, branch, submix):
    sub_branch = (branch + 1 + submix) % 4
    reals4 = _reals(4 * 4, 20 + branch).reshape((4, 4) + IMG)
    cgen = csyn.make_batch_generator(jnp.asarray(bank), IMG)
    tgen = tsyn.make_batch_generator(torch.tensor(bank), IMG)
    got, want = _replayed(
        lambda: cgen(jax.random.PRNGKey(branch), branch, sub_branch, submix,
                     jnp.asarray(reals4)),
        lambda d: tgen(d, branch, sub_branch, submix, torch.tensor(reals4)))
    _assert_images(got, want)


def test_factory_picks_catgens_branches(bank):
    """One seed, the same host draws: the same generator sequence, the same
    real-image requests, and the RandomState left where catgen leaves it.
    catgen's generators are stubbed (their pixels are checked above)."""
    picked = []

    def stub(name, n_arg):
        def gen(*args):
            picked.append(name)
            n = args[n_arg] if isinstance(args[n_arg], int) \
                else args[n_arg].shape[0]
            return jnp.zeros((n,) + SMALL)
        return gen

    asked = {"catgen": [], "port": []}

    def sampler(side):
        def sample_reals(n):
            asked[side].append(n)
            shape = (n,) + SMALL
            x = np.full(shape, 0.5, np.float32)
            return jnp.asarray(x) if side == "catgen" else torch.tensor(x)
        return sample_reals

    cfac = csyn.SyntheticImageFactory(jnp.asarray(bank[:, :16, :16]), SMALL,
                                      seed=3)
    with mock.patch.multiple(
            csyn, synthetic_mix=stub(tsyn.MIX, 1),
            synthetic_warp=stub(tsyn.WARP, 1),
            synthetic_stamp=stub(tsyn.STAMP, 1),
            synthetic_random=stub(tsyn.RANDOM, 2),
            _batch_overlay=lambda *a: jnp.zeros(SMALL[:2])):
        for n in (2, 3) * 6:
            cfac(n, sampler("catgen"))
    tfac = tsyn.SyntheticImageFactory(torch.tensor(bank[:, :16, :16]),
                                      SMALL, seed=3)
    for n in (2, 3) * 6:
        out = tfac(n, sampler("port"))
        assert out.shape == (n,) + SMALL
    assert tfac.branches == picked and len(set(picked)) == 4
    assert asked["port"] == asked["catgen"]
    assert tfac._np.randint(2 ** 31) == cfac._np.randint(2 ** 31)


def test_warp_batches_counts_primary_and_submix_warps():
    assert tvt.warp_batches([1, 0, 1, 3], [1, 1, 2, 1],
                            [False, True, True, True]) == 4


# ---------------------------------------------------------------------------
# V at full width
# ---------------------------------------------------------------------------

V_GAIN = 2.0


def catgen_v(name, shape, seed=0, gain=V_GAIN):
    v = {"v16": cmodels.create_V16, "v32": cmodels.create_V32}[name](shape)
    variables = np_tree(v.init(jax.random.PRNGKey(seed), (1,) + shape))
    perturb(variables, np.random.RandomState(seed), gain=gain)
    return v, variables


def port_v(name, shape, variables):
    v = tmodels.V_REGISTRY[name](shape)
    v.load_state_dict(catgen_to_state_dict(variables["params"],
                                           variables["state"]), strict=True)
    return v


@pytest.mark.parametrize("name,shape", [("v16", SMALL), ("v32", IMG)])
def test_v_forward_matches_catgen(name, shape):
    cv, variables = catgen_v(name, shape)
    tv = port_v(name, shape, variables)
    x = _reals(4, 7, shape)
    want, _ = jax.jit(cv.apply)(variables, jnp.asarray(x))
    got = tvt.v_scores(tv, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 1], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(
        float(tvt.rate_with_v(tv, torch.tensor(x))),
        float(cvt.rate_with_v(cv, variables, jnp.asarray(x))), rtol=0,
        atol=ATOL)
    with record_jax_draws() as draws:
        want, _ = cv.apply(variables, jnp.asarray(x), train=True,
                           rng=jax.random.PRNGKey(3))
    assert [k for k, _ in draws] == ["bernoulli"] * 4
    from catgen_torch.nn.layers import set_draws
    replay = ReplayDraws(draws)
    set_draws(tv, replay)
    got = tv.train()(torch.tensor(x))
    assert not replay.records
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    assert tmodels.create_V(shape).__class__ is tv.__class__


def test_v_step_matches_catgen_at_full_width():
    """One V32 step at batch 8: 4 reals, 4 fakes from the warp generator."""
    config = dict(batch_size=8)
    cv, variables = catgen_v("v32", IMG, seed=1)
    c_config = cvt.VConfig(**config)
    state = cvt.init_state(cv, c_config, jax.random.PRNGKey(0), IMG)
    state = state._replace(params=variables["params"],
                           state=variables["state"])
    tv = port_v("v32", IMG, variables)
    t_state = tvt.init_state(tv, tvt.VConfig(**config))
    reals, fakes = _reals(4, 8), _reals(4, 9) ** 2
    c_grads, t_grads = [], []
    with record_jax_draws() as draws, \
            capture_grads(copt, c_grads, catgen_grads_to_port):
        new, cm = cvt.make_train_step(cv, c_config)(
            state, jnp.asarray(reals), jnp.asarray(fakes),
            jax.random.PRNGKey(4))
    replay = ReplayDraws(draws)
    with capture_grads(topt, t_grads, port_grads_to_numpy):
        tm = tvt.make_train_step(tv, tvt.VConfig(**config))(
            t_state, torch.tensor(reals), torch.tensor(fakes), replay)
    assert not replay.records
    for name in ("loss", "acc"):
        np.testing.assert_allclose(float(getattr(tm, name)),
                                   float(getattr(cm, name)), rtol=1e-5,
                                   err_msg=name)
    for name in ("tp_real", "tn_fake", "fp", "fn"):
        assert int(getattr(tm, name)) == int(getattr(cm, name)), name
    assert sum(int(x) for x in tm[2:]) == 8
    assert len(c_grads) == len(t_grads) == 1
    zero = bn_fed_biases(tv)
    assert zero == {"03_Conv.bias", "10_Conv.bias", "16_Dense.bias",
                    "20_Dense.bias"}
    assert_grads_close(t_grads[0], c_grads[0], zero=zero)
    before = {k: v.numpy() for k, v in catgen_to_state_dict(
        variables["params"], {}).items()}
    want = catgen_to_state_dict(np_tree(new.params), np_tree(new.state))
    assert_adam_step_close(
        {k: v.numpy() for k, v in tv.state_dict().items()},
        {k: v.numpy() for k, v in want.items()}, c_grads[0], before,
        (c_config.v_l1, c_config.v_l2, c_config.v_clamp), zero=zero)
    assert t_state.step == int(new.step) == 1
    assert int(t_state.opt.step) == int(new.opt.step) == 1


def test_v_epoch_runs_generate_then_step_per_batch(bank):
    """The port's epoch: per batch the generator, then the step, on one
    stream of draws (checked against the same calls made by hand)."""
    v_a, v_b = (port_v("v16", SMALL, catgen_v("v16", SMALL)[1])
                for _ in range(2))
    config = tvt.VConfig(batch_size=4)
    tb = torch.tensor(bank[:, :16, :16])
    r = np.random.RandomState(3)
    reals = torch.tensor(r.rand(3, 2, *SMALL).astype(np.float32))
    gen_reals = torch.tensor(r.rand(3, 4, 2, *SMALL).astype(np.float32))
    branches, subs, submix = [0, 1, 3], [2, 1, 0], [False, True, True]
    state_a = tvt.init_state(v_a, config)
    m = tvt.make_train_epoch(v_a, config, tb, SMALL)(
        state_a, reals, gen_reals, branches, subs, submix,
        Draws(torch.Generator().manual_seed(5)))
    state_b = tvt.init_state(v_b, config)
    step = tvt.make_train_step(v_b, config)
    generate = tsyn.make_batch_generator(tb, SMALL)
    draws = Draws(torch.Generator().manual_seed(5))
    for i in range(3):
        fakes = generate(draws, branches[i], subs[i], submix[i],
                         gen_reals[i])
        mi = step(state_b, reals[i], fakes, draws)
        assert all(torch.equal(x[i], y) for x, y in zip(m, mi))
    assert (state_a.epoch, state_a.step) == (2, 3)
    for k, t in v_a.state_dict().items():
        assert torch.equal(t, v_b.state_dict()[k]), k


def test_port_config_fields_are_catgens():
    import dataclasses
    ported = {f.name for f in dataclasses.fields(tvt.VConfig)}
    catgen = {f.name for f in dataclasses.fields(cvt.VConfig)}
    # every field, the DP axis (axis_name) included
    assert ported == catgen
