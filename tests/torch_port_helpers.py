"""Shared set-up of the PyTorch port's parity tests (test_torch_port_*.py):
the flagship pair built on both sides with the same weights, JAX's draws
replayed in the port, and the inputs and selectors of the upsample-conv
kernel route.

Weights start from catgen's init and are then perturbed with seeded numpy
noise, so that the comparison exercises what zero-initialised heads and
fresh BatchNorm statistics would hide:
  * every conv and dense kernel is scaled by ``WEIGHT_GAIN``: at the
    heuristic init each layer shrinks its activations, and G's images and
    D's scores come out flat (D's scores equal to ~1e-7);
  * the spatial-transformer heads get noisy kernels and biases, so the
    grids are not the identity and the sampler reads between pixels and
    past the edges;
  * BatchNorm running means and variances get noise.
"""

from __future__ import annotations

import contextlib
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from catgen import models as cmodels
from catgen_torch import models as tmodels
from catgen_torch.io.convert import catgen_to_state_dict, kernel_to_weight

IMG = (32, 32, 3)
NOISE_DIM = 100
WEIGHT_GAIN = 4.0

# The suite runs in several pytest-xdist workers at once. torch's intra-op
# pool defaults to one thread per core in each of them, which oversubscribes
# the cores and slows the port's side several-fold; each worker takes its
# share of the cores instead.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def np_tree(tree):
    """A jax tree as writable numpy copies."""
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def perturb(variables, rng: np.random.RandomState,
            gain: float = WEIGHT_GAIN) -> None:
    """Perturbs a catgen variables tree (numpy leaves) in place; kernels
    are scaled by ``gain``."""

    def walk(params, state, path):
        for k, v in params.items():
            if not isinstance(v, dict):
                continue
            st = state.get(k, {}) if isinstance(state, dict) else {}
            if k.startswith("head"):
                v["kernel"] = rng.normal(0.0, 0.05, v["kernel"].shape
                                         ).astype(np.float32)
                v["bias"] = (v["bias"] + rng.normal(0.0, 0.2, v["bias"].shape)
                             ).astype(np.float32)
                continue
            if "kernel" in v:
                v["kernel"] = (v["kernel"] * gain).astype(np.float32)
            if "mean" in st:
                st["mean"] = rng.normal(0.0, 0.1, st["mean"].shape
                                        ).astype(np.float32)
                st["var"] = rng.uniform(0.5, 2.0, st["var"].shape
                                        ).astype(np.float32)
            walk(v, st, path + (k,))

    walk(variables["params"], variables["state"], ())


def catgen_pair(seed: int = 0):
    """catgen's G32up-c and D32_st3 with perturbed weights:
    (G, D, g_vars, d_vars), variables as numpy trees."""
    g = cmodels.create_G_decoder_upsampling32c(IMG, NOISE_DIM)
    d = cmodels.create_D32_st3(IMG)
    gv = np_tree(g.init(jax.random.PRNGKey(seed), (1, NOISE_DIM)))
    dv = np_tree(d.init(jax.random.PRNGKey(seed + 1), (1,) + IMG))
    rng = np.random.RandomState(seed)
    perturb(gv, rng)
    perturb(dv, rng)
    return g, d, gv, dv


def port_pair(gv, dv):
    """The port's G32up-c and D32_st3 holding catgen's weights, in eval."""
    g = tmodels.create_G_decoder_upsampling32c(IMG, NOISE_DIM)
    d = tmodels.create_D32_st3(IMG)
    g.load_state_dict(catgen_to_state_dict(gv["params"], gv["state"]),
                      strict=True)
    d.load_state_dict(catgen_to_state_dict(dv["params"], dv["state"]),
                      strict=True)
    return g.eval(), d.eval()


def image_shape(name: str):
    """catgen's scale for a registry model (tests/test_models.py)."""
    if "64" in name:
        return (64, 64, 3)
    if "16" in name:
        return (16, 16, 3)
    return (32, 32, 3)


REGISTRIES = {"G": (cmodels.G_REGISTRY, tmodels.G_REGISTRY),
              "D": (cmodels.D_REGISTRY, tmodels.D_REGISTRY),
              "V": (cmodels.V_REGISTRY, tmodels.V_REGISTRY)}


def build_pair(kind: str, name: str, seed: int = 0):
    """The registry model ``name`` of ``kind`` ("G", "D" or "V") at
    catgen's scale for it: catgen's model, its variables (``perturb``ed),
    the port's model holding them (strict load), and the input shape of
    one sample."""
    img = image_shape(name)
    creg, treg = REGISTRIES[kind]
    if kind == "G" and name == "refine64":
        args, x_shape = (img,), (32, 32, 3)      # image-to-image stage
    elif kind == "G":
        args, x_shape = (img, NOISE_DIM), (NOISE_DIM,)
    else:
        args, x_shape = (img,), img
    cm, tm = creg[name](*args), treg[name](*args)
    variables = np_tree(cm.init(jax.random.PRNGKey(seed), (1,) + x_shape))
    variables.setdefault("state", {})
    perturb(variables, np.random.RandomState(seed))
    tm.load_state_dict(catgen_to_state_dict(variables["params"],
                                            variables["state"]), strict=True)
    return cm, variables, tm, x_shape


# ---------------------------------------------------------------------------
# training parity: JAX's draws handed to the port, gradients captured
# ---------------------------------------------------------------------------

_DRAW_KINDS = ("uniform", "bernoulli", "normal", "randint")


def _python_scan(f, init, xs):
    """``lax.scan`` as a Python loop over the leading axis (no ``length``,
    ``reverse`` or ``unroll``): the same sequential semantics."""
    n = jax.tree_util.tree_leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, jax.tree_util.tree_map(lambda x: x[i], xs))
        ys.append(y)
    return carry, jax.tree_util.tree_map(lambda *a: jax.numpy.stack(a), *ys)


@contextlib.contextmanager
def record_jax_draws():
    """Runs the body eagerly (``jax.disable_jit``) and records, in order,
    every ``jax.random.uniform`` / ``bernoulli`` / ``normal`` / ``randint``
    result as (kind, numpy array): the noise, augmentation draws, dropout
    masks and the synthetic generators' integers catgen takes, in the
    order it takes them. ``lax.scan`` runs as a Python loop meanwhile:
    eager ``lax.scan`` took minutes on its first call over the V
    generators' 1024-step pixelwise scan."""
    records = []
    real = {k: getattr(jax.random, k) for k in _DRAW_KINDS}

    def wrap(kind):
        def draw(*args, **kwargs):
            out = real[kind](*args, **kwargs)
            records.append((kind, np.asarray(out)))
            return out
        return draw

    with mock.patch.multiple(jax.random, **{k: wrap(k) for k in real}), \
            mock.patch.object(jax.lax, "scan", _python_scan), \
            jax.disable_jit():
        yield records


class ReplayDraws:
    """Stands in for ``catgen_torch.core.random.Draws``: hands out the
    recorded JAX draws in order, checking kind and shape."""

    def __init__(self, records):
        self.records = list(records)

    def _next(self, kind, shape):
        assert self.records, f"the port drew {kind} {tuple(shape)} more " \
                             f"often than catgen"
        got_kind, arr = self.records.pop(0)
        assert (got_kind, arr.shape) == (kind, tuple(shape)), (
            f"port draws {kind} {tuple(shape)}, catgen drew {got_kind} "
            f"{arr.shape}")
        return torch.tensor(arr)

    def uniform(self, shape, low=0.0, high=1.0):
        return self._next("uniform", shape)

    def bernoulli(self, p, shape):
        return self._next("bernoulli", shape)

    def normal(self, shape):
        return self._next("normal", shape)

    def randint(self, low, high, shape):
        return self._next("randint", shape).long()


@contextlib.contextmanager
def capture_grads(module, into: list, to_port=None):
    """Records the gradients handed to ``module.clamp_and_penalize`` (each
    optimizer update's raw gradients), converted by ``to_port``."""
    real = module.clamp_and_penalize

    def spy(grads, *args, **kwargs):
        into.append(to_port(grads) if to_port else grads)
        return real(grads, *args, **kwargs)

    with mock.patch.object(module, "clamp_and_penalize", spy):
        yield into


def catgen_grads_to_port(grads):
    """A catgen gradient tree -> {port parameter name: numpy array}."""
    return {k: v.numpy() for k, v in
            catgen_to_state_dict(np_tree(grads), {}).items()}


def port_grads_to_numpy(grads):
    return {k: v.detach().cpu().numpy() for k, v in grads.items()}


def assert_grads_close(port, catgen, rel=1e-4, floor=1e-6, zero=()):
    """Per leaf: max abs difference within ``rel`` of the leaf's max |g|,
    plus ``floor`` x the largest |g| of the update, for leaves whose
    gradient is zero up to rounding (a bias in front of a BatchNorm).
    Leaves in ``zero`` (``bn_fed_biases``: exactly zero in exact
    arithmetic) must be rounding noise on both sides, within
    ``ZERO_FLOOR`` x the largest |g|."""
    assert set(port) == set(catgen)
    top = max(np.abs(v).max() for v in catgen.values())
    for k, want in catgen.items():
        if k in zero:
            for side, g in (("port", port[k]), ("catgen", want)):
                assert np.abs(g).max() <= ZERO_FLOOR * top, (k, side)
            continue
        bound = rel * np.abs(want).max() + floor * top
        err = np.abs(port[k] - want).max()
        assert err <= bound, f"{k}: {err} > {bound}"


# a gradient that is zero in exact arithmetic, summed over a few thousand
# products in f32, comes out at up to ~3e-6 of the update's largest
ZERO_FLOOR = 1e-5


def bn_fed_biases(module, prefix=""):
    """State-dict names of the biases of layers that feed a BatchNorm
    directly (in any nested Sequential): their gradient is exactly zero,
    since the BatchNorm takes out the mean."""
    from catgen_torch.nn.layers import BatchNorm
    out = set()
    children = list(module.named_children())
    for (name, m), nxt in zip(children, children[1:] + [(None, None)]):
        if isinstance(nxt[1], BatchNorm) and isinstance(
                getattr(m, "bias", None), torch.nn.Parameter):
            out.add(f"{prefix}{name}.bias")
        out |= bn_fed_biases(m, f"{prefix}{name}.")
    return out


def assert_adam_step_close(got, want, raw_grads, before, penalties,
                           zero=(), lr=1e-3, atol=2e-5, rel=1e-4,
                           floor=1e-6):
    """Parameters after one Adam step from zero moments within ``atol``,
    except where catgen's penalized gradient (``raw_grads`` through
    ``penalties`` = (l1, l2, clamp) at the ``before`` weights) is within
    the gradient tolerance of zero: Adam's first step moves a weight by
    about lr*sign(g), so there a rounding difference may move it the other
    way, by up to 2*lr. All arguments are {port name: numpy array}."""
    l1, l2, clamp = penalties
    top = max(np.abs(v).max() for v in raw_grads.values())
    assert set(got) == set(want)
    for k in want:
        err = np.abs(got[k] - want[k])
        if k not in raw_grads:                     # BatchNorm statistics
            assert err.max() <= atol, k
            continue
        g = raw_grads[k] + l1 * np.sign(before[k]) + l2 * before[k]
        if clamp:
            g = np.clip(g, -clamp, clamp)
        bound = (ZERO_FLOOR * top if k in zero
                 else rel * np.abs(raw_grads[k]).max() + floor * top)
        ambiguous = np.abs(g) <= bound
        assert err[~ambiguous].max(initial=0.0) <= atol, k
        assert err.max() <= 2 * lr + atol, k


# One full-width train step against catgen's. Weight gains where both
# gradients are well conditioned in f32: at D gain 1, D's output barely
# depends on its input and the input gradient that reaches G is a small
# remainder of cancelling paths (1e-3 relative differences between two
# correct f32 implementations); at G gain 2 and above, G's output sigmoid
# saturates and its gradient loses digits the same way; at D gain 4,
# Adam's first step (+-lr wherever |g| >> 3e-7) turns gradient rounding
# into 2*lr parameter differences.
FULL_G_GAIN, FULL_D_GAIN = 1.0, 2.0
FULL_ATOL = 1e-4


def full_width_step_matches(g_name: str, d_name: str, img, bernoulli: int,
                            batch: int = 4, g_gain: float = FULL_G_GAIN,
                            d_gain: float = FULL_D_GAIN) -> None:
    """One train step of the registry pair (``g_name``, ``d_name``) at
    ``img`` and ``batch``, with augmentation of the reals: the port's step
    against catgen's ``make_train_step``, from catgen's initial state
    (perturbed at ``g_gain`` and ``d_gain``) converted. catgen runs
    eagerly; its noise, augmentation draws and dropout masks (``bernoulli``
    of them, the flip included) are recorded and handed to the port in
    order, and both sides' raw gradients are captured before the
    optimizer. Losses, acc_d and acc_avg rtol 1e-5; confusion counts and
    the gate's decision exact; gradients per leaf within 1e-4 of the
    leaf's largest (``assert_grads_close``); parameters after the step and
    G's BatchNorm statistics atol ``FULL_ATOL``."""
    from catgen import optim as copt
    from catgen.train import gan as cgan
    from catgen_torch import optim as topt
    from catgen_torch.train import gan as tgan
    config = dict(batch_size=batch, noise_dim=NOISE_DIM, augment=True)
    c_config = cgan.GanConfig(bce="logits", **config)
    t_config = tgan.GanConfig(bce="logits", **config)
    cg = cmodels.G_REGISTRY[g_name](img, NOISE_DIM)
    cd = cmodels.D_REGISTRY[d_name](img)
    state = cgan.init_state(cg, cd, c_config, jax.random.PRNGKey(0), img)
    gv = np_tree({"params": state.g_params, "state": state.g_state})
    dv = np_tree({"params": state.d_params, "state": state.d_state})
    rng = np.random.RandomState(0)
    perturb(gv, rng, gain=g_gain)
    perturb(dv, rng, gain=d_gain)
    state = state._replace(g_params=gv["params"], g_state=gv["state"],
                           d_params=dv["params"], d_state=dv["state"])

    tg = tmodels.G_REGISTRY[g_name](img, NOISE_DIM)
    td = tmodels.D_REGISTRY[d_name](img)
    tg.load_state_dict(catgen_to_state_dict(gv["params"], gv["state"]))
    td.load_state_dict(catgen_to_state_dict(dv["params"], dv["state"]))
    t_state = tgan.init_state(tg, td, t_config)

    reals = np.random.RandomState(1).rand(batch // 2, *img).astype(
        np.float32)
    c_grads, t_grads = [], []
    with record_jax_draws() as draws, \
            capture_grads(copt, c_grads, catgen_grads_to_port):
        new, cm = cgan.make_train_step(cg, cd, c_config)(
            state, jax.numpy.asarray(reals), jax.random.PRNGKey(2))
    kinds = [k for k, _ in draws]
    assert kinds.count("normal") == 1
    assert kinds.count("bernoulli") == bernoulli
    replay = ReplayDraws(draws)
    with capture_grads(topt, t_grads, port_grads_to_numpy):
        tm = tgan.make_train_step(tg, td, t_config)(
            t_state, torch.tensor(reals), replay)
    assert not replay.records

    for name in ("loss_d", "loss_g", "acc_d", "acc_avg"):
        np.testing.assert_allclose(float(getattr(tm, name)),
                                   float(getattr(cm, name)), rtol=1e-5,
                                   err_msg=name)
    for name in ("d_trained", "tp_real", "tn_fake", "fp", "fn"):
        assert float(getattr(tm, name)) == float(getattr(cm, name)), name

    assert len(c_grads) == len(t_grads) == 2          # D, then G
    for got, want in zip(t_grads, c_grads):
        assert_grads_close(got, want)

    for module, params, st in ((tg, new.g_params, new.g_state),
                               (td, new.d_params, new.d_state)):
        want = catgen_to_state_dict(np_tree(params), np_tree(st))
        got = module.state_dict()
        assert set(got) == set(want)
        for k in want:     # parameters and G's BN running statistics
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=FULL_ATOL, err_msg=k)
    assert t_state.step == int(new.step) == 1
    assert int(t_state.d_opt.step) == int(new.d_opt.step) == 1


# ---------------------------------------------------------------------------
# G's upsample-convs on the kernel route (catgen's Pallas route, run in
# interpret mode on the CPU, against the port's plain versions)
# ---------------------------------------------------------------------------

LADDER = dict(upsample_impl="pallas", fused_ladder=True, ladder_bwd="pallas")
PER_LAYER = dict(upsample_impl="pallas", fused_ladder=False,
                 upsample_bwd="pallas")
# (n, h, w, cin, cout, k): odd sizes, H != W, channels off any tile
UPSAMPLE_SHAPES = [(2, 4, 5, 8, 12, 3), (3, 5, 4, 12, 8, 5),
                   (2, 4, 6, 9, 11, 7)]


@pytest.fixture
def catgen_route(monkeypatch):
    """Sets catgen's kernel selectors for this test only (no other test in
    the xdist worker sees them), with its Pallas kernels in interpret
    mode: ``catgen_route(upsample_impl="pallas", ...)``."""
    from catgen.kernels import config as kconfig

    monkeypatch.setattr(kconfig, "pallas_interpret", True)

    def use(**choices):
        for k, v in choices.items():
            monkeypatch.setattr(kconfig, k, v)
    return use


def upsample_inputs(seed, n, h, w, cin, cout, k, alpha_n=1):
    """numpy inputs of one upsample-conv block: x, an HWIO kernel, bias, the
    input transform (scale, shift, alpha_n slopes) and the cotangents."""
    r = np.random.RandomState(seed)
    f = np.float32
    return dict(
        x=r.randn(n, h, w, cin).astype(f),
        kern=(r.randn(k, k, cin, cout) * 0.2).astype(f),
        bias=(r.randn(cout) * 0.1).astype(f),
        scale=(r.rand(cin) + 0.5).astype(f),
        shift=(r.randn(cin) * 0.3).astype(f),
        alpha=(r.rand(alpha_n) * 0.5).astype(f),
        gy=r.randn(n, 2 * h, 2 * w, cout).astype(f),
        gs1=(r.randn(cout) * 0.01).astype(f),
        gs2=(r.randn(cout) * 0.01).astype(f))


def port_tensors(v):
    """``upsample_inputs`` as torch tensors, the kernel as an OIHW weight."""
    return {k: torch.tensor(kernel_to_weight(a) if k == "kern" else a)
            for k, a in v.items()}


def assert_rel_close(got, want, rel, name=""):
    """max |got - want| within ``rel`` of max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bound = rel * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{name}: {err} > {bound}"


# ---------------------------------------------------------------------------
# TF32 arithmetic as the tensor cores do it, emulated in numpy: the dCK
# kernel (csrc/upsample_conv_bwd.cu) runs its f32 product as 3xTF32
# ---------------------------------------------------------------------------


def tf32_round(a):
    """float32 ``a`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: add half of the last
    kept bit to the magnitude and clear the 13 dropped bits."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_tf32(a):
    """(hi, lo): hi = rna(a), lo = rna(a - hi), both TF32 values."""
    a = np.asarray(a, dtype=np.float32)
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


def _mm_t(a, b):
    """aᵀ b in float32 (torch's CPU GEMM: numpy's is slow here)."""
    return (torch.from_numpy(np.ascontiguousarray(a)).T
            @ torch.from_numpy(np.ascontiguousarray(b))).numpy()


def matmul_3xtf32(a, b):
    """aᵀ b over the leading axis in 3xTF32: lo·hi + hi·lo + hi·hi, each
    TF32 product exact, summed in float32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (_mm_t(al, bh) + _mm_t(ah, bl)) + _mm_t(ah, bh)


def matmul_tf32(a, b):
    """aᵀ b with one TF32 product per f32 product (what 3xTF32 avoids)."""
    return _mm_t(tf32_round(a), tf32_round(b))
