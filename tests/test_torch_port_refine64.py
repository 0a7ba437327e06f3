"""The 64px pyramid in the port against catgen on the CPU: the bilinear
resize and its VJP (``data/ops.py``), the refine stage, G64_stack and D64
(``models/refine.py``) from catgen's weights converted, one 64px GAN step
with catgen's draws replayed, the loader at 64px, 32px and a scale that is
no 2x step, and the stage-wise warm start (``cli/stack64_warmstart.py``)
against ``tools/stack64_warmstart.py::graft_base``.

Tolerances, stated per test:
  * resize, f32: atol 1e-6 (two 2-tap products, summed alike); its VJP
    1e-6 of the largest cotangent sum; bf16: bit for bit (rounded once
    from the same f32 value);
  * the models' eval forwards, f32: atol 1e-5 (as G32up-c's and
    D32_st3's, tests/test_torch_port_models.py); G64_stack in training
    (BatchNorm's batch statistics) the same, and its running statistics
    atol 1e-6; bf16: 2^-6 of the largest output, as the flagship pair's
    (tests/test_torch_port_bf16.py);
  * the step: tests/test_torch_port_train.py's: losses rtol 1e-5,
    confusion counts exact, gradients per leaf within 1e-4 of the leaf's
    largest, parameters, Adam moments and BatchNorm statistics atol 2e-5
    (Adam's first step: ``assert_adam_step_close``, which lets a weight
    whose penalized gradient is rounding noise move the other way); but
    G's gradients within 2e-3 of the leaf's largest plus 1e-5 of the
    update's largest: at 64px f32 rounding can flip the PReLU branch of
    one of a million pre-activations, and both packages' f32 gradients
    lie ~1e-3 from float64
    (``test_refine_training_gradient_is_f32_conditioned``; ROADMAP Queue
    C);
  * the loader: atol 1e-6 (the same PIL decode, the same f32 products);
  * the warm start: bit for bit.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import models as cmodels
from catgen.data import ops as cops
from catgen.data.fixture import write_fixture_dataset
from catgen.data.loader import ImageDataset as CDataset
from catgen.io import checkpoint as cckpt
from catgen.train import gan as cgan
from catgen_torch import models as tmodels
from catgen_torch import optim as topt
from catgen_torch.cli import stack64_warmstart as tws
from catgen_torch.core.module import reset_parameters
from catgen_torch.data import ops as tops
from catgen_torch.data.loader import ImageDataset as TDataset
from catgen_torch.io import checkpoint as tckpt
from catgen_torch.io.convert import (catgen_to_state_dict,
                                     state_dict_to_catgen,
                                     train_state_from_leaves,
                                     train_state_to_leaves, tree_to_leaves,
                                     variables_to_leaves)
from catgen_torch.train import gan as tgan

from test_torch_port_bf16 import run_traced, traced_with_callbacks
from torch_port_helpers import (ReplayDraws, assert_adam_step_close,
                                assert_grads_close, bn_fed_biases,
                                capture_grads, np_tree, perturb,
                                port_grads_to_numpy)

IMG64 = (64, 64, 3)
NOISE = 100
BF16 = jnp.bfloat16

_spec = importlib.util.spec_from_file_location(
    "stack64_warmstart",
    os.path.join(os.path.dirname(__file__), "..", "tools",
                 "stack64_warmstart.py"))
cws = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cws)


def to_bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(BF16)
                      .astype(jnp.float32))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the resize
# ---------------------------------------------------------------------------

RESIZES = [((2, 32, 32, 3), (64, 64)),     # the refine stage's base
           ((2, 64, 64, 3), (48, 48)),     # a loader scale, no 2x step
           ((3, 5, 7, 2), (10, 3)),        # up one axis, down the other
           ((1, 1, 4, 1), (3, 4))]         # one input row


@pytest.mark.parametrize("shape, out_hw", RESIZES)
def test_resize_and_its_vjp_match_catgen(shape, out_hw):
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    g = rng.randn(shape[0], *out_hw, shape[3]).astype(np.float32)
    want, vjp = jax.vjp(lambda a: cops.resize_bilinear(a, out_hw),
                        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = tops.resize_bilinear(xt, out_hw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    got.backward(torch.tensor(g))
    want_dx = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=0,
                               atol=1e-6 * np.abs(want_dx).max())
    xb = to_bf16(x)
    got16 = tops.resize_bilinear(torch.tensor(xb).bfloat16(), out_hw)
    want16 = cops.resize_bilinear(jnp.asarray(xb, BF16), out_hw)
    assert got16.dtype == torch.bfloat16 and want16.dtype == BF16
    np.testing.assert_array_equal(f32(got16), f32(want16))


def test_resize_to_the_same_size_is_the_identity():
    x = torch.rand(2, 8, 8, 3)
    assert tops.resize_bilinear(x, (8, 8)) is x


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _catgen_vars(model, shape, seed, gain=1.0):
    v = np_tree(model.init(jax.random.PRNGKey(seed), shape))
    perturb(v, np.random.RandomState(seed), gain=gain)
    return v


def _port(create, args, v):
    m = create(*args)
    m.load_state_dict(catgen_to_state_dict(v["params"], v["state"]),
                      strict=True)
    return m


# name: (constructor, its args, input shape, kernel gain: at the
# heuristic init each layer shrinks its activations, and D64's two scores
# differ by 1e-5 at gain 2)
MODELS = {
    "refine": ("create_G_refine64", ((32, 32, 3), NOISE), (3, 32, 32, 3),
               2.0),
    "g64_stack": ("create_G64_stack", (IMG64, NOISE), (2, NOISE), 2.0),
    "d64": ("create_D64", (IMG64,), (2,) + IMG64, 4.5),
}


def _inputs(name, shape, rng):
    if name == "g64_stack":
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    return rng.rand(*shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_forward_matches_catgen(name, dtype):
    create, args, shape, gain = MODELS[name]
    cm = getattr(cmodels, create)(*args)
    v = _catgen_vars(cm, shape, seed=3, gain=gain)
    tm = _port(getattr(tmodels, create), args, v).eval()
    x = _inputs(name, shape, np.random.RandomState(4))
    if dtype == "bf16":
        x = to_bf16(x)
    cdt = BF16 if dtype == "bf16" else jnp.float32
    want = jax.jit(lambda vv, a: cm.apply(vv, a, train=False)[0])(
        v, jnp.asarray(x, cdt))
    with torch.inference_mode():
        got = tm(torch.tensor(x).to(
            torch.bfloat16 if dtype == "bf16" else torch.float32))
    assert got.shape == want.shape
    assert float(np.ptp(f32(want))) > 1e-3       # not a flat output
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    else:
        assert got.dtype == torch.bfloat16 and want.dtype == BF16
        err = np.abs(f32(got) - f32(want)).max()
        assert err <= 2.0 ** -6 * np.abs(f32(want)).max(), err


def test_g64_stack_in_training_matches_catgen():
    # BatchNorm's batch statistics in the forward and its running ones
    _, args, _, _ = MODELS["g64_stack"]
    cm = cmodels.create_G64_stack(*args)
    v = _catgen_vars(cm, (2, NOISE), seed=5)
    tm = _port(tmodels.create_G64_stack, args, v).train()
    x = _inputs("g64_stack", (4, NOISE), np.random.RandomState(6))
    want, new_state = cm.apply(v, jnp.asarray(x), train=True)
    got = tm(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    sd = catgen_to_state_dict({}, np_tree(new_state))
    for k, t in sd.items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), t.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_refine_trunk_is_a_plain_sequential():
    """The trunk's upsample-conv follows the per-layer route (a plain
    Sequential), the base G32up-c keeps its ladder."""
    from catgen_torch.nn.fused import FusedDecoderSequential

    g = tmodels.create_G64_stack(IMG64, NOISE)
    assert [n for n, _ in g.named_children()] == ["00_G32up_c",
                                                  "01_RefineStage"]
    assert isinstance(g.get_submodule("00_G32up_c"), FusedDecoderSequential)
    trunk = g.get_submodule("01_RefineStage.trunk")
    assert not isinstance(trunk, FusedDecoderSequential)
    with pytest.raises(ValueError, match="64x64"):
        tmodels.create_G64_stack((32, 32, 3), NOISE)


# ---------------------------------------------------------------------------
# one 64px GAN step
# ---------------------------------------------------------------------------

BATCH = 4
STEP_ATOL = 2e-5
# G's gradients: at 64px one of a million pre-activations may take the
# other PReLU branch in the other package's f32 rounding, which moves a
# weight gradient by ~1e-3 of itself and an input gradient by ~4e-3
G_REL, G_FLOOR, DX_REL = 2e-3, 1e-5, 1e-2
# the full-width 32px step's gains (tests/test_torch_port_train_full.py):
# D gain 2 keeps D64 off saturation (loss_g 0.68); above 3 its fakes'
# scores saturate and G's gradient is a small remainder of cancelling
# paths
G_GAIN, D_GAIN = 1.0, 2.0


@pytest.mark.parametrize("frozen", [False, True], ids=["all", "frozen_base"])
def test_g64_step_matches_catgen(frozen):
    """One step of G64_stack against D64 at batch 4, augmented (the
    sampler on 64x64x3 reals), from catgen's initial state perturbed; with
    ``frozen_base`` the base G32up-c is frozen (``--G_freeze
    00_G32up_c``). catgen's step runs compiled, its draws and gradients
    taken out by ordered debug callbacks."""
    config = dict(batch_size=BATCH, noise_dim=NOISE, augment=True,
                  bce="logits",
                  g_frozen_children=("00_G32up_c",) if frozen else ())
    c_config = cgan.GanConfig(**config)
    t_config = tgan.GanConfig(**config)
    cg = cmodels.create_G64_stack(IMG64, NOISE)
    cd = cmodels.create_D64(IMG64)
    state = cgan.init_state(cg, cd, c_config, jax.random.PRNGKey(0), IMG64)
    gv = np_tree({"params": state.g_params, "state": state.g_state})
    dv = np_tree({"params": state.d_params, "state": state.d_state})
    rng = np.random.RandomState(0)
    perturb(gv, rng, gain=G_GAIN)
    perturb(dv, rng, gain=D_GAIN)
    state = state._replace(g_params=gv["params"], g_state=gv["state"],
                           d_params=dv["params"], d_state=dv["state"])
    tg = _port(tmodels.create_G64_stack, (IMG64, NOISE), gv)
    td = _port(tmodels.create_D64, (IMG64,), dv)
    before = {k: v.numpy().copy() for m in (tg, td)
              for k, v in m.state_dict().items()}
    t_state = tgan.init_state(tg, td, t_config)

    reals = np.random.RandomState(1).rand(BATCH // 2, *IMG64).astype(
        np.float32)
    draws, c_grads, t_grads = [], [], []
    with traced_with_callbacks(draws, c_grads):
        new, cm = run_traced(jax.jit(cgan.make_train_step(cg, cd, c_config)),
                             state, jnp.asarray(reals),
                             jax.random.PRNGKey(2))
    kinds = [k for k, _ in draws]
    # augmentation (its flip and noise), then per phase D64's 7 masks
    assert kinds.count("normal") == 1 and kinds.count("bernoulli") == 15
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
    g_zero = bn_fed_biases(tg)
    assert_grads_close(t_grads[0], c_grads[0])
    assert_grads_close(t_grads[1], c_grads[1], rel=G_REL, floor=G_FLOOR,
                       zero=g_zero)

    for module, params, st, grads, penalties, zero, rel, floor in (
            (tg, new.g_params, new.g_state, c_grads[1], (0.0, 0.0, 5.0),
             g_zero, G_REL, G_FLOOR),
            (td, new.d_params, new.d_state, c_grads[0], (0.0, 1e-4, 1.0),
             set(), 1e-4, 1e-6)):
        want = {k: v.numpy() for k, v in catgen_to_state_dict(
            np_tree(params), np_tree(st)).items()}
        got = {k: v.numpy() for k, v in module.state_dict().items()}
        assert_adam_step_close(got, want, grads, before, penalties,
                               zero=zero, atol=STEP_ATOL, rel=rel,
                               floor=floor)
    if frozen:
        for k, v in tg.state_dict().items():
            if k.startswith("00_G32up_c."):
                np.testing.assert_array_equal(v.numpy(), before[k], k)


def test_refine_training_gradient_is_f32_conditioned():
    """The refine stage's gradient in training, f32 on both sides, against
    the port's in float64 (its resize still f32, as catgen's): the weight
    gradients within ``G_REL`` of a leaf's largest, the input's within
    ``DX_REL`` of its largest. Here both f32 sides lie 1.3e-3 and 4.1e-3
    from float64: f32 rounding flips the sign of one of the 2^20
    pre-activations of the trunk's second PReLU, which moves that
    pixel's gradient by (1 - slope) of itself."""
    cm = cmodels.create_G_refine64((32, 32, 3), NOISE)
    v = _catgen_vars(cm, (4, 32, 32, 3), seed=0)
    rng = np.random.RandomState(1)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    r = rng.rand(4, 64, 64, 3).astype(np.float32)

    def loss(p, a):
        y, _ = cm.apply({"params": p, "state": v["state"]}, a, train=True)
        return jnp.sum(y * r)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"],
                                                     jnp.asarray(x))
    sides = {"catgen": ({k: t.numpy() for k, t in catgen_to_state_dict(
        np_tree(gp), {}).items()}, np.asarray(gx))}
    for dt in (torch.float32, torch.float64):
        tm = _port(tmodels.create_G_refine64, ((32, 32, 3), NOISE), v)
        tm = tm.to(dt).train()
        xt = torch.tensor(x, dtype=dt, requires_grad=True)
        (tm(xt) * torch.tensor(r, dtype=dt)).sum().backward()
        sides[dt] = ({k: p.grad.double().numpy()
                      for k, p in tm.named_parameters()},
                     xt.grad.double().numpy())
    exact, exact_x = sides.pop(torch.float64)
    zero = bn_fed_biases(tm)
    for name, (grads, dx) in sides.items():
        for k, want in exact.items():
            if k not in zero:
                err = np.abs(grads[k] - want).max()
                assert err <= G_REL * np.abs(want).max(), (name, k, err)
        err = np.abs(dx - exact_x).max()
        assert err <= DX_REL * np.abs(exact_x).max(), (name, err)


def test_train_state_checkpoints_cross_between_the_packages(tmp_path):
    """The nested trees of G64_stack (a Sequential in a Sequential, the
    refine stage's named trunk and head) and D64 carry both ways through a
    train-state checkpoint: catgen loads the port's, the port loads
    catgen's, every leaf at its place."""
    config = dict(batch_size=4, noise_dim=8, acc_window=20)
    cg, cd = (cmodels.create_G64_stack(IMG64, 8), cmodels.create_D64(IMG64))
    template = cgan.ckpt_template(cg, cd, cgan.GanConfig(**config),
                                  jax.random.PRNGKey(0), IMG64)
    tg, td = tmodels.create_G64_stack(IMG64, 8), tmodels.create_D64(IMG64)
    gen = torch.Generator().manual_seed(2)
    reset_parameters(tg, gen)
    reset_parameters(td, gen)
    state = tgan.init_state(tg, td, tgan.GanConfig(**config))
    path = str(tmp_path / "port.ckpt")
    tckpt.save(path, train_state_to_leaves(state), {"epoch": 1})
    loaded, _ = cckpt.load(path, template)
    kernel = tg.state_dict()["01_RefineStage.trunk.02_UpsampleConv.weight"]
    np.testing.assert_array_equal(
        np.asarray(loaded.g_params["01_RefineStage"]["trunk"]
                   ["02_UpsampleConv"]["kernel"]),
        kernel.numpy().transpose(2, 3, 1, 0))
    np.testing.assert_array_equal(
        np.asarray(loaded.g_params["01_RefineStage"]["head"]["bias"]),
        tg.state_dict()["01_RefineStage.head.bias"].numpy())
    # back: catgen's own initial state into the port's
    path = str(tmp_path / "catgen.ckpt")
    cckpt.save(path, template, {"epoch": 1})
    with np.load(path) as z:
        leaves = {k: z[k] for k in z.files if k != "__meta__"}
    train_state_from_leaves(state, leaves)
    want = catgen_to_state_dict(np_tree(template.g_params),
                                np_tree(template.g_state))
    for k, t in tg.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k].numpy(), k)
    assert set(leaves) == set(train_state_to_leaves(state))


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus64")
    write_fixture_dataset(str(root), n=6)
    return str(root)


@pytest.mark.parametrize("scale", [64, 32, 48])
def test_loader_scales_match_catgen(corpus, scale):
    c = CDataset([corpus], scale=scale, seed=3, decoder="pil")
    t = TDataset([corpus], scale=scale, seed=3)
    want = np.asarray(c.load_images(0, 6))
    got = t.load_images(0, 6).numpy()
    assert got.shape == want.shape == (6, scale, scale, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if scale == 64:   # 64px sources at --scale 64: the identity
        np.testing.assert_array_equal(
            got, t.slice_uint8(0, 6).astype(np.float32) / 255.0)


# ---------------------------------------------------------------------------
# the warm start
# ---------------------------------------------------------------------------


@pytest.fixture
def run32(tmp_path):
    """A 32px train-state checkpoint's G leaves (G32up-c, noise 8), as a
    harness writes them, in an ``adversarial.ckpt`` with scale 32."""
    g32 = tmodels.create_G_decoder_upsampling32c((32, 32, 3), 8)
    reset_parameters(g32, torch.Generator().manual_seed(7))
    params, state = state_dict_to_catgen(g32.state_dict())
    leaves = {**tree_to_leaves("g_params", params),
              **tree_to_leaves("g_state", state)}
    path = str(tmp_path / "adversarial.ckpt")
    tckpt.save(path, leaves, {"epoch": 12, "config": {
        "scale": 32, "noise_dim": 8, "colorspace": "rgb"}})
    return path, leaves


def test_warm_start_is_catgens_graft(run32, tmp_path):
    path, leaves = run32
    out = tws.main(["--ckpt", path, "--save", str(tmp_path / "x64"),
                    "--seed", "3"])
    assert os.path.basename(out) == "g_pretrained_3x64x64_nd8.ckpt"
    with np.load(out) as z:
        got = {k: z[k] for k in z.files if k != "__meta__"}
    assert tckpt.load_meta(out)["warmstart_source_epoch"] == 12
    # catgen's graft on the same fresh stack: the same file content
    fresh = tmodels.create_G64_stack(IMG64, 8)
    reset_parameters(fresh, torch.Generator().manual_seed(3))
    params, state = state_dict_to_catgen(fresh.state_dict())
    grafted = cws.graft_base({"params": params, "state": state}, leaves)
    want = tckpt.dict_tree_to_leaves(np_tree(grafted))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    # catgen's pickup template takes the file
    cg = cmodels.G_REGISTRY["g64_stack"](IMG64, 8)
    template = cg.init(jax.random.PRNGKey(0), (1, 8))
    g_vars, _ = cckpt.load(out, template)
    np.testing.assert_array_equal(
        np.asarray(g_vars["params"]["00_G32up_c"]["00_Dense"]["kernel"]),
        leaves[".g_params['00_Dense']['kernel']"])
    assert variables_to_leaves(fresh).keys() == got.keys()


@pytest.mark.parametrize("fault", ["missing", "shape", "scale"])
def test_warm_start_refuses_a_wrong_source(run32, tmp_path, fault):
    path, leaves = run32
    leaves = dict(leaves)
    meta = {"epoch": 1, "config": {"scale": 32, "noise_dim": 8}}
    if fault == "missing":
        del leaves[".g_params['03_UpsampleConv']['bias']"]
    elif fault == "shape":
        leaves[".g_state['04_BatchNorm']['mean']"] = np.zeros(3, np.float32)
    else:
        meta["config"]["scale"] = 64
    tckpt.save(path, leaves, meta)
    error = {"missing": KeyError, "shape": ValueError,
             "scale": SystemExit}[fault]
    with pytest.raises(error):
        tws.main(["--ckpt", path, "--save", str(tmp_path / "x64")])
