"""Joint localization (``CATGEN_JOINT_LOC``, on by default in both
packages) in the port against catgen on the CPU, with its selector.
catgen's selector is set per test with monkeypatch, the port's with
``config.using``; the inputs are made with numpy from a seed and handed to
both packages.

Tolerances, stated per comparison:
  * joint against per-branch in the port, f32 within 2e-5 (catgen's own
    test of the two) and bf16 within 2^-6 of the largest feature
    (test_torch_port_bf16's full-model bound: the per-branch pools sum
    once in f32, catgen's joint pass four times in bf16);
  * the port's joint pass against catgen's, f32 features within 1e-5 of
    the largest and each branch leaf's gradient within 1e-4 of the leaf's
    largest (``assert_grads_close``), bf16 features bit for bit and
    gradients at test_torch_port_bf16's step bounds (0.1 of the leaf plus
    0.05 of the largest);

The train step under each localization is held against catgen's in
tests/test_torch_port_train_full.py (the flagship step, which runs the
joint pass on both sides by default, and its per-branch case).
"""

import functools
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import models as cmodels
from catgen_torch import models as tmodels
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.kernels import config
from catgen_torch.nn import layers as tl
from catgen_torch.nn import spatial_transformer as tst

from test_torch_port_bf16 import (BF16, assert_bf16_close,
                                  assert_bf16_grads_close, f32)
from torch_port_helpers import IMG, assert_grads_close, np_tree, perturb

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, BF16)}


def _port(a, dtype, grad=False):
    """A numpy or JAX array as a port tensor of ``dtype``."""
    t = torch.tensor(f32(a)).to(dtype)
    return t.requires_grad_(True) if grad else t


# ---------------------------------------------------------------------------
# the selectors
# ---------------------------------------------------------------------------


def _fresh_config():
    """A private copy of the port's config module, read from the
    environment as it is now (the shared module stays as it is)."""
    spec = importlib.util.spec_from_file_location("_fresh_config",
                                                  config.__file__)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_selectors_have_catgens_names_values_and_defaults(monkeypatch):
    from catgen.kernels import config as kconfig
    assert config.joint_loc is kconfig.joint_loc is True
    with config.using(joint_loc=False):
        assert config.joint_loc is False
    assert config.joint_loc is True
    for value, on in (("1", True), ("0", False), ("true", False)):
        monkeypatch.setenv("CATGEN_JOINT_LOC", value)
        assert _fresh_config().joint_loc is on, value


# ---------------------------------------------------------------------------
# joint localization
# ---------------------------------------------------------------------------

BRANCH = (4, 16, 16, 64)          # D32_st3's FusedSTBranches input, batch 4


def _branches(model):
    return next(m for m in model.children()
                if type(m).__name__ == "FusedSTBranches")


@functools.lru_cache(maxsize=1)
def _catgen_branch_block():
    """catgen's D32_st3 FusedSTBranches and its perturbed variables (the
    block alone: initialising all of D eagerly takes seconds)."""
    block = next(layer for layer in cmodels.create_D32_st3(IMG).layers
                 if type(layer).__name__ == "FusedSTBranches")
    variables = np_tree(jax.jit(lambda k: block.init(k, BRANCH))(
        jax.random.PRNGKey(1)))
    perturb(variables, np.random.RandomState(1))
    return block, variables


def _branch_block():
    """catgen's D32_st3 FusedSTBranches, its perturbed variables and the
    port's block holding them, in eval."""
    c_block, variables = _catgen_branch_block()
    block = _branches(tmodels.create_D32_st3(IMG)).eval()
    block.load_state_dict(catgen_to_state_dict(variables["params"],
                                               variables["state"]),
                          strict=True)
    return c_block, variables, block


def _loc_params(block):
    return {k: v for k, v in block.named_parameters() if k.startswith("loc")}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_joint_loc_matches_per_branch(dtype):
    _, _, block = _branch_block()
    x = _port(np.random.RandomState(2).randn(*BRANCH), DTYPES[dtype][0])
    joint = block._joint_loc_features(x)
    with config.using(joint_loc=False):
        per = [getattr(block, f"loc{i}")(x) for i in range(3)]
    for got, want in zip(joint, per):
        assert got.dtype == want.dtype == x.dtype
        if dtype == "f32":
            np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5,
                                       atol=2e-5)
        else:
            assert_bf16_close(got, want, 0, 2.0 ** -6, "bf16 joint")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_joint_loc_matches_catgens_joint_pass(dtype):
    c_block, variables, block = _branch_block()
    t_dtype, j_dtype = DTYPES[dtype]
    rng = np.random.RandomState(3)
    x = rng.randn(*BRANCH).astype(np.float32)
    cots = [rng.randn(BRANCH[0], 64).astype(np.float32) for _ in range(3)]
    xj = jnp.asarray(x, j_dtype)

    def feats(params):
        return c_block._joint_loc_features(
            {"params": params, "state": variables["state"]}, xj)

    want, vjp = jax.vjp(feats, variables["params"])
    (c_grads,) = vjp([jnp.asarray(c, j_dtype) for c in cots])
    got = block._joint_loc_features(_port(xj, t_dtype))
    sum((g.float() * torch.tensor(c)).sum()
        for g, c in zip(got, cots)).backward()
    c_grads = {k: v.numpy() for k, v in catgen_to_state_dict(
        np_tree(c_grads), {}).items() if k.startswith("loc")}
    t_grads = {k: p.grad.numpy() for k, p in _loc_params(block).items()}
    assert set(t_grads) == set(c_grads) and len(c_grads) == 18
    for g, w in zip(got, want):
        assert g.dtype == t_dtype and w.dtype == j_dtype
        if dtype == "f32":
            np.testing.assert_allclose(f32(g), f32(w), rtol=0,
                                       atol=1e-5 * np.abs(f32(w)).max())
        else:
            assert_bf16_close(g, w, 0, 0.0, "bf16 features")
    if dtype == "f32":
        assert_grads_close(t_grads, c_grads)
    else:
        assert_bf16_grads_close(t_grads, c_grads)


_LOCALIZATION_NET = tst._localization_net


def _block_with(monkeypatch, edit):
    """D32_st3's branch block built from localization nets that ``edit``
    changes after ``_localization_net`` makes them."""
    def make(*args):
        net = _LOCALIZATION_NET(*args)
        edit(net)
        return net

    monkeypatch.setattr(tst, "_localization_net", make)
    return _branches(tmodels.create_D32_st3(IMG)).eval()


def test_loc_layout_refuses_another_pattern(monkeypatch):
    _, _, block = _branch_block()
    names, slope = block._layout            # derived once, at construction
    assert names == {"conv1": "01_Conv", "conv2": "03_Conv",
                     "dense": "07_Dense"} and slope == 1.0 / 3.0
    x = torch.zeros((1, 16, 16, 64))
    block = _block_with(monkeypatch, lambda net: setattr(
        net, "02_LeakyReLU", tl.Sigmoid()))
    passes = tst.JOINT_LOC_PASSES
    with pytest.raises(NotImplementedError, match="layer pattern"):
        block(x)
    assert tst.JOINT_LOC_PASSES == passes
    with config.using(joint_loc=False):           # per branch: runs
        assert block(x).shape == (1, 8, 8, 3 * 64 + 128)
    block = _block_with(monkeypatch, lambda net: setattr(
        net, "03_Conv", tl.Conv(16, 16, (5, 5))))
    with pytest.raises(NotImplementedError, match="3x3"):
        block(x)


@pytest.mark.parametrize("name,img", [("d32_st3", (32, 32, 3)),
                                      ("d16_st3", (16, 16, 3))])
def test_st3_models_take_the_joint_pass_by_default(name, img):
    d = tmodels.D_REGISTRY[name](img).eval()
    x = torch.rand((2,) + img)
    before = tst.JOINT_LOC_PASSES
    with torch.no_grad():
        d(x)
        assert tst.JOINT_LOC_PASSES == before + 1
        with config.using(joint_loc=False):
            d(x)
    assert tst.JOINT_LOC_PASSES == before + 1



