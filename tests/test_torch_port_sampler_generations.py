"""The grid-layout sampler (catgen_torch/kernels/bilinear_grid.py), which
stands for catgen's v1-v3 sampler generations, and the selectors that
route the spatial transformers to it, on the CPU.

The plain version, forward and VJP, is held against catgen's three TPU
kernels in interpret mode (``bilinear_sample_mxu``, ``_sep`` and
``_batched``) at a small odd shape and at the two shapes D32_st3 gives the
sampler. Tolerances: v1 and v2 compute in f32 as
tests/test_pallas_kernels.py holds them (forward 1e-5; VJP rtol 1e-4, atol
1e-5); v3 rounds its operands to bf16, so it is held at v4's bf16
tolerance (forward rtol 2e-2, atol 1e-2; VJP within 2e-2 of the largest
gradient). Coordinates span [-1.2, 1.2] and never fall exactly on an
edge.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import models as cmodels
from catgen.kernels.pallas_bilinear import bilinear_sample_mxu
from catgen.kernels.pallas_bilinear_v2 import bilinear_sample_sep
from catgen.kernels.pallas_bilinear_v3 import bilinear_sample_batched
from catgen_torch import models as tmodels
from catgen_torch.data.ops import augment_batch
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.kernels import bilinear, bilinear_grid
from catgen_torch.kernels import config as tconfig
from catgen_torch.nn import spatial_transformer as tst

from torch_port_helpers import IMG, np_tree, perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(4, 8, 6, 3, 8, 6),          # small, H != W
          (2, 16, 16, 64, 48, 16),     # D32_st3's three branch STs
          (3, 32, 32, 3, 32, 32)]      # D32_st3's input ST
CATGEN = {"v1": bilinear_sample_mxu, "v2": bilinear_sample_sep,
          "v3": bilinear_sample_batched}
TOL = {"v1": dict(fwd=(1e-5, 1e-5), vjp=(1e-4, 1e-5)),
       "v2": dict(fwd=(1e-5, 1e-5), vjp=(1e-4, 1e-5)),
       "v3": dict(fwd=(2e-2, 1e-2), vjp=None)}


def _inputs(shape, seed):
    n, h, w, c, ho, wo = shape
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, w, c).astype(np.float32),
            rng.uniform(-1.2, 1.2, (n, ho, wo, 2)).astype(np.float32),
            rng.uniform(-0.1, 0.1, (n, ho, wo, c)).astype(np.float32))


def _port_vjp(img, grid, g):
    d_img, d_grid = bilinear_grid.bilinear_sample_grid_backward_plain(
        torch.tensor(img), torch.tensor(grid), torch.tensor(g))
    return d_img.numpy(), d_grid.numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("gen", ["v1", "v2", "v3"])
def test_plain_matches_catgen_generation(gen, shape):
    img, grid, g = _inputs(shape, seed=0)
    fn = CATGEN[gen]
    want, vjp = jax.vjp(lambda a, b: fn(a, b, 0, True), jnp.asarray(img),
                        jnp.asarray(grid))
    got = bilinear_grid.bilinear_sample_grid_plain(torch.tensor(img),
                                                   torch.tensor(grid))
    assert got.shape == shape[:1] + shape[4:] + shape[3:4]
    rtol, atol = TOL[gen]["fwd"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)
    for a, b in zip(_port_vjp(img, grid, g), vjp(jnp.asarray(g))):
        b = np.asarray(b)
        if TOL[gen]["vjp"] is None:
            assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max()
        else:
            rtol, atol = TOL[gen]["vjp"]
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_identity_grid_follows_v1_and_the_rows_version():
    # an identity grid puts every border pixel exactly on an edge, where
    # v1-v4 differentiate the clip as 1 (catgen's XLA sampler: 0.5): the
    # grid version agrees with v1 interpreted and, bit for bit, with the
    # port's v4 rows version
    n, h, w, c = 2, 8, 8, 4
    rng = np.random.RandomState(6)
    img = rng.rand(n, h, w, c).astype(np.float32)
    gy, gx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    grid = np.broadcast_to(np.stack([gy, gx], -1), (n, h, w, 2)).astype(
        np.float32).copy()
    g = rng.uniform(-0.1, 0.1, (n, h, w, c)).astype(np.float32)
    got = _port_vjp(img, grid, g)
    _, vjp = jax.vjp(lambda a, b: bilinear_sample_mxu(a, b, 0, True),
                     jnp.asarray(img), jnp.asarray(grid))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    rows = grid.reshape(n, h * w, 2).transpose(0, 2, 1).copy()
    d_img, d_rows = bilinear.bilinear_sample_rows_backward_plain(
        torch.tensor(img), torch.tensor(rows), torch.tensor(g), (h, w))
    assert np.array_equal(got[0], d_img.numpy())
    assert np.array_equal(got[1], d_rows.numpy().transpose(0, 2, 1).reshape(
        n, h, w, 2))
    assert (got[1][:, 0, :, 0] != 0).all()       # the top edge moves


def test_affine_grid_is_the_kernels_layout():
    # the grid kernel reads (y, x) pairs of a contiguous (N, Ho, Wo, 2)
    # grid; affine_grid makes one, equal to the coordinate rows
    theta = torch.tensor(np.random.RandomState(7).randn(3, 2, 3),
                         dtype=torch.float32)
    grid = tst.affine_grid(theta, 6, 5)
    assert grid.shape == (3, 6, 5, 2) and grid.is_contiguous()
    rows = tst.affine_grid_rows(theta, 6, 5)
    assert torch.equal(grid.reshape(3, 30, 2).permute(0, 2, 1), rows)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    img, grid, _ = _inputs(SHAPES[0], seed=1)
    ti, tg = torch.tensor(img), torch.tensor(grid)
    bilinear_grid.reset_launches()
    for fn in (bilinear_grid.bilinear_sample_grid,
               bilinear_grid.bilinear_sample_mxu,
               bilinear_grid.bilinear_sample_sep,
               bilinear_grid.bilinear_sample_batched):
        assert torch.equal(fn(ti, tg), bilinear_grid.bilinear_sample_grid_plain(
            ti, tg))
    assert sum(bilinear_grid.launches().values()) == 0


@pytest.mark.parametrize("bad", ["dtype", "rank", "batch", "contiguous",
                                 "device"])
def test_launch_checks_inputs(bad):
    # "meta" tensors: every check before the device check runs here
    img = torch.empty((2, 16, 16, 64), device="meta")
    grid = torch.empty((2, 48, 16, 2), device="meta")
    err, match = ValueError, None
    if bad == "dtype":
        img, err = img.double(), TypeError
    elif bad == "rank":
        grid = grid.reshape(2, 768, 2)
    elif bad == "batch":
        grid = torch.empty((3, 48, 16, 2), device="meta")
    elif bad == "contiguous":
        grid = grid.transpose(1, 2)
    else:
        match = "needs CUDA tensors"
    with pytest.raises(err, match=match) as info:
        bilinear_grid.launch(img, grid)
    if bad != "device":
        assert "needs CUDA tensors" not in str(info.value)


def test_selectors_resolve_validate_and_restore():
    assert tconfig.resolve_sampler_impl() == "mxu"        # auto
    assert tconfig.sampler_kernel == "v4"
    assert tconfig.resolve_st_conv_impl() == "split"      # auto
    for setter, bad in ((tconfig.set_sampler_impl, "gathers"),
                        (tconfig.set_sampler_kernel, "v5"),
                        (tconfig.set_st_conv_impl, "joint")):
        with pytest.raises(ValueError, match="not a valid choice"):
            setter(bad)
    with pytest.raises(RuntimeError):
        with tconfig.using(sampler_impl="xla", sampler_kernel="v2",
                           st_conv_impl="fused"):
            assert tconfig.resolve_sampler_impl() == "xla"
            assert tconfig.get_mxu_sampler() is \
                bilinear_grid.bilinear_sample_sep
            raise RuntimeError
    assert (tconfig.sampler_impl, tconfig.sampler_kernel,
            tconfig.st_conv_impl) == ("auto", "v4", "auto")


@pytest.mark.parametrize("var, value", [("CATGEN_SAMPLER_IMPL", "gpu"),
                                        ("CATGEN_SAMPLER_KERNEL", "v0"),
                                        ("CATGEN_ST_CONV", "yes")])
def test_environment_typo_fails_at_import(var, value):
    code = ("import sys\nsys.modules['jax'] = None\n"
            "import catgen_torch.kernels.config\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, **{var: value}),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert f"{var}={value!r} is not a valid choice" in proc.stderr


def test_d32_st3_on_the_grid_routes_matches_catgen(monkeypatch):
    # catgen's v1-v3 route passes no interpret flag to its kernels, so
    # catgen runs its xla route, the same function in f32; the port runs
    # each generation's name (counted by a spy) and bilinear_sample
    from catgen.kernels import config as kconfig

    d = cmodels.create_D32_st3(IMG)
    # jitted: catgen's eager init and apply take ~10 s each here
    dv = np_tree(jax.jit(d.init, static_argnums=1)(jax.random.PRNGKey(2),
                                                   (1,) + IMG))
    perturb(dv, np.random.RandomState(2))
    td = tmodels.create_D32_st3(IMG)
    td.load_state_dict(catgen_to_state_dict(dv["params"], dv["state"]))
    td.eval()
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    monkeypatch.setattr(kconfig, "sampler_impl", "xla")
    want = np.asarray(jax.jit(lambda v, a: d.apply(v, a, train=False)[0])(
        dv, jnp.asarray(x)))
    assert abs(float(want[0, 0] - want[1, 0])) > 1e-3
    calls = []

    def spy(module, name):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a: calls.append(name)
                            or real(*a))

    for name in ("bilinear_sample_mxu", "bilinear_sample_sep",
                 "bilinear_sample_batched"):
        spy(bilinear_grid, name)
    spy(tst, "bilinear_sample")
    routes = [("v1", "mxu", "bilinear_sample_mxu"),
              ("v2", "mxu", "bilinear_sample_sep"),
              ("v3", "mxu", "bilinear_sample_batched"),
              ("v4", "xla", "bilinear_sample")]
    for kernel, impl, name in routes:
        calls.clear()
        with tconfig.using(sampler_impl=impl, sampler_kernel=kernel), \
                torch.no_grad():
            got = td(torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=kernel)
        # the input ST and the three stacked branch STs: two sampler calls
        assert calls == [name, name], calls


def test_augmentation_routes_agree():
    # the v4 rows sampler (default) and the grid route sample the same
    # warp; draws replayed from one seeded generator each time
    from catgen_torch.core.random import Draws

    images = torch.rand((3, 16, 12, 3),
                        generator=torch.Generator().manual_seed(0))
    outs = []
    for route in ({}, dict(sampler_impl="mxu", sampler_kernel="v1"),
                  dict(sampler_impl="xla")):
        with tconfig.using(**route):
            outs.append(augment_batch(
                Draws(torch.Generator().manual_seed(1)), images))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
