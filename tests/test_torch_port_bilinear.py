"""The port's bilinear sampler (catgen_torch/kernels/bilinear.py) on the
CPU: its plain version, forward and backward, against catgen's XLA
sampler and v4 Pallas kernel, and the wrappers' contract.

The CUDA kernels run only on a card (chip_smoke.py and
test_torch_port_cuda.py hold them against the plain version there); here
the wrapper must take the plain version for CPU tensors and refuse
anything else it cannot launch, and the autograd Function is exercised
with its launch functions stubbed by the plain versions.

Shapes are the two the sampling path gives the sampler, at N=2: the input
ST (32x32x3 -> 32x32, catgen's separable v4 body) and the three branch STs
stacked (16x16x64 -> 48x16, the dense v4 body). Coordinates span
[-1.2, 1.2] so the edge clamps are hit.
"""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen.kernels.pallas_bilinear_v4 import \
    bilinear_sample_rows as v4_sample_rows
from catgen.nn.spatial_transformer import bilinear_sample as jax_sample
from catgen_torch.kernels import bilinear, build
from catgen_torch.nn.spatial_transformer import bilinear_sample

SHAPES = [(2, 32, 32, 3, 32, 32), (2, 16, 16, 64, 48, 16)]


def _inputs(shape, seed=0):
    n, h, w, c, ho, wo = shape
    rng = np.random.RandomState(seed)
    img = rng.rand(n, h, w, c).astype(np.float32)
    rows = rng.uniform(-1.2, 1.2, (n, 2, ho * wo)).astype(np.float32)
    return img, rows


def _grid(rows, ho, wo):
    """(N, 2, P) rows -> catgen's (N, Ho, Wo, 2) coords."""
    return rows.transpose(0, 2, 1).reshape(rows.shape[0], ho, wo, 2)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_catgen_bilinear_sample(shape):
    # same f32 formula on both sides: equal to rounding, atol 1e-5
    n, h, w, c, ho, wo = shape
    img, rows = _inputs(shape)
    want = np.asarray(jax_sample(jnp.asarray(img),
                                 jnp.asarray(_grid(rows, ho, wo))))
    got = bilinear.bilinear_sample_rows(torch.tensor(img), torch.tensor(rows),
                                        (ho, wo))
    assert got.shape == (n, ho, wo, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_catgen_v4_interpret(shape):
    # the TPU kernel rounds its operands to bf16: v4's own tolerance
    # (tests/test_pallas_kernels.py), rtol 2e-2, atol 1e-2
    n, h, w, c, ho, wo = shape
    img, rows = _inputs(shape, seed=1)
    want = np.asarray(v4_sample_rows(jnp.asarray(img), jnp.asarray(rows),
                                     (ho, wo), True))
    got = bilinear.bilinear_sample_rows_plain(torch.tensor(img),
                                              torch.tensor(rows), (ho, wo))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=1e-2)


def test_grid_form_matches_rows_form():
    img, rows = _inputs(SHAPES[1])
    a = bilinear_sample(torch.tensor(img),
                        torch.tensor(_grid(rows, 48, 16)))
    b = bilinear.bilinear_sample_rows_plain(torch.tensor(img),
                                            torch.tensor(rows), (48, 16))
    assert torch.equal(a, b)


def test_plain_version_clamps_a_nan_coordinate_as_the_kernels_do():
    """A NaN coordinate (a diverged run's transform) samples as 0 in pixel
    space does, the kernels' fmaxf(f, 0): no index out of range, and a
    NaN image still reaches the output (the collapse detector's NaN
    signal)."""
    img, rows = _inputs(SHAPES[0])
    nan_rows = rows.copy()
    nan_rows[0, 0, :5] = np.nan            # y of five pixels
    nan_rows[1, 1, 7] = np.nan             # x of one pixel
    zero = rows.copy()
    zero[0, 0, :5] = -1.0                  # pixel 0 in y
    zero[1, 1, 7] = -1.0                   # pixel 0 in x
    got = bilinear.bilinear_sample_rows_plain(
        torch.tensor(img), torch.tensor(nan_rows), (32, 32))
    want = bilinear.bilinear_sample_rows_plain(
        torch.tensor(img), torch.tensor(zero), (32, 32))
    assert torch.equal(got, want)
    nan_img = torch.full((2, 32, 32, 3), float("nan"))
    out = bilinear.bilinear_sample_rows_plain(nan_img, torch.tensor(
        nan_rows), (32, 32))
    assert bool(torch.isnan(out).all())


def test_cpu_tensors_take_plain_version_and_count_no_launch():
    img, rows = _inputs(SHAPES[0])
    before = bilinear.LAUNCHES
    out = bilinear.bilinear_sample_rows(torch.tensor(img), torch.tensor(rows),
                                        (32, 32))
    assert bilinear.LAUNCHES == before
    assert torch.equal(out, bilinear.bilinear_sample_rows_plain(
        torch.tensor(img), torch.tensor(rows), (32, 32)))


def test_non_cpu_tensors_never_fall_back():
    # a tensor that is not on the CPU goes to the kernel or raises; a
    # "meta" tensor stands in for a device the kernel cannot take
    img = torch.empty((2, 16, 16, 64), device="meta")
    rows = torch.empty((2, 2, 768), device="meta")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bilinear.bilinear_sample_rows(img, rows, (48, 16))


@pytest.mark.parametrize("bad", ["dtype", "shape", "rank", "contiguous"])
def test_launch_checks_inputs(bad):
    # "meta" tensors carry shape, dtype and strides but no data: every
    # check runs before the device check and before any CUDA call
    img = torch.empty((2, 16, 16, 64), device="meta")
    rows = torch.empty((2, 2, 768), device="meta")
    out_hw = (48, 16)
    if bad == "dtype":
        img = img.double()
    elif bad == "shape":
        out_hw = (32, 16)
    elif bad == "rank":
        img = img[0]
    else:
        img = img.transpose(1, 2)
    err = TypeError if bad == "dtype" else ValueError
    with pytest.raises(err) as info:
        bilinear.launch(img, rows, out_hw)
    assert "needs CUDA tensors" not in str(info.value)


@pytest.mark.parametrize("needs", [(True, True), (False, True),
                                   (True, False)])
def test_backward_wiring(monkeypatch, needs):
    # the autograd Function on CPU tensors, with the three launch
    # functions stubbed by the plain versions here in the test only: the
    # backward asks for d_img only where the image needs a gradient, and
    # returns gradients of the inputs' shapes and dtypes
    calls = []

    def fwd(img, crd, out_hw):
        calls.append("fwd")
        return bilinear.bilinear_sample_rows_plain(img, crd, out_hw)

    def dimg(img, crd, g, out_hw):
        calls.append("dimg")
        return bilinear.bilinear_sample_rows_backward_plain(
            img, crd, g, out_hw, need_coords=False)[0]

    def dcrd(img, crd, g, out_hw):
        calls.append("dcoords")
        return bilinear.bilinear_sample_rows_backward_plain(
            img, crd, g, out_hw, need_img=False)[1]

    monkeypatch.setattr(bilinear, "launch", fwd)
    monkeypatch.setattr(bilinear, "launch_dimg", dimg)
    monkeypatch.setattr(bilinear, "launch_dcoords", dcrd)
    img, rows = (torch.tensor(a) for a in _inputs(SHAPES[1]))
    img.requires_grad_(needs[0])
    rows.requires_grad_(needs[1])
    out = bilinear._BilinearSampleRows.apply(img, rows, (48, 16))
    g = torch.rand(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(g)
    want = ["fwd"] + ["dimg"] * needs[0] + ["dcoords"] * needs[1]
    assert calls == want
    ref_img, ref_crd = bilinear.bilinear_sample_rows_backward_plain(
        img, rows, g, (48, 16))
    for t, ref, need in ((img, ref_img, needs[0]), (rows, ref_crd, needs[1])):
        if need:
            assert t.grad.shape == t.shape and t.grad.dtype == torch.float32
            assert torch.equal(t.grad, ref)
        else:
            assert t.grad is None


def _cotangent(shape, seed):
    # cotangents of the size a train step passes back (BCE over a batch)
    n, h, w, c, ho, wo = shape
    rng = np.random.RandomState(seed)
    return rng.uniform(-0.1, 0.1, (n, ho, wo, c)).astype(np.float32)


def _port_grads(img, rows, g, out_hw):
    d_img, d_crd = bilinear.bilinear_sample_rows_backward_plain(
        torch.tensor(img), torch.tensor(rows), torch.tensor(g), out_hw)
    return d_img.numpy(), d_crd.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_catgen_vjp(shape):
    # catgen's XLA sampler (its CPU path) under jax.vjp; coordinates in
    # [-1.2, 1.2]: inside, outside (clamped) and never exactly on an edge.
    # f32 on both sides, sums in another order: atol 1e-5
    n, h, w, c, ho, wo = shape
    img, rows = _inputs(shape, seed=2)
    g = _cotangent(shape, seed=3)
    _, vjp = jax.vjp(jax_sample, jnp.asarray(img),
                     jnp.asarray(_grid(rows, ho, wo)))
    want_img, want_grid = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    want_crd = want_grid.reshape(n, ho * wo, 2).transpose(0, 2, 1)
    got_img, got_crd = _port_grads(img, rows, g, (ho, wo))
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_crd, want_crd, rtol=0, atol=1e-5)
    assert (got_crd == 0).any() and (got_crd != 0).mean() > 0.5


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_catgen_v4_interpret(shape):
    # the TPU kernel's _bwd in interpret mode rounds image, g and its
    # weight masks to bf16 (8 bits of mantissa): max abs err within 2e-2
    # of the largest gradient
    n, h, w, c, ho, wo = shape
    img, rows = _inputs(shape, seed=4)
    g = _cotangent(shape, seed=5)
    _, vjp = jax.vjp(lambda a, b: v4_sample_rows(a, b, (ho, wo), True),
                     jnp.asarray(img), jnp.asarray(rows))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    for got, ref in zip(_port_grads(img, rows, g, (ho, wo)), want):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_exact_edge_gradient_follows_v4():
    # an identity grid puts every border pixel exactly on the edge (-1 or
    # +1). There catgen's two paths disagree: jnp.clip's derivative on the
    # bound is 0.5 (XLA bilinear_sample), v4's inclusive masks give 1. The
    # port follows v4, the path that ran on the TPU
    n, h, w, c = 2, 8, 8, 4
    rng = np.random.RandomState(6)
    img = rng.rand(n, h, w, c).astype(np.float32)
    gy, gx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    rows = np.broadcast_to(np.stack([gy.ravel(), gx.ravel()]),
                           (n, 2, h * w)).astype(np.float32).copy()
    g = rng.uniform(-0.1, 0.1, (n, h, w, c)).astype(np.float32)
    _, got = _port_grads(img, rows, g, (h, w))
    _, vjp4 = jax.vjp(lambda a, b: v4_sample_rows(a, b, (h, w), True),
                      jnp.asarray(img), jnp.asarray(rows))
    v4_crd = np.asarray(vjp4(jnp.asarray(g))[1])
    _, vjp = jax.vjp(jax_sample, jnp.asarray(img),
                     jnp.asarray(_grid(rows, h, w)))
    xla_crd = np.asarray(vjp(jnp.asarray(g))[1]).reshape(
        n, h * w, 2).transpose(0, 2, 1)
    edge_y = np.abs(rows[:, 0]) == 1.0             # (n, P)
    assert edge_y.any() and (~edge_y).any()
    np.testing.assert_allclose(got, v4_crd, rtol=0,
                               atol=2e-2 * np.abs(v4_crd).max())
    ratio = got[:, 0][edge_y] / xla_crd[:, 0][edge_y]
    np.testing.assert_allclose(ratio, 2.0, rtol=1e-5)
    np.testing.assert_allclose(got[:, 0][~edge_y], xla_crd[:, 0][~edge_y],
                               rtol=0, atol=1e-6)


def test_build_without_nvcc_raises(monkeypatch):
    from torch.utils import cpp_extension
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_failure_reports_nvcc_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compile failure' >&2\n"
                    "exit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake compile failure"):
        build.build_library()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path()
    src.write_text("// two\n")
    assert build.library_path() != first
    assert build.library_path().parent == build.BUILD_DIR
    assert os.path.basename(first).startswith("libcatgen_torch_")
