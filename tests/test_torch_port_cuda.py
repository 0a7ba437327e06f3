"""The CUDA bilinear sampler (catgen_torch/csrc/bilinear_sample.cu and
bilinear_sample_bwd.cu) on a card: the forward and backward kernels
against their plain PyTorch version, and the wrapper's contract on CUDA
tensors. Every test here needs an NVIDIA GPU and nvcc; on
a machine without a card each one skips. Run them on the card with

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(``--noconftest``: this file needs neither jax nor catgen).

Shapes: the two of the sampling path at a small batch, and edge cases of
the kernel's own arithmetic: one-pixel rows and columns (no second tap),
the switch from one thread per pixel (C < 32) to one per value (C >= 32),
and odd sizes that leave a ragged last block. Coordinates span [-1.2, 1.2]
(inside, outside and clamped). Tolerance: forward atol 1e-5, as in
chip_smoke.py (the library is built with --fmad=false, so the kernel
rounds its lerps as the plain version does); backward 1e-5 + 1e-5 x the
largest gradient, since its sums run in another order.
"""

import numpy as np
import pytest
import torch

from catgen_torch.kernels import bilinear

pytestmark = pytest.mark.cuda

ATOL = 1e-5
BWD_ATOL, BWD_RTOL = 1e-5, 1e-5   # backward: see _bwd_close
SHAPES = [                      # (N, H, W, C, Ho, Wo)
    (2, 32, 32, 3, 32, 32),     # input ST
    (2, 16, 16, 64, 48, 16),    # three branch STs, stacked
    (3, 1, 5, 1, 4, 7),         # one row
    (2, 7, 1, 32, 3, 3),        # one column, first per-value width
    (2, 4, 4, 31, 2, 2),        # last per-pixel width
    (1, 9, 11, 33, 5, 13),      # odd sizes, ragged last block
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    n, h, w, c, ho, wo = shape
    rng = np.random.RandomState(seed)
    img = rng.rand(n, h, w, c).astype(np.float32)
    rows = rng.uniform(-1.2, 1.2, (n, 2, ho * wo)).astype(np.float32)
    return (torch.tensor(img, device=device),
            torch.tensor(rows, device=device), (ho, wo))


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda, shape):
    img, rows, out_hw = _inputs(shape, cuda)
    before = bilinear.LAUNCHES
    got = bilinear.bilinear_sample_rows(img, rows, out_hw)
    torch.cuda.synchronize()
    assert bilinear.LAUNCHES == before + 1
    want = bilinear.bilinear_sample_rows_plain(img, rows, out_hw)
    assert got.shape == want.shape == (shape[0], *out_hw, shape[3])
    assert got.is_cuda
    assert (got - want).abs().max().item() <= ATOL


def test_kernel_is_deterministic(cuda):
    img, rows, out_hw = _inputs(SHAPES[1], cuda, seed=1)
    a = bilinear.launch(img, rows, out_hw)
    b = bilinear.launch(img, rows, out_hw)
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["float64", "cpu_rows"])
def test_cuda_tensors_never_fall_back(cuda, bad):
    img, rows, out_hw = _inputs(SHAPES[0], cuda)
    if bad == "float64":
        img, rows = img.double(), rows.double()
        err = TypeError
    else:
        rows = rows.cpu()
        err = ValueError
    before = bilinear.LAUNCHES
    with pytest.raises(err):
        bilinear.bilinear_sample_rows(img, rows, out_hw)
    assert bilinear.LAUNCHES == before


def _cotangent(shape, device, seed=2):
    n, h, w, c, ho, wo = shape
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.uniform(-1.0, 1.0, (n, ho, wo, c)).astype(
        np.float32), device=device)


def _bwd_close(got, want):
    # the kernels sum over channels and output pixels in another order
    # than autograd's reductions and scatter-adds: f32 rounding only
    assert got.shape == want.shape and got.is_cuda
    err = (got - want).abs().max().item()
    assert err <= BWD_ATOL + BWD_RTOL * want.abs().max().item(), err


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_kernels_match_plain(cuda, shape):
    img, rows, out_hw = _inputs(shape, cuda)
    g = _cotangent(shape, cuda)
    before = (bilinear.DIMG_LAUNCHES, bilinear.DCOORDS_LAUNCHES)
    img.requires_grad_(True)
    rows.requires_grad_(True)
    bilinear.bilinear_sample_rows(img, rows, out_hw).backward(g)
    torch.cuda.synchronize()
    assert (bilinear.DIMG_LAUNCHES, bilinear.DCOORDS_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want_img, want_crd = bilinear.bilinear_sample_rows_backward_plain(
        img, rows, g, out_hw)
    _bwd_close(img.grad, want_img)
    _bwd_close(rows.grad, want_crd)


def test_backward_at_exact_edges(cuda):
    # an identity grid: every border pixel lies exactly on an edge, where
    # the derivative of the clip is 1 (the plain version's torch.clamp)
    n, h, w, c = 2, 8, 8, 32
    gy, gx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    rows = torch.tensor(np.broadcast_to(np.stack([gy.ravel(), gx.ravel()]),
                                        (n, 2, h * w)).astype(np.float32),
                        device=cuda).contiguous()
    img = torch.rand((n, h, w, c), device=cuda)
    g = _cotangent((n, h, w, c, h, w), cuda)
    got = bilinear.launch_dcoords(img, rows, g, (h, w))
    want = bilinear.bilinear_sample_rows_backward_plain(img, rows, g, (h, w))
    _bwd_close(got, want[1])
    assert (got[:, 0][rows[:, 0].abs() == 1.0] != 0).all()


def test_backward_is_deterministic(cuda):
    for shape in SHAPES[:2]:
        img, rows, out_hw = _inputs(shape, cuda, seed=3)
        g = _cotangent(shape, cuda, seed=4)
        first = (bilinear.launch_dimg(img, rows, g, out_hw),
                 bilinear.launch_dcoords(img, rows, g, out_hw))
        again = (bilinear.launch_dimg(img, rows, g, out_hw),
                 bilinear.launch_dcoords(img, rows, g, out_hw))
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_no_image_gradient_launches_no_dimg(cuda):
    img, rows, out_hw = _inputs(SHAPES[0], cuda)
    rows.requires_grad_(True)
    before = (bilinear.DIMG_LAUNCHES, bilinear.DCOORDS_LAUNCHES)
    bilinear.bilinear_sample_rows(img, rows, out_hw).sum().backward()
    torch.cuda.synchronize()
    assert (bilinear.DIMG_LAUNCHES, bilinear.DCOORDS_LAUNCHES) == (
        before[0], before[1] + 1)
    assert rows.grad is not None and img.grad is None
