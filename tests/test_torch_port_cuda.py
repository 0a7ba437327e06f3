"""The CUDA bilinear sampler (catgen_torch/csrc/bilinear_sample.cu) on a
card: the kernel against its plain PyTorch version, and the wrapper's
contract on CUDA tensors. Every test here needs an NVIDIA GPU and nvcc; on
a machine without a card each one skips. Run them on the card with

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(``--noconftest``: this file needs neither jax nor catgen).

Shapes: the two of the sampling path at a small batch, and edge cases of
the kernel's own arithmetic: one-pixel rows and columns (no second tap),
the switch from one thread per pixel (C < 32) to one per value (C >= 32),
and odd sizes that leave a ragged last block. Tolerance: atol 1e-5, as in
chip_smoke.py; the library is built with --fmad=false, so the kernel
rounds its lerps as the plain version does.
"""

import numpy as np
import pytest
import torch

from catgen_torch.kernels import bilinear

pytestmark = pytest.mark.cuda

ATOL = 1e-5
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


def test_backward_raises(cuda):
    img, rows, out_hw = _inputs(SHAPES[0], cuda)
    img.requires_grad_(True)
    out = bilinear.bilinear_sample_rows(img, rows, out_hw)
    with pytest.raises(NotImplementedError, match="Queue B item 2"):
        out.sum().backward()
