"""The CUDA kernels on a card: the bilinear sampler (catgen_torch/csrc/
bilinear_sample.cu and bilinear_sample_bwd.cu) at coordinate rows, the
upsample-conv kernels (upsample_conv.cu, upsample_conv_bwd.cu), the
same sampler kernels on an (N, Ho, Wo, 2) grid and the fused ST-conv
kernel (st_conv.cu), and, at the end of the file, the dCK kernel's four
fold/transform variants, the bf16 block's transform and fold passes and
the bf16 dCK on wgmma, the choice between the d_coords kernels, the
staged sampler forward and the choice between the forward kernels, the
3xTF32 upsample-conv forward at ragged shapes, the per-sample, gather and
per-channel d_img kernels, the per-quad sampler forward and the 3xTF32
dX, forward and backward, against their plain PyTorch versions, and the
wrappers' contract on CUDA tensors; last, the bf16 per-quad d_coords and
the f32 tiled ST-conv, each bit for bit against the kernel it replaced. Every test here needs an NVIDIA GPU
and nvcc; on a machine without a card each one skips. Run them on the
card with

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(``--noconftest``: this file needs neither jax nor catgen).

Sampler shapes: the two of the sampling path at a small batch, and edge
cases of the kernel's own arithmetic: one-pixel rows and columns (no
second tap), the switch from one thread per pixel (C < 32) to one per
value (C >= 32), and odd sizes that leave a ragged last block. Coordinates span [-1.2, 1.2]
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


@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_nan_coordinates_sample_as_the_plain_version(cuda, layout):
    """A NaN coordinate clamps to pixel 0 in the kernel (fmaxf) and in the
    plain version alike: the same bits, no access out of range."""
    from catgen_torch.kernels import bilinear_grid

    img, rows, out_hw = _inputs(SHAPES[0], cuda, seed=5)
    rows[0, 0, :5] = float("nan")
    rows[1, 1, 7] = float("nan")
    if layout == "rows":
        got = bilinear.launch(img, rows, out_hw)
    else:
        grid = rows.permute(0, 2, 1).reshape(img.shape[0], *out_hw, 2)
        got = bilinear_grid.launch(img, grid.contiguous())
    torch.cuda.synchronize()
    want = bilinear.bilinear_sample_rows_plain(img, rows, out_hw)
    assert torch.equal(got, want)


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


# ---------------------------------------------------------------------------
# the upsample-conv kernels (csrc/upsample_conv.cu, upsample_conv_bwd.cu)
# against their plain versions (kernels/fused_upsample_conv.py). TF32 off
# for the plain version's cuDNN convolutions. Tolerances: y and dx within
# 1e-5 of the largest plain value (sums of at most a few thousand
# products, in another order); the stats, dweight, dbias, dscale, dshift
# and dalpha within 1e-4 (sums over every output pixel).
# ---------------------------------------------------------------------------

from catgen_torch.kernels import config as upconfig  # noqa: E402
from catgen_torch.kernels import fused_upsample_conv as fuc  # noqa: E402

UP_TIGHT, UP_LOOSE = 1e-5, 1e-4
UP_SHAPES = [                  # (N, H, W, Cin, Cout, k)
    (2, 4, 5, 9, 11, 3),       # odd sizes, one ragged tile
    (3, 5, 3, 17, 70, 5),      # Cout over one tile, ragged
    (1, 3, 4, 65, 33, 7),      # Cin over one tile, k = 7
    (2, 4, 4, 512, 512, 3),    # G32up-c stage 1
    (2, 16, 16, 256, 128, 5),  # G32up-c stage 3; G32up stage 2
    (3, 4, 4, 128, 256, 5),    # G16up stage 1: k5 from 4x4, Cin 128
    (2, 8, 8, 256, 128, 5),    # G16up stage 2
    (2, 8, 8, 128, 256, 5),    # G32up stage 1
]


@pytest.fixture
def f32_cuda(cuda):
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = tf32


def _up_inputs(shape, device, seed=0, alpha_n=1):
    n, h, w, cin, cout, k = shape
    r = np.random.RandomState(seed)
    f = np.float32
    t = lambda a: torch.tensor(a.astype(f), device=device)  # noqa: E731
    return dict(
        x=t(r.randn(n, h, w, cin)),
        weight=t(r.randn(cout, cin, k, k) / np.sqrt(cin * k * k)),
        bias=t(r.randn(cout) * 0.1), scale=t(r.rand(cin) + 0.5),
        shift=t(r.randn(cin) * 0.3), alpha=t(r.rand(alpha_n) * 0.5),
        gy=t(r.randn(n, 2 * h, 2 * w, cout)), gs1=t(r.randn(cout) * 0.01),
        gs2=t(r.randn(cout) * 0.01))


def _up_close(got, want, rel, name):
    assert got.shape == want.shape and got.is_cuda, name
    err = (got - want).abs().max().item()
    bound = rel * max(want.abs().max().item(), 1e-6)
    assert err <= bound, f"{name}: {err} > {bound}"


@pytest.mark.parametrize("shape", UP_SHAPES)
@pytest.mark.parametrize("alpha", ["scalar", "channelwise"])
def test_upsample_forward_kernel_matches_plain(f32_cuda, shape, alpha):
    cout = shape[4]
    v = _up_inputs(shape, f32_cuda, alpha_n=1 if alpha == "scalar" else cout)
    before = fuc.LAUNCHES
    got = fuc.upsample2_conv_fused(v["x"], v["weight"], v["bias"],
                                   v["alpha"])
    torch.cuda.synchronize()
    assert fuc.LAUNCHES == before + 1
    want = fuc.block_plain(v["x"], v["weight"], v["bias"],
                           prelu_alpha=v["alpha"])
    _up_close(got, want, UP_TIGHT, "y")


@pytest.mark.parametrize("shape", UP_SHAPES)
@pytest.mark.parametrize("with_stats", [True, False])
def test_upsample_block_kernel_matches_plain(f32_cuda, shape, with_stats):
    v = _up_inputs(shape, f32_cuda, seed=1, alpha_n=shape[3])
    args = (v["x"], v["weight"], v["bias"], v["scale"], v["shift"],
            v["alpha"])
    before = fuc.BLOCK_LAUNCHES
    got = fuc.upsample2_conv_block_fused(*args, with_stats=with_stats)
    torch.cuda.synchronize()
    assert fuc.BLOCK_LAUNCHES == before + 1
    y = fuc.block_plain(v["x"], v["weight"], v["bias"], v["scale"],
                        v["shift"], v["alpha"])
    if not with_stats:
        _up_close(got, y, UP_TIGHT, "y")
        return
    for name, a, b, rel in zip(("y", "s1", "s2"), got,
                               (y, *fuc.stats_plain(y)),
                               (UP_TIGHT, UP_LOOSE, UP_LOOSE)):
        _up_close(a, b, rel, name)


@pytest.mark.parametrize("shape", UP_SHAPES)
def test_upsample_backward_kernels_match_plain(f32_cuda, shape):
    v = _up_inputs(shape, f32_cuda, seed=2)
    before = (fuc.DX_LAUNCHES, fuc.DCK_LAUNCHES)
    got = fuc.upsample2_conv_backward(v["x"], v["weight"], v["gy"])
    torch.cuda.synchronize()
    assert (fuc.DX_LAUNCHES, fuc.DCK_LAUNCHES) == (before[0] + 1,
                                                   before[1] + 1)
    want = fuc.upsample2_conv_backward_plain(v["x"], v["weight"], v["gy"])
    for name, a, b, rel in zip(("dx", "dweight", "dbias"), got, want,
                               (UP_TIGHT, UP_LOOSE, UP_LOOSE)):
        _up_close(a, b, rel, name)


@pytest.mark.parametrize("shape", UP_SHAPES)
@pytest.mark.parametrize("alpha", ["scalar", "channelwise"])
def test_block_backward_kernels_match_plain(f32_cuda, shape, alpha):
    v = _up_inputs(shape, f32_cuda, seed=3,
                   alpha_n=1 if alpha == "scalar" else shape[3])
    y = fuc.upsample2_conv_block_fused(v["x"], v["weight"], v["bias"],
                                       v["scale"], v["shift"], v["alpha"],
                                       with_stats=False)
    args = (v["x"], v["scale"], v["shift"], v["alpha"], v["weight"], y,
            v["gy"], v["gs1"], v["gs2"])
    before = (fuc.BLOCK_DX_LAUNCHES, fuc.BLOCK_DCK_LAUNCHES)
    got = fuc.fused_block_backward(*args)
    torch.cuda.synchronize()
    assert (fuc.BLOCK_DX_LAUNCHES, fuc.BLOCK_DCK_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = fuc.fused_block_backward_plain(*args[:5], v["bias"], *args[5:])
    for name, a, b, rel in zip(
            ("dx", "dscale", "dshift", "dalpha", "dweight", "dbias"), got,
            want, (UP_TIGHT,) + (UP_LOOSE,) * 5):
        _up_close(a, b, rel, name)


def test_upsample_kernels_are_deterministic(f32_cuda):
    v = _up_inputs(UP_SHAPES[4], f32_cuda, seed=4, alpha_n=UP_SHAPES[4][3])
    y = fuc.upsample2_conv_block_fused(v["x"], v["weight"], v["bias"],
                                       v["scale"], v["shift"], v["alpha"])
    runs = []
    for _ in range(2):
        runs.append(
            list(fuc.upsample2_conv_block_fused(
                v["x"], v["weight"], v["bias"], v["scale"], v["shift"],
                v["alpha"]))
            + list(fuc.upsample2_conv_backward(v["x"], v["weight"], v["gy"]))
            + list(fuc.fused_block_backward(
                v["x"], v["scale"], v["shift"], v["alpha"], v["weight"],
                y[0], v["gy"], v["gs1"], v["gs2"])))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "cpu_bias",
                                 "bad_scale"])
def test_upsample_cuda_tensors_never_fall_back(f32_cuda, bad):
    v = _up_inputs(UP_SHAPES[0], f32_cuda, alpha_n=UP_SHAPES[0][3])
    err = ValueError
    if bad == "float64":
        v["x"], err = v["x"].double(), TypeError
    elif bad == "non_contiguous":
        v["x"] = v["x"].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "cpu_bias":
        v["bias"] = v["bias"].cpu()
    else:
        v["scale"] = v["scale"][:-1]
    before = fuc.launches()
    with pytest.raises(err):
        fuc.upsample2_conv_block_fused(v["x"], v["weight"], v["bias"],
                                       v["scale"], v["shift"], v["alpha"])
    assert fuc.launches() == before


def test_upsample_route_selects_the_kernels(f32_cuda):
    from catgen_torch.kernels.upsample_conv import UpsampleConv

    layer = UpsampleConv(9, 11).to(f32_cuda)
    x = _up_inputs(UP_SHAPES[0], f32_cuda)["x"].requires_grad_()
    fuc.reset_launches()
    layer(x).sum().backward()                   # default: collapsed, cuDNN
    assert sum(fuc.launches().values()) == 0
    with upconfig.using(upsample_impl="pallas", upsample_bwd="pallas"):
        layer(x).sum().backward()
    assert fuc.launches() == dict(fuc.launches(), LAUNCHES=1, DX_LAUNCHES=1,
                                  DCK_LAUNCHES=1)
    assert sum(fuc.launches().values()) == 3


# ---------------------------------------------------------------------------
# the sampler kernels on an (N, Ho, Wo, 2) grid (kernels/bilinear_grid.py):
# the same tolerances as the rows layout above; d_coords comes back as
# (dy, dx) pairs and equals the rows layout's bit for bit
# ---------------------------------------------------------------------------

from catgen_torch.kernels import bilinear_grid  # noqa: E402
from catgen_torch.kernels import st_conv  # noqa: E402

GRID_SHAPES = [                 # (N, H, W, C, Ho, Wo)
    (2, 32, 32, 3, 32, 32),     # input ST
    (2, 16, 16, 64, 48, 16),    # three branch STs, stacked
    (3, 1, 5, 3, 4, 7),         # one row
    (2, 7, 1, 31, 3, 3),        # one column, last per-pixel width
    (2, 4, 4, 32, 2, 2),        # first per-value width
    (1, 9, 11, 33, 5, 13),      # odd sizes, ragged last block
]


def _grid_inputs(shape, device, seed=0):
    img, rows, (ho, wo) = _inputs(shape, device, seed)
    grid = rows.permute(0, 2, 1).reshape(shape[0], ho, wo, 2).contiguous()
    return img, grid


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_grid_kernels_match_plain(cuda, shape):
    img, grid = _grid_inputs(shape, cuda)
    g = _cotangent(shape, cuda)
    bilinear_grid.reset_launches()
    img.requires_grad_(True)
    grid.requires_grad_(True)
    out = bilinear_grid.bilinear_sample_grid(img, grid)
    out.backward(g)
    torch.cuda.synchronize()
    assert bilinear_grid.launches() == dict(
        bilinear_grid.launches(), LAUNCHES=1, DCOORDS_LAUNCHES=1,
        DIMG_LAUNCHES=1)
    want = bilinear_grid.bilinear_sample_grid_plain(img, grid)
    assert out.shape == want.shape and out.is_cuda
    assert (out - want).abs().max().item() <= ATOL
    want_img, want_grid = bilinear_grid.bilinear_sample_grid_backward_plain(
        img, grid, g)
    _bwd_close(img.grad, want_img)
    _bwd_close(grid.grad, want_grid)
    rows = grid.detach().reshape(shape[0], -1, 2).permute(0, 2, 1)
    d_rows = bilinear.launch_dcoords(img.detach(), rows.contiguous(), g,
                                     shape[4:])
    assert torch.equal(grid.grad, d_rows.permute(0, 2, 1).reshape(
        grid.shape))


def test_grid_kernels_are_deterministic(cuda):
    img, grid = _grid_inputs(GRID_SHAPES[1], cuda, seed=5)
    g = _cotangent(GRID_SHAPES[1], cuda, seed=6)
    runs = [(bilinear_grid.launch(img, grid),
             bilinear_grid.launch_dimg(img, grid, g),
             bilinear_grid.launch_dcoords(img, grid, g)) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("gen, counter", [
    ("bilinear_sample_mxu", "V1_LAUNCHES"),
    ("bilinear_sample_sep", "V2_LAUNCHES"),
    ("bilinear_sample_batched", "V3_LAUNCHES")])
def test_generation_names_count_their_launches(cuda, gen, counter):
    img, grid = _grid_inputs(GRID_SHAPES[0], cuda)
    bilinear_grid.reset_launches()
    out = getattr(bilinear_grid, gen)(img, grid)
    torch.cuda.synchronize()
    assert bilinear_grid.launches() == dict(
        dict.fromkeys(bilinear_grid.COUNTERS, 0), LAUNCHES=1, **{counter: 1})
    assert torch.equal(out, bilinear_grid.launch(img, grid))


@pytest.mark.parametrize("bad", ["float64", "cpu_grid", "misaligned",
                                 "non_contiguous"])
def test_grid_cuda_tensors_never_fall_back(cuda, bad):
    img, grid = _grid_inputs(GRID_SHAPES[0], cuda)
    err = ValueError
    if bad == "float64":
        img, grid, err = img.double(), grid.double(), TypeError
    elif bad == "cpu_grid":
        grid = grid.cpu()
    elif bad == "misaligned":
        # one float in: each (y, x) pair would straddle 8-byte words
        flat = torch.empty(grid.numel() + 1, device=cuda)
        grid = flat[1:].view(grid.shape).copy_(grid)
    else:
        grid = grid.transpose(1, 2)
    bilinear_grid.reset_launches()
    with pytest.raises(err):
        bilinear_grid.bilinear_sample_mxu(img, grid)
    assert sum(bilinear_grid.launches().values()) == 0


# ---------------------------------------------------------------------------
# the fused ST-conv kernel (kernels/st_conv.py). Tolerances as chip_smoke.py
# holds it: out and z within 1e-5 of the largest plain value (27-term sums
# in another order), samp within 1e-5 absolute. The backward (the
# Function) within 1e-4 of each gradient's largest: a z within rounding of
# 0 can take the other side of the PReLU's kink, which moves dalpha, dbias
# and what follows by that element's cotangent.
# ---------------------------------------------------------------------------

ST_SHAPES = [                   # (N, H, W, C, F)
    (3, 32, 32, 3, 64),         # D32_st3's prefix
    (2, 12, 16, 3, 31),         # H != W, F under a warp
    (2, 9, 7, 3, 33),           # odd sizes, F over a warp, ragged band
    (1, 5, 6, 1, 70),           # one channel, F over one x-block
    (2, 8, 8, 5, 16),           # C over 4: weights from global memory
]


def _st_inputs(shape, device, seed=0, channelwise=False):
    n, h, w, c, f = shape
    r = np.random.RandomState(seed)
    ang = r.uniform(-0.5, 0.5, n)
    scale = r.uniform(0.8, 1.2, n)
    cos, sin = np.cos(ang) * scale, np.sin(ang) * scale
    theta = np.stack([np.stack([cos, -sin, r.uniform(-0.2, 0.2, n)], -1),
                      np.stack([sin, cos, r.uniform(-0.2, 0.2, n)], -1)], 1)
    t = lambda a: torch.tensor(np.asarray(a, np.float32),  # noqa: E731
                               device=device)
    return (t(r.rand(n, h, w, c)), t(theta), t(r.randn(3, 3, c, f) * 0.3),
            t(r.randn(f) * 0.1), t(r.rand(f if channelwise else 1) * 0.5))


def _st_close(got, want, tol, name):
    assert got.shape == want.shape and got.is_cuda, name
    err = (got - want).abs().max().item()
    assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.parametrize("shape", ST_SHAPES)
@pytest.mark.parametrize("channelwise", [False, True])
def test_st_conv_kernel_matches_plain(f32_cuda, shape, channelwise):
    args = _st_inputs(shape, f32_cuda, channelwise=channelwise)
    before = st_conv.LAUNCHES
    out, samp, z = st_conv.launch(*args)
    light = st_conv.launch(*args, save=False)
    torch.cuda.synchronize()
    assert st_conv.LAUNCHES == before + 2
    assert light[1] is None and light[2] is None
    assert torch.equal(light[0], out)
    want = st_conv._forward_plain(*args)
    for name, a, b, tol in zip(("out", "samp", "z"), (out, samp, z), want,
                               (None, 1e-5, None)):
        _st_close(a, b.contiguous(), tol or 1e-5 * b.abs().max().item(),
                  name)


def test_st_conv_kernel_is_deterministic(f32_cuda):
    args = _st_inputs(ST_SHAPES[0], f32_cuda, seed=1, channelwise=True)
    first, again = st_conv.launch(*args), st_conv.launch(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("image_grad", [True, False])
def test_st_conv_backward_matches_plain(f32_cuda, image_grad):
    args = [a.requires_grad_(i > 0 or image_grad) for i, a in
            enumerate(_st_inputs(ST_SHAPES[1], f32_cuda, seed=2,
                                 channelwise=True))]
    g = torch.randn((2, 12, 16, 31), device=f32_cuda,
                    generator=torch.Generator(f32_cuda).manual_seed(3))
    before = (bilinear.DCOORDS_LAUNCHES, bilinear.DIMG_LAUNCHES)
    got = torch.autograd.grad(st_conv.st_conv_prelu(*args),
                              [a for a in args if a.requires_grad], g)
    torch.cuda.synchronize()
    assert (bilinear.DCOORDS_LAUNCHES, bilinear.DIMG_LAUNCHES) == (
        before[0] + 1, before[1] + image_grad)
    want = torch.autograd.grad(st_conv.st_conv_prelu_plain(*args),
                               [a for a in args if a.requires_grad], g)
    for a, b in zip(got, want):
        _st_close(a, b, 1e-4 * b.abs().max().item(), "gradient")


@pytest.mark.parametrize("bad", ["cpu_theta", "non_contiguous", "float64"])
def test_st_conv_cuda_tensors_never_fall_back(f32_cuda, bad):
    img, theta, kernel, bias, alpha = _st_inputs(ST_SHAPES[1], f32_cuda)
    err = ValueError
    if bad == "cpu_theta":
        theta = theta.cpu()
    elif bad == "non_contiguous":
        img = img.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        img, err = img.double(), TypeError
    before = st_conv.LAUNCHES
    with pytest.raises(err):
        st_conv.st_conv_prelu(img, theta, kernel, bias, alpha)
    assert st_conv.LAUNCHES == before


def test_st_conv_route_launches_the_kernel(f32_cuda):
    from catgen_torch.core.module import reset_parameters
    from catgen_torch.nn import layers
    from catgen_torch.nn.spatial_transformer import (FusedSTConvPReLU,
                                                     SpatialTransformer)

    prefix = FusedSTConvPReLU(SpatialTransformer((32, 32, 3), True, False,
                                                 False),
                              layers.Conv(3, 64, (3, 3)), layers.PReLU())
    reset_parameters(prefix, torch.Generator().manual_seed(0))
    prefix = prefix.to(f32_cuda)
    x = torch.rand((2, 32, 32, 3), device=f32_cuda)
    before = (st_conv.LAUNCHES, bilinear.LAUNCHES)
    split = prefix(x)
    with upconfig.using(st_conv_impl="fused"):
        fused = prefix(x)
    torch.cuda.synchronize()
    assert (st_conv.LAUNCHES, bilinear.LAUNCHES) == (before[0] + 1,
                                                     before[1] + 1)
    assert (fused - split).abs().max().item() <= \
        1e-5 * split.abs().max().item()


# ---------------------------------------------------------------------------
# the dCK kernel (3xTF32 on the tensor cores) in all four of its variants:
# the cotangent fold (g + gs1 + 2 y gs2) and the input transform
# prelu(x * scale + shift) each on or off; the routes run both or neither.
# dweight and dbias within 1e-4 of their largest plain value, as above.
# ---------------------------------------------------------------------------

VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
# UP_SHAPES, and a shape whose pixels (5 * 9 * 13 = 585) are a multiple
# neither of the 32-pixel step nor of the split's range (2 splits of 320)
DCK_SHAPES = UP_SHAPES + [(5, 9, 13, 12, 20, 3)]


def _dck_run(v, fold, transform):
    """(dweight, dbias or None) from the dCK kernel."""
    k = v["weight"].shape[2]
    y = v["y"] if fold else None
    gs = torch.stack([v["gs1"], v["gs2"]]) if fold else None
    tr = ({"in_scale": v["scale"], "in_shift": v["shift"],
           "in_alpha": v["alpha"].expand(v["x"].shape[3]).contiguous()}
          if transform else {})
    out = fuc._launch_dck(v["x"], v["weight"], v["gy"], y, gs, **tr)
    dck, db = out if fold else (out, None)
    return fuc.dweight_from_dck(dck, k, k), db


def _dck_plain(v, fold, transform, halo=None):
    """(dweight, dbias) of the plain block: autograd through the transform
    (if any) and upsample2_conv, for the folded cotangent (if any). With
    ``halo`` (Cin,), the transformed image is padded with it instead of
    zeros: what a kernel that transforms its zero halo would compute."""
    g = (v["gy"] + v["gs1"] + 2.0 * v["y"] * v["gs2"]) if fold else v["gy"]
    sc, sh, al = v["scale"], v["shift"], v["alpha"]

    def forward(w_):
        x = fuc.in_transform(v["x"], sc, sh, al) if transform else v["x"]
        if halo is None:
            return fuc.upsample2_conv(x, w_)
        r = w_.shape[2] // 2
        up = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
        n, h2, w2, c = up.shape
        pad = halo.expand(n, h2 + 2 * r, w2 + 2 * r, c).clone()
        pad[:, r:r + h2, r:r + w2] = up
        return torch.nn.functional.conv2d(
            pad.permute(0, 3, 1, 2), w_).permute(0, 2, 3, 1)

    return fuc._vjp(forward, (v["weight"],), (True,), g)[0], g.sum((0, 1, 2))


def _dck_inputs(shape, device, seed, shift=None):
    v = _up_inputs(shape, device, seed=seed, alpha_n=1)
    if shift is not None:
        v["shift"] = torch.full_like(v["shift"], shift)
    n, h, w, _, cout, _ = shape
    v["y"] = torch.randn((n, 2 * h, 2 * w, cout), device=device,
                         generator=torch.Generator(device).manual_seed(seed))
    return v


@pytest.mark.parametrize("shape", DCK_SHAPES)
@pytest.mark.parametrize("fold, transform", VARIANTS)
def test_dck_variants_match_plain(f32_cuda, shape, fold, transform):
    v = _dck_inputs(shape, f32_cuda, seed=5)
    dw, db = _dck_run(v, fold, transform)
    torch.cuda.synchronize()
    want_dw, want_db = _dck_plain(v, fold, transform)
    _up_close(dw, want_dw, UP_LOOSE, "dweight")
    if fold:
        _up_close(db, want_db, UP_LOOSE, "dbias")
    else:
        assert db is None


def test_dck_ragged_shape_splits_its_pixels(f32_cuda):
    from catgen_torch.kernels.build import load_library

    n, h, w, cin, cout, k = DCK_SHAPES[-1]
    kp = (k + 1) // 2
    splits = load_library().catgen_upsample_conv_dck_splits(
        n, h, w, cin, cout, kp, kp)
    pixels = n * h * w
    chunk = (-(-pixels // splits) + 31) // 32 * 32     # the kernel's range
    assert splits > 1 and pixels % 32
    assert (pixels - (splits - 1) * chunk) % 32    # a ragged last range


@pytest.mark.parametrize("fold", [False, True])
def test_dck_halo_is_zero_after_the_transform(f32_cuda, fold):
    # shift 4: every halo value would be prelu(4) = 4, not 0; the plain
    # version with that halo misses the tolerance by far, the kernel not
    shape = (2, 4, 5, 16, 12, 3)
    v = _dck_inputs(shape, f32_cuda, seed=6, shift=4.0)
    dw, _ = _dck_run(v, fold, True)
    want, _ = _dck_plain(v, fold, True)
    halo = fuc.in_transform(torch.zeros(shape[3], device=f32_cuda),
                            v["scale"], v["shift"], v["alpha"])
    wrong, _ = _dck_plain(v, fold, True, halo=halo)
    bound = UP_LOOSE * want.abs().max().item()
    assert (wrong - want).abs().max().item() > 100 * bound
    _up_close(dw, want, UP_LOOSE, "dweight")


@pytest.mark.parametrize("fold, transform", [(False, False), (True, True)])
def test_dck_repeats_are_bit_identical(f32_cuda, fold, transform):
    v = _dck_inputs(UP_SHAPES[4], f32_cuda, seed=7)
    first, again = _dck_run(v, fold, transform), _dck_run(v, fold, transform)
    assert torch.equal(first[0], again[0])
    if fold:
        assert torch.equal(first[1], again[1])


# ---------------------------------------------------------------------------
# the staged d_coords kernel (the sample's image in shared memory) and the
# choice between the three d_coords kernels
# ---------------------------------------------------------------------------

STAGED_SHAPES = [(2, 16, 16, 64, 48, 16), (2, 8, 8, 128, 8, 8),
                 (2, 8, 8, 64, 24, 8)]     # D32_st3's branches at 16px


@pytest.mark.parametrize("hwc, kind", [
    ((16, 16, 64), "staged"), ((8, 8, 128), "staged"), ((7, 1, 32), "staged"),
    ((8, 8, 64), "staged"),
    ((32, 32, 64), "per_warp"), ((9, 11, 33), "per_warp"),
    ((32, 32, 3), "per_pixel"), ((4, 4, 31), "per_pixel")])
def test_dcoords_kernel_choice(cuda, hwc, kind):
    assert bilinear.dcoords_kind(*hwc) == kind


@pytest.mark.parametrize("shape", STAGED_SHAPES)
@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_staged_dcoords_matches_plain(cuda, shape, layout):
    assert bilinear.dcoords_kind(*shape[1:4]) == "staged"
    img, rows, out_hw = _inputs(shape, cuda, seed=8)
    g = _cotangent(shape, cuda, seed=9)
    if layout == "rows":
        runs = [bilinear.launch_dcoords(img, rows, g, out_hw)
                for _ in range(2)]
        want = bilinear.bilinear_sample_rows_backward_plain(
            img, rows, g, out_hw, need_img=False)[1]
    else:
        grid = rows.permute(0, 2, 1).reshape(shape[0], *out_hw, 2)
        grid = grid.contiguous()
        runs = [bilinear_grid.launch_dcoords(img, grid, g) for _ in range(2)]
        want = bilinear_grid.bilinear_sample_grid_backward_plain(
            img, grid, g, need_img=False)[1]
    torch.cuda.synchronize()
    _bwd_close(runs[0], want)
    assert torch.equal(runs[0], runs[1])


# ---------------------------------------------------------------------------
# the staged sampler forward (the sample's image in shared memory, float4
# channels) and the choice between the three forward kernels, by shape
# alone: it gives the plain version's bits and the per-value kernel's (a
# misaligned image takes that one), both layouts
# ---------------------------------------------------------------------------

# the branch shape at full batch, and shapes whose output pixels are not a
# multiple of the block's range (77 and 117 per sample)
STAGED_FWD_SHAPES = [(640, 16, 16, 64, 48, 16), (3, 16, 16, 64, 7, 11),
                     (5, 8, 8, 128, 13, 9),
                     (640, 8, 8, 64, 24, 8)]   # D32_st3's branches at 16px


def _misaligned(t):
    """A copy of ``t`` 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _forward_kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("shape", STAGED_FWD_SHAPES)
@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_staged_forward_gives_the_plain_bits(cuda, shape, layout):
    assert bilinear.forward_kind(*shape[1:4]) == "staged"
    img, rows, out_hw = _inputs(shape, cuda, seed=10)
    if layout == "rows":
        run = lambda im: bilinear.launch(im, rows, out_hw)  # noqa: E731
        want = bilinear.bilinear_sample_rows_plain(img, rows, out_hw)
    else:
        grid = rows.permute(0, 2, 1).reshape(shape[0], *out_hw, 2)
        grid = grid.contiguous()
        run = lambda im: bilinear_grid.launch(im, grid)  # noqa: E731
        want = bilinear_grid.bilinear_sample_grid_plain(img, grid)
    staged, again, per_value = run(img), run(img), run(_misaligned(img))
    torch.cuda.synchronize()
    assert torch.equal(staged, want)
    assert torch.equal(staged, again)
    assert torch.equal(staged, per_value)


@pytest.mark.parametrize("hwc, kind", [
    ((32, 32, 3), "per_quad"), ((32, 32, 1), "per_quad"),
    ((4, 4, 31), "per_quad"), ((7, 9, 4), "per_quad"),
    ((9, 11, 3), "per_pixel"), ((1, 5, 1), "per_pixel"),
    ((128, 128, 31), "per_pixel"), ((9, 11, 33), "per_value"),
    ((16, 16, 64), "staged"), ((32, 32, 64), "per_value")])
def test_forward_kernel_choice(cuda, hwc, kind):
    assert bilinear.forward_kind(*hwc) == kind


@pytest.mark.parametrize("aligned, name", [(True, "sample_per_pixel_staged"),
                                           (False, "sample_per_value")])
def test_forward_kernel_of_a_view(cuda, aligned, name):
    img, rows, out_hw = _inputs(STAGED_FWD_SHAPES[1], cuda, seed=11)
    im = img if aligned else _misaligned(img)
    names = _forward_kernel_names(lambda: bilinear.launch(im, rows, out_hw))
    assert len(names) == 1 and name + "<" in names[0], names


# ---------------------------------------------------------------------------
# the upsample-conv forward (3xTF32 on the tensor cores) at ragged shapes:
# input channels not a multiple of 4 (4-byte copies), output channels not
# a multiple of 8 or of the 128-wide tile, pixels not a multiple of the
# 128-pixel tile, a one-pixel image; a misaligned x (4-byte copies); the
# halo after the transform; repeats bit for bit. y within 1e-5 of its
# largest plain value, the stats within 1e-4, as above.
# ---------------------------------------------------------------------------

FWD_SHAPES = [                 # (N, H, W, Cin, Cout, k)
    (2, 4, 5, 9, 11, 3),       # Cin % 4 != 0, Cout % 8 != 0
    (1, 1, 1, 8, 130, 3),      # one pixel; Cout over one tile, ragged
    (3, 7, 9, 32, 136, 5),     # 189 pixels; Cout % 128 != 0
    (2, 3, 5, 6, 7, 1),        # k = 1, all ragged
]


@pytest.mark.parametrize("shape", FWD_SHAPES)
@pytest.mark.parametrize("alpha", ["scalar", "channelwise"])
def test_tf32_forward_at_ragged_shapes(f32_cuda, shape, alpha):
    cout = shape[4]
    v = _up_inputs(shape, f32_cuda, seed=12,
                   alpha_n=1 if alpha == "scalar" else cout)
    got = fuc.upsample2_conv_fused(v["x"], v["weight"], v["bias"],
                                   v["alpha"])
    again = fuc.upsample2_conv_fused(v["x"], v["weight"], v["bias"],
                                     v["alpha"])
    torch.cuda.synchronize()
    want = fuc.block_plain(v["x"], v["weight"], v["bias"],
                           prelu_alpha=v["alpha"])
    _up_close(got, want, UP_TIGHT, "y")
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", FWD_SHAPES)
@pytest.mark.parametrize("with_stats", [True, False])
def test_tf32_block_at_ragged_shapes(f32_cuda, shape, with_stats):
    v = _up_inputs(shape, f32_cuda, seed=13, alpha_n=shape[3])
    args = (v["x"], v["weight"], v["bias"], v["scale"], v["shift"],
            v["alpha"])
    got = fuc.upsample2_conv_block_fused(*args, with_stats=with_stats)
    again = fuc.upsample2_conv_block_fused(*args, with_stats=with_stats)
    torch.cuda.synchronize()
    y = fuc.block_plain(*args)
    got, again = (got, again) if with_stats else ((got,), (again,))
    want = (y, *fuc.stats_plain(y)) if with_stats else (y,)
    for name, a, b, a2, rel in zip(("y", "s1", "s2"), got, want, again,
                                   (UP_TIGHT, UP_LOOSE, UP_LOOSE)):
        _up_close(a, b, rel, name)
        assert torch.equal(a, a2), name


def test_tf32_forward_of_a_misaligned_x(f32_cuda):
    v = _up_inputs(UP_SHAPES[4], f32_cuda, seed=14, alpha_n=1)
    x = _misaligned(v["x"])
    got = fuc.upsample2_conv_block_fused(x, v["weight"], v["bias"],
                                         v["scale"], v["shift"], v["alpha"])
    torch.cuda.synchronize()
    y = fuc.block_plain(v["x"], v["weight"], v["bias"], v["scale"],
                        v["shift"], v["alpha"])
    for name, a, b, rel in zip(("y", "s1", "s2"), got,
                               (y, *fuc.stats_plain(y)),
                               (UP_TIGHT, UP_LOOSE, UP_LOOSE)):
        _up_close(a, b, rel, name)


@pytest.mark.parametrize("shape", [(2, 4, 5, 16, 12, 3), (2, 3, 3, 9, 20, 5)])
def test_tf32_forward_halo_is_zero_after_the_transform(f32_cuda, shape):
    # shift 4: a halo of prelu(4) = 4 instead of 0 misses the tolerance by
    # far in the plain version, the kernel not
    v = _up_inputs(shape, f32_cuda, seed=15, alpha_n=1)
    v["shift"] = torch.full_like(v["shift"], 4.0)
    args = (v["x"], v["weight"], v["bias"], v["scale"], v["shift"],
            v["alpha"])
    got = fuc.upsample2_conv_block_fused(*args, with_stats=False)
    torch.cuda.synchronize()
    want = fuc.block_plain(*args)
    xn = fuc.in_transform(v["x"], v["scale"], v["shift"], v["alpha"])
    halo = fuc.in_transform(torch.zeros(shape[3], device=f32_cuda),
                            v["scale"], v["shift"], v["alpha"])
    k = shape[5]
    r = k // 2
    up = xn.repeat_interleave(2, 1).repeat_interleave(2, 2)
    n, h2, w2, c = up.shape
    pad = halo.expand(n, h2 + 2 * r, w2 + 2 * r, c).clone()
    pad[:, r:r + h2, r:r + w2] = up
    wrong = torch.nn.functional.conv2d(
        pad.permute(0, 3, 1, 2), v["weight"]).permute(0, 2, 3, 1) + v["bias"]
    bound = UP_TIGHT * want.abs().max().item()
    assert (wrong - want).abs().max().item() > 100 * bound
    _up_close(got, want, UP_TIGHT, "y")


# ---------------------------------------------------------------------------
# the per-sample d_img kernel (C < 32: one block per sample, one slab of
# d_img per warp, the lanes that hit one tap summed in lane order) and the
# choice between the two d_img kernels, both layouts. Coordinates: spread
# over [-1.2, 1.2]; zoomed in (x 0.05: a few taps per sample; x 0.01: one
# tap for all 1024 output pixels, so a whole warp adds into one address);
# past every edge (+-1.5: every pixel clamped to a corner). Tolerance as
# the backward's above; repeats bit for bit.
# ---------------------------------------------------------------------------

DIMG_SHAPES = [(3, 32, 32, c, 32, 32) for c in (1, 2, 3, 4)]
DIMG_SHAPES.append((2, 7, 12, 3, 5, 19))   # non-square, output unlike it
DIMG_COORDS = {"spread": lambda r: r, "zoom": lambda r: r * 0.05,
               "point": lambda r: r * 0.01,
               "edges": lambda r: torch.sign(r) * 1.5}


def _dimg_run(layout, img, rows, g, out_hw):
    if layout == "rows":
        return bilinear.launch_dimg(img, rows, g, out_hw)
    grid = rows.permute(0, 2, 1).reshape(img.shape[0], *out_hw, 2)
    return bilinear_grid.launch_dimg(img, grid.contiguous(), g)


def _dimg_plain(img, rows, g, out_hw):
    return bilinear.bilinear_sample_rows_backward_plain(
        img, rows, g, out_hw, need_coords=False)[0]


@pytest.mark.parametrize("shape", DIMG_SHAPES)
@pytest.mark.parametrize("layout", ["rows", "grid"])
@pytest.mark.parametrize("coords", sorted(DIMG_COORDS))
def test_per_sample_dimg_matches_plain(cuda, shape, layout, coords):
    assert bilinear.dimg_kind(*shape[1:4]) == "per_sample"
    img, rows, out_hw = _inputs(shape, cuda, seed=16)
    rows = DIMG_COORDS[coords](rows).contiguous()
    g = _cotangent(shape, cuda, seed=17)
    first = _dimg_run(layout, img, rows, g, out_hw)
    again = _dimg_run(layout, img, rows, g, out_hw)
    torch.cuda.synchronize()
    _bwd_close(first, _dimg_plain(img, rows, g, out_hw))
    assert torch.equal(first, again)


@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_per_sample_dimg_of_an_offset_g(cuda, layout):
    # g 4 bytes past a 16-byte boundary: the kernel reads it by value
    shape = DIMG_SHAPES[2]
    img, rows, out_hw = _inputs(shape, cuda, seed=18)
    g = _cotangent(shape, cuda, seed=19)
    aligned = _dimg_run(layout, img, rows, g, out_hw)
    offset = _dimg_run(layout, img, rows, _misaligned(g), out_hw)
    torch.cuda.synchronize()
    assert torch.equal(aligned, offset)


@pytest.mark.parametrize("hwc, kind", [
    ((32, 32, 3), "per_sample"), ((32, 32, 1), "per_sample"),
    ((7, 12, 3), "per_sample"), ((4, 4, 31), "per_sample"),
    ((16, 16, 64), "gather"), ((32, 32, 31), "gather"),
    ((9, 11, 33), "gather"), ((32, 32, 64), "gather"),
    ((79, 79, 8), "gather"), ((80, 80, 8), "per_channel"),
    ((128, 128, 1), "per_channel")])
def test_dimg_kernel_choice(cuda, hwc, kind):
    assert bilinear.dimg_kind(*hwc) == kind


@pytest.mark.parametrize("shape, name", [
    ((2, 32, 32, 3, 32, 32), "dimg_per_sample"),
    ((2, 16, 16, 64, 48, 16), "dimg_gather"),
    ((1, 128, 128, 1, 8, 8), "dimg_per_channel")])
@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_dimg_kernel_by_shape(cuda, shape, name, layout):
    img, rows, out_hw = _inputs(shape, cuda, seed=20)
    g = _cotangent(shape, cuda, seed=21)
    if layout == "rows":
        run = lambda: bilinear.launch_dimg(img, rows, g, out_hw)  # noqa: E731
    else:       # the grid made outside the profiled call
        grid = rows.permute(0, 2, 1).reshape(shape[0], *out_hw, 2)
        grid = grid.contiguous()
        run = lambda: bilinear_grid.launch_dimg(img, grid, g)  # noqa: E731
    names = _kernel_names_seen(run)
    assert len(names) == 1 and name + "<" in names[0], names


# ---------------------------------------------------------------------------
# the gather d_img kernel (a block per sample buckets each output pixel's
# four taps by input pixel, then a warp per input pixel sums its bin in
# (output pixel, tap) order) and the per-channel kernel it leaves for
# images too large for its block, both layouts: within the backward's
# tolerance of the plain version, bit for bit the sums of the CPU
# emulation (test_torch_port_dimg_gather.py), repeats bit for bit, and
# the same bits from an offset g (one channel a lane instead of two)
# ---------------------------------------------------------------------------

from test_torch_port_dimg_gather import gather_dimg  # noqa: E402

GATHER_SHAPES = [(2, 16, 16, 64, 48, 16),   # the branch shape
                 (2, 9, 11, 33, 7, 5),      # odd sizes and C: no float2
                 (2, 32, 32, 31, 8, 8),     # C = 31: four slabs do not fit
                 (2, 32, 32, 64, 32, 32),   # a 32x32x64 image
                 (1, 9, 7, 32, 48, 48),     # 2304 output pixels: 3 passes
                 (3, 8, 8, 64, 24, 8)]      # D32_st3's branches at 16px


@pytest.mark.parametrize("shape", GATHER_SHAPES)
@pytest.mark.parametrize("layout", ["rows", "grid"])
@pytest.mark.parametrize("coords", sorted(DIMG_COORDS))
def test_gather_dimg_matches_plain(cuda, shape, layout, coords):
    assert bilinear.dimg_kind(*shape[1:4]) == "gather"
    img, rows, out_hw = _inputs(shape, cuda, seed=23)
    rows = DIMG_COORDS[coords](rows).contiguous()
    g = _cotangent(shape, cuda, seed=24)
    first = _dimg_run(layout, img, rows, g, out_hw)
    again = _dimg_run(layout, img, rows, g, out_hw)
    torch.cuda.synchronize()
    _bwd_close(first, _dimg_plain(img, rows, g, out_hw))
    assert torch.equal(first, again)


@pytest.mark.parametrize("shape", GATHER_SHAPES)
@pytest.mark.parametrize("coords", ["spread", "point"])
def test_gather_dimg_gives_the_emulated_bits(cuda, shape, coords):
    n, h, w, c = shape[:4]
    img, rows, out_hw = _inputs(shape, cuda, seed=25)
    rows = DIMG_COORDS[coords](rows).contiguous()
    g = _cotangent(shape, cuda, seed=26)
    got = bilinear.launch_dimg(img, rows, g, out_hw)
    want = gather_dimg(rows.cpu().numpy(), g.cpu().numpy().reshape(n, -1, c),
                       (h, w))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_gather_dimg_of_an_offset_g(cuda, layout):
    shape = GATHER_SHAPES[0]
    img, rows, out_hw = _inputs(shape, cuda, seed=27)
    g = _cotangent(shape, cuda, seed=28)
    aligned = _dimg_run(layout, img, rows, g, out_hw)
    offset = _dimg_run(layout, img, rows, _misaligned(g), out_hw)
    torch.cuda.synchronize()
    assert torch.equal(aligned, offset)


@pytest.mark.parametrize("shape", [   # gather, per sample, per channel
    (0, 16, 16, 64, 48, 16), (0, 32, 32, 3, 32, 32), (0, 128, 128, 1, 8, 8)])
@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_dimg_of_an_empty_batch(cuda, shape, layout):
    img, rows, out_hw = _inputs(shape, cuda)
    got = _dimg_run(layout, img, rows, _cotangent(shape, cuda), out_hw)
    torch.cuda.synchronize()
    assert got.shape == (0, *shape[1:4])


@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_per_channel_dimg_matches_plain(cuda, layout):
    shape = (2, 128, 128, 1, 8, 8)
    assert bilinear.dimg_kind(*shape[1:4]) == "per_channel"
    img, rows, out_hw = _inputs(shape, cuda, seed=29)
    g = _cotangent(shape, cuda, seed=30)
    first = _dimg_run(layout, img, rows, g, out_hw)
    again = _dimg_run(layout, img, rows, g, out_hw)
    torch.cuda.synchronize()
    _bwd_close(first, _dimg_plain(img, rows, g, out_hw))
    assert torch.equal(first, again)


# ---------------------------------------------------------------------------
# the per-quad forward (C < 32: the sample's image in shared memory, four
# output pixels a thread, float4 coordinates and outputs) and its choice by
# shape and alignment, both layouts: the plain version's bits; repeats bit
# for bit; an image or coordinate array off a 16-byte boundary takes the
# per-pixel kernel, with the same bits; coordinates spread or all within
# one pixel; P not a multiple of 4 (pixel by pixel inside the kernel)
# ---------------------------------------------------------------------------

QUAD_SHAPES = [(640, 32, 32, 3, 32, 32),    # the input ST at batch 640
               (640, 16, 16, 3, 16, 16),    # the input ST at 16px
               (3, 32, 32, 1, 32, 32),      # C = 1
               (2, 4, 4, 31, 2, 2),         # C = 31, the widest
               (2, 7, 9, 4, 5, 7),          # odd h and w; P = 35
               (3, 16, 12, 3, 9, 3)]        # P = 27
QUAD_COORDS = {"spread": lambda r: r, "point": lambda r: r * 0.01}


def _offset(t, floats):
    """A contiguous copy of ``t`` ``floats`` floats past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[floats:floats + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _coords(layout, rows, out_hw, shift=0):
    """The coordinates in ``layout``, ``shift`` floats past 16 bytes."""
    if layout == "grid":
        rows = rows.permute(0, 2, 1).reshape(rows.shape[0], *out_hw, 2)
    return _offset(rows, shift)


def _forward(layout, img, crd, out_hw):
    if layout == "rows":
        return bilinear.launch(img, crd, out_hw)
    return bilinear_grid.launch(img, crd)


@pytest.mark.parametrize("shape", QUAD_SHAPES)
@pytest.mark.parametrize("layout", ["rows", "grid"])
@pytest.mark.parametrize("coords", sorted(QUAD_COORDS))
def test_per_quad_forward_gives_the_plain_bits(cuda, shape, layout, coords):
    assert bilinear.forward_kind(*shape[1:4]) == "per_quad"
    img, rows, out_hw = _inputs(shape, cuda, seed=31)
    rows = QUAD_COORDS[coords](rows).contiguous()
    crd = _coords(layout, rows, out_hw)
    want = bilinear.bilinear_sample_rows_plain(img, rows, out_hw)
    first = _forward(layout, img, crd, out_hw)
    again = _forward(layout, img, crd, out_hw)
    per_pixel = (_forward(layout, _misaligned(img), crd, out_hw),
                 _forward(layout, img, _coords(layout, rows, out_hw, 2),
                          out_hw))
    torch.cuda.synchronize()
    assert torch.equal(first, want)
    assert torch.equal(first, again)
    assert all(torch.equal(first, other) for other in per_pixel)


@pytest.mark.parametrize("view, name", [
    ("aligned", "sample_per_quad_staged"), ("image", "sample_per_pixel"),
    ("coords", "sample_per_pixel")])
@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_per_quad_forward_kernel_of_a_view(cuda, view, name, layout):
    img, rows, out_hw = _inputs((2, 32, 32, 3, 32, 32), cuda, seed=32)
    im = _misaligned(img) if view == "image" else img
    crd = _coords(layout, rows, out_hw, 2 if view == "coords" else 0)
    names = _kernel_names_seen(lambda: _forward(layout, im, crd, out_hw))
    assert len(names) == 1 and name + "<" in names[0], names


@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_per_quad_forward_of_an_empty_batch(cuda, layout):
    img, rows, out_hw = _inputs((0, 32, 32, 3, 32, 32), cuda)
    got = _forward(layout, img, _coords(layout, rows, out_hw), out_hw)
    torch.cuda.synchronize()
    assert got.shape == (0, 32, 32, 3)


# ---------------------------------------------------------------------------
# the dX kernel (3xTF32 on wgmma) of both forms at ragged shapes: channel
# counts not a multiple of 4 (4-byte copies), pixels not a multiple of the
# 128-pixel tile, input channels over one 128-wide tile, k = 1 and 5; the
# transform with shift 4; a misaligned g (4-byte copies, the same bits);
# the halo of the fold; repeats bit for bit. dx within 1e-5 of its largest
# plain value, dscale, dshift and dalpha within 1e-4, as above.
# ---------------------------------------------------------------------------

DX_SHAPES = [                  # (N, H, W, Cin, Cout, k)
    (2, 4, 5, 9, 11, 3),       # Cin, Cout % 4 != 0
    (3, 7, 9, 32, 136, 5),     # 189 pixels; Cout over 4 steps, ragged
    (1, 1, 1, 8, 130, 3),      # one pixel
    (2, 5, 3, 130, 20, 3),     # Cin over one tile, ragged
    (2, 3, 5, 6, 7, 1),        # k = 1, all ragged
]


def _dx_block_run(v, alpha):
    """(dx, dscale, dshift, dalpha) from the dX kernel with the fold and
    the transform."""
    gs = torch.stack([v["gs1"], v["gs2"]])
    dx, dtr = fuc._launch_dx(v["x"], v["weight"], v["gy"], v["y"], gs,
                             v["scale"], v["shift"], alpha)
    return (dx, *dtr)


@pytest.mark.parametrize("shape", DX_SHAPES)
@pytest.mark.parametrize("form", ["conv", "block"])
def test_tf32_dx_at_ragged_shapes(f32_cuda, shape, form):
    v = _dck_inputs(shape, f32_cuda, seed=22)
    if form == "conv":
        runs = [(fuc.upsample2_conv_dx(v["x"], v["weight"], v["gy"]),)
                for _ in range(2)]
        want = fuc.upsample2_conv_backward_plain(v["x"], v["weight"],
                                                 v["gy"])[:1]
    else:
        alpha = v["alpha"].expand(shape[3]).contiguous()
        runs = [_dx_block_run(v, alpha) for _ in range(2)]
        want = fuc.fused_block_backward_plain(
            v["x"], v["scale"], v["shift"], v["alpha"], v["weight"],
            v["bias"], v["y"], v["gy"], v["gs1"], v["gs2"])[:4]
    torch.cuda.synchronize()
    for name, a, a2, b, rel in zip(
            ("dx", "dscale", "dshift", "dalpha"), *runs, want,
            (UP_TIGHT,) + (UP_LOOSE,) * 3):
        _up_close(a, b, rel, name)
        assert torch.equal(a, a2), name


def test_tf32_dx_transform_with_shift_4(f32_cuda):
    shape = (2, 6, 5, 24, 40, 5)
    v = _dck_inputs(shape, f32_cuda, seed=23, shift=4.0)
    got = _dx_block_run(v, v["alpha"].expand(shape[3]).contiguous())
    torch.cuda.synchronize()
    want = fuc.fused_block_backward_plain(
        v["x"], v["scale"], v["shift"], v["alpha"], v["weight"], v["bias"],
        v["y"], v["gy"], v["gs1"], v["gs2"])[:4]
    for name, a, b, rel in zip(("dx", "dscale", "dshift", "dalpha"), got,
                               want, (UP_TIGHT,) + (UP_LOOSE,) * 3):
        _up_close(a, b, rel, name)


@pytest.mark.parametrize("form", ["conv", "block"])
def test_tf32_dx_of_a_misaligned_g(f32_cuda, form):
    # 4-byte copies for g: the same arithmetic, so the same bits
    v = _dck_inputs(UP_SHAPES[4], f32_cuda, seed=24)
    gs = torch.stack([v["gs1"], v["gs2"]]) if form == "block" else None
    y = v["y"] if form == "block" else None
    a = fuc._launch_dx(v["x"], v["weight"], v["gy"], y, gs)
    b = fuc._launch_dx(v["x"], v["weight"], _misaligned(v["gy"]), y, gs)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _dx_with_g_halo(x, weight, g, halo):
    """dx of upsample2_conv(x, weight) for the cotangent g (N, 2H, 2W,
    Cout) extended past its edges by ``halo`` (Cout,) instead of zeros:
    what a kernel that folds its zero halo would compute."""
    n, h, w, cin = x.shape
    r = weight.shape[2] // 2
    h2, w2 = 2 * h, 2 * w
    gp = halo.expand(n, h2 + 2 * r, w2 + 2 * r, g.shape[3]).clone()
    gp[:, r:r + h2, r:r + w2] = g
    # the conv's adjoint on the padded upsampled input, over the extended
    # cotangent, cropped to the upsampled image, summed over each 2 x 2
    dp = torch.nn.functional.conv_transpose2d(gp.permute(0, 3, 1, 2),
                                              weight)
    du = dp[:, :, 2 * r:2 * r + h2, 2 * r:2 * r + w2]
    return du.reshape(n, cin, h, 2, w, 2).sum((3, 5)).permute(0, 2, 3, 1)


def test_tf32_dx_halo_is_zero_after_the_fold(f32_cuda):
    # gs1 of 0.5: the fold of a halo zero is gs1, not 0; the plain version
    # with that halo misses the tolerance by far, the kernel not
    shape = (2, 4, 5, 16, 12, 5)
    v = _dck_inputs(shape, f32_cuda, seed=25)
    v["gs1"] = torch.full_like(v["gs1"], 0.5)
    gs = torch.stack([v["gs1"], v["gs2"]])
    got = fuc._launch_dx(v["x"], v["weight"], v["gy"], v["y"], gs)
    torch.cuda.synchronize()
    g = v["gy"] + v["gs1"] + 2.0 * v["y"] * v["gs2"]
    want = fuc.upsample2_conv_backward_plain(v["x"], v["weight"], g)[0]
    zero = _dx_with_g_halo(v["x"], v["weight"], g, torch.zeros_like(
        v["gs1"]))
    wrong = _dx_with_g_halo(v["x"], v["weight"], g, v["gs1"])
    bound = UP_TIGHT * want.abs().max().item()
    assert (zero - want).abs().max().item() <= bound
    assert (wrong - want).abs().max().item() > 100 * bound
    _up_close(got, want, UP_TIGHT, "dx")


# ---------------------------------------------------------------------------
# the bf16 instantiations of the sampler kernels, both layouts, against the
# bf16 plain version (its upcast, f32 arithmetic and one rounding): the
# forward bit for bit, by every kernel (per quad, staged, per value, per
# pixel; an image off a 16-byte boundary, a C that is not a multiple of
# 8); d_img and d_coords within BF16_ULPS units in the last place of the
# plain value plus BF16_FLOOR of the largest (both are f32 sums of another
# order, rounded once: where they round apart they differ by one unit, and
# a sum that cancels to far below its terms may differ by f32 rounding of
# those terms); repeats bit for bit; the zoomed-in input ST, every edge,
# and a gather d_img of more than 1024 output pixels (its f32 scratch).
# ---------------------------------------------------------------------------

from catgen_torch.kernels import bilinear_grid  # noqa: E402

BF16_ULPS, BF16_FLOOR = 1, 2.0 ** -16
BF16_SHAPES = SHAPES + [
    (2, 32, 32, 64, 32, 32),    # a 32x32x64 image: per value, gather
    (2, 8, 8, 36, 5, 7),        # C % 8 != 0: per value (f32: staged)
    (2, 16, 16, 64, 48, 32),    # 1536 output pixels: gather, two passes
    (3, 16, 12, 3, 9, 3),       # P = 27: per quad, pixel by pixel
]
BF16_COORDS = {"spread": lambda r: r, "zoom": lambda r: r * 0.05,
               "edges": lambda r: torch.sign(r) * 1.5}


def _bf16_inputs(shape, device, seed=0):
    img, rows, out_hw = _inputs(shape, device, seed)
    g = _cotangent(shape, device, seed + 1)
    return img.bfloat16(), rows.bfloat16(), g.bfloat16(), out_hw


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    x = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def _bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16 and got.is_cuda
    assert got.shape == want.shape
    err = (got.float() - want.float()).abs()
    bound = (BF16_ULPS * _bf16_ulp(want)
             + BF16_FLOOR * want.float().abs().max())
    assert bool((err <= bound).all()), (err - bound).max().item()


def _bf16_grid(rows, out_hw):
    return rows.permute(0, 2, 1).reshape(rows.shape[0], *out_hw,
                                         2).contiguous()


# (forward, d_coords, d_img) by shape in bf16, where a 16-byte vector holds
# 8 values: 8x8x36 is staged in f32 only, 32x32x64 (128 KB in bf16) in bf16
# only, and 9x11x3 (594 bytes) fills no whole vector of either type
@pytest.mark.parametrize("hwc, kinds", [
    ((32, 32, 3), ("per_quad", "per_quad", "per_sample")),
    ((16, 16, 64), ("staged", "staged", "gather")),
    ((32, 32, 64), ("staged", "staged", "gather")),
    ((8, 8, 36), ("per_value", "per_warp", "gather")),
    ((9, 11, 3), ("per_pixel", "per_pixel", "per_sample")),
    ((9, 11, 33), ("per_value", "per_warp", "gather"))])
def test_bf16_kernel_choice(cuda, hwc, kinds):
    assert (bilinear.forward_kind(*hwc, torch.bfloat16),
            bilinear.dcoords_kind(*hwc, torch.bfloat16),
            bilinear.dimg_kind(*hwc, torch.bfloat16)) == kinds


# the bf16 per-quad forward (4 output pixels a thread, the image widened
# in shared memory, each round's output leaving from shared memory) where
# h*w*c fills whole vectors of 8: P off 8 (a sample's output off 16
# bytes: 2-byte stores), P off 4 (coordinates pixel by pixel), one output
# pixel, two rounds of 1024 pixels, C = 1 and the widest C = 31
BF16_QUAD_SHAPES = [
    (640, 32, 32, 3, 32, 32),   # the input ST and the augmentation
    (2, 8, 8, 3, 5, 4),         # P = 20
    (2, 8, 9, 4, 5, 7),         # P = 35
    (2, 8, 8, 3, 1, 1),         # P = 1
    (2, 16, 16, 3, 48, 32),     # P = 1536
    (3, 32, 32, 1, 32, 32),     # C = 1
    (2, 4, 4, 31, 2, 2),        # C = 31
]


@pytest.mark.parametrize("shape", BF16_SHAPES + BF16_QUAD_SHAPES)
@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_bf16_forward_gives_the_plain_bits(cuda, shape, layout):
    img, rows, _, out_hw = _bf16_inputs(shape, cuda, seed=40)
    want = bilinear.bilinear_sample_rows_plain(img, rows, out_hw)
    crd = rows if layout == "rows" else _bf16_grid(rows, out_hw)
    before = bilinear.launches() if layout == "rows" else \
        bilinear_grid.launches()
    first = _forward(layout, img, crd, out_hw)
    again = _forward(layout, img, crd, out_hw)
    other = _forward(layout, _misaligned(img), crd, out_hw)
    torch.cuda.synchronize()
    after = bilinear.launches() if layout == "rows" else \
        bilinear_grid.launches()
    assert after["BF16_LAUNCHES"] == before["BF16_LAUNCHES"] + 3
    assert after["LAUNCHES"] == before["LAUNCHES"]
    assert first.dtype == torch.bfloat16
    assert torch.equal(first, want)
    assert torch.equal(first, again)
    assert torch.equal(first, other)


@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("layout", ["rows", "grid"])
@pytest.mark.parametrize("coords", sorted(BF16_COORDS))
def test_bf16_backward_kernels_match_plain(cuda, shape, layout, coords):
    img, rows, g, out_hw = _bf16_inputs(shape, cuda, seed=41)
    rows = BF16_COORDS[coords](rows).contiguous()
    want_img, want_crd = bilinear.bilinear_sample_rows_backward_plain(
        img, rows, g, out_hw)
    if layout == "rows":
        runs = [(bilinear.launch_dimg(img, rows, g, out_hw),
                 bilinear.launch_dcoords(img, rows, g, out_hw))
                for _ in range(2)]
    else:
        grid = _bf16_grid(rows, out_hw)
        runs = [(bilinear_grid.launch_dimg(img, grid, g),
                 bilinear_grid.launch_dcoords(img, grid, g)
                 .reshape(shape[0], -1, 2).permute(0, 2, 1))
                for _ in range(2)]
    torch.cuda.synchronize()
    _bf16_close(runs[0][0], want_img)
    _bf16_close(runs[0][1].contiguous(), want_crd)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_bf16_autograd_through_the_kernels(cuda):
    shape = (4, 16, 16, 64, 48, 16)
    img, rows, g, out_hw = _bf16_inputs(shape, cuda, seed=42)
    img.requires_grad_(True)
    rows.requires_grad_(True)
    before = bilinear.launches()
    out = bilinear.bilinear_sample_rows(img, rows, out_hw)
    out.backward(g)
    torch.cuda.synchronize()
    after = bilinear.launches()
    assert {k: after[k] - before[k] for k in after} == {
        "LAUNCHES": 0, "DCOORDS_LAUNCHES": 0, "DIMG_LAUNCHES": 0,
        "BF16_LAUNCHES": 1, "BF16_DCOORDS_LAUNCHES": 1,
        "BF16_DIMG_LAUNCHES": 1}
    assert img.grad.dtype == rows.grad.dtype == torch.bfloat16
    want_img, want_crd = bilinear.bilinear_sample_rows_backward_plain(
        img, rows, g, out_hw)
    _bf16_close(img.grad, want_img)
    _bf16_close(rows.grad, want_crd)


@pytest.mark.parametrize("bad", ["mixed", "grad_f32", "grid_unaligned"])
def test_bf16_wrappers_refuse(cuda, bad):
    img, rows, g, out_hw = _bf16_inputs(SHAPES[1], cuda, seed=43)
    with pytest.raises((TypeError, ValueError)):
        if bad == "mixed":
            bilinear.launch(img, rows.float(), out_hw)
        elif bad == "grad_f32":
            bilinear.launch_dcoords(img, rows, g.float(), out_hw)
        else:
            grid = _bf16_grid(rows, out_hw)
            buf = torch.empty(grid.numel() + 1, dtype=grid.dtype,
                              device=cuda)
            off = buf[1:].view(grid.shape)   # 2 bytes past a pair
            off.copy_(grid)
            bilinear_grid.launch(img, off)


@pytest.mark.parametrize("shape", GATHER_SHAPES)
@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_bf16_gather_dimg_gives_the_emulated_bits(cuda, shape, layout):
    # the CPU emulation's f32 sums of the bf16 values, rounded once; three
    # passes take the wrapper's f32 scratch between them
    n, h, w, c = shape[:4]
    img, rows, g, out_hw = _bf16_inputs(shape, cuda, seed=44)
    got = _dimg_run(layout, img, rows, g, out_hw)
    want = gather_dimg(rows.float().cpu().numpy(),
                       g.float().cpu().numpy().reshape(n, -1, c), (h, w))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), want.bfloat16())


# ---------------------------------------------------------------------------
# the bf16 instantiations of the upsample-conv kernels (forward, dX, dCK)
# and of the ST-conv kernel against their bf16 plain versions (f32 sums of
# the bf16 operands, rounded where catgen's kernels round): each bf16
# output within _bf16_close's bound (one unit in the last place of the
# plain value plus 2^-16 of the largest: f32 sums of another order,
# rounded once); the f32 sums (statistics, the transform's gradients,
# dbias of the block) within UP_LOOSE of their largest; repeats bit for
# bit; an input off a 16-byte boundary, and channel counts that are not
# multiples of 8, take the 2-byte copies and give the same bits as the
# 16-byte copies.
# ---------------------------------------------------------------------------

BF16_UP_SHAPES = UP_SHAPES + [
    (2, 8, 8, 128, 64, 3),     # 16-byte copies, cout under one tile
    (2, 4, 5, 16, 12, 5),      # cin % 8 == 0, cout % 8 != 0
]


def _bf16_up_inputs(shape, device, seed=0, alpha_n=1):
    """``_up_inputs`` rounded to bf16, the stats cotangents f32."""
    return {k: t if k in ("gs1", "gs2") else t.bfloat16()
            for k, t in _up_inputs(shape, device, seed, alpha_n).items()}


def _bf16_or_f32_close(got, want, name):
    if want.dtype == torch.bfloat16:
        _bf16_close(got, want)
    else:
        assert got.dtype == torch.float32, name
        _up_close(got, want, UP_LOOSE, name)


def _misaligned_copy(t):
    """t's values in a tensor 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _bf16_counts():
    return {k: v for k, v in fuc.launches().items() if k.startswith("BF16")}


@pytest.mark.parametrize("shape", BF16_UP_SHAPES)
@pytest.mark.parametrize("alpha", ["scalar", "channelwise"])
def test_bf16_upsample_forward_matches_plain(f32_cuda, shape, alpha):
    cout = shape[4]
    v = _bf16_up_inputs(shape, f32_cuda, seed=60,
                        alpha_n=1 if alpha == "scalar" else cout)
    before = fuc.launches()
    got = fuc.upsample2_conv_fused(v["x"], v["weight"], v["bias"],
                                   v["alpha"])
    torch.cuda.synchronize()
    assert fuc.launches() == dict(before,
                                  BF16_LAUNCHES=before["BF16_LAUNCHES"] + 1)
    want = fuc.block_plain(v["x"], v["weight"], v["bias"],
                           prelu_alpha=v["alpha"])
    _bf16_close(got, want)


@pytest.mark.parametrize("shape", BF16_UP_SHAPES)
@pytest.mark.parametrize("with_stats", [True, False])
def test_bf16_upsample_block_matches_plain(f32_cuda, shape, with_stats):
    v = _bf16_up_inputs(shape, f32_cuda, seed=61, alpha_n=shape[3])
    args = (v["x"], v["weight"], v["bias"], v["scale"], v["shift"],
            v["alpha"])
    before = fuc.BF16_BLOCK_LAUNCHES
    got = fuc.upsample2_conv_block_fused(*args, with_stats=with_stats)
    torch.cuda.synchronize()
    assert fuc.BF16_BLOCK_LAUNCHES == before + 1
    want = fuc.block_plain(*args, with_stats=with_stats)
    if not with_stats:
        got, want = (got,), (want,)
    for name, a, b in zip(("y", "s1", "s2"), got, want):
        _bf16_or_f32_close(a, b, name)


@pytest.mark.parametrize("shape", BF16_UP_SHAPES)
def test_bf16_upsample_backward_matches_plain(f32_cuda, shape):
    v = _bf16_up_inputs(shape, f32_cuda, seed=62)
    before = (fuc.BF16_DX_LAUNCHES, fuc.BF16_DCK_LAUNCHES)
    got = fuc.upsample2_conv_backward(v["x"], v["weight"], v["gy"])
    torch.cuda.synchronize()
    assert (fuc.BF16_DX_LAUNCHES, fuc.BF16_DCK_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = fuc.kernel_backward_plain(v["x"], v["weight"], v["gy"])
    for name, a, b in zip(("dx", "dweight", "dbias"), got, want):
        assert b.dtype == torch.bfloat16, name
        _bf16_or_f32_close(a, b, name)


@pytest.mark.parametrize("shape", BF16_UP_SHAPES)
@pytest.mark.parametrize("alpha", ["scalar", "channelwise"])
def test_bf16_block_backward_matches_plain(f32_cuda, shape, alpha):
    v = _bf16_up_inputs(shape, f32_cuda, seed=63,
                        alpha_n=1 if alpha == "scalar" else shape[3])
    y = fuc.upsample2_conv_block_fused(v["x"], v["weight"], v["bias"],
                                       v["scale"], v["shift"], v["alpha"],
                                       with_stats=False)
    args = (v["x"], v["scale"], v["shift"], v["alpha"], v["weight"], y,
            v["gy"], v["gs1"], v["gs2"])
    before = (fuc.BF16_BLOCK_DX_LAUNCHES, fuc.BF16_BLOCK_DCK_LAUNCHES)
    got = fuc.fused_block_backward(*args)
    torch.cuda.synchronize()
    assert (fuc.BF16_BLOCK_DX_LAUNCHES, fuc.BF16_BLOCK_DCK_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = fuc.block_backward_plain(*args)
    for name, a, b in zip(
            ("dx", "dscale", "dshift", "dalpha", "dweight", "dbias"), got,
            want):
        _bf16_or_f32_close(a, b, name)


@pytest.mark.parametrize("shape", [UP_SHAPES[3], (2, 8, 8, 128, 64, 3)])
def test_bf16_upsample_kernels_repeat_and_ignore_alignment(f32_cuda, shape):
    # a bf16 x, g and y 2 bytes off a 16-byte boundary take the 2-byte
    # copies: the same sums in the same order, so the same bits
    v = _bf16_up_inputs(shape, f32_cuda, seed=64, alpha_n=shape[3])

    def run(x, gy):
        y = fuc.upsample2_conv_block_fused(x, v["weight"], v["bias"],
                                           v["scale"], v["shift"],
                                           v["alpha"])
        return (list(y) + list(fuc.upsample2_conv_backward(x, v["weight"],
                                                           gy))
                + list(fuc.fused_block_backward(
                    x, v["scale"], v["shift"], v["alpha"], v["weight"],
                    _misaligned_copy(y[0]) if x is not v["x"] else y[0],
                    gy, v["gs1"], v["gs2"])))

    first, again = run(v["x"], v["gy"]), run(v["x"], v["gy"])
    off = run(_misaligned_copy(v["x"]), _misaligned_copy(v["gy"]))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(a, b) for a, b in zip(first, off))


@pytest.mark.parametrize("bad", ["f32_weight", "f32_bias", "f32_scale",
                                 "f32_g"])
def test_bf16_upsample_refuses_mixed_dtypes(f32_cuda, bad):
    v = _bf16_up_inputs(UP_SHAPES[0], f32_cuda, alpha_n=UP_SHAPES[0][3])
    name = bad[4:] if bad != "f32_g" else "gy"
    v[name] = v[name].float()
    before = fuc.launches()
    with pytest.raises((TypeError, ValueError)):
        if bad == "f32_g":
            fuc.upsample2_conv_backward(v["x"], v["weight"], v["gy"])
        else:
            fuc.upsample2_conv_block_fused(v["x"], v["weight"], v["bias"],
                                           v["scale"], v["shift"],
                                           v["alpha"])
    assert fuc.launches() == before


def test_bf16_upsample_route_launches_the_bf16_kernels(f32_cuda):
    from catgen_torch.kernels.upsample_conv import UpsampleConv

    layer = UpsampleConv(9, 11).to(f32_cuda)
    x = _up_inputs(UP_SHAPES[0], f32_cuda)["x"].bfloat16().requires_grad_()
    fuc.reset_launches()
    with upconfig.using(upsample_impl="pallas", upsample_bwd="pallas"):
        layer(x).sum().backward()
    assert fuc.launches() == dict(
        dict.fromkeys(fuc.COUNTERS, 0), BF16_LAUNCHES=1, BF16_DX_LAUNCHES=1,
        BF16_DCK_LAUNCHES=1)
    assert x.grad.dtype == torch.bfloat16
    assert layer.weight.grad.dtype == torch.float32


# ---------------------------------------------------------------------------
# the bf16 block's passes (csrc/upsample_conv_prep.cu) and the bf16 dCK on
# wgmma with both operands MN-major: the passes give their plain versions'
# bits (the same f32 operations, rounded once), but for dbias, an f32 sum
# in another order (UP_LOOSE); at one-row and one-column images, channel
# counts off the 16-byte vector and over one block's 256 channels, and
# arrays 2 bytes off a 16-byte boundary. dCK per layer (x, g) and as the
# block's (xn and gf from the passes) within UP_LOOSE of the plain f32
# dCK, and dweight within _bf16_close; repeats bit for bit.
# ---------------------------------------------------------------------------

PASS_SHAPES = [                # (N, H, W, C)
    (2, 1, 7, 9),              # one row, C off the vector of 8
    (3, 5, 1, 16),             # one column
    (2, 3, 3, 5),              # C under one vector
    (2, 4, 4, 512),            # G32up-c stage 1's input: two column blocks
    (1, 6, 5, 264),            # a ragged column block
]


def _pass_inputs(shape, device, seed, alpha_n):
    n, h, w, c = shape
    r = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a.astype(np.float32),   # noqa: E731
                               device=device)
    return dict(x=t(r.randn(n, h, w, c)).bfloat16(),
                scale=t(r.rand(c) + 0.5).bfloat16(),
                shift=t(r.randn(c) * 0.3).bfloat16(),
                alpha=t(r.rand(alpha_n) * 0.5).bfloat16(),
                gy=t(r.randn(n, h, w, c)).bfloat16(),
                gs1=t(r.randn(c) * 0.01), gs2=t(r.randn(c) * 0.01))


@pytest.mark.parametrize("shape", PASS_SHAPES)
@pytest.mark.parametrize("alpha", ["scalar", "channelwise"])
@pytest.mark.parametrize("aligned", [True, False])
def test_bf16_transform_pass_gives_the_plain_bits(f32_cuda, shape, alpha,
                                                  aligned):
    v = _pass_inputs(shape, f32_cuda, 70, 1 if alpha == "scalar"
                     else shape[3])
    x = v["x"] if aligned else _misaligned_copy(v["x"])
    args = (v["scale"], v["shift"], v["alpha"])
    before = fuc.launches()
    got = fuc.block_input_pass(x, *args)
    again = fuc.block_input_pass(x, *args)
    torch.cuda.synchronize()
    assert fuc.launches() == dict(before, BF16_TRANSFORM_LAUNCHES=before[
        "BF16_TRANSFORM_LAUNCHES"] + 2)
    want = fuc.block_input(x, *args)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.parametrize("shape", PASS_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_bf16_fold_pass_gives_the_plain_bits(f32_cuda, shape, aligned):
    v = _pass_inputs(shape, f32_cuda, 71, 1)
    y, gy = v["x"], v["gy"]
    if not aligned:
        y, gy = _misaligned_copy(y), _misaligned_copy(gy)
    before = fuc.launches()
    gf, db = fuc.block_fold_pass(y, gy, v["gs1"], v["gs2"])
    gf2, db2 = fuc.block_fold_pass(y, gy, v["gs1"], v["gs2"])
    torch.cuda.synchronize()
    assert fuc.launches() == dict(before, BF16_FOLD_LAUNCHES=before[
        "BF16_FOLD_LAUNCHES"] + 2)
    want_gf, want_db = fuc.block_fold(y, gy, v["gs1"], v["gs2"])
    assert gf.dtype == torch.bfloat16 and db.dtype == torch.float32
    assert torch.equal(gf, want_gf)
    _up_close(db, want_db, UP_LOOSE, "dbias")
    assert torch.equal(gf, gf2) and torch.equal(db, db2)


def test_bf16_fold_pass_of_an_empty_batch(f32_cuda):
    v = _pass_inputs((0, 4, 4, 12), f32_cuda, 72, 1)
    gf, db = fuc.block_fold_pass(v["x"], v["gy"], v["gs1"], v["gs2"])
    torch.cuda.synchronize()
    assert gf.shape == (0, 4, 4, 12) and torch.equal(db, torch.zeros_like(db))


@pytest.mark.parametrize("shape", BF16_UP_SHAPES + [DCK_SHAPES[-1]])
@pytest.mark.parametrize("form", ["conv", "block"])
def test_bf16_dck_on_wgmma_matches_plain(f32_cuda, shape, form):
    v = _bf16_up_inputs(shape, f32_cuda, seed=66, alpha_n=shape[3])
    x, wt, gy = v["x"], v["weight"], v["gy"]
    k = shape[5]
    if form == "block":
        # as the bf16 block backward: the fold pass, then the kernel on its
        # output after the transform pass
        y = fuc.block_plain(x, wt, v["bias"], v["scale"], v["shift"],
                            v["alpha"])
        tr = (v["scale"], v["shift"], v["alpha"])

        def run():
            gf, db = fuc.block_fold_pass(y, gy, v["gs1"], v["gs2"])
            return fuc._launch_dck(x, wt, gf, None, None, *tr), db

        xn = fuc.block_input(x, *tr)
        g, want_db = fuc.block_fold(y, gy, v["gs1"], v["gs2"])
    else:
        def run():
            return (fuc._launch_dck(x, wt, gy), None)

        xn, g, want_db = x, gy, None
    before = fuc.launches()
    dck, db = run()
    again, db2 = run()
    torch.cuda.synchronize()
    passes = 2 if form == "block" else 0
    assert fuc.launches() == dict(
        before, BF16_TRANSFORM_LAUNCHES=before["BF16_TRANSFORM_LAUNCHES"]
        + passes, BF16_FOLD_LAUNCHES=before["BF16_FOLD_LAUNCHES"] + passes)
    want = fuc._kernel_vjp(xn, wt, g, need_x=False)[1]
    _up_close(dck, want, UP_LOOSE, "dck")
    _bf16_close(fuc.dweight_from_dck(dck, k, k).bfloat16(),
                fuc.dweight_from_dck(want, k, k).bfloat16())
    assert torch.equal(dck, again)
    if form == "block":
        _up_close(db, want_db, UP_LOOSE, "dbias")
        assert torch.equal(db, db2)


@pytest.mark.parametrize("bad", ["f32_x", "f32_scale", "f32_y", "f32_gy",
                                 "cpu_gy"])
def test_bf16_passes_refuse_mixed_dtypes(f32_cuda, bad):
    v = _pass_inputs(PASS_SHAPES[3], f32_cuda, 73, 1)
    name = bad.split("_")[1]
    if bad.startswith("f32"):
        v["y" if name == "y" else name] = (v["x"] if name == "y"
                                           else v[name]).float()
    else:
        v[name] = v[name].cpu()
    before = fuc.launches()
    with pytest.raises((TypeError, ValueError)):
        if name in ("x", "scale"):
            fuc.block_input_pass(v["x"], v["scale"], v["shift"], v["alpha"])
        else:
            fuc.block_fold_pass(v.get("y", v["x"]), v["gy"], v["gs1"],
                                v["gs2"])
    assert fuc.launches() == before


# ---------------------------------------------------------------------------
# the bf16 block dX, which reads the fold pass's output (the bf16 block
# backward folds once, for dX and dCK): dx, dscale, dshift and dalpha on
# gf against block_grads_plain (_bf16_close for dx, UP_LOOSE for the f32
# sums) at ragged shapes (channel counts off the vector of 8: the 2-byte
# copies; pixels off the 128-pixel tile; Cin over one tile; k = 1 and 5)
# and stage 1, the same bits as the whole block backward's, repeats bit
# for bit, an empty batch; both bf16 kernels refuse a fold of their own.
# The bf16 per-quad forward's own cases: coordinates spread and within one
# pixel, both layouts, the kernel an aligned or misaligned view takes
# ---------------------------------------------------------------------------


def _bf16_block_dx(v, gf):
    tr = (v["scale"], v["shift"], v["alpha"].expand(v["x"].shape[3])
          .contiguous())
    dx, dtr = fuc._launch_dx(v["x"], v["weight"], gf, None, None, *tr)
    return (dx, *dtr)


@pytest.mark.parametrize("shape", DX_SHAPES + [UP_SHAPES[3]])
@pytest.mark.parametrize("alpha", ["scalar", "channelwise"])
def test_bf16_block_dx_on_gf_matches_plain(f32_cuda, shape, alpha):
    v = _bf16_up_inputs(shape, f32_cuda, seed=80,
                        alpha_n=1 if alpha == "scalar" else shape[3])
    y = fuc.block_plain(v["x"], v["weight"], v["bias"], v["scale"],
                        v["shift"], v["alpha"])
    gf = fuc.block_fold(y, v["gy"], v["gs1"], v["gs2"])[0]
    before = fuc.launches()
    runs = [_bf16_block_dx(v, gf) for _ in range(2)]
    whole = fuc.fused_block_backward(v["x"], v["scale"], v["shift"],
                                     v["alpha"], v["weight"], y, v["gy"],
                                     v["gs1"], v["gs2"])
    torch.cuda.synchronize()
    after = fuc.launches()
    assert after["BF16_FOLD_LAUNCHES"] == before["BF16_FOLD_LAUNCHES"] + 1
    assert (after["BF16_BLOCK_DX_LAUNCHES"]
            == before["BF16_BLOCK_DX_LAUNCHES"] + 1)
    want = fuc.block_grads_plain(v["x"], v["scale"], v["shift"], v["alpha"],
                                 v["weight"], gf)[:4]
    for name, a, a2, b, c in zip(("dx", "dscale", "dshift", "dalpha"),
                                 *runs, want, whole):
        _bf16_or_f32_close(a, b, name)
        assert torch.equal(a, a2), name
        assert torch.equal(a, c.reshape(a.shape)), name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_dx_of_an_empty_batch(f32_cuda, dtype):
    # dx empty, and the transform's sums 0 (not left unwritten)
    shape = (0, 4, 5, 9, 11, 3)
    if dtype == "bf16":
        v = _bf16_up_inputs(shape, f32_cuda, seed=81)
        dx, ds, dh, da = _bf16_block_dx(v, v["gy"])
    else:
        v = _up_inputs(shape, f32_cuda, seed=81)
        gs = torch.stack([v["gs1"], v["gs2"]])
        dx, dtr = fuc._launch_dx(v["x"], v["weight"], v["gy"], v["gy"], gs,
                                 v["scale"], v["shift"],
                                 v["alpha"].expand(9).contiguous())
        ds, dh, da = dtr
    torch.cuda.synchronize()
    assert dx.shape == v["x"].shape and dx.dtype == v["x"].dtype
    for t in (ds, dh, da):
        assert torch.equal(t, torch.zeros_like(t))


def test_bf16_kernels_refuse_a_fold_of_their_own(f32_cuda):
    from catgen_torch.kernels.build import load_library

    n, h, w, cin, cout, k = UP_SHAPES[0]
    v = _bf16_up_inputs(UP_SHAPES[0], f32_cuda, seed=82)
    gs = torch.stack([v["gs1"], v["gs2"]])
    y = v["gy"].flip(0).contiguous()
    before = fuc.launches()
    for launch in (fuc._launch_dx, fuc._launch_dck):
        with pytest.raises(ValueError):
            launch(v["x"], v["weight"], v["gy"], y, gs)
    assert fuc.launches() == before
    wst = fuc.parity_stack(v["weight"])
    dx = torch.empty_like(v["x"])
    err = load_library().catgen_upsample_conv_dx_bf16(
        v["gy"].data_ptr(), y.data_ptr(), gs.data_ptr(), wst.data_ptr(),
        None, None, None, None, dx.data_ptr(), None, None, n, h, w, cin,
        cout, wst.shape[1], wst.shape[2], *fuc._umins(k, k),
        torch.cuda.current_stream().cuda_stream)
    assert err == 1                 # cudaErrorInvalidValue


@pytest.mark.parametrize("shape", BF16_QUAD_SHAPES)
@pytest.mark.parametrize("layout", ["rows", "grid"])
@pytest.mark.parametrize("coords", sorted(QUAD_COORDS))
def test_bf16_per_quad_forward_gives_the_plain_bits(cuda, shape, layout,
                                                    coords):
    assert bilinear.forward_kind(*shape[1:4], torch.bfloat16) == "per_quad"
    img, rows, _, out_hw = _bf16_inputs(shape, cuda, seed=42)
    rows = QUAD_COORDS[coords](rows).contiguous()
    crd = _coords(layout, rows, out_hw)
    want = bilinear.bilinear_sample_rows_plain(img, rows, out_hw)
    first = _forward(layout, img, crd, out_hw)
    again = _forward(layout, img, crd, out_hw)
    per_pixel = (_forward(layout, _misaligned(img), crd, out_hw),
                 _forward(layout, img, _coords(layout, rows, out_hw, 2),
                          out_hw))
    torch.cuda.synchronize()
    assert first.dtype == torch.bfloat16
    assert torch.equal(first, want)
    assert torch.equal(first, again)
    assert all(torch.equal(first, other) for other in per_pixel)


@pytest.mark.parametrize("view, name", [
    ("aligned", "sample_per_quad_bf16"), ("image", "sample_per_pixel"),
    ("coords", "sample_per_pixel")])
@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_bf16_per_quad_forward_kernel_of_a_view(cuda, view, name, layout):
    img, rows, _, out_hw = _bf16_inputs((2, 32, 32, 3, 32, 32), cuda,
                                        seed=43)
    im = _misaligned(img) if view == "image" else img
    crd = _coords(layout, rows, out_hw, 2 if view == "coords" else 0)
    names = _kernel_names_seen(lambda: _forward(layout, im, crd, out_hw))
    assert len(names) == 1 and name + "<" in names[0], names


@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_bf16_per_quad_forward_of_an_empty_batch(cuda, layout):
    img, rows, _, out_hw = _bf16_inputs((0, 32, 32, 3, 32, 32), cuda)
    got = _forward(layout, img, _coords(layout, rows, out_hw), out_hw)
    torch.cuda.synchronize()
    assert got.shape == (0, 32, 32, 3) and got.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", ST_SHAPES)
@pytest.mark.parametrize("channelwise", [False, True])
def test_bf16_st_conv_kernel_matches_plain(f32_cuda, shape, channelwise):
    img, *params = _st_inputs(shape, f32_cuda, seed=65,
                              channelwise=channelwise)
    img = img.bfloat16()
    before = (st_conv.LAUNCHES, st_conv.BF16_LAUNCHES)
    out, samp, z = st_conv.launch(img, *params)
    light = st_conv.launch(img, *params, save=False)
    torch.cuda.synchronize()
    assert (st_conv.LAUNCHES, st_conv.BF16_LAUNCHES) == (before[0],
                                                         before[1] + 2)
    assert light[1] is None and light[2] is None
    assert torch.equal(light[0], out)
    want = st_conv._forward_plain(img, *params)
    assert out.dtype == samp.dtype == z.dtype == torch.bfloat16
    for a, b in zip((out, z), want[::2]):
        _bf16_close(a, b.contiguous())
    # the plain version samples at the kernel's coordinates: the same bits
    assert torch.equal(samp, want[1])


def test_bf16_st_conv_kernel_repeats_bit_for_bit(f32_cuda):
    img, *params = _st_inputs(ST_SHAPES[0], f32_cuda, seed=66,
                              channelwise=True)
    img = img.bfloat16()
    first, again = st_conv.launch(img, *params), st_conv.launch(img, *params)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("image_grad", [True, False])
def test_bf16_st_conv_backward_matches_the_cpu(f32_cuda, image_grad):
    # the same Function (catgen's VJP) on the card (the bf16 sampler
    # kernels) and on the CPU (their plain versions)
    args = list(_st_inputs(ST_SHAPES[1], f32_cuda, seed=67,
                           channelwise=True))
    args[0] = args[0].bfloat16()
    g = torch.randn((2, 12, 16, 31), device=f32_cuda,
                    generator=torch.Generator(f32_cuda).manual_seed(3)
                    ).bfloat16()
    grads = []
    for dev in (f32_cuda, "cpu"):
        leaves = [a.detach().to(dev).requires_grad_(i > 0 or image_grad)
                  for i, a in enumerate(args)]
        before = bilinear.launches()
        out = st_conv.st_conv_prelu(*leaves)
        grads.append(torch.autograd.grad(
            out, [a for a in leaves if a.requires_grad], g.to(dev)))
        if dev != "cpu":
            torch.cuda.synchronize()
            after = bilinear.launches()
            assert (after["BF16_DCOORDS_LAUNCHES"]
                    - before["BF16_DCOORDS_LAUNCHES"],
                    after["BF16_DIMG_LAUNCHES"]
                    - before["BF16_DIMG_LAUNCHES"]) == (1, int(image_grad))
    for a, b in zip(*grads):
        assert a.dtype == b.dtype
        if image_grad and a.dtype == torch.bfloat16:
            assert a.shape == args[0].shape
        err = (a.float().cpu() - b.float()).abs().max().item()
        assert err <= 1e-2 * b.float().abs().max().item()


def test_bf16_st_conv_refuses_bf16_parameters(f32_cuda):
    img, theta, kernel, bias, alpha = _st_inputs(ST_SHAPES[1], f32_cuda)
    before = (st_conv.LAUNCHES, st_conv.BF16_LAUNCHES)
    with pytest.raises(TypeError):
        st_conv.st_conv_prelu(img.bfloat16(), theta, kernel.bfloat16(), bias,
                              alpha)
    assert (st_conv.LAUNCHES, st_conv.BF16_LAUNCHES) == before


# ---------------------------------------------------------------------------
# the bf16 upsample-conv forward's warp-specialised kernel (TMA boxes of x,
# an mbarrier ring, two accumulator banks): where fwd_bf16_box gives a box
# it runs, and it must give the bits of the cp.async kernel
# (upsample_conv_fwd_bf16, which a misaligned copy of x takes) for y and
# the statistics, and agree with the plain version within _bf16_close; the
# shapes without a box (cin % 64 != 0, h w neither dividing 128 nor a
# multiple of it) and a misaligned x take the cp.async kernel; an empty batch
# launches nothing; repeats bit for bit.
# ---------------------------------------------------------------------------

TMA_SHAPES = [                 # (N, H, W, Cin, Cout, k), box (w, h, n)
    ((3, 4, 4, 512, 512, 3), (4, 4, 8)),     # G32up-c stage 1, ragged n
    ((2, 8, 8, 512, 256, 3), (8, 8, 2)),     # stage 2
    ((2, 16, 16, 256, 128, 5), (16, 8, 1)),  # stage 3
    ((1, 4, 128, 64, 72, 3), (128, 1, 1)),   # a row of 128; cout ragged
    ((5, 2, 4, 64, 136, 5), (4, 2, 16)),     # odd steps (9); 2 cout tiles
    ((1, 4, 4, 64, 64, 3), (4, 4, 8)),       # one tile past n's end
    ((3, 4, 4, 128, 256, 5), (4, 4, 8)),     # G16up stage 1, ragged n
    ((2, 8, 8, 256, 128, 5), (8, 8, 2)),     # G16up stage 2
    ((2, 8, 8, 128, 256, 5), (8, 8, 2)),     # G32up stage 1
]
CP_ASYNC_SHAPES = [            # no box: the cp.async kernel
    (2, 4, 4, 96, 64, 3),      # cin % 64 != 0
    (2, 6, 6, 64, 64, 3),      # 36 pixels neither divide 128 nor fill it
    (2, 12, 12, 64, 64, 3),    # 144 pixels, not a multiple of 128
]


def _cp_async_forward(x, weight, bias, prelu, with_stats):
    """The cp.async bf16 forward kernel on x as it lies: the C entry with
    no box (the wrapper takes the box whenever x has one)."""
    from catgen_torch.kernels.build import load_library

    n, h, w, cin = x.shape
    cout, _, k_h, k_w = weight.shape
    wst = fuc.parity_stack(weight).transpose(3, 4).contiguous()
    lib = load_library()
    y = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=x.device)
    partial = stats = None
    if with_stats:
        rows = 4 * lib.catgen_upsample_conv_partial_rows(n, h, w)
        partial = torch.empty((rows, 2, cout), device=x.device)
        stats = torch.empty((2, cout), device=x.device)
    prelu = None if prelu is None else prelu.reshape(-1)
    err = lib.catgen_upsample_conv_fwd_bf16(
        x.data_ptr(), wst.data_ptr(), bias.data_ptr(),
        None if prelu is None else prelu.data_ptr(),
        0 if prelu is None else prelu.numel(), y.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if stats is None else stats.data_ptr(), n, h, w, cin, cout,
        wst.shape[1], wst.shape[2], *fuc._umins(k_h, k_w), 0, 0, 0,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return (y, stats[0], stats[1]) if with_stats else (y,)


def _kernel_names_seen(fn, calls=5):
    """``_forward_kernel_names`` of ``calls`` calls of ``fn`` in one
    session, asked up to three times: late in a long process a profiler
    session drops kernel records, now and then every record of a call
    that launches one kernel."""
    for _ in range(3):
        names = _forward_kernel_names(lambda: [fn() for _ in range(calls)])
        if names:
            return names
    return names


def _fwd_kernel(fn):
    names = [n for n in _kernel_names_seen(fn)
             if "upsample_conv_fwd_bf16" in n]
    assert len(names) == 1, names
    return "tma" if "upsample_conv_fwd_bf16_tma<" in names[0] else "cp_async"


@pytest.mark.parametrize("shape, box", TMA_SHAPES)
@pytest.mark.parametrize("form", ["scalar", "channelwise", "stats",
                                  "no_stats"])
def test_bf16_tma_forward_gives_the_cp_async_bits(f32_cuda, shape, box, form):
    n, h, w, cin, cout, _ = shape
    assert fuc.fwd_bf16_box(n, h, w, cin) == box
    block = form in ("stats", "no_stats")
    v = _bf16_up_inputs(shape, f32_cuda, seed=70,
                        alpha_n=cin if block else
                        (1 if form == "scalar" else cout))

    def run(x):
        if block:
            return fuc.upsample2_conv_block_fused(
                x, v["weight"], v["bias"], v["scale"], v["shift"],
                v["alpha"], with_stats=form == "stats")
        return (fuc.upsample2_conv_fused(x, v["weight"], v["bias"],
                                         v["alpha"]),)

    assert fuc.forward_kind_bf16(v["x"]) == "tma"
    assert _fwd_kernel(lambda: run(v["x"])) == "tma"
    if block:   # the cp.async kernel on the transform pass's output
        xn = fuc.block_input_pass(v["x"], v["scale"], v["shift"], v["alpha"])
        ref = _cp_async_forward(xn, v["weight"], v["bias"], None,
                             form == "stats")
    else:       # a misaligned x takes the cp.async kernel
        off = _misaligned_copy(v["x"])
        assert fuc.forward_kind_bf16(off) == "cp_async"
        assert _fwd_kernel(lambda: run(off)) == "cp_async"
        ref = run(off)
    got, again = run(v["x"]), run(v["x"])
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    assert len(got) == len(ref)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    if block:
        want = fuc.block_plain(v["x"], v["weight"], v["bias"], v["scale"],
                               v["shift"], v["alpha"],
                               with_stats=form == "stats")
    else:
        want = fuc.block_plain(v["x"], v["weight"], v["bias"],
                               prelu_alpha=v["alpha"])
    want = want if isinstance(want, tuple) else (want,)
    for name, a, b in zip(("y", "s1", "s2"), got, want):
        _bf16_or_f32_close(a, b, name)


@pytest.mark.parametrize("shape", CP_ASYNC_SHAPES)
def test_bf16_forward_without_a_box_takes_the_cp_async_kernel(f32_cuda, shape):
    n, h, w, cin, cout, _ = shape
    assert fuc.fwd_bf16_box(n, h, w, cin) is None
    v = _bf16_up_inputs(shape, f32_cuda, seed=71, alpha_n=cout)
    assert fuc.forward_kind_bf16(v["x"]) == "cp_async"
    run = lambda: fuc.upsample2_conv_fused(  # noqa: E731
        v["x"], v["weight"], v["bias"], v["alpha"])
    assert _fwd_kernel(run) == "cp_async"
    got = run()
    torch.cuda.synchronize()
    _bf16_close(got, fuc.block_plain(v["x"], v["weight"], v["bias"],
                                     prelu_alpha=v["alpha"]))


def test_bf16_tma_forward_of_an_empty_batch(f32_cuda):
    v = _bf16_up_inputs((1, 4, 4, 512, 512, 3), f32_cuda, seed=72)
    x = v["x"][:0]
    before = fuc.BF16_BLOCK_LAUNCHES
    y, s1, s2 = fuc.upsample2_conv_block_fused(x, v["weight"], v["bias"],
                                               v["scale"], v["shift"],
                                               v["alpha"])
    torch.cuda.synchronize()
    assert fuc.BF16_BLOCK_LAUNCHES == before + 1
    assert y.shape == (0, 8, 8, 512)
    assert s1.abs().max().item() == 0.0 and s2.abs().max().item() == 0.0


def test_f32_forward_of_an_empty_batch(f32_cuda):
    """The f32 block forward on N = 0 writes zero BatchNorm sums (the sums
    of nothing) and launches no upsample-conv kernel: the stats buffer
    reuses a freed block of NaNs, which a skipped write would leave."""
    v = _up_inputs((1, 4, 4, 512, 512, 3), f32_cuda, seed=73)
    x = v["x"][:0]
    poison = torch.full((2, 512), float("nan"), device=f32_cuda)
    del poison
    before = fuc.launches()
    out = []
    names = _forward_kernel_names(lambda: out.append(
        fuc.upsample2_conv_block_fused(x, v["weight"], v["bias"],
                                       v["scale"], v["shift"], v["alpha"])))
    after = fuc.launches()
    assert after.pop("BLOCK_LAUNCHES") == before.pop("BLOCK_LAUNCHES") + 1
    assert after == before
    assert not [n for n in names if "upsample_conv" in n], names
    y, s1, s2 = out[0]
    assert y.shape == (0, 8, 8, 512)
    assert s1.abs().max().item() == 0.0 and s2.abs().max().item() == 0.0


# ---------------------------------------------------------------------------
# the bf16 ST-conv on the tensor cores (st_conv_bf16_mma): C = 1..4, F = 64
# and 8, the training and sampling shapes and an h that is not a multiple
# of 8; out and z within _bf16_close of the plain version (27-term sums in
# the tensor core's order), samp bit for bit, repeats bit for bit; a shape
# it does not take (F % 8 != 0, C over 4, a misaligned image) keeps the
# CUDA-core kernel.
# ---------------------------------------------------------------------------

MMA_ST_SHAPES = [               # (N, H, W, C, F)
    (640, 32, 32, 3, 64),       # the training shape
    (256, 32, 32, 3, 64),       # the sampling shape
    (3, 12, 20, 1, 64),         # C = 1, h not a multiple of 8
    (2, 30, 32, 2, 64),         # C = 2, 960 pixels
    (2, 9, 8, 4, 8),            # C = 4 (K = 36 -> 48), F = 8
    (3, 32, 32, 3, 8),          # F = 8
    (2, 7, 8, 3, 136),          # F over one group of 64, ragged pixels
    (640, 16, 16, 3, 64),       # D32_st3's and D16_st3's prefix at 16px
]


def _st_kernel(fn):
    names = [n for n in _kernel_names_seen(fn) if "st_conv" in n]
    assert len(names) == 1, names
    return "mma" if "st_conv_bf16_mma<" in names[0] else "cuda_cores"


@pytest.mark.parametrize("shape", MMA_ST_SHAPES)
@pytest.mark.parametrize("channelwise", [False, True])
def test_bf16_st_conv_on_tensor_cores_matches_plain(f32_cuda, shape,
                                                    channelwise):
    img, *params = _st_inputs(shape, f32_cuda, seed=73,
                              channelwise=channelwise)
    img = img.bfloat16()
    assert st_conv.bf16_kind(img, shape[4]) == "mma"
    assert _st_kernel(lambda: st_conv.launch(img, *params)) == "mma"
    first, again = st_conv.launch(img, *params), st_conv.launch(img, *params)
    light = st_conv.launch(img, *params, save=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(light[0], first[0])
    out, samp, z = first
    want = st_conv._forward_plain(img, *params)
    for a, b in zip((out, z), want[::2]):
        _bf16_close(a, b.contiguous())
    assert torch.equal(samp, want[1])


@pytest.mark.parametrize("case", ["f31", "c5", "misaligned"])
def test_bf16_st_conv_shapes_off_the_tensor_cores(f32_cuda, case):
    shape = {"f31": (2, 12, 16, 3, 31), "c5": (2, 8, 8, 5, 16),
             "misaligned": (2, 32, 32, 3, 64)}[case]
    img, *params = _st_inputs(shape, f32_cuda, seed=74)
    img = img.bfloat16()
    if case == "misaligned":
        img = _misaligned_copy(img)
    assert st_conv.bf16_kind(img, shape[4]) == "cuda_cores"
    assert _st_kernel(lambda: st_conv.launch(img, *params)) == "cuda_cores"
    out, samp, z = st_conv.launch(img, *params)
    torch.cuda.synchronize()
    want = st_conv._forward_plain(img, *params)
    for a, b in zip((out, z), want[::2]):
        _bf16_close(a, b.contiguous())
    assert torch.equal(samp, want[1])


# ---------------------------------------------------------------------------
# the bf16 per-quad d_coords (a block per sample, the image widened in
# shared memory, 4 output pixels a thread, vector loads and stores) against
# the per-pixel kernel it replaced at C < 32, which a misaligned copy of the
# image reaches: the same bits, rows and grid layouts, at C = 1..4 and 13,
# P not a multiple of 4 (pixel by pixel), N = 1 and 3, the input ST at
# batch 640, on spread, zoomed-in, past-the-edge and exact-edge identity
# coordinates and on the augmentation's own; repeats bit for bit
# ---------------------------------------------------------------------------

QUAD_DCOORDS_SHAPES = [
    (640, 32, 32, 3, 32, 32),   # the input ST and the augmentation
    (640, 16, 16, 3, 16, 16),   # both at 16px
    (1, 32, 32, 3, 32, 32),     # N = 1
    (3, 32, 32, 1, 32, 32),     # C = 1
    (3, 32, 32, 2, 32, 32),     # C = 2
    (3, 16, 16, 4, 16, 16),     # C = 4
    (2, 16, 16, 13, 16, 16),    # C = 13: any C < 32, g value by value
    (3, 8, 8, 3, 5, 7),         # P = 35: pixel by pixel
    (2, 8, 8, 3, 1, 1),         # P = 1
    (2, 16, 16, 3, 48, 32),     # P = 1536: two quads a thread
]


def _identity_rows(n, ho, wo, device):
    gy, gx = torch.meshgrid(torch.linspace(-1, 1, ho),
                            torch.linspace(-1, 1, wo), indexing="ij")
    rows = torch.stack([gy.reshape(-1), gx.reshape(-1)])
    return rows.expand(n, 2, ho * wo).contiguous().to(device)


# coordinate rows from the random ones and the output's (Ho, Wo)
DCOORDS_COORDS = {"spread": lambda r, hw: r,
                  "zoom": lambda r, hw: r * 0.05,
                  "edges": lambda r, hw: torch.sign(r) * 1.5,
                  "identity": lambda r, hw: _identity_rows(r.shape[0], *hw,
                                                           r.device)}


def _augment_rows(images, seed):
    """The coordinate rows that ``data.ops.augment_batch`` hands the
    sampler for ``images`` (its default route: rows, in their dtype)."""
    from catgen_torch.core.random import Draws
    from catgen_torch.data import ops

    seen, sample = [], ops.bilinear_sample_rows

    def spy(img, rows, out_hw):
        seen.append(rows)
        return sample(img, rows, out_hw)

    ops.bilinear_sample_rows = spy
    try:
        ops.augment_batch(Draws(torch.Generator(images.device)
                                .manual_seed(seed)), images)
    finally:
        ops.bilinear_sample_rows = sample
    assert len(seen) == 1
    return seen[0].contiguous()


def _dcoords(layout, img, rows, g, out_hw):
    """d_coords as (N, 2, P) rows, from the rows or the grid kernels."""
    if layout == "rows":
        return bilinear.launch_dcoords(img, rows, g, out_hw)
    grid = _bf16_grid(rows, out_hw)
    return (bilinear_grid.launch_dcoords(img, grid, g)
            .reshape(rows.shape[0], rows.shape[2], 2).permute(0, 2, 1)
            .contiguous())


def _dcoords_kernel(fn):
    names = [n for n in _kernel_names_seen(fn) if "dcoords" in n]
    assert len(names) == 1, names
    return names[0]


@pytest.mark.parametrize("hwc, kind", [
    ((32, 32, 3), "per_quad"), ((32, 32, 1), "per_quad"),
    ((4, 4, 31), "per_quad"), ((16, 16, 13), "per_quad"),
    ((9, 11, 3), "per_pixel"), ((1, 5, 1), "per_pixel"),
    ((128, 128, 7), "per_pixel")])
def test_bf16_dcoords_kernel_choice(cuda, hwc, kind):
    assert bilinear.dcoords_kind(*hwc, torch.bfloat16) == kind
    # f32 keeps the per-pixel kernel at every C < 32
    assert bilinear.dcoords_kind(*hwc) == "per_pixel"
    fits = bilinear.dcoords_quad_smem_bytes(*hwc) <= bilinear.OPTIN_SMEM
    assert (kind == "per_quad") == (fits and hwc[0] * hwc[1] * hwc[2] % 8
                                    == 0)


@pytest.mark.parametrize("shape", QUAD_DCOORDS_SHAPES)
@pytest.mark.parametrize("layout", ["rows", "grid"])
@pytest.mark.parametrize("coords", sorted(DCOORDS_COORDS))
def test_bf16_per_quad_dcoords_gives_the_per_pixel_bits(cuda, shape, layout,
                                                        coords):
    assert bilinear.dcoords_kind(*shape[1:4], torch.bfloat16) == "per_quad"
    img, rows, g, out_hw = _bf16_inputs(shape, cuda, seed=80)
    rows = DCOORDS_COORDS[coords](rows.float(), out_hw).bfloat16()
    rows = rows.contiguous()
    before = (bilinear.launches(), bilinear_grid.launches())
    first = _dcoords(layout, img, rows, g, out_hw)
    again = _dcoords(layout, img, rows, g, out_hw)
    per_pixel = _dcoords(layout, _misaligned(img), rows, g, out_hw)
    torch.cuda.synchronize()
    after = (bilinear.launches(), bilinear_grid.launches())
    counts = after[layout == "grid"]
    assert counts["BF16_DCOORDS_LAUNCHES"] == \
        before[layout == "grid"]["BF16_DCOORDS_LAUNCHES"] + 3
    assert first.dtype == torch.bfloat16
    assert torch.equal(first, again)
    assert torch.equal(first, per_pixel)
    want = bilinear.bilinear_sample_rows_backward_plain(
        img, rows, g, out_hw, need_img=False)[1]
    _bf16_close(first, want)


@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_bf16_per_quad_dcoords_at_the_augmentations_coordinates(cuda,
                                                                layout):
    shape = QUAD_DCOORDS_SHAPES[0]
    img, _, g, out_hw = _bf16_inputs(shape, cuda, seed=81)
    rows = _augment_rows(img, seed=82)
    assert rows.dtype == torch.bfloat16 and rows.shape == (640, 2, 1024)
    first = _dcoords(layout, img, rows, g, out_hw)
    again = _dcoords(layout, img, rows, g, out_hw)
    per_pixel = _dcoords(layout, _misaligned(img), rows, g, out_hw)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, per_pixel)


@pytest.mark.parametrize("view, name", [
    ("aligned", "dcoords_per_quad_bf16<"), ("image", "dcoords_per_pixel<"),
    ("coords", "dcoords_per_pixel<"), ("grad", "dcoords_per_pixel<")])
@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_bf16_per_quad_dcoords_kernel_of_a_view(cuda, view, name, layout):
    img, rows, g, out_hw = _bf16_inputs((2, 32, 32, 3, 32, 32), cuda,
                                        seed=83)
    im = _misaligned(img) if view == "image" else img
    gr = _misaligned(g) if view == "grad" else g
    if layout == "rows":
        crd = _offset(rows, 2) if view == "coords" else rows
        run = lambda: bilinear.launch_dcoords(im, crd, gr, out_hw)  # noqa
    else:
        grid = _bf16_grid(rows, out_hw)
        crd = _offset(grid, 2) if view == "coords" else grid
        run = lambda: bilinear_grid.launch_dcoords(im, crd, gr)  # noqa
    kernel = _dcoords_kernel(run)
    assert name in kernel and ("GridLayout" in kernel) == (layout == "grid")
    assert "bfloat16" in kernel or "per_quad" in kernel


def test_f32_dcoords_stays_per_pixel_at_c3(cuda):
    img, rows, out_hw = _inputs((2, 32, 32, 3, 32, 32), cuda, seed=84)
    g = _cotangent((2, 32, 32, 3, 32, 32), cuda, seed=85)
    kernel = _dcoords_kernel(
        lambda: bilinear.launch_dcoords(img, rows, g, out_hw))
    assert "dcoords_per_pixel<" in kernel and "float" in kernel


@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_bf16_per_quad_dcoords_of_an_empty_batch(cuda, layout):
    img, rows, g, out_hw = _bf16_inputs((0, 32, 32, 3, 32, 32), cuda)
    got = _dcoords(layout, img, rows, g, out_hw)
    torch.cuda.synchronize()
    assert got.shape == (0, 2, 1024)


# ---------------------------------------------------------------------------
# the f32 tiled ST-conv (a block per sample, the pixel sampled once into a
# zero-bordered tile, 4 output channels of 4 pixels a thread) against the
# banded kernel it replaced, which a misaligned copy of the image reaches:
# out, z and samp bit for bit, at C = 1..4, F = 4, 60, 64 and 128, shared
# and per-channel slopes, N = 1, 3, 256 and 640, with and without samp and
# z; both within 1e-5 of the largest plain value; repeats bit for bit
# ---------------------------------------------------------------------------

TILED_ST_SHAPES = [             # (N, H, W, C, F)
    (640, 32, 32, 3, 64),       # D32_st3's training shape
    (256, 32, 32, 3, 64),       # and its sampling shape
    (640, 16, 16, 3, 64),       # the prefix at 16px: 256 pixels a sample
    (1, 32, 32, 3, 64),         # N = 1
    (3, 12, 20, 1, 4),          # C = 1, F = 4
    (3, 12, 10, 2, 128),        # C = 2, F = 128, a ragged last segment
    (2, 9, 7, 4, 64),           # C = 4, odd h and w
    (3, 32, 32, 3, 60),         # F = 60: 15 channel groups
]


def _st_kernel_name(fn):
    names = [n for n in _kernel_names_seen(fn) if "st_conv" in n]
    assert len(names) == 1, names
    return names[0]


@pytest.mark.parametrize("shape", TILED_ST_SHAPES)
@pytest.mark.parametrize("channelwise", [False, True])
@pytest.mark.parametrize("save", [True, False])
def test_f32_tiled_st_conv_gives_the_banded_bits(f32_cuda, shape,
                                                 channelwise, save):
    img, *params = _st_inputs(shape, f32_cuda, seed=90,
                              channelwise=channelwise)
    banded_img = _misaligned_copy(img)
    assert st_conv.f32_kind(img, shape[4]) == "tiled"
    assert st_conv.f32_kind(banded_img, shape[4]) == "banded"
    before = st_conv.LAUNCHES
    first = st_conv.launch(img, *params, save=save)
    again = st_conv.launch(img, *params, save=save)
    banded = st_conv.launch(banded_img, *params, save=save)
    torch.cuda.synchronize()
    assert st_conv.LAUNCHES == before + 3
    assert (first[1] is None) == (first[2] is None) == (not save)
    for a, b, c in zip(first, again, banded):
        assert (a is None) == (b is None) == (c is None)
        if a is not None:
            assert torch.equal(a, b) and torch.equal(a, c)
    want = st_conv._forward_plain(img, *params)
    _st_close(first[0], want[0].contiguous(),
              1e-5 * want[0].abs().max().item(), "out")
    if save:
        _st_close(first[2], want[2].contiguous(),
                  1e-5 * want[2].abs().max().item(), "z")
        assert torch.equal(first[1], want[1])


@pytest.mark.parametrize("case, kind", [
    ("d32_st3", "st_conv_f32_tiled<"), ("16px", "st_conv_f32_tiled<"),
    ("misaligned", "st_conv_prelu_kernel<"),
    ("f31", "st_conv_prelu_kernel<"), ("c5", "st_conv_prelu_kernel<"),
    ("hwc_odd", "st_conv_prelu_kernel<")])
def test_f32_st_conv_kernel_by_shape(f32_cuda, case, kind):
    shape = {"d32_st3": (2, 32, 32, 3, 64), "16px": (2, 16, 16, 3, 64),
             "misaligned": (2, 32, 32, 3, 64),
             "f31": (2, 12, 16, 3, 31), "c5": (2, 8, 8, 5, 16),
             "hwc_odd": (2, 9, 11, 3, 64)}[case]
    img, *params = _st_inputs(shape, f32_cuda, seed=91)
    if case == "misaligned":
        img = _misaligned_copy(img)
    want = "tiled" if kind == "st_conv_f32_tiled<" else "banded"
    assert st_conv.f32_kind(img, shape[4]) == want
    name = _st_kernel_name(lambda: st_conv.launch(img, *params))
    assert kind in name and "float" in name, name
    out, samp, z = st_conv.launch(img, *params)
    torch.cuda.synchronize()
    want_out = st_conv._forward_plain(img, *params)
    _st_close(out, want_out[0].contiguous(),
              1e-5 * want_out[0].abs().max().item(), "out")
    assert torch.equal(samp, want_out[1])


def test_bf16_st_conv_rounds_the_f32_weights_once(f32_cuda):
    # the tensor-core kernel packs the f32 weights itself, each rounded
    # once to bf16 as pack_weights(kernel.bfloat16()) holds them: weights
    # rounded beforehand give the same bits
    img, theta, kernel, bias, alpha = _st_inputs((3, 32, 32, 3, 64),
                                                 f32_cuda, seed=92)
    img = img.bfloat16()
    assert st_conv.bf16_kind(img, 64) == "mma"
    got = st_conv.launch(img, theta, kernel, bias, alpha)
    rounded = st_conv.launch(img, theta, kernel.bfloat16().float(), bias,
                             alpha)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, rounded))


# ---------------------------------------------------------------------------
# the 64px pyramid's shapes: the refine trunk's per-layer upsample-conv
# (32x32x64 -> 64x64x64, k5: Cin = Cout = 64, so every 128-channel tile
# runs half masked; in bf16 the TMA forward's box (32, 4, 1) gives one
# 64-deep contraction step a tap), at N = 1 and 8 and with an x off a
# 16-byte boundary (the scalar copies in f32, the cp.async forward in
# bf16), against the plain version; and the sampler forward on the
# augmentation's 64x64x3 reals, f32 and bf16, rows and grid, bit for bit.
# ---------------------------------------------------------------------------

REFINE_SHAPES = [(1, 32, 32, 64, 64, 5), (8, 32, 32, 64, 64, 5)]


@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned",
                                                           "x_off_16b"])
@pytest.mark.parametrize("shape", REFINE_SHAPES, ids=["n1", "n8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_refine_shape_kernels_match_plain(f32_cuda, dtype, shape,
                                          misaligned):
    bf16 = dtype == "bf16"
    v = (_bf16_up_inputs if bf16 else _up_inputs)(shape, f32_cuda, seed=80)
    x = _misaligned_copy(v["x"]) if misaligned else v["x"]
    if bf16:
        assert fuc.forward_kind_bf16(x) == ("cp_async" if misaligned
                                            else "tma")
    before = fuc.launches()
    y = fuc.upsample2_conv_fused(x, v["weight"], v["bias"])
    grads = fuc.upsample2_conv_backward(x, v["weight"], v["gy"])
    torch.cuda.synchronize()
    prefix = "BF16_" if bf16 else ""
    after = fuc.launches()
    for name in ("LAUNCHES", "DX_LAUNCHES", "DCK_LAUNCHES"):
        assert after[prefix + name] == before[prefix + name] + 1, name
    want_y = fuc.block_plain(v["x"], v["weight"], v["bias"])
    want = fuc.kernel_backward_plain(v["x"], v["weight"], v["gy"])
    if bf16:
        _bf16_close(y, want_y)
        for name, a, b in zip(("dx", "dweight", "dbias"), grads, want):
            _bf16_or_f32_close(a, b, name)
    else:
        _up_close(y, want_y, UP_TIGHT, "y")
        for name, a, b, rel in zip(("dx", "dweight", "dbias"), grads, want,
                                   (UP_TIGHT, UP_LOOSE, UP_LOOSE)):
            _up_close(a, b, rel, name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_refine_shape_kernels_ignore_alignment_and_repeat(f32_cuda, dtype):
    """At the refine shape the aligned and the misaligned x give the same
    bits (bf16: the TMA forward and the cp.async one; both dtypes: the
    16-byte and the scalar copies of dX and dCK), and repeats do too."""
    bf16 = dtype == "bf16"
    v = (_bf16_up_inputs if bf16 else _up_inputs)(REFINE_SHAPES[1],
                                                  f32_cuda, seed=81)

    def run(x):
        return [fuc.upsample2_conv_fused(x, v["weight"], v["bias"]),
                *fuc.upsample2_conv_backward(x, v["weight"], v["gy"])]

    first, again, off = run(v["x"]), run(v["x"]), run(
        _misaligned_copy(v["x"]))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(a, b) for a, b in zip(first, off))


@pytest.mark.parametrize("layout", ["rows", "grid"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sampler_forward_at_64px_gives_the_plain_bits(cuda, dtype, layout):
    """The augmentation's sampler on 64x64x3 reals: the per-quad kernel
    (the image staged in shared memory: 48 KiB in f32, widened to 4
    channels in bf16) in both dtypes, bit for bit against the plain
    version, and the kernel of a misaligned image (per pixel) too."""
    from catgen_torch.kernels import bilinear_grid

    torch_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    assert bilinear.forward_kind(64, 64, 3, torch_dtype) == "per_quad"
    img, rows, out_hw = _inputs((4, 64, 64, 3, 64, 64), cuda, seed=82)
    img, rows = img.to(torch_dtype), rows.to(torch_dtype)
    if layout == "rows":
        run = lambda im: bilinear.launch(im, rows, out_hw)  # noqa: E731
    else:
        grid = _bf16_grid(rows, out_hw)
        run = lambda im: bilinear_grid.launch(im, grid)  # noqa: E731
    got, again, other = run(img), run(img), run(_misaligned(img))
    torch.cuda.synchronize()
    want = bilinear.bilinear_sample_rows_plain(img, rows, out_hw)
    assert torch.equal(got, want)
    assert torch.equal(got, again) and torch.equal(got, other)
