"""Host-side plans of the hand-written kernels, on the CPU: which shapes
the upsample-conv forward's TMA kernel takes and the box of x it loads a
128-pixel tile as (``fused_upsample_conv.fwd_bf16_box``); the ST-conv's
tensor-core kernel: the shapes it takes (``st_conv.bf16_kind``), its
shared memory and its packed weights, which must unpack to catgen's
``kernel.reshape(9 * c, f).astype(bfloat16)`` (pallas_st_conv.py), also
when the wrapper packs them in two ops (``st_conv.pack_weights_bf16``);
the f32 ST-conv's tiled kernel: the shapes it takes (``st_conv.f32_kind``)
and its shared memory; the bf16 per-quad d_coords kernel's shared memory
(``bilinear.dcoords_quad_smem_bytes``), and the plain bf16 d_coords at
the channel counts that kernel takes beyond C = 3 against catgen's v4
backward in interpret mode. The kernels themselves run in
tests/test_torch_port_cuda.py on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen.kernels.pallas_bilinear_v4 import \
    bilinear_sample_rows as v4_sample_rows
from catgen_torch.kernels import bilinear
from catgen_torch.kernels import fused_upsample_conv as fuc
from catgen_torch.kernels import st_conv

# G32up-c's stage inputs (H = W, Cin) and the box each takes
STAGE_BOXES = [((4, 512), (4, 4, 8)), ((8, 512), (8, 8, 2)),
               ((16, 256), (16, 8, 1))]


@pytest.mark.parametrize("stage, box", STAGE_BOXES)
@pytest.mark.parametrize("n", [640, 320, 3])
def test_fwd_box_at_g32upc_stages(stage, box, n):
    hw, cin = stage
    assert fuc.fwd_bf16_box(n, hw, hw, cin) == box


@pytest.mark.parametrize("shape, box", [
    ((2, 4, 4, 96), None),            # cin % 64 != 0
    ((2, 6, 6, 64), None),            # 36 pixels: neither divides 128
    ((2, 12, 12, 64), None),          # 144 pixels: nor a multiple of it
    ((2, 16, 24, 64), None),          # rows of 24 do not split 128
    ((2, 24, 16, 64), (16, 8, 1)),    # 384 pixels in rows of 16
    ((1, 4, 32, 128), (32, 4, 1)),    # 128 pixels, one image a tile
    ((1, 2, 128, 64), (128, 1, 1)),   # a row of 128
    ((1, 3, 384, 64), (128, 1, 1)),   # rows of three tiles
    ((5, 1, 1, 64), (1, 1, 128)),     # one-pixel images
    ((0, 4, 4, 512), None),           # an empty batch
])
def test_fwd_box_at_ragged_shapes(shape, box):
    assert fuc.fwd_bf16_box(*shape) == box


def test_fwd_box_needs_an_aligned_x():
    assert fuc.fwd_bf16_box(640, 4, 4, 512, aligned=False) is None


@pytest.mark.parametrize("shape", [(3, 4, 4, 64), (2, 8, 8, 64),
                                   (2, 24, 16, 64), (1, 3, 384, 64),
                                   (5, 1, 1, 64), (1, 4, 32, 64)])
def test_fwd_box_holds_each_tile_in_row_order(shape):
    # the box at a tile's first pixel, its elements in TMA's order (w
    # fastest, then h, then n), are the tile's pixels m0 .. m0 + 127; it
    # never runs past an image's rows or columns, only past the batch
    n, h, w, cin = shape
    bw, bh, bn = fuc.fwd_bf16_box(n, h, w, cin)
    total = n * h * w
    for m0 in range(0, total, 128):
        n0, rem = divmod(m0, h * w)
        i0, j0 = divmod(rem, w)
        assert i0 + bh <= h and j0 + bw <= w
        nb, hb, wb = np.meshgrid(np.arange(bn), np.arange(bh), np.arange(bw),
                                 indexing="ij")
        flat = (((n0 + nb) * h + i0 + hb) * w + j0 + wb).reshape(-1)
        np.testing.assert_array_equal(flat, np.arange(m0, m0 + 128))


def _misaligned(t):
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return buf[1:].view(t.shape)


def test_forward_kind_follows_x_alignment():
    x = torch.zeros((2, 8, 8, 128), dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    assert fuc.forward_kind_bf16(x) == "tma"
    assert fuc.forward_kind_bf16(_misaligned(x)) == "cp_async"
    assert fuc.forward_kind_bf16(x[..., :96].contiguous()) == "cp_async"


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("f", [8, 64])
def test_packed_weights_unpack_to_catgens_matrix(c, f):
    kernel = np.random.RandomState(10 * c + f).randn(3, 3, c, f).astype(
        np.float32)
    want = np.asarray(jnp.asarray(kernel).reshape(9 * c, f).astype(
        jnp.bfloat16).astype(jnp.float32))
    packed = st_conv.pack_weights(torch.tensor(kernel).bfloat16())
    kt = st_conv.mma_k_tiles(c)
    assert packed.dtype == torch.bfloat16
    assert tuple(packed.shape) == (f // 8, 8, 4, kt, 2, 2)
    got = st_conv.unpack_weights(packed, c).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_packed_weights_are_in_fragment_order(c):
    # lane 4 g + t of n-tile nt holds, for k-tile kt, rows 16 kt + 8 r +
    # 2 t + j of column 8 nt + g (mma.sync's B fragment), zeros past 9C
    f = 16
    kernel = torch.arange(9 * c * f, dtype=torch.float32).reshape(3, 3, c, f)
    packed = st_conv.pack_weights(kernel)
    kt_n = st_conv.mma_k_tiles(c)
    m = torch.zeros(16 * kt_n, f)
    m[:9 * c] = kernel.reshape(9 * c, f)
    for nt in range(f // 8):
        for g in range(8):
            for t in range(4):
                for kt in range(kt_n):
                    for r in range(2):
                        for j in range(2):
                            assert (packed[nt, g, t, kt, r, j]
                                    == m[16 * kt + 8 * r + 2 * t + j,
                                         8 * nt + g])


def test_mma_smem_at_d32_st3():
    # image and samp copy 12 KB under the warps' staging (4.5 KB a warp),
    # the 34 x 34 x 3 tile, 64 x 2 k-tiles of weights
    assert st_conv.mma_smem_bytes(32, 32, 3, 64, warps=4) == (
        4 * 4608 + 6944 + 4096)
    assert st_conv.mma_smem_bytes(32, 32, 3, 64) == 16 * 4608 + 6944 + 4096


@pytest.mark.parametrize("shape, kind", [
    ((640, 32, 32, 3, 64), "mma"),          # D32_st3's prefix
    ((2, 12, 20, 1, 64), "mma"),            # C = 1
    ((2, 9, 8, 4, 8), "mma"),               # C = 4 (K = 36 -> 48)
    ((2, 12, 16, 3, 31), "cuda_cores"),     # F % 8 != 0
    ((2, 8, 8, 5, 16), "cuda_cores"),       # C over 4
    ((2, 9, 11, 3, 64), "cuda_cores"),      # h w C % 8 != 0
    ((1, 64, 64, 4, 8192), "cuda_cores"),   # over the shared memory
])
def test_st_conv_bf16_kind_by_shape(shape, kind):
    n, h, w, c, f = shape
    img = torch.zeros((n, h, w, c), dtype=torch.bfloat16)
    assert st_conv.bf16_kind(img, f) == kind


def test_st_conv_bf16_kind_of_a_misaligned_image():
    img = torch.zeros((2, 32, 32, 3), dtype=torch.bfloat16)
    assert st_conv.bf16_kind(img, 64) == "mma"
    assert st_conv.bf16_kind(_misaligned(img), 64) == "cuda_cores"


def _kernel_packing(kernel):
    """st_conv_bf16_mma's packing of the f32 (3, 3, C, F) weights, as its
    prologue computes it (st_conv.cu): register pair i = (nt 32 + lane) KT
    + kt holds rows 16 kt + 2 (lane % 4) + 8 r + j (q = 2 r + j) of
    column 8 nt + lane / 4, each rounded to bf16, 0 past 9 C; returned as
    pack_weights' (F/8, 8, 4, KT, 2, 2) layout."""
    c, f = kernel.shape[2], kernel.shape[3]
    kt_n = st_conv.mma_k_tiles(c)
    flat = kernel.reshape(9 * c, f).bfloat16()
    out = torch.zeros((f // 8) * 32 * kt_n * 4, dtype=torch.bfloat16)
    for i in range((f // 8) * 32 * kt_n):
        kt, lane, nt = i % kt_n, (i // kt_n) % 32, i // (kt_n * 32)
        col, row0 = 8 * nt + lane // 4, 16 * kt + 2 * (lane % 4)
        for q in range(4):
            row = row0 + 8 * (q // 2) + q % 2
            if row < 9 * c:
                out[4 * i + q] = flat[row, col]
    return out.reshape(f // 8, 8, 4, kt_n, 2, 2)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("f", [8, 64])
def test_kernel_packing_gives_pack_weights_bits(c, f):
    # the tensor-core kernel packs the f32 weights itself (no device op on
    # the host); its packing against pack_weights on the bf16 weights
    kernel = torch.tensor(np.random.RandomState(20 * c + f).randn(
        3, 3, c, f).astype(np.float32))
    got = _kernel_packing(kernel)
    want = st_conv.pack_weights(kernel.bfloat16())
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_tiled_smem_at_d32_st3():
    # image and samp's copy 12 KB each, the 34 x 34 x 3 tile
    assert st_conv.tiled_smem_bytes(32, 32, 3) == 2 * 12288 + 34 * 34 * 12
    # a ragged width: 10 columns take 3 segments, 14 tile columns
    assert st_conv.tiled_smem_bytes(12, 10, 2) == 2 * 960 + 14 * 14 * 8


@pytest.mark.parametrize("shape, kind", [
    ((640, 32, 32, 3, 64), "tiled"),        # D32_st3's training shape
    ((256, 32, 32, 3, 64), "tiled"),        # and its sampling shape
    ((2, 32, 32, 3, 60), "tiled"),          # F = 60: bf16's ragged shape
    ((3, 12, 20, 1, 4), "tiled"),           # C = 1, F = 4
    ((2, 9, 7, 4, 128), "tiled"),           # C = 4, odd h and w
    ((2, 12, 16, 3, 31), "banded"),         # F % 4 != 0
    ((2, 8, 8, 5, 16), "banded"),           # C over 4
    ((2, 9, 11, 3, 64), "banded"),          # h w C % 4 != 0
    ((1, 160, 160, 4, 8), "banded"),        # over the shared memory
])
def test_st_conv_f32_kind_by_shape(shape, kind):
    n, h, w, c, f = shape
    img = torch.zeros((n, h, w, c))
    assert st_conv.f32_kind(img, f) == kind


def test_st_conv_f32_kind_of_a_misaligned_image():
    img = torch.zeros((2, 32, 32, 3))
    assert st_conv.f32_kind(img, 64) == "tiled"
    assert st_conv.f32_kind(_misaligned(img), 64) == "banded"


@pytest.mark.parametrize("hwc, smem, fits", [
    ((32, 32, 3), 6144 + 8192, True),       # the input ST: 6 KB + 8 KB
    ((4, 4, 31), 992 + 16 * 8 * 8, True),   # the widest C, 8 groups
    ((9, 11, 3), 608 + 99 * 8, True),       # the raw image rounded to 16
    ((128, 128, 7), 229376 + 16384 * 16, False),   # too large
])
def test_dcoords_quad_smem(hwc, smem, fits):
    got = bilinear.dcoords_quad_smem_bytes(*hwc)
    assert got == smem
    assert (got <= bilinear.OPTIN_SMEM) == fits


def _bf16_values(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("c", [1, 2, 4])
def test_plain_bf16_dcoords_matches_catgens_v4(c):
    # the per-quad d_coords kernel's range beyond C = 3: the plain bf16
    # d_coords (the kernels' arithmetic) against catgen's v4 backward in
    # interpret mode on bf16 values, at v4's tolerance (rtol 2e-2, atol
    # 1e-2 of the largest; tests/test_torch_port_bf16.py), on identity
    # grids perturbed by up to 0.3 (inside, on and past the edges)
    n, h, w = 2, 32, 32
    rng = np.random.RandomState(30 + c)
    gy, gx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    ident = np.stack([gy.ravel(), gx.ravel()]).astype(np.float32)
    rows = _bf16_values(ident + rng.uniform(-0.3, 0.3, (n, 2, h * w)))
    img = _bf16_values(rng.rand(n, h, w, c))
    g = _bf16_values(rng.uniform(-1, 1, (n, h, w, c)))
    got = bilinear.bilinear_sample_rows_backward_plain(
        torch.tensor(img).bfloat16(), torch.tensor(rows).bfloat16(),
        torch.tensor(g).bfloat16(), (h, w), need_img=False)[1]
    assert got.dtype == torch.bfloat16

    @jax.jit
    def v4_dcoords(a, b, cot):
        _, vjp = jax.vjp(lambda a, b: v4_sample_rows(a, b, (h, w), True),
                         a, b)
        return vjp(cot)[1]

    want = v4_dcoords(jnp.asarray(img, jnp.bfloat16),
                      jnp.asarray(rows, jnp.bfloat16),
                      jnp.asarray(g, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=1e-2 * max(1.0, np.abs(want).max()))
