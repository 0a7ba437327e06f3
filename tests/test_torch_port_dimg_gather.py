"""The order of the gather d_img kernel (catgen_torch/csrc/
bilinear_sample_bwd.cu, ``dimg_gather``), emulated on the CPU.

The kernel turns the sampler's d_img scatter into a gather. For each pass
of up to 1024 output pixels of a sample, every entry (output pixel pi, tap
k) is bucketed by the input pixel it reaches. Each of the block's 8 warps
takes a contiguous range of the pass's pixels and counts its entries per
bin with integer atomics. A scan over (bin, warp) gives each warp its run
in each bin. Each warp then places its entries in order, 32 a round, and
the lanes that hit one bin take consecutive slots in lane order. Then one
warp per input pixel sums the bin's entries in order in f32, each term
rounded as the plain version's autograd rounds it, ``(g * wy') * wx'``,
and carries the sum on into the next pass.

``gather_dimg`` below runs those steps in numpy and torch, in the order
the kernel runs them. The placements' order does not matter: the atomics
count exactly, and each warp writes only its own run. So bins placed with
the warps and the counts in shuffled orders come out the same. The card
test ``test_gather_dimg_gives_the_emulated_bits``
(test_torch_port_cuda.py) holds the kernel to these sums bit for bit.

Here the emulation is held against the port's plain backward
(``bilinear_sample_rows_backward_plain``, autograd's scatter-adds), and
against catgen's VJPs on the CPU: the XLA ``bilinear_sample`` under
``jax.vjp``, and the v4 Pallas kernel in interpret mode. Shapes: the
branch shape (16x16 -> 48x16) at 8 channels, a non-square 9x11x33 image ->
7x5, a zoomed-in transform whose 768 outputs land on a few taps, and a
48x48 output that takes three passes.
"""

import numpy as np
import pytest
import torch

from catgen_torch.kernels import bilinear

WARPS = 8           # kGatherWarps
PASS_PIXELS = 1024  # kGatherPixels
# the kernel's sums run in another order than autograd's scatter-adds:
# f32 rounding of sums of up to ~4 P / (H W) terms, within 1e-5 + 1e-5 x
# the largest plain value (chip_smoke.py's BWD_ATOL, BWD_RTOL)
BWD_ATOL, BWD_RTOL = 1e-5, 1e-5

# (N, H, W, C, Ho, Wo, zoom): coordinates uniform in [-1.2, 1.2] x zoom
CASES = {
    "branch": (2, 16, 16, 8, 48, 16, 1.0),
    "non_square": (2, 9, 11, 33, 7, 5, 1.0),
    "zoomed": (2, 16, 16, 8, 48, 16, 0.01),
    "three_passes": (1, 9, 7, 4, 48, 48, 1.0),
}


def _inputs(case, seed=0):
    n, h, w, c, ho, wo, zoom = CASES[case]
    rng = np.random.RandomState(seed)
    img = rng.rand(n, h, w, c).astype(np.float32)
    rows = (rng.uniform(-1.2, 1.2, (n, 2, ho * wo)) * zoom).astype(
        np.float32)
    g = rng.uniform(-1.0, 1.0, (n, ho, wo, c)).astype(np.float32)
    return img, rows, g, (ho, wo)


def taps(rows, h, w):
    """make_taps of bilinear_taps.cuh for one sample's (2, P) rows, in f32
    as the plain version computes it: (P, 4) input pixel of each tap, wy,
    wx (P,)."""
    r = torch.as_tensor(rows)
    fy = torch.clamp((r[0] + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
    fx = torch.clamp((r[1] + 1.0) * 0.5 * (w - 1), 0.0, w - 1)
    y0 = (torch.clamp(torch.floor(fy), 0, h - 2).long() if h > 1
          else torch.zeros_like(fy, dtype=torch.long))
    x0 = (torch.clamp(torch.floor(fx), 0, w - 2).long() if w > 1
          else torch.zeros_like(fx, dtype=torch.long))
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    pix = torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1],
                      dim=1)
    return pix.numpy(), (fy - y0.float()).numpy(), (fx - x0.float()).numpy()


def place(bins, hw, warp_order, count_order):
    """The bucket step of one pass: ``bins`` (4 np,) is the input pixel of
    each entry e = 4 (pi - p0) + k. Counts per (bin, warp) in
    ``count_order`` (the atomics' order), an exclusive scan over (bin,
    warp), then each warp in ``warp_order`` places its entries in rounds of
    32 lanes, a group of lanes on one bin in lane order. Returns (entries
    bin by bin, the start of each bin, its end)."""
    n_ent = bins.size
    span = -(-(n_ent // 4) // WARPS)
    owner = (np.arange(n_ent) // 4) // max(span, 1)
    cur = np.zeros(hw * WARPS, np.int64)
    for e in count_order:
        cur[bins[e] * WARPS + owner[e]] += 1
    cur = np.concatenate([[0], np.cumsum(cur)[:-1]])
    ent = np.full(n_ent, -1, np.int64)
    for warp in warp_order:
        e0, e1 = 4 * min(warp * span, n_ent // 4), \
            4 * min(warp * span + span, n_ent // 4)
        for base in range(e0, e1, 32):
            lanes = np.arange(base, min(base + 32, e1))
            for b in np.unique(bins[lanes]):        # __match_any_sync
                group = lanes[bins[lanes] == b]     # in lane order
                at = cur[b * WARPS + warp]
                ent[at:at + group.size] = group
                cur[b * WARPS + warp] = at + group.size
    ends = cur.reshape(hw, WARPS)[:, -1]
    starts = np.concatenate([[0], ends[:-1]])
    return ent, starts, ends


def gather_dimg(rows, g, hw_shape, rng=None):
    """The gather kernel's d_img of (N, 2, P) rows and g (N, P, C) for an
    (H, W) image, in its order: (N, H, W, C) f32. With ``rng``, each pass
    is placed with its counts and warps in a random order."""
    h, w = hw_shape
    n, p, c = g.shape
    hw = h * w
    out = torch.zeros((n, hw, c), dtype=torch.float32)
    for ni in range(n):
        pix, wy, wx = taps(rows[ni], h, w)
        gt = torch.as_tensor(g[ni])
        for p0 in range(0, max(p, 1), PASS_PIXELS):
            np_ = min(PASS_PIXELS, p - p0)
            bins = pix[p0:p0 + np_].reshape(-1)
            count_order = np.arange(bins.size)
            warp_order = np.arange(WARPS)
            if rng is not None:
                count_order = rng.permutation(count_order)
                warp_order = rng.permutation(warp_order)
            ent, starts, ends = place(bins, hw, warp_order, count_order)
            pi, k = p0 + ent // 4, ent % 4
            # the weight's rounding of the plain version's autograd
            a = torch.as_tensor(np.where(k >= 2, wy[pi],
                                         np.float32(1) - wy[pi]))
            b = torch.as_tensor(np.where(k % 2 == 1, wx[pi],
                                         np.float32(1) - wx[pi]))
            terms = (gt[pi] * a[:, None]) * b[:, None]    # (4 np, C)
            acc = out[ni]
            lengths = ends - starts
            for r in range(int(lengths.max(initial=0))):  # one add a step
                q = np.nonzero(lengths > r)[0]
                acc[q] = acc[q] + terms[starts[q] + r]
    return out.reshape(n, h, w, c)


def _plain(img, rows, g, out_hw):
    return bilinear.bilinear_sample_rows_backward_plain(
        torch.tensor(img), torch.tensor(rows), torch.tensor(g), out_hw,
        need_coords=False)[0].numpy()


def _emulated(img, rows, g, rng=None):
    n, h, w, c = img.shape
    return gather_dimg(rows, g.reshape(n, -1, c), (h, w), rng).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_gather_matches_plain_backward(case):
    img, rows, g, out_hw = _inputs(case, seed=1)
    want = _plain(img, rows, g, out_hw)
    got = _emulated(img, rows, g)
    bound = BWD_ATOL + BWD_RTOL * np.abs(want).max()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound


def test_zoomed_outputs_land_on_a_few_taps():
    # the zoomed case is the one a per-input-pixel list has to survive: a
    # few bins hold every entry of the sample
    _, rows, _, _ = _inputs("zoomed", seed=1)
    pix, _, _ = taps(rows[0], 16, 16)
    counts = np.bincount(pix.reshape(-1), minlength=256)
    assert np.count_nonzero(counts) <= 4
    assert counts.max() >= 768


@pytest.mark.parametrize("case", ["branch", "zoomed", "three_passes"])
def test_bins_do_not_depend_on_the_placements_order(case):
    # the atomics and the warps run in any order on the card: bins placed
    # in two shuffled orders hold the same entries in the same order, in
    # (output pixel, tap) order, and give the same bits
    _, rows, g, (ho, wo) = _inputs(case, seed=2)
    n, h, w = CASES[case][:3]
    pix, _, _ = taps(rows[0], h, w)
    bins = pix[:min(PASS_PIXELS, ho * wo)].reshape(-1)
    placed = [place(bins, h * w, rng.permutation(WARPS),
                    rng.permutation(bins.size))
              for rng in (np.random.RandomState(3), np.random.RandomState(4))]
    for a, b in zip(*placed):
        np.testing.assert_array_equal(a, b)
    ent, starts, ends = placed[0]
    for q in np.nonzero(ends > starts)[0]:
        run = ent[starts[q]:ends[q]]
        assert (np.diff(run) > 0).all() and (bins[run] == q).all()
    c = g.shape[-1]
    first, second = (gather_dimg(rows, g.reshape(n, -1, c), (h, w),
                                 np.random.RandomState(s)) for s in (5, 6))
    assert torch.equal(first, second)


@pytest.mark.parametrize("case", ["branch", "non_square", "zoomed"])
def test_emulated_gather_matches_catgen_vjp(case):
    # catgen's XLA sampler (its CPU path) under jax.vjp: f32 on both sides,
    # sums in another order; d_img takes no edge derivative, so the
    # coordinates' edge clamps do not matter here: 1e-5 + 1e-5 x max
    import jax
    import jax.numpy as jnp

    from catgen.nn.spatial_transformer import bilinear_sample

    img, rows, g, (ho, wo) = _inputs(case, seed=3)
    n = img.shape[0]
    grid = rows.transpose(0, 2, 1).reshape(n, ho, wo, 2)
    _, vjp = jax.vjp(bilinear_sample, jnp.asarray(img), jnp.asarray(grid))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = _emulated(img, rows, g)
    assert np.abs(got - want).max() <= BWD_ATOL + BWD_RTOL * \
        np.abs(want).max()


@pytest.mark.parametrize("case", ["branch", "non_square", "zoomed"])
def test_emulated_gather_matches_catgen_v4_interpret(case):
    # the TPU kernel's _bwd in interpret mode rounds g and its weight masks
    # to bf16 (8 bits of mantissa): within 2e-2 of the largest gradient,
    # v4's own tolerance (test_torch_port_bilinear.py)
    import jax
    import jax.numpy as jnp

    from catgen.kernels.pallas_bilinear_v4 import bilinear_sample_rows

    img, rows, g, out_hw = _inputs(case, seed=4)
    _, vjp = jax.vjp(lambda a, b: bilinear_sample_rows(a, b, out_hw, True),
                     jnp.asarray(img), jnp.asarray(rows))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = _emulated(img, rows, g)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


# the bf16 kernel reads bf16 g and coordinates exactly into f32, sums as
# above and rounds each d_img value once: the emulation on bf16 values,
# rounded once, against the plain version's bf16 backward (its f32
# autograd rounded once) within one bf16 unit plus 2^-16 of the largest
# (two f32 sums of another order may round to neighbouring bf16 values),
# and against catgen's v4 in interpret mode on bf16 inputs, v4's tolerance
BF16_ULPS, BF16_FLOOR = 1, 2.0 ** -16


def _bf16(a):
    return torch.as_tensor(a).bfloat16()


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_bf16_gather_matches_plain_bf16_backward(case):
    img, rows, g, out_hw = _inputs(case, seed=5)
    img, rows, g = (_bf16(a) for a in (img, rows, g))
    n, h, w, c = img.shape
    got = gather_dimg(rows.float().numpy(),
                      g.float().numpy().reshape(n, -1, c), (h, w)).bfloat16()
    want = bilinear.bilinear_sample_rows_backward_plain(
        img, rows, g, out_hw, need_coords=False)[0]
    assert want.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    spacing = torch.exp2(torch.floor(torch.log2(
        want.float().abs().clamp(min=2.0 ** -126))) - 7)
    bound = BF16_ULPS * spacing + BF16_FLOOR * want.float().abs().max()
    assert bool((err <= bound).all())


@pytest.mark.parametrize("case", ["branch", "zoomed"])
def test_emulated_bf16_gather_matches_catgen_v4_interpret(case):
    import jax
    import jax.numpy as jnp

    from catgen.kernels.pallas_bilinear_v4 import bilinear_sample_rows

    img, rows, g, out_hw = _inputs(case, seed=6)
    img, rows, g = (_bf16(a).float().numpy() for a in (img, rows, g))
    _, vjp = jax.vjp(lambda a, b: bilinear_sample_rows(a, b, out_hw, True),
                     jnp.asarray(img, jnp.bfloat16),
                     jnp.asarray(rows, jnp.bfloat16))
    want = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0].astype(
        jnp.float32))
    got = _emulated(img, rows, g)
    got = torch.as_tensor(got).bfloat16().float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
