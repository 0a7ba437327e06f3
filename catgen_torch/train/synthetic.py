"""Synthetic-fake image generators for the V validator: the counterpart of
``catgen/train/synthetic.py``.

V learns to tell real photos from synthetically corrupted ones
(train_v.lua's factory) and then rates G's samples. Four generators, one
picked per batch with p=1/4 each, then with p=0.33 mixed with a second
synthetic batch:

  * Mix    -- alpha-blend two random training images through a mask;
  * Stamp  -- blend an image with a circularly shifted copy of itself;
  * Warp   -- ``warp_flow`` with a flow field built from two masks (the
             grid sampler kernel on CUDA tensors);
  * Random -- coloured cloud noise from mask products with per-channel
             circular offsets.

Masks are random-walk "gaussian" overlays (four of a precomputed bank
combined and blurred) or scan-line "pixelwise" overlays.

Randomness: the branch choices are made on the host by the caller's
``np.random.RandomState``, draw for draw as catgen's; every pixel-shaped
draw comes from a ``Draws`` in catgen's order, so a parity test replays
catgen's draws. Two choices need a draw on the host: whether a batch's
overlay is gaussian or pixelwise (catgen's ``lax.cond`` on a random bit),
and the pixelwise scan, whose threshold walk runs on the host over the
drawn steps (``_threshold_walk``); each costs one device-to-host copy.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from catgen_torch.core.random import Draws
from catgen_torch.nn.spatial_transformer import warp_flow

# ---------------------------------------------------------------------------
# overlay bank (host, built once)
# ---------------------------------------------------------------------------


def build_overlay_bank(height: int, width: int, n: int = 1000,
                       n_points: int = 10000, seed: int = 0) -> np.ndarray:
    """(n, H, W) float32 random-walk point-accumulation masks, normalized to
    max 1: catgen's bank, the same ``RandomState`` calls in the same order,
    so a seed gives catgen's bank bit for bit. The visits are counted in
    Python integers (catgen adds 1.0 to a float32 cell: the same whole
    numbers) and the walk steps are Python tuples, which takes a third off
    the time; the draws take the rest.

    The walk: with p=.02 jump somewhere new, with p=.10 step back to the
    previous position, otherwise move to a random in-bounds 8-neighbour.
    """
    rng = np.random.RandomState(seed)
    rand, randint = rng.rand, rng.randint
    bank = np.zeros((n, height, width), np.float32)
    dirs = ((-1, 0), (-1, 1), (0, 1), (1, 1),
            (1, 0), (1, -1), (0, -1), (-1, -1))
    for i in range(n):
        counts = [0] * (height * width)
        cy, cx = randint(height), randint(width)
        ly, lx = randint(height), randint(width)
        for _ in range(n_points):
            if rand() < 0.02:
                ly, lx = cy, cx
                cy, cx = randint(height), randint(width)
            elif rand() < 0.10:
                cy, cx = ly, lx
            else:
                ly, lx = cy, cx
                while True:
                    dy, dx = dirs[randint(8)]
                    ny, nx = ly + dy, lx + dx
                    if 0 <= ny < height and 0 <= nx < width:
                        cy, cx = ny, nx
                        break
            counts[cy * width + cx] += 1
        ov = bank[i]
        ov[...] = np.asarray(counts, np.float32).reshape(height, width)
        m = ov.max()
        if m > 0:
            ov /= m
    return bank


def gaussian_kernel(size: int, sigma: float = None,
                    device=None) -> torch.Tensor:
    """torch7's ``image.gaussian(size)``: a 2-D gaussian normalized to max
    1, sigma 0.25*size pixels by default."""
    if sigma is None:
        sigma = 0.25 * size
    ax = torch.arange(size, dtype=torch.float32,
                      device=device) - (size - 1) / 2.0
    g1 = torch.exp(-0.5 * torch.square(ax / sigma))
    k = torch.outer(g1, g1)
    return k / k.max()


def blur(masks: torch.Tensor, blur_size: int) -> torch.Tensor:
    """(N, H, W) masks convolved 'same' with the gaussian kernel, then
    divided by their max. An even size pads one less before than after,
    as catgen does: ``F.pad``, then a valid convolution, TF32 off."""
    if blur_size <= 0:
        return masks
    k = gaussian_kernel(blur_size, device=masks.device)
    p = (blur_size - 1) // 2
    q = blur_size - 1 - p
    x = F.pad(masks[:, None], (p, q, p, q))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x, k[None, None])[:, 0]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    mx = y.amax(dim=(1, 2), keepdim=True)
    return y / torch.clamp(mx, min=1e-8)


def gaussian_overlays(draws, bank: torch.Tensor, n: int,
                      blur_size: int = 4) -> torch.Tensor:
    """n fresh (H, W) masks: clamp(2*o1 - o2) + 2*clamp(o3*o4), clamped,
    blurred, from four random bank masks each."""
    idx = draws.randint(0, bank.shape[0], (4, n)).to(bank.device)
    o1, o2, o3, o4 = (bank[idx[i]] for i in range(4))
    out = torch.clamp(2.0 * o1 - o2, 0.0, 1.0)
    out = torch.clamp(out + 2.0 * o3 * o4, 0.0, 1.0)
    return blur(out, blur_size)


def _threshold_walk(p0: torch.Tensor, p_change: torch.Tensor,
                    walk: torch.Tensor) -> torch.Tensor:
    """(total, n) thresholds of the pixelwise scan: p starts at ``p0`` and
    after each pixel moves by -/+``p_change`` (``walk`` true/false),
    clipped to [0, 1], in float32 as catgen's ``lax.scan`` does. The
    sequential walk runs on the host, one column at a time on float32
    scalars (~0.4 ms per 1024 steps): one copy down, one up."""
    host = torch.cat([p0[None], p_change[None], walk.to(p0.dtype)]).cpu()
    host = host.numpy().astype(np.float32)
    zero, one = np.float32(0.0), np.float32(1.0)
    cols = []
    for j in range(host.shape[1]):
        p, step, col = host[0, j], host[1, j], []
        for down in (host[2:, j] > 0.5).tolist():
            col.append(p)
            p = p - step if down else p + step
            if p < zero:
                p = zero
            elif p > one:
                p = one
        cols.append(col)
    return torch.from_numpy(np.array(cols, np.float32).T.copy()).to(
        p0.device)


def pixelwise_overlays(draws, n: int, height: int,
                       width: int) -> torch.Tensor:
    """(n, H, W) scan-line correlated threshold noise: pixel t (row-major)
    is ``min(2u, 1)`` where a second uniform exceeds the walk's threshold,
    else 0."""
    p0 = draws.uniform((n,))
    p_change = draws.uniform((n,)) / 10.0
    total = height * width
    vals = torch.clamp(2.0 * draws.uniform((total, n)), max=1.0)
    thresh = draws.uniform((total, n))
    walk = draws.bernoulli(0.5, (total, n))
    p = _threshold_walk(p0, p_change, walk)
    pixels = torch.where(thresh > p, vals, torch.zeros_like(vals))
    return pixels.T.reshape(n, height, width)


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------


def _div_by_max(imgs: torch.Tensor) -> torch.Tensor:
    mx = imgs.amax(dim=(1, 2, 3), keepdim=True)
    return imgs / torch.clamp(mx, min=1e-8)


def _batch_overlay(draws, bank: torch.Tensor, height: int,
                   width: int) -> torch.Tensor:
    """ONE (H, W) mask for the whole batch: gaussian or pixelwise on one
    random bit (read on the host)."""
    if bool(draws.bernoulli(0.5, ())):
        return gaussian_overlays(draws, bank, 1, 4)[0]
    return pixelwise_overlays(draws, 1, height, width)[0].to(bank.device)


def mix_images(img1: torch.Tensor, img2: torch.Tensor,
               overlay: torch.Tensor) -> torch.Tensor:
    """overlay*img1 + (1-overlay)*img2, then per-image /max. ``overlay`` is
    (H, W) shared by the batch or (N, H, W)."""
    ov = overlay[..., None]
    return _div_by_max(ov * img1 + (1.0 - ov) * img2)


def synthetic_mix(draws, img1: torch.Tensor, img2: torch.Tensor,
                  bank: torch.Tensor) -> torch.Tensor:
    """Mix: two random training images blended through one shared mask."""
    _, h, w, _ = img1.shape
    return mix_images(img1, img2, _batch_overlay(draws, bank, h, w))


def _roll(imgs: torch.Tensor, dy: torch.Tensor,
          dx: torch.Tensor) -> torch.Tensor:
    """Circular shift of each (H, W, ...) image of the batch by its own
    (dy, dx): ``out[i, y, x] = imgs[i, (y+dy_i) % H, (x+dx_i) % W]``, one
    gather. ``dy`` and ``dx`` may carry trailing axes (N, K): the shifts
    of K copies, stacked after the batch axis."""
    h, w = imgs.shape[1:3]
    ar = torch.arange(h, device=imgs.device)
    ys = (ar + dy[..., None]) % h                      # (N, [K,] H)
    xs = (torch.arange(w, device=imgs.device) + dx[..., None]) % w
    batch = torch.arange(imgs.shape[0], device=imgs.device)
    batch = batch.reshape((-1,) + (1,) * (ys.dim()))   # (N, [1,] 1, 1)
    return imgs[batch, ys[..., :, None], xs[..., None, :]]


def synthetic_stamp(draws, imgs: torch.Tensor,
                    bank: torch.Tensor) -> torch.Tensor:
    """Stamp: each image blended with a copy of itself shifted (with wrap)
    by 1-10 pixels per axis, through one shared gaussian mask."""
    n = imgs.shape[0]
    ov = gaussian_overlays(draws, bank, 1, 4)[0][None, :, :, None]
    dy = draws.randint(1, 11, (n,)).to(imgs.device)
    dx = draws.randint(1, 11, (n,)).to(imgs.device)
    return _div_by_max((1.0 - ov) * imgs + ov * _roll(imgs, dy, dx))


def synthetic_warp(draws, imgs: torch.Tensor,
                   bank: torch.Tensor) -> torch.Tensor:
    """Warp: a flow field from two masks scaled to [-1, 1] times a length
    of 2-5 pixels per image."""
    n, h, w, _ = imgs.shape
    o1 = gaussian_overlays(draws, bank, 1, 4)[0] * 2.0 - 1.0
    o2 = gaussian_overlays(draws, bank, 1, 4)[0] * 2.0 - 1.0
    length = 1.0 + draws.randint(1, 5, (n,)).to(
        device=imgs.device, dtype=imgs.dtype)
    flow = torch.stack([o1.expand(n, h, w) * length[:, None, None],
                        o2.expand(n, h, w) * length[:, None, None]], dim=-1)
    return _div_by_max(warp_flow(imgs, flow))


def synthetic_random(draws, bank: torch.Tensor, n: int = 16,
                     height: int = 32, width: int = 32,
                     channels: int = 3) -> torch.Tensor:
    """Random: a base colour plus o1 * shifted(o2) - shifted(o3), channel c
    shifted by (c+1)*(dy, dx), then min-shifted and max-normalized."""
    o1 = gaussian_overlays(draws, bank, 1, 10)[0]
    o2 = gaussian_overlays(draws, bank, 1, 10)[0]
    o3 = gaussian_overlays(draws, bank, n, 4)
    off = (draws.randint(1, 11, (n, 2)) - 5).to(bank.device)
    base = draws.uniform((n, 1, 1, channels)).to(bank.device)
    mult = torch.arange(1, channels + 1, device=bank.device)
    dy = mult * off[:, :1]                              # (N, C)
    dx = mult * off[:, 1:]
    o2s = _roll(o2.expand(n, height, width), dy, dx)    # (N, C, H, W)
    o3s = _roll(o3, dy, dx)
    img = (o1 * o2s - o3s).permute(0, 2, 3, 1) + base
    mn = img.amin(dim=(1, 2, 3), keepdim=True)
    return _div_by_max(img + torch.abs(mn))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

MIX, WARP, STAMP, RANDOM = range(4)


def make_batch_generator(bank: torch.Tensor,
                         image_shape: Tuple[int, int, int]):
    """Returns ``generate(draws, branch, sub_branch, submix, reals4) ->
    imgs``: ``branch`` and ``sub_branch`` (host ints, 0 Mix, 1 Warp, 2
    Stamp, 3 Random) pick the generator and the recursive mix's second
    one, ``submix`` (host bool) applies that mix. ``reals4`` is (4, n, H,
    W, C) fresh real batches: [0] and [1] feed the primary generator, [2]
    and [3] the second."""
    h, w, c = image_shape

    def gen_one(draws, idx, r1, r2):
        if idx == MIX:
            return synthetic_mix(draws, r1, r2, bank)
        if idx == WARP:
            return synthetic_warp(draws, r1, bank)
        if idx == STAMP:
            return synthetic_stamp(draws, r1, bank)
        return synthetic_random(draws, bank, r1.shape[0], h, w, c)

    def generate(draws, branch: int, sub_branch: int, submix: bool,
                 reals4: torch.Tensor) -> torch.Tensor:
        imgs = gen_one(draws, int(branch), reals4[0], reals4[1])
        if submix:
            other = gen_one(draws, int(sub_branch), reals4[2], reals4[3])
            imgs = mix_images(imgs, other, _batch_overlay(draws, bank, h, w))
        return imgs

    return generate


class SyntheticImageFactory:
    """The host-side dispatcher of ``VHarness.visualize``: picks Mix, Warp,
    Stamp or Random with p=1/4, then with p=0.33 alpha-mixes with a second
    synthetic batch. Its ``RandomState`` sequence is catgen's draw for
    draw; its pixel draws come from a ``Draws`` on the bank's device
    seeded with ``seed ^ 0x5EED``. ``branches`` lists the generators it
    ran, in order."""

    def __init__(self, bank: torch.Tensor,
                 image_shape: Tuple[int, int, int], seed: int = 0):
        self.bank = bank
        self.image_shape = tuple(image_shape)
        self._np = np.random.RandomState(seed)
        self.draws = Draws(torch.Generator(bank.device).manual_seed(
            seed ^ 0x5EED))
        self.branches: List[int] = []

    def _one_batch(self, n: int, sample_reals: Callable) -> torch.Tensor:
        h, w, c = self.image_shape
        p = self._np.rand()
        branch = MIX if p < 0.25 else WARP if p < 0.5 else (
            STAMP if p < 0.75 else RANDOM)
        self.branches.append(branch)
        if branch == MIX:
            return synthetic_mix(self.draws, sample_reals(n),
                                 sample_reals(n), self.bank)
        if branch == WARP:
            return synthetic_warp(self.draws, sample_reals(n), self.bank)
        if branch == STAMP:
            return synthetic_stamp(self.draws, sample_reals(n), self.bank)
        return synthetic_random(self.draws, self.bank, n, h, w, c)

    def __call__(self, n: int, sample_reals: Callable) -> torch.Tensor:
        """sample_reals: callable(n) -> (n, H, W, C) random training
        images."""
        imgs = self._one_batch(n, sample_reals)
        if self._np.rand() < 0.33:
            other = self._one_batch(n, sample_reals)
            h, w, _ = self.image_shape
            overlay = _batch_overlay(self.draws, self.bank, h, w)
            imgs = mix_images(imgs, other, overlay)
        return imgs
