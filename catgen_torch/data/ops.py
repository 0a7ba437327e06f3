"""Image ops on NHWC tensors: the counterparts of ``downscale2``,
``AugmentConfig`` and ``augment_batch`` in ``catgen/data/ops.py``.
Bilinear resize is ROADMAP Queue A item 7."""

from __future__ import annotations

import dataclasses
import math

import torch

from catgen_torch.core.random import Draws
from catgen_torch.kernels import config as kconfig
from catgen_torch.kernels.bilinear import (affine_grid_rows,
                                           bilinear_sample_rows)
from catgen_torch.nn.layers import weak
from catgen_torch.nn.spatial_transformer import affine_grid, bilinear_sample


def downscale2(images: torch.Tensor) -> torch.Tensor:
    """Exact 2x2 area-average downscale (64 -> 32), NHWC."""
    n, h, w, c = images.shape
    return images.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The reference's offline augmentation set, applied at train time:
    hflip 50%, equal-axis scale 0.93-1.08, rotation +-8 deg, translation
    +-4 px (at 64 px, rescaled to the image size), brightness +-15%,
    gaussian noise sigma 0.02."""
    hflip: bool = True
    scale_min: float = 0.93
    scale_max: float = 1.08
    rotation_deg: float = 8.0
    translation_px: float = 4.0
    translation_ref_size: int = 64
    brightness: float = 0.15
    noise_std: float = 0.02


def augment_batch(draws: Draws, images: torch.Tensor,
                  config: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """One random augmentation per image, on the images' device.

    images (N, H, W, C) in [0, 1]. The affine part (flip, scale, rotation,
    translation) is one bilinear warp, routed as catgen's: the v4 rows
    sampler under ``mxu`` with ``v4`` (the default), else
    ``bilinear_sample`` on the grid (each the Hopper kernel on CUDA
    tensors); brightness and noise are elementwise. Draws
    are taken in catgen's order: scale, angle, ty, tx, flip, brightness,
    noise. Everything runs in the images' dtype, as catgen's does: in
    bf16 the draws are rounded to bf16 and the affine matrices and grid
    are bf16 arithmetic (catgen draws them in bf16)."""
    n, h, w, _ = images.shape
    device, dtype = images.device, images.dtype

    def uniform(shape, low, high):
        return draws.uniform(shape, low, high).to(device, dtype)

    scale = uniform((n,), config.scale_min, config.scale_max)
    angle = uniform((n,), -config.rotation_deg,
                    config.rotation_deg) * weak(math.pi / 180.0, dtype)
    tpx = config.translation_px * h / config.translation_ref_size
    # pixel translation -> normalized align-corners units
    tn = 2.0 * tpx / max(h - 1, 1)
    ty = uniform((n,), -tn, tn)
    tx = uniform((n,), -tn, tn)
    if config.hflip:
        flip = torch.where(draws.bernoulli(0.5, (n,)).to(device), -1.0,
                           1.0).to(dtype)
    else:
        flip = torch.ones((n,), dtype=dtype, device=device)

    # inverse warp: the sample grid is (1/scale) R(-angle) applied to the
    # output coords, then translated; x additionally sign-flipped for hflip
    inv = 1.0 / scale
    cos = torch.cos(angle) * inv
    sin = torch.sin(angle) * inv
    row0 = torch.stack([cos, -sin * flip, ty], dim=-1)
    row1 = torch.stack([sin, cos * flip, tx], dim=-1)
    theta = torch.stack([row0, row1], dim=1)            # (N, 2, 3)
    if (kconfig.resolve_sampler_impl() == "mxu"
            and kconfig.sampler_kernel == "v4"):
        rows = affine_grid_rows(theta, h, w).to(images.dtype)
        out = bilinear_sample_rows(images.contiguous(), rows, (h, w))
    else:
        out = bilinear_sample(images.contiguous(),
                              affine_grid(theta, h, w).to(images.dtype))

    # multiplicative brightness +-15%
    bri = uniform((n, 1, 1, 1), -config.brightness, config.brightness)
    out = out * (1.0 + bri)
    if config.noise_std > 0:
        out = out + weak(config.noise_std, dtype) * draws.normal(
            out.shape).to(device, dtype)
    return torch.clamp(out, 0.0, 1.0)
