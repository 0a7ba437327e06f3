"""Plain PyTorch layers of the reference: NHWC images, weights handed in as
tensors, nothing of the program under test. Written from the published
description of catgen's models (Conv and Dense with a bias, PReLU with one
shared slope, LeakyReLU of slope 1/3, BatchNorm over every axis but the
last, inverted dropout, spatial transformers that sample with
border-clamped, align-corners bilinear interpolation in (y, x) order).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LEAKY_SLOPE = 1.0 / 3.0


class Weights:
    """A view of a flat ``{name: tensor}`` dict under a prefix."""

    def __init__(self, tensors: Dict[str, torch.Tensor], prefix: str = ""):
        self.tensors = tensors
        self.prefix = prefix

    def __call__(self, key: str) -> torch.Tensor:
        return self.tensors[self.prefix + key]

    def sub(self, prefix: str) -> "Weights":
        return Weights(self.tensors, self.prefix + prefix)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv(x: torch.Tensor, w: Weights, key: str) -> torch.Tensor:
    """'same' convolution, stride 1, with bias."""
    weight = w(key + "weight")
    return nhwc(F.conv2d(nchw(x), weight, w(key + "bias"),
                         padding=weight.shape[-1] // 2))


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def dense(x: torch.Tensor, w: Weights, key: str) -> torch.Tensor:
    return F.linear(x, w(key + "weight"), w(key + "bias"))


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def avgpool2(x: torch.Tensor) -> torch.Tensor:
    return nhwc(F.avg_pool2d(nchw(x), 2))


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    return nhwc(F.max_pool2d(nchw(x), 2))


def batchnorm(x: torch.Tensor, w: Weights, key: str,
              train: bool) -> torch.Tensor:
    """Training: the batch's mean and biased variance; evaluation: the
    running statistics."""
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
    else:
        mean, var = w(key + "mean"), w(key + "var")
    return (x - mean) / torch.sqrt(var + BN_EPS) * w(key + "scale") \
        + w(key + "bias")


def dropout(x: torch.Tensor, draws, rate: float,
            spatial: bool = False) -> torch.Tensor:
    """Inverted dropout; a spatial one drops whole feature maps. The keep
    mask (True: kept) comes from ``draws``."""
    keep = 1.0 - rate
    shape = (x.shape[0], 1, 1, x.shape[-1]) if spatial else tuple(x.shape)
    mask = draws.bernoulli(keep, shape)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def flatten(x: torch.Tensor) -> torch.Tensor:
    """NHWC element order."""
    return x.reshape(x.shape[0], -1)


def affine_theta(params: torch.Tensor, rotation: bool, scaling: bool,
                 translation: bool) -> torch.Tensor:
    """(N, P) transformer parameters, in the order [angle] [scale]
    [tx, ty], to (N, 2, 3) matrices acting on (y, x, 1):
    [[s cos, -s sin, tx], [s sin, s cos, ty]]."""
    n = params.shape[0]
    i = 0
    zero = params.new_zeros(n)
    angle, scale, tx, ty = zero, params.new_ones(n), zero, zero
    if rotation:
        angle = params[:, i]
        i += 1
    if scaling:
        scale = params[:, i]
        i += 1
    if translation:
        tx, ty = params[:, i], params[:, i + 1]
    c, s = torch.cos(angle) * scale, torch.sin(angle) * scale
    return torch.stack([torch.stack([c, -s, tx], -1),
                        torch.stack([s, c, ty], -1)], 1)


def grid_points(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, h, w, 2) sampling points (y, x) in [-1, 1] coordinates of the
    output grid's pixels mapped through ``theta``."""
    ys = torch.linspace(-1.0, 1.0, h, dtype=torch.float64)
    xs = torch.linspace(-1.0, 1.0, w, dtype=torch.float64)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gy, gx, torch.ones_like(gy)], -1).to(
        theta.device, theta.dtype)                       # (h, w, 3)
    return torch.einsum("hwk,njk->nhwj", base, theta)


def sample(img: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of NHWC ``img`` at (N, Ho, Wo, 2) points (y, x),
    align-corners, coordinates clamped to the border."""
    grid = points.flip(-1)                               # (x, y)
    out = F.grid_sample(nchw(img), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return nhwc(out)


def resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Align-corners bilinear resize."""
    return nhwc(F.interpolate(nchw(img), size=(h, w), mode="bilinear",
                              align_corners=True))


def localization(x: torch.Tensor, w: Weights) -> torch.Tensor:
    """A transformer's localization net: avgpool2, conv16, leaky, conv16,
    leaky, avgpool2, flatten, dense64, leaky."""
    h = avgpool2(x)
    h = leaky(conv(h, w, "01_Conv."))
    h = leaky(conv(h, w, "03_Conv."))
    h = flatten(avgpool2(h))
    return leaky(dense(h, w, "07_Dense."))
