"""The 64px Laplacian-pyramid stage: the counterpart of
``catgen/models/refine.py``.

``RefineStage`` takes a 32x32 image to 64x64: the image is bilinearly
upsampled (``data/ops.py::resize_bilinear``) and a conv net predicts a
bounded residual on top of it,

    out = clip(upsample(x) + 0.5 * tanh(residual), 0, 1)

The residual head sees the trunk's features (whose upsample-conv follows
the per-layer route of ``kernels/config.py``: the trunk is a plain
``Sequential``, never the ladder) beside the upsampled base.
``create_G64_stack`` composes noise -> G32up-c -> refine into one 64x64
generator; ``create_D64`` is the 64px discriminator.

Child names are catgen's: a stack's children are ``00_G32up_c`` and
``01_RefineStage``, and the stage's are ``trunk`` and ``head``, so
``--G_freeze 00_G32up_c`` and checkpoint keys mean the same in both
packages.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from catgen_torch.core.module import Sequential
from catgen_torch.data.ops import resize_bilinear
from catgen_torch.kernels.upsample_conv import UpsampleConv
from catgen_torch.models.zoo import (ImageShape,
                                     create_G_decoder_upsampling32c)
from catgen_torch.nn.layers import (AvgPool, BatchNorm, Conv, Dense, Dropout,
                                    Flatten, PReLU, Sigmoid, SpatialDropout,
                                    weak)


class RefineStage(nn.Module):
    """(N, H, W, C) image -> (N, 2H, 2W, C) refined image. ``width`` is the
    trunk's width."""

    def __init__(self, channels: int, width: int = 64,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.channels = channels
        self.trunk = Sequential([
            Conv(channels, width, (3, 3)), PReLU(),
            UpsampleConv(width, width, (5, 5)), BatchNorm(width, axis_name),
            PReLU(),
            Conv(width, width // 2, (3, 3)), PReLU(),
        ], name="trunk")
        self.head = Conv(width // 2 + channels, channels, (3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # catgen's rounding points: the base resized in f32 and returned in
        # x's dtype, cast to the features' dtype before the concatenation
        n, h, w, _ = x.shape
        base = resize_bilinear(x, (2 * h, 2 * w))
        feats = self.trunk(x)
        residual = self.head(torch.cat([feats, base.to(feats.dtype)], dim=-1))
        return torch.clamp(
            base + weak(0.5, residual.dtype) * torch.tanh(residual), 0.0, 1.0)


def create_G_refine64(image: ImageShape, noise_dim: int = 100,
                      axis_name: Optional[str] = None) -> RefineStage:
    """The refinement stage alone (it takes 32x32 images)."""
    del noise_dim
    return RefineStage(image[2], axis_name=axis_name)


def create_G64_stack(image: ImageShape, noise_dim: int,
                     axis_name: Optional[str] = None) -> Sequential:
    """noise -> G32up-c -> refine -> 64x64 image, one generator."""
    h, w, c = image
    if (h, w) != (64, 64):
        raise ValueError(f"the stacked generator makes 64x64 images, not "
                         f"{h}x{w}")
    base = create_G_decoder_upsampling32c((32, 32, c), noise_dim,
                                          axis_name)
    return Sequential([base, RefineStage(c, axis_name=axis_name)],
                      name="G64_stack")


def create_D64(image: ImageShape,
               axis_name: Optional[str] = None) -> Sequential:
    """The 64px discriminator: D32e's topology (convs, PReLU, spatial
    dropout, average pools) with one more stride-2 stage."""
    h, w, c = image
    n_feat = (h // 16) * (w // 16) * 256
    return Sequential([
        Conv(c, 64, (3, 3)), PReLU(), SpatialDropout(0.2), AvgPool(2),
        Conv(64, 128, (3, 3)), PReLU(), SpatialDropout(0.2), AvgPool(2),
        Conv(128, 128, (3, 3)), PReLU(), SpatialDropout(0.2), AvgPool(2),
        Conv(128, 256, (3, 3)), PReLU(), SpatialDropout(0.2), AvgPool(2),
        Conv(256, 256, (3, 3)), PReLU(), SpatialDropout(0.5),
        Flatten(),
        Dense(n_feat, 1024), PReLU(), Dropout(0.5),
        Dense(1024, 512), PReLU(), Dropout(0.5),
        Dense(512, 1), Sigmoid(),
    ], name="D64")
