"""Spatial transformer: affine parameter head -> grid -> bilinear sampling.
The counterpart of ``catgen/nn/spatial_transformer.py``.

Conventions (catgen's, which follow torch-stn, not ``F.affine_grid``):
  * normalized coords in [-1, 1], align-corners, in (y, x) order;
  * the affine matrix maps *output* coords to *input* sampling coords
    (inverse warping): ``row0 = [cos*s, -sin*s, tx]`` acts on (gy, gx, 1);
  * restricted parameters, in order: [angle] if rotation, [scale] if
    scaling, [tx, ty] if translation; the head starts at the identity;
  * sampling clamps to the border.

The transformers sample through ``catgen_torch.kernels.bilinear``: the
Hopper kernel on CUDA tensors, its plain version on CPU tensors.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from catgen_torch.core.module import Sequential
from catgen_torch.kernels.bilinear import (bilinear_sample_rows,
                                           bilinear_sample_rows_plain)
from catgen_torch.nn.layers import AvgPool, Conv, Dense, Flatten, LeakyReLU

Flags = Tuple[bool, bool, bool]   # (rotation, scaling, translation)


# ---------------------------------------------------------------------------
# functional pieces
# ---------------------------------------------------------------------------


def affine_matrix(params: torch.Tensor, allow_rotation: bool,
                  allow_scaling: bool,
                  allow_translation: bool) -> torch.Tensor:
    """(B, P) restricted parameters -> (B, 2, 3) affine matrices. With no
    component allowed, params are the full 6-dof matrix row-major."""
    b = params.shape[0]
    if not (allow_rotation or allow_scaling or allow_translation):
        return params.reshape(b, 2, 3)
    zeros = params.new_zeros((b,))
    i = 0
    angle = zeros
    if allow_rotation:
        angle = params[:, i]
        i += 1
    scale = params.new_ones((b,))
    if allow_scaling:
        scale = params[:, i]
        i += 1
    tx = ty = zeros
    if allow_translation:
        tx, ty = params[:, i], params[:, i + 1]
    cos = torch.cos(angle) * scale
    sin = torch.sin(angle) * scale
    row0 = torch.stack([cos, -sin, tx], dim=-1)
    row1 = torch.stack([sin, cos, ty], dim=-1)
    return torch.stack([row0, row1], dim=1)


@functools.lru_cache(maxsize=32)
def _base_rows(height: int, width: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """(3, H*W) rows [gy; gx; 1] of the normalized output grid. Made with
    numpy, so that every device gets the same values, and once per shape
    and device: a copy from host memory on every call would make the host
    wait for the card. Made outside inference mode, so that autograd may
    save it."""
    gy, gx = np.meshgrid(np.linspace(-1.0, 1.0, height),
                         np.linspace(-1.0, 1.0, width), indexing="ij")
    base = np.stack([gy.reshape(-1), gx.reshape(-1),
                     np.ones(height * width)]).astype(np.float32)
    with torch.inference_mode(False):
        return torch.from_numpy(base).to(device, dtype)


def affine_grid_rows(theta: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """(B, 2, 3) affine matrices -> (B, 2, H*W) normalized (y; x) rows, the
    layout the sampler kernel takes."""
    return torch.matmul(theta, _base_rows(height, width, theta.device,
                                          theta.dtype))


def affine_grid(theta: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, 2, 3) affine matrices -> (B, H, W, 2) normalized (y, x) coords."""
    rows = affine_grid_rows(theta, height, width)
    return rows.permute(0, 2, 1).reshape(theta.shape[0], height, width, 2)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Samples NHWC ``img`` at normalized (y, x) ``coords`` (B, Ho, Wo, 2):
    border-clamped bilinear gathers and lerps, on any device."""
    b, ho, wo, _ = coords.shape
    rows = coords.reshape(b, ho * wo, 2).permute(0, 2, 1)
    return bilinear_sample_rows_plain(img, rows, (ho, wo))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class AffineParamHead(nn.Module):
    """Final localization layer: zero weights, identity bias."""

    def __init__(self, in_features: int, allow_rotation: bool,
                 allow_scaling: bool, allow_translation: bool):
        super().__init__()
        bias = []
        if allow_rotation:
            bias.append(0.0)
        if allow_scaling:
            bias.append(1.0)
        if allow_translation:
            bias.extend([0.0, 0.0])
        if not bias:
            bias = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
        self.init_bias = tuple(bias)
        self.n_params = len(bias)
        self.weight = nn.Parameter(torch.zeros(self.n_params, in_features))
        self.bias = nn.Parameter(torch.tensor(self.init_bias))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.zero_()
            self.bias.copy_(torch.tensor(self.init_bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.linear(x, self.weight, self.bias)


def _localization_net(in_channels: int, height: int,
                      width: int) -> Sequential:
    """avgpool2 -> conv16 -> LeakyReLU -> conv16 -> LeakyReLU -> avgpool2
    -> flatten -> dense64 -> LeakyReLU."""
    return Sequential([
        AvgPool(2),
        Conv(in_channels, 16, (3, 3)),
        LeakyReLU(),
        Conv(16, 16, (3, 3)),
        LeakyReLU(),
        AvgPool(2),
        Flatten(),
        Dense(16 * (height // 4) * (width // 4), 64),
        LeakyReLU(),
    ], name="loc")


class SpatialTransformer(nn.Module):
    """Localization net -> affine params -> grid -> bilinear resample of
    the input, at the input's size. Children ``loc`` and ``head``."""

    def __init__(self, image: Tuple[int, int, int], allow_rotation: bool,
                 allow_scaling: bool, allow_translation: bool):
        super().__init__()
        h, w, c = image
        self.flags: Flags = (allow_rotation, allow_scaling, allow_translation)
        self.loc = _localization_net(c, h, w)
        self.head = AffineParamHead(64, *self.flags)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        theta = affine_matrix(self.head(self.loc(x)).float(), *self.flags)
        h, w = x.shape[1], x.shape[2]
        rows = affine_grid_rows(theta, h, w).to(x.dtype)
        return bilinear_sample_rows(x.contiguous(), rows, (h, w))


class FusedSTBranches(nn.Module):
    """D*_st3's 4-way branch block: three spatial-transformer branches and
    one plain conv branch on the same feature map, concatenated along
    channels (tails 0..n-1, then plain).

    The branches' grids are stacked along the pixel axis, (N, 2, n*H*W),
    so the sampler runs once at out_hw (n*H, W); its output is split by
    rows, H per branch. Children ``loc{i}``, ``head{i}``, ``tail{i}`` and
    ``plain``. The localization nets run one per branch (catgen's
    ``CATGEN_JOINT_LOC=0`` path; its default joint path is the same
    arithmetic reassociated)."""

    def __init__(self, tails: Sequence[nn.Module], plain: nn.Module,
                 image: Tuple[int, int, int],
                 flags: Flags = (True, True, True)):
        super().__init__()
        if not tails:
            raise ValueError("FusedSTBranches needs at least one tail")
        h, w, c = image
        self.flags: Flags = tuple(flags)
        self.n_tails = len(tails)
        for i, tail in enumerate(tails):
            self.add_module(f"loc{i}", _localization_net(c, h, w))
            self.add_module(f"head{i}", AffineParamHead(64, *self.flags))
            self.add_module(f"tail{i}", tail)
        self.plain = plain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        x = x.contiguous()
        grids = []
        for i in range(self.n_tails):
            params = getattr(self, f"head{i}")(getattr(self, f"loc{i}")(x))
            theta = affine_matrix(params.float(), *self.flags)
            grids.append(affine_grid_rows(theta, h, w))
        stacked = torch.cat(grids, dim=2).to(x.dtype)   # (N, 2, n_tails*P)
        sampled = bilinear_sample_rows(x, stacked, (self.n_tails * h, w))
        outs = [getattr(self, f"tail{i}")(sampled[:, i * h:(i + 1) * h])
                for i in range(self.n_tails)]
        outs.append(self.plain(x))
        return torch.cat(outs, dim=-1)


class FusedSTConvPReLU(nn.Module):
    """D's input prefix [SpatialTransformer -> Conv -> PReLU], children
    ``st``, ``conv`` and ``act``. catgen's single-pass Pallas version
    (kernels/pallas_st_conv.py) is off by default there; this is its split
    path."""

    def __init__(self, st: SpatialTransformer, conv: nn.Module,
                 act: nn.Module):
        super().__init__()
        self.st, self.conv, self.act = st, conv, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv(self.st(x)))
