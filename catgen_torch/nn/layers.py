"""Core layers on NHWC tensors: the counterparts of ``catgen/nn/layers.py``.

Every layer takes and returns catgen's layout, images ``(N, H, W, C)`` and
features ``(N, F)``. Convolutions and pools run on a permuted view
``(N, C, H, W)`` of the NHWC tensor, which PyTorch treats as channels_last,
so no layout copy is made on the way in or out. ``Flatten`` and
``Reshape`` work in NHWC element order, so Dense weights line up with a
catgen checkpoint.

Parameter names: Conv and Dense hold ``weight`` (PyTorch's OIHW and
(out, in) layouts) and ``bias``; BatchNorm holds ``scale`` and ``bias``
with running statistics ``mean`` and ``var`` as buffers; PReLU holds
``alpha``. ``catgen_torch.io.convert`` maps them onto catgen's leaves.

``training`` (``module.train()`` / ``module.eval()``) selects train or
eval semantics, as catgen's ``train=`` flag does. The stochastic layers
draw their masks from the ``Draws`` set on the layer (``set_draws``).

Compute dtype: parameters and BatchNorm statistics stay f32, and the
activations run in the input's dtype (catgen's ``compute_dtype``, f32 or
bf16). As in catgen, each parameter is cast to the input's dtype where it
is used, a bias is added after the product is rounded to that dtype (two
operations in catgen), and a Python constant is rounded to the dtype
before it meets a tensor (``weak``: JAX's weak typing), where PyTorch
would keep it in f32 and round once. In f32 every path is what it was.
Under a ``torch.utils.checkpoint`` region of the train step's ``remat``
the dropout layers replay, in the recompute, the masks they drew, and
BatchNorm leaves its running statistics alone there
(``catgen_torch.core.random.remat_contexts``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from catgen_torch.core import initializers
from catgen_torch.core import random as crandom
from catgen_torch.core.random import Draws
from catgen_torch.dist import mesh


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def weak(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: the constant a
    JAX weak type puts beside an array of that dtype. PyTorch applies a
    Python scalar to a bf16 tensor in f32; rounded first, it gives
    catgen's bf16 result (and the same result as before in f32)."""
    return torch.tensor(value, dtype=dtype).item()


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """catgen's Dense: ``x @ W + b`` with W and b cast to x's dtype. In
    another dtype than the weights' the product is rounded before the
    bias is added, as catgen's dot and add are two operations."""
    if x.dtype == weight.dtype:
        return F.linear(x, weight, bias)
    return F.linear(x, weight.to(x.dtype)) + bias.to(x.dtype)


# ---------------------------------------------------------------------------
# parametric layers
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """Linear layer; weight (out, in), heuristic init by default."""

    def __init__(self, in_features: int, features: int,
                 init: str = "heuristic"):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.init_method = init
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        initializers.uniform_fan(self.init_method)(
            self.weight, self.in_features, self.features, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """2-D 'same' convolution (odd kernel, stride 1, padding (k-1)/2 per
    side), NHWC in and out, weight (O, I, kh, kw)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 init: str = "heuristic"):
        super().__init__()
        if kernel_size[0] % 2 != 1 or kernel_size[1] % 2 != 1:
            raise ValueError(f"kernel size must be odd, got {kernel_size}")
        self.in_channels = in_channels
        self.features = features
        self.kernel_size = tuple(kernel_size)
        self.padding = ((kernel_size[0] - 1) // 2, (kernel_size[1] - 1) // 2)
        self.init_method = init
        self.weight = nn.Parameter(
            torch.zeros(features, in_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        kh, kw = self.kernel_size
        initializers.uniform_fan(self.init_method)(
            self.weight, self.in_channels * kh * kw,
            self.features * kh * kw, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return to_nhwc(F.conv2d(to_nchw(x), self.weight, self.bias,
                                    padding=self.padding))
        # catgen: conv with the kernel cast to x's dtype, then the bias add
        y = F.conv2d(to_nchw(x), self.weight.to(x.dtype),
                     padding=self.padding)
        return to_nhwc(y) + self.bias.to(x.dtype)


class SubPixelConv(Conv):
    """A 'same' convolution to ``features * factor**2`` channels, then
    depth-to-space in catgen's order: channel ``(i * factor + j) *
    features + c`` of pixel (y, x) goes to pixel (y * factor + i, x *
    factor + j), channel c. The conv's ``weight`` and ``bias`` are this
    layer's own, at catgen's parameter path of the layer."""

    def __init__(self, in_channels: int, features: int, factor: int = 2,
                 kernel_size: Tuple[int, int] = (3, 3),
                 init: str = "heuristic"):
        super().__init__(in_channels, features * factor * factor,
                         kernel_size, init)
        self.out_features = features
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        n, h, w, _ = y.shape
        f = self.factor
        y = y.reshape(n, h, w, f, f, self.out_features)
        y = y.permute(0, 1, 3, 2, 4, 5)          # N, H, f, W, f, C
        return y.reshape(n, h * f, w * f, self.out_features)


def sync_moments(mean: torch.Tensor, mean_sq: torch.Tensor, n: int,
                 axis_name: Optional[str]):
    """(mean, mean_sq, n) over every rank of ``axis_name``: the two means
    averaged in one differentiable all-reduce, the count times the ranks;
    unchanged for ``axis_name=None``."""
    if axis_name is None:
        return mean, mean_sq, n
    both = mesh.all_reduce_mean(torch.stack([mean, mean_sq]), axis_name)
    return both[0], both[1], n * mesh.world_size(axis_name)


class BatchNorm(nn.Module):
    """BatchNorm over every axis but the last. Eval: ``x*scale + shift``
    with ``scale = gamma*rsqrt(var+eps)`` from the running statistics.
    Train: normalizes with the biased batch variance and moves the running
    mean and the unbiased running variance by ``momentum``, except in the
    recompute of a ``remat`` region, whose first pass moved them. The
    statistics are taken in f32; scale and shift are rounded to x's
    dtype.

    ``axis_name`` (``dist.mesh.DATA_AXIS``): in training the batch mean and
    mean square are averaged over the data-parallel ranks
    (``sync_moments``, differentiably: SyncBN, catgen's ``lax.pmean``), and
    the unbiased running variance counts every rank's rows."""

    momentum = 0.1
    eps = 1e-5

    def __init__(self, channels: int, axis_name: Optional[str] = None):
        super().__init__()
        self.axis_name = axis_name
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            xf = x.float()
            mean = xf.mean(dim=dims)
            mean_sq = (xf * xf).mean(dim=dims)
            n = math.prod(x.shape[:-1])
            mean, mean_sq, n = sync_moments(mean, mean_sq, n,
                                            self.axis_name)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if not crandom.recomputing():   # else the first pass did
                with torch.no_grad():
                    m = self.momentum
                    self.mean.mul_(1 - m).add_(m * mean)
                    self.var.mul_(1 - m).add_(
                        m * var * (n / max(n - 1, 1)))
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var.float() + self.eps)
        scale = (self.scale * inv).to(x.dtype)
        shift = (self.bias - self.scale * mean * inv).to(x.dtype)
        return x * scale + shift


class PReLU(nn.Module):
    """PReLU with one shared slope of shape (1,), init 0.25."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


# ---------------------------------------------------------------------------
# stateless layers
# ---------------------------------------------------------------------------


class LeakyReLU(nn.Module):
    """LeakyReLU with the reference's slope 1/3."""

    negative_slope = 1.0 / 3.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, weak(self.negative_slope, x.dtype) * x)


class Sigmoid(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x)


class Tanh(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x)


class Softmax(nn.Module):
    """Softmax over ``axis`` (the last by default)."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x, dim=self.axis)


class _MaskedDropout(nn.Module):
    """Inverted dropout: identity in eval; in train keeps each unit of
    ``mask_shape(x)`` with probability 1-rate and scales by 1/(1-rate).
    The mask comes from ``self.draws`` (a ``catgen_torch.core.random.Draws``
    or a stand-in that hands in masks drawn elsewhere), which the caller
    sets; see ``set_draws``. In the recompute of a ``remat`` region the
    layer replays the mask it drew in the first pass."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = rate
        self.draws: Optional[Draws] = None

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.draws is None:
            raise ValueError(f"{type(self).__name__} in train mode needs "
                             f"random draws (set .draws)")
        keep = 1.0 - self.rate
        mask = crandom.remat_mask(lambda: self.draws.bernoulli(
            keep, self.mask_shape(x)).to(x.device))
        return torch.where(mask, x / weak(keep, x.dtype), torch.zeros_like(x))


class Dropout(_MaskedDropout):
    """Inverted dropout, default p=0.5."""


class SpatialDropout(_MaskedDropout):
    """Drops whole feature maps: NHWC mask of shape (N, 1, 1, C)."""

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return (x.shape[0], 1, 1, x.shape[-1])


def set_draws(module: nn.Module, draws: Optional[Draws]) -> None:
    """Points every dropout layer of ``module`` at ``draws``. The layers
    draw in the order the forward reaches them, which is catgen's."""
    for m in module.modules():
        if isinstance(m, _MaskedDropout):
            m.draws = draws


class MaxPool(nn.Module):
    """Non-overlapping ``window`` x ``window`` pooling."""

    def __init__(self, window: int = 2):
        super().__init__()
        self.window = window

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_nhwc(F.max_pool2d(to_nchw(x), self.window))


class AvgPool(nn.Module):
    """Non-overlapping ``window`` x ``window`` pooling."""

    def __init__(self, window: int = 2):
        super().__init__()
        self.window = window

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_nhwc(F.avg_pool2d(to_nchw(x), self.window))


class Flatten(nn.Module):
    """(N, H, W, C) -> (N, H*W*C) in NHWC element order."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1)


class UpsampleNearest(nn.Module):
    """Nearest-neighbour ``factor`` x upsampling, standalone (G's decoders
    use the collapsed ``UpsampleConv``)."""

    def __init__(self, factor: int = 2):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.factor
        n, h, w, c = x.shape
        x = x[:, :, None, :, None, :].expand(n, h, f, w, f, c)
        return x.reshape(n, h * f, w * f, c)


class UnPooling(nn.Module):
    """Zero-stuffing unpool: each input pixel goes to the top-left of a
    ``factor`` x ``factor`` block, the rest of the block is zero."""

    def __init__(self, factor: int = 2):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.factor
        n, h, w, c = x.shape
        out = x.new_zeros((n, h, f, w, f, c))
        out[:, :, 0, :, 0, :] = x
        return out.reshape(n, h * f, w * f, c)


class Reshape(nn.Module):
    """Per-sample reshape; ``shape`` excludes the batch and is NHWC."""

    def __init__(self, shape: Tuple[int, ...]):
        super().__init__()
        self.shape = tuple(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape((x.shape[0],) + self.shape)
