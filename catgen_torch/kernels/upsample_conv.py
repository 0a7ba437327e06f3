"""Nearest-2x upsample + same conv as four collapsed parity convs: the
counterpart of ``catgen/kernels/upsample_conv.py``.

The upsampled image U[q, r] = x[q//2, r//2] has only H*W distinct pixels,
so for each output parity (d, e) the k x k conv collapses onto a smaller
kernel over x (k=3 -> 2x2, k=5 -> 3x3). The four parity convs run on the
original H x W image and their outputs interleave into 2H x 2W. Here
they are plain convolutions, left to cuDNN as catgen leaves them to XLA:
the default ``collapsed`` route. ``UpsampleConv`` follows
``kernels/config.py``: ``pallas`` takes the hand-written single-pass
kernels (``kernels/fused_upsample_conv.py``), ``naive`` the unfused
reference. Weights are the plain conv's, so checkpoints are
interchangeable.

Weights are OIHW (PyTorch's layout); images NHWC. As catgen's, the
collapse sums the taps in f32 (or f64) and rounds the collapsed kernel
once to the weight's dtype; the convolution casts it to the image's dtype
(bf16 under ``compute_dtype``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from catgen_torch.core import initializers
from catgen_torch.kernels import config
from catgen_torch.nn.layers import to_nchw, to_nhwc


def _collapse_matrix(k: int, parity: int) -> Tuple[np.ndarray, int]:
    """Binary matrix M (k' x k) with M[u - u_min, a + p] = 1 where
    u = floor((parity + a)/2), a in [-p, p]; returns (M, u_min)."""
    p = (k - 1) // 2
    offsets = np.arange(-p, p + 1)
    u = np.floor_divide(parity + offsets, 2)
    u_min, u_max = int(u.min()), int(u.max())
    m = np.zeros((u_max - u_min + 1, k), np.float32)
    for idx in range(len(offsets)):
        m[u[idx] - u_min, idx] = 1.0
    return m, u_min


@functools.lru_cache(maxsize=64)
def _collapse_on(k: int, parity: int, device: torch.device,
                 dtype: torch.dtype) -> Tuple[torch.Tensor, int]:
    """``_collapse_matrix`` as a tensor on ``device``, made once: a copy
    from host memory on every call would make the host wait for the card.
    Made outside inference mode, so that autograd may save it."""
    m, u_min = _collapse_matrix(k, parity)
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device, dtype), u_min


def parity_pads(k: int, parity: int) -> Tuple[int, int]:
    """(before, after): the explicit, asymmetric padding of one axis of a
    parity conv that reproduces the zero-padded 'same' conv of the naive
    upsample+conv."""
    m, u_min = _collapse_matrix(k, parity)
    return -u_min, m.shape[0] - 1 + u_min


def collapse_weights(weight: torch.Tensor, parity_h: int, parity_w: int):
    """Collapses an OIHW kernel (Cout, Cin, k, k) for one output parity:
    the taps summed in f32 (f64 for an f64 weight), rounded once to the
    weight's dtype.

    Returns (collapsed kernel (Cout, Cin, k'h, k'w), (pad_h, pad_w)), the
    pads of ``parity_pads``."""
    acc = torch.promote_types(weight.dtype, torch.float32)
    mh = _collapse_on(weight.shape[2], parity_h, weight.device, acc)[0]
    mw = _collapse_on(weight.shape[3], parity_w, weight.device, acc)[0]
    ck = torch.einsum("ua,vb,oiab->oiuv", mh, mw,
                      weight.to(acc)).to(weight.dtype)
    return ck, (parity_pads(weight.shape[2], parity_h),
                parity_pads(weight.shape[3], parity_w))


def parity_plane(x: torch.Tensor, ck: torch.Tensor, pad_h, pad_w):
    """One parity's conv of x (N, H, W, Cin) NHWC with its collapsed OIHW
    kernel, cast to x's dtype: (N, H, W, Cout)."""
    # F.pad takes (left, right, top, bottom); conv2d pads only
    # symmetrically, and these pads are not
    xc = F.pad(to_nchw(x), (pad_w[0], pad_w[1], pad_h[0], pad_h[1]))
    return to_nhwc(F.conv2d(xc, ck.to(x.dtype)))


def interleave(planes) -> torch.Tensor:
    """The four parity planes (N, H, W, C), in parity order (d, e), as the
    output (N, 2H, 2W, C), out[2i + d, 2j + e] = plane_de[i, j]."""
    n, h, w, cout = planes[0].shape
    y = torch.stack(planes, dim=-2)                 # (N, H, W, 4, Cout)
    y = y.reshape(n, h, w, 2, 2, cout)
    y = y.permute(0, 1, 3, 2, 4, 5)                 # (N, H, 2, W, 2, Cout)
    return y.reshape(n, 2 * h, 2 * w, cout)


def upsample2_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Fused nearest-2x upsample + same conv (no bias).

    x (N, H, W, Cin) NHWC; weight (Cout, Cin, k, k), k odd. Returns
    (N, 2H, 2W, Cout), equal up to reassociation to
    ``upsample2_conv_reference``."""
    planes = []
    for d in (0, 1):
        for e in (0, 1):
            ck, pads = collapse_weights(weight, d, e)
            planes.append(parity_plane(x, ck, *pads))
    return interleave(planes)


def upsample2_conv_reference(x: torch.Tensor,
                             weight: torch.Tensor) -> torch.Tensor:
    """Unfused reference: nearest-2x upsample, then the k x k same conv."""
    n, h, w, c = x.shape
    up = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    up = up.reshape(n, 2 * h, 2 * w, c)
    p = (weight.shape[2] - 1) // 2
    return to_nhwc(F.conv2d(to_nchw(up), weight.to(x.dtype), padding=p))


class UpsampleConv(nn.Module):
    """Nearest-2x upsample fused with a k x k same conv, on the route
    ``config.resolve_upsample_impl()`` names. Parameters are the plain
    conv's ``weight`` and ``bias``."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 init: str = "heuristic"):
        super().__init__()
        if kernel_size[0] % 2 != 1 or kernel_size[1] % 2 != 1:
            raise ValueError(f"kernel size must be odd, got {kernel_size}")
        self.in_channels = in_channels
        self.features = features
        self.kernel_size = tuple(kernel_size)
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
        # imported here: fused_upsample_conv builds on this module
        from catgen_torch.kernels import fused_upsample_conv

        impl = config.resolve_upsample_impl()
        if impl == "pallas":
            # the kernel takes its operands in x's dtype, as catgen's
            return fused_upsample_conv.upsample2_conv_bias(
                x, self.weight.to(x.dtype), self.bias.to(x.dtype))
        fn = upsample2_conv if impl == "collapsed" else \
            upsample2_conv_reference
        return fn(x, self.weight) + self.bias.to(x.dtype)
