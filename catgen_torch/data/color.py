"""Color-space conversions on NHWC float tensors in [0, 1]: the
counterpart of ``catgen/data/color.py``.

  * ``y``: the reference's luma weights 0.21 R + 0.72 G + 0.07 B (not
    BT.601);
  * ``yuv``: BT.601 full-range matrices (torch image package);
  * ``hsl``: standard HSL, all channels in [0, 1] (hue wraps).
"""

from __future__ import annotations

import numpy as np
import torch

_Y_WEIGHTS = np.array([0.21, 0.72, 0.07], np.float32)

_RGB2YUV = np.array([
    [0.299, 0.587, 0.114],
    [-0.14713, -0.28886, 0.436],
    [0.615, -0.51499, -0.10001],
], np.float32)
_YUV2RGB = np.array([
    [1.0, 0.0, 1.13983],
    [1.0, -0.39465, -0.58060],
    [1.0, 2.03211, 0.0],
], np.float32)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device, like.dtype)


def rgb_to_y(images: torch.Tensor) -> torch.Tensor:
    """(N,H,W,3) -> (N,H,W,1) with the 0.21/0.72/0.07 mix."""
    return torch.einsum("nhwc,c->nhw", images,
                        _const(_Y_WEIGHTS, images))[..., None]


def y_to_rgb(images: torch.Tensor) -> torch.Tensor:
    """(N,H,W,1) -> (N,H,W,3) by channel repeat."""
    return images.repeat_interleave(3, dim=-1)


def rgb_to_yuv(images: torch.Tensor) -> torch.Tensor:
    return torch.einsum("nhwc,dc->nhwd", images, _const(_RGB2YUV, images))


def yuv_to_rgb(images: torch.Tensor) -> torch.Tensor:
    return torch.einsum("nhwc,dc->nhwd", images, _const(_YUV2RGB, images))


def rgb_to_hsl(images: torch.Tensor) -> torch.Tensor:
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    l = (maxc + minc) * 0.5
    delta = maxc - minc
    one = torch.ones_like(delta)
    safe = torch.where(delta > 0, delta, one)
    s = torch.where(
        delta > 0,
        delta / torch.where(l < 0.5, maxc + minc,
                            2.0 - maxc - minc + 1e-12),
        torch.zeros_like(delta))
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(
        maxc == r, bc - gc,
        torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0),
                    torch.zeros_like(h))
    return torch.stack([h, s, l], dim=-1)


def hsl_to_rgb(images: torch.Tensor) -> torch.Tensor:
    h, s, l = images[..., 0], images[..., 1], images[..., 2]
    q = torch.where(l < 0.5, l * (1 + s), l + s - l * s)
    p = 2 * l - q

    def hue(t):
        t = torch.remainder(t, 1.0)
        return torch.where(
            t < 1 / 6, p + (q - p) * 6 * t,
            torch.where(t < 1 / 2, q,
                        torch.where(t < 2 / 3,
                                    p + (q - p) * (2 / 3 - t) * 6, p)))

    return torch.stack([hue(h + 1 / 3), hue(h), hue(h - 1 / 3)], dim=-1)


_TO = {"rgb": lambda x: x, "y": rgb_to_y, "yuv": rgb_to_yuv,
       "hsl": rgb_to_hsl}
_FROM = {"rgb": lambda x: x, "y": y_to_rgb, "yuv": yuv_to_rgb,
         "hsl": hsl_to_rgb}


def rgb_to_colorspace(images: torch.Tensor, colorspace: str) -> torch.Tensor:
    try:
        return _TO[colorspace](images)
    except KeyError:
        raise ValueError(f"unknown color space {colorspace!r}") from None


def colorspace_to_rgb(images: torch.Tensor, colorspace: str) -> torch.Tensor:
    try:
        return _FROM[colorspace](images)
    except KeyError:
        raise ValueError(f"unknown color space {colorspace!r}") from None


def channels(colorspace: str) -> int:
    return 1 if colorspace == "y" else 3


def normalize(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1] with clamping (training's ``--normalize``)."""
    return torch.clamp(images * 2.0 - 1.0, -1.0, 1.0)


def denormalize(images: torch.Tensor) -> torch.Tensor:
    return torch.clamp((images + 1.0) * 0.5, 0.0, 1.0)

