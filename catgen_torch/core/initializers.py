"""Weight initializers: the four uniform-fan schemes of catgen
(``catgen/core/initializers.py``), drawn from an explicit
``torch.Generator``.

Each scheme gives a scale ``std`` and the weight is drawn
uniform(-std, std); biases are zero. fan_in / fan_out:
  * conv:   fan_in = in_channels * kh * kw, fan_out = out_channels * kh * kw
  * linear: fan_in = in_features,           fan_out = out_features
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _scale_heuristic(fan_in: int, fan_out: int) -> float:
    return math.sqrt(1.0 / (3.0 * fan_in))


def _scale_xavier(fan_in: int, fan_out: int) -> float:
    return math.sqrt(2.0 / (fan_in + fan_out))


def _scale_xavier_caffe(fan_in: int, fan_out: int) -> float:
    return math.sqrt(1.0 / fan_in)


def _scale_kaiming(fan_in: int, fan_out: int) -> float:
    # catgen's (and the original Torch code's) "kaiming" is
    # sqrt(4/(fan_in+fan_out)), not the usual sqrt(2/fan_in)
    return math.sqrt(4.0 / (fan_in + fan_out))


SCALES = {
    "heuristic": _scale_heuristic,
    "xavier": _scale_xavier,
    "xavier_caffe": _scale_xavier_caffe,
    "kaiming": _scale_kaiming,
}


def uniform_fan(method: str) -> Callable[..., None]:
    """Returns init_(tensor, fan_in, fan_out, generator), which fills
    ``tensor`` in place with uniform(-std, std)."""
    try:
        scale_fn = SCALES[method]
    except KeyError:
        raise ValueError(f"unknown init method {method!r}; "
                         f"options: {sorted(SCALES)}") from None

    def init_(tensor: torch.Tensor, fan_in: int, fan_out: int,
              generator: torch.Generator) -> None:
        std = scale_fn(fan_in, fan_out)
        u = torch.rand(tensor.shape, generator=generator,
                       device=generator.device, dtype=torch.float32)
        with torch.no_grad():
            tensor.copy_(u * (2.0 * std) - std)

    return init_
