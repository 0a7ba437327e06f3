"""GAN helpers the sampling path needs: the counterparts of
``uniform_noise``, ``generate`` and ``discriminate`` in
``catgen/train/gan.py``. The train step is ROADMAP Queue A item 1.

The modules own their weights, so ``generate`` and ``discriminate`` take
the module where catgen takes the module and its variables.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def uniform_noise(generator: torch.Generator, n: int, noise_dim: int,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Noise ~ U(-1, 1) of shape (n, noise_dim). Drawn on the generator's
    device and then moved to ``device``, so a seed gives the same noise
    whichever device the models run on."""
    u = torch.rand((n, noise_dim), generator=generator,
                   device=generator.device)
    return (u * 2.0 - 1.0).to(device if device is not None else u.device)


def generate(g: nn.Module, noise: torch.Tensor) -> torch.Tensor:
    """G forward in eval mode (BN reads its running statistics)."""
    g.eval()
    with torch.inference_mode():
        return g(noise)


def discriminate(d: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """D scores (N,) in eval mode."""
    d.eval()
    with torch.inference_mode():
        return d(images)[:, 0]
