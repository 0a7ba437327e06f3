"""Image ops on NHWC tensors: the part of ``catgen/data/ops.py`` that the
sampling path's loader uses. Bilinear resize and train-time augmentation
are ROADMAP Queue A items 7 and 1."""

from __future__ import annotations

import torch


def downscale2(images: torch.Tensor) -> torch.Tensor:
    """Exact 2x2 area-average downscale (64 -> 32), NHWC."""
    n, h, w, c = images.shape
    return images.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
