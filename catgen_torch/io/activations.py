"""Layer-activation grids: the counterpart of ``catgen/io/activations.py``
(the reference's per-layer activity windows behind ``--weightsVisFreq``).

For each top-level child of a ``Sequential`` model, a PNG grid of the
first sample's activation is written under ``<dir>/<NN>_<child>.png``:
feature-map tiles (up to 64 channels) for an image, one square tile for
a feature vector; other ranks are skipped.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from catgen_torch.core.module import Sequential, apply_with_intermediates
from catgen_torch.io.grids import save_grid


def _normalize01(a: np.ndarray) -> np.ndarray:
    lo, hi = float(a.min()), float(a.max())
    return (a - lo) / (hi - lo + 1e-8)


def save_activation_grids(model: Sequential, x: torch.Tensor, out_dir: str,
                          max_channels: int = 64) -> list:
    """Runs ``model`` on ``x`` in eval mode; returns the files written."""
    _, inters = apply_with_intermediates(model, x)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for idx, (name, act) in enumerate(inters):
        a = act[:1].float().cpu().numpy()    # the first sample
        if a.ndim == 4:                      # (1, H, W, C): channel tiles
            c = min(a.shape[-1], max_channels)
            tiles = np.transpose(a[0, :, :, :c], (2, 0, 1))[..., None]
        elif a.ndim == 2:                    # (1, F): one square tile
            f = a[0]
            side = int(np.ceil(np.sqrt(f.size)))
            pad = np.zeros(side * side, np.float32)
            pad[:f.size] = f
            tiles = pad.reshape(1, side, side, 1)
        else:
            continue
        path = os.path.join(out_dir, f"{idx:02d}_{name}.png")
        save_grid(path, _normalize01(tiles))
        written.append(path)
    return written
