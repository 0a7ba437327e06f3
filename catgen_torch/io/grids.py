"""Image-grid artifacts with epoch stamping, numpy only.

A copy of ``to_grid`` and ``save_grid`` from ``catgen/io/grids.py`` (the
reference's imagesToGridTensor / saveImagesAsGrid with the bitmap-digit
epoch stamp). Images are NHWC floats in [0, 1]; grids are written as PNG
via PIL.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

# 5x3 bitmap digit font (rows x cols)
_DIGITS = {
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
}


def _stamp_number(canvas: np.ndarray, number: int) -> None:
    """Draws ``number`` as white-on-black 5x3 digits at the top-left."""
    text = str(number)
    h, w, _ = canvas.shape
    x = 1
    canvas[0:7, 0:1 + len(text) * 4, :] = 0.0
    for ch in text:
        glyph = _DIGITS.get(ch)
        if glyph is None:
            continue
        for r, row in enumerate(glyph):
            for c, bit in enumerate(row):
                if bit == "1" and r + 1 < h and x + c < w:
                    canvas[r + 1, x + c, :] = 1.0
        x += 4


def to_grid(images: np.ndarray, nrow: Optional[int] = None,
            pad: int = 1, epoch: Optional[int] = None) -> np.ndarray:
    """(N,H,W,C) floats [0,1] -> (GH,GW,3) grid array."""
    images = np.asarray(images, np.float32)
    n, h, w, c = images.shape
    if c == 1:
        images = np.repeat(images, 3, axis=-1)
    if nrow is None:
        nrow = int(np.ceil(np.sqrt(n)))
    ncol = int(np.ceil(n / nrow))
    grid = np.ones((ncol * (h + pad) + pad, nrow * (w + pad) + pad, 3),
                   np.float32) * 0.5
    for i in range(n):
        r, col = divmod(i, nrow)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = np.clip(images[i], 0, 1)
    if epoch is not None:
        _stamp_number(grid, epoch)
    return grid


def save_grid(path: str, images, nrow: Optional[int] = None,
              epoch: Optional[int] = None) -> str:
    """Writes the grid PNG/JPG (directory auto-created) and returns path.
    ``images`` is a numpy array (move tensors to the host first)."""
    from PIL import Image

    grid = to_grid(np.asarray(images), nrow=nrow, epoch=epoch)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)
    return path
