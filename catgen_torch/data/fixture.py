"""Synthetic cat-face fixture corpus, numpy only.

A copy of ``make_fixture_images`` and ``write_fixture_dataset`` from
``catgen/data/fixture.py``: deterministic procedurally drawn 64x64 cat-ish
faces (head ellipse, triangle ears, eyes, nose) with pose and color
jitter, so that the sampling path has a corpus to search without the real
dataset. Same seed, same images as catgen's.
"""

from __future__ import annotations

import os

import numpy as np


def _draw_face(rng: np.random.RandomState, size: int = 64):
    """Returns (img float32 [0,1], (cy, cx, ry, rx) head geometry)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy, cx = size / 2 + rng.uniform(-3, 3), size / 2 + rng.uniform(-3, 3)
    img = np.empty((size, size, 3), np.float32)
    bg = rng.uniform(0.1, 0.9, size=3).astype(np.float32)
    img[:] = bg + rng.normal(0, 0.03, (size, size, 3))

    fur = np.array([rng.uniform(0.45, 0.85), rng.uniform(0.35, 0.65),
                    rng.uniform(0.2, 0.45)], np.float32)
    dark = fur * 0.55

    ry = size * 0.34 * rng.uniform(0.9, 1.1)
    rx = size * 0.38 * rng.uniform(0.9, 1.1)
    head = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0

    def triangle(apex_y, apex_x, half_w, height):
        rel_y = yy - apex_y
        in_h = (rel_y >= 0) & (rel_y <= height)
        spread = (rel_y / max(height, 1)) * half_w
        return in_h & (np.abs(xx - apex_x) <= spread)

    ear_off = rx * 0.62
    ear_h = size * 0.22
    e1 = triangle(cy - ry - ear_h * 0.45, cx - ear_off, size * 0.10, ear_h)
    e2 = triangle(cy - ry - ear_h * 0.45, cx + ear_off, size * 0.10, ear_h)
    img[head | e1 | e2] = fur

    eye_c = np.array([rng.uniform(0.5, 0.9), rng.uniform(0.6, 0.9),
                      rng.uniform(0.1, 0.4)], np.float32)
    for sx in (-1, 1):
        ex = cx + sx * rx * 0.42
        ey = cy - ry * 0.15
        eye = (((yy - ey) / (size * 0.055)) ** 2 +
               ((xx - ex) / (size * 0.075)) ** 2) <= 1.0
        pupil = (((yy - ey) / (size * 0.05)) ** 2 +
                 ((xx - ex) / (size * 0.018)) ** 2) <= 1.0
        img[eye] = eye_c
        img[pupil] = np.array([0.05, 0.05, 0.05], np.float32)

    nose = triangle(cy + ry * 0.25, cx, size * 0.045, size * 0.07)
    img[nose] = np.array([0.75, 0.4, 0.45], np.float32)
    mouth = (np.abs(xx - cx) < size * 0.012) & \
            (yy > cy + ry * 0.32) & (yy < cy + ry * 0.55)
    img[mouth] = dark

    return np.clip(img, 0.0, 1.0), (cy, cx, ry, rx)


def make_fixture_images(n: int, size: int = 64, seed: int = 0) -> np.ndarray:
    """Returns (n, size, size, 3) uint8."""
    rng = np.random.RandomState(seed)
    out = np.stack([_draw_face(rng, size)[0] for _ in range(n)])
    return (out * 255).astype(np.uint8)


def write_fixture_dataset(directory: str, n: int = 64, size: int = 64,
                          seed: int = 0) -> str:
    """Writes n JPEG faces into ``directory`` as ``cat_XXXXX.jpg``."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    for i, arr in enumerate(make_fixture_images(n, size, seed)):
        Image.fromarray(arr).save(
            os.path.join(directory, f"cat_{i:05d}.jpg"), quality=92)
    return directory
