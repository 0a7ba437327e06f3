"""The two collapse-signal statistics the training harness logs with each
visualization: a copy of ``sat_fraction`` and ``per_pixel_std`` from
``catgen/eval/collapse.py`` (numpy only). The collapse detector itself is
not ported yet (ROADMAP Queue A item 4)."""

from __future__ import annotations

import numpy as np


def sat_fraction(images: np.ndarray, tol: float = 0.04) -> float:
    """Fraction of pixel values at the rails ([0,1] images)."""
    x = np.asarray(images, np.float32)
    return float(((x < tol) | (x > 1.0 - tol)).mean())


def per_pixel_std(images: np.ndarray) -> float:
    """Mean across-batch std per pixel (the quality report's diversity
    statistic)."""
    return float(np.mean(np.std(np.asarray(images, np.float32), axis=0)))
