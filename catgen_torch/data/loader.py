"""Image corpus loader: the counterpart of ``catgen/data/loader.py``.

Each JPEG is decoded once (PIL) into a uint8 host cache; ``load_images``,
``load_random_images`` and ``epoch_batches`` move a slice, a random sample
or one epoch of training batches to the device in one copy and there
convert it to float NHWC in [0, 1] (in [-1, 1] with ``normalize``) at the
model's scale (an exact 2x2 average for a 2x downscale, else the bilinear
resize) and color space. File order is one global sort, as
catgen's; random samples draw from the same numpy stream as catgen's for
the same seed, so both packages train on the same reals. catgen's native
multithreaded decoder and multi-host sharding are not ported yet (ROADMAP
Queue A items 5 and 11).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

from catgen_torch.data import color as colorlib
from catgen_torch.data import ops


def scan_paths(dirs: Sequence[str], ext: str = "jpg") -> List[str]:
    """All files with ``ext`` under ``dirs``, one stable global sort."""
    paths: List[str] = []
    for d in dirs:
        if not os.path.isdir(d):
            raise FileNotFoundError(f"dataset dir not found: {d}")
        for name in os.listdir(d):
            if name.lower().endswith("." + ext.lower()):
                paths.append(os.path.join(d, name))
    if not paths:
        raise FileNotFoundError(f"no *.{ext} files under {list(dirs)}")
    return sorted(paths)


def decode(path: str, size: int) -> np.ndarray:
    """One image as (size, size, 3) uint8 RGB, bilinear-resized if needed."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if im.size != (size, size):
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, np.uint8)


class ImageDataset:
    """uint8 RAM-cached image corpus; float NHWC batches on ``device``."""

    def __init__(self, dirs: Sequence[str], ext: str = "jpg",
                 scale: int = 32, colorspace: str = "rgb",
                 source_size: int = 64, seed: int = 1,
                 device: Optional[torch.device] = None,
                 normalize: bool = False):
        self.paths = scan_paths(dirs, ext)
        self.scale = scale
        self.colorspace = colorspace
        self.source_size = source_size
        self.normalize = normalize        # --normalize: [0,1] -> [-1,1]
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self._rng = np.random.RandomState(seed)
        self._cache: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.paths)

    def family_ids(self, start: int, count: int) -> np.ndarray:
        """Source-image family id per file in [start, start+count): files
        named ``{img_idx}_{aug_idx}.jpg`` (the offline augmentation's
        naming) share a family iff their img_idx matches; any other name
        gets an id of its own."""
        ids = []
        for i, p in enumerate(self.paths[start:start + count]):
            stem = os.path.splitext(os.path.basename(p))[0]
            m = re.fullmatch(r"(\d+)_(\d+)", stem)
            ids.append(int(m.group(1)) if m else -(i + 1))
        return np.asarray(ids, np.int64)

    def _ensure_cache(self) -> np.ndarray:
        if self._cache is None:
            s = self.source_size
            out = np.empty((len(self.paths), s, s, 3), np.uint8)
            for i, p in enumerate(self.paths):
                out[i] = decode(p, s)
            self._cache = out
        return self._cache

    def sample_uint8(self, count: int) -> np.ndarray:
        """(count, src, src, 3) uint8 random sample (with replacement when
        count exceeds the corpus)."""
        cache = self._ensure_cache()
        idx = self._rng.choice(len(cache), size=count,
                               replace=count > len(cache))
        return cache[idx]

    def slice_uint8(self, start: int, count: int) -> np.ndarray:
        return self._ensure_cache()[start:start + count]

    def postprocess(self, raw_uint8: np.ndarray) -> torch.Tensor:
        """uint8 (N,S,S,3) -> float (N,scale,scale,C) in [0,1], on device."""
        x = torch.from_numpy(np.ascontiguousarray(raw_uint8)).to(
            self.device).float() / 255.0
        if self.scale != x.shape[1]:
            if x.shape[1] == 2 * self.scale:
                x = ops.downscale2(x)
            else:
                x = ops.resize_bilinear(x, (self.scale, self.scale))
        x = colorlib.rgb_to_colorspace(x, self.colorspace)
        return colorlib.normalize(x) if self.normalize else x

    def load_random_images(self, count: int) -> torch.Tensor:
        return self.postprocess(self.sample_uint8(count))

    def load_images(self, start: int, count: int) -> torch.Tensor:
        return self.postprocess(self.slice_uint8(start, count))

    def epoch_batches(self, n_examples: int, half_batch: int,
                      d_iterations: int = 1) -> torch.Tensor:
        """One epoch of training reals in one host-to-device copy:
        (n_examples // half_batch, d_iterations * half_batch, H, W, C).
        Each step takes ``d_iterations`` fresh half-batches, as the
        reference's D_iterations loop refills its reals."""
        nb = max(n_examples // half_batch, 1)
        per_step = d_iterations * half_batch
        x = self.postprocess(self.sample_uint8(nb * per_step))
        return x.reshape((nb, per_step) + tuple(x.shape[1:]))
