"""Image corpus loader: the counterpart of ``catgen/data/loader.py``.

Each JPEG is decoded once into a uint8 host cache, by the native
multithreaded decoder (``data/native_decode.py``) where a C++ compiler and
libjpeg are present, else by PIL (``decoder_used`` says which ran, and
``decoder_error`` why the native one did not); a file that fails to
decode raises rather than entering training as a black image. ``load_images``,
``load_random_images`` and ``epoch_batches`` move a slice, a random sample
or one epoch of training batches to the device in one copy and there
convert it to float NHWC in [0, 1] (in [-1, 1] with ``normalize``) at the
model's scale (an exact 2x2 average for a 2x downscale, else the bilinear
resize) and color space. File order is one global sort, as
catgen's; random samples draw from the same numpy stream as catgen's for
the same seed, so both packages train on the same reals.

Data parallelism: with ``shard_by_process`` each host of a multi-host run
decodes only its interleaved slice of the sorted corpus,
``paths[pi::pc]``, and offsets its sampling stream by ``7919 * pi``, as
catgen's loader does (``pi``/``pc``: the host's process index and count,
``dist.mesh``). ``epoch_batches(..., shard=(rank, world))`` draws a step's
global batch and keeps the rank's contiguous rows of it, as catgen's mesh
shards the batch.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

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


def rank_rows(raw: np.ndarray, lead: Tuple[int, ...], rank: int,
              world: int) -> np.ndarray:
    """Rank ``rank``'s share of samples ``raw`` (prod(lead) * world * k of
    them): ``raw`` seen as (*lead, world, k, ...) and the rank's (*lead, k,
    ...) taken, the contiguous share catgen's mesh gives a device."""
    n = int(np.prod(lead)) * world
    if raw.shape[0] % n:
        raise ValueError(f"{raw.shape[0]} samples do not split into "
                         f"{lead} x {world} ranks")
    x = raw.reshape(tuple(lead) + (world, -1) + raw.shape[1:])
    return x[(slice(None),) * len(lead) + (rank,)]


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
                 normalize: bool = False, decoder: Optional[str] = None,
                 shard_by_process: bool = False):
        if decoder not in (None, "native", "pil"):
            raise ValueError(f"decoder={decoder!r}: pick 'native', 'pil' "
                             f"or None (native, else PIL)")
        self.paths = scan_paths(dirs, ext)
        if shard_by_process:
            from catgen_torch.dist import mesh
            pi, pc = mesh.process_index(), mesh.process_count()
            self.paths = self.paths[pi::pc]
            seed = seed + 7919 * pi     # each host draws its own reals
        self.scale = scale
        self.colorspace = colorspace
        self.source_size = source_size
        self.normalize = normalize        # --normalize: [0,1] -> [-1,1]
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self._rng = np.random.RandomState(seed)
        self._cache: Optional[np.ndarray] = None
        self._decoder = decoder
        self.decoder_used: Optional[str] = None    # "native" | "pil"
        self.decoder_error: Optional[str] = None   # why not native

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
            self._cache = self._decode_all()
        return self._cache

    def _decode_all(self) -> np.ndarray:
        """The corpus at ``source_size``: natively unless ``decoder`` is
        "pil"; PIL where the native decoder cannot be built (unless
        ``decoder`` is "native", which then raises)."""
        s = self.source_size
        if self._decoder != "pil":
            from catgen_torch.data import native_decode
            try:
                out, ok = native_decode.decode_batch_checked(self.paths, s)
            except (ImportError, OSError) as e:
                if self._decoder == "native":
                    raise
                self.decoder_error = str(e)
            else:
                if not ok.all():
                    bad = [self.paths[i] for i in np.flatnonzero(~ok)]
                    raise ValueError(
                        f"{len(bad)} image(s) failed to decode, e.g. "
                        f"{bad[:3]}: fix or remove them (the zero-filled "
                        f"slots would otherwise enter training as "
                        f"all-black reals)")
                self.decoder_used = "native"
                return out
        else:
            self.decoder_error = "decoder='pil' was asked for"
        out = np.empty((len(self.paths), s, s, 3), np.uint8)
        for i, p in enumerate(self.paths):
            out[i] = decode(p, s)
        self.decoder_used = "pil"
        return out

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
                      d_iterations: int = 1,
                      shard: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
        """One epoch of training reals in one host-to-device copy:
        (n_examples // half_batch, d_iterations * half_batch, H, W, C).
        Each step takes ``d_iterations`` fresh half-batches, as the
        reference's D_iterations loop refills its reals.

        ``shard=(rank, world)``: ``half_batch`` is the global half batch;
        the rows of each step are drawn as above and the rank keeps its
        contiguous ``1/world`` of them (only those reach the device)."""
        nb = max(n_examples // half_batch, 1)
        raw = self.sample_uint8(nb * d_iterations * half_batch)
        raw = rank_rows(raw, (nb,), *(shard or (0, 1)))
        x = self.postprocess(raw.reshape((-1,) + raw.shape[-3:]))
        return x.reshape(raw.shape[:2] + tuple(x.shape[1:]))
