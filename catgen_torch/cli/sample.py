"""Sampling CLI: the counterpart of ``catgen/cli/sample.py``.

Loads a catgen-format adversarial checkpoint, generates ``--count``
images, ranks them with D, writes real/random/best/worst grids and, with
``--neighbours``, the nearest-neighbour pair grid of the best 16 against
the training corpus.

    python -m catgen_torch.cli.sample --save logs --neighbours --device cuda

catgen's ``--platform`` (a jax platform choice) becomes ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

import torch

from catgen_torch import models
from catgen_torch.cli.common import (add_dataset_args, add_device_arg,
                                     build_dataset, resolve_device)
from catgen_torch.data import color as colorlib
from catgen_torch.io import checkpoint as ckpt
from catgen_torch.io.convert import gan_from_leaves
from catgen_torch.io.grids import save_grid
from catgen_torch.sample import (interleave_pairs, neighbours_of_best,
                                 sample_and_rank)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of a checkpoint's ``config`` metadata (catgen's
    HarnessConfig) that rebuild its models, with catgen's defaults."""
    scale: int = 32
    colorspace: str = "rgb"
    noise_dim: int = 100
    g_model: str = "default"
    d_model: str = "default"

    @property
    def image_shape(self):
        return (self.scale, self.scale, colorlib.channels(self.colorspace))

    @classmethod
    def from_meta(cls, meta: dict) -> "ModelConfig":
        config = meta.get("config", {})
        return cls(**{f.name: config[f.name]
                      for f in dataclasses.fields(cls) if f.name in config})


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_dataset_args(p)
    p.add_argument("--save", default="logs")
    p.add_argument("--out", default=None,
                   help="output dir (default <save>/samples)")
    p.add_argument("--network", default=None,
                   help="checkpoint path (default <save>/adversarial.ckpt)")
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--count", type=int, default=1024)
    p.add_argument("--neighbours", action="store_true",
                   help="nearest-neighbour search of best 16 vs training set")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--scale", type=int, default=32)
    p.add_argument("--colorSpace", default="rgb",
                   choices=["rgb", "yuv", "hsl", "y"])
    add_device_arg(p)
    return p.parse_args(argv)


def load_gan(path: str, device: torch.device):
    """Rebuilds G and D from the checkpoint's metadata and loads their
    weights (optimizer leaves are not read). Returns (g, d, config)."""
    leaves, meta = ckpt.load(path, ("g_params", "g_state",
                                    "d_params", "d_state"))
    config = ModelConfig.from_meta(meta)
    g = models.G_REGISTRY[config.g_model](config.image_shape,
                                          config.noise_dim)
    d = models.D_REGISTRY[config.d_model](config.image_shape)
    gan_from_leaves(g, d, leaves)
    return g.to(device).eval(), d.to(device).eval(), config


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Runs the CLI; returns, per run, the sampler's result dict and (with
    ``--neighbours``) the neighbour dict under 'neighbours'."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    path = args.network or os.path.join(args.save,
                                        ckpt.adversarial_filename())
    g, d, config = load_gan(path, device)
    args.scale, args.colorSpace = config.scale, config.colorspace
    out = args.out or os.path.join(args.save, "samples")
    dataset = build_dataset(args, device)

    def to_rgb(x):
        return colorlib.colorspace_to_rgb(x, config.colorspace).cpu().numpy()

    runs = []
    for run in range(args.runs):
        generator = torch.Generator().manual_seed(args.seed + run)
        reals = dataset.load_random_images(64)
        save_grid(os.path.join(out, f"run{run}_real64.png"), to_rgb(reals),
                  nrow=8)
        result = sample_and_rank(g, d, generator, noise_dim=config.noise_dim,
                                 count=args.count, device=device)
        imgs = result["images"]
        save_grid(os.path.join(out, f"run{run}_random256.png"),
                  to_rgb(imgs[:256]), nrow=16)
        save_grid(os.path.join(out, f"run{run}_random{args.count}.png"),
                  to_rgb(imgs), nrow=32)
        save_grid(os.path.join(out, f"run{run}_best64.png"),
                  to_rgb(result["best"]), nrow=8)
        save_grid(os.path.join(out, f"run{run}_worst64.png"),
                  to_rgb(result["worst"]), nrow=8)
        print(f"run {run}: D scores best={float(result['scores'].max()):.4f} "
              f"worst={float(result['scores'].min()):.4f}")
        if args.neighbours:
            corpus = dataset.load_images(0, len(dataset))
            nb = neighbours_of_best(result, corpus, n_best=16)
            pairs = interleave_pairs(nb["queries"], nb["matches"])
            save_grid(os.path.join(out, f"run{run}_neighbours.png"),
                      to_rgb(pairs), nrow=8)
            print(f"run {run}: NN distances "
                  f"mean={float(nb['distances'].mean()):.4f}")
            result["neighbours"] = nb
        runs.append(result)
    print(f"artifacts in {out}")
    return runs


if __name__ == "__main__":
    main()
