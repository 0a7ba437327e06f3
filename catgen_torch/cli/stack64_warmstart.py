"""Stage-wise warm start of the 64px Laplacian stack: the counterpart of
``tools/stack64_warmstart.py``.

``create_G64_stack`` (``catgen_torch/models/refine.py``) composes noise ->
G32up-c -> RefineStage into one 64px generator. This grafts a trained
32px G (from a run's ``adversarial.ckpt``) into the base of a freshly
initialized stack and writes the result under the pretrained-G pickup
filename (``g_pretrained_3x64x64_nd<N>.ckpt``), which the training
harness loads by name, so that

    python -m catgen_torch.cli.stack64_warmstart \\
        --ckpt runs/x/adversarial.ckpt --save runs/x64
    python -m catgen_torch.cli.train --scale 64 --G g64_stack --D d64 \\
        --save runs/x64 --collapseDetect

starts the 64px run from a generator that already draws 32px faces. The
refine stage's head starts near the identity (out = clip(upsample(base) +
0.5 tanh(residual))), so the stack's first samples are bilinear
upsamples of the base's. The file is catgen's format: either package's
harness picks it up. It runs on the CPU: it only builds weights.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from catgen_torch import models
from catgen_torch.core.module import reset_parameters
from catgen_torch.io import checkpoint as ckpt
from catgen_torch.io.convert import (catgen_to_state_dict,
                                     state_dict_to_catgen, tree_to_leaves)
from catgen_torch.train.harness import save_variables

BASE_CHILD = "00_G32up_c"


def graft_base(g64: nn.Module, adv: Dict[str, np.ndarray],
               base_child: str = BASE_CHILD) -> None:
    """Loads the 32px run's trained G into the stack's base child, in place.

    ``adv``: the 32px train-state checkpoint's leaves (G's spelled
    ``.g_params[...]`` and ``.g_state[...]``). Every leaf of the base
    must be there at its shape (KeyError, ValueError otherwise); each is
    cast to the base's dtype."""
    base = g64.get_submodule(base_child)
    params, state = state_dict_to_catgen(base.state_dict())
    trees = []
    for attr, tree in (("g_params", params), ("g_state", state)):
        leaves = {}
        for k, leaf in tree_to_leaves(attr, tree).items():
            if k not in adv:
                raise KeyError(f"the 32px checkpoint is missing {k}: is its "
                               f"G the default 32px decoder (G32up-c)?")
            arr = np.asarray(adv[k])
            if arr.shape != leaf.shape:
                raise ValueError(f"{k}: checkpoint shape {arr.shape} != "
                                 f"stack template {leaf.shape}")
            leaves[k] = arr.astype(leaf.dtype)
        trees.append(ckpt.leaves_to_tree(attr, leaves))
    base.load_state_dict(catgen_to_state_dict(*trees), strict=True)


def main(argv: Optional[List[str]] = None) -> str:
    """Runs the CLI; returns the path written."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True,
                   help="32px adversarial.ckpt holding the trained base G")
    p.add_argument("--save", required=True,
                   help="64px run directory; the warm start is written "
                        "there under the pretrained-pickup filename")
    p.add_argument("--seed", type=int, default=1,
                   help="init seed of the refine stage's weights")
    args = p.parse_args(argv)

    meta = ckpt.load_meta(args.ckpt)
    cfg = meta.get("config", {})
    if cfg.get("scale", 32) != 32:
        raise SystemExit(f"[warmstart] the source must be a 32px run (got "
                         f"scale={cfg.get('scale')})")
    noise_dim = cfg.get("noise_dim", 100)
    channels = 1 if cfg.get("colorspace") == "y" else 3

    g64 = models.G_REGISTRY["g64_stack"]((64, 64, channels), noise_dim)
    reset_parameters(g64, torch.Generator().manual_seed(args.seed))
    with np.load(args.ckpt) as z:
        adv = {k: z[k] for k in z.files if k.startswith(".g_")}
    graft_base(g64, adv)

    out = os.path.join(args.save, ckpt.g_pretrained_filename(
        channels, 64, 64, noise_dim))
    os.makedirs(args.save, exist_ok=True)
    save_variables(g64, out, {
        "epoch": meta.get("epoch", 0),
        "warmstart_source": os.path.abspath(args.ckpt),
        "warmstart_source_epoch": meta.get("epoch"),
        "warmstart_seed": args.seed,
    })
    n_base = sum(t.numel() for t in
                 g64.get_submodule(BASE_CHILD).parameters())
    n_all = sum(t.numel() for t in g64.parameters())
    print(f"[warmstart] wrote {out}")
    print(f"[warmstart] base (grafted from epoch {meta.get('epoch')}): "
          f"{n_base} params; refiner (fresh, seed {args.seed}): "
          f"{n_all - n_base} params")
    return out


if __name__ == "__main__":
    main()
