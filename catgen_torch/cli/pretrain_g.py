"""G pretraining CLI: the counterpart of ``catgen/cli/pretrain_g.py`` (``th
pretrain_g.lua``), with catgen's flags and ``--device`` for
``--platform``. It trains the G autoencoder and exports the decoder as
``g_pretrained_<C>x<H>x<W>_nd<N>.ckpt``, which ``cli.train`` picks up from
the same ``--save``.

    python -m catgen_torch.cli.pretrain_g --fixture 256 --epochs 2
    python -m catgen_torch.cli.pretrain_g --device cpu --fixture 16 \\
        --epochs 1 --batchSize 4 --N_epoch 8 --save /tmp/run

``--devices`` and the multi-host flags pretrain data-parallel, as
``cli.train`` does (``cli/common.py``).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from catgen_torch.cli.common import (add_common_args, add_dataset_args,
                                     build_dataset, run_ranks, world_size)
from catgen_torch.train import pretrainer
from catgen_torch.train.harness import HarnessConfig, PretrainHarness


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    add_dataset_args(p)
    p.set_defaults(batchSize=16)
    p.add_argument("--saveFreq", type=int, default=1)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--G_clamp", type=float, default=5.0)
    p.add_argument("--G_L1", type=float, default=0.0)
    p.add_argument("--G_L2", type=float, default=0.0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Optional[PretrainHarness]:
    """Runs the CLI; returns the harness after training where it ran in
    this process (None when ranks were started)."""
    return run_ranks(parse_args(argv), run)


def run(args, device: torch.device) -> PretrainHarness:
    """The CLI's work on ``device``: one rank of it under data
    parallelism."""
    hc = HarnessConfig(save_dir=args.save, n_epoch=args.N_epoch,
                       scale=args.scale, colorspace=args.colorSpace,
                       noise_dim=args.noiseDim, seed=args.seed,
                       n_devices=world_size(args))
    pc = pretrainer.PretrainConfig(batch_size=args.batchSize,
                                   g_l1=args.G_L1, g_l2=args.G_L2,
                                   g_clamp=args.G_clamp)
    dataset = build_dataset(args, device, create_fixture=True)
    harness = PretrainHarness(hc, pc, dataset, device)
    harness.train(args.epochs, save_freq=args.saveFreq)
    return harness


if __name__ == "__main__":
    main()
