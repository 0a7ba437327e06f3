"""V training CLI: the counterpart of ``catgen/cli/train_v.py`` (``th
train_v.lua``), with catgen's flags and ``--device`` for ``--platform``.
Run it before GAN training: ``cli.train`` picks up its
``v_<C>x<H>x<W>.ckpt`` from the same ``--save`` and rates G's samples with
it.

    python -m catgen_torch.cli.train_v --fixture 256 --epochs 3
    python -m catgen_torch.cli.train_v --device cpu --fixture 16 \\
        --epochs 1 --batchSize 4 --N_epoch 8 --save /tmp/run

``--devices`` and the multi-host flags train V data-parallel, as
``cli.train`` does (``cli/common.py``).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from catgen_torch.cli.common import (add_common_args, add_dataset_args,
                                     build_dataset, run_ranks, world_size)
from catgen_torch.train import v_trainer
from catgen_torch.train.harness import HarnessConfig, VHarness


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    add_dataset_args(p)
    p.add_argument("--saveFreq", type=int, default=10)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--V_clamp", type=float, default=5.0)
    p.add_argument("--V_L1", type=float, default=0.0)
    p.add_argument("--V_L2", type=float, default=0.01)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Optional[VHarness]:
    """Runs the CLI; returns the harness after training where it ran in
    this process (None when ranks were started)."""
    return run_ranks(parse_args(argv), run)


def run(args, device: torch.device) -> VHarness:
    """The CLI's work on ``device``: one rank of it under data
    parallelism."""
    hc = HarnessConfig(save_dir=args.save, n_epoch=args.N_epoch,
                       scale=args.scale, colorspace=args.colorSpace,
                       seed=args.seed, n_devices=world_size(args))
    vc = v_trainer.VConfig(batch_size=args.batchSize, v_l1=args.V_L1,
                           v_l2=args.V_L2, v_clamp=args.V_clamp)
    dataset = build_dataset(args, device, create_fixture=True)
    harness = VHarness(hc, vc, dataset, device)
    harness.train(args.epochs, save_freq=args.saveFreq)
    return harness


if __name__ == "__main__":
    main()
