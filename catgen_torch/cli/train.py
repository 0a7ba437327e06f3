"""GAN training CLI: the counterpart of ``catgen/cli/train.py`` (``th
train.lua``), with catgen's flags and ``--device`` for ``--platform``.

    python -m catgen_torch.cli.train --device cuda --fixture 256 --epochs 5
    python -m catgen_torch.cli.train --device cpu --fixture 16 --epochs 1 \\
        --batchSize 4 --N_epoch 8 --save /tmp/run

The 64px pyramid (G64_stack against D64), warm-started from a 32px run
(``cli.stack64_warmstart``) and stopped if it collapses:

    python -m catgen_torch.cli.train --scale 64 --G g64_stack --D d64 \\
        --augment --collapseDetect --save runs/x64

Checkpoints are catgen's ``adversarial.ckpt`` (either package resumes the
other's). A V checkpoint (``cli.train_v``) and a pretrained G
(``cli.pretrain_g``, ``cli.stack64_warmstart``) in ``--save`` are picked up
by filename. ``--collapseDetect`` exits with code 42 when the detector
stops the run, as catgen's does; ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the second epoch into DIR. Flags whose
machinery is not ported yet (data parallelism) raise NotImplementedError
naming the ROADMAP item; none is silently ignored.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from catgen_torch.cli.common import (add_common_args, add_dataset_args,
                                     build_dataset, refuse_multi_host,
                                     resolve_device)
from catgen_torch.models import D_REGISTRY, G_REGISTRY
from catgen_torch.train import gan
from catgen_torch.train.harness import GanHarness, HarnessConfig

_OPTIMIZERS = ["adam", "adagrad", "sgd", "rmsprop"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    add_dataset_args(p)
    p.add_argument("--saveFreq", type=int, default=30)
    p.add_argument("--network", default="",
                   help="checkpoint to resume from")
    p.add_argument("--rebuildOptstate", action="store_true")
    p.add_argument("--epochs", type=int, default=None,
                   help="epochs to run (default: forever, like train.lua)")
    p.add_argument("--G", default="default", choices=sorted(G_REGISTRY))
    p.add_argument("--D", default="default", choices=sorted(D_REGISTRY))
    p.add_argument("--D_optmethod", default="adam", choices=_OPTIMIZERS)
    p.add_argument("--G_optmethod", default="adam", choices=_OPTIMIZERS)
    p.add_argument("--D_sgd_lr", type=float, default=0.02)
    p.add_argument("--G_sgd_lr", type=float, default=0.02)
    p.add_argument("--D_sgd_momentum", type=float, default=0.0)
    p.add_argument("--G_sgd_momentum", type=float, default=0.0)
    p.add_argument("--D_L1", type=float, default=0.0)
    p.add_argument("--D_L2", type=float, default=1e-4)
    p.add_argument("--G_L1", type=float, default=0.0)
    p.add_argument("--G_L2", type=float, default=0.0)
    p.add_argument("--D_iterations", type=int, default=1)
    p.add_argument("--G_iterations", type=int, default=1)
    p.add_argument("--D_maxAcc", type=float, default=1.01)
    p.add_argument("--D_clamp", type=float, default=1.0)
    p.add_argument("--G_clamp", type=float, default=5.0)
    p.add_argument("--no-G_bn_advance", dest="no_G_bn_advance",
                   action="store_true",
                   help="freeze G's BN running stats during the D phase")
    p.add_argument("--G_freeze", default="",
                   help="comma list of top-level G children to freeze "
                        "(grads zeroed, params and BN state pinned)")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="activation compute dtype (bf16: the kernels' "
                        "bf16 instantiations on every route)")
    p.add_argument("--bce", default=None,
                   choices=list(gan.BCE_CHOICES),
                   help="GAN criterion (default: CATGEN_BCE or 'logits', "
                        "the logit-space BCE; 'torch' / 'clip' are the "
                        "probability-space alternates)")
    p.add_argument("--weightsVisFreq", type=int, default=0,
                   help="D activation grids every N epochs")
    p.add_argument("--visFreq", type=int, default=1,
                   help="write sample grids and probes every N epochs")
    p.add_argument("--collapseDetect", action="store_true",
                   help="stop the run when the GAN-collapse detector "
                        "fires (eval/collapse.py); exits with code 42")
    p.add_argument("--normalize", action="store_true",
                   help="remap inputs [0,1] -> [-1,1]")
    p.add_argument("--augment", action="store_true",
                   help="train-time augmentation of the real batches")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler Chrome trace of the second "
                        "trained epoch (the first with --epochs 1) into "
                        "this directory")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> GanHarness:
    """Runs the CLI; returns the harness after training. Exits with code 42
    when the collapse detector stopped the run."""
    args = parse_args(argv)
    refuse_multi_host(args)
    device = resolve_device(args.device)
    hc = HarnessConfig(save_dir=args.save, save_freq=args.saveFreq,
                       n_epoch=args.N_epoch, scale=args.scale,
                       colorspace=args.colorSpace, noise_dim=args.noiseDim,
                       seed=args.seed, n_devices=args.devices,
                       g_model=args.G, d_model=args.D, epochs=args.epochs,
                       weights_vis_freq=args.weightsVisFreq,
                       vis_freq=max(args.visFreq, 1),
                       normalize=args.normalize,
                       collapse_detect=args.collapseDetect)
    gc = gan.GanConfig(
        batch_size=args.batchSize,
        d_optimizer=args.D_optmethod, g_optimizer=args.G_optmethod,
        d_sgd_lr=args.D_sgd_lr, g_sgd_lr=args.G_sgd_lr,
        d_sgd_momentum=args.D_sgd_momentum,
        g_sgd_momentum=args.G_sgd_momentum,
        d_l1=args.D_L1, d_l2=args.D_L2, g_l1=args.G_L1, g_l2=args.G_L2,
        d_clamp=args.D_clamp, g_clamp=args.G_clamp,
        d_iterations=args.D_iterations, g_iterations=args.G_iterations,
        d_max_acc=args.D_maxAcc, augment=args.augment,
        normalized_inputs=args.normalize,
        g_bn_advance_in_d=not args.no_G_bn_advance,
        g_frozen_children=tuple(s for s in args.G_freeze.split(",") if s),
        bce=args.bce,
        compute_dtype=(torch.bfloat16 if args.dtype == "bf16"
                       else torch.float32))
    dataset = build_dataset(args, device, create_fixture=True)
    harness = GanHarness(hc, gc, dataset, device)
    if args.network:
        harness.resume(args.network, rebuild_optstate=args.rebuildOptstate)
    status = harness.train(args.epochs, profile_dir=args.profile or None)
    if status == "collapsed":
        raise SystemExit(42)
    return harness


if __name__ == "__main__":
    main()
