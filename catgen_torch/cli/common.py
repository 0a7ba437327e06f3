"""Shared CLI plumbing: dataset flags, the reference's common flags, the
corpus, and the device (catgen's ``--platform`` becomes ``--device``)."""

from __future__ import annotations

import argparse
import os

import torch

from catgen_torch.data.fixture import write_fixture_dataset
from catgen_torch.data.loader import ImageDataset


def add_dataset_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset", nargs="*", default=None,
                   help="directories of 64x64 JPEGs")
    p.add_argument("--fixture", type=int, default=0,
                   help="training: if >0 and no --dataset, write N synthetic "
                        "cat faces to <save>/fixture and train on them; "
                        "sampling reads an existing <save>/fixture and never "
                        "writes one")


def add_common_args(p: argparse.ArgumentParser):
    """The reference's common flags (catgen/cli/common.py), with --device
    for --platform. Multi-host flags are refused: ROADMAP Queue A item 11."""
    p.add_argument("--save", default="logs", help="artifact directory")
    p.add_argument("--scale", type=int, default=32)
    p.add_argument("--colorSpace", default="rgb",
                   choices=["rgb", "yuv", "hsl", "y"])
    p.add_argument("--noiseDim", type=int, default=100)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--N_epoch", type=int, default=1000)
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel size (only 1 is ported)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator (not ported)")
    p.add_argument("--numProcesses", type=int, default=None)
    p.add_argument("--processId", type=int, default=None)
    add_device_arg(p)


def refuse_multi_host(args) -> None:
    """Raises for the multi-host flags (ROADMAP Queue A item 11)."""
    from catgen_torch.train.harness import not_ported
    if args.coordinator or args.numProcesses:
        raise not_ported("multi-host data parallelism", "11")


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "silent fallback to the CPU: pass --device cpu)")


def resolve_device(name: str) -> torch.device:
    """The requested device; raises if it is CUDA and no card is present.

    Also sets catgen's numeric mode, which the port's parity tests
    assume: full f32 for cuDNN's convolutions and for matmuls (no TF32);
    bf16 matmuls that sum in f32, as XLA's bf16 dots do (cuBLAS may
    otherwise reduce bf16 products in reduced precision); and cuDNN's
    deterministic algorithms with no autotuning, so that a same-seed run
    repeats its bits as catgen's compiled step does. The port's own
    kernels ignore these flags: the 3xTF32 upsample-conv kernels are
    f32-accurate by construction, and every kernel of
    ``catgen_torch/csrc`` sums in a fixed order."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return device


def build_dataset(args, device: torch.device,
                  create_fixture: bool = False) -> ImageDataset:
    """The corpus of ``--dataset``, else the fixture under <save>/fixture.
    Only training (``create_fixture``) synthesizes a missing fixture (of
    ``--fixture`` images, 64 by default): NN statistics against a toy
    corpus mean nothing for a checkpoint trained on a real dataset."""
    dirs = args.dataset
    if not dirs:
        fixture_dir = os.path.join(args.save, "fixture")
        missing = not os.path.isdir(fixture_dir) or not os.listdir(
            fixture_dir)
        if missing and create_fixture:
            n = args.fixture or 64
            print(f"[data] no --dataset given; writing {n} synthetic cat "
                  f"faces to {fixture_dir}")
            write_fixture_dataset(fixture_dir, n=n)
        elif missing:
            raise SystemExit(
                f"no --dataset given and no fixture corpus at "
                f"{fixture_dir}: pass --dataset <dirs> (the training "
                f"corpus path is not recorded in checkpoints)")
        dirs = [fixture_dir]
    return ImageDataset(dirs, scale=args.scale, colorspace=args.colorSpace,
                        seed=args.seed, device=device,
                        normalize=getattr(args, "normalize", False))
