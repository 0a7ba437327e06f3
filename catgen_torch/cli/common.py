"""Shared CLI plumbing: dataset flags, the corpus, and the device."""

from __future__ import annotations

import argparse
import os

import torch

from catgen_torch.data.loader import ImageDataset


def add_dataset_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset", nargs="*", default=None,
                   help="directories of 64x64 JPEGs")
    p.add_argument("--fixture", type=int, default=0,
                   help="catgen's flag for the training CLIs; sampling "
                        "reads an existing <save>/fixture and never writes "
                        "one")


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "silent fallback to the CPU: pass --device cpu)")


def resolve_device(name: str) -> torch.device:
    """The requested device; raises if it is CUDA and no card is present."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    return device


def build_dataset(args, device: torch.device) -> ImageDataset:
    """The corpus of ``--dataset``, else the fixture under <save>/fixture.
    A missing fixture is not synthesized: NN statistics against a toy
    corpus mean nothing for a checkpoint trained on a real dataset."""
    dirs = args.dataset
    if not dirs:
        fixture_dir = os.path.join(args.save, "fixture")
        if not os.path.isdir(fixture_dir) or not os.listdir(fixture_dir):
            raise SystemExit(
                f"no --dataset given and no fixture corpus at "
                f"{fixture_dir}: pass --dataset <dirs> (the training "
                f"corpus path is not recorded in checkpoints)")
        dirs = [fixture_dir]
    return ImageDataset(dirs, scale=args.scale, colorspace=args.colorSpace,
                        seed=args.seed, device=device)
