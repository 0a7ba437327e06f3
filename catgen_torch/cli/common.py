"""Shared CLI plumbing: dataset flags, the reference's common flags, the
corpus, the device (catgen's ``--platform`` becomes ``--device``) and the
data-parallel ranks.

``--devices N`` runs N ranks on this host, each a process with one device
(``cuda:<local rank>``, or the CPU with ``--device cpu``; NCCL wants one
card per rank, so more ranks than cards are refused). ``--coordinator
host:port --numProcesses P --processId I`` make this host process I of P,
in a world of ``P * N`` ranks meeting at rank 0's ``host:port``; a world
of one (``--devices 1`` with a coordinator) runs the data-parallel path
in this process. ``--batchSize`` is per rank.
"""

from __future__ import annotations

import argparse
import os

import torch

from catgen_torch.data.fixture import write_fixture_dataset
from catgen_torch.data.loader import ImageDataset
from catgen_torch.dist import launch, mesh


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
    for --platform."""
    p.add_argument("--save", default="logs", help="artifact directory")
    p.add_argument("--scale", type=int, default=32)
    p.add_argument("--colorSpace", default="rgb",
                   choices=["rgb", "yuv", "hsl", "y"])
    p.add_argument("--noiseDim", type=int, default=100)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--N_epoch", type=int, default=1000)
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel ranks on this host, one device each "
                        "(cuda:0..N-1, or the CPU with --device cpu)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous (multi-host "
                        "data parallelism)")
    p.add_argument("--numProcesses", type=int, default=None,
                   help="hosts (processes of --devices ranks each)")
    p.add_argument("--processId", type=int, default=None,
                   help="this host's index among --numProcesses")
    add_device_arg(p)


def world_size(args) -> int:
    """The data-parallel world of the flags: hosts times local ranks."""
    return (args.numProcesses or 1) * args.devices


def check_dp_flags(args) -> None:
    """Raises SystemExit for flags that cannot place the ranks: the
    multi-host flags without a coordinator, a process index outside the
    hosts, more CUDA ranks than cards."""
    if not args.coordinator and (args.numProcesses is not None
                                 or args.processId is not None):
        raise SystemExit("--numProcesses/--processId need --coordinator "
                         "host:port")
    n, i = args.numProcesses or 1, args.processId or 0
    if not 0 <= i < n:
        raise SystemExit(f"--processId {i} of --numProcesses {n}")
    launch.check_devices(args.device, args.devices)


def refuse_data_parallel(args, what: str) -> None:
    """For the CLIs that run on one device: raises SystemExit when the
    data-parallel flags ask for ranks."""
    if args.devices != 1 or args.coordinator or args.numProcesses:
        raise SystemExit(f"{what} runs on one device: --devices, "
                         f"--coordinator and --numProcesses are the "
                         f"training CLIs' flags")


def run_ranks(args, run):
    """Runs ``run(args, device)``, the CLI's work, as the flags say: in
    this process without a group (``--devices 1``, no coordinator), else
    on ``--devices`` local ranks of the data-parallel group
    (``dist.launch``; a world of one stays in this process). Returns
    ``run``'s result where it ran in this process, else None. A rank's
    SystemExit code (the collapse detector's 42) is the CLI's."""
    check_dp_flags(args)
    if args.devices == 1 and not args.coordinator:
        return run(args, resolve_device(args.device))
    return launch.launch(
        _rank, args.devices, args=(run, args, args.devices == 1),
        device=args.device, coordinator=args.coordinator,
        num_processes=args.numProcesses or 1,
        process_id=args.processId or 0)[0]


def _rank(local_rank: int, device, run, args, keep: bool):
    """One rank of ``run_ranks``, the numeric mode set on its device;
    the result only where it stays in this process (``keep``)."""
    result = run(args, resolve_device(str(device)))
    return result if keep else None


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

        def missing() -> bool:
            return not os.path.isdir(fixture_dir) or not os.listdir(
                fixture_dir)

        if create_fixture:
            if mesh.rank() == 0 and missing():
                n = args.fixture or 64
                print(f"[data] no --dataset given; writing {n} synthetic "
                      f"cat faces to {fixture_dir}")
                write_fixture_dataset(fixture_dir, n=n)
            if mesh.is_active():    # the others wait for rank 0's files
                mesh.barrier()
        if missing():
            raise SystemExit(
                f"no --dataset given and no fixture corpus at "
                f"{fixture_dir}: pass --dataset <dirs> (the training "
                f"corpus path is not recorded in checkpoints)")
        dirs = [fixture_dir]
    return ImageDataset(dirs, scale=args.scale, colorspace=args.colorSpace,
                        seed=args.seed, device=device,
                        normalize=getattr(args, "normalize", False),
                        shard_by_process=mesh.process_count() > 1)
