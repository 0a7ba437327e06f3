"""Starts the local ranks of a data-parallel run.

``--devices N`` means N ranks on this host, each a process with one
device: ``cuda:<local rank>``, or the CPU (``--device cpu``). With the
multi-host flags the host is process ``process_id`` of ``num_processes``,
and the world is ``num_processes * N`` ranks meeting at ``coordinator``
(rank 0's ``host:port``); without them the local ranks meet through a
file in a fresh temporary directory.

``launch(fn, n, ...)`` runs ``fn(local_rank, device, *args)`` on every
local rank inside the group (``mesh.session``) and returns the ranks'
results in order: a world of one runs in this process, more ranks in
processes started with ``torch.multiprocessing`` (``spawn``). ``fn`` and
its arguments must pickle (a module-level function), and so must its
result; a rank's ``SystemExit`` code ends ``launch`` with the same code.
``check_devices`` refuses more CUDA ranks than visible cards: NCCL does
not put two ranks on one card. A test or a smoke run may still
put several ranks on one card, or on the CPU, by passing ``devices`` and
the gloo backend itself.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch

from catgen_torch.dist import mesh


def check_devices(device: str, n: int) -> None:
    """Raises SystemExit unless ``n`` ranks of ``device`` can each have a
    device of their own: the CPU always, CUDA only with ``n`` visible
    cards and no card index in ``device`` when ``n > 1``."""
    dev = torch.device(device)
    if n < 1:
        raise SystemExit(f"--devices {n}: at least one rank")
    if dev.type != "cuda" or n == 1:
        return
    if dev.index is not None:
        raise SystemExit(f"--devices {n} --device {device}: each rank takes "
                         f"cuda:<local rank>; pass --device cuda")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < n:
        raise SystemExit(
            f"--devices {n}: {cards} CUDA card(s) visible, but each rank "
            f"needs a card of its own (NCCL refuses two ranks on one card); "
            f"pass --devices {cards or 1}, or --device cpu for CPU ranks")


def rank_devices(device: str, n: int) -> List[torch.device]:
    """The device of each local rank: ``cuda:0`` .. ``cuda:n-1`` for
    CUDA (``device`` itself for one rank), else ``device`` for all."""
    dev = torch.device(device)
    if dev.type == "cuda" and n > 1:
        return [torch.device("cuda", i) for i in range(n)]
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", 0)]
    return [dev] * n


def _rank_main(local_rank: int, fn: Callable, devices: Sequence[str],
               init: dict, args: tuple, out_dir: str, threads: int) -> None:
    # the ranks share the launcher's intra-op threads: a fresh process
    # would take one per core, and N of them would oversubscribe the cores
    torch.set_num_threads(max(1, threads // len(devices)))
    device = torch.device(devices[local_rank])
    with mesh.session(local_rank=local_rank, local_size=len(devices),
                      device=device, **init):
        result = fn(local_rank, device, *args)
    torch.save(result, os.path.join(out_dir, f"rank{local_rank}.pt"))


def launch(fn: Callable, n: int, args: tuple = (), device: str = "cpu",
           devices: Optional[Sequence[str]] = None,
           coordinator: Optional[str] = None, num_processes: int = 1,
           process_id: int = 0, backend: Optional[str] = None,
           timeout_s: float = 600.0) -> List[Any]:
    """Runs ``fn(local_rank, device, *args)`` on ``n`` local ranks of a
    data-parallel group and returns their results. ``devices`` (one per
    rank) overrides ``rank_devices(device, n)``; ``backend`` defaults to
    NCCL on cards and gloo on the CPU. The ranks meet at ``coordinator``,
    else through a file."""
    if devices is None:
        devices = rank_devices(device, n)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    tmp = tempfile.mkdtemp(prefix="catgen_torch_ranks_")
    try:
        init_method = None if coordinator else "file://" + os.path.join(
            tmp, "rendezvous")
        init = dict(coordinator=coordinator, num_processes=num_processes,
                    process_id=process_id, backend=backend,
                    init_method=init_method, timeout_s=timeout_s)
        names = [str(torch.device(d)) for d in devices]
        if n == 1:
            with mesh.session(local_rank=0, local_size=1,
                              device=torch.device(names[0]), **init):
                return [fn(0, torch.device(names[0]), *args)]
        try:
            torch.multiprocessing.start_processes(
                _rank_main, nprocs=n,
                args=(fn, names, init, args, tmp, torch.get_num_threads()),
                join=True, start_method="spawn")
        except torch.multiprocessing.ProcessExitedException as e:
            if e.exit_code and e.exit_code > 0:   # a rank's SystemExit
                raise SystemExit(e.exit_code) from e
            raise
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
