"""Process groups and the collectives of data parallelism: the counterpart
of ``catgen/dist/mesh.py``.

catgen shards over a named ``jax.sharding.Mesh`` whose ``data`` axis spans
the chips; XLA inserts the collectives. Here each rank is one process with
one device (``cuda:<local rank>``, or the CPU), in one
``torch.distributed`` process group: NCCL between cards, gloo on the CPU
(or, as the tests and the smoke run do, for several ranks on one card).
``DATA_AXIS`` names that group where catgen names its mesh axis
(``GanConfig.axis_name``, the models' ``axis_name``).

  * ``initialize`` joins the group: ``num_processes`` hosts of
    ``local_size`` ranks each, ``process_id * local_size + local_rank``
    being this rank (catgen's ``jax.distributed.initialize``);
  * ``rank_seed`` gives each rank its own random stream (catgen's
    ``fold_in_axis_index``); rank 0's stream is the single-process one;
  * ``replicate`` broadcasts tensors from rank 0 (catgen's ``replicate``),
    ``assert_replicated`` checks that they are bit-equal on every rank;
  * ``all_reduce_mean`` is the differentiable mean over the ranks (its
    backward all-reduces the cotangent), ``all_reduce_mean_flat`` the
    gradients' mean, one all-reduce over a flat f32 buffer.

Every all-reduce adds one to ``ALL_REDUCES`` where it is issued, the
backward's included; the reduced tensors are f32 (gloo may refuse bf16).
"""

from __future__ import annotations

import contextlib
import datetime
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"

ALL_REDUCES = 0       # all-reduces issued in this process

# this host's place among the hosts (the loader's shard_by_process)
_process = (0, 1)


def reset_counts() -> None:
    global ALL_REDUCES
    ALL_REDUCES = 0


def initialize(coordinator: Optional[str], num_processes: int = 1,
               process_id: int = 0, local_rank: int = 0, local_size: int = 1,
               device: torch.device = torch.device("cpu"),
               backend: Optional[str] = None,
               init_method: Optional[str] = None,
               timeout_s: float = 600.0) -> None:
    """Joins the data-parallel group as rank ``process_id * local_size +
    local_rank`` of ``num_processes * local_size``. ``coordinator`` is
    ``host:port`` of rank 0's rendezvous (``tcp://``); ``init_method``
    (``file://...``, say) replaces it. ``backend`` defaults to NCCL on a
    card and gloo on the CPU; NCCL wants one card per rank."""
    global _process
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} of {num_processes}")
    if not 0 <= local_rank < local_size:
        raise ValueError(f"local rank {local_rank} of {local_size}")
    if init_method is None:
        if not coordinator:
            raise ValueError("initialize needs a coordinator (host:port) "
                             "or an init_method")
        init_method = f"tcp://{coordinator}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=num_processes * local_size,
        rank=process_id * local_size + local_rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    _process = (process_id, num_processes)


def shutdown() -> None:
    """Leaves the group (a no-op outside one)."""
    global _process
    if dist.is_initialized():
        dist.destroy_process_group()
    _process = (0, 1)


@contextlib.contextmanager
def session(*args, **kwargs):
    """``initialize(*args, **kwargs)`` for the body, then ``shutdown``."""
    initialize(*args, **kwargs)
    try:
        yield
    finally:
        shutdown()


def barrier() -> None:
    """Waits for every rank of the group."""
    dist.barrier()


def is_active() -> bool:
    """True inside a data-parallel group."""
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size(axis: Optional[str] = DATA_AXIS) -> int:
    """The ranks of ``axis`` (1 for None or outside a group)."""
    if axis is None or not dist.is_initialized():
        return 1
    check_axis(axis)
    return dist.get_world_size()


def process_index() -> int:
    """This host's index among the hosts (catgen's process_index)."""
    return _process[0]


def process_count() -> int:
    return _process[1]


def check_axis(axis: str) -> None:
    if axis != DATA_AXIS:
        raise ValueError(f"axis {axis!r}: the port's one axis is "
                         f"{DATA_AXIS!r}")
    if not dist.is_initialized():
        raise RuntimeError(f"axis {axis!r}: no process group (call "
                           f"dist.mesh.initialize first)")


def rank_seed(seed: int, rank_: Optional[int] = None) -> int:
    """The seed of a rank's random stream: ``seed`` itself on rank 0, so
    that a world of one draws what the single-process run draws, and
    distinct odd-multiple offsets on the others."""
    r = rank() if rank_ is None else rank_
    return (seed + r * 0x9E3779B97F4A7C15) % (2 ** 63)


def rank_generator(seed: int, device, rank_: Optional[int] = None
                   ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``rank_seed``."""
    gen = torch.Generator(torch.device(device))
    gen.manual_seed(rank_seed(seed, rank_))
    return gen


def _all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    global ALL_REDUCES
    if x.dtype != torch.float32:
        raise TypeError(f"all-reduce of {x.dtype}: the port reduces f32")
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    ALL_REDUCES += 1
    return y


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is the sum of the
    cotangents (each rank's output is every rank's input's)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad)


def all_reduce_mean(x: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """The mean of the f32 ``x`` over ``axis``'s ranks, differentiable:
    catgen's ``lax.pmean``, whose transpose is the mean of the
    cotangents."""
    check_axis(axis)
    return _AllReduceSum.apply(x) / dist.get_world_size()


def _reduce_flat(tensors: Sequence[torch.Tensor], axis: str,
                 mean: bool) -> List[torch.Tensor]:
    check_axis(axis)
    flat = _all_reduce_sum(torch.cat([t.detach().reshape(-1).float()
                                      for t in tensors]))
    if mean:
        flat = flat / dist.get_world_size()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_reduce_mean_flat(tensors: Sequence[torch.Tensor],
                         axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (no gradient), in one
    all-reduce of one flat f32 buffer; each comes back in its shape and
    dtype."""
    return _reduce_flat(tensors, axis, mean=True)


def all_reduce_sum_flat(tensors: Sequence[torch.Tensor],
                        axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """``all_reduce_mean_flat`` with the sum (counts below 2^24 stay
    exact in f32)."""
    return _reduce_flat(tensors, axis, mean=False)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrites each tensor, in place, with rank ``src``'s."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src)


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """Every tensor of a train state (``gan.TrainState``,
    ``v_trainer.VTrainState``, ``pretrainer.AEState``) by a stable name:
    its modules' parameters and buffers, its optimizer states' tensors
    and the gate's buffer."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, value) -> None:
        if isinstance(value, torch.nn.Module):
            for k, t in value.state_dict(keep_vars=True).items():
                out[f"{prefix}.{k}"] = t
        elif isinstance(value, torch.Tensor):
            out[prefix] = value
        elif isinstance(value, dict):
            for k in sorted(value):
                walk(f"{prefix}.{k}", value[k])
        elif isinstance(value, tuple):
            fields = getattr(value, "_fields", range(len(value)))
            for f, v in zip(fields, value):
                walk(f"{prefix}.{f}", v)

    for field in sorted(vars(state)):
        walk(field, getattr(state, field))
    return out


def replicate(state) -> None:
    """Broadcasts every tensor of ``state`` (``state_tensors``) from rank
    0, in place; a no-op outside a group."""
    if dist.is_initialized():
        broadcast_(state_tensors(state).values())


def assert_replicated(state) -> int:
    """Checks that every tensor of ``state`` holds the same bits on every
    rank: rank 0's bytes are broadcast, each rank compares its own, and one
    f32 all-reduce sums the mismatches. Raises AssertionError naming the
    tensors that differ; returns the bytes compared."""
    tensors = state_tensors(state)
    if not dist.is_initialized():
        return 0
    names = list(tensors)
    raw = [tensors[k].detach().contiguous().reshape(-1).view(torch.uint8)
           for k in names]
    sizes = [r.numel() for r in raw]
    mine = torch.cat(raw)
    pad = (-mine.numel()) % 4
    if pad:
        mine = torch.cat([mine, mine.new_zeros(pad)])
    theirs = mine.clone().view(torch.int32)
    broadcast_([theirs], src=0)
    theirs = theirs.view(torch.uint8)
    flags, at = [], 0
    for n in sizes:
        flags.append((mine[at:at + n] != theirs[at:at + n]).any())
        at += n
    differ = _all_reduce_sum(torch.stack(flags).float())
    bad = [k for k, f in zip(names, differ.tolist()) if f]
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} state tensors "
                             f"differ across ranks, e.g. {bad[:5]}")
    return sum(sizes)
