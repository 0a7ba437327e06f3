"""Holding a data-parallel step against the single-process step on the
concatenated batch: the single step's random draws, cut into each rank's.

Rank r of W holds rows ``[r*n, (r+1)*n)`` of a global batch of ``W*n``.
So does each draw over that batch: the noise, the augmentation's
parameters and the dropout masks of a G or D forward over fakes. One kind
of batch interleaves: the D phase's (and V's) input is ``[reals;
fakes]``, so its masks over ``2*W*h`` rows give rank r rows ``[r*h,
(r+1)*h)`` of the reals' half and the same of the fakes' half
(``paired``). With these cuts, a DP step on W ranks and the single step
on the concatenated batch compute the same function.

``RecordingDraws`` keeps what a ``Draws`` drew, ``ReplayDraws`` hands the
records out again (checking kind and shape), ``gan_pairs`` marks which
draws of a GAN step are over a ``[reals; fakes]`` batch, and
``split_draws`` cuts the records for one rank.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Record = Tuple[str, torch.Tensor]


class RecordingDraws:
    """Draws from ``draws``, keeping each as (kind, tensor), in order."""

    def __init__(self, draws):
        self.draws = draws
        self.records: List[Record] = []

    def _keep(self, kind: str, t: torch.Tensor) -> torch.Tensor:
        self.records.append((kind, t))
        return t

    def uniform(self, shape, low=0.0, high=1.0):
        return self._keep("uniform", self.draws.uniform(shape, low, high))

    def bernoulli(self, p, shape):
        return self._keep("bernoulli", self.draws.bernoulli(p, shape))

    def normal(self, shape):
        return self._keep("normal", self.draws.normal(shape))

    def randint(self, low, high, shape):
        return self._keep("randint", self.draws.randint(low, high, shape))


class ReplayDraws:
    """Hands out ``records`` in order on ``device``, checking that each
    call asks for the recorded kind and shape."""

    def __init__(self, records: Sequence[Record], device="cpu"):
        self.records = list(records)
        self.device = device

    def _next(self, kind: str, shape) -> torch.Tensor:
        if not self.records:
            raise AssertionError(f"a draw of {kind} {tuple(shape)} beyond "
                                 f"the records")
        got, t = self.records.pop(0)
        if (got, tuple(t.shape)) != (kind, tuple(shape)):
            raise AssertionError(f"drew {kind} {tuple(shape)}, the record "
                                 f"is {got} {tuple(t.shape)}")
        return t.to(self.device)

    def uniform(self, shape, low=0.0, high=1.0):
        return self._next("uniform", shape)

    def bernoulli(self, p, shape):
        return self._next("bernoulli", shape)

    def normal(self, shape):
        return self._next("normal", shape)

    def randint(self, low, high, shape):
        return self._next("randint", shape)


def gan_pairs(records: Sequence[Record], half: int, world: int,
              noise_dim: int) -> List[bool]:
    """For a single GAN step's records on the global batch (``half`` reals
    and fakes per rank): True for the draws over the D phase's [reals;
    fakes] input, which come between a D phase's noise (``half * world``
    rows) and the next noise."""
    flags, in_d = [], False
    for kind, t in records:
        if kind == "uniform" and t.dim() == 2 and t.shape[1] == noise_dim:
            in_d = t.shape[0] == half * world
            flags.append(False)
        else:
            flags.append(in_d and t.shape[0] == 2 * half * world)
    return flags


def split_draws(records: Sequence[Record], rank: int, world: int,
                paired: Sequence[bool]) -> List[Record]:
    """Rank ``rank``'s share of each record, along its first dimension:
    the contiguous ``1/world``, or for a ``paired`` record the rank's
    share of each half."""
    out = []
    for (kind, t), pair in zip(records, paired):
        n = t.shape[0]
        if n % (2 * world if pair else world):
            raise ValueError(f"a draw of {n} rows does not split over "
                             f"{world} ranks")
        if pair:
            h = n // (2 * world)
            part = torch.cat([t[rank * h:(rank + 1) * h],
                              t[world * h + rank * h:
                                world * h + (rank + 1) * h]])
        else:
            k = n // world
            part = t[rank * k:(rank + 1) * k]
        out.append((kind, part.clone()))
    return out
