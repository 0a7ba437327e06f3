"""The random draws the benchmark hands to a training step, and their
replay for the reference.

A step draws from one object with ``uniform``, ``bernoulli`` and
``normal`` (the program's ``Draws``). The benchmark's wrappers:

  * ``recording(base)``: hands out the base's draws and keeps a copy of
    each, with its kind and shape, for the reference;
  * ``Replay``: hands the recorded draws out again, in order, and raises
    where the reference asks for another kind or shape than the program
    drew: the two sides then disagree on catgen's order of draws;
  * ``clocked(base, per_step, events)``: records a CUDA event on the
    current stream before every ``per_step``-th draw, that is at the start
    of each step, for the per-step times of the window.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Record = Tuple[str, Tuple[int, ...], tuple, torch.Tensor]


def recording(base_cls, generator: torch.Generator,
              records: List[Record]):
    """An instance of a subclass of the program's ``Draws`` class that
    appends every draw to ``records``."""

    class Recording(base_cls):
        def uniform(self, shape, low=0.0, high=1.0):
            v = super().uniform(shape, low, high)
            records.append(("uniform", tuple(shape), (low, high), v.clone()))
            return v

        def bernoulli(self, p, shape):
            v = super().bernoulli(p, shape)
            records.append(("bernoulli", tuple(shape), (p,), v.clone()))
            return v

        def normal(self, shape):
            v = super().normal(shape)
            records.append(("normal", tuple(shape), (), v.clone()))
            return v

    return Recording(generator)


def clocked(base_cls, generator: torch.Generator, per_step: int,
            events: List[torch.cuda.Event]):
    """An instance of a subclass of the program's ``Draws`` class that
    records a timing event before every ``per_step``-th draw."""

    class Clocked(base_cls):
        count = 0

        def _tick(self):
            if self.count % per_step == 0:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                events.append(e)
            self.count += 1

        def uniform(self, shape, low=0.0, high=1.0):
            self._tick()
            return super().uniform(shape, low, high)

        def bernoulli(self, p, shape):
            self._tick()
            return super().bernoulli(p, shape)

        def normal(self, shape):
            self._tick()
            return super().normal(shape)

    return Clocked(generator)


class Replay:
    """The recorded draws, handed out in order."""

    def __init__(self, records: Sequence[Record], device=None,
                 dtype: torch.dtype = torch.float32):
        self.records = list(records)
        self.at = 0
        self.device = device
        self.dtype = dtype

    def _next(self, kind: str, shape, args) -> torch.Tensor:
        if self.at >= len(self.records):
            raise RuntimeError(f"the reference drew more than the program "
                               f"({len(self.records)} draws); next: {kind} "
                               f"{tuple(shape)}")
        k, s, a, v = self.records[self.at]
        if (k, s) != (kind, tuple(shape)) or any(
                abs(x - y) > 1e-12 for x, y in zip(a, args)):
            raise RuntimeError(f"draw {self.at}: the program drew {k} {s} "
                               f"{a}, the reference asks for {kind} "
                               f"{tuple(shape)} {tuple(args)}")
        self.at += 1
        if v.is_floating_point():
            v = v.to(self.dtype)
        return v if self.device is None else v.to(self.device)

    def uniform(self, shape, low=0.0, high=1.0):
        return self._next("uniform", shape, (low, high))

    def bernoulli(self, p, shape):
        return self._next("bernoulli", shape, (p,))

    def normal(self, shape):
        return self._next("normal", shape, ())

    def done(self) -> bool:
        return self.at == len(self.records)
