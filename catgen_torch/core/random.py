"""The random draws of training: one object that every stochastic layer and
step draws from.

catgen splits a ``jax.random`` key per step, layer and use; here every
draw of a training step comes, in a fixed order, from one ``Draws``: the
noise, the augmentation parameters and the dropout masks. ``Draws`` reads
a ``torch.Generator`` on the device the step runs on, so no draw crosses
from the host. JAX's threefry and torch's Philox never give the same
numbers, so a parity test hands in an object with the same four methods
that replays the numbers JAX drew, in the order catgen drew them.
"""

from __future__ import annotations

from typing import Sequence

import torch


class Draws:
    """Uniform, Bernoulli, normal and integer draws from ``generator``,
    made on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape: Sequence[int], low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator,
                       device=self.generator.device)
        return u * (high - low) + low

    def bernoulli(self, p: float, shape: Sequence[int]) -> torch.Tensor:
        """Boolean mask, True with probability ``p``."""
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.generator.device) < p

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device)

    def randint(self, low: int, high: int,
                shape: Sequence[int]) -> torch.Tensor:
        """Integers uniform in [low, high), int64."""
        return torch.randint(low, high, tuple(shape),
                             generator=self.generator,
                             device=self.generator.device)
