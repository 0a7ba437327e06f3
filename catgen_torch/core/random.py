"""The random draws of training: one object that every stochastic layer and
step draws from.

catgen splits a ``jax.random`` key per step, layer and use; here every
draw of a training step comes, in a fixed order, from one ``Draws``: the
noise, the augmentation parameters and the dropout masks. ``Draws`` reads
a ``torch.Generator`` on the device the step runs on, so no draw crosses
from the host. JAX's threefry and torch's Philox never give the same
numbers, so a parity test hands in an object with the same four methods
that replays the numbers JAX drew, in the order catgen drew them.

``remat`` (catgen's ``jax.checkpoint`` of G and D) recomputes a module's
forward during the backward (``torch.utils.checkpoint`` with
``remat_contexts``). JAX's recompute draws the same masks from the same
key; here the recompute must not draw from the stream, which would move
every later draw of the step. So each checkpointed region keeps a tape:
its dropout layers record their masks in the first pass and replay them,
in order, in the recompute (``remat_mask``), and BatchNorm leaves its
running statistics alone there (``recomputing``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

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


class _Tape:
    """The masks one checkpointed region drew, in order."""

    def __init__(self):
        self.masks: List[torch.Tensor] = []
        self.next = 0


# (tape, replaying) of the region being run, if any. A module global, not
# a thread-local: autograd runs the recompute on its own device thread.
_active: Optional[Tuple[_Tape, bool]] = None


@contextlib.contextmanager
def _on(tape: _Tape, replaying: bool):
    global _active
    saved, _active = _active, (tape, replaying)
    try:
        yield
    finally:
        _active = saved


def remat_contexts():
    """``context_fn`` of ``torch.utils.checkpoint.checkpoint`` (with
    ``use_reentrant=False``): the first pass records the region's masks
    on a fresh tape, the recompute replays them."""
    tape = _Tape()
    return _on(tape, False), _on(tape, True)


def recomputing() -> bool:
    """True inside the recompute of a checkpointed region."""
    return _active is not None and _active[1]


def remat_mask(draw: Callable[[], torch.Tensor]) -> torch.Tensor:
    """A dropout mask: ``draw()`` outside a checkpointed region; inside,
    ``draw()`` recorded on the region's tape in the first pass and the
    recorded mask, in order, in the recompute."""
    if _active is None:
        return draw()
    tape, replaying = _active
    if not replaying:
        tape.masks.append(draw())
        return tape.masks[-1]
    if tape.next >= len(tape.masks):
        raise RuntimeError("the recompute of a remat region drew more "
                           "masks than its first pass")
    tape.next += 1
    return tape.masks[tape.next - 1]
