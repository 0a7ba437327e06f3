"""Module helpers shared by the port's layers.

catgen's modules are immutable descriptions with their weights in a
pytree; here they are ``torch.nn.Module``s that own their tensors. What is
kept is the naming: a ``Sequential`` names its children
``f"{i:02d}_{name}"`` exactly as ``catgen/core/module.py::Sequential``
does, where ``name`` is a nested Sequential's own name or the class name.
A port ``state_dict`` key such as ``05_FusedSTBranches.loc0.01_Conv.weight``
therefore spells the same path as catgen's
``['05_FusedSTBranches']['loc0']['01_Conv']['kernel']``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def layer_name(layer: nn.Module) -> str:
    """catgen's ``Module.name``: a Sequential's own name, else the class."""
    return getattr(layer, "seq_name", None) or type(layer).__name__


class Sequential(nn.Module):
    """Chain of modules, children named ``{i:02d}_{name}``."""

    def __init__(self, layers: Sequence[nn.Module],
                 name: Optional[str] = None):
        super().__init__()
        self.seq_name = name or "Sequential"
        for i, layer in enumerate(layers):
            self.add_module(f"{i:02d}_{layer_name(layer)}", layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initializes every layer of ``module`` that has weights, in
    definition order, from ``generator`` (catgen's ``init`` counterpart;
    torch's and JAX's random streams differ, so the values do too)."""
    for m in module.modules():
        if hasattr(m, "reset_parameters_"):
            m.reset_parameters_(generator)
