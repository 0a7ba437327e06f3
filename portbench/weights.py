"""Weights, inputs and seeds made from ``--seed``, on the device, in a few
large calls: the same seed gives the same tensors.

The weights follow the models' initialisation scheme: each conv and
dense weight uniform in +-gain * sqrt(1 / (3 fan_in)) (catgen's heuristic
init at gain 1, as training starts from it), biases zero, PReLU slopes
0.25, BatchNorm scales 1 and shifts 0; the spatial transformers' heads
noisy around their identity (weights N(0, 0.05), biases their identity
plus N(0, 0.2)), so that the samplers read between pixel centres;
BatchNorm running statistics noisy (mean N(0, 0.1), variance U(0.5, 2)),
which only evaluation reads.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...]]]


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def cuda_generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, tag))
    return gen


def spec_of(module: torch.nn.Module) -> Spec:
    """(name, shape) of every parameter and buffer, in definition order."""
    return ([(k, tuple(p.shape)) for k, p in module.named_parameters()]
            + [(k, tuple(b.shape)) for k, b in module.named_buffers()])


def _is_head(name: str) -> bool:
    """A spatial transformer's parameter head: ``st.head`` (a
    ``SpatialTransformer``) or ``head<i>`` (a branch block)."""
    parts = name.split(".")
    return len(parts) >= 3 and (parts[-3:-1] == ["st", "head"] or (
        parts[-2].startswith("head") and parts[-2][4:].isdigit()))


def _fan_in(shape: Sequence[int]) -> int:
    return int(np.prod(shape[1:]))


def make(spec: Spec, seed: int, tag: str, device,
         gain: float = 1.0) -> Dict[str, torch.Tensor]:
    """The tensors of ``spec`` from ``seed``: one uniform and one normal
    draw of the whole model on ``device``, sliced and scaled per leaf.
    A transformer's head is a ``head``/``head<i>`` child; its identity bias
    is read from the zero-noise value each shape implies (1 parameter:
    the angle 0; 4: angle 0, scale 1, translation 0)."""
    total = sum(math.prod(s) for _, s in spec)
    gen = cuda_generator(seed, tag, device)
    uni = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    nrm = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape in spec:
        n = math.prod(shape)
        u, z = uni[at:at + n].view(shape), nrm[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if _is_head(name):
            if leaf == "weight":
                v = z * 0.05
            else:
                ident = {1: [0.0], 4: [0.0, 1.0, 0.0, 0.0]}[n]
                v = torch.tensor(ident, device=device) + z * 0.2
        elif leaf == "weight":
            v = u * (gain * math.sqrt(1.0 / (3.0 * _fan_in(shape))))
        elif leaf == "alpha":
            v = torch.full(shape, 0.25, device=device)
        elif leaf == "scale":
            v = torch.ones(shape, device=device)
        elif leaf == "mean":
            v = z * 0.1
        elif leaf == "var":
            v = (u + 1.0) * 0.75 + 0.5
        else:                                   # biases
            v = torch.zeros(shape, device=device)
        out[name] = v.contiguous()
    return out


def load_into(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]
              ) -> None:
    with torch.no_grad():
        for k, p in list(module.named_parameters()) + list(
                module.named_buffers()):
            p.copy_(tensors[k])


def uint8_images(seed: int, tag: str, shape: Sequence[int]) -> np.ndarray:
    """Random uint8 images made on the host, as a loader's are."""
    rng = np.random.default_rng(subseed(seed, tag))
    return np.frombuffer(bytearray(rng.bytes(math.prod(shape))),
                         np.uint8).reshape(shape)
