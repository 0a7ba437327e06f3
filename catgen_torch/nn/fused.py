"""G decoder ladder: the counterpart of ``catgen/nn/fused.py``.

``FusedDecoderSequential`` is a ``Sequential`` with the same children,
names, parameters and buffers. On the kernel route (``config.fused_ladder``
and ``resolve_upsample_impl() == "pallas"``) it recognizes
``[UpsampleConv, BatchNorm, PReLU]`` stage groups and runs each as one
boundary-fused block (``kernels/fused_upsample_conv.py``):

  * the block applies the *previous* stage's BatchNorm affine + PReLU to
    its input as it loads it (the identity for the first stage), and
  * emits per-channel [sum y, sum y^2], from which this stage's BatchNorm
    takes its batch statistics in training; in eval it reads the running
    statistics and the block computes no sums.

The pending affine + PReLU of the last stage is applied before the next
plain layer (G32up-c's output conv). In bf16 (catgen's compute dtype) the
blocks take the weight, bias, affine and slope rounded to bf16 (the
affine computed in f32 from the f32 statistics), and the pending affine
at the ladder's end runs on bf16 operands, as catgen's does.

The BatchNorm arithmetic (biased batch variance for normalization;
running mean and unbiased running variance moved by ``momentum`` in
place on the ``BatchNorm`` child's buffers, also under ``torch.no_grad``,
but not in a ``remat`` recompute) follows ``nn.layers.BatchNorm``, so the
two paths are interchangeable and checkpoints identical; under data
parallelism (the BatchNorm's ``axis_name``) the block's sums are averaged
over the ranks, differentiably, before the next stage's transform reads
them (``sync_moments``). Off the kernel route it is the plain
``Sequential``.
"""

from __future__ import annotations

import math

import torch

from catgen_torch.core import random as crandom
from catgen_torch.core.module import Sequential
from catgen_torch.kernels import config
from catgen_torch.kernels.fused_upsample_conv import (
    in_transform, upsample2_conv_block, upsample2_conv_block_fused)
from catgen_torch.kernels.upsample_conv import UpsampleConv
from catgen_torch.nn.layers import BatchNorm, PReLU, sync_moments


def _is_stage(layers, i) -> bool:
    return (i + 2 < len(layers)
            and isinstance(layers[i], UpsampleConv)
            and isinstance(layers[i + 1], BatchNorm)
            and isinstance(layers[i + 2], PReLU))


class FusedDecoderSequential(Sequential):
    """Sequential whose [UpsampleConv, BatchNorm, PReLU] runs execute as
    boundary-fused blocks on the kernel route."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (not config.fused_ladder
                or config.resolve_upsample_impl() != "pallas"):
            return super().forward(x)
        layers = list(self.children())
        pending = None      # (scale, shift, alpha) of the previous BN+PReLU
        i = 0
        while i < len(layers):
            if not _is_stage(layers, i):
                if pending is not None:
                    x = in_transform(x, *pending)
                    pending = None
                x = layers[i](x)
                i += 1
                continue
            uc, bn, pr = layers[i:i + 3]
            dt = x.dtype
            if pending is None:       # identity: slope-1 PReLU
                cin = x.shape[-1]
                pending = (torch.ones(cin, dtype=dt, device=x.device),
                           torch.zeros(cin, dtype=dt, device=x.device),
                           torch.ones(1, dtype=dt, device=x.device))
            weight, bias = uc.weight.to(dt), uc.bias.to(dt)
            if self.training:
                y, s1, s2 = upsample2_conv_block(x, *pending, weight, bias)
                count = math.prod(y.shape[:-1])
                mean, mean_sq, count = sync_moments(
                    s1 / count, s2 / count, count, bn.axis_name)
                var = torch.clamp(mean_sq - mean * mean, min=0.0)
                if not crandom.recomputing():   # else the first pass did
                    with torch.no_grad():
                        m = bn.momentum
                        bn.mean.mul_(1 - m).add_(m * mean)
                        bn.var.mul_(1 - m).add_(
                            m * var * (count / max(count - 1, 1)))
            else:
                y = upsample2_conv_block_fused(x, weight, bias, *pending,
                                               with_stats=False)
                mean, var = bn.mean, bn.var
            # the affine and slope in f32, rounded to y's dtype (catgen's)
            inv = torch.rsqrt(var + bn.eps)
            pending = ((bn.scale * inv).to(dt),
                       (bn.bias - bn.scale * mean * inv).to(dt),
                       pr.alpha.to(dt))
            x = y
            i += 3
        if pending is not None:       # the ladder ended on a stage group
            x = in_transform(x, *pending)
        return x
