"""The plain reference of one GAN training step, from catgen's description
(adversarial.lua's alternation):

  * the reals are augmented: per image a horizontal flip (50%), a scale in
    [0.93, 1.08], a rotation of up to 8 degrees and a translation of up to
    4 px at 64 px (scaled to the image), one inverse-warped bilinear
    resample, then brightness x (1 +- 0.15) and Gaussian noise of sigma
    0.02, clamped to [0, 1]; the draws in the order scale, angle, ty, tx,
    flip, brightness, noise;
  * D phase: B/2 noise rows U(-1, 1) through G (training mode, no
    gradients), D on [reals; fakes] with targets 1 / 0, BCE on D's logits,
    D's gradients plus the L2 penalty, clamped, and Torch7's Adam, applied
    while the rolling accuracy of the last ``acc_window`` batches is below
    ``d_max_acc``;
  * G phase: B noise rows through G and D (D's parameters frozen), targets
    1, G's gradients clamped, Torch7's Adam.

Every random draw comes from ``draws`` in that order; the model functions
draw their dropout masks in the order their forward reaches them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from portbench.reference import nn as R

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    batch_size: int
    noise_dim: int = 100
    augment: bool = True
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-8
    d_l2: float = 1e-4
    d_clamp: float = 1.0
    g_clamp: float = 5.0
    d_max_acc: float = 1.01
    acc_window: int = 20
    # fault switches of the checks (never on in a measured run)
    loss_rows: str = "all"        # "half": the mean over half the batch


def augment(draws, x: torch.Tensor) -> torch.Tensor:
    n, h, w, _ = x.shape
    scale = draws.uniform((n,), 0.93, 1.08)
    angle = draws.uniform((n,), -8.0, 8.0) * (math.pi / 180.0)
    tn = 2.0 * (4.0 * h / 64.0) / max(h - 1, 1)
    ty = draws.uniform((n,), -tn, tn)
    tx = draws.uniform((n,), -tn, tn)
    flip = torch.where(draws.bernoulli(0.5, (n,)), -1.0, 1.0)
    c, s = torch.cos(angle) / scale, torch.sin(angle) / scale
    theta = torch.stack([torch.stack([c, -s * flip, ty], -1),
                         torch.stack([s, c * flip, tx], -1)], 1)
    out = R.sample(x, R.grid_points(theta, h, w))
    out = out * (1.0 + draws.uniform((n, 1, 1, 1), -0.15, 0.15))
    out = out + 0.02 * draws.normal(tuple(out.shape))
    return torch.clamp(out, 0.0, 1.0)


def bce_logits(logits: torch.Tensor, targets: torch.Tensor,
               rows: str = "all") -> torch.Tensor:
    terms = F.softplus(logits) - targets * logits
    if rows == "half":
        terms = terms[: terms.shape[0] // 2]
    return terms.mean()


class Adam:
    """Torch7's Adam: ``-lr sqrt(1 - b2^t) / (1 - b1^t) m / (sqrt(v) +
    eps)``, per leaf."""

    def __init__(self, params: Tree, cfg: StepConfig):
        self.cfg = cfg
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    def updates(self, grads: Tree) -> Tree:
        c = self.cfg
        self.t += 1
        step = c.lr * math.sqrt(1.0 - c.beta2 ** self.t) / (
            1.0 - c.beta1 ** self.t)
        out = {}
        for k, g in grads.items():
            self.m[k] = c.beta1 * self.m[k] + (1.0 - c.beta1) * g
            self.v[k] = c.beta2 * self.v[k] + (1.0 - c.beta2) * g * g
            out[k] = -step * self.m[k] / (torch.sqrt(self.v[k]) + c.adam_eps)
        return out


class Trainer:
    """G's and D's parameters, their Adam states and the gate, advanced one
    step at a time. ``g_fn(params, noise, train)`` gives images and
    ``d_fn(params, images, draws)`` D's logits in training mode."""

    def __init__(self, cfg: StepConfig, g_params: Tree, d_params: Tree,
                 g_fn: Callable, d_fn: Callable):
        self.cfg = cfg
        self.g = {k: v.detach().clone() for k, v in g_params.items()}
        self.d = {k: v.detach().clone() for k, v in d_params.items()}
        self.g_fn, self.d_fn = g_fn, d_fn
        self.g_adam = Adam(self.g, cfg)
        self.d_adam = Adam(self.d, cfg)
        self.acc: List[float] = []
        self.losses: List[tuple] = []

    def step(self, reals: torch.Tensor, draws) -> None:
        c = self.cfg
        half = c.batch_size // 2
        x = augment(draws, reals) if c.augment else reals

        # D phase
        noise = draws.uniform((half, c.noise_dim), -1.0, 1.0)
        with torch.no_grad():
            fakes = self.g_fn(self.g, noise, True)
        inputs = torch.cat([x, fakes])
        targets = torch.cat([torch.ones(half, device=x.device),
                             torch.zeros(half, device=x.device)])
        d_leaves = {k: v.requires_grad_(True) for k, v in self.d.items()}
        logits = self.d_fn(d_leaves, inputs, draws)[:, 0]
        loss_d = bce_logits(logits, targets, c.loss_rows)
        grads = torch.autograd.grad(loss_d, list(d_leaves.values()))
        acc = ((logits > 0) == (targets > 0.5)).float().mean().item()
        self.acc = (self.acc + [acc])[-c.acc_window:]
        grads = {k: torch.clamp(g + c.d_l2 * self.d[k].detach(), -c.d_clamp,
                                c.d_clamp)
                 for k, g in zip(self.d, grads)}
        upd = self.d_adam.updates(grads)
        if sum(self.acc) / len(self.acc) < c.d_max_acc:
            self.d = {k: (v.detach() + upd[k]) for k, v in self.d.items()}
        else:
            self.d = {k: v.detach() for k, v in self.d.items()}

        # G phase
        noise = draws.uniform((c.batch_size, c.noise_dim), -1.0, 1.0)
        g_leaves = {k: v.requires_grad_(True) for k, v in self.g.items()}
        fakes = self.g_fn(g_leaves, noise, True)
        d_frozen = {k: v.detach() for k, v in self.d.items()}
        logits = self.d_fn(d_frozen, fakes, draws)[:, 0]
        loss_g = bce_logits(logits, torch.ones_like(logits), c.loss_rows)
        grads = torch.autograd.grad(loss_g, list(g_leaves.values()))
        grads = {k: torch.clamp(g, -c.g_clamp, c.g_clamp)
                 for k, g in zip(self.g, grads)}
        upd = self.g_adam.updates(grads)
        self.g = {k: (v.detach() + upd[k]) for k, v in self.g.items()}
        self.losses.append((loss_d.item(), loss_g.item()))
