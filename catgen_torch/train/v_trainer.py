"""The V trainer: the counterpart of ``catgen/train/v_trainer.py``.

V is a real-vs-synthetic classifier that rates G's samples (the GAN
harness's pseudo-validation curve). A step takes half real and half
synthetic images, a 2-way softmax target (channel 0 fake, channel 1 real)
and BCE with the prediction clipped to [1e-7, 1-1e-7] in f32; the
gradients go through the reference's pipeline with V_L1, V_L2 (0.01) and
the clamp (+-5), then Torch7-form Adam. The step updates the ``VTrainState``
in place (V holds its weights) and returns its metrics on the device.

The epoch is a per-batch loop: generate the batch's fakes, then step.
catgen scans both inside one compiled program and stages the epoch flat,
TPU workarounds that are not ported.

``VConfig.axis_name`` (``dist.mesh.DATA_AXIS``) makes the step one rank's
share of a data-parallel step: the gradients and the batch accuracy are
averaged over the ranks in one all-reduce (catgen's ``pmean``s).

``VConfig.compute_dtype`` (f32 or bf16) is the update's activation dtype:
as catgen's step, it casts the reals and fakes it is handed, after they
were made (the synthetic generators, the warp's sampler kernel included,
run in f32 before it); V's layers cast their f32 parameters to it, and
the BCE upcasts to f32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from catgen_torch import optim
from catgen_torch.dist import mesh
from catgen_torch.nn.layers import set_draws
from catgen_torch.train import synthetic
from catgen_torch.train.gan import bce_clip, params_of


@dataclasses.dataclass(frozen=True)
class VConfig:
    """train_v.lua's flag block."""
    batch_size: int = 32
    v_l1: float = 0.0
    v_l2: float = 0.01
    v_clamp: float = 5.0
    lr: Optional[float] = None            # None: torch7 adam's default
    compute_dtype: torch.dtype = torch.float32   # or torch.bfloat16
    axis_name: Optional[str] = None       # data-parallel axis (DATA_AXIS)

    def make_optimizer(self) -> optim.Optimizer:
        return optim.adam() if self.lr is None else optim.adam(lr=self.lr)


@dataclasses.dataclass
class VTrainState:
    v: nn.Module
    opt: NamedTuple
    step: int = 0
    epoch: int = 1


class VStepMetrics(NamedTuple):
    loss: torch.Tensor
    acc: torch.Tensor
    tp_real: torch.Tensor
    tn_fake: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor


def init_state(v: nn.Module, config: VConfig) -> VTrainState:
    """A fresh state around V, which holds its weights on its device."""
    return VTrainState(v=v, opt=config.make_optimizer().init(params_of(v)))


def make_train_step(v: nn.Module, config: VConfig):
    """``step(state, reals, fakes, draws) -> VStepMetrics``: reals and
    fakes are (batch_size/2, H, W, C) each; the dropout masks come from
    ``draws``."""
    opt = config.make_optimizer()
    half = config.batch_size // 2
    params = dict(v.named_parameters())

    def step(state: VTrainState, reals: torch.Tensor, fakes: torch.Tensor,
             draws) -> VStepMetrics:
        if reals.shape[0] != half or fakes.shape[0] != half:
            raise ValueError(f"the step takes batch_size/2 = {half} reals "
                             f"and fakes, got {reals.shape[0]} and "
                             f"{fakes.shape[0]}")
        v.train()
        set_draws(v, draws)
        device = reals.device
        cdt = config.compute_dtype
        inputs = torch.cat([reals.to(cdt), fakes.to(cdt)])
        t_real = torch.cat([torch.ones(half, device=device),
                            torch.zeros(half, device=device)])
        targets = torch.stack([1.0 - t_real, t_real], dim=-1)
        out = v(inputs)
        loss = bce_clip(out, targets)
        grads = torch.autograd.grad(loss, list(params.values()))
        pred_real = out.detach()[:, 1] > 0.5
        is_real = t_real > 0.5
        acc = (pred_real == is_real).float().mean()
        if config.axis_name is not None:
            *grads, acc = mesh.all_reduce_mean_flat([*grads, acc],
                                                    config.axis_name)
        grads = dict(zip(params, grads))
        values = params_of(v)
        grads = optim.clamp_and_penalize(grads, values, config.v_l1,
                                         config.v_l2, config.v_clamp)
        updates, state.opt = opt.update(grads, state.opt)
        new = optim.apply_updates(values, updates)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        state.step += 1
        return VStepMetrics(
            loss=loss.detach(), acc=acc,
            tp_real=(pred_real & is_real).sum(),
            tn_fake=(~pred_real & ~is_real).sum(),
            fp=(pred_real & ~is_real).sum(),
            fn=(~pred_real & is_real).sum())

    return step


def make_train_epoch(v: nn.Module, config: VConfig, bank: torch.Tensor,
                     image_shape):
    """``epoch(state, reals, gen_reals, branches, sub_branches, submix,
    draws) -> VStepMetrics`` stacked over the epoch's batches, then
    ``epoch + 1``. ``reals`` is (nb, B/2, H, W, C), ``gen_reals`` (nb, 4,
    B/2, H, W, C) the fresh reals each generator reads; ``branches``,
    ``sub_branches`` and ``submix`` (host arrays of nb) are the host's
    generator choices. Each batch generates its fakes from ``draws``, then
    steps on the same ``draws``."""
    step = make_train_step(v, config)
    generate = synthetic.make_batch_generator(bank, image_shape)

    def epoch_fn(state: VTrainState, reals, gen_reals, branches,
                 sub_branches, submix, draws) -> VStepMetrics:
        metrics = []
        for i in range(reals.shape[0]):
            with torch.no_grad():
                fakes = generate(draws, int(branches[i]),
                                 int(sub_branches[i]), bool(submix[i]),
                                 gen_reals[i])
            metrics.append(step(state, reals[i], fakes, draws))
        state.epoch += 1
        return VStepMetrics(*(torch.stack(list(f)) for f in zip(*metrics)))

    return epoch_fn


def warp_batches(branches, sub_branches, submix) -> int:
    """The warp generator runs of an epoch's host choices: one per primary
    warp and one per recursive mix whose second generator is the warp."""
    branches, sub_branches, submix = map(np.asarray, (branches, sub_branches,
                                                      submix))
    return int((branches == synthetic.WARP).sum()
               + (submix & (sub_branches == synthetic.WARP)).sum())


def v_scores(v: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """Per-image p(real), V in eval mode."""
    v.eval()
    with torch.inference_mode():
        return v(images)[:, 1]


def rate_with_v(v: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """Mean p(real) over a batch (the reference's rateWithV)."""
    return v_scores(v, images).mean()
