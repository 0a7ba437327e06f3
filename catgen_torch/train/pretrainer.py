"""The G pretrainer: the counterpart of ``catgen/train/pretrainer.py``.

G's decoder is composed with a conv encoder into an autoencoder trained to
reconstruct its input with MSE; the gradients go through the reference's
pipeline (G_L1, G_L2, the clamp +-5), then Torch7-form Adam. Only the
decoder is exported (``extract_decoder``), keyed as a standalone G, into
``g_pretrained_<C>x<H>x<W>_nd<N>.ckpt``, which the GAN harness picks up by
filename.

The autoencoder draws nothing at random, so the step takes no draws. The
epoch is a per-batch loop; catgen's scan and flat staging are TPU
workarounds and are not ported. ``PretrainConfig.axis_name``
(``dist.mesh.DATA_AXIS``) averages the gradients over the data-parallel
ranks in one all-reduce (catgen's ``pmean``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from catgen_torch import optim
from catgen_torch.dist import mesh
from catgen_torch.train.gan import params_of


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """pretrain_g.lua's flag block."""
    batch_size: int = 16
    noise_dim: int = 100
    g_l1: float = 0.0
    g_l2: float = 0.0
    g_clamp: float = 5.0
    lr: Optional[float] = None
    axis_name: Optional[str] = None       # data-parallel axis (DATA_AXIS)

    def make_optimizer(self) -> optim.Optimizer:
        return optim.adam() if self.lr is None else optim.adam(lr=self.lr)


@dataclasses.dataclass
class AEState:
    ae: nn.Module
    opt: NamedTuple
    step: int = 0
    epoch: int = 1


def init_state(ae: nn.Module, config: PretrainConfig) -> AEState:
    """A fresh state around the autoencoder, which holds its weights on its
    device."""
    return AEState(ae=ae, opt=config.make_optimizer().init(params_of(ae)))


def make_train_step(ae: nn.Module, config: PretrainConfig):
    """``step(state, images) -> mse`` (a 0-d tensor on the device): input
    == target."""
    opt = config.make_optimizer()
    params = dict(ae.named_parameters())

    def step(state: AEState, images: torch.Tensor) -> torch.Tensor:
        ae.train()
        loss = torch.mean(torch.square(ae(images) - images))
        grads = torch.autograd.grad(loss, list(params.values()))
        if config.axis_name is not None:
            grads = mesh.all_reduce_mean_flat(grads, config.axis_name)
        grads = dict(zip(params, grads))
        values = params_of(ae)
        grads = optim.clamp_and_penalize(grads, values, config.g_l1,
                                         config.g_l2, config.g_clamp)
        updates, state.opt = opt.update(grads, state.opt)
        new = optim.apply_updates(values, updates)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        state.step += 1
        return loss.detach()

    return step


def make_train_epoch(ae: nn.Module, config: PretrainConfig):
    """``epoch(state, batches (nb, B, H, W, C)) -> losses (nb,)``, the step
    over each batch in turn, then ``epoch + 1``."""
    step = make_train_step(ae, config)

    def epoch_fn(state: AEState, batches: torch.Tensor) -> torch.Tensor:
        losses = torch.stack([step(state, batch) for batch in batches])
        state.epoch += 1
        return losses

    return epoch_fn


def decoder_child_name(ae: nn.Module) -> str:
    """The decoder is child 1 of the encoder + decoder Sequential."""
    return list(dict(ae.named_children()))[1]


def extract_decoder(ae: nn.Module) -> nn.Module:
    """The decoder, whose ``state_dict`` is keyed as a standalone G (the
    reference's ``:get(2)`` export)."""
    return getattr(ae, decoder_child_name(ae))


def insert_decoder(ae: nn.Module, decoder_state: dict) -> None:
    """Loads a standalone G's ``state_dict`` into the decoder (inverse of
    ``extract_decoder``)."""
    extract_decoder(ae).load_state_dict(decoder_state, strict=True)


def reconstruct(ae: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """The autoencoder in eval mode."""
    ae.eval()
    with torch.inference_mode():
        return ae(images)
