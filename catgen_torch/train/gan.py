"""The GAN training engine: the counterpart of ``catgen/train/gan.py``.

One step alternates, as the reference's adversarial.lua does:

  * D phase, ``d_iterations`` times: a batch of half reals (fresh ones per
    iteration) and half G fakes (detached), targets real=1 / fake=0, BCE,
    the L1/L2/clamp pipeline, and the rolling-accuracy gate: D's update is
    skipped while the mean accuracy over the last ``acc_window`` batches
    (the current one included) is >= ``d_max_acc``. A skipped update leaves
    D's parameters and its optimizer state, step count included, as they
    were; the decision is a select on the device, so no step waits for the
    host.
  * G phase, ``g_iterations`` times: a full batch of fresh noise with
    flipped labels (targets=1), gradients through a frozen D
    (``torch.autograd.grad`` with respect to G's parameters only: D's
    ``.grad`` is never touched).

Mode semantics are the reference's: D's dropout is active in both phases
and G runs in training mode, so its BatchNorm uses batch statistics and
advances its running statistics on every forward, the D phase's fakes
included (``g_bn_advance_in_d``). With the default logit-space BCE, D's
final Sigmoid is peeled and the loss reads logits; D's weights are the
same.

The modules own their weights, so the step updates the ``TrainState`` in
place (parameters, buffers and optimizer tensors) and returns the step's
metrics as 0-d tensors on the device. Every random draw of a step comes,
in catgen's order, from one ``Draws`` (``catgen_torch.core.random``).

``compute_dtype`` (f32 or bf16) is the activations' dtype, as catgen's:
the noise is drawn in it and the reals are cast to it (before the
augmentation), the layers cast their f32 parameters to it where they use
them (``nn/layers.py``), and the losses upcast to f32; parameters,
optimizer states and BatchNorm statistics stay f32. ``remat`` recomputes
G's and D's forwards in the backward (``torch.utils.checkpoint``, where
catgen wraps the same module applications in ``jax.checkpoint``); the
recompute replays the region's dropout masks and leaves BatchNorm's
running statistics alone, so the step equals the one without it bit for
bit. ``bce=None`` reads ``CATGEN_BCE`` (default ``logits``), as catgen's
step does.

``axis_name`` (``dist.mesh.DATA_AXIS``) makes the step one rank's share of
a data-parallel step (``dist/dp.py``): each phase's gradients are averaged
over the ranks in one all-reduce of a flat buffer, the D phase's together
with the batch accuracy, before the gate reads it, so that every rank
takes the same gate decision and the replicas stay bit-equal; frozen G
children are zeroed after the reduction. The models' BatchNorms sync
their statistics on their own ``axis_name``.

Not yet ported: catgen's flat optimizer (bit-identical updates, a speed
choice; ROADMAP item 3.1).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from catgen_torch import optim
from catgen_torch.core.module import Sequential
from catgen_torch.core.random import Draws, remat_contexts
from catgen_torch.data import color as colorlib
from catgen_torch.data.ops import augment_batch
from catgen_torch.dist import mesh
from catgen_torch.nn.layers import Sigmoid, set_draws

BCE_CHOICES = ("logits", "torch", "clip")
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)

# GanConfig.bce=None reads the environment once, at import, as catgen does
# (catgen/train/gan.py): a typo fails loudly instead of falling through
_bce_choice = os.environ.get("CATGEN_BCE", "logits")
if _bce_choice not in BCE_CHOICES:
    raise ValueError(f"CATGEN_BCE={_bce_choice!r}: pick one of "
                     f"{sorted(BCE_CHOICES)}")


@dataclasses.dataclass(frozen=True)
class GanConfig:
    """Training knobs: the reference's train.lua flag block."""
    batch_size: int = 32
    noise_dim: int = 100
    d_optimizer: str = "adam"
    g_optimizer: str = "adam"
    d_lr: Optional[float] = None  # None: the method's torch7 default
    g_lr: Optional[float] = None
    d_sgd_lr: float = 0.02
    g_sgd_lr: float = 0.02
    d_sgd_momentum: float = 0.0
    g_sgd_momentum: float = 0.0
    d_adagrad_lr: float = 1e-3
    g_adagrad_lr: float = 3e-3
    d_l1: float = 0.0
    d_l2: float = 1e-4
    g_l1: float = 0.0
    g_l2: float = 0.0
    d_clamp: float = 1.0
    g_clamp: float = 5.0
    d_iterations: int = 1
    g_iterations: int = 1
    d_max_acc: float = 1.01
    acc_window: int = 20
    augment: bool = False          # train-time augmentation of the reals
    normalized_inputs: bool = False    # reals arrive in [-1, 1]
    g_bn_advance_in_d: bool = True     # G's BN stats advance in the D phase
    g_frozen_children: Tuple[str, ...] = ()   # top-level G children kept
    compute_dtype: torch.dtype = torch.float32   # or torch.bfloat16
    remat: bool = False            # recompute G's and D's forwards
    bce: Optional[str] = None      # "logits" | "torch" | "clip"; None:
                                   # the CATGEN_BCE default
    axis_name: Optional[str] = None    # data-parallel axis (DATA_AXIS)

    def make_optimizers(self) -> Tuple[optim.Optimizer, optim.Optimizer]:
        """(D's, G's) optimizer."""
        return (self._make(self.d_optimizer, self.d_lr, self.d_sgd_lr,
                           self.d_sgd_momentum, self.d_adagrad_lr),
                self._make(self.g_optimizer, self.g_lr, self.g_sgd_lr,
                           self.g_sgd_momentum, self.g_adagrad_lr))

    @staticmethod
    def _make(name, lr, sgd_lr, sgd_momentum, adagrad_lr) -> optim.Optimizer:
        if name == "sgd":
            return optim.sgd(lr=lr if lr is not None else sgd_lr,
                             momentum=sgd_momentum)
        if name == "adagrad":
            return optim.adagrad(lr=lr if lr is not None else adagrad_lr)
        if lr is not None:
            return optim.make(name, lr=lr)
        return optim.make(name)


@dataclasses.dataclass
class TrainState:
    """G and D (which hold their parameters and BatchNorm statistics), the
    two optimizer states keyed by parameter name, and the gate's circular
    accuracy buffer. ``acc_count``, ``acc_index``, ``step`` and ``epoch``
    do not depend on the data, so they are host integers."""
    g: nn.Module
    d: nn.Module
    g_opt: NamedTuple
    d_opt: NamedTuple
    acc_buffer: torch.Tensor     # (acc_window,) f32, on the device
    acc_count: int = 0           # valid entries (saturates at the window)
    acc_index: int = 0           # circular write position
    step: int = 0
    epoch: int = 1


class StepMetrics(NamedTuple):
    loss_d: torch.Tensor      # mean D loss over the d_iterations batches
    loss_g: torch.Tensor
    acc_d: torch.Tensor       # mean D batch accuracy over the iterations
    acc_avg: torch.Tensor     # the gate's rolling mean after the last one
    d_trained: torch.Tensor   # fraction of D iterations whose update applied
    # confusion counts summed over all d_iterations batches
    tp_real: torch.Tensor
    tn_fake: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor


def bce_torch(pred: torch.Tensor, target: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """Torch7's nn.BCECriterion on probabilities, with the eps floors as
    catgen writes them: ``-(t log max(p, eps) + (1-t) log max(1-p, eps))``."""
    p = pred.float()
    t = target.float()
    pos = torch.log(torch.clamp(p, min=eps))
    neg = torch.log(torch.clamp(1.0 - p, min=eps))
    return -torch.mean(t * pos + (1.0 - t) * neg)


def bce_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE in logit space, ``mean(softplus(l) - t*l)``: the gradient is
    ``sigmoid(l) - t`` at any saturation depth."""
    l = logits.float()
    t = target.float()
    return torch.mean(F.softplus(l) - t * l)


def bce_clip(pred: torch.Tensor, target: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """BCE with the prediction clipped to [eps, 1-eps] (zero gradient
    outside the window): catgen's rounds 1-4 baseline."""
    p = torch.clamp(pred.float(), eps, 1.0 - eps)
    t = target.float()
    return -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))


_PROB_BCE = {"torch": bce_torch, "clip": bce_clip}


def draw_noise(draws: Draws, shape, dtype: torch.dtype) -> torch.Tensor:
    """The step's noise, U(-1, 1) of ``shape`` in ``dtype``. catgen draws
    it as ``jax.random.uniform(key, shape, bf16, -1, 1)``: 7 random
    mantissa bits give u in [0, 1) in steps of 1/128, so the noise lies in
    [-1, 63/64] in steps of 1/64. A round-to-nearest cast of an f32 draw
    could give 1.0; instead the f32 draw is floored onto catgen's grid,
    which keeps [-1, 1) and maps a value already on it (catgen's replayed
    draws) to itself."""
    u = draws.uniform(shape, -1.0, 1.0)
    if dtype == torch.float32:
        return u
    return (torch.floor((u + 1.0) * 64.0) / 64.0 - 1.0).to(dtype)


def uniform_noise(generator: torch.Generator, n: int, noise_dim: int,
                  device=None) -> torch.Tensor:
    """Noise ~ U(-1, 1) of shape (n, noise_dim). Drawn on the generator's
    device and then moved to ``device``, so a seed gives the same noise
    whichever device the models run on."""
    u = torch.rand((n, noise_dim), generator=generator,
                   device=generator.device)
    return (u * 2.0 - 1.0).to(device if device is not None else u.device)


def generate(g: nn.Module, noise: torch.Tensor) -> torch.Tensor:
    """G forward in eval mode (BN reads its running statistics)."""
    g.eval()
    with torch.inference_mode():
        return g(noise)


def discriminate(d: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """D scores (N,) in eval mode."""
    d.eval()
    with torch.inference_mode():
        return d(images)[:, 0]


def augment_reals(config: GanConfig, draws: Draws,
                  reals: torch.Tensor) -> torch.Tensor:
    """Train-time augmentation of the real half-batches. ``augment_batch``
    works in [0, 1], so normalized reals are mapped there and back."""
    x = reals
    if config.normalized_inputs:
        x = colorlib.denormalize(x)
    x = augment_batch(draws, x)
    if config.normalized_inputs:
        x = colorlib.normalize(x)
    return x


def params_of(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters by ``state_dict`` name, detached."""
    return {k: p.detach() for k, p in module.named_parameters()}


def init_state(g: nn.Module, d: nn.Module, config: GanConfig) -> TrainState:
    """A fresh train state around G and D, which hold their weights and
    are on their device: zero optimizer states and an empty gate."""
    d_optim, g_optim = config.make_optimizers()
    device = next(g.parameters()).device
    return TrainState(
        g=g, d=d, g_opt=g_optim.init(params_of(g)),
        d_opt=d_optim.init(params_of(d)),
        acc_buffer=torch.zeros((config.acc_window,), dtype=torch.float32,
                               device=device))


def _buffers(module: nn.Module, prefixes=None) -> List[torch.Tensor]:
    return [b for k, b in module.named_buffers()
            if prefixes is None or k.startswith(prefixes)]


def _snapshot(buffers: List[torch.Tensor]) -> List[torch.Tensor]:
    return [b.clone() for b in buffers]


def _restore(buffers: List[torch.Tensor], saved: List[torch.Tensor]) -> None:
    with torch.no_grad():
        for b, s in zip(buffers, saved):
            b.copy_(s)


def _write(params: Dict[str, torch.Tensor],
           values: Dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(values[k])


def make_train_step(g: nn.Module, d: nn.Module, config: GanConfig):
    """Builds the step: ``step(state, reals, draws) -> StepMetrics``, which
    updates ``state`` in place.

    ``reals`` is ``d_iterations`` half-batches stacked along the batch
    axis, (d_iterations * batch_size/2, H, W, C), in [0, 1] (in [-1, 1]
    with ``normalized_inputs``), on the models' device; the step casts
    them to ``compute_dtype``. It draws its noise, augmentation and
    dropout masks from ``draws``."""
    if config.d_iterations < 1 or config.g_iterations < 1:
        raise ValueError(
            f"d_iterations/g_iterations must be >= 1 (got "
            f"{config.d_iterations}/{config.g_iterations}); the reference "
            f"always runs at least one D and one G update per batch")
    bce = config.bce or _bce_choice
    if bce not in BCE_CHOICES:
        raise ValueError(f"GanConfig.bce={bce!r}: pick one of "
                         f"{sorted(BCE_CHOICES)}")
    cdt = config.compute_dtype
    if cdt not in COMPUTE_DTYPES:
        raise ValueError(f"GanConfig.compute_dtype={cdt}: pick one of "
                         f"{list(COMPUTE_DTYPES)}")
    d_optim, g_optim = config.make_optimizers()
    half = config.batch_size // 2
    g_params = dict(g.named_parameters())
    d_params = dict(d.named_parameters())
    d_buffers = _buffers(d)
    g_buffers = _buffers(g)

    children = dict(g.named_children())
    frozen = tuple(config.g_frozen_children)
    for name in frozen:
        if name not in children:
            raise KeyError(f"g_frozen_children entry {name!r} is not a "
                           f"top-level G child (children: "
                           f"{sorted(children)})")
    frozen_prefixes = tuple(f"{name}." for name in frozen)
    frozen_g_buffers = _buffers(g, frozen_prefixes) if frozen else []

    def is_frozen(key: str) -> bool:
        return bool(frozen) and key.startswith(frozen_prefixes)

    def apply(module_fn, x):
        """``module_fn(x)``; under ``remat`` checkpointed, as catgen's
        ``jax.checkpoint`` of the module application: recomputed in the
        backward, replaying its dropout masks (``remat_contexts``)."""
        if not config.remat:
            return module_fn(x)
        return checkpoint(module_fn, x, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=remat_contexts)

    if bce == "logits":
        layers = list(d.children())
        if not (isinstance(d, Sequential) and layers
                and isinstance(layers[-1], Sigmoid)):
            raise ValueError("bce='logits' needs D to be a Sequential "
                             "ending in Sigmoid")
        body = layers[:-1]

        def d_logits(x):
            for layer in body:
                x = layer(x)
            return x

        def d_loss_and_prob(x, targets):
            logits = apply(d_logits, x)[:, 0]
            return bce_logits(logits, targets), torch.sigmoid(logits)
    else:
        prob_bce = _PROB_BCE[bce]

        def d_loss_and_prob(x, targets):
            prob = apply(d, x)[:, 0]
            return prob_bce(prob, targets), prob

    def update(opt, grads, opt_state, params, l1, l2, clamp):
        grads = optim.clamp_and_penalize(grads, params, l1, l2, clamp)
        updates, new_opt = opt.update(grads, opt_state)
        return optim.apply_updates(params, updates), new_opt

    def d_phase(state: TrainState, reals: torch.Tensor, draws: Draws):
        device = reals.device
        noise = draw_noise(draws, (half, config.noise_dim), cdt).to(device)
        saved = (_snapshot(g_buffers) if not config.g_bn_advance_in_d
                 else _snapshot(frozen_g_buffers))
        with torch.no_grad():
            fakes = g(noise)
        if not config.g_bn_advance_in_d:
            _restore(g_buffers, saved)
        else:
            _restore(frozen_g_buffers, saved)
        inputs = torch.cat([reals, fakes], dim=0)
        targets = torch.cat([torch.ones(half, device=device),
                             torch.zeros(half, device=device)])
        loss, prob = d_loss_and_prob(inputs, targets)
        grads = torch.autograd.grad(loss, list(d_params.values()))

        # batch confusion / accuracy
        pred_real = prob > 0.5
        is_real = targets > 0.5
        acc = (pred_real == is_real).float().mean()
        if config.axis_name is not None:
            # one all-reduce: D's gradients and the gate's accuracy
            *grads, acc = mesh.all_reduce_mean_flat([*grads, acc],
                                                    config.axis_name)
        grads = dict(zip(d_params, grads))
        tp = (pred_real & is_real).sum()
        tn = (~pred_real & ~is_real).sum()
        fp = (pred_real & ~is_real).sum()
        fn = (~pred_real & is_real).sum()

        # rolling-accuracy gate: append this accuracy, average over the
        # valid window, train while the average is below d_max_acc
        buf = state.acc_buffer.clone()
        buf[state.acc_index] = acc
        count = min(state.acc_count + 1, config.acc_window)
        acc_avg = buf.sum() / count
        do_train = acc_avg < config.d_max_acc

        values = params_of(d)
        new_params, new_opt = update(d_optim, grads, state.d_opt, values,
                                     config.d_l1, config.d_l2,
                                     config.d_clamp)
        if config.d_max_acc <= 1.0:
            # the gate can fire (an accuracy average never exceeds 1.0)
            new_params = optim.select(do_train, new_params, values)
            new_opt = optim.select(do_train, new_opt, state.d_opt)
        _write(d_params, new_params)
        state.d_opt = new_opt
        state.acc_buffer = buf
        state.acc_count = count
        state.acc_index = (state.acc_index + 1) % config.acc_window
        return loss.detach(), acc, acc_avg, do_train.float(), tp, tn, fp, fn

    def g_phase(state: TrainState, draws: Draws, device) -> torch.Tensor:
        noise = draw_noise(draws, (config.batch_size, config.noise_dim),
                           cdt).to(device)
        targets = torch.ones(config.batch_size, device=device)
        saved_d = _snapshot(d_buffers)        # catgen drops D's new state
        saved_g = _snapshot(frozen_g_buffers)
        # D frozen until the backward is done: a remat recompute of D must
        # save what its first pass saved
        for p in d_params.values():
            p.requires_grad_(False)
        try:
            fakes = apply(g, noise)
            loss, _ = d_loss_and_prob(fakes, targets)
            grads = dict(zip(g_params, torch.autograd.grad(
                loss, list(g_params.values()))))
        finally:
            for p in d_params.values():
                p.requires_grad_(True)
        _restore(d_buffers, saved_d)
        if config.axis_name is not None:
            grads = dict(zip(grads, mesh.all_reduce_mean_flat(
                list(grads.values()), config.axis_name)))
        if frozen:
            grads = {k: torch.zeros_like(v) if is_frozen(k) else v
                     for k, v in grads.items()}
        values = params_of(g)
        new_params, new_opt = update(g_optim, grads, state.g_opt, values,
                                     config.g_l1, config.g_l2,
                                     config.g_clamp)
        if frozen:
            # pin the frozen children exactly: the L1/L2 terms re-add
            # parameter-dependent gradients after the zeroing
            new_params = {k: values[k] if is_frozen(k) else v
                          for k, v in new_params.items()}
            new_opt = type(new_opt)(*(
                {k: old[k] if is_frozen(k) else v for k, v in new.items()}
                if isinstance(new, dict) else new
                for new, old in zip(new_opt, state.g_opt)))
            _restore(frozen_g_buffers, saved_g)
        _write(g_params, new_params)
        state.g_opt = new_opt
        return loss.detach()

    def train_step(state: TrainState, reals: torch.Tensor,
                   draws: Draws) -> StepMetrics:
        if reals.shape[0] != config.d_iterations * half:
            raise ValueError(
                f"the step takes d_iterations*batch_size/2 = "
                f"{config.d_iterations * half} reals, got {reals.shape[0]}")
        g.train()
        d.train()
        set_draws(g, draws)
        set_draws(d, draws)
        reals = reals.to(cdt)         # catgen casts before the augmentation
        if config.augment:
            reals = augment_reals(config, draws, reals)
        d_stats = [d_phase(state, reals[it * half:(it + 1) * half], draws)
                   for it in range(config.d_iterations)]
        for _ in range(config.g_iterations):
            loss_g = g_phase(state, draws, reals.device)
        # losses and accuracies averaged over the D iterations, confusion
        # counts summed; acc_avg is the gate's mean after the last one
        k = config.d_iterations
        fields = [sum(s[i] for s in d_stats) for i in range(8)]
        state.step += 1
        return StepMetrics(fields[0] / k, loss_g, fields[1] / k,
                           d_stats[-1][2], fields[3] / k, *fields[4:])

    # exposed for parity tests and timing, as catgen exposes them
    train_step.d_phase = d_phase
    train_step.g_phase = g_phase
    return train_step


def make_train_epoch(g: nn.Module, d: nn.Module, config: GanConfig):
    """``epoch(state, real_batches, draws) -> StepMetrics`` of stacked
    per-step values: the step over each of ``real_batches`` (nb,
    d_iterations * batch_size/2, H, W, C) in turn, then ``epoch + 1``."""
    step = make_train_step(g, d, config)

    def epoch_fn(state: TrainState, real_batches: torch.Tensor,
                 draws: Draws) -> StepMetrics:
        metrics = [step(state, batch, draws) for batch in real_batches]
        state.epoch += 1
        return StepMetrics(*(torch.stack(list(f)) for f in zip(*metrics)))

    return epoch_fn
