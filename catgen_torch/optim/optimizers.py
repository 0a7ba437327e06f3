"""Optimizers with the reference's gradient pipeline: the counterpart of
``catgen/optim/optimizers.py``.

adam, adagrad, sgd (classic momentum) and rmsprop with Torch7's default
hyperparameters, as plain functions over dicts of tensors keyed by
``state_dict`` parameter name, with per-leaf state. Before the update the
reference's pipeline runs (``clamp_and_penalize``):

    g <- clip(g + l1 * sign(w) + l2 * w, -clamp, +clamp)     (elementwise)

adam is Torch7's form, ``-lr * sqrt(bc2) / bc1 * m / (sqrt(v) + eps)``,
not ``torch.optim.Adam``'s ``m_hat / (sqrt(v_hat) + eps)``: the two put eps
on different scales. Step counters are 0-d int32 tensors on the device,
so that a step the accuracy gate skips can leave them unchanged without a
host round trip (``select``).

catgen's flat optimizer (``flat_update``, ``CATGEN_FLAT_OPT``) gives
updates bit-identical to the per-leaf path and changes only speed; it is
ROADMAP item 3.1, a multi-tensor update to be measured against the
port's bench, not yet written.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], NamedTuple]
    # (grads, state) -> (updates, new state); the updates are added to the
    # parameters
    update: Callable[[Tree, NamedTuple], tuple]


def _zeros_like(params: Tree) -> Tree:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _step0(params: Tree) -> torch.Tensor:
    device = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=device)


def clamp_and_penalize(grads: Tree, params: Tree, l1: float = 0.0,
                       l2: float = 0.0, clamp: float = 0.0) -> Tree:
    """Adds the L1 (``sign``) and then the L2 penalty gradients, then clamps
    each element to +-clamp (0 disables each part)."""
    out = {}
    for k, g in grads.items():
        p = params[k]
        if l1:
            g = g + l1 * torch.sign(p)
        if l2:
            g = g + l2 * p
        if clamp:
            g = torch.clamp(g, -clamp, clamp)
        out[k] = g
    return out


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: params[k] + updates[k] for k in params}


def select(pred: torch.Tensor, a, b):
    """``a`` where the 0-d bool ``pred`` is true, else ``b``, over equal
    trees (NamedTuples, dicts, tensors): a select on the device."""
    if isinstance(a, torch.Tensor):
        return torch.where(pred, a, b)
    if isinstance(a, dict):
        return {k: select(pred, a[k], b[k]) for k in a}
    return type(a)(*(select(pred, x, y) for x, y in zip(a, b)))


# -- adam (torch7 defaults: lr 1e-3, beta1 .9, beta2 .999, eps 1e-8) -------


class AdamState(NamedTuple):
    step: torch.Tensor
    m: Tree
    v: Tree


def adam(lr: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        return AdamState(_step0(params), _zeros_like(params),
                         _zeros_like(params))

    def update(grads, state):
        step = state.step + 1
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(beta1, t)
        bc2 = 1.0 - torch.pow(beta2, t)
        m = {k: beta1 * state.m[k] + (1 - beta1) * g
             for k, g in grads.items()}
        v = {k: beta2 * state.v[k] + (1 - beta2) * torch.square(g)
             for k, g in grads.items()}
        step_size = lr * torch.sqrt(bc2) / bc1
        updates = {k: -step_size * m[k] / (torch.sqrt(v[k]) + eps)
                   for k in m}
        return updates, AdamState(step, m, v)

    return Optimizer(init, update)


# -- adagrad (torch7: -lr/(1+step*lrd) * g / (sqrt(sum g^2) + 1e-10)) ------


class AdagradState(NamedTuple):
    step: torch.Tensor
    accum: Tree


def adagrad(lr: float = 1e-3, lr_decay: float = 0.0) -> Optimizer:
    def init(params):
        return AdagradState(_step0(params), _zeros_like(params))

    def update(grads, state):
        accum = {k: state.accum[k] + torch.square(g)
                 for k, g in grads.items()}
        clr = lr / (1.0 + state.step.to(torch.float32) * lr_decay)
        updates = {k: -clr * g / (torch.sqrt(accum[k]) + 1e-10)
                   for k, g in grads.items()}
        return updates, AdagradState(state.step + 1, accum)

    return Optimizer(init, update)


# -- sgd with classic momentum (torch7 optim.sgd, no nesterov) --------------


class SgdState(NamedTuple):
    momentum_buf: Tree


def sgd(lr: float = 0.02, momentum: float = 0.0) -> Optimizer:
    def init(params):
        return SgdState(_zeros_like(params))

    def update(grads, state):
        if momentum:
            buf = {k: momentum * state.momentum_buf[k] + g
                   for k, g in grads.items()}
            return {k: -lr * b for k, b in buf.items()}, SgdState(buf)
        return {k: -lr * g for k, g in grads.items()}, state

    return Optimizer(init, update)


# -- rmsprop (torch7 defaults: lr 1e-2, alpha .99, eps 1e-8) ----------------


class RmspropState(NamedTuple):
    ms: Tree


def rmsprop(lr: float = 1e-2, alpha: float = 0.99,
            eps: float = 1e-8) -> Optimizer:
    def init(params):
        return RmspropState(_zeros_like(params))

    def update(grads, state):
        ms = {k: alpha * state.ms[k] + (1 - alpha) * torch.square(g)
              for k, g in grads.items()}
        updates = {k: -lr * g / (torch.sqrt(ms[k]) + eps)
                   for k, g in grads.items()}
        return updates, RmspropState(ms)

    return Optimizer(init, update)


_FACTORIES = {"adam": adam, "adagrad": adagrad, "sgd": sgd,
              "rmsprop": rmsprop}


def make(name: str, **kwargs) -> Optimizer:
    """The reference's --D_optmethod / --G_optmethod factory."""
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; options: "
                         f"{sorted(_FACTORIES)}") from None
    return factory(**kwargs)
