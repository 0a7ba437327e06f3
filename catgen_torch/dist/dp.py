"""Data-parallel training steps and epochs: the counterpart of
``catgen/dist/dp.py``.

catgen wraps its single-chip step in ``shard_map`` over the mesh's
``data`` axis. Here every rank runs the single-process step on its own
rows, with the config's ``axis_name`` set, inside a ``torch.distributed``
group (``dist.mesh``):

  * parameters, optimizer states and the gate's buffer are replicated:
    they start equal (``mesh.replicate``) and stay bit-equal, because the
    gradients and the gate's batch accuracy are averaged inside the step
    (``GanConfig.axis_name``), and BatchNorm's batch statistics over the
    ranks (the models' ``axis_name``);
  * the reals are the rank's rows of the global batch, the fakes its own;
  * each rank draws from its own stream (``mesh.rank_generator``,
    catgen's ``fold_in_axis_index``): the caller hands each rank its
    ``Draws``;
  * the metrics come back reduced over the ranks: losses and accuracies
    averaged, confusion counts summed (``_reduce_metrics``), once per step
    or, for an epoch, once per epoch.

The global batch is ``batch_size`` times the ranks. A world of one runs
the single-process step's arithmetic bit for bit, the collectives
included.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

from torch import nn

from catgen_torch.dist import mesh
from catgen_torch.nn.layers import BatchNorm


def _with_axis(config, *models: nn.Module):
    """The config with its ``axis_name`` set (catgen's ``_with_axis``).
    A step built from a config that skips its reductions would let the
    ranks' gradients, gate decisions and so parameters drift apart, so
    the DP builders rebind it; likewise every BatchNorm of the models must
    sync its statistics, or the running statistics drift apart: a model
    built without ``axis_name`` raises."""
    if config.axis_name is None:
        config = dataclasses.replace(config, axis_name=mesh.DATA_AXIS)
    axis = config.axis_name
    unsynced = [f"{type(m).__name__}.{name}" for m in models
                for name, layer in m.named_modules()
                if isinstance(layer, BatchNorm) and layer.axis_name != axis]
    if unsynced:
        raise ValueError(
            f"a data-parallel step needs every BatchNorm synced over "
            f"{axis!r}: build the models with axis_name={axis!r} "
            f"(not synced: {unsynced[:4]})")
    mesh.check_axis(axis)        # raises outside a process group
    return config, axis


_MEAN_FIELDS = ("loss", "loss_d", "loss_g", "acc", "acc_d", "acc_avg",
                "d_trained")


def _reduce_metrics(metrics: NamedTuple, axis: str) -> NamedTuple:
    """Losses and accuracies averaged over the ranks, confusion counts
    summed: one all-reduce of a flat buffer, whatever the fields' shapes
    (a step's scalars or an epoch's stacks)."""
    sums = mesh.all_reduce_sum_flat(list(metrics), axis)
    world = mesh.world_size(axis)
    return type(metrics)(*(
        s / world if f in _MEAN_FIELDS else s
        for f, s in zip(metrics._fields, sums)))


def _reduce_loss(loss, axis: str):
    return mesh.all_reduce_mean_flat([loss], axis)[0]


def make_dp_train_step(g: nn.Module, d: nn.Module, config):
    """``step(state, reals, draws) -> StepMetrics`` reduced over the
    ranks: ``gan.make_train_step`` on this rank's reals
    (``d_iterations * batch_size/2`` rows) and draws, the state updated in
    place and kept replicated."""
    from catgen_torch.train import gan

    config, axis = _with_axis(config, g, d)
    step = gan.make_train_step(g, d, config)

    def dp_step(state, reals, draws):
        return _reduce_metrics(step(state, reals, draws), axis)

    dp_step.config = config
    return dp_step


def make_dp_train_epoch(g: nn.Module, d: nn.Module, config):
    """``epoch(state, real_batches, draws) -> StepMetrics`` of per-step
    stacks, reduced once: ``real_batches`` is this rank's (nb,
    d_iterations * batch_size/2, H, W, C)."""
    from catgen_torch.train import gan

    config, axis = _with_axis(config, g, d)
    epoch = gan.make_train_epoch(g, d, config)

    def dp_epoch(state, real_batches, draws):
        return _reduce_metrics(epoch(state, real_batches, draws), axis)

    dp_epoch.config = config
    return dp_epoch


def make_dp_v_step(v: nn.Module, config):
    """``step(state, reals, fakes, draws) -> VStepMetrics`` reduced over
    the ranks; reals and fakes are this rank's ``batch_size/2`` each."""
    from catgen_torch.train import v_trainer

    config, axis = _with_axis(config, v)
    step = v_trainer.make_train_step(v, config)

    def dp_step(state, reals, fakes, draws):
        return _reduce_metrics(step(state, reals, fakes, draws), axis)

    dp_step.config = config
    return dp_step


def make_dp_v_epoch(v: nn.Module, config, bank, image_shape):
    """``epoch(state, reals, gen_reals, branches, sub_branches, submix,
    draws)`` reduced once: reals (nb, B/2, ...) and gen_reals (nb, 4, B/2,
    ...) are this rank's rows; the host's generator choices are the same
    on every rank (one generator per global batch, as catgen's), the
    device draws the rank's own."""
    from catgen_torch.train import v_trainer

    config, axis = _with_axis(config, v)
    epoch = v_trainer.make_train_epoch(v, config, bank, image_shape)

    def dp_epoch(state, reals, gen_reals, branches, sub_branches, submix,
                 draws):
        return _reduce_metrics(epoch(state, reals, gen_reals, branches,
                                     sub_branches, submix, draws), axis)

    dp_epoch.config = config
    return dp_epoch


def make_dp_ae_step(autoencoder: nn.Module, config):
    """``step(state, images) -> mse`` averaged over the ranks; ``images``
    are this rank's ``batch_size``."""
    from catgen_torch.train import pretrainer

    config, axis = _with_axis(config, autoencoder)
    step = pretrainer.make_train_step(autoencoder, config)

    def dp_step(state, images):
        return _reduce_loss(step(state, images), axis)

    dp_step.config = config
    return dp_step


def make_dp_ae_epoch(autoencoder: nn.Module, config):
    """``epoch(state, batches) -> losses (nb,)`` averaged over the ranks
    once; ``batches`` is this rank's (nb, batch_size, H, W, C)."""
    from catgen_torch.train import pretrainer

    config, axis = _with_axis(config, autoencoder)
    epoch = pretrainer.make_train_epoch(autoencoder, config)

    def dp_epoch(state, batches):
        return _reduce_loss(epoch(state, batches), axis)

    dp_epoch.config = config
    return dp_epoch


def all_reduces_per_gan_step(g: nn.Module, d: nn.Module, config) -> int:
    """The all-reduces one DP GAN step issues (``make_dp_train_step``,
    the metrics' one included): per D iteration, each synced BatchNorm
    (or ladder block) of G once and D's once forward and once backward,
    plus D's gradients with the accuracy; per G iteration, G's and D's
    once forward and once backward, plus G's gradients; then the metrics.
    Under ``remat`` the backward recomputes each forward once more."""
    g_bn = _synced(g)
    d_bn = _synced(d)
    fwd = 2 if config.remat else 1
    d_iter = g_bn + (fwd + 1) * d_bn + 1
    g_iter = (fwd + 1) * (g_bn + d_bn) + 1
    return config.d_iterations * d_iter + config.g_iterations * g_iter + 1


def _synced(module: nn.Module) -> int:
    return sum(isinstance(m, BatchNorm) and m.axis_name is not None
               for m in module.modules())

