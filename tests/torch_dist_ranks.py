"""The rank side of tests/test_torch_port_dist.py: what each of the two
gloo ranks runs, in one spawned group for the whole module. It imports no
jax (the ranks are fresh processes); the test module prepares the inputs
(weights, reals, the single-process step's draws) and holds the ranks'
results against catgen and against the port's single-process steps."""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from catgen_torch import models, optim
from catgen_torch.core.random import Draws
from catgen_torch.data.loader import ImageDataset
from catgen_torch.dist import dp, mesh
from catgen_torch.dist.parity import ReplayDraws, split_draws
from catgen_torch.kernels import config as kconfig
from catgen_torch.core.module import Sequential
from catgen_torch.nn.layers import (BatchNorm, Dense, Flatten, PReLU,
                                    Reshape, Sigmoid)
from catgen_torch.train import gan, harness, pretrainer, v_trainer

AXIS = mesh.DATA_AXIS
TINY_IMG = (8, 8, 1)
TINY_NOISE = 8
IMG = (32, 32, 3)
NOISE = 100
LADDER = dict(upsample_impl="pallas", fused_ladder=True, ladder_bwd="pallas")


def tiny_g(axis_name=None):
    """catgen's tests/test_dist.py tiny G, built with its widths."""
    return Sequential([
        Dense(TINY_NOISE, 16), BatchNorm(16, axis_name), PReLU(),
        Dense(16, 64), Sigmoid(), Reshape(TINY_IMG),
    ], name="tinyG")


def tiny_d():
    return Sequential([
        Flatten(), Dense(64, 16), PReLU(), Dense(16, 1), Sigmoid(),
    ], name="tinyD")


def tiny_config(batch_size: int, axis_name=None) -> gan.GanConfig:
    """catgen's zeroed-G trick: SGD, D's lr 0.1, G's 0, no penalties."""
    return gan.GanConfig(batch_size=batch_size, noise_dim=TINY_NOISE,
                         acc_window=4, d_optimizer="sgd",
                         g_optimizer="sgd", d_lr=0.1, g_lr=0.0,
                         d_clamp=0.0, d_l2=0.0, g_clamp=0.0,
                         axis_name=axis_name)


def rows(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    """The rank's contiguous share of a global batch."""
    n = x.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(x[rank * n:(rank + 1) * n]))


def capture(into: list):
    """Records the gradients each optimizer update is handed."""
    real = optim.clamp_and_penalize

    def spy(grads, *args, **kwargs):
        into.append({k: v.detach().clone().numpy()
                     for k, v in grads.items()})
        return real(grads, *args, **kwargs)

    return mock.patch.object(optim, "clamp_and_penalize", spy)


def state_numpy(*named_modules) -> dict:
    return {f"{prefix}.{k}": v.detach().clone().numpy()
            for prefix, m in named_modules
            for k, v in m.state_dict().items()}


def _tiny(rank, world, spec) -> dict:
    g, d = tiny_g(AXIS), tiny_d()
    g.load_state_dict(spec["g"])
    d.load_state_dict(spec["d"])
    config = tiny_config(spec["batch"])
    state = gan.init_state(g, d, config)
    mesh.replicate(state)
    step = dp.make_dp_train_step(g, d, config)
    gen = mesh.rank_generator(5, "cpu")
    m = step(state, rows(spec["reals"], rank, world), Draws(gen))
    mesh.assert_replicated(state)
    return {"d": state_numpy(("d", d)), "loss_d": float(m.loss_d),
            "count": int(m.tp_real + m.tn_fake + m.fp + m.fn)}


def _gan(rank, world, spec, route) -> dict:
    g = models.create_G_decoder_upsampling32c(IMG, NOISE, axis_name=AXIS)
    d = models.create_D32_st3(IMG, axis_name=AXIS)
    g.load_state_dict(spec["g"])
    d.load_state_dict(spec["d"])
    config = gan.GanConfig(batch_size=spec["batch"], augment=True,
                           d_optimizer=spec["d_optimizer"])
    state = gan.init_state(g, d, config)
    mesh.replicate(state)
    step = dp.make_dp_train_step(g, d, config)
    draws = ReplayDraws(split_draws(spec["records"], rank, world,
                                    spec["pairs"]))
    grads = []
    before = mesh.ALL_REDUCES
    with capture(grads), kconfig.using(**route):
        m = step(state, rows(spec["reals"], rank, world), draws)
    reduces = mesh.ALL_REDUCES - before
    mesh.assert_replicated(state)
    assert not draws.records, "the DP step drew less than the single one"
    return {"metrics": {k: float(v) for k, v in m._asdict().items()},
            "grads": grads, "state": state_numpy(("g", g), ("d", d)),
            "all_reduces": reduces,
            "expected_all_reduces": dp.all_reduces_per_gan_step(g, d,
                                                                config)}


def _v(rank, world, spec) -> dict:
    v = models.create_V32(IMG, axis_name=AXIS)
    v.load_state_dict(spec["v"])
    config = v_trainer.VConfig(batch_size=spec["batch"])
    state = v_trainer.init_state(v, config)
    mesh.replicate(state)
    step = dp.make_dp_v_step(v, config)
    draws = ReplayDraws(split_draws(spec["records"], rank, world,
                                    [True] * len(spec["records"])))
    grads = []
    with capture(grads):
        m = step(state, rows(spec["reals"], rank, world),
                 rows(spec["fakes"], rank, world), draws)
    mesh.assert_replicated(state)
    return {"metrics": {k: float(x) for k, x in m._asdict().items()},
            "grads": grads, "state": state_numpy(("v", v))}


def _ae(rank, world, spec) -> dict:
    ae = models.create_G_autoencoder(IMG, NOISE, axis_name=AXIS)
    ae.load_state_dict(spec["ae"])
    config = pretrainer.PretrainConfig(batch_size=spec["batch"])
    state = pretrainer.init_state(ae, config)
    mesh.replicate(state)
    step = dp.make_dp_ae_step(ae, config)
    grads = []
    with capture(grads):
        loss = step(state, rows(spec["images"], rank, world))
    mesh.assert_replicated(state)
    return {"loss": float(loss), "grads": grads,
            "state": state_numpy(("ae", ae))}


def _harnesses(rank, world, spec) -> dict:
    """catgen's tests/test_harness_dp.py on the port's harnesses, at as
    many steps an epoch as catgen's 8-device run takes (4)."""
    harness.OVERLAY_BANK = spec["bank"]
    dataset = ImageDataset([spec["corpus"]], scale=16, device="cpu")
    out = {}
    save = spec["gan_save"]
    hc = harness.HarnessConfig(save_dir=save, n_epoch=32, scale=16,
                               seed=3, n_devices=world, g_model="g16up",
                               d_model="d16b", save_freq=1)
    gc = gan.GanConfig(batch_size=8)
    h = harness.GanHarness(hc, gc, dataset, torch.device("cpu"))
    out["gan_epoch"] = h.run_epoch()
    h.visualize()
    h.save()
    mesh.assert_replicated(h.state)
    mesh.barrier()                  # rank 0's checkpoint is written
    h2 = harness.GanHarness(hc, gc, dataset, torch.device("cpu"))
    h2.resume()
    out["gan_resumed_epoch"] = h2.state.epoch
    out["gan_epoch2"] = h2.run_epoch()
    mesh.assert_replicated(h2.state)
    out["gan_state"] = state_numpy(("g", h2.state.g), ("d", h2.state.d))
    out["decoder_used"] = dataset.decoder_used

    hc = harness.HarnessConfig(save_dir=spec["v_save"], n_epoch=32,
                               scale=16, seed=5, n_devices=world,
                               v_model="v16")
    vh = harness.VHarness(hc, v_trainer.VConfig(batch_size=8), dataset,
                          torch.device("cpu"))
    out["v_epoch"] = vh.run_epoch()
    vh.save()
    mesh.assert_replicated(vh.state)
    out["v_choices"] = [np.asarray(c).tolist() for c in vh.choices[0]]

    hc = harness.HarnessConfig(save_dir=spec["ae_save"], n_epoch=32,
                               scale=16, seed=7, n_devices=world)
    ph = harness.PretrainHarness(hc, pretrainer.PretrainConfig(batch_size=8),
                                 dataset, torch.device("cpu"))
    out["ae_epochs"] = [ph.run_epoch(), ph.run_epoch()]
    ph.save()
    mesh.assert_replicated(ph.state)
    return out


def run_all(local_rank: int, device, spec: dict) -> dict:
    """Every case of the module on this rank; each checks that the state
    stayed bit-equal across the ranks (``mesh.assert_replicated``)."""
    rank, world = mesh.rank(), mesh.world_size()
    gen = mesh.rank_generator(11, "cpu")
    out = {"rank": rank, "world": world, "seed": mesh.rank_seed(11),
           "stream": torch.rand(4, generator=gen).numpy(),
           "tiny": _tiny(rank, world, spec["tiny"])}
    for name, route in (("default", {}), ("ladder", LADDER)):
        out[f"gan_{name}"] = _gan(rank, world, spec[f"gan_{name}"], route)
    out["v"] = _v(rank, world, spec["v"])
    out["ae"] = _ae(rank, world, spec["ae"])
    out["harness"] = _harnesses(rank, world, spec["harness"])
    if rank:    # replicated: rank 0's weights and gradients stand for all
        for case in ("gan_default", "gan_ladder", "v", "ae"):
            out[case] = {k: v for k, v in out[case].items()
                         if k not in ("grads", "state")}
        out["harness"].pop("gan_state")
    return out
