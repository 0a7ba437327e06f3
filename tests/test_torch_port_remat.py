"""``GanConfig.remat`` and the ``CATGEN_BCE`` default of the port's train
step (catgen_torch/train/gan.py), on the CPU.

``remat`` recomputes G's and D's forwards in the backward
(``torch.utils.checkpoint``). The recompute replays the dropout masks its
region drew and leaves BatchNorm's running statistics alone, so a remat
step is the plain step bit for bit: parameters, BatchNorm buffers,
optimizer states, metrics and the next draw of the stream. catgen's own
check of its remat step is tests/test_gan_step.py::
test_remat_step_matches_plain; here the port's remat step is also held
against catgen's, with the f32 parity tests' tolerances (losses rtol
1e-5, parameters, moments and BatchNorm statistics atol 2e-5). catgen's
steps run compiled; its draws are taken out of its plain step through
ordered debug callbacks (inside ``jax.checkpoint`` a recompute would
repeat them) and are the remat step's, from the same state and key.
"""

import copy
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen.train import gan as cgan
from catgen_torch import models as tmodels
from catgen_torch.core.module import reset_parameters
from catgen_torch.core.random import Draws
from catgen_torch.kernels import config as kconfig
from catgen_torch.nn.layers import set_draws
from catgen_torch.train import gan as tgan

from catgen_torch.core.module import Sequential as TSequential
from test_torch_port_bf16 import run_traced, traced_with_callbacks
from test_torch_port_train import (BATCH, Pair, assert_metrics_close,
                                   catgen_models, port_models, _reals)
from torch_port_helpers import LADDER, ReplayDraws


def _state_tensors(state):
    """Every tensor of a port TrainState, by name."""
    out = {f"g.{k}": v for k, v in state.g.state_dict().items()}
    out.update({f"d.{k}": v for k, v in state.d.state_dict().items()})
    for name, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        for field, value in zip(type(opt)._fields, opt):
            items = value.items() if isinstance(value, dict) else [("", value)]
            for k, v in items:
                out[f"{name}.{field}.{k}"] = v
    out["acc_buffer"] = state.acc_buffer
    return out


def _run(models, config, steps=2, seed=7):
    """The port's step ``steps`` times on copies of ``models``; returns
    (state, metrics, the stream's next draw)."""
    g, d = (copy.deepcopy(m) for m in models)
    state = tgan.init_state(g, d, config)
    step = tgan.make_train_step(g, d, config)
    draws = Draws(torch.Generator().manual_seed(seed))
    half = config.batch_size // 2 * config.d_iterations
    metrics = [step(state, torch.tensor(_reals(half, 10 + i,
                                               config.normalized_inputs)),
                    draws) for i in range(steps)]
    return state, metrics, draws.uniform((5,))


def _tiny():
    tg, td = port_models()
    gen = torch.Generator().manual_seed(1)
    reset_parameters(tg, gen)
    reset_parameters(td, gen)
    with torch.no_grad():     # the ST head off the identity, BN stats off
        for name, p in td.named_parameters():
            if "head" in name:
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return tg, td


CASES = {
    "logits": dict(),
    "bce_torch": dict(bce="torch"),
    "augment": dict(augment=True),
    "d_iterations_2": dict(d_iterations=2),
    "bf16": dict(compute_dtype=torch.bfloat16, augment=True),
    "g_frozen": dict(g_frozen_children=("00_Dense",), g_l2=1e-2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_step_is_the_plain_step_bit_for_bit(case):
    models = _tiny()
    base = tgan.GanConfig(batch_size=BATCH, noise_dim=8, acc_window=3,
                          **CASES[case])
    plain = _run(models, base)
    remat = _run(models, dataclasses.replace(base, remat=True))
    a, b = _state_tensors(plain[0]), _state_tensors(remat[0])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for ma, mb in zip(plain[1], remat[1]):
        assert all(torch.equal(x, y) for x, y in zip(ma, mb))
    assert torch.equal(plain[2], remat[2])     # the stream's next draw
    if case == "g_frozen":
        before = models[0].state_dict()
        for k, v in remat[0].g.state_dict().items():
            assert torch.equal(v, before[k]) == k.startswith("00_Dense."), k


def test_remat_g_phase_with_a_frozen_child_takes_only_gs_gradients():
    models = _tiny()
    config = tgan.GanConfig(batch_size=BATCH, noise_dim=8, acc_window=3,
                            remat=True, g_frozen_children=("00_Dense",))
    results = []
    for remat in (False, True):
        g, d = (copy.deepcopy(m) for m in models)
        state = tgan.init_state(g, d, dataclasses.replace(config,
                                                          remat=remat))
        step = tgan.make_train_step(g, d, dataclasses.replace(
            config, remat=remat))
        g.train(), d.train()
        draws = Draws(torch.Generator().manual_seed(3))
        set_draws(g, draws)
        set_draws(d, draws)
        d_before = copy.deepcopy(d.state_dict())
        loss = step.g_phase(state, draws, torch.device("cpu"))
        assert all(p.grad is None for p in d.parameters())
        assert all(torch.equal(v, d_before[k])
                   for k, v in d.state_dict().items())   # D's BN restored
        results.append((loss, copy.deepcopy(g.state_dict()),
                        draws.uniform((3,))))
    (la, ga, na), (lb, gb, nb) = results
    assert torch.equal(la, lb) and torch.equal(na, nb)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k
    frozen = models[0].state_dict()
    assert all(torch.equal(gb[k], frozen[k]) for k in gb
               if k.startswith("00_Dense."))


@pytest.mark.parametrize("route", ["default", "ladder"])
def test_remat_step_of_the_flagship_pair_is_the_plain_step(route):
    # the ladder route moves BatchNorm's statistics in nn/fused.py
    g = tmodels.create_G_decoder_upsampling32c((32, 32, 3), 100)
    d = tmodels.create_D32_st3((32, 32, 3))
    gen = torch.Generator().manual_seed(2)
    reset_parameters(g, gen)
    reset_parameters(d, gen)
    config = tgan.GanConfig(batch_size=4, acc_window=3, augment=True)
    runs = []
    for remat in (False, True):
        gc, dc = copy.deepcopy(g), copy.deepcopy(d)
        cfg = dataclasses.replace(config, remat=remat)
        state = tgan.init_state(gc, dc, cfg)
        draws = Draws(torch.Generator().manual_seed(4))
        reals = torch.rand((2, 32, 32, 3),
                           generator=torch.Generator().manual_seed(5))
        with kconfig.using(**(LADDER if route == "ladder" else {})):
            m = tgan.make_train_step(gc, dc, cfg)(state, reals, draws)
        runs.append((m, _state_tensors(state), draws.uniform((3,))))
    (ma, sa, na), (mb, sb, nb) = runs
    assert all(torch.equal(x, y) for x, y in zip(ma, mb))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(na, nb)


@pytest.mark.parametrize("config", [dict(), dict(augment=True, bce="torch")])
def test_remat_step_matches_catgens_remat_step(config):
    pair = Pair(remat=True, **config)
    reals = jnp.asarray(_reals(BATCH // 2, 11))
    key = jax.random.PRNGKey(21)
    cg, cd = catgen_models()
    plain = jax.jit(cgan.make_train_step(cg, cd, dataclasses.replace(
        pair.c_config, remat=False)))
    draws = []             # catgen's draws, the same with remat or without
    with traced_with_callbacks(draws, []):
        _, plain_m = run_traced(plain, pair.c_state, reals, key)
    pair.c_state, cm = jax.jit(pair.c_step)(pair.c_state, reals, key)
    replay = ReplayDraws(draws)
    tm = pair.t_step(pair.t_state, torch.tensor(np.asarray(reals)), replay)
    assert not replay.records
    assert_metrics_close(plain_m, cm)       # catgen: remat == plain
    assert_metrics_close(cm, tm)
    pair.assert_state_close()


def test_bce_none_reads_catgen_bce(monkeypatch):
    models = _tiny()
    base = tgan.GanConfig(batch_size=BATCH, noise_dim=8, acc_window=3)
    assert base.bce is None
    monkeypatch.setattr(tgan, "_bce_choice", "torch")
    from_env = _run(models, base, steps=1)
    named = _run(models, dataclasses.replace(base, bce="torch"), steps=1)
    for a, b in zip(_state_tensors(from_env[0]).values(),
                    _state_tensors(named[0]).values()):
        assert torch.equal(a, b)
    # the logit-space BCE needs D to end in a Sigmoid; the others do not
    g, d = port_models()
    no_sigmoid = TSequential(list(d.children())[:-1], name="tinyD")
    tgan.make_train_step(g, no_sigmoid, base)
    monkeypatch.setattr(tgan, "_bce_choice", "logits")
    with pytest.raises(ValueError, match="ending in Sigmoid"):
        tgan.make_train_step(g, no_sigmoid, base)


def test_catgen_bce_is_read_at_import_and_a_typo_fails():
    script = ("import importlib, os\n"
              "os.environ['CATGEN_BCE'] = 'clip'\n"
              "from catgen_torch.train import gan\n"
              "print(gan._bce_choice)\n"
              "os.environ['CATGEN_BCE'] = 'hinge'\n"
              "try:\n"
              "    importlib.reload(gan)\n"
              "except ValueError as e:\n"
              "    print(e)\n")
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    # catgen's message for a typo (catgen/train/gan.py)
    assert out.stdout.splitlines() == [
        "clip", "CATGEN_BCE='hinge': pick one of ['clip', 'logits', "
                "'torch']"], out.stderr[-500:]
