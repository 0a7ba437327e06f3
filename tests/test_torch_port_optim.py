"""The port's optimizers (catgen_torch/optim) against catgen's: five steps
of each, with the L1 / L2 / clamp pipeline in front, on the same numpy
parameters and gradients. f32 on both sides; Torch7's adam form. The
updates agree to f32 rounding of a few ops: rtol 1e-5, atol 1e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import optim as copt
from catgen_torch import optim as topt

SHAPES = {"00_Dense.weight": (6, 5), "00_Dense.bias": (6,),
          "01_Conv.weight": (4, 3, 3, 3)}
CASES = {
    "adam": dict(),
    "adam_lr": dict(lr=2e-3),
    "adagrad": dict(lr=1e-2),
    "sgd": dict(lr=0.05),
    "sgd_momentum": dict(lr=0.05, momentum=0.9),
    "rmsprop": dict(),
}
PIPELINES = [(0.0, 0.0, 0.0), (1e-3, 1e-2, 0.05)]   # (l1, l2, clamp)


def _steps(seed):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_catgen(case, pipeline):
    name = case.split("_")[0]
    kwargs = CASES[case]
    l1, l2, clamp = pipeline
    params, grads = _steps(seed=len(case))
    c_opt, t_opt = copt.make(name, **kwargs), topt.make(name, **kwargs)
    c_params = {k: jnp.asarray(v) for k, v in params.items()}
    t_params = {k: torch.tensor(v) for k, v in params.items()}
    c_state, t_state = c_opt.init(c_params), t_opt.init(t_params)
    for g in grads:
        cg = copt.clamp_and_penalize({k: jnp.asarray(v) for k, v in g.items()},
                                     c_params, l1, l2, clamp)
        upd, c_state = c_opt.update(cg, c_state, c_params)
        c_params = copt.apply_updates(c_params, upd)
        tg = topt.clamp_and_penalize({k: torch.tensor(v) for k, v in
                                      g.items()}, t_params, l1, l2, clamp)
        upd, t_state = t_opt.update(tg, t_state)
        t_params = topt.apply_updates(t_params, upd)
    for k in params:
        np.testing.assert_allclose(t_params[k].numpy(),
                                   np.asarray(c_params[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for field, value in zip(type(t_state)._fields, t_state):
        want = getattr(c_state, field)
        if isinstance(value, dict):
            for k in value:
                np.testing.assert_allclose(value[k].numpy(),
                                           np.asarray(want[k]), rtol=1e-5,
                                           atol=1e-12, err_msg=field)
        else:
            assert int(value) == int(want) == 5


def test_adam_is_torch7s_form_not_torch_optims():
    # one step from zero state on g: torch7 adam moves lr*sqrt(bc2)/bc1 *
    # m/(sqrt(v)+eps); torch.optim.Adam's eps sits on the bias-corrected
    # scale, and the two differ measurably where |g| is near eps
    g = {"w": torch.tensor([1e-8, 1.0])}
    opt = topt.adam()
    upd, state = opt.update(g, opt.init({"w": torch.zeros(2)}))
    bc1, bc2 = 1 - 0.9, 1 - 0.999
    m, v = 0.1 * g["w"], 0.001 * g["w"] ** 2
    want = -1e-3 * np.sqrt(bc2) / bc1 * m / (torch.sqrt(v) + 1e-8)
    torch.testing.assert_close(upd["w"], want)
    p = torch.zeros(2, requires_grad=True)
    ref = torch.optim.Adam([p], lr=1e-3)
    p.grad = g["w"].clone()
    ref.step()
    assert not torch.allclose(upd["w"], p.detach(), rtol=1e-3)
    assert int(state.step) == 1 and state.step.dtype == torch.int32


def test_select_keeps_the_old_state_when_gated():
    opt = topt.adam()
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    upd, new = opt.update({"w": torch.ones(3)}, state)
    kept = topt.select(torch.tensor(False), new, state)
    assert int(kept.step) == 0 and torch.equal(kept.m["w"], state.m["w"])
    taken = topt.select(torch.tensor(True), new, state)
    assert int(taken.step) == 1 and torch.equal(taken.v["w"], new.v["w"])


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make("lbfgs")
