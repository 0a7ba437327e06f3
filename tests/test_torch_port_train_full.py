"""One train step of the flagship pair at full width, G32up-c against
D32_st3 (32x32x3, noise 100), batch 4, with augmentation of the reals: the
port's step against catgen's ``make_train_step``, from catgen's initial
state converted. catgen runs eagerly; its noise, augmentation draws and
dropout masks are recorded and handed to the port in order, and both
sides' raw gradients are captured before the optimizer.

The transformer heads start off the identity (``perturb``), so no sample
of the four transformers lies exactly on an image edge, where catgen's CPU
sampler (XLA, ``jnp.clip``) and the port (v4's convention) differ by
design.

Tolerances, f32 with TF32 off (the CPU has none): losses, acc_d and
acc_avg rtol 1e-5; confusion counts and the gate's decision exact;
gradients per leaf within 1e-4 of the leaf's largest (plus 1e-6 of the
update's largest, for leaves whose gradient is rounding noise, such as
the upsample-conv biases in front of BatchNorm); parameters after the step
and G's BatchNorm statistics atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from catgen import models as cmodels
from catgen import optim as copt
from catgen.train import gan as cgan
from catgen_torch import models as tmodels
from catgen_torch import optim as topt
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.train import gan as tgan

from torch_port_helpers import (IMG, NOISE_DIM, ReplayDraws,
                                assert_grads_close, capture_grads,
                                catgen_grads_to_port, np_tree, perturb,
                                port_grads_to_numpy, record_jax_draws)

BATCH = 4
ATOL = 1e-4
# Weight gains where both gradients are well conditioned in f32. At D gain
# 1, D's output barely depends on its input and the input gradient that
# reaches G is a small remainder of cancelling paths (1e-3 relative
# differences between two correct f32 implementations); at G gain 2 and
# above, G's output sigmoid saturates and its gradient loses digits the
# same way; at D gain 4, Adam's first step (+-lr wherever |g| >> 3e-7)
# turns gradient rounding into 2*lr parameter differences.
G_GAIN, D_GAIN = 1.0, 2.0


def test_full_width_step_matches_catgen():
    config = dict(batch_size=BATCH, noise_dim=NOISE_DIM, augment=True)
    c_config = cgan.GanConfig(bce="logits", **config)
    t_config = tgan.GanConfig(bce="logits", **config)
    cg = cmodels.create_G_decoder_upsampling32c(IMG, NOISE_DIM)
    cd = cmodels.create_D32_st3(IMG)
    state = cgan.init_state(cg, cd, c_config, jax.random.PRNGKey(0), IMG)
    gv = np_tree({"params": state.g_params, "state": state.g_state})
    dv = np_tree({"params": state.d_params, "state": state.d_state})
    rng = np.random.RandomState(0)
    perturb(gv, rng, gain=G_GAIN)
    perturb(dv, rng, gain=D_GAIN)
    state = state._replace(g_params=gv["params"], g_state=gv["state"],
                           d_params=dv["params"], d_state=dv["state"])

    tg = tmodels.create_G_decoder_upsampling32c(IMG, NOISE_DIM)
    td = tmodels.create_D32_st3(IMG)
    tg.load_state_dict(catgen_to_state_dict(gv["params"], gv["state"]))
    td.load_state_dict(catgen_to_state_dict(dv["params"], dv["state"]))
    t_state = tgan.init_state(tg, td, t_config)

    reals = np.random.RandomState(1).rand(BATCH // 2, *IMG).astype(
        np.float32)
    c_grads, t_grads = [], []
    with record_jax_draws() as draws, \
            capture_grads(copt, c_grads, catgen_grads_to_port):
        new, cm = cgan.make_train_step(cg, cd, c_config)(
            state, jnp.asarray(reals), jax.random.PRNGKey(2))
    kinds = [k for k, _ in draws]
    # augmentation (5 uniform, the flip, 1 normal), then the D phase's
    # noise and D's 7 dropout masks, then the G phase's
    assert kinds.count("normal") == 1 and kinds.count("bernoulli") == 15
    replay = ReplayDraws(draws)
    with capture_grads(topt, t_grads, port_grads_to_numpy):
        tm = tgan.make_train_step(tg, td, t_config)(
            t_state, torch.tensor(reals), replay)
    assert not replay.records

    for name in ("loss_d", "loss_g", "acc_d", "acc_avg"):
        np.testing.assert_allclose(float(getattr(tm, name)),
                                   float(getattr(cm, name)), rtol=1e-5,
                                   err_msg=name)
    for name in ("d_trained", "tp_real", "tn_fake", "fp", "fn"):
        assert float(getattr(tm, name)) == float(getattr(cm, name)), name

    assert len(c_grads) == len(t_grads) == 2          # D, then G
    for got, want in zip(t_grads, c_grads):
        assert_grads_close(got, want)

    for module, params, st in ((tg, new.g_params, new.g_state),
                               (td, new.d_params, new.d_state)):
        want = catgen_to_state_dict(np_tree(params), np_tree(st))
        got = module.state_dict()
        assert set(got) == set(want)
        for k in want:     # parameters and G's BN running statistics
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=ATOL, err_msg=k)
    assert t_state.step == int(new.step) == 1
    assert int(t_state.d_opt.step) == int(new.d_opt.step) == 1
