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

from catgen_torch.kernels import config
from catgen_torch.nn import spatial_transformer as tst

from torch_port_helpers import IMG, full_width_step_matches


def test_full_width_step_matches_catgen():
    # augmentation (5 uniform, the flip, 1 normal), then the D phase's
    # noise and D's 7 dropout masks, then the G phase's
    full_width_step_matches("g32up_c", "d32_st3", IMG, bernoulli=15)


def test_full_width_step_per_branch_matches_catgen(monkeypatch):
    """The same step with the transformer branches' localization nets run
    one branch at a time (``CATGEN_JOINT_LOC=0``) on both sides, at the
    same weights and tolerances; the default step above runs catgen's
    joint pass, one per D forward, on both sides."""
    from catgen.kernels import config as kconfig
    monkeypatch.setattr(kconfig, "joint_loc", False)
    passes = tst.JOINT_LOC_PASSES
    with config.using(joint_loc=False):
        full_width_step_matches("g32up_c", "d32_st3", IMG, bernoulli=15)
    assert tst.JOINT_LOC_PASSES == passes
