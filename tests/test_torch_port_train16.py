"""One 16px train step at full width, G16up (catgen's default G at 16px)
against D32_st3 (the default D at every scale: its stem pools the 16x16
input to 8x8, so its branches sample 8x8x64 images) and against D16_st3
(no pools: branches on 16x16x64), batch 4, with augmentation of the
reals: the port's step against catgen's ``make_train_step`` through
``torch_port_helpers.full_width_step_matches``, at the flagship step's
tolerances (tests/test_torch_port_train_full.py): losses rtol 1e-5,
gradients per leaf within 1e-4 of the leaf's largest, parameters and
BatchNorm statistics after the step atol 1e-4.
"""

import pytest

from torch_port_helpers import full_width_step_matches

IMG16 = (16, 16, 3)


# the flip, then D's dropout masks in the D phase (real and fake halves
# in one batch) and in the G phase: D32_st3 has 7 dropouts, D16_st3 2
@pytest.mark.parametrize("d_name,bernoulli", [("d32_st3", 15),
                                              ("d16_st3", 5)])
def test_16px_step_matches_catgen(d_name, bernoulli):
    full_width_step_matches("g16up", d_name, IMG16, bernoulli=bernoulli)
