"""The port's G32up-c and D32_st3 at full width against catgen's: eval
forward at batch 2 on the CPU, with catgen's weights carried over by
catgen_torch.io.convert (perturbed ST heads and BN statistics, see
torch_port_helpers). catgen runs its CPU path, which is the plain
reference of every kernel: XLA gathers for the sampler, collapsed parity
convs for the decoder.

Tolerance: both sides compute in f32 with the same formulas; only the
summation order of the convolutions and matmuls differs (~1e-7 relative),
so images in [0, 1] and sigmoid scores agree to 1e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import IMG, NOISE_DIM, catgen_pair, port_pair

ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    g, d, gv, dv = catgen_pair(seed=0)
    rng = np.random.RandomState(1)
    noise = rng.uniform(-1.0, 1.0, (2, NOISE_DIM)).astype(np.float32)
    reals = rng.rand(2, *IMG).astype(np.float32)
    images = np.asarray(g.apply(gv, jnp.asarray(noise), train=False)[0])
    d_in = np.concatenate([images[:1], reals[:1]])
    scores = np.asarray(d.apply(dv, jnp.asarray(d_in), train=False)[0])
    tg, td = port_pair(gv, dv)
    return {"gv": gv, "dv": dv, "noise": noise, "images": images,
            "d_in": d_in, "scores": scores, "tg": tg, "td": td}


def test_g32up_c_eval_matches_catgen(pair):
    with torch.inference_mode():
        got = pair["tg"](torch.tensor(pair["noise"])).numpy()
    assert got.shape == (2,) + IMG
    assert float(pair["images"].std()) > 0.05    # not a flat image
    np.testing.assert_allclose(got, pair["images"], rtol=0, atol=ATOL)


def test_d32_st3_eval_matches_catgen(pair):
    with torch.inference_mode():
        got = pair["td"](torch.tensor(pair["d_in"])).numpy()
    assert got.shape == (2, 1)
    assert abs(float(pair["scores"][0, 0] - pair["scores"][1, 0])) > 1e-3
    np.testing.assert_allclose(got, pair["scores"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("which", ["g", "d"])
def test_state_dict_matches_catgen_leaves(pair, which):
    """Every port weight has a catgen leaf and vice versa (strict load),
    and D's sampler-fed layers sit at catgen's paths."""
    module = pair["t" + which]
    keys = set(module.state_dict())
    if which == "d":
        assert "05_FusedSTBranches.loc0.01_Conv.weight" in keys
        assert "00_FusedSTConvPReLU.st.head.weight" in keys
        w = module.state_dict()["08_Dense.weight"].numpy()
        np.testing.assert_array_equal(
            w, pair["dv"]["params"]["08_Dense"]["kernel"].T)
    else:
        assert "04_BatchNorm.mean" in keys
        np.testing.assert_array_equal(
            module.state_dict()["04_BatchNorm.var"].numpy(),
            pair["gv"]["state"]["04_BatchNorm"]["var"])
