"""Every model of the port's registries at full width against catgen's,
and the four layers catgen has beside them (Tanh, UpsampleNearest,
SubPixelConv, UnPooling), on the CPU.

Each registry model is built at catgen's scale for it (catgen's
tests/test_models.py: a G at 16px where its name says 16, 64px where it
says 64, else 32px; a D or V at 16px where its name says 16, 64px for
d64, else 32px), from catgen's weights carried over by
catgen_torch.io.convert with a strict load, the kernels scaled by
``WEIGHT_GAIN`` and the ST heads and BatchNorm statistics perturbed
(torch_port_helpers.perturb), so that images and scores vary. Its eval
forward at batch 2 must match catgen's within 1e-5 absolute (sums of
another order in f32), and its parameter count equal catgen's.

The new generators on the kernel route's ladder are in
tests/test_torch_port_shapes16.py.

The new layers: within 1e-6 on random inputs; SubPixelConv's weights go
through the converter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen import models as cmodels
from catgen import nn as cnn
from catgen.core.module import param_count
from catgen_torch import models as tmodels
from catgen_torch import nn as tnn
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.nn.fused import FusedDecoderSequential

from torch_port_helpers import NOISE_DIM, build_pair, np_tree

ATOL = 1e-5
CASES = ([("G", k) for k in sorted(cmodels.G_REGISTRY)]
         + [("D", k) for k in sorted(cmodels.D_REGISTRY)]
         + [("V", k) for k in sorted(cmodels.V_REGISTRY)])


def _input(x_shape, n=2, seed=1):
    x = np.random.RandomState(seed).rand(n, *x_shape).astype(np.float32)
    return x * 2.0 - 1.0 if x_shape == (NOISE_DIM,) else x


@pytest.mark.parametrize("kind,name", CASES)
def test_registry_model_matches_catgen(kind, name):
    cm, variables, tm, x_shape = build_pair(kind, name)
    x = _input(x_shape)
    want = np.asarray(jax.jit(lambda v, a: cm.apply(v, a, train=False)[0])(
        variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = tm.eval()(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    assert np.ptp(want) > 1e-4, "a flat output tests nothing"
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert sum(p.numel() for p in tm.parameters()) == param_count(
        variables["params"])


def test_every_model_builds_where_catgen_builds():
    """The Ds and Vs of either scale build at the other too (their widths
    come from the image shape), and the Gs refuse a size they cannot
    make, as catgen's assert does."""
    for name in tmodels.D_REGISTRY:
        if name != "d64":
            for img in ((16, 16, 3), (32, 32, 3)):
                y = tmodels.D_REGISTRY[name](img).eval()(torch.rand(1, *img))
                assert y.shape == (1, 1), (name, img)
    for img in ((16, 16, 3), (32, 32, 1)):
        assert tmodels.create_V(img).eval()(torch.rand(1, *img)).shape == (
            1, 2)
    for name, size in (("g16up", 32), ("g32up", 16), ("g32up_b", 16),
                       ("g32up_c", 16)):
        with pytest.raises(ValueError, match="makes"):
            tmodels.G_REGISTRY[name]((size, size, 3), NOISE_DIM)
    assert isinstance(tmodels.create_G((16, 16, 3), NOISE_DIM),
                      FusedDecoderSequential)


# ---------------------------------------------------------------------------
# the four layers catgen has beside the models
# ---------------------------------------------------------------------------

LAYERS = {
    "Tanh": (cnn.Tanh, tnn.Tanh),
    "UpsampleNearest": (lambda: cnn.UpsampleNearest(3),
                        lambda: tnn.UpsampleNearest(3)),
    "UnPooling": (lambda: cnn.UnPooling(2), lambda: tnn.UnPooling(2)),
    "SubPixelConv": (lambda: cnn.SubPixelConv(5, 2, (3, 3)),
                     lambda: tnn.SubPixelConv(4, 5, 2, (3, 3))),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_new_layer_matches_catgen(name):
    make_c, make_t = LAYERS[name]
    x = np.random.RandomState(5).randn(2, 3, 5, 4).astype(np.float32)
    cl, tl = make_c(), make_t()
    variables = np_tree(cl.init(jax.random.PRNGKey(6), x.shape))
    if variables.get("params"):
        variables["params"]["kernel"] = np.random.RandomState(7).randn(
            *variables["params"]["kernel"].shape).astype(np.float32)
        variables["params"]["bias"] = np.random.RandomState(8).randn(
            *variables["params"]["bias"].shape).astype(np.float32)
        tl.load_state_dict(catgen_to_state_dict(variables["params"], {}),
                           strict=True)
    want = np.asarray(cl.apply(variables, jnp.asarray(x))[0])
    with torch.no_grad():
        got = tl(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
