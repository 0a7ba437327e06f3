"""The ladder block of the port's upsample-conv kernel route
(catgen_torch/kernels/fused_upsample_conv.py) against catgen's Pallas
kernels in interpret mode, as in test_torch_port_upsample_kernels.py
(which holds the per-layer form, rows 3 and 5):

  * row 4, ``upsample2_conv_block_fused`` with and without the stats;
  * row 6, the six cotangents of ``upsample2_conv_block`` under
    ``ladder_bwd="pallas"`` (the shape of tests/test_fused_ladder.py).

Sizes are small and odd, k in {3, 5, 7}, scalar and per-channel input
slopes; inputs from numpy seeds. Tolerances, f32 on both sides: y and dx
within 1e-5 of each output's largest value; the stats, dscale, dshift,
dalpha, dW and dbias within 1e-4 of their largest (sums over every
output pixel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen.kernels import pallas_upsample_conv as cpu_conv
from catgen_torch.io.convert import kernel_to_weight
from catgen_torch.kernels import config as tconfig
from catgen_torch.kernels import fused_upsample_conv as fuc

from torch_port_helpers import UPSAMPLE_SHAPES as SHAPES
from torch_port_helpers import (assert_rel_close, catgen_route,  # noqa: F401
                                port_tensors, upsample_inputs)

TIGHT, LOOSE = 1e-5, 1e-4


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_stats", [True, False])
def test_row4_block_matches_catgen(catgen_route, shape, with_stats):
    catgen_route(upsample_impl="pallas")
    n, h, w, cin, cout, k = shape
    v = upsample_inputs(1, n, h, w, cin, cout, k, cin if k == 5 else 1)
    names = ("bias", "scale", "shift", "alpha")
    want = cpu_conv.upsample2_conv_block_fused(
        jnp.asarray(v["x"]), jnp.asarray(v["kern"]),
        *(jnp.asarray(v[a]) for a in names), with_stats=with_stats,
        interpret=True)
    p = port_tensors(v)
    got = fuc.upsample2_conv_block_fused(p["x"], p["kern"],
                                         *(p[a] for a in names),
                                         with_stats=with_stats)
    if not with_stats:
        assert_rel_close(got, want, TIGHT, "y")
        return
    for name, a, b, rel in zip(("y", "s1", "s2"), got, want,
                               (TIGHT, LOOSE, LOOSE)):
        assert_rel_close(a, b, rel, name)


@pytest.mark.parametrize("alpha,shape", [
    ("scalar", SHAPES[0]), ("scalar", SHAPES[2]), ("channelwise", SHAPES[1]),
    ("channelwise", SHAPES[2])])
def test_row6_block_backward_matches_catgen(catgen_route, shape, alpha):
    catgen_route(upsample_impl="pallas", ladder_bwd="pallas")
    n, h, w, cin, cout, k = shape
    v = upsample_inputs(4, n, h, w, cin, cout, k,
                        1 if alpha == "scalar" else cin)
    names = ("x", "scale", "shift", "alpha", "kern", "bias")
    gy, gs1, gs2 = (jnp.asarray(v[a]) for a in ("gy", "gs1", "gs2"))

    def loss(*a):
        y, s1, s2 = cpu_conv.upsample2_conv_block(*a, True)
        return jnp.sum(y * gy) + jnp.sum(s1 * gs1) + jnp.sum(s2 * gs2)

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(v[a]) for a in names))
    p = port_tensors(v)
    leaves = [p[a].requires_grad_() for a in names]
    with tconfig.using(ladder_bwd="pallas"):
        y, s1, s2 = fuc.upsample2_conv_block(*leaves)
        (torch.sum(y * p["gy"]) + torch.sum(s1 * p["gs1"])
         + torch.sum(s2 * p["gs2"])).backward()
    for name, leaf, ref, rel in zip(
            ("dx", "dscale", "dshift", "dalpha", "dkernel", "dbias"),
            leaves, want, (TIGHT,) + (LOOSE,) * 5):
        ref = np.asarray(ref)
        if name == "dkernel":
            ref = kernel_to_weight(ref)
        assert_rel_close(leaf.grad, ref, rel, name)
