"""The per-layer form of the port's upsample-conv kernel route
(catgen_torch/kernels/fused_upsample_conv.py) against catgen's Pallas
kernels, run as catgen's own tests run them on the CPU (interpret mode).
On the CPU the port runs its plain versions, so this holds the plain
versions, and the wrappers' weight collapse, dCK -> dW chain and
selections, to catgen's rows 3 and 5:

  * row 3, ``upsample2_conv_fused`` with bias and PReLU (scalar and
    per-channel slope);
  * row 5, the backward of ``upsample2_conv_bias`` under the ``pallas``,
    ``hybrid`` and ``naive`` selections of ``upsample_bwd``, and
    ``upsample2_conv_backward`` itself.

The ladder form (rows 4 and 6) is in test_torch_port_ladder_kernels.py.
Sizes are small and odd (H != W; Cin and Cout not multiples of a tile)
with k in {3, 5, 7}. Inputs come from numpy seeds. Tolerances, f32 on
both sides: outputs and dx within 1e-5 of each output's largest value
(sums of at most a few hundred products in another order); dW and dbias
within 1e-4 of their largest (sums over every output pixel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from catgen.kernels import pallas_upsample_conv as cpu_conv
from catgen.kernels import pallas_upsample_conv_bwd as cpu_conv_bwd
from catgen_torch.io.convert import kernel_to_weight
from catgen_torch.kernels import config as tconfig
from catgen_torch.kernels import fused_upsample_conv as fuc

from torch_port_helpers import UPSAMPLE_SHAPES as SHAPES
from torch_port_helpers import (assert_rel_close, catgen_route,  # noqa: F401
                                port_tensors, upsample_inputs)

TIGHT, LOOSE = 1e-5, 1e-4


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", ["scalar", "channelwise"])
def test_row3_forward_matches_catgen(catgen_route, shape, alpha):
    catgen_route(upsample_impl="pallas")
    n, h, w, cin, cout, k = shape
    v = upsample_inputs(0, n, h, w, cin, cout, k,
                        1 if alpha == "scalar" else cout)
    want = cpu_conv.upsample2_conv_fused(
        jnp.asarray(v["x"]), jnp.asarray(v["kern"]), jnp.asarray(v["bias"]),
        jnp.asarray(v["alpha"]), interpret=True)
    p = port_tensors(v)
    got = fuc.upsample2_conv_fused(p["x"], p["kern"], p["bias"], p["alpha"])
    assert_rel_close(got, want, TIGHT, "y")


def _row5_catgen(v):
    x, kern, bias = (jnp.asarray(v[a]) for a in ("x", "kern", "bias"))
    gy = jnp.asarray(v["gy"])
    return jax.grad(lambda *a: jnp.sum(cpu_conv.upsample2_conv_bias(*a) * gy),
                    argnums=(0, 1, 2))(x, kern, bias)


# every shape for the kernels' own selection, fewer for the others (each
# case runs catgen's interpret-mode kernels, which are slow on the CPU)
@pytest.mark.parametrize("impl,shape", [
    ("pallas", SHAPES[0]), ("pallas", SHAPES[1]), ("pallas", SHAPES[2]),
    ("hybrid", SHAPES[0]), ("hybrid", SHAPES[2]), ("naive", SHAPES[1])])
def test_row5_backward_selections_match_catgen(catgen_route, shape, impl):
    catgen_route(upsample_impl="pallas", upsample_bwd=impl)
    n, h, w, cin, cout, k = shape
    v = upsample_inputs(2, n, h, w, cin, cout, k)
    want = _row5_catgen(v)
    p = port_tensors(v)
    x, wt, b = (p[a].requires_grad_() for a in ("x", "kern", "bias"))
    with tconfig.using(upsample_bwd=impl):
        fuc.upsample2_conv_bias(x, wt, b).backward(p["gy"])
    assert_rel_close(x.grad, want[0], TIGHT, "dx")
    assert_rel_close(wt.grad, kernel_to_weight(np.asarray(want[1])), LOOSE,
                     "dweight")
    assert_rel_close(b.grad, want[2], LOOSE, "dbias")


@pytest.mark.parametrize("shape", SHAPES)
def test_row5_backward_function_matches_catgen(catgen_route, shape):
    catgen_route(upsample_impl="pallas")
    n, h, w, cin, cout, k = shape
    v = upsample_inputs(3, n, h, w, cin, cout, k)
    want = cpu_conv_bwd.upsample2_conv_backward(
        jnp.asarray(v["x"]), jnp.asarray(v["kern"]), jnp.asarray(v["gy"]),
        interpret=True)
    p = port_tensors(v)
    dx, dw, db = fuc.upsample2_conv_backward(p["x"], p["kern"], p["gy"])
    assert_rel_close(dx, want[0], TIGHT, "dx")
    assert_rel_close(dw, kernel_to_weight(np.asarray(want[1])), LOOSE,
                     "dweight")
    assert_rel_close(db, want[2], LOOSE, "dbias")


def test_selections_validate():
    with pytest.raises(ValueError, match="upsample_bwd"):
        tconfig.set_upsample_bwd("fast")
    with pytest.raises(KeyError, match="unknown"):
        with tconfig.using(sampler="v4"):
            pass
    with tconfig.using(upsample_impl="pallas", ladder_bwd="pallas"):
        assert tconfig.resolve_upsample_impl() == "pallas"
    assert tconfig.resolve_upsample_impl() == "collapsed"
    assert tconfig.ladder_bwd == "xla_vjp"
