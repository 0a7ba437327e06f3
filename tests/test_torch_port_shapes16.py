"""The kernels' plain versions at the shapes the 16px models and G32up give
them, against catgen's CPU path, at small N:

  * the upsample-conv block (row 4: y and the BatchNorm sums) and its
    backward (row 6) at G16up's first stage, a k5 conv from a 4x4 image
    at Cin = 128, against catgen's Pallas kernels in interpret mode;
  * the sampler at D32_st3's branch shape at 16px, three 8x8x64 images
    stacked to 24x8, forward and backward, against catgen's XLA sampler;
  * G16up, G32up and G32up-b on the kernel route's ladder (on the CPU, the
    kernels' plain versions) against catgen's Pallas ladder in interpret
    mode: images within 1e-5 and the BatchNorm statistics after a train
    forward within 1e-5 of each buffer's largest, which holds only if both
    ladders see the same stage boundaries (G16up and G32up have the PReLU
    after the seed's Reshape, G32up-b a BatchNorm on the dense output).

Tolerances as in tests/test_torch_port_ladder_kernels.py and
tests/test_torch_port_bilinear.py: y and dx within 1e-5 of the largest
value, the sums over every output pixel within 1e-4; the sampler within
1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen.kernels import pallas_upsample_conv as cpu_conv
from catgen.nn.spatial_transformer import bilinear_sample as jax_sample
from catgen_torch.io.convert import catgen_to_state_dict, kernel_to_weight
from catgen_torch.kernels import bilinear
from catgen_torch.kernels import config as tconfig
from catgen_torch.kernels import fused_upsample_conv as fuc
from catgen_torch.nn.fused import FusedDecoderSequential

from torch_port_helpers import (LADDER, assert_rel_close,  # noqa: F401
                                build_pair, catgen_route, np_tree,
                                port_tensors, upsample_inputs)

TIGHT, LOOSE = 1e-5, 1e-4
G16UP_STAGE1 = (2, 4, 4, 128, 256, 5)      # (n, h, w, cin, cout, k)
BRANCH16 = (2, 8, 8, 64, 24, 8)            # (n, h, w, c, ho, wo)


def test_g16up_stage_block_matches_catgen(catgen_route):
    catgen_route(upsample_impl="pallas")
    n, h, w, cin, cout, k = G16UP_STAGE1
    v = upsample_inputs(10, n, h, w, cin, cout, k, cin)
    names = ("bias", "scale", "shift", "alpha")
    want = cpu_conv.upsample2_conv_block_fused(
        jnp.asarray(v["x"]), jnp.asarray(v["kern"]),
        *(jnp.asarray(v[a]) for a in names), with_stats=True,
        interpret=True)
    p = port_tensors(v)
    got = fuc.upsample2_conv_block_fused(p["x"], p["kern"],
                                         *(p[a] for a in names))
    assert got[0].shape == (n, 2 * h, 2 * w, cout)
    for name, a, b, rel in zip(("y", "s1", "s2"), got, want,
                               (TIGHT, LOOSE, LOOSE)):
        assert_rel_close(a, b, rel, name)


def test_g16up_stage_block_backward_matches_catgen(catgen_route):
    catgen_route(upsample_impl="pallas", fused_ladder=True,
                 ladder_bwd="pallas")
    n, h, w, cin, cout, k = G16UP_STAGE1
    v = upsample_inputs(11, n, h, w, cin, cout, k)
    names = ("x", "scale", "shift", "alpha", "kern", "bias")

    def loss(*args):
        y, s1, s2 = cpu_conv.upsample2_conv_block(*args, True)
        return (jnp.sum(y * jnp.asarray(v["gy"]))
                + jnp.sum(s1 * jnp.asarray(v["gs1"]))
                + jnp.sum(s2 * jnp.asarray(v["gs2"])))

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(v[a]) for a in names))
    p = {a: t.requires_grad_() for a, t in port_tensors(v).items()
         if a in names}
    with tconfig.using(ladder_bwd="pallas"):
        y, s1, s2 = fuc.upsample2_conv_block(*(p[a] for a in names))
        torch.autograd.backward(
            (y, s1, s2), (torch.tensor(v["gy"]), torch.tensor(v["gs1"]),
                          torch.tensor(v["gs2"])))
    for a, ref in zip(names, want):
        ref = np.asarray(ref)
        if a == "kern":
            ref = kernel_to_weight(ref)
        assert_rel_close(p[a].grad, ref, TIGHT if a == "x" else LOOSE, a)


def test_branch_sampler_at_16px_matches_catgen():
    n, h, w, c, ho, wo = BRANCH16
    rng = np.random.RandomState(12)
    img = rng.rand(n, h, w, c).astype(np.float32)
    rows = rng.uniform(-1.2, 1.2, (n, 2, ho * wo)).astype(np.float32)
    g = rng.uniform(-1, 1, (n, ho, wo, c)).astype(np.float32)
    grid = rows.transpose(0, 2, 1).reshape(n, ho, wo, 2)
    out, vjp = jax.vjp(jax_sample, jnp.asarray(img), jnp.asarray(grid))
    want_img, want_grid = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    ti = torch.tensor(img, requires_grad=True)
    tr = torch.tensor(rows, requires_grad=True)
    got = bilinear.bilinear_sample_rows(ti, tr, (ho, wo))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-5)
    got.backward(torch.tensor(g))
    np.testing.assert_allclose(ti.grad.numpy(), want_img, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tr.grad.numpy(), want_grid.reshape(n, ho * wo, 2).transpose(0, 2, 1),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["g16up", "g32up", "g32up_b"])
def test_ladder_generator_matches_catgen(catgen_route, name):
    catgen_route(**LADDER)
    cm, variables, tm, x_shape = build_pair("G", name, seed=3)
    assert isinstance(tm, FusedDecoderSequential)
    z = np.random.RandomState(4).uniform(-1, 1, (4,) + x_shape).astype(
        np.float32)
    want, new_state = cm.apply(variables, jnp.asarray(z), train=True,
                               rng=jax.random.PRNGKey(1))
    with tconfig.using(**LADDER), torch.no_grad():
        got = tm.train()(torch.tensor(z))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        for k, v in catgen_to_state_dict({}, np_tree(new_state)).items():
            buf = tm.state_dict()[k].numpy()
            bound = 1e-5 * max(float(np.abs(v.numpy()).max()), 1e-6)
            assert np.abs(buf - v.numpy()).max() <= bound, k
        moved = {"params": variables["params"], "state": new_state}
        want = cm.apply(moved, jnp.asarray(z), train=False)[0]
        got = tm.eval()(torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
