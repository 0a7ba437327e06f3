"""The precision argument of the dCK, dX and forward upsample-conv kernels
(catgen_torch/csrc/upsample_conv_bwd.cu, upsample_conv.cu), on the CPU:
the kernels compute their f32 products on the tensor cores as 3xTF32
(each f32 operand split into a TF32 hi and lo, lo·hi + hi·lo + hi·hi
summed in f32), which TF32 rounding emulated in numpy reproduces
(torch_port_helpers.tf32_round).

  * at G32up-c's last stage widths (Cin 256, Cout 128) over 4096 pixels,
    3xTF32 is within 1e-5 of the largest value of the float64 product,
    and one TF32 product is not within 1e-4 (the tolerance of dW);
  * the emulated 3xTF32 dCK of small stages, chained to dW by the port's
    ``dweight_from_dck``, matches catgen's ``upsample2_conv_backward``
    (its Pallas kernels in interpret mode) within 1e-4 of dW's largest
    value, the tolerance of test_torch_port_upsample_kernels.py;
  * the emulated 3xTF32 forward of a small stage with the input transform
    (shift 4, so a halo of prelu(shift) would show), split once per
    element after the transform and the zero halo, with fresh sums per
    32-deep step added in f32 as the kernel does, is within 1e-6 of the
    largest value of its float64 counterpart, and one TF32 product per
    f32 product is not within 1e-4; the float64 forward is the port's
    plain version within 1e-5;
  * the emulated 3xTF32 dX of a small stage of each form (row 5: the
    conv's dx; row 6: the cotangent folded with the stats cotangents,
    then the transform's backward), each element of g split once after
    the fold and the zero halo, with fresh sums per 32-deep (parity, tap,
    32 output channels) step added in f32 as the kernel does, is within
    1e-6 of the largest value of its float64 counterpart, and one TF32
    product per f32 product is not within 1e-4; the float64 dX is the
    port's plain version within 1e-5, and the emulated dx matches
    catgen's ``upsample2_conv_backward`` / ``fused_block_backward``
    (Pallas, interpret mode) within 1e-5 of its largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen.kernels import pallas_upsample_conv_bwd as cpu_conv_bwd
from catgen_torch.io.convert import kernel_to_weight
from catgen_torch.kernels import fused_upsample_conv as fuc
from catgen_torch.kernels.upsample_conv import _collapse_matrix

from torch_port_helpers import UPSAMPLE_SHAPES as SHAPES
from torch_port_helpers import (assert_rel_close, matmul_3xtf32, matmul_tf32,
                                port_tensors, tf32_round, upsample_inputs)

LOOSE = 1e-4


@pytest.mark.parametrize("value, want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),        # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                      # below half: down
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),     # above half: up
    (3.0, 3.0)])
def test_tf32_round_is_nearest_ties_away(value, want):
    assert tf32_round(np.float32(value)) == np.float32(want)


def _stage3_operands(seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(4096, 256).astype(np.float32),
            r.randn(4096, 128).astype(np.float32))


@pytest.mark.parametrize("form, rel, within", [
    ("3xtf32", 1e-5, True), ("tf32", 1e-4, False)])
def test_split_product_accuracy(form, rel, within):
    x, g = _stage3_operands()
    exact = (torch.from_numpy(x).double().T
             @ torch.from_numpy(g).double()).numpy()
    got = matmul_3xtf32(x, g) if form == "3xtf32" else matmul_tf32(x, g)
    err = np.abs(got - exact).max() / np.abs(exact).max()
    assert (err <= rel) == within, err


def _dck_3xtf32(x, g, k):
    """dCK (4, kp, kp, Cin, Cout) of x (n, h, w, Cin) against g (n, 2h,
    2w, Cout) as the kernel computes it: per parity and tap, the shifted
    image (0 outside) against the parity plane of g, in 3xTF32."""
    n, h, w, cin = x.shape
    cout = g.shape[-1]
    kp = _collapse_matrix(k, 0)[0].shape[0]
    umin = fuc._umins(k, k)
    pad = 2 * kp
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    dck = np.zeros((4, kp, kp, cin, cout), np.float32)
    for p in range(4):
        d, e = divmod(p, 2)
        plane = g[:, d::2, e::2].reshape(-1, cout)
        for u in range(kp):
            for v in range(kp):
                i0, j0 = pad + umin[d] + u, pad + umin[2 + e] + v
                xs = xp[:, i0:i0 + h, j0:j0 + w].reshape(-1, cin)
                dck[p, u, v] = matmul_3xtf32(xs, plane)
    return dck


@pytest.mark.parametrize("shape", SHAPES[:1])
def test_emulated_dck_matches_catgen(shape):
    n, h, w, cin, cout, k = shape
    v = upsample_inputs(3, n, h, w, cin, cout, k)
    want = cpu_conv_bwd.upsample2_conv_backward(
        jnp.asarray(v["x"]), jnp.asarray(v["kern"]), jnp.asarray(v["gy"]),
        interpret=True)[1]
    dck = _dck_3xtf32(v["x"], v["gy"], k)
    dw = fuc.dweight_from_dck(torch.tensor(dck), k, k)
    assert_rel_close(dw, kernel_to_weight(np.asarray(want)), LOOSE,
                     "dweight")


FWD_SHAPES = [(2, 4, 4, 64, 32, 3), (2, 4, 4, 64, 32, 5)]
STEP = 32       # the forward kernel's contraction per stage


def _forward_by_steps(xn, wst, k, product):
    """The four parity planes (4, n, h, w, Cout) of the collapsed parity
    convs of xn (n, h, w, Cin; 0 outside the image) with the parity stack
    wst (4, kp, kp, Cin, Cout), as the kernel sums them: per tap and
    32-channel step, ``product`` of the step's operands, the steps added
    in the operands' dtype."""
    n, h, w, cin = xn.shape
    kp = wst.shape[1]
    umin = fuc._umins(k, k)
    pad = 2 * kp
    xp = np.pad(xn, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    out = np.zeros((4, n * h * w, wst.shape[-1]), xn.dtype)
    for p in range(4):
        d, e = divmod(p, 2)
        for u in range(kp):
            for v in range(kp):
                i0, j0 = pad + umin[d] + u, pad + umin[2 + e] + v
                xs = xp[:, i0:i0 + h, j0:j0 + w].reshape(-1, cin)
                for c0 in range(0, cin, STEP):
                    out[p] += product(xs[:, c0:c0 + STEP].T,
                                      wst[p, u, v, c0:c0 + STEP])
    return out.reshape(4, n, h, w, -1)


@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_emulated_forward_is_f32_accurate(shape):
    n, h, w, cin, cout, k = shape
    t = port_tensors(upsample_inputs(4, n, h, w, cin, cout, k, alpha_n=cin))
    t["shift"] = torch.full_like(t["shift"], 4.0)
    xn = fuc.in_transform(t["x"], t["scale"], t["shift"], t["alpha"])
    wst = fuc.parity_stack(t["kern"])
    xn32, wst32 = xn.numpy(), wst.numpy()
    exact = _forward_by_steps(xn32.astype(np.float64),
                              wst32.astype(np.float64), k,
                              lambda a, b: a.T @ b)
    # the float64 planes, interleaved, are the port's plain block
    plain = fuc.block_plain(t["x"], t["kern"], None, t["scale"], t["shift"],
                            t["alpha"]).numpy()
    planes = plain.reshape(n, h, 2, w, 2, cout).transpose(2, 4, 0, 1, 3, 5)
    assert_rel_close(planes.reshape(exact.shape), exact, 1e-5, "plain")
    top = np.abs(exact).max()
    three = _forward_by_steps(xn32, wst32, k, matmul_3xtf32)
    one = _forward_by_steps(xn32, wst32, k, matmul_tf32)
    assert np.abs(three - exact).max() <= 1e-6 * top
    assert np.abs(one - exact).max() > 1e-4 * top


DX_SHAPE = (2, 4, 4, 48, 64, 3)    # (n, h, w, Cin, Cout, k)


def _dx_by_steps(g, wst, k, product):
    """dx (n, h, w, Cin) of the collapsed parity convs with the parity
    stack wst (4, kp, kp, Cin, Cout), for the cotangent g (n, 2h, 2w,
    Cout; 0 outside the image), as the dX kernel sums it: per parity, tap
    and 32-channel step of Cout, ``product`` of the step's operands (g at
    the source pixels, the stack's slice), the steps added in the
    operands' dtype."""
    n, h2, w2, cout = g.shape
    h, w = h2 // 2, w2 // 2
    kp = wst.shape[1]
    umin = fuc._umins(k, k)
    pad = 2 * kp
    out = np.zeros((n * h * w, wst.shape[3]), g.dtype)
    for p in range(4):
        d, e = divmod(p, 2)
        plane = np.pad(g[:, d::2, e::2],
                       ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        for u in range(kp):
            for v in range(kp):
                i0, j0 = pad - umin[d] - u, pad - umin[2 + e] - v
                gs = plane[:, i0:i0 + h, j0:j0 + w].reshape(-1, cout)
                for c0 in range(0, cout, STEP):
                    out += product(gs[:, c0:c0 + STEP].T,
                                   wst[p, u, v, :, c0:c0 + STEP].T)
    return out.reshape(n, h, w, -1)


def _transform_bwd(dxn, x, scale, shift, alpha):
    """The input transform's backward on dxn, in f32 as the kernel's
    epilogue computes it."""
    xt = x * scale + shift
    return np.where(xt >= 0, dxn, dxn * alpha) * scale


@pytest.mark.parametrize("form", ["conv", "block"])
def test_emulated_dx_is_f32_accurate(form):
    n, h, w, cin, cout, k = DX_SHAPE
    v = upsample_inputs(5, n, h, w, cin, cout, k, alpha_n=cin)
    t = port_tensors(v)
    block = form == "block"
    y = fuc.block_plain(t["x"], t["kern"], t["bias"], t["scale"],
                        t["shift"], t["alpha"])
    if block:       # (gy + gs1) + (2 y) gs2, the kernel's order
        g = t["gy"] + t["gs1"] + 2.0 * y * t["gs2"]
        g64 = (t["gy"].double() + t["gs1"].double()
               + 2.0 * y.double() * t["gs2"].double())
    else:
        g, g64 = t["gy"], t["gy"].double()
    wst = fuc.parity_stack(t["kern"]).numpy()
    exact = _dx_by_steps(g64.numpy(), wst.astype(np.float64), k,
                         lambda a, b: a.T @ b)
    # the float64 sum is the port's plain dx (autograd of the conv)
    plain = fuc.upsample2_conv_backward_plain(t["x"], t["kern"], g)[0]
    assert_rel_close(plain, exact, 1e-5, "plain")
    three = _dx_by_steps(g.numpy(), wst, k, matmul_3xtf32)
    one = _dx_by_steps(g.numpy(), wst, k, matmul_tf32)
    if block:
        args = [v[a] for a in ("x", "scale", "shift", "alpha")]
        exact = _transform_bwd(exact, *(a.astype(np.float64) for a in args))
        three, one = (_transform_bwd(a, *args) for a in (three, one))
    top = np.abs(exact).max()
    assert np.abs(three - exact).max() <= 1e-6 * top
    assert np.abs(one - exact).max() > 1e-4 * top
    # catgen's dX (Pallas, interpret mode)
    j = {a: jnp.asarray(b) for a, b in v.items()}
    if block:
        want = cpu_conv_bwd.fused_block_backward(
            j["x"], j["scale"], j["shift"], j["alpha"], j["kern"],
            jnp.asarray(y.numpy()), j["gy"], j["gs1"], j["gs2"],
            interpret=True)[0]
    else:
        want = cpu_conv_bwd.upsample2_conv_backward(
            j["x"], j["kern"], j["gy"], interpret=True)[0]
    assert_rel_close(three, np.asarray(want), 1e-5, "dx")
