"""The bf16 block backward with one fold, on the CPU, against catgen: on the
card the bf16 ladder block's backward folds its cotangent once
(``block_fold_pass``, plain version ``block_fold``) and hands the folded
gf to both kernels, as catgen's ``_fused_block_bwd_kernel`` folds g once
for dX and dCK; the bf16 dX kernel then computes dx of the parity convs on
gf and the transform's backward (plain version ``block_grads_plain``).
Here that composition, built from the fold, the parity convs' f32
gradient and the transform's backward written out, gives the bits of the
block's plain version (``block_backward_plain``), which
``fused_block_backward`` runs on CPU tensors without a launch, and agrees
with catgen's ``fused_block_backward`` in interpret mode at
tests/test_torch_port_kernel_routes_bf16.py's tolerances: bf16 values
within 1 unit at catgen's value plus 2^-16 of the largest, f32 sums within
1e-4 of the largest. Inputs are numpy arrays from seeds, rounded to bf16
and handed to both sides; two ladder stages at narrow widths, the second
with Cin and Cout off the 16-byte vector of 8 bf16.
"""

import numpy as np
import pytest
import torch

from catgen_torch.io.convert import kernel_to_weight
from catgen_torch.kernels import fused_upsample_conv as fuc

from test_torch_port_bf16 import f32
from test_torch_port_kernel_routes_bf16 import (C_BLOCK, C_BLOCK_BACKWARD,
                                                _close, _inputs)

# (n, h, w, cin, cout, k): a k3 stage, then a k5 stage with Cin and Cout
# not multiples of 8
STAGES = [(2, 4, 4, 16, 8, 3), (2, 6, 5, 12, 10, 5)]
TRANSFORM = ("scale", "shift", "alpha")
NAMES = ("dx", "dscale", "dshift", "dalpha", "dweight", "dbias")


def _composition(x, scale, shift, alpha, kern, y, gy, gs1, gs2):
    """The block backward as the card runs it in bf16, written out: the
    fold once (gf rounded to bf16, dbias its f32 sum), the transform
    recomputed in f32 and rounded, the parity convs' f32 gradients on gf
    (dx of the conv and dCK -> dW), the transform's backward in f32 and dx
    rounded once."""
    gf, dbias = fuc.block_fold(y, gy, gs1, gs2)
    sc, sh = scale.float(), shift.float()
    al = alpha.float().reshape(-1).expand(x.shape[-1])
    xt = x.float() * sc + sh
    pos = xt >= 0
    xn = torch.where(pos, xt, al * xt).bfloat16()
    dxn = fuc._kernel_vjp(xn, kern, gf)[0]
    dweight = fuc.kernel_backward_plain(xn, kern, gf, need_x=False)[1]
    dxt = torch.where(pos, dxn, dxn * al)
    dims = (0, 1, 2)
    return ((dxt * sc).bfloat16(), (dxt * x.float()).sum(dims),
            dxt.sum(dims), torch.where(pos, 0.0, dxn * xt).sum(dims),
            dweight, dbias)


@pytest.mark.parametrize("shape, alpha", [(STAGES[0], "scalar"),
                                          (STAGES[1], "channelwise")])
def test_one_fold_for_both_kernels_is_the_block_backward(shape, alpha):
    c, t = _inputs(40, shape, 1 if alpha == "scalar" else shape[3])
    y = C_BLOCK(c["x"], c["kern"], c["bias"], *(c[a] for a in TRANSFORM),
                with_stats=False, interpret=True)
    ty = torch.tensor(f32(y)).bfloat16()
    args = (t["x"], *(t[a] for a in TRANSFORM), t["kern"], ty, t["gy"],
            t["gs1"], t["gs2"])
    fuc.reset_launches()
    got = fuc.fused_block_backward(*args)
    assert sum(fuc.launches().values()) == 0     # CPU: the plain versions
    plain = fuc.block_backward_plain(*args)
    written = _composition(*args)
    gf = fuc.block_fold(ty, t["gy"], t["gs1"], t["gs2"])[0]
    helper = fuc.block_grads_plain(t["x"], *(t[a] for a in TRANSFORM),
                                   t["kern"], gf)
    for name, a, p, w in zip(NAMES, got, plain, written):
        assert a.dtype == p.dtype == w.dtype, name
        assert torch.equal(a, p), name
        assert torch.equal(w, p), name
    for name, h, p in zip(NAMES, helper, plain):
        assert torch.equal(h, p), name
    # catgen's transform constants as f32 arrays of their bf16 values, as
    # test_torch_port_kernel_routes_bf16 hands them
    tr = [c[a].astype(np.float32) for a in TRANSFORM]
    want = C_BLOCK_BACKWARD(c["x"], *tr, c["kern"], y, c["gy"], c["gs1"],
                            c["gs2"], interpret=True)
    for name, a, b in zip(NAMES, got, want):
        if name == "dweight":
            b = kernel_to_weight(f32(b))
        _close(a, b, name)
    assert got[0].dtype == got[4].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in (*got[1:4], got[5]))


def test_the_dx_kernels_plain_version_reads_the_folded_cotangent():
    # the dX kernel's plain version on gf, not on the unfolded gy: the
    # stats cotangents move dx, dscale, dshift and dalpha, and a zero
    # fold gives the per-layer dX through the transform
    _, t = _inputs(41, STAGES[1], STAGES[1][3])
    tr = [t[a] for a in TRANSFORM]
    ty = t["gy"].flip(0)                # any bf16 output of the stage
    gf = fuc.block_fold(ty, t["gy"], t["gs1"], t["gs2"])[0]
    on_gf = fuc.block_grads_plain(t["x"], *tr, t["kern"], gf)
    on_gy = fuc.block_grads_plain(t["x"], *tr, t["kern"], t["gy"])
    assert not any(torch.equal(a, b) for a, b in zip(on_gf[:4], on_gy[:4]))
    zero = torch.zeros_like(t["gs1"])
    unfolded = fuc.block_backward_plain(t["x"], *tr, t["kern"], ty, t["gy"],
                                        zero, zero)
    assert all(torch.equal(a, b) for a, b in zip(on_gy, unfolded))
