"""The bf16 ladder block as passes and per-layer kernels, on the CPU,
against catgen: on the card the bf16 block runs its input transform
(``block_input_pass``, plain version ``block_input``) and its cotangent
fold with dbias (``block_fold_pass``, plain version ``block_fold``) once
per element, and then row 3's forward and row 5's dCK on their outputs as
they lie (``kernels/fused_upsample_conv.py``). Here the passes' plain
versions, followed by the per-layer plain forward and dCK, give the bits
of the block's own plain versions (``block_plain``,
``block_backward_plain``), and agree with catgen's
``upsample2_conv_block_fused`` and ``fused_block_backward`` in interpret
mode at tests/test_torch_port_kernel_routes_bf16.py's tolerances: bf16
values within 1 unit at catgen's value plus 2^-16 of the largest, f32
sums within 1e-4 of the largest. Inputs are numpy arrays from seeds,
rounded to bf16 and handed to both sides; two ladder stages at narrow
widths, the second with Cin off the 16-byte vector of 8 bf16.
"""

import numpy as np
import pytest
import torch

from catgen_torch.io.convert import kernel_to_weight
from catgen_torch.kernels import fused_upsample_conv as fuc

from test_torch_port_bf16 import f32
from test_torch_port_kernel_routes_bf16 import (C_BLOCK, C_BLOCK_BACKWARD,
                                                _close, _inputs)

# (n, h, w, cin, cout, k): a k3 stage, then a k5 stage fed by its 12
# channels
STAGES = [(2, 4, 4, 16, 12, 3), (2, 8, 8, 12, 8, 5)]
TRANSFORM = ("scale", "shift", "alpha")


@pytest.mark.parametrize("shape, with_stats", [(STAGES[0], True),
                                               (STAGES[1], False)])
def test_transform_pass_then_row3_is_the_block(shape, with_stats):
    c, t = _inputs(30, shape, shape[3])
    fuc.reset_launches()
    xn = fuc.block_input_pass(t["x"], *(t[a] for a in TRANSFORM))
    assert xn.dtype == torch.bfloat16
    assert torch.equal(xn, fuc.block_input(t["x"],
                                           *(t[a] for a in TRANSFORM)))
    got = fuc.block_plain(xn, t["kern"], t["bias"], with_stats=with_stats)
    plain = fuc.block_plain(t["x"], t["kern"], t["bias"],
                            *(t[a] for a in TRANSFORM),
                            with_stats=with_stats)
    want = C_BLOCK(c["x"], c["kern"], c["bias"], *(c[a] for a in TRANSFORM),
                   with_stats=with_stats, interpret=True)
    if not with_stats:
        got, plain, want = (got,), (plain,), (want,)
    for name, a, p, b in zip(("y", "s1", "s2"), got, plain, want):
        assert torch.equal(a, p), name
        _close(a, b, name)
    assert sum(fuc.launches().values()) == 0     # CPU: the plain versions


@pytest.mark.parametrize("shape, alpha", [(STAGES[0], "scalar"),
                                          (STAGES[1], "channelwise")])
def test_fold_pass_then_row5_dck_is_the_block_backward(shape, alpha):
    c, t = _inputs(31, shape, 1 if alpha == "scalar" else shape[3])
    y = C_BLOCK(c["x"], c["kern"], c["bias"], *(c[a] for a in TRANSFORM),
                with_stats=False, interpret=True)
    ty = torch.tensor(f32(y)).bfloat16()
    fuc.reset_launches()
    xn = fuc.block_input_pass(t["x"], *(t[a] for a in TRANSFORM))
    gf, dbias = fuc.block_fold_pass(ty, t["gy"], t["gs1"], t["gs2"])
    assert gf.dtype == torch.bfloat16 and dbias.dtype == torch.float32
    assert all(torch.equal(a, b) for a, b in zip(
        (gf, dbias), fuc.block_fold(ty, t["gy"], t["gs1"], t["gs2"])))
    dweight = fuc.kernel_backward_plain(xn, t["kern"], gf, need_x=False)[1]
    plain = fuc.block_backward_plain(t["x"], *(t[a] for a in TRANSFORM),
                                     t["kern"], ty, t["gy"], t["gs1"],
                                     t["gs2"])
    assert torch.equal(dweight, plain[4]) and torch.equal(dbias, plain[5])
    # catgen's transform constants as f32 arrays of their bf16 values, as
    # test_torch_port_kernel_routes_bf16 hands them
    tr = [c[a].astype(np.float32) for a in TRANSFORM]
    want = C_BLOCK_BACKWARD(c["x"], *tr, c["kern"], y, c["gy"], c["gs1"],
                            c["gs2"], interpret=True)
    _close(dweight, kernel_to_weight(f32(want[4])), "dweight")
    _close(dbias, want[5], "dbias")
    assert sum(fuc.launches().values()) == 0


def test_fold_pass_rounds_once_after_the_f32_fold():
    # the fold's terms summed in f32 and rounded once: rounding each term
    # to bf16 first moves some values, and dbias sums the unrounded fold
    _, t = _inputs(32, STAGES[1])
    y = t["gy"].flip(0)                 # any bf16 output of the stage's shape
    gf, dbias = fuc.block_fold_pass(y, t["gy"], t["gs1"], t["gs2"])
    g32 = fuc._fold(y, t["gy"], t["gs1"], t["gs2"])
    twice = (t["gy"] + t["gs1"].bfloat16()) + (2.0 * y) * t["gs2"].bfloat16()
    assert torch.equal(gf, g32.bfloat16())
    assert not torch.equal(gf, twice)
    assert torch.equal(dbias, g32.sum(dim=(0, 1, 2)))
    assert not torch.equal(dbias, gf.float().sum(dim=(0, 1, 2)))
