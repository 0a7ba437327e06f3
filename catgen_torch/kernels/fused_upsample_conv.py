"""Nearest-2x upsample + conv on the kernel route: the Hopper kernels and
their plain PyTorch versions. The counterpart of
``catgen/kernels/pallas_upsample_conv.py`` and
``catgen/kernels/pallas_upsample_conv_bwd.py``, with their public names:

  * ``upsample2_conv_fused(x, weight, bias, prelu_alpha)``: upsample + conv
    (+ bias, + PReLU) in one pass (catgen's row 3 kernel);
  * ``upsample2_conv_block_fused(..., with_stats)``: the ladder block,
    prelu(x * scale + shift, alpha) -> upsample + conv + bias, with the
    per-channel [sum y, sum y^2] (row 4);
  * ``upsample2_conv_backward``: (dx, dweight, dbias) of row 3 (row 5);
  * ``fused_block_backward``: the six cotangents of row 4, with the stats
    cotangents folded in (row 6);
  * ``block_input_pass`` and ``block_fold_pass``: the bf16 block's input
    transform and cotangent fold (with dbias), each a pass of its own over
    the elements, which the bf16 kernels then read as they lie (the
    forward and dCK the transform's output, dX and dCK the fold's, once
    per block backward);
  * ``upsample2_conv_bias`` and ``upsample2_conv_block``: the autograd
    Functions around them; their backwards follow ``config.upsample_bwd``
    and ``config.ladder_bwd``.

The kernels are ``catgen_torch/csrc/upsample_conv.cu`` (forward),
``catgen_torch/csrc/upsample_conv_bwd.cu`` (dX, dCK) and
``catgen_torch/csrc/upsample_conv_prep.cu`` (the bf16 passes). The
weight collapse into the 4-parity stack, the dCK -> dW chain through the
collapse matrices and the per-layer dbias stay PyTorch ops here, as
catgen keeps them outside its ``pallas_call``s.

Two element types, as catgen's compute dtype: float32, and bfloat16 with
x, the weight, bias, the input transform, g and y all in bf16. The bf16
kernels round where catgen's Pallas kernels round: the collapsed kernel
once (its taps summed in f32), the transformed input and the folded
cotangent before the products, each output once; the products' sums, the
statistics, the transform's gradients, dCK and the dCK -> dW chain are
f32, and dW and the per-layer dbias are rounded to the weight's dtype.

On CPU tensors every function runs its plain version: in f32 the input
transform, the port's ``upsample2_conv`` (the collapsed parity convs),
bias and the sums, each backward autograd of that forward; in bf16 the
same in f32 on the bf16 values, rounded at the kernels' points. On CUDA
tensors it launches the kernels or raises. Weights are OIHW (the port's
layout), images NHWC.
"""

from __future__ import annotations

import torch

from catgen_torch.kernels import config
from catgen_torch.kernels.build import load_library
from catgen_torch.kernels.upsample_conv import (_collapse_matrix, _collapse_on,
                                                collapse_weights, interleave,
                                                parity_pads, parity_plane,
                                                upsample2_conv,
                                                upsample2_conv_reference)

# the kernels' element types and the suffix of their C entry points
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Launches of each CUDA kernel since import (or since reset_launches()),
# f32 and bf16 instantiations apart.
LAUNCHES = 0              # row 3: upsample2_conv_fused
BLOCK_LAUNCHES = 0        # row 4: upsample2_conv_block_fused
DX_LAUNCHES = 0           # row 5: dX of upsample2_conv_backward
DCK_LAUNCHES = 0          # row 5: dCK of upsample2_conv_backward
BLOCK_DX_LAUNCHES = 0     # row 6: dX, dscale, dshift, dalpha
BLOCK_DCK_LAUNCHES = 0    # row 6: dCK and dbias
BF16_LAUNCHES = BF16_BLOCK_LAUNCHES = BF16_DX_LAUNCHES = 0
BF16_DCK_LAUNCHES = BF16_BLOCK_DX_LAUNCHES = BF16_BLOCK_DCK_LAUNCHES = 0
BF16_TRANSFORM_LAUNCHES = 0   # the bf16 block's input transform pass
BF16_FOLD_LAUNCHES = 0        # the bf16 block's cotangent fold pass
F32_COUNTERS = ("LAUNCHES", "BLOCK_LAUNCHES", "DX_LAUNCHES", "DCK_LAUNCHES",
                "BLOCK_DX_LAUNCHES", "BLOCK_DCK_LAUNCHES")
PASS_COUNTERS = ("BF16_TRANSFORM_LAUNCHES", "BF16_FOLD_LAUNCHES")
COUNTERS = (F32_COUNTERS + tuple(f"BF16_{c}" for c in F32_COUNTERS)
            + PASS_COUNTERS)


def reset_launches() -> None:
    for name in COUNTERS:
        globals()[name] = 0


def launches() -> dict:
    return {name: globals()[name] for name in COUNTERS}


def _count(name: str, dtype: torch.dtype) -> None:
    """Adds one to the f32 counter ``name`` or to its bf16 twin (the
    passes have only the bf16 one)."""
    globals()[name if dtype == torch.float32 else f"BF16_{name}"] += 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _wide(t):
    """t in f32, or in its own dtype where that is wider (an f64
    reference keeps f64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def in_transform(x, scale, shift, alpha):
    """The previous stage's BatchNorm affine and PReLU, in the operands'
    dtype (in bf16 each operation rounds, as catgen's ladder end does)."""
    xt = x * scale + shift
    return torch.where(xt >= 0, xt, alpha * xt)


def block_input(x, scale, shift, alpha):
    """The block's prologue: ``in_transform`` in f32, rounded once to x's
    dtype."""
    return in_transform(_wide(x), _wide(scale), _wide(shift),
                        _wide(alpha)).to(x.dtype)


def _block_sums(x, weight, bias, in_scale, in_shift, in_alpha, prelu_alpha):
    """The block's output in f32, before its one rounding: [prologue ->]
    upsample2_conv of the (rounded) operands [+ bias] [-> PReLU]."""
    if in_scale is not None:
        x = block_input(x, in_scale, in_shift, in_alpha)
    y = upsample2_conv(_wide(x), weight)
    if bias is not None:
        y = y + _wide(bias)
    if prelu_alpha is not None:
        y = torch.where(y >= 0, y, _wide(prelu_alpha) * y)
    return y


def block_plain(x, weight, bias=None, in_scale=None, in_shift=None,
                in_alpha=None, prelu_alpha=None, with_stats=False):
    """Plain forward: [in-transform ->] upsample2_conv [+ bias] [-> PReLU],
    in x's dtype; with ``with_stats`` also the f32 per-channel [sum y,
    sum y^2] of the unrounded output (``stats_plain``)."""
    y = _block_sums(x, weight, bias, in_scale, in_shift, in_alpha,
                    prelu_alpha)
    out = y.to(x.dtype)
    return (out, *stats_plain(y)) if with_stats else out


def stats_plain(y):
    """Per-channel [sum y, sum y^2] over (N, 2H, 2W)."""
    return y.sum(dim=(0, 1, 2)), (y * y).sum(dim=(0, 1, 2))


def _vjp(fn, inputs, needs, cotangent):
    """Autograd of ``fn(*inputs)``: the gradients of the inputs whose
    ``needs`` is true, in order."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = fn(*leaves)
        return torch.autograd.grad(
            out, [t for t, n in zip(leaves, needs) if n], cotangent)


def upsample2_conv_backward_plain(x, weight, g, fn=upsample2_conv,
                                  need_x=True):
    """(dx, dweight, dbias) of ``fn(x, weight) + bias`` by autograd, in the
    operands' dtype; dx is None unless ``need_x``."""
    bias = torch.zeros(weight.shape[0], dtype=g.dtype, device=g.device)
    grads = _vjp(lambda x_, w_, b_: fn(x_, w_) + b_, (x, weight, bias),
                 (need_x, True, True), g)
    return (grads[0], grads[1], grads[2]) if need_x else (None, *grads)


def stack_conv(x, wst, k_h: int, k_w: int):
    """``upsample2_conv`` from the parity stack ``wst`` (``parity_stack``
    of a k_h x k_w weight), in wst's dtype."""
    planes = []
    for p in range(4):
        d, e = divmod(p, 2)
        planes.append(parity_plane(x, wst[p].permute(3, 2, 0, 1),
                                   parity_pads(k_h, d), parity_pads(k_w, e)))
    return interleave(planes)


def _kernel_vjp(xn, weight, g, need_x=True):
    """(dxn or None, dCK) in f32 of the parity convs for the cotangent g:
    the f32 sums of the (already rounded) operands' products."""
    k_h, k_w = weight.shape[2], weight.shape[3]
    grads = _vjp(lambda a, b: stack_conv(a, b, k_h, k_w),
                 (_wide(xn), _wide(parity_stack(weight))), (need_x, True),
                 _wide(g))
    return (grads[0] if need_x else None), grads[-1]


def kernel_backward_plain(x, weight, g, need_x=True):
    """Row 5's plain version: (dx, dweight, dbias) of ``upsample2_conv(x,
    weight) + bias`` as the kernels compute them, catgen's arithmetic: dx
    and dCK f32 sums over the operands (the collapsed kernel rounded once
    to the weight's dtype), dx rounded once to x's dtype, dCK chained to dW
    in f32 and rounded to the weight's dtype, dbias the f32 sum of g,
    rounded likewise (in f32 the roundings do nothing)."""
    dxn, dck = _kernel_vjp(x, weight, g, need_x)
    k_h, k_w = weight.shape[2], weight.shape[3]
    return (dxn.to(x.dtype) if need_x else None,
            dweight_from_dck(dck, k_h, k_w).to(weight.dtype),
            _wide(g).sum(dim=(0, 1, 2)).to(weight.dtype))


def _fold(y, gy, gs1, gs2):
    """The stats cotangents folded into the output's, in f32: (gy + gs1)
    + (2 y) gs2."""
    return _wide(gy) + _wide(gs1) + 2.0 * _wide(y) * _wide(gs2)


def block_fold(y, gy, gs1, gs2):
    """The block backward's fold: (g, dbias), the fold in f32 rounded once
    to y's dtype and its f32 per-channel sum before the rounding."""
    g32 = _fold(y, gy, gs1, gs2)
    return g32.to(y.dtype), g32.sum(dim=(0, 1, 2))


def _block_ref(x, in_scale, in_shift, in_alpha, weight, bias):
    """catgen's ``_block_ref``: the block with the conv's output rounded
    to x's dtype before the bias (the ``xla_vjp`` backward's forward)."""
    xn = block_input(x, in_scale, in_shift, in_alpha)
    return upsample2_conv(xn, weight) + bias.to(x.dtype)


def fused_block_backward_plain(x, in_scale, in_shift, in_alpha, weight, bias,
                               y, gy, gs1, gs2):
    """The six cotangents of the block by autograd of catgen's
    ``_block_ref`` in x's dtype, the stats cotangents folded into g in f32
    and rounded to y's dtype (catgen's ``xla_vjp`` ladder backward);
    dalpha per input channel."""
    g = _fold(y, gy, gs1, gs2).to(y.dtype)
    alpha = in_alpha.reshape(-1).expand(x.shape[-1])
    return _vjp(_block_ref, (x, in_scale, in_shift, alpha, weight, bias),
                (True,) * 6, g)


def block_grads_plain(x, in_scale, in_shift, in_alpha, weight, g):
    """The block's gradients for the folded cotangent g (``block_fold``'s,
    in x's dtype) as the kernels compute them from it, catgen's
    ``_fused_block_bwd_kernel`` arithmetic after its fold: (dx, dscale,
    dshift, dalpha (Cin,), dweight), the prologue recomputed in f32 and
    rounded to x's dtype, dx of the parity convs on g and the transform's
    backward in f32, dx rounded once, dscale, dshift and dalpha f32 sums,
    dCK chained to dW in f32 and rounded to the weight's dtype (in f32 the
    roundings do nothing). The bf16 block dX kernel computes the first
    four, the dCK kernel on the transform pass's output the last."""
    sc, sh = _wide(in_scale), _wide(in_shift)
    al = _wide(in_alpha).reshape(-1).expand(x.shape[-1])
    xt = _wide(x) * sc + sh
    mask = xt >= 0
    xn = torch.where(mask, xt, al * xt).to(x.dtype)
    dxn, dck = _kernel_vjp(xn, weight, g)
    dxt = dxn * torch.where(mask, 1.0, al)
    dims = (0, 1, 2)
    return ((dxt * sc).to(x.dtype), (dxt * _wide(x)).sum(dims),
            dxt.sum(dims), (dxn * torch.where(mask, 0.0, xt)).sum(dims),
            dweight_from_dck(dck, weight.shape[2], weight.shape[3]).to(
                weight.dtype))


def block_backward_plain(x, in_scale, in_shift, in_alpha, weight, y, gy,
                         gs1, gs2):
    """Row 6's plain version: (dx, dscale, dshift, dalpha (Cin,), dweight,
    dbias), catgen's ``_fused_block_bwd_kernel`` arithmetic: the fold in
    f32 rounded once to y's dtype (``block_fold``; dbias its f32 sum),
    then ``block_grads_plain`` on the folded cotangent."""
    g, dbias = block_fold(y, gy, gs1, gs2)
    return (*block_grads_plain(x, in_scale, in_shift, in_alpha, weight, g),
            dbias)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _check(name: str, t: torch.Tensor, device, shape=None,
           dtype=None) -> None:
    """t on ``device``, contiguous, and of ``shape`` and ``dtype`` where
    they are given."""
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"upsample-conv kernel takes {dtype} {name}, got "
                        f"{t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, x on {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"upsample-conv kernel takes a contiguous {name}")


def _geometry(x: torch.Tensor, weight: torch.Tensor):
    """Checks x and the weight; returns (n, h, w, cin, cout, k_h, k_w)."""
    if not x.is_cuda:
        raise ValueError(f"upsample-conv kernel needs CUDA tensors, x is on "
                         f"{x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"upsample-conv kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    _check("x", x, x.device)
    if weight.dim() != 4 or weight.shape[1] != x.shape[3]:
        raise ValueError(f"weight must be (Cout, {x.shape[3]}, k, k), got "
                         f"{tuple(weight.shape)}")
    if weight.shape[2] % 2 != 1 or weight.shape[3] % 2 != 1:
        raise ValueError(f"kernel size must be odd, got "
                         f"{tuple(weight.shape[2:])}")
    if weight.dtype != x.dtype or weight.device != x.device:
        raise ValueError(f"weight must be {x.dtype} on {x.device}, got "
                         f"{weight.dtype} on {weight.device}")
    n, h, w, cin = x.shape
    return n, h, w, cin, weight.shape[0], weight.shape[2], weight.shape[3]


def _umins(k_h: int, k_w: int) -> tuple:
    """Tap 0's offset for parities 0 and 1 of each axis."""
    return (_collapse_matrix(k_h, 0)[1], _collapse_matrix(k_h, 1)[1],
            _collapse_matrix(k_w, 0)[1], _collapse_matrix(k_w, 1)[1])


def parity_stack(weight: torch.Tensor) -> torch.Tensor:
    """The four collapsed kernels of an OIHW weight in parity order (d, e)
    as (4, kh', kw', Cin, Cout), the layout the kernels read (the bf16
    forward its transpose (4, kh', kw', Cout, Cin))."""
    cks = [collapse_weights(weight, d, e)[0] for d in (0, 1) for e in (0, 1)]
    return torch.stack([ck.permute(2, 3, 1, 0) for ck in cks]).contiguous()


def dweight_from_dck(dck: torch.Tensor, k_h: int, k_w: int) -> torch.Tensor:
    """dW = collapse^T(dCK): (4, kh', kw', Cin, Cout) -> (Cout, Cin, k_h,
    k_w)."""
    dw = None
    for p in range(4):
        d, e = divmod(p, 2)
        mh = _collapse_on(k_h, d, dck.device, dck.dtype)[0]
        mw = _collapse_on(k_w, e, dck.device, dck.dtype)[0]
        term = torch.einsum("ua,vb,uvio->oiab", mh, mw, dck[p])
        dw = term if dw is None else dw + term
    return dw


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _entry(name: str, dtype: torch.dtype):
    """The C entry point ``catgen_upsample_conv_<name>_<f32|bf16>``."""
    return getattr(load_library(),
                   f"catgen_upsample_conv_{name}_{KERNEL_DTYPES[dtype]}")


def _check_transform(in_scale, in_shift, in_alpha, cin, x):
    """Checks the input transform; returns in_alpha as (cin,)."""
    _check("in_scale", in_scale, x.device, (cin,), x.dtype)
    _check("in_shift", in_shift, x.device, (cin,), x.dtype)
    if in_alpha.numel() not in (1, cin):
        raise ValueError(f"in_alpha must hold 1 or {cin} slopes, got "
                         f"{in_alpha.numel()}")
    _check("in_alpha", in_alpha, x.device, dtype=x.dtype)
    return in_alpha.reshape(-1).expand(cin).contiguous()


def _bf16_only(what: str, x) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what} kernel needs CUDA tensors, x is on "
                         f"{x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bfloat16, got {x.dtype}")


def _launch_transform(x, in_scale, in_shift, in_alpha):
    """Runs the transform pass on a bf16 x (N, H, W, Cin); returns xn."""
    _bf16_only("block input transform", x)
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got {tuple(x.shape)}")
    _check("x", x, x.device)
    cin = x.shape[3]
    in_alpha = _check_transform(in_scale, in_shift, in_alpha, cin, x)
    xn = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = load_library().catgen_upsample_conv_transform_bf16(
            x.data_ptr(), in_scale.data_ptr(), in_shift.data_ptr(),
            in_alpha.data_ptr(), xn.data_ptr(), x.numel() // max(cin, 1),
            cin, _stream(x.device))
    _launched(err, "block input transform")
    return xn


def _launch_fold(y, gy, gs1, gs2):
    """Runs the fold pass on bf16 y and gy (N, 2H, 2W, Cout) with f32 gs1,
    gs2 (Cout,); returns (gf, dbias f32)."""
    _bf16_only("cotangent fold", y)
    if y.dim() != 4:
        raise ValueError(f"y must be (N, 2H, 2W, Cout), got "
                         f"{tuple(y.shape)}")
    _check("y", y, y.device)
    _check("gy", gy, y.device, y.shape, y.dtype)
    cout = y.shape[3]
    gs = torch.stack([gs1.float(), gs2.float()]).contiguous()
    _check("gs", gs, y.device, (2, cout))
    rows = y.numel() // max(cout, 1)
    lib = load_library()
    partial = torch.empty((lib.catgen_upsample_conv_fold_rows(rows, cout),
                           cout), dtype=torch.float32, device=y.device)
    gf = torch.empty_like(gy)
    dbias = torch.empty((cout,), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        err = lib.catgen_upsample_conv_fold_bf16(
            gy.data_ptr(), y.data_ptr(), gs.data_ptr(), gf.data_ptr(),
            partial.data_ptr(), dbias.data_ptr(), rows, cout,
            _stream(y.device))
    _launched(err, "cotangent fold")
    return gf, dbias


# pixels of a bf16 forward tile and channels of its contraction step
FWD_TILE_PIXELS, FWD_STEP = 128, 64


def fwd_bf16_box(n: int, h: int, w: int, cin: int, aligned: bool = True):
    """The box (w_b, h_b, n_b) of x (n, h, w, cin) that the bf16 forward's
    warp-specialised kernel loads each 128-pixel tile as, by TMA: a box
    whose elements in row order are the tile's pixels (128 pixels of one
    row, whole rows of one image, or whole images); None where no box
    holds a tile (h w neither divides 128 nor is a multiple of it, or its
    rows do not split into boxes), cin % 64 != 0, or x is not 16-byte
    aligned (``aligned``), where the cp.async kernel
    (``upsample_conv_fwd_bf16``) runs. Shape and alignment alone decide."""
    hw = h * w
    if not aligned or cin % FWD_STEP or n * hw == 0:
        return None
    if w % FWD_TILE_PIXELS == 0:
        return (FWD_TILE_PIXELS, 1, 1)
    if FWD_TILE_PIXELS % w == 0 and hw % FWD_TILE_PIXELS == 0:
        return (w, FWD_TILE_PIXELS // w, 1)
    if FWD_TILE_PIXELS % hw == 0:
        return (w, h, FWD_TILE_PIXELS // hw)
    return None


def forward_kind_bf16(x) -> str:
    """Which kernel the bf16 forward takes for x (N, H, W, Cin): "tma"
    (the warp-specialised kernel, ``fwd_bf16_box``) or "cp_async" (the
    cp.async kernel, ``upsample_conv_fwd_bf16``)."""
    n, h, w, cin = x.shape
    return ("tma" if fwd_bf16_box(n, h, w, cin, x.data_ptr() % 16 == 0)
            else "cp_async")


def _launch_forward(x, weight, bias=None, prelu_alpha=None, in_scale=None,
                    in_shift=None, in_alpha=None, with_stats=False):
    """Runs the forward kernel; returns y, or (y, s1, s2) with stats (f32
    sums in both element types). In bf16 the input transform runs first,
    as its own pass (``block_input_pass``)."""
    n, h, w, cin, cout, k_h, k_w = _geometry(x, weight)
    dev = x.device
    if bias is not None:
        _check("bias", bias, dev, (cout,), x.dtype)
    prelu_n = 0
    if prelu_alpha is not None:
        prelu_alpha = prelu_alpha.reshape(-1)
        prelu_n = prelu_alpha.numel()
        if prelu_n not in (1, cout):
            raise ValueError(f"prelu_alpha must hold 1 or {cout} slopes, got "
                             f"{prelu_n}")
        _check("prelu_alpha", prelu_alpha, dev, dtype=x.dtype)
    if in_scale is not None:
        in_alpha = _check_transform(in_scale, in_shift, in_alpha, cin, x)
    lib = load_library()
    wst = parity_stack(weight)
    transform = (_ptr(in_scale), _ptr(in_shift), _ptr(in_alpha))
    box = ()
    if x.dtype == torch.bfloat16:     # K-major B for bf16 wgmma
        wst = wst.transpose(3, 4).contiguous()
        if in_scale is not None:
            x = block_input_pass(x, in_scale, in_shift, in_alpha)
        transform = ()
        # the box of x the TMA kernel loads, or (0, 0, 0): the cp.async one
        box = fwd_bf16_box(n, h, w, cin, x.data_ptr() % 16 == 0) or (0, 0, 0)
    y = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=dev)
    partial = stats = None
    if with_stats:
        rows = 4 * lib.catgen_upsample_conv_partial_rows(n, h, w)
        partial = torch.empty((rows, 2, cout), dtype=torch.float32,
                              device=dev)
        stats = torch.empty((2, cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry("fwd", x.dtype)(
            x.data_ptr(), wst.data_ptr(), _ptr(bias), _ptr(prelu_alpha),
            prelu_n, *transform, y.data_ptr(), _ptr(partial), _ptr(stats),
            n, h, w, cin, cout,
            wst.shape[1], wst.shape[2], *_umins(k_h, k_w), *box, _stream(dev))
    _launched(err, "upsample-conv forward")
    return (y, stats[0], stats[1]) if with_stats else y


def _launch_dx(x, weight, g, y=None, gs=None, in_scale=None, in_shift=None,
               in_alpha=None):
    """Runs the dX kernel; with the transform, returns (dx, dtr (3, cin))
    (dtr f32 in both element types). The f32 kernel folds g with y and gs
    itself; the bf16 kernel takes no fold, but g folded by
    ``block_fold_pass``."""
    n, h, w, cin, cout, k_h, k_w = _geometry(x, weight)
    dev = x.device
    _check("g", g, dev, (n, 2 * h, 2 * w, cout), x.dtype)
    if x.dtype == torch.bfloat16 and y is not None:
        raise ValueError("the bf16 dX kernel reads the folded cotangent: "
                         "fold with block_fold_pass first")
    lib = load_library()
    wst = parity_stack(weight)
    dx = torch.empty_like(x)
    partial = dtr = None
    if in_scale is not None:
        rows = lib.catgen_upsample_conv_partial_rows(n, h, w)
        partial = torch.empty((rows, 3, cin), dtype=torch.float32, device=dev)
        dtr = torch.empty((3, cin), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry("dx", x.dtype)(
            g.data_ptr(), _ptr(y), _ptr(gs), wst.data_ptr(),
            x.data_ptr() if in_scale is not None else None, _ptr(in_scale),
            _ptr(in_shift), _ptr(in_alpha), dx.data_ptr(), _ptr(partial),
            _ptr(dtr), n, h, w, cin, cout, wst.shape[1], wst.shape[2],
            *_umins(k_h, k_w), _stream(dev))
    _launched(err, "upsample-conv dX")
    return dx if dtr is None else (dx, dtr)


def _launch_dck(x, weight, g, y=None, gs=None, in_scale=None, in_shift=None,
                in_alpha=None):
    """Runs the dCK kernel; returns dCK (4, kh', kw', Cin, Cout), and with
    the fold (f32 only) also dbias (Cout,), both f32. In bf16 the kernel
    takes no fold, but g folded by ``block_fold_pass``, and the transform
    runs first as a pass of its own (``block_input_pass``), whose output
    the kernel reads."""
    n, h, w, cin, cout, k_h, k_w = _geometry(x, weight)
    dev = x.device
    _check("g", g, dev, (n, 2 * h, 2 * w, cout), x.dtype)
    lib = load_library()
    kp_h, kp_w = _collapse_matrix(k_h, 0)[0].shape[0], \
        _collapse_matrix(k_w, 0)[0].shape[0]
    splits = lib.catgen_upsample_conv_dck_splits(n, h, w, cin, cout, kp_h,
                                                 kp_w)
    partial = torch.empty((splits, 4, kp_h, kp_w, cin, cout),
                          dtype=torch.float32, device=dev)
    dck = torch.empty((4, kp_h, kp_w, cin, cout), dtype=torch.float32,
                      device=dev)
    db_partial = dbias = None
    if x.dtype == torch.bfloat16:
        if y is not None:
            raise ValueError("the bf16 dCK kernel reads the folded "
                             "cotangent: fold with block_fold_pass first")
        if in_scale is not None:
            x = block_input_pass(x, in_scale, in_shift, in_alpha)
        with torch.cuda.device(dev):
            err = lib.catgen_upsample_conv_dck_bf16(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                dck.data_ptr(), n, h, w, cin, cout, kp_h, kp_w,
                *_umins(k_h, k_w), _stream(dev))
        _launched(err, "upsample-conv dCK")
        return dck
    if y is not None:
        db_partial = torch.empty((splits * 4, cout), dtype=torch.float32,
                                 device=dev)
        dbias = torch.empty((cout,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry("dck", x.dtype)(
            x.data_ptr(), _ptr(in_scale), _ptr(in_shift), _ptr(in_alpha),
            g.data_ptr(), _ptr(y), _ptr(gs), partial.data_ptr(),
            dck.data_ptr(), _ptr(db_partial), _ptr(dbias), n, h, w, cin,
            cout, kp_h, kp_w, *_umins(k_h, k_w), _stream(dev))
    _launched(err, "upsample-conv dCK")
    return dck if dbias is None else (dck, dbias)


# ---------------------------------------------------------------------------
# public functions
# ---------------------------------------------------------------------------


def block_input_pass(x, in_scale, in_shift, in_alpha):
    """The block's input transform, ``block_input``: prelu(x * in_scale +
    in_shift, in_alpha) in f32, rounded once to x's dtype, as one pass
    over x (N, H, W, Cin) (the bf16 kernel on the card). in_scale,
    in_shift (Cin,), in_alpha (Cin,) or (1,), in x's dtype."""
    if _on_cpu(x, in_scale, in_shift, in_alpha):
        return block_input(x, in_scale, in_shift, in_alpha)
    xn = _launch_transform(x, in_scale, in_shift, in_alpha)
    _count("TRANSFORM_LAUNCHES", x.dtype)
    return xn


def block_fold_pass(y, gy, gs1, gs2):
    """The block backward's fold, ``block_fold``: (g, dbias), g = (gy +
    gs1) + (2 y) gs2 in f32 rounded once to y's dtype and dbias its f32
    sum over (N, 2H, 2W), as one pass over y and gy (the bf16 kernel on
    the card). gs1, gs2 (Cout,) f32."""
    if _on_cpu(y, gy, gs1, gs2):
        return block_fold(y, gy, gs1, gs2)
    out = _launch_fold(y, gy, gs1, gs2)
    _count("FOLD_LAUNCHES", y.dtype)
    return out


def upsample2_conv_fused(x, weight, bias=None, prelu_alpha=None):
    """Nearest-2x upsample + same conv (+ bias) (+ PReLU, one slope or one
    per output channel) in one pass. x (N, H, W, Cin), weight (Cout, Cin,
    k, k) odd k, bias and slopes in x's dtype; returns (N, 2H, 2W, Cout)."""
    if _on_cpu(x, weight, bias, prelu_alpha):
        return block_plain(x, weight, bias, prelu_alpha=prelu_alpha)
    y = _launch_forward(x, weight, bias, prelu_alpha=prelu_alpha)
    _count("LAUNCHES", x.dtype)
    return y


def upsample2_conv_block_fused(x, weight, bias, in_scale, in_shift, in_alpha,
                               with_stats: bool = True):
    """prelu(x * in_scale + in_shift, in_alpha) -> upsample2 -> conv ->
    + bias in one pass; with ``with_stats`` also the per-channel [sum y,
    sum y^2] over (N, 2H, 2W), f32. in_scale, in_shift (Cin,); in_alpha
    (Cin,) or (1,); all in x's dtype. Returns y, or (y, s1, s2)."""
    if _on_cpu(x, weight, bias, in_scale, in_shift, in_alpha):
        return block_plain(x, weight, bias, in_scale, in_shift, in_alpha,
                           with_stats=with_stats)
    out = _launch_forward(x, weight, bias, in_scale=in_scale,
                          in_shift=in_shift, in_alpha=in_alpha,
                          with_stats=with_stats)
    _count("BLOCK_LAUNCHES", x.dtype)
    return out


def upsample2_conv_dx(x, weight, g):
    """dx of ``upsample2_conv(x, weight)`` for the cotangent g: the dX
    kernel alone (the ``hybrid`` backward)."""
    if _on_cpu(x, weight, g):
        return kernel_backward_plain(x, weight, g)[0]
    dx = _launch_dx(x, weight, g)
    _count("DX_LAUNCHES", x.dtype)
    return dx


def upsample2_conv_backward(x, weight, g):
    """(dx, dweight, dbias) of ``upsample2_conv(x, weight) + bias`` for the
    cotangent g (N, 2H, 2W, Cout); dweight and dbias in the weight's
    dtype."""
    if _on_cpu(x, weight, g):
        return kernel_backward_plain(x, weight, g)
    dx = upsample2_conv_dx(x, weight, g)
    dck = _launch_dck(x, weight, g)
    _count("DCK_LAUNCHES", x.dtype)
    dw = dweight_from_dck(dck, weight.shape[2], weight.shape[3])
    return (dx, dw.to(weight.dtype),
            g.float().sum(dim=(0, 1, 2)).to(weight.dtype))


def fused_block_backward(x, in_scale, in_shift, in_alpha, weight, y, gy,
                         gs1, gs2):
    """The full VJP of ``upsample2_conv_block``: returns (dx, dscale,
    dshift, dalpha (Cin,), dweight, dbias); the caller sums dalpha for a
    shared slope. dx in x's dtype, dweight in the weight's; the others are
    f32 sums."""
    if _on_cpu(x, in_scale, in_shift, in_alpha, weight, y, gy, gs1, gs2):
        return block_backward_plain(x, in_scale, in_shift, in_alpha, weight,
                                    y, gy, gs1, gs2)
    cin = x.shape[-1]
    gs = torch.stack([gs1.float(), gs2.float()]).contiguous()
    _check("y", y, x.device, gy.shape, x.dtype)
    _check("gs", gs, x.device, (2, weight.shape[0]))
    alpha = _check_transform(in_scale, in_shift, in_alpha, cin, x)
    tr = (in_scale, in_shift, alpha)
    if x.dtype == torch.bfloat16:
        # the fold once, for both kernels, as catgen's kernel folds g once
        gf, dbias = block_fold_pass(y, gy, gs1, gs2)
        dx, dtr = _launch_dx(x, weight, gf, None, None, *tr)
        _count("BLOCK_DX_LAUNCHES", x.dtype)
        dck = _launch_dck(x, weight, gf, None, None, *tr)
    else:
        dx, dtr = _launch_dx(x, weight, gy, y, gs, *tr)
        _count("BLOCK_DX_LAUNCHES", x.dtype)
        dck, dbias = _launch_dck(x, weight, gy, y, gs, *tr)
    _count("BLOCK_DCK_LAUNCHES", x.dtype)
    dw = dweight_from_dck(dck, weight.shape[2], weight.shape[3])
    return dx, dtr[0], dtr[1], dtr[2], dw.to(weight.dtype), dbias


class _UpsampleConvBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return upsample2_conv_fused(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        impl = config.upsample_bwd
        if impl == "pallas":
            return upsample2_conv_backward(x, weight, g)
        if impl == "hybrid":
            # the dX kernel, and autograd's dW and db through the
            # collapsed parity convs
            _, dw, db = upsample2_conv_backward_plain(x, weight, g,
                                                      need_x=False)
            return upsample2_conv_dx(x, weight, g), dw, db
        fn = (upsample2_conv if impl == "collapsed"
              else upsample2_conv_reference)
        return upsample2_conv_backward_plain(x, weight, g, fn)


def upsample2_conv_bias(x, weight, bias):
    """Differentiable ``upsample2_conv_fused(x, weight, bias)``; the
    backward follows ``config.upsample_bwd``."""
    return _UpsampleConvBias.apply(x, weight, bias)


class _UpsampleConvBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, in_scale, in_shift, in_alpha, weight, bias):
        y, s1, s2 = upsample2_conv_block_fused(x, weight, bias, in_scale,
                                               in_shift, in_alpha, True)
        ctx.save_for_backward(x, in_scale, in_shift, in_alpha, weight, bias,
                              y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, in_scale, in_shift, in_alpha, weight, bias, y = ctx.saved_tensors
        gy = gy.contiguous()
        if config.ladder_bwd == "pallas":
            dx, dsc, dsh, dal, dw, db = fused_block_backward(
                x, in_scale, in_shift, in_alpha, weight, y, gy, gs1, gs2)
        else:
            # "xla_vjp" and "xla": autograd through the plain block
            dx, dsc, dsh, dal, dw, db = fused_block_backward_plain(
                x, in_scale, in_shift, in_alpha, weight, bias, y, gy, gs1,
                gs2)
        if in_alpha.numel() == 1:     # shared slope: sum over channels
            dal = dal.sum()
        # the f32 sums rounded to their inputs' dtype, as catgen's VJP
        return (dx, dsc.to(in_scale.dtype), dsh.to(in_shift.dtype),
                dal.reshape(in_alpha.shape).to(in_alpha.dtype), dw,
                db.to(bias.dtype))


def upsample2_conv_block(x, in_scale, in_shift, in_alpha, weight, bias):
    """Differentiable ladder block: returns (y, s1, s2) as
    ``upsample2_conv_block_fused(..., with_stats=True)``; the backward
    takes (gy, gs1, gs2) and follows ``config.ladder_bwd``."""
    return _UpsampleConvBlock.apply(x, in_scale, in_shift, in_alpha, weight,
                                    bias)
