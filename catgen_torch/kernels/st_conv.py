"""D's input prefix [spatial transformer -> 3x3 'same' conv -> PReLU] in
one kernel, and its plain PyTorch version: the counterpart of
``catgen/kernels/pallas_st_conv.py``.

``st_conv_prelu(img, theta, kernel, bias, alpha)`` takes catgen's layouts:
img NHWC ``(N, H, W, C)``; theta ``(N, 2, 3)``, the affine matrices in
(y, x) rows (``nn/spatial_transformer.py::affine_matrix``); kernel HWIO
``(3, 3, C, F)``; bias ``(F,)``; alpha ``(1,)`` (a shared slope) or
``(F,)``. It returns ``(N, H, W, F)``: the image sampled at the affine grid
(edge-clamped bilinear, align-corners), convolved with zero padding of the
sampled image, plus bias, through PReLU.

Two element types for the image (and the output), as catgen's compute
dtype: float32, and bfloat16; theta, kernel, bias and alpha stay f32 (the
model's parameters). In f32 the kernel computes in f32 throughout (not
catgen's bf16 roundings). In bf16 it rounds where catgen's Pallas kernel
does: the sampled image (f32 coordinates, f32 lerps) and the conv weights
to bf16, z = the f32 sum + the f32 bias stored in bf16, and the output
from the f32 z rounded once.

On CUDA tensors the wrapper launches ``csrc/st_conv.cu`` (counted in
``LAUNCHES``, ``BF16_LAUNCHES`` for bf16) or raises; on CPU tensors it
runs ``st_conv_prelu_plain``. The kernel writes the sampled image and the
pre-activation z only where autograd will need them. In f32 the shapes
that ``f32_kind`` names "tiled" (D32_st3's prefix) take
``st_conv_f32_tiled`` (a block per sample, 4 output channels of 4 pixels
a thread), the others the banded kernel ``st_conv_prelu_kernel``, with
the same bits. In bf16 the conv runs on the tensor cores
(``st_conv_bf16_mma``) for the shapes that ``bf16_kind`` names "mma"; that
kernel takes the f32 weights and packs them itself in ``pack_weights``'
fragment order (the same bits), so the wrapper launches nothing else.
Other shapes keep the banded kernel.

The backward mirrors catgen's ``_vjp_bwd``, in f32 in both element types:
dz and dalpha from the saved z; the conv's input and weight gradients
(dS, dkernel, from the unrounded f32 kernel) and dbias from the saved
sampled image in one ``aten.convolution_backward`` (catgen does that part
in XLA, outside Pallas); then, dS and the coordinate rows rounded to the
image's dtype, the sampler's backward kernels at the grid's coordinate
rows, d_coords always and d_img only where the image needs a gradient (in
the D phase it is data); ``dtheta = d_rows @ base^T`` in f32. On CPU
tensors the same Function runs with the plain forward and the plain
sampler backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from catgen_torch.kernels import bilinear
from catgen_torch.kernels.bilinear import (OPTIN_SMEM, _launched,
                                           affine_grid_rows, base_rows,
                                           bilinear_sample_rows_plain)
from catgen_torch.kernels.build import load_library

# forward kernel launches since import or a caller's reset, per element type
LAUNCHES = 0
BF16_LAUNCHES = 0


def _slope(alpha: torch.Tensor) -> torch.Tensor:
    return alpha if alpha.numel() == 1 else alpha.reshape(1, 1, 1, -1)


def prefix_rows(theta, h: int, w: int) -> torch.Tensor:
    """(N, 2, H*W) coordinate rows as catgen's fused kernel makes them
    from theta (``pallas_st_conv.py:72-73``) and the CUDA kernel does:
    t0 gy + t1 gx + t2, each product rounded, added left to right (f32).
    ``affine_grid_rows``'s matmul may add them in another order, which in
    bf16 can move a sample by a unit."""
    base = base_rows(h, w, theta.device, torch.float32)
    theta = theta.float()
    return (theta[:, :, 0:1] * base[0] + theta[:, :, 1:2] * base[1]
            + theta[:, :, 2:3])


def _forward_plain(img, theta, kernel, bias, alpha):
    """(out, samp, z) of the split composition, NHWC: the kernel's affine
    grid rows (f32), gathers, zero-padded 3x3 conv, bias, PReLU, in f32 on
    the operands rounded to the image's dtype (the sampled image, the
    kernel), each result rounded once to it."""
    n, h, w, c = img.shape
    dt = img.dtype
    rows = prefix_rows(theta, h, w)
    samp = bilinear_sample_rows_plain(img.float(), rows, (h, w)).to(dt)
    z = F.conv2d(samp.float().permute(0, 3, 1, 2),
                 kernel.to(dt).float().permute(3, 2, 0, 1), bias.float(),
                 padding=1).permute(0, 2, 3, 1)
    out = torch.where(z >= 0, z, _slope(alpha.float()) * z)
    return out.to(dt), samp, z.to(dt)


def st_conv_prelu_plain(img, theta, kernel, bias, alpha) -> torch.Tensor:
    """Plain version: the split [ST -> conv -> PReLU] composition, in f32
    (``_forward_plain``)."""
    return _forward_plain(img, theta, kernel, bias, alpha)[0]


def tiled_smem_bytes(h: int, w: int, c: int) -> int:
    """Shared memory of a block of the f32 tiled kernel, as st_conv.cu
    (``sttile::smem_bytes``) computes it: the sample's image and samp's
    compact copy (each rounded to 16 bytes), and the zero-bordered tile of
    (h + 2) rows of 4 ceil(w / 4) + 2 columns."""
    image = (h * w * c * 4 + 15) // 16 * 16
    return 2 * image + (h + 2) * ((w + 3) // 4 * 4 + 2) * c * 4


def f32_kind(img, f: int) -> str:
    """Which kernel the f32 prefix takes for img (N, H, W, C) and F output
    channels: "tiled" (``st_conv_f32_tiled``) for C = 1..4, F a multiple
    of 4, H W C a multiple of 4, a 16-byte aligned image, H W F within 32
    bits and a block that fits the card's shared memory; else "banded"
    (``st_conv_prelu_kernel``). Shape and alignment alone decide, as
    st_conv.cu's ``tiled_f32`` does (the wrapper's outputs are aligned)."""
    _, h, w, c = img.shape
    ok = (1 <= c <= 4 and f > 0 and f % 4 == 0 and (h * w * c) % 4 == 0
          and img.data_ptr() % 16 == 0 and h * w * f < 2 ** 31
          and tiled_smem_bytes(h, w, c) <= OPTIN_SMEM)
    return "tiled" if ok else "banded"


# st_conv.cu's tensor-core kernel: its most warps a block, staged bytes
# per warp (out and z: 16 pixels x 8 chunks of 16 bytes, rows padded by
# 16)
MMA_WARPS, MMA_STAGE = 16, 2 * 16 * (8 * 16 + 16)


def mma_k_tiles(c: int) -> int:
    """16-deep contraction steps of the conv: K = 9C padded to 16s."""
    return (9 * c + 15) // 16


def mma_smem_bytes(h: int, w: int, c: int, f: int,
                   warps: int = MMA_WARPS) -> int:
    """Shared memory of a block of ``warps`` warps of the tensor-core
    kernel, as st_conv.cu (``stmma::smem_bytes``) computes it: the image
    and samp's compact copy or the warps' output staging, the
    zero-bordered sampled tile, the packed weights."""
    sampling = 2 * h * w * c * 2
    staging = warps * MMA_STAGE
    tile = ((h + 2) * (w + 2) * c * 2 + 15) // 16 * 16
    return max(sampling, staging) + tile + f * mma_k_tiles(c) * 32


def bf16_kind(img, f: int) -> str:
    """Which kernel the bf16 prefix takes for img (N, H, W, C) and F
    output channels: "mma" (the conv on the tensor cores) for C = 1..4,
    F a multiple of 8, H W C a multiple of 8, a 16-byte aligned image and
    a block that fits the card's shared memory; else "cuda_cores" (the
    banded kernel, ``st_conv_prelu_kernel``). Shape and alignment alone
    decide."""
    _, h, w, c = img.shape
    ok = (1 <= c <= 4 and f > 0 and f % 8 == 0 and (h * w * c) % 8 == 0
          and img.data_ptr() % 16 == 0
          and mma_smem_bytes(h, w, c, f) <= OPTIN_SMEM)
    return "mma" if ok else "cuda_cores"


def pack_weights(kmat: torch.Tensor) -> torch.Tensor:
    """The (3, 3, C, F) weights as the tensor-core kernel packs its B
    fragments in shared memory (from the f32 weights, rounding each to
    bf16 once: ``pack_weights(kernel.bfloat16())`` is its packing, bit for
    bit): K = 9C rows in catgen's (ky, kx, ci) order
    (``kernel.reshape(9 C, F)``), zero rows to 16 KT, F a multiple of 8;
    returned as (F/8, 8, 4, KT, 2, 2): n-tile, the lane's group g and
    thread t (lane 4 g + t), k-tile, then rows 16 kt + 8 r + 2 t + j of
    column 8 nt + g. Keeps kmat's dtype."""
    c, f = kmat.shape[2], kmat.shape[3]
    kt = mma_k_tiles(c)
    m = kmat.new_zeros((16 * kt, f))
    m[:9 * c] = kmat.reshape(9 * c, f)
    return (m.reshape(kt, 2, 4, 2, f // 8, 8).permute(4, 5, 2, 0, 1, 3)
            .contiguous())


def unpack_weights(packed: torch.Tensor, c: int) -> torch.Tensor:
    """``pack_weights``'s (9C, F) matrix back from its packing."""
    nt, _, _, kt, _, _ = packed.shape
    return packed.permute(3, 4, 2, 5, 0, 1).reshape(16 * kt, 8 * nt)[:9 * c]


def _check(img, theta, kernel, bias, alpha) -> None:
    named = {"img": img, "theta": theta, "kernel": kernel, "bias": bias,
             "alpha": alpha}
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"st_conv_prelu kernel takes a float32 or bfloat16 "
                        f"img, got {img.dtype}")
    for name, t in list(named.items())[1:]:
        if t.dtype != torch.float32:
            raise TypeError(f"st_conv_prelu kernel takes float32 {name}, got "
                            f"{t.dtype}")
    if img.dim() != 4:
        raise ValueError(f"img must be (N, H, W, C), got {tuple(img.shape)}")
    n, _, _, c = img.shape
    f = kernel.shape[-1]
    want = {"theta": (n, 2, 3), "kernel": (3, 3, c, f), "bias": (f,)}
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(named[name].shape)}")
    if tuple(alpha.shape) not in ((1,), (f,)):
        raise ValueError(f"alpha must be (1,) or ({f},), got "
                         f"{tuple(alpha.shape)}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"st_conv_prelu kernel takes contiguous "
                             f"tensors; {name} is not")
    for name, t in named.items():
        if not t.is_cuda or t.device != img.device:
            raise ValueError(f"st_conv_prelu kernel needs CUDA tensors on "
                             f"one device, got {name} on {t.device}")


def launch(img, theta, kernel, bias, alpha, save: bool = True):
    """Runs the forward kernel on the current stream and returns (out,
    samp, z), NHWC, in the image's dtype; samp and z are None unless
    ``save``. Raises on bad inputs or a refused launch. Counts each launch
    in ``LAUNCHES`` (f32) or ``BF16_LAUNCHES``."""
    global LAUNCHES, BF16_LAUNCHES
    _check(img, theta, kernel, bias, alpha)
    lib = load_library()
    n, h, w, c = img.shape
    f = kernel.shape[-1]
    bf16 = img.dtype == torch.bfloat16
    base = base_rows(h, w, img.device, torch.float32)
    mma = bf16 and bf16_kind(img, f) == "mma"
    # the banded bf16 kernel takes bf16 weights; the tensor-core one packs
    # and rounds the f32 weights itself (pack_weights' layout and bits)
    kmat = kernel if mma else kernel.to(img.dtype)
    out = torch.empty((n, h, w, f), dtype=img.dtype, device=img.device)
    samp = torch.empty_like(img) if save else None
    z = torch.empty_like(out) if save else None
    args = (img.data_ptr(), theta.data_ptr(), base.data_ptr(),
            kmat.data_ptr(), bias.data_ptr(), alpha.data_ptr(),
            alpha.numel(), out.data_ptr(),
            samp.data_ptr() if save else None,
            z.data_ptr() if save else None, n, h, w, c, f)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        if bf16:
            err = lib.catgen_st_conv_prelu_bf16(*args, int(mma), stream)
        else:
            err = lib.catgen_st_conv_prelu_f32(*args, stream)
    # a band of the sampled image is held in shared memory: a width and
    # channel count too large for 48 KB are refused (cudaErrorInvalidValue)
    _launched(err, "st_conv_prelu")
    if bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out, samp, z


def _sampler_vjp(img, rows, ds, need_img: bool):
    """(d_img or None, d_rows) of the sampler at ``rows`` for the sampled
    image's gradient ``ds``: its kernels on the card, the plain backward
    on CPU tensors."""
    out_hw = img.shape[1:3]
    if not img.is_cuda:
        return bilinear.bilinear_sample_rows_backward_plain(
            img, rows, ds, out_hw, need_img=need_img)
    d_rows = bilinear.launch_dcoords(img, rows, ds, out_hw)
    d_img = bilinear.launch_dimg(img, rows, ds, out_hw) if need_img else None
    return d_img, d_rows


class _STConvPReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, theta, kernel, bias, alpha):
        if img.is_cuda:
            out, samp, z = launch(img, theta, kernel, bias, alpha)
        else:
            out, samp, z = _forward_plain(img, theta, kernel, bias, alpha)
        ctx.save_for_backward(img, theta, kernel, alpha, samp, z)
        return out

    @staticmethod
    def backward(ctx, g):
        img, theta, kernel, alpha, samp, z = ctx.saved_tensors
        n, h, w, c = img.shape
        f = kernel.shape[-1]
        need = ctx.needs_input_grad
        # f32 throughout (no-ops in f32): the bf16 g, z and samp upcast
        g, z = g.float(), z.float()
        dz = torch.where(z >= 0, g, _slope(alpha) * g)
        neg = torch.where(z < 0, g * z, 0.0)
        dalpha = (neg.sum() if alpha.numel() == 1
                  else neg.sum(dim=(0, 1, 2))).reshape(alpha.shape)
        ds, dw, dbias = torch.ops.aten.convolution_backward(
            dz.permute(0, 3, 1, 2), samp.float().permute(0, 3, 1, 2),
            kernel.permute(3, 2, 0, 1), [f], [1, 1], [1, 1], [1, 1], False,
            [0, 0], 1, [True, need[2], need[3]])
        dkernel = dw.permute(2, 3, 1, 0) if need[2] else None
        rows = affine_grid_rows(theta, h, w).to(img.dtype)
        d_img, d_rows = _sampler_vjp(
            img, rows, ds.permute(0, 2, 3, 1).to(img.dtype).contiguous(),
            need[0])
        dtheta = torch.matmul(d_rows.float(), base_rows(h, w, theta.device,
                                                        theta.dtype).T)
        return d_img, dtheta, dkernel, dbias, dalpha


def st_conv_prelu(img, theta, kernel, bias, alpha) -> torch.Tensor:
    """img (N, H, W, C) f32 or bf16, theta (N, 2, 3), kernel (3, 3, C, F),
    bias (F,), alpha (1,) or (F,), all four f32. Returns (N, H, W, F) in
    the image's dtype. CPU tensors take the plain version; CUDA tensors the
    kernel, which skips writing what the backward reads when no gradient
    will be taken. The backward is catgen's VJP on both."""
    args = (img, theta, kernel, bias, alpha)
    cpu = all(t.device.type == "cpu" for t in args)
    if not cpu:
        # the parameters are small: a contiguous copy costs nothing; the
        # image must come contiguous
        args = (img,) + tuple(t.contiguous() for t in args[1:])
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _STConvPReLU.apply(*args)
    return st_conv_prelu_plain(*args) if cpu else launch(*args,
                                                          save=False)[0]
