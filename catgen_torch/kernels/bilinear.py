"""Bilinear sampling at coordinate rows: the Hopper kernels and their plain
PyTorch version.

``affine_grid_rows(theta, h, w)`` makes the rows of an affine grid, and
``bilinear_sample_rows(img, coords_rows, out_hw)`` samples an NHWC image at
normalized (y; x) coordinate rows ``(N, 2, Ho*Wo)`` with edge-clamped
bilinear interpolation (align-corners: -1 is pixel 0, +1 is pixel size-1)
and returns ``(N, Ho, Wo, C)``, differentiable with respect to both
inputs. It is the counterpart of
``catgen/kernels/pallas_bilinear_v4.py::bilinear_sample_rows``; the CUDA
kernels are ``catgen_torch/csrc/bilinear_sample.cu`` (forward) and
``catgen_torch/csrc/bilinear_sample_bwd.cu`` (d_img and d_coords). Which
forward, d_coords and d_img kernel a shape takes is decided by the shape
alone (``forward_kind``, ``dcoords_kind``, ``dimg_kind``).

On a CUDA tensor the wrapper launches the kernels or raises; on a CPU
tensor it runs ``bilinear_sample_rows_plain``, the gather-and-lerp
formulation of ``catgen/nn/spatial_transformer.py::bilinear_sample``,
under autograd. Both follow the TPU kernel at exact edges: the derivative
of the coordinate clip is 1 on the edge itself (``torch.clamp``; v4's
inclusive masks), where catgen's XLA path (``jnp.clip``) gives 0.5.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from catgen_torch.kernels.build import load_library

# Launches of each CUDA kernel since import (or since a caller reset them).
LAUNCHES = 0              # forward
DCOORDS_LAUNCHES = 0      # backward, d_coords
DIMG_LAUNCHES = 0         # backward, d_img


@functools.lru_cache(maxsize=32)
def base_rows(height: int, width: int, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    """(3, H*W) rows [gy; gx; 1] of the normalized output grid. Made with
    numpy, so that every device gets the same values, and once per shape
    and device: a copy from host memory on every call would make the host
    wait for the card. Made outside inference mode, so that autograd may
    save it."""
    gy, gx = np.meshgrid(np.linspace(-1.0, 1.0, height),
                         np.linspace(-1.0, 1.0, width), indexing="ij")
    base = np.stack([gy.reshape(-1), gx.reshape(-1),
                     np.ones(height * width)]).astype(np.float32)
    with torch.inference_mode(False):
        return torch.from_numpy(base).to(device, dtype)


def affine_grid_rows(theta: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """(B, 2, 3) affine matrices -> (B, 2, H*W) normalized (y; x) rows, the
    layout the sampler kernel takes."""
    return torch.matmul(theta, base_rows(height, width, theta.device,
                                         theta.dtype))


def bilinear_sample_rows_plain(img: torch.Tensor, coords_rows: torch.Tensor,
                               out_hw) -> torch.Tensor:
    """Plain version: four gathers and three lerps, in the input dtype."""
    n, h, w, c = img.shape
    ho, wo = out_hw
    p = ho * wo
    fy = (coords_rows[:, 0] + 1.0) * 0.5 * (h - 1)       # (N, P)
    fx = (coords_rows[:, 1] + 1.0) * 0.5 * (w - 1)
    fy = torch.clamp(fy, 0.0, h - 1)
    fx = torch.clamp(fx, 0.0, w - 1)
    if h > 1:
        y0 = torch.clamp(torch.floor(fy), 0, h - 2).long()
    else:
        y0 = torch.zeros_like(fy, dtype=torch.long)
    if w > 1:
        x0 = torch.clamp(torch.floor(fx), 0, w - 2).long()
    else:
        x0 = torch.zeros_like(fx, dtype=torch.long)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (fy - y0.to(fy.dtype))[..., None]
    wx = (fx - x0.to(fx.dtype))[..., None]
    flat = img.reshape(n, h * w, c)

    def gather(yi, xi):
        idx = (yi * w + xi)[..., None].expand(n, p, c)
        return torch.gather(flat, 1, idx)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return (top * (1 - wy) + bot * wy).to(img.dtype).reshape(n, ho, wo, c)


def bilinear_sample_rows_backward_plain(img, coords_rows, grad_out, out_hw,
                                        need_img=True, need_coords=True):
    """Plain backward: (d_img, d_coords) of the plain version by autograd,
    each None where not asked for."""
    with torch.enable_grad():
        img = img.detach().requires_grad_(need_img)
        crd = coords_rows.detach().requires_grad_(need_coords)
        out = bilinear_sample_rows_plain(img, crd, out_hw)
        wrt = [t for t, need in ((img, need_img), (crd, need_coords)) if need]
        grads = iter(torch.autograd.grad(out, wrt, grad_out))
    return (next(grads) if need_img else None,
            next(grads) if need_coords else None)


def _check(img: torch.Tensor, coords_rows: torch.Tensor, out_hw) -> None:
    if img.dtype != torch.float32 or coords_rows.dtype != torch.float32:
        raise TypeError(f"bilinear_sample_rows kernel takes float32, got "
                        f"{img.dtype} and {coords_rows.dtype}")
    if img.dim() != 4:
        raise ValueError(f"img must be (N, H, W, C), got {tuple(img.shape)}")
    ho, wo = out_hw
    want = (img.shape[0], 2, ho * wo)
    if tuple(coords_rows.shape) != want:
        raise ValueError(f"coords_rows must be {want} for out_hw={out_hw}, "
                         f"got {tuple(coords_rows.shape)}")
    if not (img.is_contiguous() and coords_rows.is_contiguous()):
        raise ValueError("bilinear_sample_rows kernel takes contiguous "
                         "tensors (NHWC image, (N, 2, P) rows)")
    if not (img.is_cuda and coords_rows.is_cuda):
        raise ValueError(
            f"bilinear_sample_rows kernel needs CUDA tensors, got "
            f"{img.device} and {coords_rows.device}")
    if img.device != coords_rows.device:
        raise ValueError(f"img on {img.device}, coords on "
                         f"{coords_rows.device}")


def _check_grad(img: torch.Tensor, grad_out: torch.Tensor, out_hw) -> None:
    n, _, _, c = img.shape
    want = (n, out_hw[0], out_hw[1], c)
    if grad_out.dtype != torch.float32:
        raise TypeError(f"bilinear sampler backward takes a float32 "
                        f"gradient, got {grad_out.dtype}")
    if tuple(grad_out.shape) != want or not grad_out.is_contiguous():
        raise ValueError(f"the sampled output's gradient must be a "
                         f"contiguous {want}, got {tuple(grad_out.shape)}")
    if grad_out.device != img.device:
        raise ValueError(f"gradient on {grad_out.device}, img on "
                         f"{img.device}")


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def launch(img: torch.Tensor, coords_rows: torch.Tensor,
           out_hw) -> torch.Tensor:
    """Runs the forward kernel on the current stream; raises on bad inputs
    or a refused launch. Counts each launch in ``LAUNCHES``."""
    global LAUNCHES
    _check(img, coords_rows, out_hw)
    lib = load_library()
    n, h, w, c = img.shape
    ho, wo = out_hw
    out = torch.empty((n, ho, wo, c), dtype=img.dtype, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.catgen_bilinear_sample_rows_f32(
            img.data_ptr(), coords_rows.data_ptr(), out.data_ptr(),
            n, h, w, c, ho * wo, stream)
    _launched(err, "bilinear_sample_rows")
    LAUNCHES += 1
    return out


def launch_dcoords(img: torch.Tensor, coords_rows: torch.Tensor,
                   grad_out: torch.Tensor, out_hw) -> torch.Tensor:
    """Runs the d_coords kernel: (N, 2, P), the gradient with respect to
    the coordinate rows. Counts each launch in ``DCOORDS_LAUNCHES``."""
    global DCOORDS_LAUNCHES
    _check(img, coords_rows, out_hw)
    _check_grad(img, grad_out, out_hw)
    lib = load_library()
    n, h, w, c = img.shape
    dcrd = torch.empty_like(coords_rows)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.catgen_bilinear_dcoords_f32(
            img.data_ptr(), coords_rows.data_ptr(), grad_out.data_ptr(),
            dcrd.data_ptr(), n, h, w, c, out_hw[0] * out_hw[1], stream)
    _launched(err, "bilinear sampler d_coords")
    DCOORDS_LAUNCHES += 1
    return dcrd


DCOORDS_KINDS = ("per_pixel", "per_warp", "staged")
FORWARD_KINDS = ("per_pixel", "per_value", "staged", "per_quad")
DIMG_KINDS = ("per_channel", "per_sample", "gather")


def _kind(h: int, w: int, c: int, names, entry: str) -> str:
    code = getattr(load_library(), entry)(h, w, c)
    if code < 0:
        raise RuntimeError(f"reading the card's shared memory failed: "
                           f"cudaError_t {-code}")
    return names[code]


def dcoords_kind(h: int, w: int, c: int) -> str:
    """Which d_coords kernel an (h, w, c) image takes on the current card
    (16-byte aligned arrays): ``per_pixel`` (c < 32), ``staged`` (the
    image in shared memory: c % 4 == 0 and it fits) or ``per_warp``."""
    return _kind(h, w, c, DCOORDS_KINDS, "catgen_bilinear_sampler_kind")


def forward_kind(h: int, w: int, c: int) -> str:
    """Which forward kernel an (h, w, c) image takes on the current card,
    rows or grid layout, with 16-byte aligned arrays: for c >= 32 the
    d_coords kernels' rule, ``staged`` (c % 4 == 0 and the image fits
    shared memory) or ``per_value`` (unaligned arrays take it too); for c
    < 32 ``per_quad`` (the image staged in shared memory, four output
    pixels a thread: h*w*c % 4 == 0 and the image fits) or ``per_pixel``
    (unaligned arrays take it too)."""
    return _kind(h, w, c, FORWARD_KINDS, "catgen_bilinear_forward_kind")


def dimg_kind(h: int, w: int, c: int) -> str:
    """Which d_img kernel an (h, w, c) image takes on the current card,
    rows or grid layout: ``per_sample`` (c < 32 and four h*w*c slabs fit
    one block's shared memory: a block per sample, one slab per warp),
    else ``gather`` (a block per sample buckets its output pixels' taps by
    input pixel, then sums each input pixel's bin in order; images up to
    79x79), else ``per_channel`` (a block per sample and slab of 32
    channels)."""
    return _kind(h, w, c, DIMG_KINDS, "catgen_bilinear_dimg_kind")


def launch_dimg(img: torch.Tensor, coords_rows: torch.Tensor,
                grad_out: torch.Tensor, out_hw) -> torch.Tensor:
    """Runs the d_img kernel: (N, H, W, C), the gradient with respect to
    the image (``img`` gives its shape and device; its values are not
    read). Deterministic: no atomics. Counts each launch in
    ``DIMG_LAUNCHES``."""
    global DIMG_LAUNCHES
    _check(img, coords_rows, out_hw)
    _check_grad(img, grad_out, out_hw)
    lib = load_library()
    n, h, w, c = img.shape
    dimg = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.catgen_bilinear_dimg_f32(
            coords_rows.data_ptr(), grad_out.data_ptr(), dimg.data_ptr(),
            n, h, w, c, out_hw[0] * out_hw[1], stream)
    # a block holds up to 8 slabs of h*w*c floats (per sample), 8 cursors
    # per input pixel and 1024 output pixels' entries and weights (gather)
    # or h*w*min(c, 32) floats (per channel); an image too large for the
    # card's shared memory is refused with cudaErrorInvalidValue
    _launched(err, f"bilinear sampler d_img (a block needs "
                   f"{lib.catgen_bilinear_dimg_smem_bytes(h, w, c)} bytes of "
                   f"shared memory)")
    DIMG_LAUNCHES += 1
    return dimg


class _BilinearSampleRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, coords_rows, out_hw):
        ctx.out_hw = out_hw
        ctx.save_for_backward(img, coords_rows)
        return launch(img, coords_rows, out_hw)

    @staticmethod
    def backward(ctx, grad_out):
        img, coords_rows = ctx.saved_tensors
        g = grad_out.contiguous()
        # no d_img work where the image needs no gradient (the D-phase
        # input transformer samples data)
        d_img = (launch_dimg(img, coords_rows, g, ctx.out_hw)
                 if ctx.needs_input_grad[0] else None)
        d_crd = (launch_dcoords(img, coords_rows, g, ctx.out_hw)
                 if ctx.needs_input_grad[1] else None)
        return d_img, d_crd, None


def bilinear_sample_rows(img: torch.Tensor, coords_rows: torch.Tensor,
                         out_hw) -> torch.Tensor:
    """img (N, H, W, C); coords_rows (N, 2, Ho*Wo) normalized (y; x) rows.
    Returns (N, Ho, Wo, C). CPU tensors take the plain version; CUDA
    tensors take the kernels, forward and backward."""
    if img.device.type == "cpu" and coords_rows.device.type == "cpu":
        return bilinear_sample_rows_plain(img, coords_rows, out_hw)
    return _BilinearSampleRows.apply(img, coords_rows, tuple(out_hw))
