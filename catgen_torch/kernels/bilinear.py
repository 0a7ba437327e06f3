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

Two element types, as catgen's compute dtype: float32, and bfloat16 with
image, coordinates and gradients in bf16. The bf16 kernels (the same
kernels instantiated for ``__nv_bfloat16``) and the plain version alike
compute in f32 from the bf16 values and round each result once, to
nearest even: the output, d_img (an f32 sum, as v4's) and d_coords (in the
coordinates' dtype). The forward's bits are the plain version's; the
backward's differ only where two f32 sums of another order round apart.
Launches are counted per element type: ``LAUNCHES``, ``DCOORDS_LAUNCHES``
and ``DIMG_LAUNCHES`` for f32, ``BF16_LAUNCHES``,
``BF16_DCOORDS_LAUNCHES`` and ``BF16_DIMG_LAUNCHES`` for bf16.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from catgen_torch.kernels.build import load_library

# Launches of each CUDA kernel since import (or since a caller reset them),
# f32 and bf16 instantiations apart.
LAUNCHES = 0              # forward
DCOORDS_LAUNCHES = 0      # backward, d_coords
DIMG_LAUNCHES = 0         # backward, d_img
BF16_LAUNCHES = BF16_DCOORDS_LAUNCHES = BF16_DIMG_LAUNCHES = 0
COUNTERS = ("LAUNCHES", "DCOORDS_LAUNCHES", "DIMG_LAUNCHES", "BF16_LAUNCHES",
            "BF16_DCOORDS_LAUNCHES", "BF16_DIMG_LAUNCHES")

# the kernels' element types and the suffix of their C entry points
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for name in COUNTERS:
        globals()[name] = 0


def launches() -> dict:
    return {name: globals()[name] for name in COUNTERS}


def count(name: str, dtype: torch.dtype) -> None:
    """Adds one to the f32 counter ``name`` or to its bf16 twin."""
    key = name if dtype == torch.float32 else f"BF16_{name}"
    globals()[key] += 1


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
    """Plain version: four gathers and three lerps, in the input dtype; a
    bf16 input is computed in f32 and the output rounded once to bf16 (the
    bf16 kernels' arithmetic). Under autograd the casts make the bf16
    gradients f32 sums rounded once too."""
    if img.dtype == torch.bfloat16:
        return _sample_rows(img.float(), coords_rows.float(),
                            out_hw).to(torch.bfloat16)
    return _sample_rows(img, coords_rows, out_hw)


def _sample_rows(img: torch.Tensor, coords_rows: torch.Tensor,
                 out_hw) -> torch.Tensor:
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
    if img.dtype not in KERNEL_DTYPES or coords_rows.dtype != img.dtype:
        raise TypeError(f"bilinear_sample_rows kernel takes float32 or "
                        f"bfloat16, the image and coordinates alike, got "
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
    if grad_out.dtype != img.dtype:
        raise TypeError(f"bilinear sampler backward takes a gradient of the "
                        f"image's dtype {img.dtype}, got {grad_out.dtype}")
    if tuple(grad_out.shape) != want or not grad_out.is_contiguous():
        raise ValueError(f"the sampled output's gradient must be a "
                         f"contiguous {want}, got {tuple(grad_out.shape)}")
    if grad_out.device != img.device:
        raise ValueError(f"gradient on {grad_out.device}, img on "
                         f"{img.device}")


def _entry(name: str, dtype: torch.dtype):
    """The C entry point ``catgen_bilinear_<name>_<f32|bf16>``."""
    return getattr(load_library(),
                   f"catgen_bilinear_{name}_{KERNEL_DTYPES[dtype]}")


def dimg_scratch(img: torch.Tensor, p: int):
    """The f32 scratch of a bf16 gather d_img that takes more than one pass
    over its ``p`` output pixels per sample (the running sums between
    passes), as an address for the C entry point; None (0) otherwise."""
    n, h, w, c = img.shape
    if (img.dtype != torch.bfloat16 or dimg_kind(h, w, c, img.dtype)
            != "gather"
            or p <= load_library().catgen_bilinear_dimg_gather_pixels()):
        return None, 0
    part = torch.empty(img.shape, dtype=torch.float32, device=img.device)
    return part, part.data_ptr()


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def launch(img: torch.Tensor, coords_rows: torch.Tensor,
           out_hw) -> torch.Tensor:
    """Runs the forward kernel on the current stream; raises on bad inputs
    or a refused launch. Counts each launch in ``LAUNCHES`` (f32) or
    ``BF16_LAUNCHES``."""
    _check(img, coords_rows, out_hw)
    n, h, w, c = img.shape
    ho, wo = out_hw
    out = torch.empty((n, ho, wo, c), dtype=img.dtype, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _entry("sample_rows", img.dtype)(
            img.data_ptr(), coords_rows.data_ptr(), out.data_ptr(),
            n, h, w, c, ho * wo, stream)
    _launched(err, "bilinear_sample_rows")
    count("LAUNCHES", img.dtype)
    return out


def launch_dcoords(img: torch.Tensor, coords_rows: torch.Tensor,
                   grad_out: torch.Tensor, out_hw) -> torch.Tensor:
    """Runs the d_coords kernel: (N, 2, P), the gradient with respect to
    the coordinate rows, in their dtype. Counts each launch in
    ``DCOORDS_LAUNCHES`` (f32) or ``BF16_DCOORDS_LAUNCHES``."""
    _check(img, coords_rows, out_hw)
    _check_grad(img, grad_out, out_hw)
    n, h, w, c = img.shape
    dcrd = torch.empty_like(coords_rows)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _entry("dcoords", img.dtype)(
            img.data_ptr(), coords_rows.data_ptr(), grad_out.data_ptr(),
            dcrd.data_ptr(), n, h, w, c, out_hw[0] * out_hw[1], stream)
    _launched(err, "bilinear sampler d_coords")
    count("DCOORDS_LAUNCHES", img.dtype)
    return dcrd


DCOORDS_KINDS = ("per_pixel", "per_warp", "staged", "per_quad")
FORWARD_KINDS = ("per_pixel", "per_value", "staged", "per_quad")
DIMG_KINDS = ("per_channel", "per_sample", "gather")
# the card's opt-in shared memory per block (H100), for the host-side plans
OPTIN_SMEM = 232448


def dcoords_quad_smem_bytes(h: int, w: int, c: int) -> int:
    """Shared memory of a block of the bf16 per-quad d_coords kernel at an
    (h, w, c) image, as bilinear_sample_bwd.cu (``quad_smem_bytes``)
    computes it: the sample's image as it lies, rounded to 16 bytes, and
    its copy widened to 8-byte groups of 4 channels."""
    return (h * w * c * 2 + 15) // 16 * 16 + h * w * ((c + 3) // 4) * 8


def _kind(h: int, w: int, c: int, dtype: torch.dtype, names,
          entry: str) -> str:
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the sampler kernels take float32 or bfloat16, not "
                        f"{dtype}")
    code = getattr(load_library(), entry)(h, w, c, dtype.itemsize)
    if code < 0:
        raise RuntimeError(f"reading the card's shared memory failed: "
                           f"cudaError_t {-code}")
    return names[code]


def dcoords_kind(h: int, w: int, c: int,
                 dtype: torch.dtype = torch.float32) -> str:
    """Which d_coords kernel an (h, w, c) image of ``dtype`` takes on the
    current card (16-byte aligned arrays): for c < 32 ``per_quad`` in bf16
    where h*w*c values fill whole 16-byte vectors and the image with its
    widened copy fits a block's shared memory
    (``dcoords_quad_smem_bytes``: a block per sample, a thread per 4
    neighbouring output pixels), else ``per_pixel`` (every f32 c < 32
    too); for c >= 32 ``staged`` (the image in shared memory: a pixel's c
    values fill whole 16-byte vectors, c % 4 == 0 in f32 and c % 8 == 0
    in bf16, and it fits) or ``per_warp``. The per-quad kernel also needs
    the image, coordinates, gradient and output 16-byte aligned, and
    takes ``per_pixel``'s place only where they are."""
    return _kind(h, w, c, dtype, DCOORDS_KINDS,
                 "catgen_bilinear_dcoords_kind")


def forward_kind(h: int, w: int, c: int,
                 dtype: torch.dtype = torch.float32) -> str:
    """Which forward kernel an (h, w, c) image of ``dtype`` takes on the
    current card, rows or grid layout, with 16-byte aligned arrays: for c
    >= 32 the d_coords kernels' rule, ``staged`` (whole 16-byte vectors
    per pixel and the image fits shared memory) or ``per_value``
    (unaligned arrays take it too); for c < 32 ``per_quad`` (the image
    staged in shared memory, a thread per group of neighbouring output
    pixels, 4 in f32 and 8 in bf16, whose coordinates fill a 16-byte
    vector: h*w*c values fill whole 16-byte vectors and the image fits)
    or ``per_pixel`` (unaligned arrays take it too)."""
    return _kind(h, w, c, dtype, FORWARD_KINDS,
                 "catgen_bilinear_forward_kind")


def dimg_kind(h: int, w: int, c: int,
              dtype: torch.dtype = torch.float32) -> str:
    """Which d_img kernel an (h, w, c) image of ``dtype`` takes on the
    current card, rows or grid layout: ``per_sample`` (c < 32 and four
    h*w*c slabs of f32 sums fit one block's shared memory: a block per
    sample, one slab per warp), else ``gather`` (a block per sample
    buckets its output pixels' taps by input pixel, then sums each input
    pixel's bin in order; images up to 79x79), else ``per_channel`` (a
    block per sample and slab of 32 channels). The sums are f32 for both
    element types, so the choice does not depend on ``dtype``."""
    return _kind(h, w, c, dtype, DIMG_KINDS, "catgen_bilinear_dimg_kind")


def launch_dimg(img: torch.Tensor, coords_rows: torch.Tensor,
                grad_out: torch.Tensor, out_hw) -> torch.Tensor:
    """Runs the d_img kernel: (N, H, W, C), the gradient with respect to
    the image (``img`` gives its shape, dtype and device; its values are
    not read), summed in f32 and rounded once for bf16. Deterministic: no
    atomics. Counts each launch in ``DIMG_LAUNCHES`` (f32) or
    ``BF16_DIMG_LAUNCHES``."""
    _check(img, coords_rows, out_hw)
    _check_grad(img, grad_out, out_hw)
    lib = load_library()
    n, h, w, c = img.shape
    p = out_hw[0] * out_hw[1]
    dimg = torch.empty_like(img)
    # the bf16 entry points take the scratch's address (0: none), held
    # until the launch; the caching allocator orders its reuse after the
    # kernel on this stream
    part, part_ptr = dimg_scratch(img, p)
    scratch = () if img.dtype == torch.float32 else (part_ptr,)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _entry("dimg", img.dtype)(
            coords_rows.data_ptr(), grad_out.data_ptr(), dimg.data_ptr(),
            *scratch, n, h, w, c, p, stream)
    del part
    # a block holds up to 8 slabs of h*w*c floats (per sample), 8 cursors
    # per input pixel and 1024 output pixels' entries and weights (gather)
    # or h*w*min(c, 32) floats (per channel); an image too large for the
    # card's shared memory is refused with cudaErrorInvalidValue
    _launched(err, f"bilinear sampler d_img (a block needs "
                   f"{lib.catgen_bilinear_dimg_smem_bytes(h, w, c)} bytes of "
                   f"shared memory)")
    count("DIMG_LAUNCHES", img.dtype)
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
