"""Bilinear sampling at an (N, Ho, Wo, 2) coordinate grid: the Hopper
kernels that stand for catgen's first three sampler generations, and their
plain PyTorch version.

``bilinear_sample_grid(img, coords)`` samples an NHWC image at normalized
(y, x) coordinates ``(N, Ho, Wo, 2)`` with edge-clamped bilinear
interpolation (align-corners) and returns ``(N, Ho, Wo, C)``,
differentiable with respect to both inputs. It is the function of catgen's
``bilinear_sample`` (its ``xla`` route) and of the three TPU kernels that
v4 superseded, under their public names here:

  * ``bilinear_sample_mxu``: v1, ``catgen/kernels/pallas_bilinear.py``
    (a dense one-hot matrix times the image);
  * ``bilinear_sample_sep``: v2, ``pallas_bilinear_v2.py`` (separable
    A img B^T);
  * ``bilinear_sample_batched``: v3, ``pallas_bilinear_v3.py`` (v2
    batched over the block, bf16 operands on the TPU).

They differ only in how they fed the TPU's matrix unit. On Hopper each is
the v4 gather kernels instantiated for the grid layout
(``csrc/bilinear_sample.cu``, ``csrc/bilinear_sample_bwd.cu``): one load
of the (y, x) pair per pixel (8 bytes in f32, 4 in bf16), d_coords
written as (dy, dx) pairs, no permute copy. In f32, or in bf16 as
``kernels/bilinear.py``'s kernels are: bf16 values, f32 arithmetic, each
result rounded once (v3's bf16 operand rounding is not copied, as v4's is
not). Their masks are inclusive, so the derivative on the edge itself is 1,
as v4's (``kernels/bilinear.py``); catgen's XLA sampler gives 0.5 there.

On a CUDA tensor each wrapper launches the kernels or raises; on CPU
tensors it runs ``bilinear_sample_grid_plain`` under autograd. Counters:
``LAUNCHES``, ``DCOORDS_LAUNCHES`` and ``DIMG_LAUNCHES`` count the f32
kernels and their ``BF16_`` twins the bf16 ones, ``V1_LAUNCHES``..
``V3_LAUNCHES`` the forwards taken under each generation's name
(``bilinear_sample_grid`` itself, catgen's ``xla`` route, counts in
neither).
"""

from __future__ import annotations

import torch

from catgen_torch.kernels.bilinear import (KERNEL_DTYPES, _check_grad,
                                           _entry, _launched,
                                           bilinear_sample_rows_plain,
                                           dimg_scratch)
from catgen_torch.kernels.build import load_library

COUNTERS = ("LAUNCHES", "DCOORDS_LAUNCHES", "DIMG_LAUNCHES", "V1_LAUNCHES",
            "V2_LAUNCHES", "V3_LAUNCHES", "BF16_LAUNCHES",
            "BF16_DCOORDS_LAUNCHES", "BF16_DIMG_LAUNCHES")
LAUNCHES = DCOORDS_LAUNCHES = DIMG_LAUNCHES = 0
V1_LAUNCHES = V2_LAUNCHES = V3_LAUNCHES = 0
BF16_LAUNCHES = BF16_DCOORDS_LAUNCHES = BF16_DIMG_LAUNCHES = 0


def reset_launches() -> None:
    for name in COUNTERS:
        globals()[name] = 0


def launches() -> dict:
    return {name: globals()[name] for name in COUNTERS}


def _count(name: str, dtype: torch.dtype = torch.float32) -> None:
    """Adds one to ``name``, or for a bf16 kernel to its ``BF16_`` twin."""
    globals()[name if dtype == torch.float32 else f"BF16_{name}"] += 1


def bilinear_sample_grid_plain(img: torch.Tensor,
                               coords: torch.Tensor) -> torch.Tensor:
    """Plain version: the coordinate rows' gathers and lerps on the grid's
    (y, x) pairs, in the input dtype (bf16: in f32, rounded once)."""
    n, ho, wo, _ = coords.shape
    rows = coords.reshape(n, ho * wo, 2).permute(0, 2, 1)
    return bilinear_sample_rows_plain(img, rows, (ho, wo))


def bilinear_sample_grid_backward_plain(img, coords, grad_out,
                                        need_img=True, need_coords=True):
    """Plain backward: (d_img, d_coords) of the plain version by autograd,
    each None where not asked for."""
    with torch.enable_grad():
        img = img.detach().requires_grad_(need_img)
        crd = coords.detach().requires_grad_(need_coords)
        out = bilinear_sample_grid_plain(img, crd)
        wrt = [t for t, need in ((img, need_img), (crd, need_coords)) if need]
        grads = iter(torch.autograd.grad(out, wrt, grad_out))
    return (next(grads) if need_img else None,
            next(grads) if need_coords else None)


def _check(img: torch.Tensor, coords: torch.Tensor) -> None:
    if img.dtype not in KERNEL_DTYPES or coords.dtype != img.dtype:
        raise TypeError(f"bilinear_sample_grid kernel takes float32 or "
                        f"bfloat16, the image and grid alike, got "
                        f"{img.dtype} and {coords.dtype}")
    if img.dim() != 4 or coords.dim() != 4 or coords.shape[-1] != 2 \
            or coords.shape[0] != img.shape[0]:
        raise ValueError(f"img must be (N, H, W, C) and coords (N, Ho, Wo, "
                         f"2), got {tuple(img.shape)} and "
                         f"{tuple(coords.shape)}")
    if not (img.is_contiguous() and coords.is_contiguous()):
        raise ValueError("bilinear_sample_grid kernel takes contiguous "
                         "tensors (NHWC image, (N, Ho, Wo, 2) grid)")
    if not (img.is_cuda and coords.is_cuda):
        raise ValueError(
            f"bilinear_sample_grid kernel needs CUDA tensors, got "
            f"{img.device} and {coords.device}")
    if img.device != coords.device:
        raise ValueError(f"img on {img.device}, coords on {coords.device}")
    if coords.data_ptr() % (2 * coords.element_size()):
        raise ValueError("bilinear_sample_grid kernel reads (y, x) as one "
                         "load: the grid must be aligned to a pair")


def launch(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Runs the forward kernel on the current stream; raises on bad inputs
    or a refused launch. Counts each launch in ``LAUNCHES`` (f32) or
    ``BF16_LAUNCHES``."""
    _check(img, coords)
    n, h, w, c = img.shape
    ho, wo = coords.shape[1:3]
    out = torch.empty((n, ho, wo, c), dtype=img.dtype, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _entry("sample_grid", img.dtype)(
            img.data_ptr(), coords.data_ptr(), out.data_ptr(), n, h, w, c,
            ho * wo, stream)
    _launched(err, "bilinear_sample_grid")
    _count("LAUNCHES", img.dtype)
    return out


def launch_dcoords(img: torch.Tensor, coords: torch.Tensor,
                   grad_out: torch.Tensor) -> torch.Tensor:
    """Runs the d_coords kernel: (N, Ho, Wo, 2), the gradient with respect
    to the grid, in its dtype. Counts each launch in ``DCOORDS_LAUNCHES``
    (f32) or ``BF16_DCOORDS_LAUNCHES``."""
    _check(img, coords)
    out_hw = tuple(coords.shape[1:3])
    _check_grad(img, grad_out, out_hw)
    n, h, w, c = img.shape
    dcrd = torch.empty_like(coords)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _entry("grid_dcoords", img.dtype)(
            img.data_ptr(), coords.data_ptr(), grad_out.data_ptr(),
            dcrd.data_ptr(), n, h, w, c, out_hw[0] * out_hw[1], stream)
    _launched(err, "bilinear_sample_grid d_coords")
    _count("DCOORDS_LAUNCHES", img.dtype)
    return dcrd


def launch_dimg(img: torch.Tensor, coords: torch.Tensor,
                grad_out: torch.Tensor) -> torch.Tensor:
    """Runs the d_img kernel: (N, H, W, C), the gradient with respect to
    the image (``img`` gives its shape, dtype and device), summed in f32
    and rounded once for bf16. Deterministic: no atomics. Counts each
    launch in ``DIMG_LAUNCHES`` (f32) or ``BF16_DIMG_LAUNCHES``."""
    _check(img, coords)
    out_hw = tuple(coords.shape[1:3])
    _check_grad(img, grad_out, out_hw)
    lib = load_library()
    n, h, w, c = img.shape
    p = out_hw[0] * out_hw[1]
    dimg = torch.empty_like(img)
    # the bf16 gather's f32 scratch (kernels/bilinear.py), held until the
    # launch
    part, part_ptr = dimg_scratch(img, p)
    scratch = () if img.dtype == torch.float32 else (part_ptr,)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _entry("grid_dimg", img.dtype)(
            coords.data_ptr(), grad_out.data_ptr(), dimg.data_ptr(),
            *scratch, n, h, w, c, p, stream)
    del part
    _launched(err, f"bilinear_sample_grid d_img (a block needs "
                   f"{lib.catgen_bilinear_dimg_smem_bytes(h, w, c)} bytes of "
                   f"shared memory)")
    _count("DIMG_LAUNCHES", img.dtype)
    return dimg


class _BilinearSampleGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, coords):
        ctx.save_for_backward(img, coords)
        return launch(img, coords)

    @staticmethod
    def backward(ctx, grad_out):
        img, coords = ctx.saved_tensors
        g = grad_out.contiguous()
        # no d_img work where the image is data
        d_img = (launch_dimg(img, coords, g)
                 if ctx.needs_input_grad[0] else None)
        d_crd = (launch_dcoords(img, coords, g)
                 if ctx.needs_input_grad[1] else None)
        return d_img, d_crd


def bilinear_sample_grid(img: torch.Tensor,
                         coords: torch.Tensor) -> torch.Tensor:
    """img (N, H, W, C); coords (N, Ho, Wo, 2) normalized (y, x). Returns
    (N, Ho, Wo, C). CPU tensors take the plain version; CUDA tensors take
    the kernels, forward and backward."""
    if img.device.type == "cpu" and coords.device.type == "cpu":
        return bilinear_sample_grid_plain(img, coords)
    return _BilinearSampleGrid.apply(img, coords)


def _generation(counter: str, img: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
    out = bilinear_sample_grid(img, coords)
    if img.device.type != "cpu":
        _count(counter)
    return out


def bilinear_sample_mxu(img: torch.Tensor,
                        coords: torch.Tensor) -> torch.Tensor:
    """catgen's v1 (``pallas_bilinear.py::bilinear_sample_mxu``): the grid
    kernels; counts in ``V1_LAUNCHES``. catgen's ``batch_tile`` and
    ``interpret`` arguments size and emulate TPU blocks and have no
    counterpart."""
    return _generation("V1_LAUNCHES", img, coords)


def bilinear_sample_sep(img: torch.Tensor,
                        coords: torch.Tensor) -> torch.Tensor:
    """catgen's v2 (``pallas_bilinear_v2.py::bilinear_sample_sep``): the
    grid kernels; counts in ``V2_LAUNCHES``."""
    return _generation("V2_LAUNCHES", img, coords)


def bilinear_sample_batched(img: torch.Tensor,
                            coords: torch.Tensor) -> torch.Tensor:
    """catgen's v3 (``pallas_bilinear_v3.py::bilinear_sample_batched``):
    the grid kernels; counts in ``V3_LAUNCHES``."""
    return _generation("V3_LAUNCHES", img, coords)
