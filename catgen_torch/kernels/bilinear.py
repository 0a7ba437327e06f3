"""Bilinear sampling at coordinate rows: the Hopper kernel and its plain
PyTorch version.

``bilinear_sample_rows(img, coords_rows, out_hw)`` samples an NHWC image at
normalized (y; x) coordinate rows ``(N, 2, Ho*Wo)`` with edge-clamped
bilinear interpolation (align-corners: -1 is pixel 0, +1 is pixel size-1)
and returns ``(N, Ho, Wo, C)``. It is the counterpart of
``catgen/kernels/pallas_bilinear_v4.py::bilinear_sample_rows``; the CUDA
kernel is ``catgen_torch/csrc/bilinear_sample.cu``.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs ``bilinear_sample_rows_plain``, the gather-and-lerp formulation of
``catgen/nn/spatial_transformer.py::bilinear_sample``. The kernel is
forward only: its backward belongs to the training slice.
"""

from __future__ import annotations

import torch

from catgen_torch.kernels.build import load_library

# Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0


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


def launch(img: torch.Tensor, coords_rows: torch.Tensor,
           out_hw) -> torch.Tensor:
    """Runs the CUDA kernel on the current stream; raises on bad inputs or
    a refused launch. Counts each launch in ``LAUNCHES``."""
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
    if err != 0:
        raise RuntimeError(f"bilinear_sample_rows kernel launch failed: "
                           f"cudaError_t {err}")
    LAUNCHES += 1
    return out


class _BilinearSampleRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, coords_rows, out_hw):
        return launch(img, coords_rows, out_hw)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the CUDA bilinear sampler has no backward yet: it is ROADMAP "
            "Queue B item 2 (the v4 sampler backward, training slice)")


def bilinear_sample_rows(img: torch.Tensor, coords_rows: torch.Tensor,
                         out_hw) -> torch.Tensor:
    """img (N, H, W, C); coords_rows (N, 2, Ho*Wo) normalized (y; x) rows.
    Returns (N, Ho, Wo, C). CPU tensors take the plain version; CUDA
    tensors take the kernel."""
    if img.device.type == "cpu" and coords_rows.device.type == "cpu":
        return bilinear_sample_rows_plain(img, coords_rows, out_hw)
    return _BilinearSampleRows.apply(img, coords_rows, tuple(out_hw))
