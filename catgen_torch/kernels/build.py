"""Builds the port's CUDA sources into one shared library and loads it.

Every ``catgen_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
process for Hopper (``sm_90a``), all of them at once, and the objects are
linked into ``catgen_torch/_build/libcatgen_torch_<hash>.so``, a library
with a plain C interface that the kernel wrappers call through ``ctypes``.
The file name carries a hash of the sources, the headers they include
(``csrc/*.cuh``) and the flags, so an edited source builds anew and an
unchanged one is reused. The build runs at first use, never at import: the
CPU tests import every module on machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# --fmad=false: the lerps round like the plain PyTorch version's separate
# multiplies and adds (the upsample-conv kernels' inner products call
# fmaf, which the flag does not split); -Xptxas=-v writes registers and
# spills to the log.
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# (name, argument types, return type) of every C entry point
SIGNATURES = (
    *((f"catgen_bilinear_sample_{layout}_{t}", [_P, _P, _P] + [_I] * 5 + [_P],
       _I) for layout in ("rows", "grid") for t in ("f32", "bf16")),
    *((f"catgen_bilinear_{layout}dcoords_{t}", [_P] * 4 + [_I] * 5 + [_P],
       _I) for layout in ("", "grid_") for t in ("f32", "bf16")),
    *((f"catgen_bilinear_{layout}dimg_f32", [_P] * 3 + [_I] * 5 + [_P], _I)
      for layout in ("", "grid_")),
    # the bf16 d_img also takes the f32 scratch of the gather's passes
    *((f"catgen_bilinear_{layout}dimg_bf16", [_P] * 4 + [_I] * 5 + [_P], _I)
      for layout in ("", "grid_")),
    ("catgen_bilinear_dimg_smem_bytes", [_I] * 3, _I64),
    ("catgen_bilinear_dimg_gather_pixels", [], _I),
    # (h, w, c, element size in bytes)
    ("catgen_bilinear_dcoords_kind", [_I] * 4, _I),
    ("catgen_bilinear_forward_kind", [_I] * 4, _I),
    ("catgen_bilinear_dimg_kind", [_I] * 4, _I),
    ("catgen_st_conv_prelu_f32", [_P] * 6 + [_I] + [_P] * 3 + [_I] * 5
     + [_P], _I),
    # the bf16 entry also takes whether the tensor-core kernel runs (kmat
    # then f32, which it packs itself)
    ("catgen_st_conv_prelu_bf16", [_P] * 6 + [_I] + [_P] * 3 + [_I] * 6
     + [_P], _I),
    ("catgen_upsample_conv_partial_rows", [_I, _I, _I], _I),
    ("catgen_upsample_conv_fwd_f32", [_P] * 4 + [_I] + [_P] * 6 + [_I] * 11
     + [_P], _I),
    # the bf16 forward and dCK take no input transform or fold: the bf16
    # block runs them as passes of their own (transform, fold); the
    # forward takes the box of x its TMA kernel loads (or zeros)
    ("catgen_upsample_conv_fwd_bf16", [_P] * 4 + [_I] + [_P] * 3
     + [_I] * 14 + [_P], _I),
    ("catgen_upsample_conv_dck_splits", [_I] * 7, _I),
    *((f"catgen_upsample_conv_{k}", [_P] * 11 + [_I] * 11 + [_P], _I)
      for k in ("dx_f32", "dx_bf16", "dck_f32")),
    ("catgen_upsample_conv_dck_bf16", [_P] * 4 + [_I] * 11 + [_P], _I),
    ("catgen_upsample_conv_fold_rows", [_I, _I], _I),
    ("catgen_upsample_conv_transform_bf16", [_P] * 5 + [_I] * 2 + [_P], _I),
    ("catgen_upsample_conv_fold_bf16", [_P] * 6 + [_I] * 2 + [_P], _I),
)


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC_DIR.glob("*.cuh"))


def find_nvcc() -> str:
    """nvcc from CUDA_HOME (as PyTorch's cpp_extension resolves it, the
    toolkit's default prefix included), else from PATH."""
    from torch.utils import cpp_extension

    candidates = []
    if cpp_extension.CUDA_HOME:
        candidates.append(os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME unset and no nvcc on PATH): the port's "
        "CUDA kernels are compiled from catgen_torch/csrc at first use and "
        "need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcatgen_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds, log: list) -> None:
    """Runs the commands at once and waits for all; appends their output
    to ``log``; raises RuntimeError naming the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outputs = [p.communicate() for p in procs]
    log.extend(o + e for o, e in outputs)
    for cmd, p, (o, e) in zip(cmds, procs, outputs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}: "
                               f"{' '.join(cmd)}\n{o}{e}")


def build_library() -> Path:
    """Compiles the sources (one nvcc each, in parallel) and links them,
    unless a library of the same hash exists. Raises RuntimeError with
    nvcc's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    log: list = []
    try:
        _run_all([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources(), objects)], log)
        _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)]],
                 log)
        os.replace(tmp, out)   # atomic: a loader never sees half a file
    finally:
        out.with_suffix(".log").write_text("".join(log))
        for path in objects + [tmp]:
            path.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library, with argument and return types declared."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes, restype in SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
