"""Builds the port's CUDA sources into one shared library and loads it.

Every ``catgen_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``catgen_torch/_build/libcatgen_torch_<hash>.so``, a
library with a plain C interface that the kernel wrappers call through
``ctypes``. The file name carries a hash of the sources and the flags, so
an edited source builds anew and an unchanged one is reused. The build
runs at first use, never at import: the CPU tests import every module on
machines without a CUDA toolkit.
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
# multiplies and adds; -Xptxas=-v writes registers and spills to the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcatgen_torch_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compiles the sources unless a library of the same hash exists.
    Raises RuntimeError with nvcc's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library, with argument and return types declared."""
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.catgen_bilinear_sample_rows_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
