"""ctypes binding of the native JPEG decoder: the counterpart of
``catgen/data/native_decode.py``.

``catgen_torch/native/fastimage.cpp`` (a copy of catgen's
``native/fastimage.cpp``) decodes a batch of JPEGs with libjpeg on a pool
of worker threads and resizes each to the cache's size (bilinear, align
corners). It is built with the host's C++ compiler at first use into
``catgen_torch/_build/libfastimage_<hash>.so``; the hash covers the source
and the flags, so an edited source builds anew. ``load`` raises
``ImportError`` when no compiler or libjpeg is present; the loader then
falls back to PIL and says so (``ImageDataset.decoder_used``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "fastimage.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"

# catgen's native/Makefile flags: -std=c++17 keeps GCC from contracting
# the resize's multiplies and adds into FMAs, so both libraries round alike
COMPILE_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
                 "-shared")
LINK_FLAGS = ("-ljpeg", "-lpthread")
ABI_VERSION = 1


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastimage_{h.hexdigest()[:16]}.so"


def find_compiler() -> str:
    """$CXX, else g++ or c++ on PATH."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise ImportError("no C++ compiler (CXX, g++, c++) to build the native "
                      "decoder")


def build_library() -> Path:
    """Compiles the decoder unless a library of the same hash exists.
    Raises ImportError with the compiler's output when the build fails
    (no libjpeg headers, say)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_compiler(), *COMPILE_FLAGS, str(SOURCE), "-o", str(tmp),
           *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise ImportError(f"cannot build the native decoder "
                              f"({' '.join(cmd)}): "
                              f"{(proc.stdout + proc.stderr).strip()}")
        os.replace(tmp, out)    # atomic: a loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library, its entry points typed and its ABI checked."""
    lib = ctypes.CDLL(str(build_library()))
    lib.fi_decode_batch.restype = ctypes.c_int
    lib.fi_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int]
    lib.fi_abi_version.restype = ctypes.c_int
    if lib.fi_abi_version() != ABI_VERSION:
        raise ImportError(f"native decoder ABI {lib.fi_abi_version()}, "
                          f"expected {ABI_VERSION}")
    return lib


def decode_batch_checked(paths: Sequence[str], size: int,
                         threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Decodes JPEGs into (n, size, size, 3) uint8 on ``threads`` workers
    (0: one per core) and returns them with the per-file ok mask. Files
    that fail to decode come back zero-filled, their mask False."""
    lib = load()
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    ok = np.empty((n,), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.fi_decode_batch(
        c_paths, n, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads)
    return out, ok.astype(bool)
