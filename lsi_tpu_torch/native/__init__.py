"""ctypes binding and build of the native image loader (``loader.cc``).

``load_batch(paths, h, w)`` decodes and resizes a batch of PNG or JPEG
images on a C++ thread pool (libpng, libjpeg) straight into one float32
array. A copy of ``lsi_tpu/native/`` owned by the port, with the same C
interface and the same answers (``tests/test_torch_native_loader.py``).

The library is built at first use with one ``g++`` call into
``lsi_tpu_torch/_build/`` (listed in ``.gitignore``), beside the CUDA
kernels; its file name carries a hash of the source and flags, so an
edited source is rebuilt. Where the toolchain or the image libraries are
missing, every function returns None and :func:`build_error` says why:
the KITTI and SYNTHIA readers then decode with PIL, as the JAX package's
readers do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-ljpeg", "-lz", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ERROR = ""


def library_path() -> Path:
    """Where the library is (or will be) built, keyed on source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"liblsi_loader-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private file, then rename: a concurrent build never
    # sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", tmp, *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (rc {proc.returncode}): "
                               f"{proc.stderr.strip()[-2000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _ERROR
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            _ERROR = f"{type(e).__name__}: {e}"
            return None
        lib.lsi_load_batch.restype = ctypes.c_int
        lib.lsi_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.lsi_decode_image.restype = ctypes.c_int
        lib.lsi_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long]
        lib.lsi_decode_depth16.restype = ctypes.c_int
        lib.lsi_decode_depth16.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_long]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _get_lib() is not None


def build_error() -> str:
    """Why the library could not be built or loaded ("" if it was)."""
    _get_lib()
    return _ERROR


def load_batch(paths: List[str], out_h: int, out_w: int,
               num_threads: int = 8) -> Optional[np.ndarray]:
    """Decode and resize a batch: (N, H, W, 3) float32 in [0, 1], or None
    if the library is unavailable. Files that fail decode to zeros."""
    lib = _get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.zeros((n, out_h, out_w, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.lsi_load_batch(arr, n, out_h, out_w,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       num_threads)
    return out


def decode_image(path: str) -> Optional[np.ndarray]:
    """Decode one image at its own size to (H, W, 3) uint8, or None."""
    lib = _get_lib()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if not lib.lsi_decode_image(path.encode(), ctypes.byref(h),
                                ctypes.byref(w), None, 0):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    ok = lib.lsi_decode_image(
        path.encode(), ctypes.byref(h), ctypes.byref(w),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size)
    return out if ok else None


def decode_depth16(path: str) -> Optional[np.ndarray]:
    """Decode a 16-bit grayscale PNG to (H, W) uint16, or None."""
    lib = _get_lib()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if not lib.lsi_decode_depth16(path.encode(), ctypes.byref(h),
                                  ctypes.byref(w), None, 0):
        return None
    out = np.empty((h.value, w.value), np.uint16)
    ok = lib.lsi_decode_depth16(
        path.encode(), ctypes.byref(h), ctypes.byref(w),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size)
    return out if ok else None
