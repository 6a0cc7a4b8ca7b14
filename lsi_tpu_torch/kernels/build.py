"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each library is built from the sources under ``lsi_tpu_torch/csrc/`` at
first use, into ``lsi_tpu_torch/_build/`` (listed in ``.gitignore``), with
a plain C interface: no PyTorch headers, so a build takes seconds. Each
source compiles in its own nvcc process, all started together, and the
objects are linked into one shared library. The file name carries a hash
of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# Flags of each source's compile (``-c``); the link adds ``-shared``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int

# Library name -> (sources under csrc/, {C function: argtypes}).
LIBRARIES = {
    "splat_fwd": (("splat_fwd.cu", "splat_band.cu"), {
        # values, coords, weights, accum, wsum, n, src_h, src_w, channels,
        # out_h, out_w, snap, block_x, tile_h, smem_bytes, vec4, max_dy,
        # fold_h, base_offset, stream
        "lsi_splat_fwd": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _INT,
                          _I64, _I64, _INT, _INT, _INT, _INT, _INT, _INT,
                          _I64, _I64, _P],
        # values, coords, weights, accum, wsum, n, src_h, src_w, channels,
        # out_h, out_w, snap, max_dy, fold_h, base_offset, band_rows,
        # plane_stride, smem_bytes, vec4, stream
        "lsi_splat_band": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _INT,
                           _I64, _I64, _INT, _INT, _I64, _I64, _INT, _INT,
                           _INT, _INT, _P],
    }),
    # The deterministic splat (K1-D), a library of its own so that the
    # other libraries' sources, hashes and code stay as they were.
    "splat_sort": (("splat_sort.cu",), {
        # coords, keys, n, src_h, src_w, out_h, out_w, snap, max_dy,
        # fold_h, base_offset, stream
        "lsi_splat_sort_keys": [_P, _P, _I64, _I64, _I64, _I64, _I64, _INT,
                                _INT, _I64, _I64, _P],
        # values, coords, weights, sorted_keys, order, accum, wsum, n,
        # src_h, src_w, channels, out_h, out_w, snap, stream
        "lsi_splat_sort_sum": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                               _INT, _I64, _I64, _INT, _P],
    }),
    "splat_bwd": (("splat_bwd.cu",), {
        # values, coords, weights, g_accum, g_wsum, d_values, d_coords,
        # d_weights, n, src_h, src_w, channels, out_h, out_w, max_dy,
        # fold_h, base_offset, stream
        "lsi_splat_vjp": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                          _INT, _I64, _I64, _INT, _I64, _I64, _P],
        # image, coords, sampled, valid, n, src_h, src_w, channels, img_h,
        # img_w, row_groups, tile_rows, row_stride, max_dy, fold_h, stream
        "lsi_gather_fwd": [_P, _P, _P, _P, _I64, _I64, _I64, _INT, _I64,
                           _I64, _INT, _INT, _INT, _INT, _I64, _P],
        # image, coords, g_sampled, g_valid, d_coords, n, src_h, src_w,
        # channels, img_h, img_w, max_dy, fold_h, stream
        "lsi_gather_bwd_coords": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _INT,
                                  _I64, _I64, _INT, _I64, _P],
    }),
}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where ``name``'s library is (or will be) built, keyed on its sources."""
    sources, _ = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.encode())
        h.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _run(cmds, name: str) -> None:
    """Run the nvcc commands ``cmds`` all at once; raise on any failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        output = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"(rc {proc.returncode}) {' '.join(cmd)}\n{output}")
    if failed:
        raise RuntimeError(f"nvcc failed for {name}:\n" + "\n".join(failed))


def build(name: str) -> Path:
    """Compile ``name`` unless its library for these sources exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources, _ = LIBRARIES[name]
    nvcc = find_nvcc()
    # Compile into a private directory and link to a private file, then
    # rename: a concurrent build never sees a half-written library.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, Path(s).stem + ".o") for s in sources]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC_DIR / s)]
              for s, obj in zip(sources, objects)], name)
        lib = os.path.join(tmp, "lib.so")
        _run([[nvcc, "-shared", "-o", lib, *objects]], name)
        os.replace(lib, out)
    return out


def launch(library: str, function: str, device, *args) -> None:
    """Call ``function`` of ``library`` (built and loaded at first use) on
    ``device`` with ``args`` and that device's current stream; raise if
    the launch failed (the C entry points return cudaGetLastError())."""
    lib = load(library)
    with torch.cuda.device(device):
        err = getattr(lib, function)(
            *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{function} launch failed: cudaError {err}")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``name``, with every argtype declared."""
    lib = ctypes.CDLL(str(build(name)))
    for fn_name, argtypes in LIBRARIES[name][1].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
