"""Forward bilinear splat: the CUDA kernel's wrapper.

The kernel is ``lsi_tpu_torch/csrc/splat_fwd.cu`` (hand-written for
sm_90a, bound through ctypes). It replaces the TPU kernel
``lsi_tpu/kernels/splat_pallas.py:_splat_kernel`` with the exact,
unwindowed semantics of ``ops/splat.splat_bilinear``; the source note says
what bounds it on the card and what the design does about it.

A tensor on the CPU takes the plain version (``ops/splat.py``); a CUDA
tensor launches the kernel, and a failed build or launch raises. There is
no fallback from one to the other.
"""

from __future__ import annotations

import torch

from lsi_tpu_torch.kernels import build
from lsi_tpu_torch.ops.splat import splat_bilinear


def _check(values: torch.Tensor, coords: torch.Tensor,
           weights: torch.Tensor, out_hw) -> None:
    if values.ndim != 4:
        raise ValueError(f"values must be (N, Hs, Ws, C), got {tuple(values.shape)}")
    n, hs, ws, c = values.shape
    want = {"coords": (n, hs, ws, 2), "weights": (n, hs, ws, 1)}
    for name, t in (("coords", coords), ("weights", weights)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    for name, t in (("values", values), ("coords", coords),
                    ("weights", weights)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != values.device:
            raise ValueError(f"{name} is on {t.device}, values on {values.device}")
    if not 1 <= c <= 8:
        raise ValueError(f"the kernel takes 1..8 channels, got {c}")
    out_h, out_w = out_hw
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"out_hw must be positive, got {out_hw}")


def splat(values: torch.Tensor, coords: torch.Tensor, weights: torch.Tensor,
          out_hw):
    """Forward-splat ``values`` into an ``out_hw`` image.

    Args:
      values:  (N, Hs, Ws, C) float32, C in 1..8; layers may be folded into
        Hs, the targets come from ``coords`` alone.
      coords:  (N, Hs, Ws, 2) float32 target pixel [x, y].
      weights: (N, Hs, Ws, 1) float32.
      out_hw:  (out_h, out_w).
    Returns:
      accum (N, out_h, out_w, C) and wsum (N, out_h, out_w, 1), float32.
    """
    _check(values, coords, weights, out_hw)
    if values.device.type == "cpu":
        return splat_bilinear(values, coords, weights, out_hw)
    if values.device.type != "cuda":
        raise ValueError(f"splat runs on cpu or cuda, not {values.device}")

    n, hs, ws, c = values.shape
    out_h, out_w = (int(v) for v in out_hw)
    accum = torch.zeros((n, out_h, out_w, c), dtype=torch.float32,
                        device=values.device)
    wsum = torch.zeros((n, out_h, out_w, 1), dtype=torch.float32,
                       device=values.device)
    lib = build.load("splat_fwd")
    with torch.cuda.device(values.device):
        err = lib.lsi_splat_fwd(
            values.data_ptr(), coords.data_ptr(), weights.data_ptr(),
            accum.data_ptr(), wsum.data_ptr(), n, hs, ws, c, out_h, out_w,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"splat_fwd launch failed: cudaError {err}")
    splat.launches += 1
    return accum, wsum


#: Kernel launches made through :func:`splat` (CPU calls do not count).
splat.launches = 0
