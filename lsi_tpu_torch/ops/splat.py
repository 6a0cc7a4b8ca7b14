"""Forward bilinear splat (scatter-add): the plain PyTorch version.

PyTorch counterpart of ``lsi_tpu/ops/splat.py`` (``method="scatter"``, no
vertical window). It is the CPU path of ``kernels.splat_cuda.splat`` and
the reference the CUDA kernel is held against on the card.
"""

from __future__ import annotations

import torch

# Bilinear fractions within MIN_FRACTION of an integer are snapped to it
# (see snap_fraction).
MIN_FRACTION = 1e-4


def snap_fraction(f: torch.Tensor) -> torch.Tensor:
    """Snap bilinear fractions within MIN_FRACTION of 0/1 to exactly 0/1.

    float32 rounding of near-integer projected coordinates yields ~1e-5
    phantom fractions that the soft z-buffer's exp weights can amplify
    above a neighbouring pixel's own weight; snapping per axis removes them
    (same semantics as the JAX package and its numpy oracle).
    """
    f = torch.where(f < MIN_FRACTION, torch.zeros_like(f), f)
    return torch.where(f > 1.0 - MIN_FRACTION, torch.ones_like(f), f)


def splat_bilinear(values: torch.Tensor, coords: torch.Tensor,
                   weights: torch.Tensor, out_hw):
    """Forward-splat per-pixel values into a target image.

    Args:
      values:  (N, Hs, Ws, C) source values.
      coords:  (N, Hs, Ws, 2) target pixel [x, y] for each source pixel.
      weights: (N, Hs, Ws, 1) per-source-pixel weight.
      out_hw:  (out_h, out_w) target size.
    Returns:
      accum (N, out_h, out_w, C) float32 sum of ``w * frac * v`` and
      wsum (N, out_h, out_w, 1) float32 sum of ``w * frac``.
    """
    out_h, out_w = out_hw
    n, hs, ws, c = values.shape
    p = hs * ws
    dev = values.device

    w32 = weights.float().reshape(n, p, 1)
    payload = torch.cat([values.float().reshape(n, p, c) * w32, w32], dim=-1)

    x = coords[..., 0].float().reshape(n, p)
    y = coords[..., 1].float().reshape(n, p)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = snap_fraction(x - x0)
    fy = snap_fraction(y - y0)

    # Out-of-image corners go to one trash row past the end, sliced off
    # below. The bounds test is made in float, and only in-bounds
    # coordinates reach the integer conversion: projected coordinates reach
    # ~1e6 (and may be inf/nan), where a float->int cast is undefined.
    trash = n * out_h * out_w
    batch_off = (torch.arange(n, device=dev, dtype=torch.int64)
                 * (out_h * out_w))[:, None]
    zero = torch.zeros_like(x)
    idxs = []
    wts = []
    for dy, dx, frac in ((0, 0, (1.0 - fx) * (1.0 - fy)),
                         (0, 1, fx * (1.0 - fy)),
                         (1, 0, (1.0 - fx) * fy),
                         (1, 1, fx * fy)):
        xi = x0 + dx
        yi = y0 + dy
        inb = (xi >= 0) & (xi <= out_w - 1) & (yi >= 0) & (yi <= out_h - 1)
        lin = (batch_off
               + torch.where(inb, yi, zero).to(torch.int64) * out_w
               + torch.where(inb, xi, zero).to(torch.int64))
        idxs.append(torch.where(inb, lin, torch.full_like(lin, trash)))
        wts.append(frac * inb)

    idx = torch.stack(idxs).reshape(-1)                     # (4*N*P,)
    contrib = (payload[None] * torch.stack(wts)[..., None]).reshape(-1, c + 1)
    out = torch.zeros(trash + 1, c + 1, dtype=torch.float32, device=dev)
    out.index_add_(0, idx, contrib)
    out = out[:trash].reshape(n, out_h, out_w, c + 1)
    return out[..., :c], out[..., c:]
