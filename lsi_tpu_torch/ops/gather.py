"""Bilinear gather (inverse warp): the plain PyTorch version.

PyTorch counterpart of ``lsi_tpu/ops/gather.py``. It is the CPU path of
``kernels.gather_cuda`` (K4) and the reference the CUDA kernels are held
against on the card. Semantics of the JAX lax path: zeros outside the
image (an out-of-image corner has zero weight and a clamped read), an
in-bounds ``valid`` mass, and NO fraction snap (unlike the splat).

With ``max_dy >= 0`` it is the TPU kernel's gather instead
(``lsi_tpu/kernels/gather_pallas.py:gather_pallas_diff``, K4-W): the
fractions snapped (``ops.splat.snap_fraction``, so the coordinate gradient
is 0 in a snap zone) and every corner outside the vertical window of its
row's base row dropped from ``sampled`` and ``valid``. That is the
transpose of the windowed splat (``ops.splat.splat_bilinear`` with
``max_dy_window``) of ``[g, 1]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from lsi_tpu_torch.ops.splat import corner_reads, snap_fraction


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor,
                    max_dy: int = -1, fold_h: Optional[int] = None):
    """Sample ``image`` at real-valued pixel coordinates (differentiable in
    both, through the bilinear fractions; the floor carries no gradient).

    Args:
      image:  (N, H, W, C).
      coords: (N, Ho, Wo, 2) pixel [x, y] in the image's frame (pixel
        centres at integers).
      max_dy: -1 (the default) samples exactly. ``max_dy >= 0`` snaps the
        fractions and drops every corner whose row ``yi`` has ``yi - base``
        outside ``[-max_dy, max_dy + 1]``, ``base = r % fold_h`` for
        coordinate row r (``fold_h`` defaults to H: layers folded into the
        rows sample around their own row).
    Returns:
      sampled (N, Ho, Wo, C), 0 outside the image, in ``image``'s dtype;
      valid (N, Ho, Wo, 1) float32, the bilinear weight that fell inside
      the image (1 fully inside, 0 fully outside) and the window.
    """
    n, h, w, c = image.shape
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    window = max_dy >= 0
    if window:
        fx = snap_fraction(fx)
        fy = snap_fraction(fy)
        base = (torch.arange(coords.shape[1], device=coords.device)
                % (h if fold_h is None else fold_h)).float()[None, :, None]

    def inb(xi, yi):
        ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        if window:
            ok &= (yi - base >= -max_dy) & (yi - base <= max_dy + 1)
        return ok

    # Corner weights, zeroed where the corner is outside the image.
    w00 = (1.0 - fx) * (1.0 - fy) * inb(x0, y0)
    w01 = fx * (1.0 - fy) * inb(x0 + 1, y0)
    w10 = (1.0 - fx) * fy * inb(x0, y0 + 1)
    w11 = fx * fy * inb(x0 + 1, y0 + 1)

    out_shape = tuple(coords.shape[:-1]) + (c,)
    reads = [r.reshape(out_shape) for r in corner_reads(
        image, x0.reshape(n, -1), y0.reshape(n, -1))]
    dt = image.dtype
    sampled = (reads[0] * w00[..., None].to(dt)
               + reads[1] * w01[..., None].to(dt)
               + reads[2] * w10[..., None].to(dt)
               + reads[3] * w11[..., None].to(dt))
    valid = (w00 + w01 + w10 + w11)[..., None]
    return sampled, valid

