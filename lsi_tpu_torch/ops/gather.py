"""Bilinear gather (inverse warp): the plain PyTorch version.

PyTorch counterpart of ``lsi_tpu/ops/gather.py``. It is the CPU path of
``kernels.gather_cuda`` (K4) and the reference the CUDA kernels are held
against on the card. Semantics of the JAX lax path: zeros outside the
image (an out-of-image corner has zero weight and a clamped read), an
in-bounds ``valid`` mass, and NO fraction snap (unlike the splat).
"""

from __future__ import annotations

import torch

from lsi_tpu_torch.ops.splat import corner_reads


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor):
    """Sample ``image`` at real-valued pixel coordinates (differentiable in
    both, through the bilinear fractions; the floor carries no gradient).

    Args:
      image:  (N, H, W, C).
      coords: (N, Ho, Wo, 2) pixel [x, y] in the image's frame (pixel
        centres at integers).
    Returns:
      sampled (N, Ho, Wo, C), 0 outside the image, in ``image``'s dtype;
      valid (N, Ho, Wo, 1) float32, the bilinear weight that fell inside
      the image (1 fully inside, 0 fully outside).
    """
    n, h, w, c = image.shape
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def inb(xi, yi):
        return (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)

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

