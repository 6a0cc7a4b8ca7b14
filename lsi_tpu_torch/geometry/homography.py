"""Plane-induced homography warping (the layered-plane / plane-sweep
baselines).

PyTorch counterpart of ``lsi_tpu/geometry/homography.py``: the homography
induced by a 3D plane between two views, the warp of an image through it,
and the plane-sweep volume. The warp holds to the JAX package's lax path
(``ops/gather.bilinear_sample``: no vertical window, no fraction snap); it
goes through ``kernels.gather_cuda.GatherFn``, so a CUDA tensor launches
the gather kernel (K4) and a CPU tensor takes the plain gather.

The 3x3 algebra and the per-pixel projective map are written as
multiply-adds in float32, never TF32 (the reference runs them at
``precision="highest"``).
"""

from __future__ import annotations

import torch

from lsi_tpu_torch.geometry.projection import invert_intrinsics
from lsi_tpu_torch.geometry.transforms import matmul_f32
from lsi_tpu_torch.kernels.gather_cuda import GatherFn

# Floor on |z| of the mapped homogeneous coordinate. Not sign-preserving:
# a |z| below it becomes +DENOM_FLOOR (as in the reference), and those
# entries carry no gradient.
DENOM_FLOOR = 1e-8


def plane_homography(K_src: torch.Tensor, K_trg: torch.Tensor,
                     pose_src2trg: torch.Tensor, normal_src: torch.Tensor,
                     depth: torch.Tensor) -> torch.Tensor:
    """Homography mapping *target* pixels to *source* pixels for a plane.

    The plane is {X : n^T X = d} in the source frame (``normal_src``
    (..., 3) unit normal, ``depth`` (...) plane offset d > 0; a
    fronto-parallel plane at depth z0 is n = (0, 0, 1), d = z0). For X_s on
    the plane, X_t = (R + t n^T / d) X_s, so the source->target homography
    is K_t (R + t n^T / d) K_s^-1; this returns its inverse, (..., 3, 3)
    with [x_s, y_s, 1]^T ~ H [x_t, y_t, 1]^T.

    The inverse skips the singularity check (no host sync): a degenerate
    plane gives non-finite entries, as in the reference.
    """
    rot = pose_src2trg[..., :3, :3].float()
    t = pose_src2trg[..., :3, 3].float()
    n = normal_src.float()[..., None, :]
    d = depth.float()[..., None, None]
    h_st = matmul_f32(matmul_f32(K_trg.float(), rot + t[..., :, None] * n / d),
                      invert_intrinsics(K_src.float()))
    return torch.linalg.inv_ex(h_st).inverse


def homography_coords(homography_t2s: torch.Tensor, out_hw) -> torch.Tensor:
    """Source pixel coordinates of every target pixel: (N, Ho, Wo, 2)
    [x, y] for (N, 3, 3) homographies, the mapped z floored at
    :data:`DENOM_FLOOR`."""
    oh, ow = (int(v) for v in out_hw)
    dev = homography_t2s.device
    hm = homography_t2s.float()
    x = torch.arange(ow, dtype=torch.float32, device=dev)[None, None, :]
    y = torch.arange(oh, dtype=torch.float32, device=dev)[None, :, None]

    def row(i):
        a = hm[:, i, :, None, None]  # (N, 3, 1, 1)
        return a[:, 0] * x + a[:, 1] * y + a[:, 2]

    z = row(2)
    denom = torch.where(z.abs() < DENOM_FLOOR,
                        torch.full_like(z, DENOM_FLOOR), z)
    return torch.stack([row(0) / denom, row(1) / denom], dim=-1)


def homography_warp(image_src: torch.Tensor, homography_t2s: torch.Tensor,
                    out_hw=None):
    """Warp a source image into the target view through a homography.

    Args:
      image_src: (B, H, W, C), sampled in float32.
      homography_t2s: (B, 3, 3) mapping target pixels -> source pixels.
      out_hw: (Ho, Wo); defaults to the source size.
    Returns:
      warped (B, Ho, Wo, C) (0 outside the source) and valid
      (B, Ho, Wo, 1), the in-image bilinear mass; float32, differentiable
      in the image and the homography.
    """
    if out_hw is None:
        out_hw = image_src.shape[1:3]
    coords = homography_coords(homography_t2s, out_hw)
    return GatherFn.apply(image_src.float().contiguous(), coords.contiguous())


def plane_sweep_volume(image_src: torch.Tensor, K_src: torch.Tensor,
                       K_trg: torch.Tensor, pose_trg2src: torch.Tensor,
                       depths: torch.Tensor, out_hw=None):
    """Warp the source image to the target view through D fronto-parallel
    planes of the *target* camera (``depths`` (D,), target frame).

    The D warps share the source image, so their coordinates are folded
    into the rows of one gather.

    Returns volume (B, D, Ho, Wo, C) and valid (B, D, Ho, Wo, 1).
    """
    b, h, w, c = image_src.shape
    d = depths.shape[0]
    oh, ow = (h, w) if out_hw is None else (int(v) for v in out_hw)

    def rep(m):
        return m.float().repeat_interleave(d, dim=0)

    normal = torch.tensor([0.0, 0.0, 1.0], device=image_src.device).expand(
        b * d, 3)
    # The plane lives in the target frame: plane_homography with the roles
    # swapped gives source -> target, whose inverse is target -> source.
    h_t2s = torch.linalg.inv_ex(plane_homography(
        rep(K_trg), rep(K_src), rep(pose_trg2src), normal,
        depths.float().repeat(b))).inverse
    coords = homography_coords(h_t2s, (oh, ow)).reshape(b, d * oh, ow, 2)
    volume, valid = GatherFn.apply(image_src.float().contiguous(),
                                   coords.contiguous())
    return (volume.reshape(b, d, oh, ow, c), valid.reshape(b, d, oh, ow, 1))
