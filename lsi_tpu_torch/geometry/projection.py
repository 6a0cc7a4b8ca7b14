"""Projective camera geometry: intrinsics and the fused forward projection.

PyTorch counterpart of ``lsi_tpu/geometry/projection.py`` (the parts the
render path uses). Conventions: pixel centers at integer coordinates,
``coords[..., 0] = x`` (column), ``coords[..., 1] = y`` (row); disparity is
inverse depth.
"""

from __future__ import annotations

import torch

from lsi_tpu_torch.geometry.transforms import matmul_f32, matvec_f32

# Guard for depth==0 / disparity==0 inversions; render code masks z<=MIN_DEPTH.
MIN_DEPTH = 1e-6


def intrinsics_matrix(fx, fy, cx, cy, device=None) -> torch.Tensor:
    """Assemble (..., 3, 3) K from (broadcastable) focal lengths / centers."""
    fx, fy, cx, cy = (torch.as_tensor(v, dtype=torch.float32, device=device)
                      for v in (fx, fy, cx, cy))
    fx, fy, cx, cy = torch.broadcast_tensors(fx, fy, cx, cy)
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    rows = [torch.stack([fx, zero, cx], -1),
            torch.stack([zero, fy, cy], -1),
            torch.stack([zero, zero, one], -1)]
    return torch.stack(rows, -2)


def scale_intrinsics(K: torch.Tensor, scale_x: float,
                     scale_y: float) -> torch.Tensor:
    """Rescale K for an image resized by (scale_x, scale_y)
    (align-corners=False: x -> x * s + (s - 1) / 2)."""
    fx = K[..., 0, 0] * scale_x
    fy = K[..., 1, 1] * scale_y
    cx = K[..., 0, 2] * scale_x + (scale_x - 1.0) / 2.0
    cy = K[..., 1, 2] * scale_y + (scale_y - 1.0) / 2.0
    return intrinsics_matrix(fx, fy, cx, cy)


def invert_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form K^-1 for an axis-aligned pinhole K (no skew)."""
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    return intrinsics_matrix(1.0 / fx, 1.0 / fy, -cx / fx, -cy / fy)


def disparity_to_depth(disparity: torch.Tensor) -> torch.Tensor:
    return 1.0 / disparity.clamp_min(MIN_DEPTH)


def depth_to_disparity(depth: torch.Tensor) -> torch.Tensor:
    return 1.0 / depth.clamp_min(MIN_DEPTH)


def forward_project(disparity: torch.Tensor, K_src: torch.Tensor,
                    K_trg: torch.Tensor, pose_src2trg: torch.Tensor,
                    row_offset: int = 0):
    """Per-pixel source->target correspondence for a disparity map.

    The chain unproject -> rigid transform -> project collapses to
        uvw = A @ [x, y, 1] + b * d,   A = K_t R K_s^-1,  b = K_t t
    (homogeneous coordinates scaled by 1/z): per pixel, 9 multiply-adds on
    broadcast rows of A. The 3x3 algebra runs once per batch element in
    exact float32.

    Args:
      disparity: (B, H, W, 1) source-frame inverse depth.
      K_src, K_trg: (B, 3, 3).
      pose_src2trg: (B, 4, 4).
      row_offset: global row index of this tensor's first row.
    Returns:
      trg_coords (B, H, W, 2) target pixel [x, y]; trg_disparity
      (B, H, W, 1); valid (B, H, W, 1) float32, 1 where the point lies in
      front of the target camera.
    """
    _, h, w, _ = disparity.shape
    dev = disparity.device
    d = disparity[..., 0].float()

    rot = pose_src2trg[..., :3, :3].float()
    t = pose_src2trg[..., :3, 3].float()
    K_trg = K_trg.float()
    A = matmul_f32(matmul_f32(K_trg, rot), invert_intrinsics(K_src.float()))
    bvec = matvec_f32(K_trg, t)  # (B, 3)

    x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    y = (torch.arange(h, dtype=torch.float32, device=dev)
         + row_offset)[None, :, None]

    def row(i):
        a = A[:, i, :, None, None]  # (B, 3, 1, 1)
        return (a[:, 0] * x + a[:, 1] * y + a[:, 2]
                + bvec[:, i, None, None] * d)

    u = row(0)
    v = row(1)
    zscale = row(2)  # = z_trg * d  (z_trg / z_src)

    # Clamp the denominator: where zscale ~ 0 the coordinates become huge
    # (up to ~1e6 * |u|) but stay finite; those pixels carry valid = 0.
    denom = torch.where(zscale.abs() > MIN_DEPTH, zscale,
                        torch.full_like(zscale, MIN_DEPTH))
    trg_coords = torch.stack([u / denom, v / denom], dim=-1)
    valid = (zscale > MIN_DEPTH).float()
    trg_disparity = (d / denom) * valid
    return trg_coords, trg_disparity[..., None], valid[..., None]
