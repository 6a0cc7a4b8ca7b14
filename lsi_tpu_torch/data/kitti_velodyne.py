"""KITTI velodyne LiDAR -> sparse GT depth maps for evaluation.

A copy of ``lsi_tpu/data/kitti_velodyne.py`` (numpy only), owned by the
port.

Capability parity with the reference's KITTI depth evaluation (SURVEY.md
§3.4: "depth metrics for layer-0 vs LiDAR/GT"): loads the raw ``.bin``
point clouds shipped with KITTI-raw drives
(``<drive>/velodyne_points/data/*.bin``, float32 x,y,z,reflectance), chains
the standard calibration (``calib_velo_to_cam.txt`` R|T, then
``calib_cam_to_cam.txt`` R_rect_00 and P_rect_02) to project points into
the rectified left color camera, and rasterizes a sparse inverse-depth map
at the training resolution. The result feeds the existing
``gt_disparity``/``gt_valid`` batch fields, so ``evaluation/runner.py``
reports abs_rel/δ-thresholds for KITTI checkpoints unchanged.

Projection chain (KITTI devkit convention):
    X_cam0 = R_velo2cam @ X_velo + t_velo2cam        (unrectified cam-0)
    X_rect = R_rect_00 @ X_cam0                      (rectified frame)
    [u, v, 1]^T * z = P_rect_02 @ [X_rect, 1]^T      (left color image)
Depth for the disparity map is ``z`` after P_rect_02 (the rectified z plus
the camera-2 baseline shift along x does not change z).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def load_velodyne(path: str) -> np.ndarray:
    """Read a KITTI velodyne scan: (N, 4) float32 [x, y, z, reflectance]."""
    pts = np.fromfile(path, dtype=np.float32)
    return pts.reshape(-1, 4)


def parse_velo_to_cam(path: str) -> np.ndarray:
    """Parse calib_velo_to_cam.txt -> (4, 4) homogeneous velo->cam0."""
    vals: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, val = line.split(":", 1)
            try:
                vals[key.strip()] = np.asarray(
                    [float(v) for v in val.split()], np.float64)
            except ValueError:
                continue
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = vals["R"].reshape(3, 3)
    T[:3, 3] = vals["T"]
    return T


def velo_to_image_matrix(calib_cam: Dict[str, np.ndarray],
                         velo_to_cam: np.ndarray) -> np.ndarray:
    """(3, 4) matrix taking homogeneous velodyne points to image coords
    (u*z, v*z, z) of the rectified left color camera (camera 2)."""
    R_rect = np.eye(4, dtype=np.float64)
    R_rect[:3, :3] = calib_cam["R_rect_00"].reshape(3, 3)
    P2 = calib_cam["P_rect_02"].reshape(3, 4)
    return (P2 @ R_rect @ velo_to_cam).astype(np.float64)


def project_to_disparity(points: np.ndarray, proj: np.ndarray,
                         orig_hw: Tuple[int, int],
                         out_hw: Tuple[int, int],
                         min_depth: float = 1e-3,
                         max_depth: float = 120.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Rasterize a velodyne scan into a sparse inverse-depth map.

    Args:
      points: (N, >=3) velodyne-frame points.
      proj: (3, 4) velo->image matrix (:func:`velo_to_image_matrix`).
      orig_hw: native image size the calibration refers to.
      out_hw: output (training) resolution; projected pixels are scaled.
      min_depth/max_depth: depth validity range (meters).

    Returns:
      (disparity (H, W, 1) f32 = 1/depth_m, valid (H, W, 1) f32). Where
      several points land in one output pixel the NEAREST wins (hard
      z-buffer — matches how LiDAR GT is conventionally rasterized; sparse
      maps leave valid=0 elsewhere).
    """
    oh, ow = orig_hw
    out_h, out_w = out_hw
    xyz1 = np.concatenate(
        [points[:, :3], np.ones((points.shape[0], 1), points.dtype)], axis=1)
    uvz = xyz1 @ proj.T  # (N, 3)
    z = uvz[:, 2]
    keep = z > min_depth
    uvz, z = uvz[keep], z[keep]
    u = uvz[:, 0] / z * (out_w / ow)
    v = uvz[:, 1] / z * (out_h / oh)
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    keep = ((ui >= 0) & (ui < out_w) & (vi >= 0) & (vi < out_h)
            & (z < max_depth))
    ui, vi, z = ui[keep], vi[keep], z[keep]

    depth = np.full((out_h, out_w), np.inf, np.float32)
    flat = vi * out_w + ui
    # nearest-point-wins: sort by depth descending, later (nearer) writes win
    order = np.argsort(-z)
    depth.reshape(-1)[flat[order]] = z[order].astype(np.float32)
    valid = np.isfinite(depth)
    disparity = np.where(valid, 1.0 / np.maximum(depth, min_depth),
                         0.0).astype(np.float32)
    return disparity[..., None], valid.astype(np.float32)[..., None]


def velodyne_path_for_image(image_path: str) -> str:
    """Map ``.../image_02/data/0000000005.png`` to the drive's
    ``velodyne_points/data/0000000005.bin`` (empty string if absent)."""
    data_dir = os.path.dirname(image_path)          # .../image_02/data
    drive_dir = os.path.dirname(os.path.dirname(data_dir))
    frame = os.path.splitext(os.path.basename(image_path))[0]
    cand = os.path.join(drive_dir, "velodyne_points", "data", frame + ".bin")
    return cand if os.path.exists(cand) else ""


class VelodyneDepth:
    """Cached per-date calibration + scan->disparity rasterizer."""

    def __init__(self):
        self._proj_cache: Dict[str, np.ndarray] = {}

    def matrix_for(self, calib_cam_path: str) -> np.ndarray:
        date_dir = os.path.dirname(calib_cam_path)
        if date_dir not in self._proj_cache:
            from lsi_tpu_torch.data.kitti import parse_calib_cam_to_cam
            velo_calib = os.path.join(date_dir, "calib_velo_to_cam.txt")
            self._proj_cache[date_dir] = velo_to_image_matrix(
                parse_calib_cam_to_cam(calib_cam_path),
                parse_velo_to_cam(velo_calib))
        return self._proj_cache[date_dir]

    def disparity_for(self, image_path: str, calib_cam_path: str,
                      orig_hw: Tuple[int, int], out_hw: Tuple[int, int]):
        """(disparity, valid) for an image's scan, or None if no scan /
        no velo calibration exists for the drive."""
        bin_path = velodyne_path_for_image(image_path)
        if not bin_path:
            return None
        velo_calib = os.path.join(os.path.dirname(calib_cam_path),
                                  "calib_velo_to_cam.txt")
        if not os.path.exists(velo_calib):
            return None
        return project_to_disparity(
            load_velodyne(bin_path), self.matrix_for(calib_cam_path),
            orig_hw, out_hw)
