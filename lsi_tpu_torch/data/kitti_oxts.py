"""KITTI OXTS ego-motion: camera-frame relative poses between frames.

A copy of ``lsi_tpu/data/kitti_oxts.py`` (numpy only), owned by the port.

Extends the stereo-pair loader with temporal pairs (frame t -> t+k of the
same camera), the training signal used by the monocular branch of this
model family. Implements the standard KITTI devkit chain:

    T_w<-imu(t)   from OXTS lat/lon/alt (Mercator) + roll/pitch/yaw
    T_cam<-imu    from calib_imu_to_velo.txt and calib_velo_to_cam.txt
    T_cam(t1)<-cam(t0) = T_cam<-imu @ T_imu(t1)<-w @ T_w<-imu(t0) @ T_imu<-cam

All math is plain numpy on the host (per-example, tiny).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

EARTH_RADIUS = 6378137.0


def _rotx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def oxts_to_world_pose(oxts: np.ndarray, scale: float) -> np.ndarray:
    """One OXTS record (>= 6 values: lat lon alt roll pitch yaw) ->
    (4, 4) T_world<-imu. `scale` = cos(lat0) of the sequence's first frame
    (shared across the drive so positions are consistent)."""
    lat, lon, alt, roll, pitch, yaw = oxts[:6]
    tx = scale * np.deg2rad(lon) * EARTH_RADIUS
    ty = scale * EARTH_RADIUS * np.log(
        np.tan(np.pi / 4.0 + np.deg2rad(lat) / 2.0))
    rot = _rotz(yaw) @ _roty(pitch) @ _rotx(roll)
    T = np.eye(4)
    T[:3, :3] = rot
    T[:3, 3] = [tx, ty, alt]
    return T


def parse_rigid_calib(path: str) -> np.ndarray:
    """Parse an 'R: ... T: ...' KITTI calib file into (4, 4)."""
    vals: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, raw = line.split(":", 1)
            try:
                vals[key.strip()] = np.asarray(
                    [float(v) for v in raw.split()], np.float64)
            except ValueError:
                continue
    T = np.eye(4)
    T[:3, :3] = vals["R"].reshape(3, 3)
    T[:3, 3] = vals["T"]
    return T


def cam_from_imu(date_dir: str) -> np.ndarray:
    """T_cam<-imu (rectified cam0 frame ~= cam2 up to baseline translation,
    which cancels in relative poses of the SAME camera)."""
    velo_from_imu = parse_rigid_calib(
        os.path.join(date_dir, "calib_imu_to_velo.txt"))
    cam_from_velo = parse_rigid_calib(
        os.path.join(date_dir, "calib_velo_to_cam.txt"))
    return cam_from_velo @ velo_from_imu


def load_oxts(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def relative_camera_pose(oxts_t0: np.ndarray, oxts_t1: np.ndarray,
                         cam_from_imu_T: np.ndarray,
                         scale: float) -> np.ndarray:
    """(4, 4) float32 pose mapping cam(t0) points into the cam(t1) frame."""
    w_from_imu0 = oxts_to_world_pose(oxts_t0, scale)
    w_from_imu1 = oxts_to_world_pose(oxts_t1, scale)
    imu1_from_imu0 = np.linalg.inv(w_from_imu1) @ w_from_imu0
    cam1_from_cam0 = (cam_from_imu_T @ imu1_from_imu0
                      @ np.linalg.inv(cam_from_imu_T))
    return cam1_from_cam0.astype(np.float32)


def mercator_scale(oxts_first: np.ndarray) -> float:
    return float(np.cos(np.deg2rad(oxts_first[0])))
