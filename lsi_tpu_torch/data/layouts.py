"""Write directories in the published KITTI raw and SYNTHIA-SEQS layouts,
with synthetic scenes as their content.

No KITTI or SYNTHIA data ships with the repository. These writers give the
readers (``data.kitti``, ``data.synthia``) and the training CLI real files
to read at the datasets' own image sizes: each frame is a multi-object
scene of ``data.synthetic`` (source view as the left camera, target view
as the right), PNGs written with the standard library
(``evaluation.png.write_png``), so no image package is needed.

* KITTI raw (``write_kitti_raw``): ``<date>/calib_cam_to_cam.txt``
  (``P_rect_02``, ``P_rect_03``, ``R_rect_00``), ``calib_velo_to_cam.txt``
  and ``calib_imu_to_velo.txt``; per drive ``image_02`` and ``image_03``
  PNGs, OXTS packets of a car driving forward, and Velodyne scans on every
  other frame: the scene's depth at a sparse grid of pixels back-projected
  through the calibration, so the reader's LiDAR ground truth is the
  scene's own depth at those pixels.
* SYNTHIA-SEQS (``write_synthia_seqs``): ``RGB/Stereo_{Left,Right}/Omni_F``
  PNGs and ``Depth/Stereo_{Left,Right}/Omni_F`` 16-bit PNGs in
  centimetres.

``workers`` > 0 writes frames in that many spawned processes.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from lsi_tpu_torch.evaluation.png import write_png

KITTI_HW = (375, 1242)
KITTI_DATE = "2011_09_26"
# P_rect_02/03 of a 1242x375 KITTI rig (baseline 0.537 m), with the
# rectifying rotation and the LiDAR and IMU extrinsics of the same rig.
KITTI_CALIB_CAM = """calib_time: 09-Jan-2012 13:57:47
R_rect_00: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01
P_rect_02: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 0.000000e+00 7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 0.000000e+00 1.000000e+00 2.745884e-03
P_rect_03: 7.215377e+02 0.000000e+00 6.095593e+02 -3.395242e+02 0.000000e+00 7.215377e+02 1.728540e+02 2.199936e+00 0.000000e+00 0.000000e+00 1.000000e+00 2.729905e-03
"""
KITTI_CALIB_VELO = """calib_time: 15-Mar-2012 11:37:16
R: 7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 7.280733e-04 -9.998902e-01 9.998621e-01 7.523790e-03 1.480755e-02
T: -4.069766e-03 -7.631618e-02 -2.717806e-01
"""
KITTI_CALIB_IMU = """calib_time: 25-May-2012 16:47:16
R: 9.999976e-01 7.553071e-04 -2.035826e-03 -7.854027e-04 9.998898e-01 -1.482298e-02 2.024406e-03 1.482454e-02 9.998881e-01
T: -8.086759e-01 3.195559e-01 -7.997231e-01
"""
SYNTHIA_HW = (760, 1280)
SYNTHIA_SEQ = "SYNTHIA-SEQS-01-SUMMER"


def _u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _scene(seed: int, index: int, hw):
    from lsi_tpu_torch.data import synthetic

    return synthetic.scene_example("multi", seed, 0, index, hw[0], hw[1])


def _velodyne_points(depth: np.ndarray, proj: np.ndarray, stride: int = 4,
                     lines: int = 64) -> np.ndarray:
    """(N, 4) float32 [x, y, z, reflectance] in the Velodyne frame whose
    projection ``proj`` (3x4, Velodyne to the left colour camera) lands
    on a grid of pixels (``lines`` rows, every ``stride``-th column) at
    ``depth`` there."""
    h, w = depth.shape
    v, u = np.meshgrid(np.linspace(0, h - 1, lines).round().astype(np.int64),
                       np.arange(0, w, stride), indexing="ij")
    z = depth[v, u].astype(np.float64)
    # proj [X; 1] = A X + b = z [u, v, 1]  ->  X = A^-1 (z [u, v, 1] - b).
    rhs = z[..., None] * np.stack([u, v, np.ones_like(u)], -1) - proj[:, 3]
    x_velo = rhs @ np.linalg.inv(proj[:, :3]).T
    refl = np.full(x_velo.shape[:-1] + (1,), 0.5)
    return np.concatenate([x_velo, refl], -1).reshape(-1, 4).astype(
        np.float32)


def _kitti_frame(root: str, drive: str, seed: int, index: int, frame: int,
                 hw, velodyne: bool) -> None:
    ex = _scene(seed, index, hw)
    ddir = os.path.join(root, KITTI_DATE, drive)
    name = f"{frame:010d}"
    for cam, key in (("image_02", "src_image"), ("image_03", "trg_image")):
        write_png(os.path.join(ddir, cam, "data", name + ".png"),
                  _u8(ex[key]))
    # A car driving north at 1 m a frame (about 9e-6 degrees of latitude).
    lat = 49.0 + frame * np.rad2deg(1.0 / 6378137.0)
    vals = [lat, 8.43, 110.0, 0.0, 0.0, np.pi / 2] + [0.0] * 24
    with open(os.path.join(ddir, "oxts", "data", name + ".txt"), "w") as f:
        f.write(" ".join(f"{v:.12f}" for v in vals))
    if velodyne:
        from lsi_tpu_torch.data.kitti_velodyne import VelodyneDepth

        proj = VelodyneDepth().matrix_for(
            os.path.join(root, KITTI_DATE, "calib_cam_to_cam.txt"))
        depth = 1.0 / np.maximum(ex["gt_disparity"][..., 0], 1e-6)
        _velodyne_points(depth, proj).tofile(
            os.path.join(ddir, "velodyne_points", "data", name + ".bin"))


def _synthia_frame(root: str, seed: int, index: int, hw) -> None:
    ex = _scene(seed, index, hw)
    seq = os.path.join(root, SYNTHIA_SEQ)
    name = f"{index:06d}.png"
    for side, img, disp in (("Stereo_Left", "src_image", "gt_disparity"),
                            ("Stereo_Right", "trg_image",
                             "trg_gt_disparity")):
        write_png(os.path.join(seq, "RGB", side, "Omni_F", name),
                  _u8(ex[img]))
        depth_cm = 100.0 / np.maximum(ex[disp][..., 0], 1e-6)
        write_png(os.path.join(seq, "Depth", side, "Omni_F", name),
                  np.clip(depth_cm + 0.5, 0, 65535).astype(np.uint16))


def _run(jobs: List[tuple], workers: int) -> None:
    if workers <= 0:
        for fn, *args in jobs:
            fn(*args)
        return
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=mp.get_context("spawn")) as ex:
        for f in [ex.submit(fn, *args) for fn, *args in jobs]:
            f.result()


def write_kitti_raw(root: str, drives: int = 2, frames: int = 24,
                    hw=KITTI_HW, seed: int = 0,
                    workers: int = 0) -> List[str]:
    """A KITTI raw tree of ``drives`` drives of ``frames`` frames each at
    ``hw`` (KITTI's 375x1242 by default); returns the drive directories."""
    date_dir = os.path.join(root, KITTI_DATE)
    os.makedirs(date_dir, exist_ok=True)
    for name, text in (("calib_cam_to_cam.txt", KITTI_CALIB_CAM),
                       ("calib_velo_to_cam.txt", KITTI_CALIB_VELO),
                       ("calib_imu_to_velo.txt", KITTI_CALIB_IMU)):
        with open(os.path.join(date_dir, name), "w") as f:
            f.write(text)
    jobs, dirs = [], []
    for d in range(drives):
        drive = f"{KITTI_DATE}_drive_{d + 1:04d}_sync"
        dirs.append(os.path.join(date_dir, drive))
        for sub in ("image_02", "image_03", "oxts", "velodyne_points"):
            os.makedirs(os.path.join(date_dir, drive, sub, "data"),
                        exist_ok=True)
        for i in range(frames):
            jobs.append((_kitti_frame, root, drive, seed, d * frames + i, i,
                         tuple(hw), i % 2 == 0))
    _run(jobs, workers)
    return dirs


def write_synthia_seqs(root: str, frames: int = 16, hw=SYNTHIA_HW,
                       seed: int = 0, workers: int = 0) -> str:
    """A SYNTHIA-SEQS sequence of ``frames`` frames at ``hw`` (SYNTHIA's
    760x1280 by default); returns the sequence directory."""
    seq = os.path.join(root, SYNTHIA_SEQ)
    for kind in ("RGB", "Depth"):
        for side in ("Stereo_Left", "Stereo_Right"):
            os.makedirs(os.path.join(seq, kind, side, "Omni_F"),
                        exist_ok=True)
    _run([(_synthia_frame, root, seed, i, tuple(hw)) for i in range(frames)],
         workers)
    return seq


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m lsi_tpu_torch.data.layouts")
    ap.add_argument("kind", choices=("kitti", "synthia"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--drives", type=int, default=None,
                    help="KITTI drives (default 2); the SYNTHIA layout is "
                    "one sequence and refuses it")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    if args.kind == "kitti":
        write_kitti_raw(args.out, 2 if args.drives is None else args.drives,
                        args.frames, seed=args.seed, workers=args.workers)
    elif args.drives is not None:
        ap.error("--drives applies to the kitti layout only")
    else:
        write_synthia_seqs(args.out, args.frames, seed=args.seed,
                           workers=args.workers)
    print(f"wrote a {args.kind} layout to {args.out}")


if __name__ == "__main__":
    main()
