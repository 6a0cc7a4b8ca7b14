"""SYNTHIA sequences dataset (synthetic driving; has GT depth).

Capability parity with the reference's SYNTHIA loader (``lsi/data/syn/…``):
indexes SYNTHIA-SEQS sequence directories, loads stereo RGB pairs plus the
ground-truth depth of the source view (enabling direct depth supervision and
occluded-content evaluation — the capability KITTI lacks), and streams
(src, trg, K, pose, gt_disparity) examples. Expected layout::

    <root>/SYNTHIA-SEQS-*/RGB/Stereo_Left/Omni_F/*.png
    <root>/SYNTHIA-SEQS-*/RGB/Stereo_Right/Omni_F/*.png
    <root>/SYNTHIA-SEQS-*/Depth/Stereo_Left/Omni_F/*.png

SYNTHIA camera constants (1280x760 rig): focal 532.740352 px, principal
point (640, 380), stereo baseline 0.8 m; depth PNGs encode centimeters in
uint16 (SYNTHIA-SEQS release convention).

A copy of ``lsi_tpu/data/synthia.py`` owned by the port, with the
intrinsics' rescaling in numpy float32 (``kitti.scale_intrinsics``).
Images and depth maps are decoded by the native loader where it builds,
else by PIL, in that order, as the JAX reader does; :data:`DECODED`
counts which decoder served each file.
"""

from __future__ import annotations

import collections
import glob
import os
from typing import Iterator, List

import numpy as np

from lsi_tpu_torch.config import DataConfig
from lsi_tpu_torch.data.kitti import _to_wire_u8, scale_intrinsics

#: Files decoded so far, by decoder: "native" or "pil" for the images,
#: "native_depth16" or "pil_depth16" for the depth maps.
DECODED: collections.Counter = collections.Counter()

FOCAL_PX = 532.740352
CX, CY = 640.0, 380.0
BASELINE_M = 0.8
NATIVE_W, NATIVE_H = 1280, 760


def default_intrinsics() -> np.ndarray:
    return np.array([[FOCAL_PX, 0, CX], [0, FOCAL_PX, CY], [0, 0, 1]],
                    np.float32)


def index_sequences(root: str) -> List[dict]:
    records = []
    if not os.path.isdir(root):
        return records
    for seq in sorted(glob.glob(os.path.join(root, "SYNTHIA-SEQS-*"))):
        ldir = os.path.join(seq, "RGB", "Stereo_Left", "Omni_F")
        rdir = os.path.join(seq, "RGB", "Stereo_Right", "Omni_F")
        ddir = os.path.join(seq, "Depth", "Stereo_Left", "Omni_F")
        drdir = os.path.join(seq, "Depth", "Stereo_Right", "Omni_F")
        if not os.path.isdir(ldir) or not os.path.isdir(rdir):
            continue
        for fname in sorted(os.listdir(ldir)):
            if not fname.endswith(".png"):
                continue
            rec = {
                "left": os.path.join(ldir, fname),
                "right": os.path.join(rdir, fname),
                "depth": os.path.join(ddir, fname),
                # right-camera GT depth = target-view GT for the
                # occluded-region evaluation (SURVEY.md §3.4)
                "depth_right": os.path.join(drdir, fname),
            }
            if os.path.exists(rec["right"]):
                records.append(rec)
    return records


def _load_rgb(path: str, height: int, width: int) -> np.ndarray:
    from lsi_tpu_torch import native
    if native.available():
        batch = native.load_batch([path], height, width, num_threads=1)
        if batch is not None and batch.max() > 0:
            DECODED["native"] += 1
            return batch[0]
    from PIL import Image
    img = Image.open(path).convert("RGB").resize((width, height),
                                                 Image.BILINEAR)
    DECODED["pil"] += 1
    return np.asarray(img, np.float32) / 255.0


def _load_depth_m(path: str, height: int, width: int) -> np.ndarray:
    """uint16 centimeters -> float meters, nearest-resized (no blending
    across depth edges)."""
    from lsi_tpu_torch import native
    arr = native.decode_depth16(path) if native.available() else None
    if arr is None:
        from PIL import Image
        img = Image.open(path)
        arr = np.asarray(img)
        DECODED["pil_depth16"] += 1
    else:
        DECODED["native_depth16"] += 1
    if arr.ndim == 3:  # some releases store depth in the R channel
        arr = arr[..., 0].astype(np.float32) * (65535.0 / 255.0)
    depth_m = arr.astype(np.float32) / 100.0
    idx_y = np.linspace(0, depth_m.shape[0] - 1, height).round().astype(int)
    idx_x = np.linspace(0, depth_m.shape[1] - 1, width).round().astype(int)
    return depth_m[idx_y][:, idx_x]


def example_stream(cfg: DataConfig, seed: int, repeat: bool
                   ) -> Iterator[dict]:
    records = index_sequences(cfg.root)
    if not records:
        raise FileNotFoundError(
            f"no SYNTHIA records under {cfg.root!r} — expected "
            "<root>/SYNTHIA-SEQS-*/RGB/Stereo_Left/Omni_F/*.png")
    # Hold out whole sequences (frame-level splits would leak near-dupes).
    from lsi_tpu_torch.data.splits import split_records
    records = split_records(
        records, lambda r: os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.dirname(r["left"])))),
        cfg.split, cfg.val_fraction)
    rng = np.random.default_rng(seed)

    K = scale_intrinsics(default_intrinsics()[None], cfg.width / NATIVE_W,
                         cfg.height / NATIVE_H)[0].astype(np.float32)

    while True:
        order = rng.permutation(len(records)) if cfg.augment else \
            np.arange(len(records))
        for i in order:
            rec = records[i]
            left = _load_rgb(rec["left"], cfg.height, cfg.width)
            right = _load_rgb(rec["right"], cfg.height, cfg.width)

            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = -BASELINE_M

            def depth_to_disp(path):
                if not os.path.exists(path):
                    return (np.zeros((cfg.height, cfg.width), np.float32),
                            np.zeros((cfg.height, cfg.width), bool))
                depth = _load_depth_m(path, cfg.height, cfg.width)
                valid = (depth > 0.1) & (depth < 1000.0)
                return (np.where(valid, 1.0 / np.maximum(depth, 0.1),
                                 0.0).astype(np.float32), valid)

            disp, valid = depth_to_disp(rec["depth"])
            trg_disp, trg_valid = depth_to_disp(rec.get("depth_right", ""))

            yield {
                "src_image": _to_wire_u8(left),
                "trg_image": _to_wire_u8(right),
                "intrinsics": K,
                "pose_src2trg": pose,
                "gt_disparity": disp[..., None],
                "gt_valid": valid[..., None].astype(np.float32),
                "trg_gt_disparity": trg_disp[..., None],
                "trg_gt_valid": trg_valid[..., None].astype(np.float32),
            }
        if not repeat:
            return
