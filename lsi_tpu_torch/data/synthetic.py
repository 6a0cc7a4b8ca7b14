"""Synthetic two-plane stereo scenes (numpy).

A copy of the two-plane generator of ``lsi_tpu/data/synthetic.py`` (the
port imports nothing of the JAX package): a textured background plane and
a textured foreground rectangle at distinct depths, both views rendered
analytically with correct occlusion. The same seed gives byte-identical
scenes in both packages (``tests/test_torch_train.py`` holds them equal).
The multi-object family (``kind="multi"``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticScene:
    src_image: np.ndarray      # (H, W, 3) float32
    trg_image: np.ndarray      # (H, W, 3) float32
    intrinsics: np.ndarray     # (3, 3) float32
    pose_src2trg: np.ndarray   # (4, 4) float32
    gt_disparity_layers: np.ndarray  # (2, H, W) float32 (fg-visible, bg)
    gt_visible_disparity: np.ndarray  # (H, W) float32 (layer 0 / nearest)
    gt_trg_disparity: np.ndarray  # (H, W) float32, visible in the target


def _lin_weights(n_out: int, cells: int) -> np.ndarray:
    """(n_out, cells) bilinear-upsample weight matrix (rows sum to 1)."""
    pos = np.linspace(0, cells - 1, n_out).astype(np.float32)
    i0 = np.floor(pos).astype(np.int32)
    i1 = np.minimum(i0 + 1, cells - 1)
    f = pos - i0
    a = np.zeros((n_out, cells), np.float32)
    rows = np.arange(n_out)
    a[rows, i0] += 1.0 - f
    a[rows, i1] += f
    return a


def _texture(rng: np.random.Generator, h: int, w: int, cells: int = 8):
    """Smooth random colour texture (upsampled low-res noise), as a
    separable bilinear upsample in two small GEMMs."""
    low = rng.uniform(0.05, 0.95, (cells, cells, 3)).astype(np.float32)
    ay = _lin_weights(h, cells)
    ax = _lin_weights(w, cells)
    tmp = np.tensordot(ay, low, axes=(1, 0))            # (h, cells, 3)
    out = np.tensordot(tmp, ax, axes=(1, 1))            # (h, 3, w)
    return np.ascontiguousarray(out.transpose(0, 2, 1))


def _render_view(bg_tex, fg_tex, fg_box, bg_depth, fg_depth, K, tx, h, w):
    """Analytic view of a 2-plane scene from a camera translated by tx.

    Planes are fronto-parallel; a camera at x-offset tx sees plane content
    shifted by fx * tx / depth. The foreground occludes the background.
    """
    fx = K[0, 0]
    xs = np.arange(w, dtype=np.float32)

    def sample_plane(tex, depth):
        # pixel x in this camera sees plane texture at x + fx*tx/depth of
        # the canonical (tx=0) frame.
        shift = fx * tx / depth
        src_x = xs + shift
        x0 = np.floor(src_x).astype(int)
        f = src_x - x0
        x0c = np.clip(x0, 0, w - 1)
        x1c = np.clip(x0 + 1, 0, w - 1)
        return ((1 - f)[None, :, None] * tex[:, x0c]
                + f[None, :, None] * tex[:, x1c]), src_x

    img, _ = sample_plane(bg_tex, bg_depth)
    disp = np.full((h, w), 1.0 / bg_depth, np.float32)

    fg_img, src_x = sample_plane(fg_tex, fg_depth)
    y0, y1, x0b, x1b = fg_box
    # The foreground rectangle is defined in canonical-frame coordinates; a
    # pixel shows foreground iff its fg-plane lookup lands inside the box.
    in_box = np.broadcast_to((src_x >= x0b) & (src_x < x1b), (h, w)).copy()
    in_box[:y0] = False
    in_box[y1:] = False
    img = np.where(in_box[..., None], fg_img, img)
    disp = np.where(in_box, 1.0 / fg_depth, disp)
    return img.astype(np.float32), disp


def make_scene(rng: np.random.Generator, height: int, width: int,
               baseline: float = 0.3) -> SyntheticScene:
    """Sample one two-plane stereo scene."""
    h, w = height, width
    fx = 0.95 * w
    K = np.array([[fx, 0, (w - 1) / 2], [0, fx, (h - 1) / 2], [0, 0, 1]],
                 np.float32)

    bg_depth = float(rng.uniform(8.0, 14.0))
    fg_depth = float(rng.uniform(2.5, 5.0))
    bg_tex = _texture(rng, h, w)
    fg_tex = _texture(rng, h, w, cells=5)

    y0 = int(rng.integers(0, h // 3))
    y1 = int(rng.integers(2 * h // 3, h))
    x0 = int(rng.integers(0, w // 3))
    x1 = int(rng.integers(2 * w // 3, w))
    box = (y0, y1, x0, x1)

    src_img, src_disp = _render_view(bg_tex, fg_tex, box, bg_depth, fg_depth,
                                     K, 0.0, h, w)
    trg_img, trg_disp = _render_view(bg_tex, fg_tex, box, bg_depth, fg_depth,
                                     K, baseline, h, w)

    # src -> trg pose: the target camera at +baseline along x sees points
    # moved by -baseline.
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = -baseline

    gt_layers = np.stack([src_disp,
                          np.full((h, w), 1.0 / bg_depth, np.float32)])
    return SyntheticScene(
        src_image=src_img, trg_image=trg_img, intrinsics=K,
        pose_src2trg=pose, gt_disparity_layers=gt_layers,
        gt_visible_disparity=src_disp, gt_trg_disparity=trg_disp)


def scene_example(kind: str, seed: int, epoch: int, index: int,
                  height: int, width: int) -> dict:
    """One example dict of numpy arrays, seeded by (seed, epoch, index)
    alone, so the stream does not depend on how it is produced."""
    if kind != "two_plane":
        raise NotImplementedError(
            f"synthetic scene kind {kind!r} is not ported yet (ROADMAP "
            "Queue 1, M7: the 'multi' scenes)")
    rng = np.random.default_rng(
        np.random.SeedSequence([seed & 0xFFFFFFFF, epoch, index]))
    s = make_scene(rng, height, width)
    ones = np.ones((height, width, 1), np.float32)
    return {
        "src_image": s.src_image,
        "trg_image": s.trg_image,
        "intrinsics": s.intrinsics,
        "pose_src2trg": s.pose_src2trg,
        "gt_disparity": s.gt_visible_disparity[..., None],
        "gt_valid": ones,
        "trg_gt_disparity": s.gt_trg_disparity[..., None],
        "trg_gt_valid": ones,
    }
