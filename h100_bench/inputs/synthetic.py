"""Synthetic stereo scenes (numpy): a frozen copy of the generators of
``lsi_tpu_torch/data/synthetic.py`` at commit ee70f4d (the whole file
below its docstring, unchanged), so that a change to the port's data
cannot change the benchmark's inputs.

* ``"two_plane"``: a textured background plane and a textured foreground
  rectangle at distinct depths, both views rendered analytically with
  correct occlusion;
* ``"multi"``: 2-4 textured boxes over a slanted background plane, the
  target camera under SE(3) jitter, rendered by exact ray-plane
  intersection.
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


# Multi-object scenes: 2-4 textured boxes at varying depths over a slanted
# background plane, observed under full SE(3) pose jitter (rotation too).
# Each view pixel casts its ray, intersects every plane analytically and
# keeps the nearest in-region hit.


def _euler_rotation(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float64)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float64)
    return (Rz @ Ry @ Rx).astype(np.float32)


def _bilinear_np(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Sample (H, W, C) texture at float pixel coords (clamped).

    Flat linear-index gathers: numpy's multi-array fancy indexing takes a
    slow pair-index path that dominated scene generation.
    """
    h, w = tex.shape[:2]
    u = np.clip(u.astype(np.float32), 0.0, w - 1.0)
    v = np.clip(v.astype(np.float32), 0.0, h - 1.0)
    u0 = u.astype(np.int32)          # == floor for non-negative coords
    v0 = v.astype(np.int32)
    u1 = np.minimum(u0 + 1, w - 1)
    v1 = np.minimum(v0 + 1, h - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    flat = tex.reshape(-1, tex.shape[-1])
    r0 = v0 * w
    r1 = v1 * w
    return ((1 - fv) * ((1 - fu) * flat[r0 + u0] + fu * flat[r0 + u1])
            + fv * ((1 - fu) * flat[r1 + u0] + fu * flat[r1 + u1]))


def _box_view_bbox(box, offset, K, R, t, h, w):
    """Integer view-image bbox (r0, r1, c0, c1) covering a fronto-parallel
    canonical plane patch (n=(0,0,1), z=offset, pixel rect ``box``) as seen
    from the view camera, or the full image if any corner is near/behind
    the camera. A planar quad projects to a quad; the corner bbox (+1 px
    bilinear margin) contains every pixel the patch can cover."""
    y0, y1, x0, x1 = box
    corners_pix = np.array([[x0, x0, x1, x1],
                            [y0, y1, y0, y1],
                            [1, 1, 1, 1]], np.float32)
    corners_c = offset * (np.linalg.inv(K).astype(np.float32) @ corners_pix)
    corners_v = R @ corners_c + t[:, None]          # (3, 4) view frame
    z = corners_v[2]
    if (z <= 1e-3).any():
        return 0, h, 0, w
    u = (K[0, 0] * corners_v[0] + K[0, 2] * z) / z
    v = (K[1, 1] * corners_v[1] + K[1, 2] * z) / z
    c0 = max(0, int(np.floor(u.min())) - 1)
    c1 = min(w, int(np.ceil(u.max())) + 2)
    r0 = max(0, int(np.floor(v.min())) - 1)
    r1 = min(h, int(np.ceil(v.max())) + 2)
    return r0, r1, c0, c1


def _render_planes(planes, K, pose_c2v, h, w, num_hit_layers=2):
    """Exact analytic render of plane set from the camera at pose_c2v.

    Each plane dict: {normal (3,), offset d (n.p = d), tex (H, W, 3),
    box (y0, y1, x0, x1) or None (infinite)}. Regions are defined in the
    CANONICAL camera's image (pixel rect of the plane's canonical
    projection). Returns (rgb, disparity of nearest hit, disparity of k-th
    hit for k < num_hit_layers).

    Host-side hot path (feeds the card): float32 throughout, box planes
    evaluated only inside their projected view bbox, visibility via two
    argmin passes (not a full sort), and each plane's texture sampled only
    at the pixels it wins.
    """
    R = pose_c2v[:3, :3].astype(np.float32)
    t = pose_c2v[:3, 3].astype(np.float32)
    Kinv = np.linalg.inv(K).astype(np.float32)
    fx, fy = np.float32(K[0, 0]), np.float32(K[1, 1])
    cx, cy = np.float32(K[0, 2]), np.float32(K[1, 2])

    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ Kinv.T  # view frame
    # canonical-frame ray: p_c = R^T (s * ray - t)
    rays_c = rays @ R  # == R^T applied to each ray
    t_c = (R.T @ t).astype(np.float32)
    rz = np.ascontiguousarray(rays[..., 2])

    num_p = len(planes)
    depth = np.full((num_p, h, w), np.inf, np.float32)
    plane_uv = [None] * num_p  # (r0, r1, c0, c1, u, v) per plane
    for pi, pl in enumerate(planes):
        if pl["box"] is None:
            r0, r1, c0, c1 = 0, h, 0, w
        else:
            r0, r1, c0, c1 = _box_view_bbox(
                pl["box"], np.float32(pl["offset"]), K, R, t, h, w)
            if r0 >= r1 or c0 >= c1:
                continue
        rc = rays_c[r0:r1, c0:c1]
        n = pl["normal"].astype(np.float32)
        denom = rc @ n
        denom = np.where(np.abs(denom) < 1e-9, np.float32(1e-9), denom)
        s = (np.float32(pl["offset"]) + n @ t_c) / denom
        z_view = s * rz[r0:r1, c0:c1]
        pz = s * rc[..., 2] - t_c[2]
        pzc = np.where(np.abs(pz) < 1e-9, np.float32(1e-9), pz)
        u = (fx * (s * rc[..., 0] - t_c[0]) + cx * pz) / pzc
        v = (fy * (s * rc[..., 1] - t_c[1]) + cy * pz) / pzc
        valid = (z_view > 0.1) & (pz > 1e-6)
        if pl["box"] is not None:
            y0, y1, x0, x1 = pl["box"]
            valid &= (u >= x0) & (u < x1) & (v >= y0) & (v < y1)
        depth[pi, r0:r1, c0:c1] = np.where(valid, z_view, np.inf)
        plane_uv[pi] = (r0, r1, c0, c1, u, v)

    # Visibility: nearest + k-th nearest by repeated masked argmin.
    flat = depth.reshape(num_p, -1)
    win = np.argmin(flat, axis=0)                       # (H*W,)
    cols = np.arange(h * w)
    nearest = flat[win, cols].reshape(h, w)
    layers = [np.where(np.isfinite(nearest), 1.0 / nearest, 0.0)]
    if num_hit_layers > 1:
        flat2 = flat.copy()
        prev = win
        for _ in range(num_hit_layers - 1):
            flat2[prev, cols] = np.inf
            prev = np.argmin(flat2, axis=0)
            dk = flat2[prev, cols].reshape(h, w)
            layers.append(np.where(np.isfinite(dk), 1.0 / dk, 0.0))

    # Texture: sample each plane only where it wins.
    img = np.zeros((h, w, 3), np.float32)
    win2d = win.reshape(h, w)
    covered = np.isfinite(nearest)
    for pi, pl in enumerate(planes):
        if plane_uv[pi] is None:
            continue
        r0, r1, c0, c1, u, v = plane_uv[pi]
        m = (win2d[r0:r1, c0:c1] == pi) & covered[r0:r1, c0:c1]
        if not m.any():
            continue
        img[r0:r1, c0:c1][m] = _bilinear_np(pl["tex"], u[m], v[m])
    disp = layers[0]
    return (img.astype(np.float32), disp.astype(np.float32),
            np.stack(layers[:num_hit_layers]).astype(np.float32))


def make_scene_multi(rng: np.random.Generator, height: int, width: int,
                     baseline: float = 0.3,
                     max_extra_translation: float = 0.03,
                     max_rotation: float = 0.008,
                     num_boxes=None) -> SyntheticScene:
    """Sample a multi-object scene + SE(3)-jittered stereo-ish pair.

    2-4 textured boxes at depths 2.5-6 m over a slanted background plane
    (normal tilted up to ~12 deg), target camera at x-baseline plus small
    y/z translation and rotation jitter (fy * rx ~ a few rows at the
    training resolutions).
    """
    h, w = height, width
    fx = 0.95 * w
    K = np.array([[fx, 0, (w - 1) / 2], [0, fx, (h - 1) / 2], [0, 0, 1]],
                 np.float32)

    # slanted background: n = Rsmall @ (0,0,1); n.p = d_bg along the tilt
    bg_depth = float(rng.uniform(8.0, 14.0))
    tilt = _euler_rotation(float(rng.uniform(-0.2, 0.2)),
                           float(rng.uniform(-0.2, 0.2)), 0.0)
    n_bg = (tilt @ np.array([0.0, 0.0, 1.0], np.float32)).astype(np.float32)
    planes = [{
        "normal": n_bg, "offset": bg_depth * 1.0,
        "tex": _texture(rng, h, w), "box": None,
    }]

    nb = int(rng.integers(2, 5)) if num_boxes is None else int(num_boxes)
    for _ in range(nb):
        d = float(rng.uniform(2.5, 6.0))
        bw = int(rng.integers(w // 8, w // 3))
        bh = int(rng.integers(h // 6, h // 2))
        x0 = int(rng.integers(0, max(1, w - bw)))
        y0 = int(rng.integers(0, max(1, h - bh)))
        planes.append({
            "normal": np.array([0.0, 0.0, 1.0], np.float32), "offset": d,
            "tex": _texture(rng, h, w, cells=int(rng.integers(4, 9))),
            "box": (y0, y0 + bh, x0, x0 + bw),
        })

    # src = canonical camera; trg = jittered pose. pose_src2trg maps
    # src-frame points into the trg frame: p_t = R p_s + t.
    rx, ry, rz = rng.uniform(-max_rotation, max_rotation, 3)
    R = _euler_rotation(float(rx), float(ry), float(rz))
    cam_t = np.array([
        baseline * float(rng.uniform(0.7, 1.3)),
        float(rng.uniform(-max_extra_translation, max_extra_translation)),
        float(rng.uniform(-max_extra_translation, max_extra_translation)),
    ], np.float32)  # trg camera center in src coords
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R
    pose[:3, 3] = -R @ cam_t

    ident = np.eye(4, dtype=np.float32)
    src_img, src_disp, src_layers = _render_planes(planes, K, ident, h, w)
    trg_img, trg_disp, _ = _render_planes(planes, K, pose, h, w)

    return SyntheticScene(
        src_image=src_img, trg_image=trg_img, intrinsics=K,
        pose_src2trg=pose, gt_disparity_layers=src_layers,
        gt_visible_disparity=src_disp, gt_trg_disparity=trg_disp)


def generate_multi(seed: int, height: int, width: int, count: int, **kw):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        yield make_scene_multi(rng, height, width, **kw)


def scene_example(kind: str, seed: int, epoch: int, index: int,
                  height: int, width: int) -> dict:
    """One example dict of numpy arrays, seeded by (seed, epoch, index)
    alone, so the stream does not depend on how it is produced. ``kind``
    is ``"multi"`` for :func:`make_scene_multi`; anything else gives the
    two-plane scene, as in the JAX package."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed & 0xFFFFFFFF, epoch, index]))
    make = make_scene_multi if kind == "multi" else make_scene
    s = make(rng, height, width)
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
