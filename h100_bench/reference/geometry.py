"""Poses, the forward projection, the plain splat and gather, the LDI
render and the canonical trajectory sweep (module docstring of the
package says which port files these copy).

``prec.render`` (``precision.py``) is the dtype of the splat's and the
gather's arithmetic; the reference passes float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from h100_bench.reference.precision import REFERENCE, Precision

MIN_DEPTH = 1e-6
MIN_FRACTION = 1e-4


# ---------------------------------------------------------------- poses

def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def matmul_f32(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def matvec_f32(a, v):
    return (a * v[..., None, :]).sum(-1)


def make_pose(rotation, translation) -> torch.Tensor:
    rotation = _as_f32(rotation)
    translation = _as_f32(translation, rotation.device)
    batch = torch.broadcast_shapes(rotation.shape[:-2], translation.shape[:-1])
    rotation = rotation.expand(batch + (3, 3))
    translation = translation.expand(batch + (3,))
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=torch.float32,
                         device=rotation.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def invert_pose(pose):
    rot_inv = pose[..., :3, :3].transpose(-1, -2)
    return make_pose(rot_inv, -matvec_f32(rot_inv, pose[..., :3, 3]))


def euler_to_rotation(angles):
    angles = _as_f32(angles)
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return matmul_f32(matmul_f32(rz, ry), rx)


def pose_from_euler(angles, translation):
    return make_pose(euler_to_rotation(angles), _as_f32(translation))


def camera_trajectory(num_views, max_translation, max_rotation):
    """(num_views, 4, 4): the sinusoidal sweep."""
    phase = torch.linspace(0.0, 2.0 * math.pi, num_views, dtype=torch.float32)
    alpha = torch.sin(phase)[:, None]
    return pose_from_euler(alpha * _as_f32(max_rotation)[None, :],
                           alpha * _as_f32(max_translation)[None, :])


# ----------------------------------------------------------- projection

def intrinsics_matrix(fx, fy, cx, cy, device=None):
    fx, fy, cx, cy = (torch.as_tensor(v, dtype=torch.float32, device=device)
                      for v in (fx, fy, cx, cy))
    fx, fy, cx, cy = torch.broadcast_tensors(fx, fy, cx, cy)
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack([torch.stack([fx, zero, cx], -1),
                        torch.stack([zero, fy, cy], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def invert_intrinsics(K):
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    return intrinsics_matrix(1.0 / fx, 1.0 / fy, -cx / fx, -cy / fy)


def forward_project(disparity, K_src, K_trg, pose_src2trg):
    """(trg_coords (B,H,W,2), trg_disparity (B,H,W,1), valid (B,H,W,1))."""
    _, h, w, _ = disparity.shape
    dev = disparity.device
    d = disparity[..., 0].float()
    rot = pose_src2trg[..., :3, :3].float()
    t = pose_src2trg[..., :3, 3].float()
    K_trg = K_trg.float()
    A = matmul_f32(matmul_f32(K_trg, rot), invert_intrinsics(K_src.float()))
    bvec = matvec_f32(K_trg, t)
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    y = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]

    def row(i):
        a = A[:, i, :, None, None]
        return (a[:, 0] * x + a[:, 1] * y + a[:, 2]
                + bvec[:, i, None, None] * d)

    u, v, zscale = row(0), row(1), row(2)
    denom = torch.where(zscale.abs() > MIN_DEPTH, zscale,
                        torch.full_like(zscale, MIN_DEPTH))
    trg_coords = torch.stack([u / denom, v / denom], dim=-1)
    valid = (zscale > MIN_DEPTH).float()
    trg_disparity = (d / denom) * valid
    return trg_coords, trg_disparity[..., None], valid[..., None]


def divide_safe(num, den, eps: float = 1e-8):
    den_ok = den.abs() > eps
    safe_den = torch.where(den_ok, den, torch.ones_like(den))
    return torch.where(den_ok, num / safe_den, torch.zeros_like(num))


# ------------------------------------------------------- splat, gather

def snap_fraction(f):
    f = torch.where(f < MIN_FRACTION, torch.zeros_like(f), f)
    return torch.where(f > 1.0 - MIN_FRACTION, torch.ones_like(f), f)


def splat_bilinear(values, coords, weights, out_hw, snap=True,
                   max_dy_window=None, prec: Precision = REFERENCE):
    """(accum (N,oh,ow,C), wsum (N,oh,ow,1) or None): every corner of every
    source pixel added into its target by one ``index_add_``; with
    ``max_dy_window`` m, a corner whose row lies outside
    ``[base - m, base + m + 1]`` (``base = row % out_h``) is dropped."""
    out_h, out_w = out_hw
    n, hs, ws, c = values.shape
    p = hs * ws
    dev = values.device
    if weights is None:
        payload = values.float().reshape(n, p, c)
    else:
        w32 = weights.float().reshape(n, p, 1)
        payload = torch.cat([values.float().reshape(n, p, c) * w32, w32], -1)
    planes = payload.shape[-1]
    x = coords[..., 0].float().reshape(n, p)
    y = coords[..., 1].float().reshape(n, p)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    if snap:
        fx, fy = snap_fraction(fx), snap_fraction(fy)
    trash = n * out_h * out_w
    batch_off = (torch.arange(n, device=dev, dtype=torch.int64)
                 * (out_h * out_w))[:, None]
    if max_dy_window is not None:
        base = (torch.arange(hs, device=dev) % out_h).float()[:, None] \
            .expand(hs, ws).reshape(1, p)
    zero = torch.zeros_like(x)
    idxs, wts = [], []
    for dy, dx, frac in ((0, 0, (1.0 - fx) * (1.0 - fy)),
                         (0, 1, fx * (1.0 - fy)),
                         (1, 0, (1.0 - fx) * fy),
                         (1, 1, fx * fy)):
        xi, yi = x0 + dx, y0 + dy
        inb = (xi >= 0) & (xi <= out_w - 1) & (yi >= 0) & (yi <= out_h - 1)
        if max_dy_window is not None:
            ky = yi - base
            inb &= (ky >= -max_dy_window) & (ky <= max_dy_window + 1)
        lin = (batch_off + torch.where(inb, yi, zero).to(torch.int64) * out_w
               + torch.where(inb, xi, zero).to(torch.int64))
        idxs.append(torch.where(inb, lin, torch.full_like(lin, trash)))
        wts.append(frac * inb)
    idx = torch.stack(idxs).reshape(-1)
    contrib = (payload[None] * torch.stack(wts)[..., None]).reshape(-1, planes)
    out = torch.zeros(trash + 1, planes, dtype=prec.render, device=dev)
    out = out.index_add(0, idx, contrib.to(prec.render)).float()
    out = out[:trash].reshape(n, out_h, out_w, planes)
    return out[..., :c], (None if weights is None else out[..., c:])


def _corner_reads(image, x0, y0):
    n, h, w, c = image.shape
    flat = image.reshape(n, h * w, c)
    reads = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        lin = (yi.clamp(0, h - 1).nan_to_num(0.0).to(torch.int64) * w
               + xi.clamp(0, w - 1).nan_to_num(0.0).to(torch.int64))
        g = torch.gather(flat, 1, lin[..., None].expand(-1, -1, c))
        reads.append(g * inb[..., None])
    return reads


def bilinear_sample(image, coords, max_dy: int = -1,
                    prec: Precision = REFERENCE):
    """(sampled (N,Ho,Wo,C) float32, valid (N,Ho,Wo,1)); ``max_dy >= 0``
    snaps the fractions and drops corners outside the row window
    (``base = row % H``)."""
    n, h, w, c = image.shape
    image = image.to(prec.render)
    x, y = coords[..., 0].float(), coords[..., 1].float()
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    window = max_dy >= 0
    if window:
        fx, fy = snap_fraction(fx), snap_fraction(fy)
        base = (torch.arange(coords.shape[1], device=coords.device)
                % h).float()[None, :, None]

    def inb(xi, yi):
        ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        if window:
            ok &= (yi - base >= -max_dy) & (yi - base <= max_dy + 1)
        return ok

    w00 = (1.0 - fx) * (1.0 - fy) * inb(x0, y0)
    w01 = fx * (1.0 - fy) * inb(x0 + 1, y0)
    w10 = (1.0 - fx) * fy * inb(x0, y0 + 1)
    w11 = fx * fy * inb(x0 + 1, y0 + 1)
    out_shape = tuple(coords.shape[:-1]) + (c,)
    reads = [r.reshape(out_shape) for r in _corner_reads(
        image, x0.reshape(n, -1), y0.reshape(n, -1))]
    dt = image.dtype
    sampled = (reads[0] * w00[..., None].to(dt) + reads[1] * w01[..., None].to(dt)
               + reads[2] * w10[..., None].to(dt)
               + reads[3] * w11[..., None].to(dt))
    return sampled.float(), (w00 + w01 + w10 + w11)[..., None]


# ------------------------------------------------------------------ LDI

@dataclasses.dataclass
class LDI:
    textures: torch.Tensor     # (B, L, H, W, 3)
    disparities: torch.Tensor  # (B, L, H, W, 1)
    intrinsics: torch.Tensor   # (B, 3, 3)


def windowed(render: dict) -> bool:
    """The configuration's route: True for the TPU kernels' window."""
    flag = render["use_pallas"]
    if flag in (False, "off", "auto"):
        return False
    if flag in (True, "on"):
        return True
    raise ValueError(f"use_pallas {flag!r}")


def project_layers_folded(ldi: LDI, pose_src2trg, K_trg=None):
    b, l, h, w, _ = ldi.textures.shape
    K_trg = ldi.intrinsics if K_trg is None else K_trg
    rep = lambda m: m.repeat_interleave(l, dim=0)  # noqa: E731
    return forward_project(ldi.disparities.reshape(b * l, h, w, 1),
                           rep(ldi.intrinsics), rep(K_trg), rep(pose_src2trg))


def splat_inputs(ldi: LDI, pose_src2trg, zbuffer_scale):
    b, l, h, w, _ = ldi.textures.shape
    trg_coords, trg_disp, valid = project_layers_folded(ldi, pose_src2trg)
    trg_coords = trg_coords.reshape(b, l * h, w, 2)
    trg_disp = trg_disp.reshape(b, l * h, w, 1)
    valid = valid.reshape(b, l * h, w, 1)
    neg_inf = torch.full_like(trg_disp, float("-inf"))
    d_shift = torch.where(valid > 0, trg_disp, neg_inf).amax(
        dim=(1, 2, 3), keepdim=True).detach().clamp_min(0.0)
    weights = torch.exp(zbuffer_scale * (trg_disp - d_shift)) * valid
    payload = torch.cat([ldi.textures.float().reshape(b, l * h, w, 3),
                         trg_disp], dim=-1)
    return payload, trg_coords.contiguous(), weights.contiguous(), valid


def composite(accum, wsum):
    out = divide_safe(accum, wsum, eps=0.0)
    return {"rgb": out[..., :3], "disparity": out[..., 3:4],
            "coverage": wsum}


def window_dropped_fraction(coords, valid, out_hw, max_dy):
    out_h, out_w = out_hw
    x, y = coords[..., 0], coords[..., 1]
    y0 = torch.floor(y)
    fy = snap_fraction(y - y0)
    base = (torch.arange(coords.shape[1], device=coords.device)
            % out_h).float()[None, :, None]
    ky = y0 - base
    kept = ((1.0 - fy) * ((ky >= -max_dy) & (ky <= max_dy + 1))
            + fy * ((ky + 1 >= -max_dy) & (ky + 1 <= max_dy + 1)))
    rel = ((valid[..., 0] > 0) & (x > -1.0) & (x < out_w)).float()
    return (rel * (1.0 - kept)).sum() / rel.sum().clamp_min(1.0)


def render_forward(ldi: LDI, pose_src2trg, render: dict, out_hw=None,
                   check_window=True, prec: Precision = REFERENCE):
    """The LDI rendered into the pose's view: rgb, disparity, coverage
    and window_dropped_frac. ``render`` is the configuration's render
    section; its ``splat_method`` does not enter (the sort splat adds the
    same terms in another order)."""
    h, w = ldi.textures.shape[2:4]
    out_hw = (h, w) if out_hw is None else tuple(out_hw)
    payload, coords, weights, valid = splat_inputs(ldi, pose_src2trg,
                                                   render["zbuffer_scale"])
    win = windowed(render) and out_hw == (h, w)
    accum, wsum = splat_bilinear(
        payload, coords, weights, out_hw,
        max_dy_window=render["pallas_max_dy"] if win else None, prec=prec)
    if win and check_window:
        dropped = window_dropped_fraction(coords.detach(), valid, out_hw,
                                          render["pallas_max_dy"])
    else:
        dropped = torch.zeros((), device=wsum.device)
    return dict(composite(accum, wsum), window_dropped_frac=dropped)


@torch.no_grad()
def disocclusion_mask(ldi: LDI, pose_src2trg, render: dict, out_hw=None,
                      prec: Precision = REFERENCE):
    layer0 = LDI(ldi.textures[:, :1], ldi.disparities[:, :1], ldi.intrinsics)
    cov0 = render_forward(layer0, pose_src2trg, render, out_hw=out_hw,
                          check_window=False, prec=prec)["coverage"]
    return (cov0 <= 0).float()


def route_max_dy(render: dict, max_dy: int, windowable: bool) -> int:
    return int(max_dy) if windowed(render) and windowable else -1


# ------------------------------------------------------------ trajectory

def repeat_ldi(ldi: LDI, k: int) -> LDI:
    def rep(x):
        return x.repeat((k,) + (1,) * (x.dim() - 1))
    return LDI(rep(ldi.textures), rep(ldi.disparities), rep(ldi.intrinsics))


#: Poses a render in the port's ``evaluation.trajectory.render_trajectory``
#: (fixed there at 8, not a setting): the reference sweeps in the same
#: chunks, and the sweep's K1 calls have these shapes.
TRAJECTORY_CHUNK = 8


@torch.no_grad()
def render_trajectory(ldi: LDI, render: dict, num_views=60,
                      max_translation=(0.15, 0.0, 0.0),
                      max_rotation=(0.0, 0.0, 0.02),
                      prec: Precision = REFERENCE):
    """(num_views, B, H, W, 3): the canonical sweep, ``TRAJECTORY_CHUNK``
    poses a render."""
    chunk = TRAJECTORY_CHUNK
    b = ldi.textures.shape[0]
    poses = camera_trajectory(num_views, max_translation,
                              max_rotation).to(ldi.textures.device)
    frames = []
    for start in range(0, num_views, chunk):
        p = poses[start:start + chunk]
        k = p.shape[0]
        out = render_forward(repeat_ldi(ldi, k), p.repeat_interleave(b, 0),
                             render, check_window=False, prec=prec)
        frames.append(out["rgb"].reshape((k, b) + out["rgb"].shape[1:]))
    return torch.cat(frames)
