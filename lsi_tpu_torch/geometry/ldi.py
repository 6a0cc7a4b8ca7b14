"""The LDI container, the forward-splat LDI render and the per-layer
inverse-warp gather.

PyTorch counterpart of ``lsi_tpu/geometry/ldi.py`` (``LDI``,
``render_forward``, ``project_layers_folded``,
``gather_target_per_layer(_folded)``). The render folds the layers into
the source-row axis so ONE splat accumulates every layer of every image;
the soft z-buffer blend comes from the shared normalization of the
``exp(scale * disparity)`` weights.

Both are differentiable: the splat goes through
``kernels.splat_cuda.SplatFn`` and the gather through
``kernels.gather_cuda.GatherFn`` (the CUDA kernels for CUDA tensors, the
plain versions for CPU tensors). ``use_pallas`` picks the semantics, as
``render.use_pallas`` does in the JAX package (:func:`resolve_use_pallas`):
``"auto"`` (the default), ``"off"`` and False are exact, the JAX package's
lax path; ``"on"`` and True are its TPU kernels' route, a vertical window
of ``pallas_max_dy`` rows around each folded row's base row and snapped
gather fractions, whose truncation ``window_dropped_frac`` reports
(:func:`warn_window_drop` turns it into a warning). The height-sharded
render (``parallel.spatial``) is held to the windowed render.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import torch

from lsi_tpu_torch.geometry import projection
from lsi_tpu_torch.kernels.gather_cuda import GatherFn
from lsi_tpu_torch.kernels.splat_cuda import SplatFn
from lsi_tpu_torch.ops.splat import snap_fraction
from lsi_tpu_torch.parallel.reduce import batch_sum
from lsi_tpu_torch.utils.helpers import divide_safe


def resolve_use_pallas(flag) -> bool:
    """Resolve a ``use_pallas`` value ("auto" | "on" | "off" | bool): True
    for the TPU kernels' windowed route.

    "auto" is exact, as it is in the JAX package off the TPU; "on" (or
    True) takes the windowed route on either device: the CUDA kernels'
    windowed modes on the card, their plain versions on the CPU. JAX's
    ``LSI_TPU_FORCE_PALLAS`` has no counterpart: it exists because JAX's
    kernels run interpreted off the TPU, and the port's do not.
    """
    if flag in (False, "off", "auto"):
        return False
    if flag in (True, "on"):
        return True
    raise ValueError(
        f"use_pallas must be 'auto'|'on'|'off'|bool, got {flag!r}")


#: ``window_dropped_frac`` above which :func:`warn_window_drop` warns.
WINDOW_DROP_TOL = 1e-4


def warn_window_drop(frac, max_dy: Optional[int] = None,
                     tol: float = WINDOW_DROP_TOL) -> bool:
    """Warn when the vertical window dropped content (``frac``, a
    ``window_dropped_frac`` value or tensor, above ``tol``); returns
    whether it warned (``lsi_tpu.geometry.ldi.warn_window_drop``)."""
    frac = float(torch.as_tensor(frac).max())
    if frac > tol:
        extra = f" (pallas_max_dy={max_dy})" if max_dy is not None else ""
        warnings.warn(
            f"splat dy-window{extra} dropped {frac:.4%} of valid splat "
            "contributions: the render is missing content. Raise "
            "render.pallas_max_dy or set render.use_pallas='auto'.",
            RuntimeWarning)
        return True
    return False


@dataclasses.dataclass
class LDI:
    """Layered Depth Image (layouts as in the JAX package).

    Attributes:
      textures:    (B, L, H, W, 3) per-layer RGB in [0, 1].
      disparities: (B, L, H, W, 1) per-layer inverse depth, non-increasing
        across the layer axis (layer 0 = nearest, visible surface).
      intrinsics:  (B, 3, 3) pinhole K of the camera the LDI lives in.
    """
    textures: torch.Tensor
    disparities: torch.Tensor
    intrinsics: torch.Tensor

    @property
    def batch(self) -> int:
        return self.textures.shape[0]

    @property
    def num_layers(self) -> int:
        return self.textures.shape[1]

    @property
    def height(self) -> int:
        return self.textures.shape[2]

    @property
    def width(self) -> int:
        return self.textures.shape[3]


def project_layers_folded(ldi: LDI, pose_src2trg: torch.Tensor,
                          K_trg: Optional[torch.Tensor] = None,
                          row_offset: int = 0):
    """Per-layer target correspondences on folded (B*L, H, W, ·) tensors;
    ``row_offset`` is the global row of the LDI's first row (a height
    shard's).

    Returns (trg_coords (B*L,H,W,2), trg_disp (B*L,H,W,1),
    in_front (B*L,H,W,1)).
    """
    b, l, h, w, _ = ldi.textures.shape
    if K_trg is None:
        K_trg = ldi.intrinsics
    disp_bl = ldi.disparities.reshape(b * l, h, w, 1)

    def rep(m):
        return m.repeat_interleave(l, dim=0)

    return projection.forward_project(
        disp_bl, rep(ldi.intrinsics), rep(K_trg), rep(pose_src2trg),
        row_offset=row_offset)


def splat_inputs(ldi: LDI, pose_src2trg: torch.Tensor,
                 K_trg: Optional[torch.Tensor] = None,
                 zbuffer_scale: float = 50.0, row_offset: int = 0,
                 global_max: Optional[Callable] = None):
    """The render's splat inputs, the layers folded into the source rows:
    payload (B, L*H, W, 4) = [rgb, target disparity], target coordinates
    (B, L*H, W, 2) and soft z-buffer weights (B, L*H, W, 1), with the
    in-front mask (B, L*H, W, 1).

    ``row_offset`` and ``global_max`` serve a height shard
    (``parallel.spatial``): its rows project at their global rows, and
    ``global_max`` turns the shard's per-image max target disparity into
    the whole image's.
    """
    b, l, h, w, _ = ldi.textures.shape
    trg_coords, trg_disp, valid = project_layers_folded(
        ldi, pose_src2trg, K_trg, row_offset)
    trg_coords = trg_coords.reshape(b, l * h, w, 2)
    trg_disp = trg_disp.reshape(b, l * h, w, 1)
    valid = valid.reshape(b, l * h, w, 1)

    # Shift the exp argument by each image's largest valid target
    # disparity: the factor cancels between accum and wsum, and keeps the
    # largest weight at exactly 1 so no scale underflows the accumulator.
    # It carries no gradient (JAX: stop_gradient).
    neg_inf = torch.full_like(trg_disp, float("-inf"))
    d_shift = torch.where(valid > 0, trg_disp, neg_inf).amax(
        dim=(1, 2, 3), keepdim=True).detach()
    if global_max is not None:
        d_shift = global_max(d_shift)
    d_shift = d_shift.clamp_min(0.0)
    weights = torch.exp(zbuffer_scale * (trg_disp - d_shift)) * valid

    payload = torch.cat(
        [ldi.textures.float().reshape(b, l * h, w, 3), trg_disp], dim=-1)
    return payload, trg_coords.contiguous(), weights.contiguous(), valid


def composite(accum: torch.Tensor, wsum: torch.Tensor):
    """The splat's sums -> the render's rgb, disparity and coverage."""
    # Exact > 0 test: shifted weights of occluded layers can be tiny yet
    # still meaningful after normalization.
    out = divide_safe(accum, wsum, eps=0.0)
    return {"rgb": out[..., :3], "disparity": out[..., 3:4],
            "coverage": wsum}


def window_dropped_fraction(coords: torch.Tensor, valid: torch.Tensor,
                            out_hw, max_dy: int,
                            data_group=None) -> torch.Tensor:
    """The share of valid, horizontally in-image splat corners' vertical
    tent mass that the ``max_dy`` window drops (base row ``row % out_h``);
    ``lsi_tpu/geometry/ldi.py:_window_dropped_fraction``. With a
    ``data_group`` (``parallel.reduce``) it is the global batch's share."""
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
    return (batch_sum(rel * (1.0 - kept), data_group)
            / batch_sum(rel, data_group).clamp_min(1.0))


def render_forward(ldi: LDI, pose_src2trg: torch.Tensor,
                   K_trg: Optional[torch.Tensor] = None, out_hw=None,
                   zbuffer_scale: float = 50.0, use_pallas="auto",
                   pallas_max_dy: int = 2, check_window: bool = True,
                   data_group=None):
    """Render an LDI into a novel view by forward splatting.

    Args:
      ldi: source-frame LDI.
      pose_src2trg: (B, 4, 4) rigid transform source cam -> target cam.
      K_trg: (B, 3, 3) target intrinsics; defaults to the LDI's.
      out_hw: (Ho, Wo) target size; defaults to the LDI's (H, W).
      zbuffer_scale: soft z-buffer sharpness (weight = exp(scale * d)).
      use_pallas: "auto" (the default), "off" or False splat exactly;
        "on" or True take the TPU kernels' route (:func:`resolve_use_pallas`):
        every corner more than ``pallas_max_dy`` rows from its source
        row's base row ``r % H`` is dropped. A render with ``out_hw`` other
        than the LDI's is exact on either route, as in the JAX package.
        ``parallel.spatial.render_forward_spatial`` equals the windowed
        render.
      pallas_max_dy: the window, in rows (JAX's name).
      check_window: on the windowed route, count the share of the splat
        the window drops (:func:`window_dropped_fraction`; over the global
        batch of ``data_group``'s ranks where one is given).
    Returns dict with:
      rgb (B, Ho, Wo, 3), disparity (B, Ho, Wo, 1), coverage (B, Ho, Wo, 1)
      (accumulated splat weight, 0 = hole), all float32, and
      window_dropped_frac, a 0-d tensor: that share, 0 when exact or
      unchecked.
    """
    h, w = ldi.height, ldi.width
    out_hw = (h, w) if out_hw is None else tuple(out_hw)
    payload, coords, weights, valid = splat_inputs(ldi, pose_src2trg, K_trg,
                                                   zbuffer_scale)
    # The window measures rows from r % H, so it holds only where the
    # target grid is the LDI's; other renders take the exact splat.
    windowed = resolve_use_pallas(use_pallas) and out_hw == (h, w)
    if windowed:
        accum, wsum = SplatFn.apply(payload, coords, weights, out_hw,
                                    pallas_max_dy)
    else:
        accum, wsum = SplatFn.apply(payload, coords, weights, out_hw)
    if windowed and check_window:
        dropped = window_dropped_fraction(coords.detach(), valid, out_hw,
                                          pallas_max_dy, data_group)
    else:
        dropped = torch.zeros((), device=wsum.device)
    return dict(composite(accum, wsum), window_dropped_frac=dropped)


def route_max_dy(use_pallas, pallas_max_dy: int, windowable: bool) -> int:
    """A gather's ``max_dy``: ``pallas_max_dy`` on the windowed route where
    its shapes allow the window (``windowable``), else -1, the exact
    gather, as JAX's route takes its lax path for other shapes."""
    if resolve_use_pallas(use_pallas) and windowable:
        return int(pallas_max_dy)
    return -1


def gather_target_per_layer_folded(ldi: LDI, target_image: torch.Tensor,
                                   pose_src2trg: torch.Tensor,
                                   K_trg: Optional[torch.Tensor] = None,
                                   use_pallas="off",
                                   pallas_max_dy: int = 2):
    """Folded (B*L, H, W, C) variant of :func:`gather_target_per_layer`.

    The gather reads the (B, Ht, Wt, C) target directly at the folded
    (B, L*H, W, 2) coordinates: no per-layer copy of the target. The
    target is sampled in float32. On the windowed route (``use_pallas``
    "on", a target of the LDI's size) the gather is the TPU kernel's:
    fractions snapped, samples more than ``pallas_max_dy`` rows from their
    row's base row dropped (value and valid).

    Returns (sampled (B*L, H, W, C), valid (B*L, H, W, 1) = in front of
    the target camera x in-image bilinear mass, trg_disp (B*L, H, W, 1)).
    """
    b, l, h, w = ldi.textures.shape[:4]
    trg_coords, trg_disp, in_front = project_layers_folded(
        ldi, pose_src2trg, K_trg)
    sampled, in_bounds = GatherFn.apply(
        target_image.float().contiguous(),
        trg_coords.reshape(b, l * h, w, 2).contiguous(),
        route_max_dy(use_pallas, pallas_max_dy,
                     tuple(target_image.shape[1:3]) == (h, w)))
    sampled = sampled.reshape(b * l, h, w, -1)
    in_bounds = in_bounds.reshape(b * l, h, w, 1)
    return sampled, in_front * in_bounds, trg_disp


def gather_target_per_layer(ldi: LDI, target_image: torch.Tensor,
                            pose_src2trg: torch.Tensor,
                            K_trg: Optional[torch.Tensor] = None):
    """Inverse warp: sample the target image at each layer's projection.

    Returns:
      sampled:  (B, L, H, W, C) target colours at each layer's
        correspondence.
      valid:    (B, L, H, W, 1) in-image & in-front mass (float32).
      trg_disp: (B, L, H, W, 1) per-layer disparity in the target frame.
    """
    b, l, h, w, _ = ldi.textures.shape
    sampled, valid, trg_disp = gather_target_per_layer_folded(
        ldi, target_image, pose_src2trg, K_trg)
    return (sampled.reshape(b, l, h, w, -1), valid.reshape(b, l, h, w, 1),
            trg_disp.reshape(b, l, h, w, 1))
