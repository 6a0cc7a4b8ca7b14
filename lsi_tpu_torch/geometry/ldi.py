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
plain versions for CPU tensors). Both are exact (no vertical window), so
``window_dropped_frac`` is always 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lsi_tpu_torch.geometry import projection
from lsi_tpu_torch.kernels.gather_cuda import GatherFn
from lsi_tpu_torch.kernels.splat_cuda import SplatFn
from lsi_tpu_torch.utils.helpers import divide_safe


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
                          K_trg: Optional[torch.Tensor] = None):
    """Per-layer target correspondences on folded (B*L, H, W, ·) tensors.

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
        disp_bl, rep(ldi.intrinsics), rep(K_trg), rep(pose_src2trg))


def render_forward(ldi: LDI, pose_src2trg: torch.Tensor,
                   K_trg: Optional[torch.Tensor] = None, out_hw=None,
                   zbuffer_scale: float = 50.0):
    """Render an LDI into a novel view by forward splatting.

    Args:
      ldi: source-frame LDI.
      pose_src2trg: (B, 4, 4) rigid transform source cam -> target cam.
      K_trg: (B, 3, 3) target intrinsics; defaults to the LDI's.
      out_hw: (Ho, Wo) target size; defaults to the LDI's (H, W).
      zbuffer_scale: soft z-buffer sharpness (weight = exp(scale * d)).
    Returns dict with:
      rgb (B, Ho, Wo, 3), disparity (B, Ho, Wo, 1), coverage (B, Ho, Wo, 1)
      (accumulated splat weight, 0 = hole), all float32, and
      window_dropped_frac, a 0-d tensor that is always 0 (the splat is
      exact; the key is kept for parity with the JAX package).
    """
    b, l, h, w, _ = ldi.textures.shape
    if out_hw is None:
        out_hw = (h, w)

    trg_coords, trg_disp, valid = project_layers_folded(ldi, pose_src2trg,
                                                        K_trg)
    trg_coords = trg_coords.reshape(b, l * h, w, 2)
    trg_disp = trg_disp.reshape(b, l * h, w, 1)
    valid = valid.reshape(b, l * h, w, 1)

    # Shift the exp argument by each image's largest valid target
    # disparity: the factor cancels between accum and wsum, and keeps the
    # largest weight at exactly 1 so no scale underflows the accumulator.
    neg_inf = torch.full_like(trg_disp, float("-inf"))
    d_shift = torch.where(valid > 0, trg_disp, neg_inf).amax(
        dim=(1, 2, 3), keepdim=True).clamp_min(0.0).detach()
    weights = torch.exp(zbuffer_scale * (trg_disp - d_shift)) * valid

    payload = torch.cat(
        [ldi.textures.float().reshape(b, l * h, w, 3), trg_disp], dim=-1)
    accum, wsum = SplatFn.apply(payload, trg_coords.contiguous(),
                                weights.contiguous(), tuple(out_hw))

    # Exact > 0 test: shifted weights of occluded layers can be tiny yet
    # still meaningful after normalization.
    out = divide_safe(accum, wsum, eps=0.0)
    return {
        "rgb": out[..., :3],
        "disparity": out[..., 3:4],
        "coverage": wsum,
        "window_dropped_frac": torch.zeros((), device=wsum.device),
    }


def gather_target_per_layer_folded(ldi: LDI, target_image: torch.Tensor,
                                   pose_src2trg: torch.Tensor,
                                   K_trg: Optional[torch.Tensor] = None):
    """Folded (B*L, H, W, C) variant of :func:`gather_target_per_layer`.

    The gather reads the (B, Ht, Wt, C) target directly at the folded
    (B, L*H, W, 2) coordinates: no per-layer copy of the target. The
    target is sampled in float32.

    Returns (sampled (B*L, H, W, C), valid (B*L, H, W, 1) = in front of
    the target camera x in-image bilinear mass, trg_disp (B*L, H, W, 1)).
    """
    b, l, h, w = ldi.textures.shape[:4]
    trg_coords, trg_disp, in_front = project_layers_folded(
        ldi, pose_src2trg, K_trg)
    sampled, in_bounds = GatherFn.apply(
        target_image.float().contiguous(),
        trg_coords.reshape(b, l * h, w, 2).contiguous())
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
