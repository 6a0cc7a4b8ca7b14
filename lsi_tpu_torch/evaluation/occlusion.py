"""Occluded-region evaluation: depth and colour accuracy on the target
pixels that are disoccluded (visible in the target view, hidden behind
the foreground in the source), the content only the LDI's deeper layers
can explain.

PyTorch counterpart of ``lsi_tpu/evaluation/occlusion.py``. Disoccluded
pixels are found geometrically: splat layer 0 alone; target pixels it
leaves without coverage were filled, if at all, by deeper layers.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from lsi_tpu_torch.evaluation.metrics import depth_metrics, psnr
from lsi_tpu_torch.geometry.ldi import LDI, render_forward


@torch.no_grad()
def disocclusion_mask(ldi: LDI, pose_src2trg: torch.Tensor, out_hw=None,
                      zbuffer_scale: float = 50.0, use_pallas="auto",
                      pallas_max_dy: int = 2) -> torch.Tensor:
    """(B, Ho, Wo, 1) float mask of the target pixels layer 0 does not
    cover, on the render route ``use_pallas`` picks. A mask has no
    gradient, so the layer-0 render runs under ``no_grad``: it records no
    autograd node and its VJP never runs."""
    layer0 = LDI(textures=ldi.textures[:, :1],
                 disparities=ldi.disparities[:, :1],
                 intrinsics=ldi.intrinsics)
    cov0 = render_forward(layer0, pose_src2trg, out_hw=out_hw,
                          zbuffer_scale=zbuffer_scale, use_pallas=use_pallas,
                          pallas_max_dy=pallas_max_dy,
                          check_window=False)["coverage"]
    return (cov0 <= 0).float()


def occlusion_metrics(ldi: LDI, pose_src2trg: torch.Tensor,
                      trg_gt_disparity: torch.Tensor,
                      trg_gt_valid: Optional[torch.Tensor] = None,
                      trg_image: Optional[torch.Tensor] = None,
                      zbuffer_scale: float = 50.0, use_pallas="auto",
                      pallas_max_dy: int = 2) -> Dict[str, torch.Tensor]:
    """Depth (and, with ``trg_image``, photometric) accuracy on the
    disoccluded pixels that the full render covers.

    Args:
      ldi: predicted source-frame LDI.
      pose_src2trg: (B, 4, 4).
      trg_gt_disparity: (B, Ho, Wo, 1) target-view ground-truth disparity.
      trg_gt_valid: optional ground-truth validity mask.
      trg_image: optional (B, Ho, Wo, 3) target RGB for ``occ_psnr``.
      use_pallas, pallas_max_dy: the render route
        (``geometry.ldi.render_forward``).
    Returns ``occ_*`` depth metrics, ``occ_fraction`` (the disoccluded
    share of the target) and ``occ_psnr`` when ``trg_image`` is given.
    """
    out_hw = tuple(trg_gt_disparity.shape[1:3])
    route = dict(zbuffer_scale=zbuffer_scale, use_pallas=use_pallas,
                 pallas_max_dy=pallas_max_dy)
    out = render_forward(ldi, pose_src2trg, out_hw=out_hw,
                         check_window=False, **route)
    disocc = disocclusion_mask(ldi, pose_src2trg, out_hw=out_hw, **route)
    covered = (out["coverage"] > 0).float()
    mask = disocc * covered
    if trg_gt_valid is not None:
        mask = mask * trg_gt_valid

    dm = depth_metrics(out["disparity"], trg_gt_disparity, valid=mask)
    result = {f"occ_{k}": v for k, v in dm.items()}
    result["occ_fraction"] = disocc.mean()
    if trg_image is not None:
        result["occ_psnr"] = psnr(out["rgb"], trg_image, mask=mask)
    return result
