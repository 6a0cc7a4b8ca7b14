"""Training losses: view synthesis, smoothness, depth supervision.

PyTorch counterpart of ``lsi_tpu/losses/losses.py`` (the single-prediction
losses): the inverse-warp photometric loss with the per-pixel min over
layers, the splat-composite photometric loss, edge-aware disparity
smoothness, depth supervision and ``total_loss``.

Gradients match JAX's where values tie: ``amin``/``amax`` split the
gradient equally among equal entries, as ``jnp.min``/``jnp.max`` do
(``torch.min(dim=...)`` would give it all to one). Ties are common: an
invalid layer carries the same large error as every other invalid layer,
and ``valid`` is 1.0 in every layer that lands inside the image.

Not ported yet (raise ``NotImplementedError``; ROADMAP Queue 1):
``candidate_radius > 0``, ``ssim_weight > 0`` and the two-prediction
losses. ``photo_layer0_weight`` is a refuted knob and is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from lsi_tpu_torch.config import LossConfig, RenderConfig
from lsi_tpu_torch.geometry.ldi import (LDI, gather_target_per_layer_folded,
                                        render_forward)
from lsi_tpu_torch.utils.helpers import divide_safe

# Error given to samples that fell outside the target view, so the min over
# layers ignores them.
BIG_ERROR = 1e3


def check_loss_config(loss_cfg: LossConfig) -> None:
    """Reject the loss options the port does not implement."""
    if loss_cfg.photo_mode not in ("inverse_warp", "splat", "both"):
        raise ValueError(f"unknown photo_mode {loss_cfg.photo_mode!r}")
    if loss_cfg.candidate_radius > 0:
        raise NotImplementedError(
            "candidate_radius > 0 is not ported yet (ROADMAP Queue 1, "
            "M6 'candidate_radius')")
    if loss_cfg.ssim_weight > 0:
        raise NotImplementedError(
            "ssim_weight > 0 is not ported yet: it needs "
            "evaluation/metrics.ssim (ROADMAP Queue 1, M6 'ssim')")
    if loss_cfg.photo_layer0_weight > 0:
        raise NotImplementedError(
            "photo_layer0_weight is a refuted knob and is not ported "
            "(ROADMAP 'Do not port')")


def _charbonnier(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Smooth L1; gradient-stable at 0."""
    return torch.sqrt(x * x + eps * eps)


def view_synthesis_inverse_warp(ldi: LDI, target_image: torch.Tensor,
                                pose_src2trg: torch.Tensor,
                                K_trg: Optional[torch.Tensor] = None,
                                min_over_layers: bool = True,
                                layer0_margin: float = 0.0,
                                return_diag: bool = False):
    """Gather-direction photometric loss, per-pixel min over layers (one
    sample per layer: ``candidate_radius`` 0).

    For each source pixel and layer, samples the target image at the
    layer's projection and compares it with the layer's texture. Samples
    outside the view get ``BIG_ERROR`` so the min ignores them, and pixels
    invalid in every layer are masked out. With ``return_diag``, returns
    ``(loss, {})``: the port's gather has no window to diagnose.
    """
    b, l, h, w, _ = ldi.textures.shape
    tex = ldi.textures.float().reshape(b * l, h, w, 3)
    sampled, valid, _ = gather_target_per_layer_folded(
        ldi, target_image, pose_src2trg, K_trg)
    err = _charbonnier(sampled - tex).mean(-1, keepdim=True)  # (B*L,H,W,1)
    err_masked = torch.where(valid > 0.5, err, BIG_ERROR).reshape(
        b, l, h, w, 1)
    valid = valid.reshape(b, l, h, w, 1)
    if min_over_layers:
        if layer0_margin > 0.0 and l > 1:
            # Deep layers win the min only when they beat layer 0 by more
            # than the margin (LossConfig.min_layer0_margin).
            is_deep = (torch.arange(l, device=err.device) > 0)[
                None, :, None, None, None]
            err_masked = torch.where(is_deep, err_masked + layer0_margin,
                                     err_masked)
        per_pixel = err_masked.amin(dim=1)  # (B, H, W, 1)
    else:
        per_pixel = divide_safe(
            torch.where(valid > 0.5, err_masked, 0.0).sum(dim=1),
            valid.sum(dim=1))
    any_valid = valid.amax(dim=1)
    per_pixel = torch.where(any_valid > 0.5, per_pixel, 0.0)
    loss = divide_safe(per_pixel.sum(), any_valid.sum())
    return (loss, {}) if return_diag else loss


def view_synthesis_splat(ldi: LDI, target_image: torch.Tensor,
                         pose_src2trg: torch.Tensor,
                         render_cfg: RenderConfig,
                         K_trg: Optional[torch.Tensor] = None,
                         return_diag: bool = False):
    """Scatter-direction photometric loss on the soft-z composite render,
    masked by splat coverage (Charbonnier only: ``ssim_weight`` 0). With
    ``return_diag``, returns ``(loss, {"window_dropped_frac": 0})`` as the
    JAX lax path does."""
    out = render_forward(ldi, pose_src2trg, K_trg=K_trg,
                         out_hw=tuple(target_image.shape[1:3]),
                         zbuffer_scale=render_cfg.zbuffer_scale)
    covered = (out["coverage"] > 0).float()
    err = _charbonnier(out["rgb"] - target_image.float()).mean(
        -1, keepdim=True)
    photo = divide_safe((err * covered).sum(), covered.sum())
    if return_diag:
        return photo, {"window_dropped_frac": out["window_dropped_frac"]}
    return photo


def disparity_smoothness(ldi: LDI, edge_aware: bool = True,
                         edge_gate_deep: bool = True) -> torch.Tensor:
    """First-order disparity smoothness, optionally edge-aware (weights
    exp(-10 |grad I|) of the layer-0 texture). With
    ``edge_gate_deep=False`` the edge gate applies to layer 0 only."""
    d = ldi.disparities[..., 0]  # (B, L, H, W)
    dx = (d[..., :, 1:] - d[..., :, :-1]).abs()
    dy = (d[..., 1:, :] - d[..., :-1, :]).abs()
    if edge_aware:
        img = ldi.textures[:, 0].float()  # (B, H, W, 3)
        gx = (img[:, :, 1:] - img[:, :, :-1]).abs().mean(-1)
        gy = (img[:, 1:, :] - img[:, :-1, :]).abs().mean(-1)
        wx = torch.exp(-10.0 * gx)[:, None]
        wy = torch.exp(-10.0 * gy)[:, None]
        if not edge_gate_deep and d.shape[1] > 1:
            layer_is_0 = (torch.arange(d.shape[1], device=d.device) == 0)[
                None, :, None, None]
            wx = torch.where(layer_is_0, wx, 1.0)
            wy = torch.where(layer_is_0, wy, 1.0)
        dx = dx * wx
        dy = dy * wy
    return dx.mean() + dy.mean()


def depth_supervision(ldi: LDI, gt_disparity: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Charbonnier on layer-0 disparity where ground truth exists."""
    pred = ldi.disparities[:, 0]  # (B, H, W, 1)
    err = _charbonnier(pred - gt_disparity) * valid
    return divide_safe(err.sum(), valid.sum())


def total_loss(ldi: LDI, target_image: torch.Tensor,
               pose_src2trg: torch.Tensor, loss_cfg: LossConfig,
               render_cfg: RenderConfig,
               K_trg: Optional[torch.Tensor] = None,
               gt_disparity: Optional[torch.Tensor] = None,
               gt_valid: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """Assemble the configured loss: ``{"total", parts..., diagnostics}``.

    Diagnostics (``window_dropped_frac``) ride along and are NOT summed
    into ``total``.
    """
    check_loss_config(loss_cfg)
    parts = {}
    diags = {}
    if loss_cfg.photo_mode in ("inverse_warp", "both"):
        inv_loss, inv_diag = view_synthesis_inverse_warp(
            ldi, target_image, pose_src2trg, K_trg,
            min_over_layers=loss_cfg.min_over_layers,
            layer0_margin=loss_cfg.min_layer0_margin, return_diag=True)
        parts["photo_inverse_warp"] = loss_cfg.inverse_warp_weight * inv_loss
        diags.update(inv_diag)
    if loss_cfg.photo_mode in ("splat", "both"):
        splat_loss, diag = view_synthesis_splat(
            ldi, target_image, pose_src2trg, render_cfg, K_trg,
            return_diag=True)
        parts["photo_splat"] = loss_cfg.splat_weight * splat_loss
        diags.update(diag)
    if loss_cfg.smoothness_weight > 0:
        parts["smoothness"] = (
            loss_cfg.smoothness_weight
            * disparity_smoothness(ldi, loss_cfg.edge_aware_smoothness,
                                   loss_cfg.smoothness_edge_gate_deep))
    if loss_cfg.depth_supervision_weight > 0 and gt_disparity is not None:
        if gt_valid is None:
            gt_valid = torch.ones_like(gt_disparity)
        parts["depth_supervision"] = (
            loss_cfg.depth_supervision_weight
            * depth_supervision(ldi, gt_disparity, gt_valid))
    parts["total"] = sum(parts.values())
    parts.update(diags)
    return parts
