"""Training losses: view synthesis, smoothness, depth supervision and
cross-view depth consistency.

PyTorch counterpart of ``lsi_tpu/losses/losses.py``: the inverse-warp
photometric loss with the per-pixel min over layers (and over candidate
offsets, ``candidate_radius``), the splat-composite photometric loss (with
SSIM mixed in, ``ssim_weight``), edge-aware disparity smoothness, depth
supervision, ``total_loss``, the two-prediction terms
``depth_consistency`` and ``total_loss_bidirectional``, and the MPI
baseline's ``mpi_smoothness`` and ``mpi_total_loss``.

Gradients match JAX's where values tie: ``amin``/``amax`` split the
gradient equally among equal entries, as ``jnp.min``/``jnp.max`` do
(``torch.min(dim=...)`` would give it all to one), and
``torch.minimum``/``torch.maximum`` give half to each of two equal
arguments, as ``jnp.minimum``/``jnp.maximum`` do. Ties are common: an
invalid layer carries the same large error as every other invalid layer,
and ``valid`` is 1.0 in every layer that lands inside the image.

Every loss is a ratio of sums, or a mean, over the batch. Each sum is
taken by ``parallel.reduce.batch_sum`` (a mean by ``batch_mean``) over
the ``data_group`` argument: ``x.sum()`` for None (one process, the
default) and the sum over the data-parallel ranks for their group, so
that a data-parallel step computes the global batch's loss and gradient,
as JAX's sharded step does (a mean of per-rank ratios would be another
number).

The refuted knobs ``photo_layer0_weight``, ``consistency_ema_teacher``
and ``consistency_stop_step`` are not ported (ROADMAP "Do not port").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from lsi_tpu_torch.config import LossConfig, RenderConfig
from lsi_tpu_torch.evaluation.metrics import ssim
from lsi_tpu_torch.evaluation.occlusion import disocclusion_mask
from lsi_tpu_torch.geometry.ldi import (LDI, project_layers_folded,
                                        render_forward, resolve_use_pallas,
                                        route_max_dy,
                                        window_dropped_fraction)
from lsi_tpu_torch.kernels.gather_cuda import GatherFn
from lsi_tpu_torch.models.mpi import MPI, mpi_source_disparity, render_mpi
from lsi_tpu_torch.geometry.transforms import invert_pose
from lsi_tpu_torch.parallel.reduce import batch_mean, batch_sum
from lsi_tpu_torch.utils.helpers import divide_safe

# Error given to samples that fell outside the target view, so the min over
# layers ignores them.
BIG_ERROR = 1e3


def check_loss_config(loss_cfg: LossConfig) -> None:
    """Reject the loss options the port does not implement."""
    if loss_cfg.photo_mode not in ("inverse_warp", "splat", "both"):
        raise ValueError(f"unknown photo_mode {loss_cfg.photo_mode!r}")
    for knob in ("photo_layer0_weight", "consistency_ema_teacher",
                 "consistency_stop_step"):
        if getattr(loss_cfg, knob):
            raise NotImplementedError(
                f"{knob} is a refuted knob and is not ported (ROADMAP "
                "'Do not port')")


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the gradient 1 at x == 0, as ``jnp.abs`` has (``torch.abs``
    has 0 there; ROADMAP H15). Neighbouring disparities are exactly equal
    wherever a sigmoid saturates, so the smoothness terms meet x == 0."""
    return torch.where(x >= 0, x, -x)


def _charbonnier(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Smooth L1; gradient-stable at 0."""
    return torch.sqrt(x * x + eps * eps)


def _candidate_errors(ldi: LDI, target_image: torch.Tensor,
                      pose_src2trg: torch.Tensor,
                      K_trg: Optional[torch.Tensor], tex: torch.Tensor,
                      radius: int, render_cfg: RenderConfig):
    """The inverse warp's per-layer error with ``candidate_radius`` r: the
    min over the (2r+1)^2 integer offsets around each projection of the
    masked Charbonnier error, and the max of ``valid``.

    The offsets' coordinates are stacked along the folded rows, so ONE
    gather samples every candidate (one launch of each gather kernel, the
    coordinates' gradient summed back over the offsets). The min and max
    are taken offset by offset (dy outer, dx inner), as the reference
    takes them, so ties split their gradient the same way. Radius 0 is
    the plain inverse warp: one offset, added nowhere.

    On the windowed route (``render_cfg.use_pallas`` "on", a target of the
    LDI's size) the gather is the TPU kernel's at a window of
    ``pallas_max_dy + r`` rows, which absorbs the offsets; the stacked
    rows keep their base row ``row % H``, so one launch still serves
    every candidate.

    Returns (err_masked (B*L, H, W, 1), valid (B*L, H, W, 1), and the
    projection's coordinates (B, L*H, W, 2) and in-front mask
    (B, L*H, W, 1)).
    """
    b, l, h, w, _ = ldi.textures.shape
    trg_coords, _, in_front = project_layers_folded(ldi, pose_src2trg, K_trg)
    k = (2 * radius + 1) ** 2
    coords = trg_coords.reshape(b, 1, l * h, w, 2)
    if radius > 0:
        offsets = torch.tensor(
            [[dx, dy] for dy in range(-radius, radius + 1)
             for dx in range(-radius, radius + 1)],
            dtype=torch.float32, device=trg_coords.device)
        coords = coords + offsets[None, :, None, None, :]
    coords = coords.reshape(b, k * l * h, w, 2)
    max_dy = route_max_dy(render_cfg.use_pallas,
                          render_cfg.pallas_max_dy + radius,
                          tuple(target_image.shape[1:3]) == (h, w))
    sampled, in_bounds = GatherFn.apply(target_image.float().contiguous(),
                                        coords.contiguous(), max_dy)

    def per_offset(x):  # (B, K*L*H, W, C) -> (K, B*L, H, W, C)
        return x.reshape(b, k, l, h, w, -1).transpose(0, 1).reshape(
            k, b * l, h, w, -1)

    sampled, in_bounds = per_offset(sampled), per_offset(in_bounds)
    err_masked = valid = None
    for i in range(k):
        v = in_front * in_bounds[i]
        e = _charbonnier(sampled[i] - tex).mean(-1, keepdim=True)
        e = torch.where(v > 0.5, e, BIG_ERROR)
        err_masked = e if err_masked is None else torch.minimum(err_masked, e)
        valid = v if valid is None else torch.maximum(valid, v)
    return (err_masked, valid, trg_coords.reshape(b, l * h, w, 2),
            in_front.reshape(b, l * h, w, 1))


def view_synthesis_inverse_warp(ldi: LDI, target_image: torch.Tensor,
                                pose_src2trg: torch.Tensor,
                                K_trg: Optional[torch.Tensor] = None,
                                min_over_layers: bool = True,
                                candidate_radius: int = 0,
                                layer0_margin: float = 0.0,
                                render_cfg: RenderConfig = RenderConfig(),
                                return_diag: bool = False, data_group=None):
    """Gather-direction photometric loss, per-pixel min over layers.

    For each source pixel and layer, samples the target image at the
    layer's projection and compares it with the layer's texture. Samples
    outside the view get ``BIG_ERROR`` so the min ignores them, and pixels
    invalid in every layer are masked out. With ``candidate_radius`` r > 0
    the error is also the min over the (2r+1)^2 integer-offset samples
    around each projection (it forgives sub-pixel correspondence error).
    ``render_cfg`` picks the gather's route (:func:`_candidate_errors`).
    With ``return_diag``, returns ``(loss, diag)``: ``diag`` holds the
    gather window's ``window_dropped_frac`` on the windowed route with
    ``render_cfg.window_check`` and radius 0, and is empty otherwise, as
    in the JAX package. ``data_group``: the data-parallel ranks whose
    batches make the global batch (module docstring).
    """
    b, l, h, w, _ = ldi.textures.shape
    tex = ldi.textures.float().reshape(b * l, h, w, 3)
    err_masked, valid, trg_coords, in_front = _candidate_errors(
        ldi, target_image, pose_src2trg, K_trg, tex, candidate_radius,
        render_cfg)
    err_masked = err_masked.reshape(b, l, h, w, 1)
    valid = valid.reshape(b, l, h, w, 1)
    if min_over_layers:
        if layer0_margin > 0.0 and l > 1:
            # Deep layers win the min only when they beat layer 0 by more
            # than the margin (LossConfig.min_layer0_margin).
            is_deep = (torch.arange(l, device=tex.device) > 0)[
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
    loss = divide_safe(batch_sum(per_pixel, data_group),
                       batch_sum(any_valid, data_group))
    if not return_diag:
        return loss
    diag = {}
    if (render_cfg.window_check and candidate_radius == 0
            and resolve_use_pallas(render_cfg.use_pallas)
            and tuple(target_image.shape[1:3]) == (h, w)):
        diag["window_dropped_frac"] = window_dropped_fraction(
            trg_coords.detach(), in_front.detach(), (h, w),
            render_cfg.pallas_max_dy, data_group)
    return loss, diag


def view_synthesis_splat(ldi: LDI, target_image: torch.Tensor,
                         pose_src2trg: torch.Tensor,
                         render_cfg: RenderConfig,
                         K_trg: Optional[torch.Tensor] = None,
                         ssim_weight: float = 0.0,
                         return_diag: bool = False, data_group=None):
    """Scatter-direction photometric loss on the soft-z composite render,
    masked by splat coverage. With ``ssim_weight`` alpha > 0 it is the
    monodepth mix alpha * (1 - SSIM) / 2 + (1 - alpha) * Charbonnier, the
    SSIM masked by coverage too. The render takes ``render_cfg``'s route.
    With ``return_diag``, returns ``(loss, {"window_dropped_frac": f})``,
    the render's (0 on the exact route or without ``window_check``)."""
    out = render_forward(ldi, pose_src2trg, K_trg=K_trg,
                         out_hw=tuple(target_image.shape[1:3]),
                         zbuffer_scale=render_cfg.zbuffer_scale,
                         use_pallas=render_cfg.use_pallas,
                         pallas_max_dy=render_cfg.pallas_max_dy,
                         check_window=render_cfg.window_check,
                         data_group=data_group)
    covered = (out["coverage"] > 0).float()
    trg32 = target_image.float()
    err = _charbonnier(out["rgb"] - trg32).mean(-1, keepdim=True)
    photo = divide_safe(batch_sum(err * covered, data_group),
                        batch_sum(covered, data_group))
    if ssim_weight > 0.0:
        structural = (1.0 - ssim(out["rgb"], trg32, mask=covered,
                                 data_group=data_group)) / 2.0
        photo = ssim_weight * structural + (1.0 - ssim_weight) * photo
    if return_diag:
        return photo, {"window_dropped_frac": out["window_dropped_frac"]}
    return photo


def disparity_smoothness(ldi: LDI, edge_aware: bool = True,
                         edge_gate_deep: bool = True,
                         data_group=None) -> torch.Tensor:
    """First-order disparity smoothness, optionally edge-aware (weights
    exp(-10 |grad I|) of the layer-0 texture). With
    ``edge_gate_deep=False`` the edge gate applies to layer 0 only."""
    d = ldi.disparities[..., 0]  # (B, L, H, W)
    dx = _abs(d[..., :, 1:] - d[..., :, :-1])
    dy = _abs(d[..., 1:, :] - d[..., :-1, :])
    if edge_aware:
        img = ldi.textures[:, 0].float()  # (B, H, W, 3)
        gx = _abs(img[:, :, 1:] - img[:, :, :-1]).mean(-1)
        gy = _abs(img[:, 1:, :] - img[:, :-1, :]).mean(-1)
        wx = torch.exp(-10.0 * gx)[:, None]
        wy = torch.exp(-10.0 * gy)[:, None]
        if not edge_gate_deep and d.shape[1] > 1:
            layer_is_0 = (torch.arange(d.shape[1], device=d.device) == 0)[
                None, :, None, None]
            wx = torch.where(layer_is_0, wx, 1.0)
            wy = torch.where(layer_is_0, wy, 1.0)
        dx = dx * wx
        dy = dy * wy
    return batch_mean(dx, data_group) + batch_mean(dy, data_group)


def depth_consistency(ldi_src: LDI, ldi_trg: LDI,
                      pose_src2trg: torch.Tensor,
                      render_cfg: RenderConfig,
                      K_trg: Optional[torch.Tensor] = None,
                      stop_target: bool = False,
                      disocc_only: bool = False,
                      visible_only: bool = False,
                      deep_only: bool = False,
                      data_group=None) -> torch.Tensor:
    """Cross-view depth consistency, one direction: splat the source LDI's
    disparity into the target view and penalise its disagreement with the
    target prediction's layer-0 disparity where the render has weight.

    Args:
      stop_target: the target's layer-0 disparity is a constant
        (a pseudo-label), so the term cannot be met by both predictions
        drifting together.
      disocc_only: only the target pixels the source's layer 0 does not
        cover (the disoccluded set; ``visible_only`` is its complement).
        The mask is a constant, computed under ``no_grad``.
      deep_only: the source's layer-0 disparity is detached before the
        splat, so the gradient reaches only the deep layers (the textures
        are not detached).

    The rendered disparity is renormalised with a floor of 1e-30 on the
    splat weight: disoccluded pixels carry only deep-layer weight, about
    ``exp(-scale)`` after the soft-z shift, and the VJP's division by that
    weight must stay inside float32.
    """
    if deep_only:
        d = ldi_src.disparities
        ldi_src = dataclasses.replace(
            ldi_src, disparities=torch.cat([d[:, :1].detach(), d[:, 1:]], 1))
    out_hw = tuple(ldi_trg.disparities.shape[2:4])
    route = dict(zbuffer_scale=render_cfg.zbuffer_scale,
                 use_pallas=render_cfg.use_pallas,
                 pallas_max_dy=render_cfg.pallas_max_dy)
    out = render_forward(ldi_src, pose_src2trg, K_trg=K_trg, out_hw=out_hw,
                         check_window=False, **route)
    wsum = out["coverage"]
    disp_num = out["disparity"] * wsum  # the accumulated disparity mass
    rendered_disp = divide_safe(disp_num, wsum, eps=1e-30)
    mask = (wsum > 1e-30).float()
    if disocc_only or visible_only:
        disocc = disocclusion_mask(ldi_src, pose_src2trg, out_hw=out_hw,
                                   **route)
        mask = mask * (disocc if disocc_only else 1.0 - disocc)
    target = ldi_trg.disparities[:, 0]
    if stop_target:
        target = target.detach()
    err = _charbonnier(rendered_disp - target)
    return divide_safe(batch_sum(err * mask, data_group),
                       batch_sum(mask, data_group))


def depth_supervision(ldi: LDI, gt_disparity: torch.Tensor,
                      valid: torch.Tensor, data_group=None) -> torch.Tensor:
    """Charbonnier on layer-0 disparity where ground truth exists."""
    pred = ldi.disparities[:, 0]  # (B, H, W, 1)
    err = _charbonnier(pred - gt_disparity) * valid
    return divide_safe(batch_sum(err, data_group),
                       batch_sum(valid, data_group))


def total_loss(ldi: LDI, target_image: torch.Tensor,
               pose_src2trg: torch.Tensor, loss_cfg: LossConfig,
               render_cfg: RenderConfig,
               K_trg: Optional[torch.Tensor] = None,
               gt_disparity: Optional[torch.Tensor] = None,
               gt_valid: Optional[torch.Tensor] = None,
               data_group=None) -> Dict[str, torch.Tensor]:
    """Assemble the configured loss: ``{"total", parts..., diagnostics}``.

    Diagnostics (``window_dropped_frac``) ride along and are NOT summed
    into ``total``. With a ``data_group`` the parts are the global batch's
    (module docstring).
    """
    check_loss_config(loss_cfg)
    parts = {}
    diags = {}
    if loss_cfg.photo_mode in ("inverse_warp", "both"):
        inv_loss, inv_diag = view_synthesis_inverse_warp(
            ldi, target_image, pose_src2trg, K_trg,
            min_over_layers=loss_cfg.min_over_layers,
            candidate_radius=loss_cfg.candidate_radius,
            layer0_margin=loss_cfg.min_layer0_margin, render_cfg=render_cfg,
            return_diag=True, data_group=data_group)
        parts["photo_inverse_warp"] = loss_cfg.inverse_warp_weight * inv_loss
        diags.update(inv_diag)
    if loss_cfg.photo_mode in ("splat", "both"):
        splat_loss, diag = view_synthesis_splat(
            ldi, target_image, pose_src2trg, render_cfg, K_trg,
            ssim_weight=loss_cfg.ssim_weight, return_diag=True,
            data_group=data_group)
        parts["photo_splat"] = loss_cfg.splat_weight * splat_loss
        diags.update(diag)
    if loss_cfg.smoothness_weight > 0:
        parts["smoothness"] = (
            loss_cfg.smoothness_weight
            * disparity_smoothness(ldi, loss_cfg.edge_aware_smoothness,
                                   loss_cfg.smoothness_edge_gate_deep,
                                   data_group))
    if loss_cfg.depth_supervision_weight > 0 and gt_disparity is not None:
        if gt_valid is None:
            gt_valid = torch.ones_like(gt_disparity)
        parts["depth_supervision"] = (
            loss_cfg.depth_supervision_weight
            * depth_supervision(ldi, gt_disparity, gt_valid, data_group))
    parts["total"] = sum(parts.values())
    parts.update(diags)
    return parts


def total_loss_bidirectional(ldi_src: LDI, ldi_trg: LDI,
                             src_image: torch.Tensor,
                             trg_image: torch.Tensor,
                             pose_src2trg: torch.Tensor,
                             loss_cfg: LossConfig,
                             render_cfg: RenderConfig,
                             gt_disparity: Optional[torch.Tensor] = None,
                             gt_valid: Optional[torch.Tensor] = None,
                             data_group=None) -> Dict[str, torch.Tensor]:
    """The two-prediction loss (an LDI predicted from each view):

    * :func:`total_loss` of the source prediction against the target;
    * with ``symmetric``, the same of the target prediction against the
      source (no depth supervision: its ground truth is the source's),
      its parts suffixed ``_rev``;
    * with ``consistency_weight``, :func:`depth_consistency` in both
      directions with the configured flags (``depth_consistency``);
    * with ``consistency_anchor_weight``, the ``visible_only`` consistency
      in both directions (``depth_anchor``).

    Diagnostics ride along un-summed, as in :func:`total_loss`, and
    ``data_group`` is :func:`total_loss`'s.
    """
    parts = total_loss(ldi_src, trg_image, pose_src2trg, loss_cfg,
                       render_cfg, gt_disparity=gt_disparity,
                       gt_valid=gt_valid, data_group=data_group)
    total = parts.pop("total")
    pose_trg2src = invert_pose(pose_src2trg)
    if loss_cfg.symmetric:
        rev = total_loss(ldi_trg, src_image, pose_trg2src, loss_cfg,
                         render_cfg, data_group=data_group)
        total = total + rev.pop("total")
        for k, v in rev.items():
            parts[("window_dropped_frac_rev" if k == "window_dropped_frac"
                   else f"{k}_rev")] = v
    terms = []
    if loss_cfg.consistency_weight > 0:
        terms.append(("depth_consistency", loss_cfg.consistency_weight, dict(
            stop_target=loss_cfg.consistency_stop_target,
            disocc_only=loss_cfg.consistency_disocc_only,
            deep_only=loss_cfg.consistency_deep_only)))
    if loss_cfg.consistency_anchor_weight > 0:
        terms.append(("depth_anchor", loss_cfg.consistency_anchor_weight,
                      dict(visible_only=True)))
    for name, weight, kw in terms:
        both = (depth_consistency(ldi_src, ldi_trg, pose_src2trg,
                                  render_cfg, data_group=data_group, **kw)
                + depth_consistency(ldi_trg, ldi_src, pose_trg2src,
                                    render_cfg, data_group=data_group,
                                    **kw))
        parts[name] = weight * both
        total = total + parts[name]
    parts["total"] = total
    return parts


def mpi_smoothness(disp: torch.Tensor, image: torch.Tensor,
                   edge_aware: bool = True, data_group=None) -> torch.Tensor:
    """First-order smoothness of the MPI's expected source disparity
    (B, H, W, 1), edge-aware against the input image (weights
    exp(-10 |grad I|), as the LDI term)."""
    d = disp[..., 0]  # (B, H, W)
    dx = _abs(d[:, :, 1:] - d[:, :, :-1])
    dy = _abs(d[:, 1:, :] - d[:, :-1, :])
    if edge_aware:
        img = image.float()
        gx = _abs(img[:, :, 1:] - img[:, :, :-1]).mean(-1)
        gy = _abs(img[:, 1:, :] - img[:, :-1, :]).mean(-1)
        dx = dx * torch.exp(-10.0 * gx)
        dy = dy * torch.exp(-10.0 * gy)
    return batch_mean(dx, data_group) + batch_mean(dy, data_group)


def mpi_total_loss(mpi: MPI, src_image: torch.Tensor,
                   target_image: torch.Tensor, pose_src2trg: torch.Tensor,
                   loss_cfg: LossConfig,
                   K_trg: Optional[torch.Tensor] = None,
                   gt_disparity: Optional[torch.Tensor] = None,
                   gt_valid: Optional[torch.Tensor] = None,
                   alpha_coverage_weight: float = 1.0,
                   render_cfg: RenderConfig = RenderConfig(use_pallas="off"),
                   data_group=None) -> Dict[str, torch.Tensor]:
    """The MPI baseline's training loss: ``{"total", parts...}``.

    * ``photo_mpi``: Charbonnier of the homography-warped over-composite
      against the target (``splat_weight`` x the mean);
    * ``alpha_coverage``: mean (1 - accumulated alpha)^2, without which an
      all-transparent MPI zeroes the photometric gradient;
    * ``smoothness``: :func:`mpi_smoothness` of the expected source
      disparity (``smoothness_weight`` > 0);
    * ``depth_supervision``: Charbonnier of that disparity against ground
      truth, where the batch has it (``depth_supervision_weight`` > 0).
    ``render_cfg`` picks the warp's route (``models.mpi.render_mpi``).
    With a ``data_group`` the parts are the global batch's (module
    docstring).
    """
    out = render_mpi(mpi, pose_src2trg, K_trg=K_trg,
                     out_hw=tuple(target_image.shape[1:3]),
                     use_pallas=render_cfg.use_pallas,
                     pallas_max_dy=render_cfg.pallas_max_dy)
    err = _charbonnier(out["rgb"] - target_image.float()).mean(
        -1, keepdim=True)
    parts = {
        "photo_mpi": loss_cfg.splat_weight * batch_mean(err, data_group),
        "alpha_coverage": alpha_coverage_weight * batch_mean(
            (1.0 - out["alpha"]) ** 2, data_group),
    }
    src_disp = mpi_source_disparity(mpi)
    if loss_cfg.smoothness_weight > 0:
        parts["smoothness"] = loss_cfg.smoothness_weight * mpi_smoothness(
            src_disp, src_image, loss_cfg.edge_aware_smoothness,
            data_group)
    if loss_cfg.depth_supervision_weight > 0 and gt_disparity is not None:
        if gt_valid is None:
            gt_valid = torch.ones_like(gt_disparity)
        err_d = _charbonnier(src_disp - gt_disparity) * gt_valid
        parts["depth_supervision"] = (
            loss_cfg.depth_supervision_weight
            * divide_safe(batch_sum(err_d, data_group),
                          batch_sum(gt_valid, data_group)))
    parts["total"] = sum(parts.values())
    return parts
