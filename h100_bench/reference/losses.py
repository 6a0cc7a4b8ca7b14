"""The LDI training losses, copied from ``lsi_tpu_torch/losses/losses.py``
(one process: every batch sum is a plain ``sum``) and the SSIM of
``evaluation/metrics.py``. ``loss`` and ``render`` are the
configuration's sections as dicts; ``prec`` is passed to every splat and
gather.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from h100_bench.reference.geometry import (LDI, bilinear_sample,
                                           disocclusion_mask, divide_safe,
                                           invert_pose,
                                           project_layers_folded,
                                           render_forward, route_max_dy,
                                           window_dropped_fraction, windowed)
from h100_bench.reference.precision import REFERENCE, Precision

BIG_ERROR = 1e3


def _abs(x):
    return torch.where(x >= 0, x, -x)


def _charbonnier(x, eps: float = 1e-4):
    return torch.sqrt(x * x + eps * eps)


def _gaussian_kernel(size=11, sigma=1.5, device=None):
    xs = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d(img, k1d):
    size = k1d.shape[0]

    def conv_axis(x, axis):
        n = x.shape[axis]
        slices = [x.narrow(axis, i, n - size + 1) for i in range(size)]
        return sum(k1d[i] * slices[i] for i in range(size))

    return conv_axis(conv_axis(img, 1), 2)


def ssim(pred, target, mask=None, max_val: float = 1.0):
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    k = _gaussian_kernel(device=pred.device)
    x, y = pred.float(), target.float()
    if mask is None:
        def fmean(z):
            return _filter2d(z, k)
        weight = None
    else:
        m = mask.float()
        x, y = x * m, y * m
        msum = _filter2d(m, k)

        def fmean(z):
            return _filter2d(z, k) / torch.clamp(msum, min=1e-8)
        weight = msum
    mu_x, mu_y = fmean(x), fmean(y)
    mu_x2, mu_y2, mu_xy = mu_x ** 2, mu_y ** 2, mu_x * mu_y
    sigma_x = fmean(x * x) - mu_x2
    sigma_y = fmean(y * y) - mu_y2
    sigma_xy = fmean(x * y) - mu_xy
    score = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)
             / ((mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2)))
    if weight is None:
        return score.mean()
    w = weight.expand_as(score)
    return (score * w).sum() / torch.clamp(w.sum(), min=1e-8)


def _candidate_errors(ldi, target_image, pose, tex, radius, render, prec):
    b, l, h, w, _ = ldi.textures.shape
    trg_coords, _, in_front = project_layers_folded(ldi, pose)
    k = (2 * radius + 1) ** 2
    coords = trg_coords.reshape(b, 1, l * h, w, 2)
    if radius > 0:
        offsets = torch.tensor(
            [[dx, dy] for dy in range(-radius, radius + 1)
             for dx in range(-radius, radius + 1)],
            dtype=torch.float32, device=trg_coords.device)
        coords = coords + offsets[None, :, None, None, :]
    coords = coords.reshape(b, k * l * h, w, 2)
    max_dy = route_max_dy(render, render["pallas_max_dy"] + radius,
                          tuple(target_image.shape[1:3]) == (h, w))
    sampled, in_bounds = bilinear_sample(target_image.float(), coords, max_dy,
                                         prec=prec)

    def per_offset(x):
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


def view_synthesis_inverse_warp(ldi, target_image, pose, render,
                                min_over_layers=True, candidate_radius=0,
                                layer0_margin=0.0, return_diag=False,
                                prec: Precision = REFERENCE):
    b, l, h, w, _ = ldi.textures.shape
    tex = ldi.textures.float().reshape(b * l, h, w, 3)
    err_masked, valid, trg_coords, in_front = _candidate_errors(
        ldi, target_image, pose, tex, candidate_radius, render, prec)
    err_masked = err_masked.reshape(b, l, h, w, 1)
    valid = valid.reshape(b, l, h, w, 1)
    if min_over_layers:
        if layer0_margin > 0.0 and l > 1:
            is_deep = (torch.arange(l, device=tex.device) > 0)[
                None, :, None, None, None]
            err_masked = torch.where(is_deep, err_masked + layer0_margin,
                                     err_masked)
        per_pixel = err_masked.amin(dim=1)
    else:
        per_pixel = divide_safe(
            torch.where(valid > 0.5, err_masked, 0.0).sum(dim=1),
            valid.sum(dim=1))
    any_valid = valid.amax(dim=1)
    per_pixel = torch.where(any_valid > 0.5, per_pixel, 0.0)
    loss = divide_safe(per_pixel.sum(), any_valid.sum())
    if not return_diag:
        return loss
    diag = {}
    if (render["window_check"] and candidate_radius == 0 and windowed(render)
            and tuple(target_image.shape[1:3]) == (h, w)):
        diag["window_dropped_frac"] = window_dropped_fraction(
            trg_coords.detach(), in_front.detach(), (h, w),
            render["pallas_max_dy"])
    return loss, diag


def view_synthesis_splat(ldi, target_image, pose, render, ssim_weight=0.0,
                         prec: Precision = REFERENCE):
    out = render_forward(ldi, pose, render,
                         out_hw=tuple(target_image.shape[1:3]),
                         check_window=render["window_check"], prec=prec)
    covered = (out["coverage"] > 0).float()
    trg32 = target_image.float()
    err = _charbonnier(out["rgb"] - trg32).mean(-1, keepdim=True)
    photo = divide_safe((err * covered).sum(), covered.sum())
    if ssim_weight > 0.0:
        structural = (1.0 - ssim(out["rgb"], trg32, mask=covered)) / 2.0
        photo = ssim_weight * structural + (1.0 - ssim_weight) * photo
    return photo, {"window_dropped_frac": out["window_dropped_frac"]}


def disparity_smoothness(ldi, edge_aware=True, edge_gate_deep=True):
    d = ldi.disparities[..., 0]
    dx = _abs(d[..., :, 1:] - d[..., :, :-1])
    dy = _abs(d[..., 1:, :] - d[..., :-1, :])
    if edge_aware:
        img = ldi.textures[:, 0].float()
        gx = _abs(img[:, :, 1:] - img[:, :, :-1]).mean(-1)
        gy = _abs(img[:, 1:, :] - img[:, :-1, :]).mean(-1)
        wx = torch.exp(-10.0 * gx)[:, None]
        wy = torch.exp(-10.0 * gy)[:, None]
        if not edge_gate_deep and d.shape[1] > 1:
            layer_is_0 = (torch.arange(d.shape[1], device=d.device) == 0)[
                None, :, None, None]
            wx = torch.where(layer_is_0, wx, 1.0)
            wy = torch.where(layer_is_0, wy, 1.0)
        dx, dy = dx * wx, dy * wy
    return dx.mean() + dy.mean()


def depth_consistency(ldi_src, ldi_trg, pose, render, stop_target=False,
                      disocc_only=False, visible_only=False, deep_only=False,
                      prec: Precision = REFERENCE):
    if deep_only:
        d = ldi_src.disparities
        ldi_src = dataclasses.replace(
            ldi_src, disparities=torch.cat([d[:, :1].detach(), d[:, 1:]], 1))
    out_hw = tuple(ldi_trg.disparities.shape[2:4])
    out = render_forward(ldi_src, pose, render, out_hw=out_hw,
                         check_window=False, prec=prec)
    wsum = out["coverage"]
    rendered_disp = divide_safe(out["disparity"] * wsum, wsum, eps=1e-30)
    mask = (wsum > 1e-30).float()
    if disocc_only or visible_only:
        disocc = disocclusion_mask(ldi_src, pose, render, out_hw=out_hw,
                                   prec=prec)
        mask = mask * (disocc if disocc_only else 1.0 - disocc)
    target = ldi_trg.disparities[:, 0]
    if stop_target:
        target = target.detach()
    err = _charbonnier(rendered_disp - target)
    return divide_safe((err * mask).sum(), mask.sum())


def depth_supervision(ldi, gt_disparity, valid):
    err = _charbonnier(ldi.disparities[:, 0] - gt_disparity) * valid
    return divide_safe(err.sum(), valid.sum())


def total_loss(ldi, target_image, pose, loss: dict, render: dict,
               gt_disparity=None, gt_valid=None,
               prec: Precision = REFERENCE) -> Dict[str, torch.Tensor]:
    parts, diags = {}, {}
    mode = loss["photo_mode"]
    if mode not in ("inverse_warp", "splat", "both"):
        raise ValueError(f"unknown photo_mode {mode!r}")
    if mode in ("inverse_warp", "both"):
        inv, diag = view_synthesis_inverse_warp(
            ldi, target_image, pose, render,
            min_over_layers=loss["min_over_layers"],
            candidate_radius=loss["candidate_radius"],
            layer0_margin=loss["min_layer0_margin"], return_diag=True,
            prec=prec)
        parts["photo_inverse_warp"] = loss["inverse_warp_weight"] * inv
        diags.update(diag)
    if mode in ("splat", "both"):
        sp, diag = view_synthesis_splat(ldi, target_image, pose, render,
                                        loss["ssim_weight"], prec=prec)
        parts["photo_splat"] = loss["splat_weight"] * sp
        diags.update(diag)
    if loss["photo_layer0_weight"] > 0 and ldi.textures.shape[1] > 1:
        layer0 = LDI(ldi.textures[:, :1], ldi.disparities[:, :1],
                     ldi.intrinsics)
        parts["photo_layer0"] = loss["photo_layer0_weight"] * \
            view_synthesis_inverse_warp(layer0, target_image, pose, render,
                                        min_over_layers=False, prec=prec)
    if loss["smoothness_weight"] > 0:
        parts["smoothness"] = loss["smoothness_weight"] * disparity_smoothness(
            ldi, loss["edge_aware_smoothness"],
            loss["smoothness_edge_gate_deep"])
    if loss["depth_supervision_weight"] > 0 and gt_disparity is not None:
        if gt_valid is None:
            gt_valid = torch.ones_like(gt_disparity)
        parts["depth_supervision"] = (loss["depth_supervision_weight"]
                                      * depth_supervision(ldi, gt_disparity,
                                                          gt_valid))
    parts["total"] = sum(parts.values())
    parts.update(diags)
    return parts


def total_loss_bidirectional(ldi_src, ldi_trg, src_image, trg_image, pose,
                             loss: dict, render: dict, gt_disparity=None,
                             gt_valid=None, prec: Precision = REFERENCE):
    parts = total_loss(ldi_src, trg_image, pose, loss, render,
                       gt_disparity=gt_disparity, gt_valid=gt_valid,
                       prec=prec)
    total = parts.pop("total")
    pose_rev = invert_pose(pose)
    if loss["symmetric"]:
        rev = total_loss(ldi_trg, src_image, pose_rev, loss, render,
                         prec=prec)
        total = total + rev.pop("total")
        for k, v in rev.items():
            parts[f"{k}_rev"] = v
    terms = []
    if loss["consistency_weight"] > 0:
        terms.append(("depth_consistency", loss["consistency_weight"], dict(
            stop_target=loss["consistency_stop_target"],
            disocc_only=loss["consistency_disocc_only"],
            deep_only=loss["consistency_deep_only"])))
    if loss["consistency_anchor_weight"] > 0:
        terms.append(("depth_anchor", loss["consistency_anchor_weight"],
                      dict(visible_only=True)))
    for name, weight, kw in terms:
        both = (depth_consistency(ldi_src, ldi_trg, pose, render, prec=prec,
                                  **kw)
                + depth_consistency(ldi_trg, ldi_src, pose_rev, render,
                                    prec=prec, **kw))
        parts[name] = weight * both
        total = total + parts[name]
    parts["total"] = total
    return parts



def check_supported(loss: dict) -> None:
    """Raise where the configuration asks for a term this copy lacks."""
    if loss["consistency_ema_teacher"]:
        raise NotImplementedError("the reference has no EMA teacher")
