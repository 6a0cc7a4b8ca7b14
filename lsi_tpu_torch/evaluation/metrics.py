"""Evaluation metrics: image quality (PSNR, SSIM) and depth accuracy.

PyTorch counterpart of ``lsi_tpu/evaluation/metrics.py``: plain tensor
code, the same arithmetic in the same order (the separable SSIM filter
sums its 11 shifted slices as the JAX version does).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from lsi_tpu_torch.parallel.reduce import batch_mean, batch_sum


def psnr(pred: torch.Tensor, target: torch.Tensor,
         mask: Optional[torch.Tensor] = None,
         max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the batch (0-d, dB)."""
    err = (pred.float() - target.float()) ** 2
    if mask is not None:
        mse = (err * mask).sum() / torch.clamp(
            mask.sum() * err.shape[-1] / mask.shape[-1], min=1e-8)
    else:
        mse = err.mean()
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d(img: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' filter on (B, H, W, C): along H, then along W."""
    size = k1d.shape[0]

    def conv_axis(x, axis):
        n = x.shape[axis]
        slices = [x.narrow(axis, i, n - size + 1) for i in range(size)]
        return sum(k1d[i] * slices[i] for i in range(size))

    return conv_axis(conv_axis(img, 1), 2)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         mask: Optional[torch.Tensor] = None,
         data_group=None) -> torch.Tensor:
    """Mean SSIM over the batch, 11x11 Gaussian windows (sigma 1.5).

    Inputs (B, H, W, C) in [0, max_val]; returns a 0-d tensor. With
    ``mask`` (B, H, W, 1), window statistics are taken over the masked
    pixels only (means and variances renormalised by the window's mask
    mass) and each window's score is weighted by that mass. With a
    ``data_group`` the mean is over the global batch of those ranks (the
    data-parallel training loss; ``parallel.reduce``).
    """
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    k = _gaussian_kernel(device=pred.device)
    x = pred.float()
    y = target.float()
    if mask is None:
        def fmean(z):
            return _filter2d(z, k)
        weight = None
    else:
        m = mask.float()
        x = x * m
        y = y * m
        msum = _filter2d(m, k)  # (B, H', W', 1), in (0, 1]

        def fmean(z):
            return _filter2d(z, k) / torch.clamp(msum, min=1e-8)
        weight = msum
    mu_x = fmean(x)
    mu_y = fmean(y)
    mu_x2, mu_y2, mu_xy = mu_x ** 2, mu_y ** 2, mu_x * mu_y
    sigma_x = fmean(x * x) - mu_x2
    sigma_y = fmean(y * y) - mu_y2
    sigma_xy = fmean(x * y) - mu_xy
    score = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)
             / ((mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2)))
    if weight is None:
        return batch_mean(score, data_group)
    w = weight.expand_as(score)
    return batch_sum(score * w, data_group) / torch.clamp(
        batch_sum(w, data_group), min=1e-8)


def depth_metrics(pred_disparity: torch.Tensor, gt_disparity: torch.Tensor,
                  valid: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Monocular-depth metrics on disparity maps (B, H, W, 1): abs_rel and
    rmse in depth space, delta thresholds on the max ratio; pixels with
    invalid ground truth are masked."""
    if valid is None:
        valid = (gt_disparity > 1e-6).float()
    eps = 1e-6
    pred_d = 1.0 / torch.clamp(pred_disparity, min=eps)
    gt_d = 1.0 / torch.clamp(gt_disparity, min=eps)
    n = torch.clamp(valid.sum(), min=1.0)

    abs_rel = ((pred_d - gt_d).abs() / gt_d * valid).sum() / n
    rmse = torch.sqrt(((pred_d - gt_d) ** 2 * valid).sum() / n)
    ratio = torch.maximum(pred_d / gt_d, gt_d / pred_d)
    ratio = torch.where(valid > 0, ratio, torch.full_like(ratio, float("inf")))

    def delta(t):
        return (ratio < t).float().sum() / n

    return {
        "abs_rel": abs_rel,
        "rmse": rmse,
        "delta_1.25": delta(1.25),
        "delta_1.25^2": delta(1.25 ** 2),
        "delta_1.25^3": delta(1.25 ** 3),
    }
