"""The training step: the two-prediction loss, its gradient and the optax
chain ``apply_if_finite(chain(clip_by_global_norm, adam(warmup cosine)))``
as plain tensor ops.

Copied from ``lsi_tpu_torch/train/trainer.py`` (``make_lr_schedule``,
``Optimizer.update``, ``global_norm``, ``loss_and_grads`` and
``make_train_step`` for the "full" phase: no staging, no freeze, no EMA
teacher). ``train`` is the configuration's train section as a dict.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from h100_bench.reference.losses import (check_supported, total_loss,
                                         total_loss_bidirectional)
from h100_bench.reference.net import predict
from h100_bench.reference.precision import REFERENCE, Precision

ADAM_EPS = 1e-8


def lr_at(train: dict, count: int) -> float:
    """optax.warmup_cosine_decay_schedule in float32, op by op."""
    f32 = np.float32
    peak = train["learning_rate"]
    warmup = train["warmup_steps"]
    horizon = max(train["decay_steps"] or train["max_steps"], warmup + 1)
    decay_steps = horizon - warmup
    alpha = 0.0 if peak == 0.0 else peak * train["lr_end_factor"] / peak
    if count < warmup:
        frac = f32(1) - f32(count) / f32(warmup)
        return float(f32(0.0 - peak) * frac + f32(peak))
    c = f32(min(count - warmup, decay_steps))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps)))
    return float(f32(peak) * (f32(1.0 - alpha) * cosine + f32(alpha)))


class Adam:
    """The chain's state and update; ``step`` applies one update in place,
    in the parameters' dtype."""

    def __init__(self, train: dict, params: Dict[str, torch.Tensor]):
        self.train = train
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0
        self.notfinite = 0

    def step(self, params, grads) -> None:
        t = self.train
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        norm_host = float(norm)
        finite = math.isfinite(norm_host) or all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        if finite:
            self.notfinite = 0
        else:
            self.notfinite += 1
            if t["skip_nonfinite_updates"] and self.notfinite <= 100:
                return
        if not norm_host < t["grad_clip_norm"]:
            grads = {k: (g / norm) * t["grad_clip_norm"]
                     for k, g in grads.items()}
        lr = lr_at(t, self.count)
        self.count += 1
        b1, b2 = t["adam_b1"], t["adam_b2"]
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.count))
        with torch.no_grad():
            for k, g in grads.items():
                self.mu[k] = (1.0 - b1) * g + b1 * self.mu[k]
                self.nu[k] = (1.0 - b2) * (g * g) + b2 * self.nu[k]
                params[k].add_(-lr * ((self.mu[k] / bc1)
                                      / (torch.sqrt(self.nu[k] / bc2)
                                         + ADAM_EPS)))


def loss_and_grads(params, batch: dict, cfg: dict,
                   prec: Precision = REFERENCE):
    """(loss parts as floats, {name: gradient}) of one batch: one forward
    over both views when the loss takes two predictions."""
    model, loss, render = cfg["model"], cfg["loss"], cfg["render"]
    check_supported(loss)
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    src, trg = batch["src_image"].float(), batch["trg_image"].float()
    K, pose = batch["intrinsics"].float(), batch["pose_src2trg"].float()
    gt, gt_valid = batch.get("gt_disparity"), batch.get("gt_valid")
    two = (loss["consistency_weight"] > 0
           or loss["consistency_anchor_weight"] > 0 or loss["symmetric"])
    with torch.enable_grad():
        if two:
            b = src.shape[0]
            both = predict(leaves, torch.cat([src, trg]), torch.cat([K, K]),
                           model, prec)
            halves = [type(both)(both.textures[sl], both.disparities[sl],
                                 both.intrinsics[sl])
                      for sl in (slice(0, b), slice(b, None))]
            parts = total_loss_bidirectional(
                halves[0], halves[1], src, trg, pose, loss, render,
                gt_disparity=gt, gt_valid=gt_valid, prec=prec)
        else:
            pred = predict(leaves, src, K, model, prec)
            parts = total_loss(pred, trg, pose, loss, render,
                               gt_disparity=gt, gt_valid=gt_valid, prec=prec)
        names = list(leaves)
        grads = torch.autograd.grad(parts["total"],
                                    [leaves[k] for k in names],
                                    allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(names, grads)}
    return {k: float(v.detach()) for k, v in parts.items()}, grads


def follow(params, batches: List[dict], cfg: dict,
           prec: Precision = REFERENCE):
    """The first ``len(batches)`` steps from ``params`` (a fresh optimizer):
    each step's loss parts, the first gradient as the optimizer takes it
    (clipped) and the parameters after the last step. ``params`` is not
    changed."""
    params = {k: p.detach().clone() for k, p in params.items()}
    adam = Adam(cfg["train"], params)
    losses, first = [], None
    for batch in batches:
        parts, grads = loss_and_grads(params, batch, cfg, prec)
        losses.append(parts)
        adam.step(params, grads)
        if first is None:
            first = {k: m / (1.0 - cfg["train"]["adam_b1"])
                     for k, m in adam.mu.items()}
    return losses, first, params
