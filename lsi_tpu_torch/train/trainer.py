"""The training step: model forward, differentiable render and gather,
losses, backward and the optimizer update.

PyTorch counterpart of ``lsi_tpu/train/trainer.py`` (``make_lr_schedule``,
``make_optimizer`` as the ``Optimizer`` class, ``create_state``,
``_truncate_ldi``, ``make_train_step`` with its ``stage_layer0`` and
``freeze_layer0`` variants). The optimizer is optax's chain written out as plain tensor ops,
so that it matches the JAX package step for step:

    apply_if_finite(chain(clip_by_global_norm(grad_clip_norm),
                          adam(warmup_cosine_decay_schedule, b1, b2)),
                    max_consecutive_errors=100)

* the clip scales by ``max / norm`` only when ``norm >= max`` (no epsilon);
* Adam adds ``eps = 1e-8`` outside the square root and corrects the bias
  by the count of applied updates;
* the learning rate is read at the count BEFORE it is incremented, so the
  first step has lr = 0 and leaves the parameters unchanged;
* a step whose gradients hold a non-finite value is skipped: parameters,
  moments and the count stay as they were and the error counters move;
  after 100 consecutive skips updates pass through again.

Unlike the JAX step, which returns a new state, ``step_fn`` updates the
state in place (parameters, moments, counters) and returns it.

Not ported yet (raise ``NotImplementedError``; ROADMAP Queue 1): the
two-prediction losses (``consistency_weight``,
``consistency_anchor_weight``, ``symmetric``), ``remat_decoder`` and
``family="mpi"``; the EMA teacher is a refuted knob and is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from lsi_tpu_torch.api import check_render_config
from lsi_tpu_torch.config import Config
from lsi_tpu_torch.data.pipeline import Batch, decode_batch
from lsi_tpu_torch.geometry.ldi import LDI
from lsi_tpu_torch.losses.losses import check_loss_config, total_loss
from lsi_tpu_torch.models.ldi_predictor import (LDIPredictor,
                                                freeze_layer0_grad_mask)

# optax.adam's default epsilon, added outside the square root.
ADAM_EPS = 1e-8
# optax.apply_if_finite(max_consecutive_errors=...) as the JAX trainer sets it.
MAX_CONSECUTIVE_ERRORS = 100


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, horizon, lr * end):
    linear warmup from 0, then cosine decay to ``lr * lr_end_factor`` at
    the horizon (``decay_steps``, else ``max_steps``). Evaluated in float32
    op by op, as optax does."""
    t = cfg.train
    f32 = np.float32
    peak = t.learning_rate
    warmup = t.warmup_steps
    horizon = max(t.decay_steps or t.max_steps, warmup + 1)
    decay_steps = horizon - warmup
    alpha = 0.0 if peak == 0.0 else peak * t.lr_end_factor / peak

    def schedule(count: int) -> float:
        if count < warmup:
            # optax.linear_schedule(0, peak, warmup).
            frac = f32(1) - f32(count) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c
                                             / f32(decay_steps)))
        return float(f32(peak) * (f32(1.0 - alpha) * cosine + f32(alpha)))

    return schedule


@dataclasses.dataclass
class OptState:
    """The optimizer chain's state, by parameter name."""
    mu: Dict[str, torch.Tensor]   # Adam's first moment
    nu: Dict[str, torch.Tensor]   # Adam's second moment
    count: int = 0                # updates applied (optax keeps this twice,
                                  # in scale_by_adam and scale_by_schedule)
    notfinite_count: int = 0      # consecutive steps with non-finite grads
    total_notfinite: int = 0
    last_finite: bool = True


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.sqrt(sum((g * g).sum() for g in tree.values()))


class Optimizer:
    """The optax chain of ``lsi_tpu.train.trainer.make_optimizer(cfg)``:
    ``Optimizer(cfg)`` is its counterpart."""

    def __init__(self, cfg: Config):
        t = cfg.train
        self.schedule = make_lr_schedule(cfg)
        self.clip_norm = t.grad_clip_norm
        self.b1 = t.adam_b1
        self.b2 = t.adam_b2
        self.skip_nonfinite = t.skip_nonfinite_updates

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        return OptState(
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(self, grads: Dict[str, torch.Tensor], state: OptState,
               norm: torch.Tensor) -> Optional[Dict[str, torch.Tensor]]:
        """The updates to add to the parameters, or None for a skipped
        step; advances ``state`` in place. ``norm`` is
        ``global_norm(grads)``."""
        norm_host = float(norm)  # one host sync per step
        # A finite norm means finite entries; an infinite one may come from
        # finite entries whose squares overflow, so look at the entries.
        finite = math.isfinite(norm_host) or all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        state.last_finite = finite
        if finite:
            state.notfinite_count = 0
        else:
            state.notfinite_count += 1
            state.total_notfinite += 1
            if (self.skip_nonfinite
                    and state.notfinite_count <= MAX_CONSECUTIVE_ERRORS):
                return None

        if not norm_host < self.clip_norm:
            grads = {k: (g / norm) * self.clip_norm for k, g in grads.items()}
        lr = self.schedule(state.count)
        state.count += 1
        # Bias corrections in float32, as optax computes them.
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(state.count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(state.count))
        updates = {}
        for k, g in grads.items():
            mu = (1.0 - self.b1) * g + self.b1 * state.mu[k]
            nu = (1.0 - self.b2) * (g * g) + self.b2 * state.nu[k]
            state.mu[k] = mu
            state.nu[k] = nu
            updates[k] = -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))
        return updates


@dataclasses.dataclass
class TrainState:
    """The network (its parameters), the optimizer state and the number of
    steps taken, applied or skipped."""
    net: LDIPredictor
    opt_state: OptState
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.named_parameters())


def check_train_config(cfg: Config) -> None:
    """Reject the training options the port does not implement."""
    if cfg.model.family != "ldi":
        raise NotImplementedError(
            f"model family {cfg.model.family!r} is not ported yet (ROADMAP "
            "Queue 1, M11)")
    lc = cfg.loss
    if lc.consistency_weight > 0 or lc.consistency_anchor_weight > 0 \
            or lc.symmetric:
        raise NotImplementedError(
            "the two-prediction losses (consistency_weight, "
            "consistency_anchor_weight, symmetric) are not ported yet "
            "(ROADMAP Queue 1, M6 'total_loss_bidirectional')")
    if lc.consistency_ema_teacher:
        raise NotImplementedError(
            "consistency_ema_teacher is a refuted knob and is not ported "
            "(ROADMAP 'Do not port')")
    if cfg.train.remat_decoder:
        raise NotImplementedError(
            "remat_decoder is not ported yet (ROADMAP Queue 1, M8)")
    check_loss_config(lc)
    check_render_config(cfg.render)


def create_state(cfg: Config, seed: int = 0, device="cuda") -> TrainState:
    """Random parameters drawn from ``seed`` (on the CPU, so every device
    gets the same ones), moved to ``device`` (the card unless the caller
    asks for the CPU), and a fresh optimizer state."""
    check_train_config(cfg)
    net = LDIPredictor(cfg.model)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    net = net.to(device)
    return TrainState(net=net, opt_state=Optimizer(cfg).init(
        {k: p.detach() for k, p in net.named_parameters()}))


def _truncate_ldi(ldi: LDI, num_layers: int) -> LDI:
    """Keep the first ``num_layers`` layers of an LDI (staged training)."""
    return dataclasses.replace(
        ldi, textures=ldi.textures[:, :num_layers],
        disparities=ldi.disparities[:, :num_layers])


def loss_and_grads(state: TrainState, batch: Batch, cfg: Config,
                   stage_layer0: bool = False):
    """The loss parts of one batch and the gradient of ``total`` with
    respect to every parameter (zeros where it does not reach one):
    ``(parts, {name: grad})``. The two halves are profiler ranges
    ``train_step/forward_loss`` and ``train_step/backward``."""
    params = state.params()
    with record_function("train_step/forward_loss"):
        batch = decode_batch(batch)
        pred = state.net(batch.src_image, batch.intrinsics)
        if stage_layer0:
            pred = _truncate_ldi(pred, 1)
        parts = total_loss(pred, batch.trg_image, batch.pose_src2trg,
                           cfg.loss, cfg.render,
                           gt_disparity=batch.gt_disparity,
                           gt_valid=batch.gt_valid)
    with record_function("train_step/backward"):
        grads = torch.autograd.grad(parts["total"], list(params.values()),
                                    allow_unused=True)
    return parts, {k: torch.zeros_like(p) if g is None else g
                   for (k, p), g in zip(params.items(), grads)}


def make_train_step(cfg: Config, stage_layer0: bool = False,
                    freeze_layer0: bool = False):
    """Build ``step_fn(state, batch) -> (state, metrics)``.

    ``metrics`` holds the loss parts, ``total``, ``window_dropped_frac``
    (always 0: the port's splat is exact) and ``grad_norm``, as 0-d
    tensors on the state's device. The update is the profiler range
    ``train_step/optimizer``.

    With ``stage_layer0`` the loss sees only layer 0 of the prediction, so
    the deep heads get no gradient. With ``freeze_layer0`` the gradients
    AND the updates of every parameter entry layer 0's output depends on
    are zeroed, so layer 0 stays bitwise constant
    (``models.ldi_predictor.freeze_layer0_grad_mask``).
    """
    check_train_config(cfg)
    opt = Optimizer(cfg)

    def step_fn(state: TrainState, batch: Batch):
        parts, grads = loss_and_grads(state, batch, cfg, stage_layer0)
        with record_function("train_step/optimizer"):
            if freeze_layer0:
                grads = freeze_layer0_grad_mask(cfg.model, grads)
            norm = global_norm(grads)
            updates = opt.update(grads, state.opt_state, norm)
            if updates is not None:
                if freeze_layer0:
                    updates = freeze_layer0_grad_mask(cfg.model, updates)
                with torch.no_grad():
                    for k, p in state.params().items():
                        p.add_(updates[k])
        state.step += 1
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics["grad_norm"] = norm
        return state, metrics

    return step_fn
