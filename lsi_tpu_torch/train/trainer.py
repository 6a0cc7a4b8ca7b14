"""The training step (model forward, differentiable render and gather,
losses, backward and the optimizer update) and the training loop.

PyTorch counterpart of ``lsi_tpu/train/trainer.py`` (``make_lr_schedule``,
``make_optimizer`` as the ``Optimizer`` class, ``create_state``,
``_truncate_ldi``, ``make_train_step`` with its two-prediction path, its
MPI-baseline path and its ``stage_layer0`` and ``freeze_layer0``
variants, and ``Trainer``). The model comes from ``models.build_model``:
the LDI predictor or the MPI baseline (``model.family``).
The optimizer is optax's chain written out as plain tensor ops, so that it
matches the JAX package step for step:

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

Data parallelism (JAX: the step sharded over a ``MeshPlan``) takes a
``parallel.mesh.ProcessPlan``: each rank holds its share of the global
batch, the losses take their batch sums over the plan's data group
(``ProcessPlan.batch_group``, passed to them as ``data_group``), and the
ranks' gradients are summed before the
optimizer, so the clip, the finiteness test and the schedule see the
global batch's gradient and every rank applies the same update.

``train.remat_decoder`` recomputes the network's forward in the
backward instead of keeping its activations (JAX: ``jax.checkpoint``
around the model apply; here ``torch.utils.checkpoint`` around every call
of the network in the step, :func:`apply_net`). The refuted knobs (the
EMA teacher, ``consistency_stop_step``) are not ported (ROADMAP "Do not
port").
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from lsi_tpu_torch.api import check_render_config
from lsi_tpu_torch.config import Config
from lsi_tpu_torch.data.pipeline import Batch, decode_batch, make_dataset
from lsi_tpu_torch.device import resolve_device
from lsi_tpu_torch.evaluation.runner import (build_eval_step,
                                             eval_data_config,
                                             export_image_grid, to_floats)
from lsi_tpu_torch.geometry.ldi import LDI, warn_window_drop
from lsi_tpu_torch.losses.losses import (check_loss_config, mpi_total_loss,
                                         total_loss,
                                         total_loss_bidirectional)
from lsi_tpu_torch.models import build_model
from lsi_tpu_torch.models.ldi_predictor import (freeze_layer0_grad_mask,
                                                splice_layer0_params)
from lsi_tpu_torch.parallel.mesh import (ProcessPlan, all_reduce_grads,
                                         assert_divisible, barrier,
                                         batch_slice, broadcast_flag,
                                         broadcast_params)
from lsi_tpu_torch.train.checkpoint import (CheckpointManager,
                                            export_params_npz,
                                            import_params_npz,
                                            read_params_npz_meta)
from lsi_tpu_torch.train.metrics import MetricWriter

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
    """The network (its parameters: an ``LDIPredictor`` or an
    ``MPIPredictor``), the optimizer state and the number of steps taken,
    applied or skipped."""
    net: torch.nn.Module
    opt_state: OptState
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.named_parameters())


def check_train_config(cfg: Config) -> None:
    """Reject the training options the port does not implement."""
    if cfg.model.family not in ("ldi", "mpi"):
        raise ValueError(
            f"unknown model family {cfg.model.family!r}; use ldi|mpi")
    check_loss_config(cfg.loss)
    check_render_config(cfg.render)


def create_state(cfg: Config, seed: int = 0, device="cuda") -> TrainState:
    """Random parameters drawn from ``seed`` (on the CPU, so every device
    gets the same ones), moved to ``device`` (the card unless the caller
    asks for the CPU), and a fresh optimizer state."""
    check_train_config(cfg)
    net = build_model(cfg.model)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    net = net.to(device)
    return TrainState(net=net, opt_state=Optimizer(cfg).init(
        {k: p.detach() for k, p in net.named_parameters()}))


def _truncate_ldi(ldi: LDI, num_layers: int) -> LDI:
    """Keep the first ``num_layers`` layers of an LDI (staged training)."""
    return dataclasses.replace(
        ldi, textures=ldi.textures[:, :num_layers],
        disparities=ldi.disparities[:, :num_layers])


def apply_net(net: torch.nn.Module, image: torch.Tensor,
              intrinsics: torch.Tensor, remat: bool = False):
    """``net(image, intrinsics)``; with ``remat`` (``train.remat_decoder``)
    under ``torch.utils.checkpoint``: the forward keeps none of the
    network's activations and the backward runs it again to rebuild them.
    The network draws no random numbers, so the gradients are the same."""
    if not remat:
        return net(image, intrinsics)
    return checkpoint(net, image, intrinsics, use_reentrant=False)


def apply_model_pair(net: torch.nn.Module, image_a: torch.Tensor,
                     image_b: torch.Tensor, intrinsics: torch.Tensor,
                     remat: bool = False) -> Tuple[LDI, LDI]:
    """One forward over both views, stacked on the batch axis. The UNet
    works per sample (convolutions; GroupNorm normalises within each
    sample), so this equals two forwards with half the launches."""
    b = image_a.shape[0]
    both = apply_net(net, torch.cat([image_a, image_b]),
                     torch.cat([intrinsics, intrinsics]), remat)
    return tuple(LDI(textures=both.textures[sl],
                     disparities=both.disparities[sl],
                     intrinsics=both.intrinsics[sl])
                 for sl in (slice(0, b), slice(b, None)))


def loss_and_grads(state: TrainState, batch: Batch, cfg: Config,
                   stage_layer0: bool = False, data_group=None):
    """The loss parts of one batch and the gradient of ``total`` with
    respect to every parameter (zeros where it does not reach one):
    ``(parts, {name: grad})``. The two halves are profiler ranges
    ``train_step/forward_loss`` and ``train_step/backward``.

    The MPI baseline (``model.family="mpi"``) takes ``mpi_total_loss``
    (one prediction; ``stage_layer0`` does not apply to it). An LDI
    two-prediction config (``symmetric``, ``consistency_weight``,
    ``consistency_anchor_weight``) predicts from both views in one forward
    and takes ``total_loss_bidirectional``, except in the
    ``stage_layer0`` step, which keeps the single prediction. With a
    ``data_group`` (``ProcessPlan.batch_group``) the parts are the global
    batch's and the gradients this rank's share of the global gradient
    (``parallel.reduce``). Every call of the network goes through
    :func:`apply_net` (``train.remat_decoder``)."""
    params = state.params()
    lc = cfg.loss
    remat = cfg.train.remat_decoder
    mpi = cfg.model.family == "mpi"
    two_predictions = not mpi and (lc.consistency_weight > 0
                                   or lc.consistency_anchor_weight > 0
                                   or lc.symmetric)
    with record_function("train_step/forward_loss"):
        batch = decode_batch(batch)
        if mpi:
            pred = apply_net(state.net, batch.src_image, batch.intrinsics,
                             remat)
            parts = mpi_total_loss(
                pred, batch.src_image, batch.trg_image, batch.pose_src2trg,
                cfg.loss, gt_disparity=batch.gt_disparity,
                gt_valid=batch.gt_valid, render_cfg=cfg.render,
                data_group=data_group)
        elif two_predictions and not stage_layer0:
            pred, pred_trg = apply_model_pair(
                state.net, batch.src_image, batch.trg_image, batch.intrinsics,
                remat)
            parts = total_loss_bidirectional(
                pred, pred_trg, batch.src_image, batch.trg_image,
                batch.pose_src2trg, cfg.loss, cfg.render,
                gt_disparity=batch.gt_disparity, gt_valid=batch.gt_valid,
                data_group=data_group)
        else:
            pred = apply_net(state.net, batch.src_image, batch.intrinsics,
                             remat)
            if stage_layer0:
                pred = _truncate_ldi(pred, 1)
            parts = total_loss(pred, batch.trg_image, batch.pose_src2trg,
                               cfg.loss, cfg.render,
                               gt_disparity=batch.gt_disparity,
                               gt_valid=batch.gt_valid,
                               data_group=data_group)
    with record_function("train_step/backward"):
        grads = torch.autograd.grad(parts["total"], list(params.values()),
                                    allow_unused=True)
    return parts, {k: torch.zeros_like(p) if g is None else g
                   for (k, p), g in zip(params.items(), grads)}


def make_train_step(cfg: Config, stage_layer0: bool = False,
                    freeze_layer0: bool = False,
                    plan: Optional[ProcessPlan] = None):
    """Build ``step_fn(state, batch) -> (state, metrics)``.

    ``metrics`` holds the loss parts, ``total``, ``window_dropped_frac``
    (the share of the content the vertical window of
    ``render.use_pallas="on"`` drops: the splat loss's render's, or with
    ``photo_mode="inverse_warp"`` the gather's, as in the JAX package; 0
    from the exact route's splat, absent from its gather) and
    ``grad_norm``, as 0-d tensors on the state's device. The update is the profiler range
    ``train_step/optimizer``.

    With ``stage_layer0`` the loss sees only layer 0 of the prediction, so
    the deep heads get no gradient. With ``freeze_layer0`` the gradients
    AND the updates of every parameter entry layer 0's output depends on
    are zeroed, so layer 0 stays bitwise constant
    (``models.ldi_predictor.freeze_layer0_grad_mask``).

    With a ``plan`` whose data axis has several ranks, ``batch`` is this
    rank's share of the global batch, and the loss parts, ``grad_norm``
    and the update are the global batch's on every rank (the gradients
    are summed in one collective, range ``train_step/all_reduce``).
    """
    check_train_config(cfg)
    opt = Optimizer(cfg)
    data_group = None if plan is None else plan.batch_group

    def step_fn(state: TrainState, batch: Batch):
        parts, grads = loss_and_grads(state, batch, cfg, stage_layer0,
                                      data_group)
        with record_function("train_step/all_reduce"):
            grads = all_reduce_grads(plan, grads)
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


class Trainer:
    """The training loop of ``lsi_tpu.train.trainer.Trainer``:

        state, metrics = Trainer(cfg).train()   # resumes automatically

    Phases, chosen per step in this order of precedence (the JAX order):
    ``stage`` (``train.stage_layer0_steps``), ``freeze``
    (``train.freeze_layer0_step`` on), ``warmup`` (before
    ``loss.consistency_start_step``: the full loss with
    ``consistency_weight=0``, the anchor kept), ``full``. An eval every
    ``train.eval_every`` steps writes ``eval_*`` metrics and an image grid,
    tracks layer-0 drift against the run's best ``eval_abs_rel``, and
    exports the params to ``best_params.npz`` (metadata inside, written
    atomically) when that improves. With ``train.freeze_layer0_from_best``
    the layer-0 parameters are spliced from that export when the run
    crosses the freeze step. With ``train.collapse_rollback_threshold``
    an eval whose drift crosses it restores every parameter from that
    export and re-initialises the optimizer (the warmup replays), at most
    ``train.collapse_max_rollbacks`` times a run (``rollback_state.json``),
    and checkpoints at once. A non-finite loss halts the run with a params
    dump outside the checkpoints.

    ``run_stamp.json`` holds a hash of the config (:func:`run_stamp`). A
    start that finds no checkpoint removes another run's best export and
    rollback budget from the directory, but keeps those of a run with the
    same stamp: that run crashed before its first checkpoint, and this is
    it again.

    ``device`` defaults to the card; with no CUDA device it raises (pass
    ``device="cpu"`` to train on the CPU).

    With a ``plan`` (``parallel.mesh.make_process_plan``, e.g. under
    ``torchrun``) the run is data-parallel: ``data.batch_size`` is the
    global batch, every rank makes it from the seed and steps on its
    share, every rank restores the checkpoint on resume, and rank 0 alone
    writes the jsonl, the checkpoints and the best export, runs the evals
    on whole batches (the numbers of a one-process run), and splices
    layer 0 at the freeze, whose parameters it then broadcasts. Rank 0
    decides a rollback; every rank then takes its parameters and a fresh
    optimizer state.
    """

    BEST_NPZ = "best_params.npz"
    ROLLBACK_JSON = "rollback_state.json"
    RUN_STAMP = "run_stamp.json"

    def __init__(self, config: Config, device="cuda",
                 plan: Optional[ProcessPlan] = None):
        cfg = self.config = config
        self.plan = plan
        self.device = plan.device if plan is not None else resolve_device(
            device)
        self.is_main = plan is None or plan.is_main
        check_train_config(cfg)
        t, lcfg = cfg.train, cfg.loss
        if plan is not None:
            assert_divisible(cfg.data.batch_size, plan)
        self.writer = MetricWriter(t.checkpoint_dir if self.is_main
                                   else None)
        self.ckpt = CheckpointManager(t.checkpoint_dir, t.max_to_keep)

        def step(c=cfg, **kw):
            return make_train_step(c, plan=plan, **kw)

        self.step_fns = {"full": step()}
        if t.stage_layer0_steps > 0:
            self.step_fns["stage"] = step(stage_layer0=True)
        if lcfg.consistency_weight > 0 and lcfg.consistency_start_step > 0:
            # Pseudo-labels from a fresh network are noise: before the
            # start step the term is dropped; the anchor stays on.
            self.step_fns["warmup"] = step(cfg.replace(
                loss=dataclasses.replace(lcfg, consistency_weight=0.0)))
        fz = t.freeze_layer0_step
        if t.freeze_layer0_from_best:
            ev = t.eval_every
            if fz <= 0:
                raise ValueError("train.freeze_layer0_from_best requires "
                                 "train.freeze_layer0_step > 0")
            if not t.save_best_params:
                raise ValueError("train.freeze_layer0_from_best requires "
                                 "train.save_best_params=True (the splice "
                                 "source is the best-eval export)")
            if ev <= 0 or ev > fz:
                raise ValueError(
                    "train.freeze_layer0_from_best needs at least one "
                    "in-training eval before the freeze boundary: "
                    f"eval_every={ev} vs freeze_layer0_step={fz}")
        if fz > 0:
            if cfg.model.family != "ldi":
                raise ValueError(
                    "train.freeze_layer0_step is an LDI-family mechanism "
                    "(the layer-0 vs deep-head parameter split); "
                    f"family={cfg.model.family!r}")
            if 0 < fz < t.stage_layer0_steps:
                raise ValueError(
                    f"train.freeze_layer0_step={fz} must be >= "
                    f"train.stage_layer0_steps={t.stage_layer0_steps} (the "
                    "freeze is the LAST phase)")
            if lcfg.consistency_weight > 0 and fz < lcfg.consistency_start_step:
                raise ValueError(
                    f"train.freeze_layer0_step={fz} must be >= "
                    f"loss.consistency_start_step={lcfg.consistency_start_step}"
                    " (the freeze is the LAST phase)")
            self.step_fns["freeze"] = step(freeze_layer0=True)
        if t.collapse_rollback_threshold > 0:
            if not t.save_best_params:
                raise ValueError("train.collapse_rollback_threshold requires "
                                 "train.save_best_params=True (the rollback "
                                 "target is the best-eval export)")
            if t.eval_every <= 0:
                raise ValueError("train.collapse_rollback_threshold requires "
                                 "train.eval_every > 0 (the collapse signal "
                                 "is the in-training eval's drift metric)")
            if t.drift_warn_threshold <= 0:
                raise ValueError("train.collapse_rollback_threshold requires "
                                 "train.drift_warn_threshold > 0 (the drift "
                                 "monitor computes the eval_abs_rel_drift "
                                 "signal the rollback triggers on)")
        self._rollback_count: Optional[int] = None
        self._eval_step = None
        self._eval_iter = None
        self._best_eval_abs_rel = None
        self._drift_seeded = False
        self._best_export_abs_rel = None

    def phase(self, step: int) -> str:
        """The phase that runs 0-based step ``step``."""
        t, lcfg = self.config.train, self.config.loss
        if "stage" in self.step_fns and step < t.stage_layer0_steps:
            return "stage"
        if "freeze" in self.step_fns and step >= t.freeze_layer0_step:
            return "freeze"
        if "warmup" in self.step_fns and step < lcfg.consistency_start_step:
            return "warmup"
        return "full"

    def run_step(self, phase: str, state: TrainState, batch: Batch):
        """One step of ``phase``: ``(state, metrics)``."""
        return self.step_fns[phase](state, batch)

    def _path(self, name: str) -> str:
        return os.path.join(self.config.train.checkpoint_dir, name)

    # ------------------------------------------------------------- eval

    def _update_drift(self, out: Dict[str, float]) -> None:
        """``eval_abs_rel_drift``: abs_rel above the run's best so far, with
        a warning past ``train.drift_warn_threshold``. A resumed run seeds
        its best from ``train.jsonl``; a fresh start does not (that file
        may hold another run's lines)."""
        thr = self.config.train.drift_warn_threshold
        if thr <= 0 or "eval_abs_rel" not in out:
            return
        if not self._drift_seeded:
            self._best_eval_abs_rel = _best_abs_rel_from_jsonl(
                self._path("train.jsonl"))
            self._drift_seeded = True
        cur = float(out["eval_abs_rel"])
        best = self._best_eval_abs_rel
        drift = 0.0 if best is None else max(0.0, cur - best)
        out["eval_abs_rel_drift"] = drift
        if best is None or cur < best:
            self._best_eval_abs_rel = cur
        if drift > thr:
            print(f"[drift] eval_abs_rel {cur:.3f} exceeds the run's best "
                  f"{best:.3f} by {drift:.3f} (> {thr}): view synthesis is "
                  "likely being bought with geometry drift; the measured "
                  "mitigations are loss.min_layer0_margin=0.02, a late "
                  "layer-0 freeze (train.freeze_layer0_step) and best-"
                  "checkpoint selection by eval_abs_rel", flush=True)

    def eval_metrics(self, state: TrainState, step: int) -> Dict[str, float]:
        """The eval's ``eval_*`` metrics, averaged over
        ``train.eval_batches`` held-out batches, with the first batch's
        image grid written under ``eval_images/step_<N>``."""
        cfg = self.config
        if self._eval_step is None:
            self._eval_step = build_eval_step(cfg)
        if self._eval_iter is None:
            self._eval_iter = make_dataset(eval_data_config(cfg.data),
                                           seed=cfg.train.seed + 1,
                                           device=self.device)
        n = max(1, cfg.train.eval_batches)
        sums: Dict[str, float] = {}
        grid_args = None
        for i in range(n):
            batch = next(self._eval_iter)
            metrics, rendered, pred = self._eval_step(state.net, batch)
            for k, v in to_floats(metrics).items():
                sums[k] = sums.get(k, 0.0) + v
            if i == 0:
                grid_args = (batch, rendered, pred)
        export_image_grid(*grid_args, self._path(os.path.join(
            "eval_images", f"step_{step:08d}")))
        return {f"eval_{k}": v / n for k, v in sums.items()}

    def run_eval(self, state: TrainState, step: int) -> Dict[str, float]:
        """The in-training eval (:meth:`eval_metrics`), its drift, best
        export and collapse rollback; its metrics go to the jsonl."""
        cfg = self.config
        out = self.eval_metrics(state, step)
        if "eval_abs_rel" not in out:
            # Without it neither the splice source nor the collapse signal
            # exists: fail at the first eval, not at the freeze boundary.
            needs = []
            if (cfg.train.freeze_layer0_from_best
                    and not cfg.train.freeze_fallback_live):
                needs.append("train.freeze_layer0_from_best")
            if cfg.train.collapse_rollback_threshold > 0:
                needs.append("train.collapse_rollback_threshold")
            if needs:
                raise ValueError(
                    f"{' and '.join(needs)} "
                    f"{'require' if len(needs) > 1 else 'requires'} "
                    f"eval_abs_rel, but the eval at step {step} produced "
                    f"none: the eval split of dataset {cfg.data.dataset!r} "
                    "has no ground-truth depth. Provide it, or set "
                    "train.freeze_fallback_live=True to freeze the live "
                    "params at the boundary.")
        self._update_drift(out)
        self._maybe_export_best(state, step, out)
        self._maybe_rollback(state, step, out)
        self.writer.write(step, out)
        return out

    def _maybe_export_best(self, state: TrainState, step: int,
                           out: Dict[str, float]) -> None:
        """``best_params.npz`` (JAX's key format, ``step`` and
        ``eval_abs_rel`` inside) whenever eval_abs_rel beats the best
        export so far; written to a temporary name and renamed."""
        cfg = self.config
        if not cfg.train.save_best_params or "eval_abs_rel" not in out:
            return
        if self._best_export_abs_rel is None:
            try:
                self._best_export_abs_rel = float(read_params_npz_meta(
                    self._path(self.BEST_NPZ))["eval_abs_rel"])
            except (OSError, KeyError, ValueError):
                pass
        cur = float(out["eval_abs_rel"])
        if (self._best_export_abs_rel is not None
                and cur >= self._best_export_abs_rel):
            return
        self._best_export_abs_rel = cur
        meta = {"step": step, "eval_abs_rel": cur}
        npz = self._path(self.BEST_NPZ)
        export_params_npz(state.net.state_dict(), npz + ".tmp.npz", meta)
        os.replace(npz + ".tmp.npz", npz)

    def _maybe_rollback(self, state: TrainState, step: int,
                        out: Dict[str, float]) -> None:
        """The collapse response: when the eval's drift above the run's
        best crosses ``train.collapse_rollback_threshold``, restore every
        parameter from ``best_params.npz`` and set ``out["rollback"]`` to
        the rollbacks used so far (the optimizer is re-initialised by
        :meth:`rollback_everywhere`). The layer-0 splice alone would leave
        the trunk and the deep heads in the collapsed basin. Without an
        export, or with the budget spent, the run continues as it is."""
        t = self.config.train
        thr = t.collapse_rollback_threshold
        drift = out.get("eval_abs_rel_drift", 0.0)
        if thr <= 0 or drift <= thr:
            return
        npz = self._path(self.BEST_NPZ)
        if not os.path.exists(npz):
            print(f"[rollback] collapse at step {step} (drift {drift:.3f} > "
                  f"{thr}) but no best_params.npz exists yet; continuing "
                  "without rollback", flush=True)
            return
        if self._rollback_count is None:
            self._rollback_count = _read_rollback_count(
                self._path(self.ROLLBACK_JSON))
        if self._rollback_count >= t.collapse_max_rollbacks:
            print(f"[rollback] collapse at step {step} (drift {drift:.3f}) "
                  f"but the rollback budget ({t.collapse_max_rollbacks}) is "
                  "spent: repeated collapse is a recipe problem, not a "
                  "transient; continuing", flush=True)
            return
        self._rollback_count += 1
        best = import_params_npz(self.config.model, npz)
        with torch.no_grad():
            for k, p in state.net.named_parameters():
                p.copy_(best[k])
        try:
            meta = read_params_npz_meta(npz)
            src = (f"step {int(meta['step'])}, "
                   f"eval_abs_rel {meta['eval_abs_rel']:.4f}")
        except (OSError, KeyError, ValueError):
            src = "metadata missing"
        print(f"[rollback] eval_abs_rel {out['eval_abs_rel']:.3f} at step "
              f"{step} is {drift:.3f} above the run's best (> {thr}): "
              "geometry collapse; restoring ALL params from best_params.npz "
              f"({src}), re-initializing the optimizer (LR re-warmup), "
              f"rollback {self._rollback_count}/{t.collapse_max_rollbacks}",
              flush=True)
        out["rollback"] = float(self._rollback_count)

    def rollback_everywhere(self, state: TrainState, rolled: bool) -> bool:
        """After an eval, on every rank: rank 0's rollback decision
        (``rolled``); where it rolled back, every rank takes rank 0's
        restored parameters and a fresh optimizer state (zero moments and
        count, so the learning-rate schedule replays its warmup)."""
        rolled = broadcast_flag(self.plan, rolled)
        if rolled:
            broadcast_params(self.plan, state.net)
            state.opt_state = Optimizer(self.config).init(
                {k: p.detach() for k, p in state.net.named_parameters()})
        return rolled

    def _write_rollback_count(self) -> None:
        """``rollback_state.json``, written after the rolled-back state's
        checkpoint: a crash in between resumes with the parameters rolled
        back and the budget not yet charged, never the other way round."""
        path = self._path(self.ROLLBACK_JSON)
        with open(path + ".tmp", "w") as f:
            json.dump({"count": self._rollback_count}, f)
        os.replace(path + ".tmp", path)

    def _start_in_directory(self, fresh: bool) -> None:
        """Rank 0, before the first step: on a fresh start (no checkpoint)
        in a directory stamped by another run, or not stamped, remove that
        run's best export and rollback budget, which must neither seed the
        trackers nor be spliced into layer 0, and take no drift baseline
        from its jsonl lines. A directory with this config's stamp holds
        this run's own files from before a crash: keep them. Then stamp
        the directory."""
        t = self.config.train
        stamp = run_stamp(self.config)
        path = self._path(self.RUN_STAMP)
        try:
            with open(path) as f:
                same = json.load(f).get("config_sha256") == stamp
        except (OSError, ValueError, AttributeError):
            same = False
        if fresh and same:
            print(f"[train] fresh start of the run stamped in "
                  f"{t.checkpoint_dir} (a crash before its first "
                  "checkpoint): keeping its best export and rollback "
                  "budget", flush=True)
        elif fresh:
            for name in (self.BEST_NPZ, "best_params.json",
                         self.ROLLBACK_JSON):
                if os.path.exists(self._path(name)):
                    os.remove(self._path(name))
                    print(f"[train] fresh start: removed stale {name} from "
                          f"{t.checkpoint_dir}", flush=True)
            self._drift_seeded = True
        os.makedirs(t.checkpoint_dir, exist_ok=True)
        with open(path + ".tmp", "w") as f:
            json.dump({"config_sha256": stamp}, f)
        os.replace(path + ".tmp", path)

    def splice_best_layer0(self, state: TrainState) -> TrainState:
        """At the freeze boundary: every layer-0-owned parameter entry from
        ``best_params.npz``, the rest live. Params only: the Adam moments
        are kept. The provenance printed comes from the npz's own
        metadata. Data-parallel: rank 0 splices, every rank then takes its
        parameters."""
        if self.is_main:
            state = self._splice_best_layer0(state)
        broadcast_params(self.plan, state.net)
        return state

    def _splice_best_layer0(self, state: TrainState) -> TrainState:
        cfg = self.config
        npz = self._path(self.BEST_NPZ)
        if not os.path.exists(npz):
            msg = ("freeze_layer0_from_best: no best_params.npz in "
                   f"{cfg.train.checkpoint_dir} at the freeze boundary (no "
                   "eval ever produced an export)")
            if not cfg.train.freeze_fallback_live:
                raise FileNotFoundError(
                    msg + "; refusing to freeze the live params (set "
                    "train.freeze_fallback_live=True to opt in)")
            print(f"[freeze] {msg}; freezing the live params "
                  "(train.freeze_fallback_live)", flush=True)
            return state
        best = import_params_npz(cfg.model, npz)
        live = {k: p.detach() for k, p in state.net.named_parameters()}
        spliced = splice_layer0_params(cfg.model, live, best)
        with torch.no_grad():
            for k, p in state.net.named_parameters():
                p.copy_(spliced[k])
        try:
            meta = read_params_npz_meta(npz)
            src = (f"step {int(meta['step'])}, "
                   f"eval_abs_rel {meta['eval_abs_rel']:.4f}")
        except (OSError, KeyError, ValueError):
            src = "metadata missing"
        print(f"[freeze] layer-0 spliced from best_params.npz ({src}) and "
              "frozen; deep heads continue from the live state", flush=True)
        return state

    # ------------------------------------------------------------ train

    def train(self, max_steps: Optional[int] = None,
              data_iter=None) -> Tuple[TrainState, Dict[str, Any]]:
        cfg = self.config
        t = cfg.train
        max_steps = max_steps or t.max_steps
        state = create_state(cfg, seed=t.seed, device=self.device)
        state = self.ckpt.restore(state)
        start_step = state.step
        if self.is_main:
            self._start_in_directory(fresh=start_step == 0)
        own_data = data_iter is None
        if own_data:
            data_iter = make_dataset(
                cfg.data, seed=t.seed, device=self.device,
                examples=None if self.plan is None else batch_slice(
                    cfg.data.batch_size, self.plan))
        profiler = None
        if t.profile_dir and self.is_main:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()

        last_metrics: Dict[str, Any] = {}
        window_warned = False
        t_last, steps, frames = time.perf_counter(), 0, 0
        try:
            for step in range(start_step, max_steps):
                batch = next(data_iter)
                if (t.freeze_layer0_from_best and "freeze" in self.step_fns
                        and step == t.freeze_layer0_step):
                    # Crossing the boundary live; a resume past it restores
                    # already-spliced params and must not splice again.
                    state = self.splice_best_layer0(state)
                state, metrics = self.run_step(self.phase(step), state, batch)
                steps += 1
                frames += cfg.data.batch_size

                if (step + 1) % t.log_every == 0 or step + 1 == max_steps:
                    metrics = to_floats(metrics)
                    if not all(map(math.isfinite, metrics.values())):
                        # Halt; the poisoned params go to a dump outside
                        # the checkpoints, which resume would restore.
                        dump = self._path(
                            f"nan_debug_params_step{step + 1}.npz")
                        if self.is_main:
                            export_params_npz(state.net.state_dict(), dump)
                        raise FloatingPointError(
                            f"non-finite loss at step {step + 1}: {metrics} "
                            f"(params dumped to {dump})")
                    if (self.is_main and not window_warned
                            and "window_dropped_frac" in metrics):
                        # The windowed route truncating content: warn once.
                        window_warned = warn_window_drop(
                            metrics["window_dropped_frac"],
                            cfg.render.pallas_max_dy)
                    now = time.perf_counter()
                    metrics["steps_per_sec"] = steps / (now - t_last)
                    metrics["frames_per_sec"] = frames / (now - t_last)
                    t_last, steps, frames = now, 0, 0
                    self.writer.write(step + 1, metrics,
                                      echo=self.is_main)
                    last_metrics = metrics

                rolled = False
                if t.eval_every and ((step + 1) % t.eval_every == 0
                                     or step + 1 == max_steps):
                    if self.is_main:
                        out = self.run_eval(state, step + 1)
                        last_metrics.update(out)
                        rolled = "rollback" in out
                    if t.collapse_rollback_threshold > 0:
                        rolled = self.rollback_everywhere(state, rolled)

                if self.is_main and (rolled
                                     or (step + 1) % t.checkpoint_every == 0
                                     or step + 1 == max_steps):
                    # A rollback is checkpointed at once, so a crash cannot
                    # resume the collapsed parameters.
                    self.ckpt.save(step + 1, state)
                    if rolled:
                        self._write_rollback_count()
            # Rank 0 writes the last checkpoint after the others are done:
            # none returns before it exists, so a train() that follows in
            # these processes restores the same step on every rank.
            barrier(self.plan)
        finally:
            if own_data:
                data_iter.close()
            if self._eval_iter is not None:
                self._eval_iter.close()
                self._eval_iter = None
            if profiler is not None:
                profiler.stop()
                os.makedirs(t.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(t.profile_dir, "trace.json"))
        return state, last_metrics


def run_stamp(cfg: Config) -> str:
    """A hash of everything in ``cfg`` that shapes the run's path: the
    config less ``train.max_steps`` (a resume may extend it),
    ``train.checkpoint_dir`` and ``train.profile_dir``."""
    d = dataclasses.asdict(cfg)
    for k in ("max_steps", "checkpoint_dir", "profile_dir"):
        d["train"].pop(k)
    return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()


def _read_rollback_count(path: str) -> int:
    """The rollbacks a run has used (``rollback_state.json``), 0 without
    the file."""
    try:
        with open(path) as f:
            return int(json.load(f)["count"])
    except (OSError, ValueError, KeyError, TypeError):
        return 0


def _best_abs_rel_from_jsonl(path: str) -> Optional[float]:
    """The least ``eval_abs_rel`` in a train.jsonl, or None."""
    best = None
    try:
        with open(path) as f:
            for line in f:
                try:
                    v = json.loads(line).get("eval_abs_rel")
                except json.JSONDecodeError:
                    continue
                if v is not None and (best is None or v < best):
                    best = float(v)
    except OSError:
        return None
    return best
