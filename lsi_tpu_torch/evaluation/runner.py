"""Evaluation runner: view-synthesis and depth metrics over the held-out
split.

PyTorch counterpart of ``lsi_tpu/evaluation/runner.py``: restore a
checkpoint, predict an LDI (or, for the MPI baseline, an MPI) from each
held-out source image, render it into the paired view, and score PSNR and
SSIM against the target (masked to rendered coverage: splat weight > 0
for an LDI, accumulated alpha > 0.5 for an MPI), depth where ground truth
exists (an LDI's layer 0, an MPI's expected source disparity), and, for
an LDI, the disoccluded region where the target's ground truth exists;
average, and export an image grid (src | trg | render | disparity) as a
PNG.

    python -m lsi_tpu_torch.evaluation.runner --config=kitti_ldi3_quality \
        --set train.checkpoint_dir=/path/to/run --num_batches 16

With ``--trajectory_gif PATH`` (LDI family) the first source image of
the configured data stream is also rendered to a 60-view sweep
(``trajectory.render_trajectory``) and written as a GIF (``video.save_gif``,
PIL).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
from typing import Dict, Optional

import numpy as np
import torch

from lsi_tpu_torch.device import resolve_device
from lsi_tpu_torch.config import PRESETS, Config, DataConfig, build_config
from lsi_tpu_torch.data.pipeline import Batch, decode_batch, make_dataset
from lsi_tpu_torch.evaluation.metrics import depth_metrics, psnr, ssim
from lsi_tpu_torch.evaluation.occlusion import occlusion_metrics
from lsi_tpu_torch.evaluation.png import write_png
from lsi_tpu_torch.geometry.ldi import render_forward, warn_window_drop
from lsi_tpu_torch.models import build_model
from lsi_tpu_torch.models.mpi import MPI, mpi_source_disparity, render_mpi
from lsi_tpu_torch.train.checkpoint import CheckpointManager


def build_eval_step(cfg: Config):
    """``eval_step(net, batch) -> (metrics, rendered rgb, prediction)``:
    metrics are 0-d tensors. An LDI's carry ``occ_*`` metrics whenever the
    batch carries the target's ground-truth disparity; an MPI's
    (``model.family="mpi"``) are psnr and ssim where the accumulated alpha
    exceeds 0.5, ``psnr_full``, ``coverage`` (the mean accumulated alpha)
    and the depth metrics of its expected source disparity. Renders take
    ``cfg.render``'s route (``use_pallas``, ``pallas_max_dy``). Runs without
    autograd."""
    rc = cfg.render
    route = dict(use_pallas=rc.use_pallas, pallas_max_dy=rc.pallas_max_dy)
    if cfg.model.family == "mpi":
        return functools.partial(_eval_step_mpi, route=route)
    zscale = rc.zbuffer_scale

    @torch.no_grad()
    def eval_step(net: torch.nn.Module, batch: Batch):
        batch = decode_batch(batch)
        ldi = net(batch.src_image, batch.intrinsics)
        out = render_forward(ldi, batch.pose_src2trg,
                             out_hw=tuple(batch.trg_image.shape[1:3]),
                             zbuffer_scale=zscale,
                             check_window=rc.window_check, **route)
        covered = (out["coverage"] > 0).float()
        metrics = {
            "psnr": psnr(out["rgb"], batch.trg_image, mask=covered),
            "psnr_full": psnr(out["rgb"], batch.trg_image),
            "ssim": ssim(out["rgb"], batch.trg_image, mask=covered),
            "coverage": covered.mean(),
            "window_dropped_frac": out["window_dropped_frac"],
        }
        if batch.gt_disparity is not None and batch.gt_valid is not None:
            metrics.update(depth_metrics(ldi.disparities[:, 0],
                                         batch.gt_disparity, batch.gt_valid))
        if batch.trg_gt_disparity is not None:
            metrics.update(occlusion_metrics(
                ldi, batch.pose_src2trg, batch.trg_gt_disparity,
                trg_gt_valid=batch.trg_gt_valid, trg_image=batch.trg_image,
                zbuffer_scale=zscale, **route))
        return metrics, out["rgb"], ldi

    return eval_step


@torch.no_grad()
def _eval_step_mpi(net: torch.nn.Module, batch: Batch, route: dict):
    batch = decode_batch(batch)
    mpi = net(batch.src_image, batch.intrinsics)
    out = render_mpi(mpi, batch.pose_src2trg,
                     out_hw=tuple(batch.trg_image.shape[1:3]), **route)
    covered = (out["alpha"] > 0.5).float()
    metrics = {
        "psnr": psnr(out["rgb"], batch.trg_image, mask=covered),
        "psnr_full": psnr(out["rgb"], batch.trg_image),
        "ssim": ssim(out["rgb"], batch.trg_image, mask=covered),
        "coverage": out["alpha"].mean(),
    }
    if batch.gt_disparity is not None and batch.gt_valid is not None:
        metrics.update(depth_metrics(mpi_source_disparity(mpi),
                                     batch.gt_disparity, batch.gt_valid))
    return metrics, out["rgb"], mpi


def eval_data_config(data_cfg: DataConfig) -> DataConfig:
    """The held-out, unaugmented view of a training data config."""
    return dataclasses.replace(data_cfg, augment=False, split="val")


def to_floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d tensors -> floats, with one device-to-host copy."""
    vals = torch.stack([v.float().reshape(()) for v in metrics.values()])
    return dict(zip(metrics, vals.tolist()))


def evaluate(cfg: Config, net: torch.nn.Module, num_batches: int = 16,
             image_dir: Optional[str] = None, seed: int = 1234,
             device="cuda") -> Dict[str, float]:
    """Average the eval metrics over ``num_batches`` held-out batches."""
    eval_step = build_eval_step(cfg)
    it = make_dataset(eval_data_config(cfg.data), seed=seed, device=device)
    sums: Dict[str, float] = {}
    try:
        for i in range(num_batches):
            batch = next(it)
            metrics, rendered, pred = eval_step(net, batch)
            for k, v in to_floats(metrics).items():
                sums[k] = sums.get(k, 0.0) + v
            if image_dir is not None and i == 0:
                export_image_grid(batch, rendered, pred, image_dir)
    finally:
        it.close()
    results = {k: v / num_batches for k, v in sums.items()}
    if "window_dropped_frac" in results:
        warn_window_drop(results["window_dropped_frac"],
                         cfg.render.pallas_max_dy)
    return results


@torch.no_grad()
def trajectory_frames(cfg: Config, net: torch.nn.Module,
                      device="cuda") -> torch.Tensor:
    """The runner's sweep: the LDI of the first source image of
    ``cfg.data``'s stream (seed 1) rendered to 60 views, ±0.15 m across
    and ±0.01 rad about the optical axis; (60, 1, H, W, 3)."""
    from lsi_tpu_torch.evaluation.trajectory import render_trajectory

    it = make_dataset(cfg.data, seed=1, repeat=True, device=device)
    try:
        batch = decode_batch(next(it))
    finally:
        it.close()
    ldi = net(batch.src_image[:1], batch.intrinsics[:1])
    return render_trajectory(ldi, 60, max_translation=(0.15, 0.0, 0.0),
                             max_rotation=(0.0, 0.0, 0.01),
                             render_cfg=cfg.render)


def _pred_disparity(pred) -> torch.Tensor:
    """(B, H, W) display disparity of either family's prediction: an LDI's
    layer 0, an MPI's expected source disparity."""
    if isinstance(pred, MPI):
        return mpi_source_disparity(pred)[..., 0]
    return pred.disparities[:, 0, ..., 0]


def export_image_grid(batch: Batch, rendered: torch.Tensor, pred,
                      out_dir: str, max_rows: int = 4) -> None:
    """``<out_dir>/eval_grid.png``: one row per example, src | trg |
    render | disparity (:func:`_pred_disparity`, grey, scaled by the
    batch's maximum)."""
    os.makedirs(out_dir, exist_ok=True)

    def dec(x):
        x = x.detach().cpu().numpy()
        return x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else x

    src = dec(batch.src_image)
    trg = dec(batch.trg_image)
    ren = np.clip(dec(rendered), 0, 1)
    disp = dec(_pred_disparity(pred))
    disp = disp / max(disp.max(), 1e-6)
    rows = [np.concatenate([src[i], trg[i], ren[i],
                            np.repeat(disp[i][..., None], 3, axis=-1)],
                           axis=1)
            for i in range(min(max_rows, src.shape[0]))]
    grid = (np.concatenate(rows, axis=0) * 255).astype(np.uint8)
    write_png(os.path.join(out_dir, "eval_grid.png"), grid)


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(
        prog="python -m lsi_tpu_torch.evaluation.runner")
    ap.add_argument("--config", default="kitti_ldi2",
                    help=f"preset: {sorted(PRESETS)}")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    ap.add_argument("--num_batches", type=int, default=16)
    ap.add_argument("--image_dir", default="")
    ap.add_argument("--trajectory_gif", default="",
                    help="also render a 60-view sweep of the data stream's "
                         "first image to this GIF path (needs PIL)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)
    cfg = build_config(args.config, args.set)
    device = resolve_device(args.device)

    raw = CheckpointManager(cfg.train.checkpoint_dir,
                            cfg.train.max_to_keep).restore_raw()
    net = build_model(cfg.model)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net = net.to(device)
    if raw is None:
        print("no checkpoint found; evaluating fresh-initialized params")
        step = 0
    else:
        net.load_state_dict(raw["params"])
        step = int(raw["step"])
    print(f"evaluating checkpoint step {step}")
    results = evaluate(cfg, net, args.num_batches, args.image_dir or None,
                       device=device)
    for k, v in sorted(results.items()):
        print(f"{k}: {v:.4f}")

    if args.trajectory_gif and cfg.model.family != "ldi":
        print("trajectory gif: LDI-family only; skipping")
    elif args.trajectory_gif:
        from lsi_tpu_torch.evaluation.video import save_gif

        frames = trajectory_frames(cfg, net, device)
        print(f"trajectory gif: {save_gif(frames, args.trajectory_gif)}")
    return results


if __name__ == "__main__":
    main()
