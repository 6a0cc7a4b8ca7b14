"""Evaluation runner: view-synthesis and depth metrics over the held-out
split.

PyTorch counterpart of ``lsi_tpu/evaluation/runner.py`` for the LDI
family: restore a checkpoint, predict an LDI from each held-out source
image, render it into the paired view, and score PSNR and SSIM against
the target (masked to rendered coverage), layer-0 depth where ground
truth exists, and the disoccluded region where the target's ground truth
exists; average, and export an image grid (src | trg | render |
disparity) as a PNG.

    python -m lsi_tpu_torch.evaluation.runner --config=kitti_ldi3_quality \
        --set train.checkpoint_dir=/path/to/run --num_batches 16

Not ported yet: ``--trajectory_gif`` (ROADMAP Queue 1, item 6: M10's
``trajectory`` and ``video``) and the MPI family (item 7, M11).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from lsi_tpu_torch.api import resolve_device
from lsi_tpu_torch.config import PRESETS, Config, DataConfig, build_config
from lsi_tpu_torch.data.pipeline import Batch, batch_stream, decode_batch
from lsi_tpu_torch.evaluation.metrics import depth_metrics, psnr, ssim
from lsi_tpu_torch.evaluation.occlusion import occlusion_metrics
from lsi_tpu_torch.geometry.ldi import LDI, render_forward
from lsi_tpu_torch.models.ldi_predictor import LDIPredictor
from lsi_tpu_torch.train.checkpoint import CheckpointManager


def build_eval_step(cfg: Config):
    """``eval_step(net, batch) -> (metrics, rendered rgb, ldi)``: metrics
    are 0-d tensors; ``occ_*`` metrics whenever the batch carries the
    target's ground-truth disparity. Runs without autograd."""
    if cfg.model.family != "ldi":
        raise NotImplementedError(
            f"model family {cfg.model.family!r} is not ported yet (ROADMAP "
            "Queue 1, item 7: M11)")
    zscale = cfg.render.zbuffer_scale

    @torch.no_grad()
    def eval_step(net: LDIPredictor, batch: Batch):
        batch = decode_batch(batch)
        ldi = net(batch.src_image, batch.intrinsics)
        out = render_forward(ldi, batch.pose_src2trg,
                             out_hw=tuple(batch.trg_image.shape[1:3]),
                             zbuffer_scale=zscale)
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
                zbuffer_scale=zscale))
        return metrics, out["rgb"], ldi

    return eval_step


def eval_data_config(data_cfg: DataConfig) -> DataConfig:
    """The held-out, unaugmented view of a training data config."""
    return dataclasses.replace(data_cfg, augment=False, split="val")


def to_floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d tensors -> floats, with one device-to-host copy."""
    vals = torch.stack([v.float().reshape(()) for v in metrics.values()])
    return dict(zip(metrics, vals.tolist()))


def evaluate(cfg: Config, net: LDIPredictor, num_batches: int = 16,
             image_dir: Optional[str] = None, seed: int = 1234,
             device="cuda") -> Dict[str, float]:
    """Average the eval metrics over ``num_batches`` held-out batches."""
    eval_step = build_eval_step(cfg)
    it = batch_stream(eval_data_config(cfg.data), seed=seed, device=device)
    sums: Dict[str, float] = {}
    for i in range(num_batches):
        batch = next(it)
        metrics, rendered, ldi = eval_step(net, batch)
        for k, v in to_floats(metrics).items():
            sums[k] = sums.get(k, 0.0) + v
        if image_dir is not None and i == 0:
            export_image_grid(batch, rendered, ldi, image_dir)
    return {k: v / num_batches for k, v in sums.items()}


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (zlib and struct
    from the standard library; no image package needed)."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + row.tobytes()
                   for row in np.ascontiguousarray(rgb, np.uint8))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def export_image_grid(batch: Batch, rendered: torch.Tensor, pred: LDI,
                      out_dir: str, max_rows: int = 4) -> None:
    """``<out_dir>/eval_grid.png``: one row per example, src | trg |
    render | layer-0 disparity (grey, scaled by the batch's maximum)."""
    os.makedirs(out_dir, exist_ok=True)

    def dec(x):
        x = x.detach().cpu().numpy()
        return x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else x

    src = dec(batch.src_image)
    trg = dec(batch.trg_image)
    ren = np.clip(dec(rendered), 0, 1)
    disp = dec(pred.disparities[:, 0, ..., 0])
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
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)
    cfg = build_config(args.config, args.set)
    device = resolve_device(args.device)

    raw = CheckpointManager(cfg.train.checkpoint_dir,
                            cfg.train.max_to_keep).restore_raw()
    net = LDIPredictor(cfg.model)
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
    return results


if __name__ == "__main__":
    main()
