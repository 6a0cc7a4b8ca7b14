#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). Phases, one line each; any failure
ends the run with a non-zero exit and no result line:

1. device  — require CUDA; card name and power limit, torch/CUDA/nvcc.
2. build   — build the forward splat kernel (K1) from lsi_tpu_torch/csrc.
3. kernel  — K1 against the plain index_add_ splat on the card, at the
             render's shape (N=8, Hs=512, Ws=768, C=4), with out-of-image
             and +-1e6 coordinates; run-to-run spread of the atomics.
4. golden  — predict_ldi -> render on the card at float32 (TF32 off)
             against the JAX outputs in tests/data/torch_golden_toy.npz.
5. slice   — the kitti_ldi2 model (L=2, base_filters=32, num_scales=5,
             bf16) at 256x768, random weights from a seed: 4 requests of
             batch 8 through LSIModel.predict_ldi -> LSIModel.render; K1's
             launch count must equal the number of renders.
6. timing  — CUDA-event times after warm-up: predict, render and
             end-to-end frames/s at b8 and b16; K1 vs plain per call.

The line before the last two is {"kernels": [...]}, then the card's name
and power limit as nvidia-smi prints them, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from lsi_tpu_torch.api import LSIModel
from lsi_tpu_torch.config import get_config
from lsi_tpu_torch.geometry.ldi import render_forward
from lsi_tpu_torch.geometry.transforms import pose_from_euler, translation_pose
from lsi_tpu_torch.kernels import build, splat_cuda
from lsi_tpu_torch.ops.splat import splat_bilinear

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "data" / "torch_golden_toy.npz"

# K1 vs plain: both sum float32 atomics, in an order that changes from run
# to run, so they agree to float32 rounding of the sums, not bitwise.
SPLAT_RTOL = 1e-5
SPLAT_ATOL_OF_MAX = 1e-5  # atol = this * max|reference|
# Golden (float32, TF32 off): cuDNN and XLA sum convolutions in other
# orders (~1e-6 on the LDI). The composite gets more room: the fraction
# snap (MIN_FRACTION 1e-4) moves a corner's weight by up to 1e-4 when a
# projected coordinate crosses its edge, and the soft z-buffer multiplies
# a disparity difference by zbuffer_scale (50) inside exp().
GOLDEN_LDI_ATOL = 1e-4
GOLDEN_RENDER_ATOL = 1e-3
GOLDEN_COVERAGE_RTOL = 1e-3

SPLAT_SHAPE = (8, 512, 768, 4)  # N, L*H, W, C of the flagship render
OUT_HW = (256, 768)
REQUESTS = 4
BATCH = 8


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def splat_inputs(rng: np.random.Generator, dev: torch.device):
    """Render-like splat inputs: each folded row lands near its base row,
    shifted up to +-40 px across and +-3 rows; 1% of pixels far outside
    (+-1e6, as where the projection clamps its denominator) and some just
    off the image edges."""
    n, hs, ws, c = SPLAT_SHAPE
    ho, wo = OUT_HW
    values = rng.uniform(size=(n, hs, ws, c)).astype(np.float32)
    x = (np.arange(ws, dtype=np.float32)[None, None, :]
         + rng.uniform(-40, 40, (n, hs, ws)).astype(np.float32))
    y = ((np.arange(hs, dtype=np.float32) % ho)[None, :, None]
         + rng.uniform(-3, 3, (n, hs, ws)).astype(np.float32))
    far = rng.uniform(size=(n, hs, ws)) < 0.01
    x[far] = 1e6
    y[rng.uniform(size=(n, hs, ws)) < 0.01] = -1e6
    coords = np.stack([x, y], -1)
    weights = rng.uniform(0.0, 1.0, (n, hs, ws, 1)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (values, coords, weights))


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor,
                rtol: float, atol: float) -> float:
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements off, max abs err "
             f"{err.max().item():.3e} (rtol {rtol}, atol {atol:.3e})")
    return err.max().item()


def main() -> None:
    # 1. Device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card and has no CPU path")
    dev = torch.device("cuda", 0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc_version = run([build.find_nvcc(), "--version"]).splitlines()[-1]
    log("device", f"{smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {nvcc_version}")

    # 2. Build.
    t0 = time.perf_counter()
    build.load("splat_fwd")
    log("build", f"splat_fwd built and loaded in "
        f"{time.perf_counter() - t0:.2f} s -> "
        f"{build.library_path('splat_fwd').relative_to(REPO)}")

    # 3. Kernel vs plain at the path's shape.
    values, coords, weights = splat_inputs(np.random.default_rng(0), dev)
    acc_ref, ws_ref = splat_bilinear(values, coords, weights, OUT_HW)
    acc_1, ws_1 = splat_cuda.splat(values, coords, weights, OUT_HW)
    acc_2, ws_2 = splat_cuda.splat(values, coords, weights, OUT_HW)
    torch.cuda.synchronize()
    max_err = 0.0
    for name, got, ref in (("accum", acc_1, acc_ref), ("wsum", ws_1, ws_ref)):
        atol = SPLAT_ATOL_OF_MAX * ref.abs().max().item()
        max_err = max(max_err, check_close(name, got, ref, SPLAT_RTOL, atol))
    spread = max((acc_1 - acc_2).abs().max().item(),
                 (ws_1 - ws_2).abs().max().item())
    log("kernel", f"K1 vs plain at {SPLAT_SHAPE} -> {OUT_HW}: max abs err "
        f"{max_err:.3e} (max|ref| accum {acc_ref.abs().max().item():.3f}, "
        f"rtol {SPLAT_RTOL}, atol {SPLAT_ATOL_OF_MAX}*max|ref|); "
        f"run-to-run max abs diff {spread:.3e}")

    # 4. Golden check against the JAX outputs, float32 with TF32 off.
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with np.load(GOLDEN) as g:
        golden = {k: g[k] for k in g.files if not k.startswith("params/")}
    model = LSIModel.load(str(GOLDEN), device=dev)
    if model.config.model.compute_dtype != "float32":
        fail("golden model must compute in float32")

    def on_dev(name):
        return torch.from_numpy(golden[name]).to(dev)

    with torch.inference_mode():
        ldi = model.predict_ldi(on_dev("image"), on_dev("intrinsics"))
        out = render_forward(ldi, on_dev("pose"),
                             zbuffer_scale=model.config.render.zbuffer_scale)
    errs = {
        "textures": check_close("golden textures", ldi.textures,
                                on_dev("ldi_textures"), 0.0, GOLDEN_LDI_ATOL),
        "disparities": check_close("golden disparities", ldi.disparities,
                                   on_dev("ldi_disparities"), 0.0,
                                   GOLDEN_LDI_ATOL),
        "rgb": check_close("golden rgb", out["rgb"], on_dev("rgb"), 0.0,
                           GOLDEN_RENDER_ATOL),
        "disparity": check_close("golden disparity", out["disparity"],
                                 on_dev("disparity"), 0.0,
                                 GOLDEN_RENDER_ATOL),
        "coverage": check_close("golden coverage", out["coverage"],
                                on_dev("coverage"), GOLDEN_COVERAGE_RTOL,
                                1e-5),
    }
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log("golden", "port on CUDA vs JAX (CPU) at 2x32x64, float32: max abs "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (LDI atol {GOLDEN_LDI_ATOL}, render atol {GOLDEN_RENDER_ATOL})")

    # 5. The slice at full width.
    config = get_config("kitti_ldi2")
    h, w = config.data.height, config.data.width
    model = LSIModel.init(0, config, h, w, device=dev)
    n_params = sum(p.numel() for p in model.net.parameters())
    rng = np.random.default_rng(1)
    images = [torch.from_numpy(rng.uniform(size=(BATCH, h, w, 3))
                               .astype(np.float32)).to(dev)
              for _ in range(REQUESTS)]
    poses = [translation_pose([[-0.3, 0.0, 0.0]] * BATCH).to(dev),
             pose_from_euler([[0.0, 0.03, 0.0]] * BATCH,
                             [[-0.1, 0.0, 0.0]] * BATCH).to(dev)]
    torch.cuda.synchronize()

    splat_cuda.splat.launches = 0
    results = []
    for i, image in enumerate(images):
        ldi = model.predict_ldi(image)
        results.append((ldi, poses[i % 2], model.render(ldi, poses[i % 2])))
    torch.cuda.synchronize()
    launches = splat_cuda.splat.launches
    if launches != REQUESTS:
        fail(f"K1 launched {launches} times for {REQUESTS} renders")

    cfg_m = config.model
    covered = []
    for ldi, pose, rgb in results:
        if tuple(rgb.shape) != (BATCH, h, w, 3) or not torch.isfinite(rgb).all():
            fail(f"render output shape {tuple(rgb.shape)} or non-finite")
        d = ldi.disparities
        if not (torch.isfinite(d).all() and torch.isfinite(ldi.textures).all()):
            fail("non-finite LDI")
        if (d.min() < cfg_m.min_disparity - 1e-6
                or d.max() > cfg_m.max_disparity + 1e-6
                or (d[:, 1:] > d[:, :-1] + 1e-6).any()):
            fail("LDI disparities out of range or out of order")
        with torch.inference_mode():
            cov = render_forward(ldi, pose,
                                 zbuffer_scale=config.render.zbuffer_scale)
        frac = (cov["coverage"] > 0).float().mean().item()
        if not torch.allclose(cov["rgb"], rgb, rtol=1e-5, atol=1e-5):
            fail("render_forward and LSIModel.render disagree")
        covered.append(frac)
    if min(covered) < 0.5:
        fail(f"coverage > 0 on only {min(covered):.1%} of pixels")
    log("slice", f"kitti_ldi2 ({n_params} params, {cfg_m.compute_dtype}) "
        f"at {h}x{w}: {REQUESTS} requests of batch {BATCH} served; K1 "
        f"launches {launches} = renders {REQUESTS}; covered pixels "
        + ", ".join(f"{c:.1%}" for c in covered))

    # 6. Timing.
    for b in (8, 16):
        image = torch.from_numpy(rng.uniform(size=(b, h, w, 3))
                                 .astype(np.float32)).to(dev)
        pose = translation_pose([[-0.3, 0.0, 0.0]] * b).to(dev)
        ldi = model.predict_ldi(image)
        t_pred = cuda_ms(lambda: model.predict_ldi(image), iters=20)
        t_rend = cuda_ms(lambda: model.render(ldi, pose), iters=20)
        t_e2e = cuda_ms(lambda: model.render(model.predict_ldi(image), pose),
                        iters=20)
        log("timing", f"{smi} | b{b} {h}x{w}: predict {t_pred:.3f} ms "
            f"({1e3 * b / t_pred:.1f} frames/s), render {t_rend:.3f} ms "
            f"({1e3 * b / t_rend:.1f} frames/s), end-to-end {t_e2e:.3f} ms "
            f"({1e3 * b / t_e2e:.1f} frames/s)")
    # K1 and plain in turns (plain, K1, K1, plain), at the b8 render shape.
    times = {"plain": [], "k1": []}
    for which in ("plain", "k1", "k1", "plain"):
        fn = splat_bilinear if which == "plain" else splat_cuda.splat
        times[which].append(cuda_ms(
            lambda: fn(values, coords, weights, OUT_HW), iters=50))
    k1_ms = float(np.mean(times["k1"]))
    plain_ms = float(np.mean(times["plain"]))
    log("timing", f"{smi} | splat at {SPLAT_SHAPE} -> {OUT_HW}: K1 "
        f"{1e3 * k1_ms:.1f} us/call {times['k1']}, plain index_add_ "
        f"{1e3 * plain_ms:.1f} us/call {times['plain']}")

    print(json.dumps({"kernels": [{
        "name": "splat_fwd",
        "route": "cuda",
        "source": "lsi_tpu_torch/csrc/splat_fwd.cu",
        "replaces": "lsi_tpu/kernels/splat_pallas.py:141",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
