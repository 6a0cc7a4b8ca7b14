#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path, its training step and its
training CLI (the quality recipe) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). Phases, one line each (timing
phases may print several); any failure ends the run with a non-zero exit
and no result line:

1. device  — require CUDA; card name and power limit, torch/CUDA/nvcc.
2. build   — build every kernel library from lsi_tpu_torch/csrc, one nvcc
             per library, all started together: splat_fwd (K1) and
             splat_bwd (lsi_splat_vjp, lsi_gather_fwd,
             lsi_gather_bwd_coords).
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
             end-to-end frames/s at b8 and b16; K1 vs plain per call at
             random +-40 px and on the b8 render's own inputs (recorded
             from one render).
7. vjp     — SplatFn (forward K1, backward lsi_splat_vjp = K2 + K3)
             against the plain splat and autograd through it at the
             training splat's shape (16, 768, 768, 4) -> (256, 768), with
             +-1e6 and snap-zone coordinates; lsi_splat_vjp twice, bitwise
             equal.
8. gather  — GatherFn (lsi_gather_fwd; lsi_gather_bwd_coords and the
             unsnapped K1 in the backward, K4) against autograd through
             the plain gather at image (16, 256, 768, 3), coordinates
             (16, 768, 768, 2) crossing the borders and at +-1e6.
9. golden-train — three train steps on the card (float32, TF32 off)
             against the JAX numbers in tests/data/torch_golden_train_toy.npz.
10. train  — kitti_ldi3_b16 at its published widths (L=3, base_filters=32,
             num_scales=5, bf16, photo_mode="both"), 256x768, batch 16,
             two-plane synthetic scenes, params from seed 0: 4 steps
             through make_train_step; every kernel launched once a step.
11. timing — train step ms and steps/s at b16 and b8; each kernel vs its
             plain version in turns, at random +-40 px and, for K1 and
             lsi_gather_fwd, on the b16 step's own inputs (recorded from
             one step); F.grid_sample on the same inputs as the gather's
             library yardstick.
12. golden-quality — two two-prediction steps of the toy quality recipe
             on the card (float32, TF32 off) against the JAX numbers in
             tests/data/torch_golden_quality_toy.npz (loss parts with
             depth_consistency, depth_anchor and the _rev terms; step-1
             gradients); whether K1 keeps a float32 denormal weight (H12).
13. quality — python -m lsi_tpu_torch.train --config=kitti_ldi3_quality,
             called in-process at the preset's widths (256x768, batch 8,
             L=3, base_filters=32, num_scales=5, bf16) on multi-object
             synthetic scenes, with only the phase boundaries moved into 8
             steps: consistency warm-up, full step, evals with the best
             export, the splice from the best export and the layer-0
             freeze, checkpoints; launches per step kind and per eval
             against the table; then a resume to step 10, and the eval
             CLI on the checkpoint. Host seconds (synchronised) of each
             training batch's generation, step, eval and checkpoint save,
             beside the jsonl's steps_per_sec, whose window holds them all.
14. timing — the quality step at b8 (full and warm-up): ms, steps/s,
             peak memory; the eval step per batch; K1 on the step's own
             inputs at both of its shapes (full LDI and layer 0 alone),
             lsi_splat_vjp and the gather kernels on the step's own
             inputs, each held to its plain version (at phases 3, 7 and
             8's tolerances) and timed beside it, its bound and, for the
             gathers, F.grid_sample (forward; backward for the grid).
15. golden-mpi — the MPI baseline on the card (float32, TF32 off) against
             the JAX numbers in tests/data/torch_golden_mpi_toy.npz:
             plane_homography, render_mpi values and gradients, the clips'
             gradient at alphas exactly 0 and 1 (H14), the expected source
             disparity, and three train steps of the toy mpi_baseline.
16. mpi    — python -m lsi_tpu_torch.train --config=mpi_baseline,
             in-process at the preset's widths (D=16, base_filters=16,
             num_scales=4, bf16, 128x256, batch 8, two-plane scenes), the
             horizon and the eval and checkpoint boundaries moved into 8
             steps: launches per step and per eval batch against the
             table (the D planes warped by one gather), evals with the
             best export, a resume to step 10, the eval CLI, and the
             layer-0 freeze refused with ValueError.
17. options — kitti_ldi3_b16 at its widths (256x768, b16) with
             loss.candidate_radius=1 and loss.ssim_weight=0.85: 3 steps
             through make_train_step, launches per step (the 9 candidate
             gathers are one stacked call), finite loss parts, and the
             candidate gather held to the plain gather (forward and
             coordinate VJP) on the step's own inputs.
18. timing — the MPI step at b8 (ms, steps/s, peak memory) and its eval
             step per batch; lsi_gather_fwd and K1 in its d_image role on
             the MPI step's own inputs, each beside its plain version, its
             bound and F.grid_sample (forward; backward for the input);
             the b16 step with the loss options in turns with the plain
             b16 step; the gather kernels on the candidate gathers' own
             inputs beside grid_sample (forward; backward for the grid).

The line before the last two is {"kernels": [...]}, then the card's name
and power limit as nvidia-smi prints them, and last
{"ok": true, "device": {...}}. Each kernel's ``launches`` counts the five
main paths (phases 5, 10, 13, 16 and 17, each counted from 0).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from lsi_tpu_torch.api import LSIModel
from lsi_tpu_torch.config import Config, build_config, get_config
from lsi_tpu_torch.data.pipeline import Batch, batch_stream
from lsi_tpu_torch.geometry.homography import plane_homography
from lsi_tpu_torch.geometry.ldi import render_forward
from lsi_tpu_torch.geometry.transforms import pose_from_euler, translation_pose
from lsi_tpu_torch.kernels import build, gather_cuda, splat_cuda
from lsi_tpu_torch.evaluation import runner
from lsi_tpu_torch.models.convert import (jax_from_state_dict,
                                          state_dict_from_jax)
from lsi_tpu_torch.models.ldi_predictor import freeze_layer0_grad_mask
from lsi_tpu_torch.models.mpi import MPI, mpi_source_disparity, render_mpi
from lsi_tpu_torch.ops.gather import bilinear_sample
from lsi_tpu_torch.ops.splat import splat_bilinear
from lsi_tpu_torch.train import trainer as trainer_mod
from lsi_tpu_torch.train.__main__ import main as train_main
from lsi_tpu_torch.train.checkpoint import (import_params_npz,
                                            read_params_npz_meta)
from lsi_tpu_torch.train.trainer import (create_state, loss_and_grads,
                                         make_lr_schedule, make_train_step)

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "data" / "torch_golden_toy.npz"
GOLDEN_TRAIN = REPO / "tests" / "data" / "torch_golden_train_toy.npz"
GOLDEN_QUALITY = REPO / "tests" / "data" / "torch_golden_quality_toy.npz"
GOLDEN_MPI = REPO / "tests" / "data" / "torch_golden_mpi_toy.npz"

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
# K2/K3 and K4 vs autograd through the plain versions: the same float32
# products summed over 4 corners in another order, and differences of
# corner terms for the coordinates: rtol 1e-4, atol 1e-5 * max|reference|.
# d_image of the gather sums K1's atomics: the same.
VJP_RTOL = 1e-4
VJP_ATOL_OF_MAX = 1e-5
# Golden train (tests/test_torch_train.py gives the reasons): the splat
# and gather gradients jump where a coordinate crosses a pixel or
# snap-zone edge, so JAX's own jit and eager gradients differ by up to
# 2.5e-4, and Adam turns that into steps of up to lr. Loss parts: tight
# while the params are equal (steps 1-2); step-1 gradients within 2e-4 of
# the largest (sound runs read 2e-5 to 5e-5 of it, planted faults 4e-2 and
# more: scripts/train_parity_spread.py); params after 3 steps within the
# step sizes' sum, and within 20% of the average movement on average,
# movements' cosine >= 0.95.
# Loss parts get 1e-4 here (TF32 off, cuDNN vs XLA CPU convs).
TRAIN_LOSS_RTOL = (1e-4, 1e-4, 2e-3)
TRAIN_NORM_RTOL = (2e-3, 2e-3, 5e-2)
TRAIN_GRAD_ATOL_OF_MAX = 2e-4
# Golden quality: the card's step-1 gradients read 2.7e-4 of the largest
# against the fixture, the port on the CPU 1.5e-5 (whose test holds 2e-4).
# The gap is not the kernels' (the plain splat and gather on the card give
# the same gap) and no pixel, snap-zone or weight decision flips: the
# cuDNN convolutions move the predicted LDI by ~2e-6, and the consistency
# terms' gradient is steep in the LDI where the rendered disparity is a
# ratio of small splat weights (ROADMAP H13; scripts/quality_grad_by_part.py).
# JAX's own jit and eager gradients differ by 1.25e-4 of the largest;
# planted faults in the two-prediction terms read 0.31 to 1.85
# (scripts/train_parity_spread.py --quality). Hence 5e-4 of the largest
# here; the loss parts keep phase 9's tolerances.
QUALITY_GRAD_ATOL_OF_MAX = 5e-4
TRAIN_PARAM_MEAN = 0.2
TRAIN_PARAM_COS = 0.95

# The quality run (phase 13): the preset at its widths on multi-object
# synthetic scenes, only the phase boundaries moved into 8 steps.
QUALITY_SETS = ["data.dataset=synthetic", "data.synthetic_scene=multi",
                "train.max_steps=8", "loss.consistency_start_step=2",
                "train.eval_every=3", "train.eval_batches=1",
                "train.freeze_layer0_step=6", "train.checkpoint_every=4",
                "train.log_every=1"]
# Launches per step kind, read from the loss code (PERF.md's table): the
# full step renders the full LDI 6 times (photometric splat, pseudo-label
# and anchor, each both ways) and layer 0 alone 4 times under no_grad (the
# disocclusion masks of the pseudo-label and the anchor); the warm-up step
# drops the pseudo-label. Every full-LDI render is differentiated; each
# direction's inverse warp gathers once. An eval batch renders the LDI
# twice and layer 0 once, without gradients.
FULL_STEP = {"splat_fwd": 10, "splat_vjp": 6, "gather_fwd": 2,
             "gather_bwd_coords": 2}
STEP_LAUNCHES = {"warmup": {"splat_fwd": 6, "splat_vjp": 4, "gather_fwd": 2,
                            "gather_bwd_coords": 2},
                 "full": FULL_STEP, "freeze": FULL_STEP}
EVAL_LAUNCHES = {"splat_fwd": 3, "splat_vjp": 0, "gather_fwd": 0,
                 "gather_bwd_coords": 0}

# The MPI run (phase 16): the preset at its widths, the horizon and the
# eval and checkpoint boundaries moved into 8 steps. A step warps the B*D
# planes by one gather, whose backward is one unsnapped K1 (the planes'
# gradient; the homographies are constants); an eval batch gathers once.
MPI_SETS = ["train.max_steps=8", "train.eval_every=3", "train.eval_batches=1",
            "train.checkpoint_every=4", "train.log_every=1"]
MPI_STEP = {"splat_fwd": 1, "splat_vjp": 0, "gather_fwd": 1,
            "gather_bwd_coords": 0}
MPI_EVAL = {"splat_fwd": 0, "splat_vjp": 0, "gather_fwd": 1,
            "gather_bwd_coords": 0}
# Golden MPI render values and gradients, as the CPU test holds them.
MPI_VAL_ATOL = 1e-5
MPI_GRAD_ATOL_OF_MAX = 1e-4
# The loss options (phase 17) on kitti_ldi3_b16: the candidate gathers
# (9 offsets in one stacked gather) and the SSIM mix; one launch of each
# kernel per step, as without them.
OPTION_SETS = ["data.dataset=synthetic", "loss.candidate_radius=1",
               "loss.ssim_weight=0.85"]
OPTION_STEPS = 3

SPLAT_SHAPE = (8, 512, 768, 4)  # N, L*H, W, C of the flagship render
OUT_HW = (256, 768)
REQUESTS = 4
BATCH = 8
TRAIN_SPLAT_SHAPE = (16, 768, 768, 4)  # kitti_ldi3_b16: N, L*H, W, C
GATHER_IMAGE = (16, 256, 768, 3)
TRAIN_STEPS = 4

# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


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


def in_turns(fns, iters: int):
    """Mean ms of each of two functions timed plain, kernel, kernel, plain
    (``fns`` = {"plain": f, "kernel": g}), and the four readings."""
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(cuda_ms(fns[which], iters=iters))
    return ({k: float(np.mean(v)) for k, v in times.items()}, times)


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the float32 peak."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / FP32_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def corners_in_image(coords: torch.Tensor, h: int, w: int) -> int:
    """How many of the coordinates' 4 bilinear corners lie in an h x w
    image (the data-dependent part of the kernels' work)."""
    x0 = torch.floor(coords[..., 0])
    y0 = torch.floor(coords[..., 1])
    total = 0
    for dy in (0, 1):
        for dx in (0, 1):
            total += int(((x0 + dx >= 0) & (x0 + dx <= w - 1)
                          & (y0 + dy >= 0) & (y0 + dy <= h - 1)).sum())
    return total


def splat_inputs(rng: np.random.Generator, dev: torch.device,
                 shape=SPLAT_SHAPE, snap_zone: bool = False):
    """Render-like splat inputs: each folded row lands near its base row,
    shifted up to +-40 px across and +-3 rows; 1% of pixels far outside
    (+-1e6, as where the projection clamps its denominator) and some just
    off the image edges; with ``snap_zone``, 2% of x fractions inside the
    snap zones (within MIN_FRACTION of an integer)."""
    n, hs, ws, c = shape
    ho, wo = OUT_HW
    values = rng.uniform(size=(n, hs, ws, c)).astype(np.float32)
    x = (np.arange(ws, dtype=np.float32)[None, None, :]
         + rng.uniform(-40, 40, (n, hs, ws)).astype(np.float32))
    y = ((np.arange(hs, dtype=np.float32) % ho)[None, :, None]
         + rng.uniform(-3, 3, (n, hs, ws)).astype(np.float32))
    if snap_zone:
        near = rng.uniform(size=(n, hs, ws)) < 0.02
        x[near] = np.round(x[near]) + rng.choice(
            np.array([-5e-5, 5e-5], np.float32), int(near.sum()))
    far = rng.uniform(size=(n, hs, ws)) < 0.01
    x[far] = 1e6
    y[rng.uniform(size=(n, hs, ws)) < 0.01] = -1e6
    coords = np.stack([x, y], -1)
    weights = rng.uniform(0.0, 1.0, (n, hs, ws, 1)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (values, coords, weights))


def gather_inputs(rng: np.random.Generator, dev: torch.device):
    """The inverse-warp gather's shapes: a (16, 256, 768, 3) target and
    (16, 768, 768, 2) folded-layer coordinates near each row's base row,
    +-40 px across (so the left and right borders are crossed) and +-3
    rows (the top and bottom ones), 1% at +-1e6."""
    n, hi, wi, c = GATHER_IMAGE
    hs, ws = 3 * hi, wi
    image = rng.uniform(size=(n, hi, wi, c)).astype(np.float32)
    x = (np.arange(ws, dtype=np.float32)[None, None, :]
         + rng.uniform(-40, 40, (n, hs, ws)).astype(np.float32))
    y = ((np.arange(hs, dtype=np.float32) % hi)[None, :, None]
         + rng.uniform(-3, 3, (n, hs, ws)).astype(np.float32))
    x[rng.uniform(size=(n, hs, ws)) < 0.01] = -1e6
    y[rng.uniform(size=(n, hs, ws)) < 0.01] = 1e6
    coords = np.stack([x, y], -1)
    return tuple(torch.from_numpy(a).to(dev) for a in (image, coords))


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


def check_vjp(name: str, got, ref) -> float:
    """Each gradient against the plain one: VJP_RTOL, VJP_ATOL_OF_MAX."""
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        atol = VJP_ATOL_OF_MAX * r.abs().max().item()
        err = max(err, check_close(f"{name}[{i}]", g, r, VJP_RTOL, atol))
    return err


def grads_of(fn, inputs, cotangents):
    """Outputs of ``fn`` on fresh leaves of ``inputs`` that require grad,
    and their VJP with ``cotangents``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    grads = torch.autograd.grad(outs, leaves, cotangents)
    return [o.detach() for o in outs], grads


def with_tf32_off(fn):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return fn()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextlib.contextmanager
def recording():
    """Record the arguments (cloned) of every K1 and lsi_gather_fwd launch
    made inside, as {"splat_fwd": [(values, coords, weights, out_hw,
    snap)], "gather_fwd": [(image, coords)]}: the main path's own inputs.
    The launches themselves run and count as usual."""
    calls = {"splat_fwd": [], "gather_fwd": []}
    launch_splat = splat_cuda._launch_splat
    launch_gather = gather_cuda._launch_gather_fwd

    def splat(values, coords, weights, out_hw, snap, tiling=None):
        calls["splat_fwd"].append((values.clone(), coords.clone(),
                                   weights.clone(), tuple(out_hw), snap))
        return launch_splat(values, coords, weights, out_hw, snap, tiling)

    def gather(image, coords, tiling=None):
        calls["gather_fwd"].append((image.clone(), coords.clone()))
        return launch_gather(image, coords, tiling)

    splat_cuda._launch_splat, gather_cuda._launch_gather_fwd = splat, gather
    try:
        yield calls
    finally:
        splat_cuda._launch_splat = launch_splat
        gather_cuda._launch_gather_fwd = launch_gather


def k1_bound(values, coords, weights, out_hw):
    """K1's bound: each input read and accum/wsum written once, against
    2 (C+1) float32 operations per in-image corner."""
    n, _, _, c = values.shape
    return bound(nbytes(values, coords, weights)
                 + 4 * n * out_hw[0] * out_hw[1] * (c + 1),
                 2 * (c + 1) * corners_in_image(coords, *out_hw))


def k1_image_grad_bound(values, coords, out_hw):
    """K1's bound as the gather's image gradient, the function
    grid_sample's backward for its input computes: the cotangent and the
    coordinates read once, d_image written once, against 2 C float32
    operations per in-image corner. The unit weights GatherFn.backward
    passes and the wsum it discards are not part of that function."""
    n, _, _, c = values.shape
    return bound(nbytes(values, coords) + 4 * n * out_hw[0] * out_hw[1] * c,
                 2 * c * corners_in_image(coords, *out_hw))


def time_k1(label: str, smi: str, values, coords, weights, out_hw,
            snap: bool = True, iters: int = 20, bnd=None):
    """K1 against the plain splat on these inputs (values within
    SPLAT_RTOL), then both timed in turns; logs and returns
    (times, bound, max abs err). ``bnd`` replaces ``k1_bound`` where K1
    computes a narrower function."""
    ref = splat_bilinear(values, coords, weights, out_hw, snap=snap)
    got = splat_cuda.splat(values, coords, weights, out_hw, snap=snap)
    err = max(check_close(f"K1 {label} {name}", g, r, SPLAT_RTOL,
                          SPLAT_ATOL_OF_MAX * r.abs().max().item())
              for name, g, r in zip(("accum", "wsum"), got, ref))
    del ref, got
    t, readings = in_turns({
        "plain": lambda: splat_bilinear(values, coords, weights, out_hw,
                                        snap=snap),
        "kernel": lambda: splat_cuda.splat(values, coords, weights, out_hw,
                                           snap=snap)}, iters=iters)
    if bnd is None:
        bnd = k1_bound(values, coords, weights, out_hw)
    log("timing", f"{smi} | K1 splat {label} {tuple(values.shape)} -> "
        f"{tuple(out_hw)}: {1e3 * t['kernel']:.1f} us/call "
        f"{readings['kernel']}, plain index_add_ {1e3 * t['plain']:.1f} "
        f"us/call {readings['plain']}; bound {1e3 * bnd[0]:.1f} us "
        f"({bnd[1]}); max abs err {err:.3e}")
    return t, bnd, err


def grid_sample_args(image, coords):
    """F.grid_sample's inputs for the same gather: [image, 1] as NCHW (the
    ones channel gives ``valid``) and the coordinates scaled to [-1, 1]
    (align_corners=True)."""
    _, hi, wi, _ = image.shape
    img4 = torch.cat([image, torch.ones_like(image[..., :1])],
                     -1).permute(0, 3, 1, 2).contiguous()
    scale = torch.tensor([2.0 / (wi - 1), 2.0 / (hi - 1)],
                         device=image.device)
    return img4, (coords * scale - 1.0).contiguous()


GS_KW = dict(mode="bilinear", padding_mode="zeros", align_corners=True)


def time_gather_fwd(label: str, smi: str, image, coords, iters: int = 20):
    """lsi_gather_fwd against the plain gather on these inputs (1e-5 /
    1e-6), both timed in turns, and F.grid_sample's forward on the same
    inputs; logs and returns (times, bound, max abs err, grid_sample ms)."""
    got = gather_cuda.gather_fwd(image, coords)
    ref = bilinear_sample(image, coords)
    err = max(check_close(f"gather {label} {name}", g, r, 1e-5, 1e-6)
              for name, g, r in zip(("sampled", "valid"), got, ref))
    t, readings = in_turns({
        "plain": lambda: bilinear_sample(image, coords),
        "kernel": lambda: gather_cuda.gather_fwd(image, coords)},
        iters=iters)
    img4, grid = grid_sample_args(image, coords)
    lib = cuda_ms(lambda: torch.nn.functional.grid_sample(img4, grid,
                                                          **GS_KW),
                  iters=iters)
    _, hi, wi, c = image.shape
    bnd = bound(nbytes(image, coords, *got),
                20 * coords[..., 0].numel()
                + 2 * (c + 1) * corners_in_image(coords, hi, wi))
    log("timing", f"{smi} | lsi_gather_fwd {label} image "
        f"{tuple(image.shape)}, coords {tuple(coords.shape)}: "
        f"{1e3 * t['kernel']:.1f} us/call {readings['kernel']}, plain "
        f"bilinear_sample {1e3 * t['plain']:.1f} us/call; grid_sample "
        f"forward {1e3 * lib:.1f} us; bound {1e3 * bnd[0]:.1f} us "
        f"({bnd[1]}); max abs err {err:.3e}")
    return t, bnd, err, lib


def gather_bwd_bound(image, coords, cot):
    """lsi_gather_bwd_coords' bound: image, coordinates and cotangents read
    and d_coords written once, against 20 float32 operations per sample
    and 2C+2 per in-image corner."""
    _, hi, wi, c = image.shape
    return bound(nbytes(image, coords, *cot) + nbytes(coords),
                 20 * coords[..., 0].numel()
                 + (2 * c + 2) * corners_in_image(coords, hi, wi))


def time_gather_bwd(label: str, smi: str, image, coords, gen,
                    iters: int = 20):
    """lsi_gather_bwd_coords against the plain coordinate VJP (autograd
    through bilinear_sample) on these inputs with random cotangents (VJP
    tolerances), both timed in turns, and F.grid_sample's backward for the
    grid alone on the same inputs; logs and returns (times, bound, max abs
    err, grid_sample ms)."""
    c = image.shape[-1]
    cot = (torch.randn(coords.shape[:-1] + (c,), generator=gen,
                       device=image.device),
           torch.randn(coords.shape[:-1] + (1,), generator=gen,
                       device=image.device))
    fns = {
        "plain": lambda: gather_cuda._plain_coords_vjp(image, coords, *cot),
        "kernel": lambda: gather_cuda.gather_bwd_coords(image, coords, *cot)}
    err = check_vjp(f"lsi_gather_bwd_coords {label}", [fns["kernel"]()],
                    [fns["plain"]()])
    t, readings = in_turns(fns, iters=iters)
    img4, grid = grid_sample_args(image, coords)
    grid = grid.requires_grad_()
    gs_out = torch.nn.functional.grid_sample(img4, grid, **GS_KW)
    gs_cot = torch.randn(gs_out.shape, generator=gen, device=image.device)
    lib = cuda_ms(lambda: torch.autograd.grad(gs_out, grid, gs_cot,
                                              retain_graph=True), iters=iters)
    bnd = gather_bwd_bound(image, coords, cot)
    log("timing", f"{smi} | lsi_gather_bwd_coords {label}: "
        f"{1e3 * t['kernel']:.1f} us/call {readings['kernel']}, plain "
        f"(autograd through bilinear_sample) {1e3 * t['plain']:.1f} us/call; "
        f"grid_sample backward (grid only) {1e3 * lib:.1f} us; bound "
        f"{1e3 * bnd[0]:.1f} us ({bnd[1]}); max abs err {err:.3e} (rtol "
        f"{VJP_RTOL}, atol {VJP_ATOL_OF_MAX}*max|ref|)")
    return t, bnd, err, lib


KERNELS = {"splat_fwd": splat_cuda.splat, "splat_vjp": splat_cuda.splat_vjp,
           "gather_fwd": gather_cuda.gather_fwd,
           "gather_bwd_coords": gather_cuda.gather_bwd_coords}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def golden_serve(dev) -> dict:
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
    return {
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


def golden_train(dev, path=GOLDEN_TRAIN, label="golden-train") -> str:
    """Three steps of a toy config on the card against the JAX numbers in
    ``path`` (the toy kitti_ldi3_b16, or the toy mpi_baseline); returns
    the summary for the log line."""
    with np.load(path) as g:
        golden = {k: g[k] for k in g.files}

    def section(prefix):
        return {k[len(prefix):]: v for k, v in golden.items()
                if k.startswith(prefix)}

    cfg = Config.from_dict(json.loads(bytes(golden["__config__"]).decode()))
    start = state_dict_from_jax(section("params/"), cfg.model)
    state = create_state(cfg, device=dev)
    state.net.load_state_dict(start)
    start = {k: v.to(dev) for k, v in start.items()}
    batches = [Batch(**{k: torch.from_numpy(v).to(dev)
                        for k, v in section(f"batch{i}/").items()})
               for i in range(3)]

    grads = loss_and_grads(state, batches[0], cfg)[1]
    want = {k: v.to(dev)
            for k, v in state_dict_from_jax(section("step1_grads/"),
                                            cfg.model).items()}
    g_max = max(v.abs().max().item() for v in want.values())
    g_err = max(check_close(f"{label} grad {k}", grads[k], want[k], 0.0,
                            TRAIN_GRAD_ATOL_OF_MAX * g_max) for k in want)

    step = make_train_step(cfg)
    metrics_want = section("metrics/")
    worst = {}
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch)
        for k, v in metrics_want.items():
            rtol = (TRAIN_NORM_RTOL if k == "grad_norm" else
                    TRAIN_LOSS_RTOL)[i]
            got, ref = float(metrics[k]), float(v[i])
            if not abs(got - ref) <= 1e-7 + rtol * abs(ref):
                fail(f"{label} {k} at step {i + 1}: {got} vs JAX {ref} "
                     f"(rtol {rtol})")
            worst[k] = max(worst.get(k, 0.0), abs(got - ref) / max(abs(ref),
                                                                  1e-12))
    want = {k: v.to(dev)
            for k, v in state_dict_from_jax(section("step3_params/"),
                                            cfg.model).items()}
    got = state.net.state_dict()
    names = sorted(want)
    diff = torch.cat([(got[k] - want[k]).flatten() for k in names])
    moved = torch.cat([(want[k] - start[k]).flatten() for k in names])
    mine = torch.cat([(got[k] - start[k]).flatten() for k in names])
    lr = make_lr_schedule(cfg)
    lr_sum = sum(lr(c) for c in range(3))
    mean_ratio = (diff.abs().mean() / moved.abs().mean()).item()
    cosine = ((moved @ mine) / (moved.norm() * mine.norm())).item()
    if diff.abs().max().item() > 1.5 * lr_sum:
        fail(f"{label} params: max diff {diff.abs().max().item():.3e} "
             f"beyond 1.5 x the step sizes' sum {lr_sum:.3e}")
    if mean_ratio > TRAIN_PARAM_MEAN or cosine < TRAIN_PARAM_COS:
        fail(f"{label} params: mean diff / mean move {mean_ratio:.3f}, "
             f"cosine {cosine:.4f}")
    return (f"step-1 grads max abs err {g_err:.3e} (max |grad| {g_max:.3e}); "
            "max rel err over 3 steps "
            + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
            + f"; params after 3 steps: max diff "
            f"{diff.abs().max().item():.3e}, mean diff / mean move "
            f"{mean_ratio:.4f}, cosine {cosine:.5f}")


def golden_mpi(dev) -> str:
    """The MPI baseline on the card against the JAX numbers: the plane
    homography, the render and its VJP under a rotation (alphas in (0, 1)
    and 0) and under the identity pose (alphas exactly 0 and 1, exact
    samples: both clips at their bounds, H14), the expected source
    disparity, then three toy train steps. Returns the summary."""
    with np.load(GOLDEN_MPI) as g:
        golden = {k: g[k] for k in g.files}

    def section(prefix):
        return {k[len(prefix):]: v for k, v in golden.items()
                if k.startswith(prefix)}

    def on(x):
        return torch.from_numpy(np.array(x)).to(dev)

    def grad_close(name, got, want):
        return check_close(name, got, on(want), 0.0,
                           MPI_GRAD_ATOL_OF_MAX * float(np.abs(want).max()))

    hom = section("homography/")
    h_err = check_close("golden-mpi plane_homography", plane_homography(
        *(on(hom[k]) for k in ("K_src", "K_trg", "pose", "normal",
                               "depth"))), on(hom["out"]), 1e-5, 1e-6)
    keys = ("rgb", "alpha", "disparity")
    errs, h14 = {}, []
    for name in ("render", "render_id"):
        case = section(name + "/")
        mpi = MPI(on(case["colors"]).requires_grad_(),
                  on(case["alphas"]).requires_grad_(), on(case["depths"]),
                  on(case["intrinsics"]))
        out = render_mpi(mpi, on(case["pose"]))
        v_err = max(check_close(f"golden-mpi {name} {k}", out[k].detach(),
                                on(case[k]), 0.0, MPI_VAL_ATOL) for k in keys)
        grads = torch.autograd.grad([out[k] for k in keys],
                                    (mpi.colors, mpi.alphas),
                                    [on(case["g_" + k]) for k in keys])
        g_err = max(grad_close(f"golden-mpi {name} {k}", g, case[k])
                    for k, g in zip(("d_colors", "d_alphas"), grads))
        errs[name] = (v_err, g_err)
        if name == "render_id":
            at = on((case["alphas"] == 0) | (case["alphas"] == 1))
            h14.append(check_close("golden-mpi H14 (warped alphas)",
                                   grads[1][at], on(case["d_alphas"])[at],
                                   0.0, 1e-6))
            ident = case
    sd = section("srcdisp/")
    alphas = on(ident["alphas"]).requires_grad_()
    out = mpi_source_disparity(MPI(on(ident["colors"]), alphas,
                                   on(ident["depths"]),
                                   on(ident["intrinsics"])))
    s_err = check_close("golden-mpi source disparity", out.detach(),
                        on(sd["out"]), 0.0, MPI_VAL_ATOL)
    (d_alphas,) = torch.autograd.grad(out, alphas, on(sd["g"]))
    s_err = max(s_err, grad_close("golden-mpi source disparity d_alphas",
                                  d_alphas, sd["d_alphas"]))
    at = on((ident["alphas"] == 0) | (ident["alphas"] == 1))
    h14.append(check_close("golden-mpi H14 (source alphas)", d_alphas[at],
                           on(sd["d_alphas"])[at], 0.0, 1e-6))
    train = golden_train(dev, GOLDEN_MPI, "golden-mpi")
    return (f"plane_homography max abs err {h_err:.3e}; render (rotation) "
            f"values {errs['render'][0]:.3e}, VJP {errs['render'][1]:.3e}; "
            f"render (identity, alphas exactly 0 and 1) values "
            f"{errs['render_id'][0]:.3e}, VJP {errs['render_id'][1]:.3e}; "
            f"source disparity {s_err:.3e}; H14: the alphas' gradient at "
            f"exactly 0 and 1 within {max(h14):.3e} of JAX's ({int(at.sum())} "
            f"source entries; warped and source clips); toy mpi_baseline "
            "train steps: " + train)

def golden_quality(dev) -> str:
    """Two steps of the toy two-prediction (quality) step on the card
    against the JAX numbers; returns the summary for the log line."""
    with np.load(GOLDEN_QUALITY) as g:
        golden = {k: g[k] for k in g.files}

    def section(prefix):
        return {k[len(prefix):]: v for k, v in golden.items()
                if k.startswith(prefix)}

    cfg = Config.from_dict(json.loads(bytes(golden["__config__"]).decode()))
    state = create_state(cfg, device=dev)
    state.net.load_state_dict(state_dict_from_jax(section("params/"),
                                                  cfg.model))
    batches = [Batch(**{k: torch.from_numpy(v).to(dev)
                        for k, v in section(f"batch{i}/").items()})
               for i in range(2)]
    grads = loss_and_grads(state, batches[0], cfg)[1]
    want = {k: v.to(dev)
            for k, v in state_dict_from_jax(section("step1_grads/"),
                                            cfg.model).items()}
    g_max = max(v.abs().max().item() for v in want.values())
    g_err = max(check_close(f"golden-quality grad {k}", grads[k], want[k],
                            0.0, QUALITY_GRAD_ATOL_OF_MAX * g_max)
                for k in want)
    metrics_want = section("metrics/")
    for k in ("depth_consistency", "depth_anchor", "photo_splat_rev",
              "photo_inverse_warp_rev", "smoothness_rev"):
        if k not in metrics_want:
            fail(f"golden-quality fixture lacks {k}")
    step = make_train_step(cfg)
    worst = {}
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch)
        if sorted(metrics) != sorted(metrics_want):
            fail(f"golden-quality metrics {sorted(metrics)} vs JAX "
                 f"{sorted(metrics_want)}")
        for k, v in metrics_want.items():
            rtol = (TRAIN_NORM_RTOL if k == "grad_norm" else
                    TRAIN_LOSS_RTOL)[i]
            got, ref = float(metrics[k]), float(v[i])
            if not abs(got - ref) <= 1e-7 + rtol * abs(ref):
                fail(f"golden-quality {k} at step {i + 1}: {got} vs JAX "
                     f"{ref} (rtol {rtol})")
            worst[k] = max(worst.get(k, 0.0),
                           abs(got - ref) / max(abs(ref), 1e-12))
    return (f"step-1 grads max abs err {g_err:.3e} (max |grad| "
            f"{g_max:.3e}, atol {QUALITY_GRAD_ATOL_OF_MAX}*max); loss parts "
            "over 2 steps, max rel err "
            + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items())))


def denormal_probe(dev) -> str:
    """H12: splat weights 1e-39 (a float32 denormal), 2e-38 and 1 to
    pixels 0..2 with K1's shared-memory path, its global-atomics path and
    the plain index_add_, and report each wsum. JAX on the CPU flushes
    denormals to 0; torch on the CPU keeps them."""
    values = torch.ones((1, 1, 3, 1), device=dev)
    coords = torch.tensor([[[[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]]]],
                          device=dev)
    weights = torch.tensor([1e-39, 2e-38, 1.0],
                           device=dev).reshape(1, 1, 3, 1)
    out_hw = (1, 3)
    shared = splat_cuda.splat(values, coords, weights, out_hw)[1]
    glob = splat_cuda._launch_splat(
        values, coords, weights, out_hw, True,
        splat_cuda.splat_tiling(values.shape, out_hw, False,
                                smem_bytes=0))[1]
    plain = splat_bilinear(values, coords, weights, out_hw)[1]
    return (f"wsum of weights [1e-39, 2e-38, 1]: K1 shared-memory path "
            f"{shared.flatten().tolist()}, K1 global atomics "
            f"{glob.flatten().tolist()}, plain index_add_ "
            f"{plain.flatten().tolist()}; exp(-90) on the card "
            f"{torch.exp(torch.tensor(-90.0, device=dev)).item()}")


def host_seconds(fn):
    """``(fn(), host seconds)``, the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def tracing_trainer():
    """Record what the Trainer does inside, as events: ("step", index)
    when a step's phase is chosen, ("data", seconds) after each training
    batch is made, ("run", phase, launches, seconds) after each step,
    ("eval", step, launches, seconds) after each eval, ("save", seconds)
    after each checkpoint, ("splice", state dict) after the splice from
    the best export. Seconds are the host's, synchronised."""
    events = []
    cls = trainer_mod.Trainer
    phase, run_step, run_eval, splice = (cls.phase, cls.run_step,
                                         cls.run_eval,
                                         cls.splice_best_layer0)
    stream, save = trainer_mod.batch_stream, trainer_mod.CheckpointManager.save
    in_eval = []

    def delta(before):
        return {k: v - before[k] for k, v in counts().items()}

    def traced_stream(*args, **kwargs):
        batches = stream(*args, **kwargs)
        while True:
            batch, s = host_seconds(lambda: next(batches))
            if not in_eval:
                events.append(("data", s))
            yield batch

    def traced_phase(self, step):
        events.append(("step", step))
        return phase(self, step)

    def traced_run_step(self, name, state, batch):
        before = counts()
        out, s = host_seconds(lambda: run_step(self, name, state, batch))
        events.append(("run", name, delta(before), s))
        return out

    def traced_run_eval(self, state, step):
        before = counts()
        in_eval.append(step)
        try:
            out, s = host_seconds(lambda: run_eval(self, state, step))
        finally:
            in_eval.pop()
        events.append(("eval", step, delta(before), s))
        return out

    def traced_save(self, step, state):
        _, s = host_seconds(lambda: save(self, step, state))
        events.append(("save", s))

    def traced_splice(self, state):
        state = splice(self, state)
        events.append(("splice", {k: v.detach().clone()
                                  for k, v in state.net.state_dict().items()}))
        return state

    (cls.phase, cls.run_step, cls.run_eval,
     cls.splice_best_layer0) = (traced_phase, traced_run_step,
                                traced_run_eval, traced_splice)
    trainer_mod.batch_stream = traced_stream
    trainer_mod.CheckpointManager.save = traced_save
    try:
        yield events
    finally:
        (cls.phase, cls.run_step, cls.run_eval,
         cls.splice_best_layer0) = phase, run_step, run_eval, splice
        trainer_mod.batch_stream = stream
        trainer_mod.CheckpointManager.save = save


def check_layer0_kept(model_cfg, net, spliced, when: str) -> None:
    """Every layer-0-owned parameter entry bitwise equal to ``spliced``."""
    got = net.state_dict()
    owned = freeze_layer0_grad_mask(
        model_cfg, {k: torch.ones_like(v) for k, v in got.items()})
    for k, v in got.items():
        keep = owned[k] == 0
        if not torch.equal(v[keep], spliced[k][keep]):
            fail(f"quality: layer-0 entries of {k} moved after the splice "
                 f"({when})")


def quality_run(dev, workdir: Path) -> str:
    """Phase 13: the training CLI on the quality preset, its resume and
    the eval CLI; returns the summary for the log line."""
    ckpt = workdir / "quality_run"
    sets = QUALITY_SETS + [f"train.checkpoint_dir={ckpt}"]
    cfg = build_config("kitti_ldi3_quality", sets)
    torch.cuda.reset_peak_memory_stats()
    with tracing_trainer() as events:
        state, _ = train_main(["--config=kitti_ldi3_quality", "--set", *sets])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = [e[1] for e in events if e[0] == "step"]
    runs = [e for e in events if e[0] == "run"]
    evals = [e for e in events if e[0] == "eval"]
    splices = [i for i, e in enumerate(events) if e[0] == "splice"]
    want_phases = ["warmup"] * 2 + ["full"] * 4 + ["freeze"] * 2
    if steps != list(range(8)) or [r[1] for r in runs] != want_phases:
        fail(f"quality: steps {steps}, phases {[r[1] for r in runs]}")
    for i, (_, name, launched, _) in enumerate(runs):
        if launched != STEP_LAUNCHES[name]:
            fail(f"quality: step {i + 1} ({name}) launched {launched}, "
                 f"expected {STEP_LAUNCHES[name]}")
    if [e[1] for e in evals] != [3, 6, 8] or any(
            e[2] != EVAL_LAUNCHES for e in evals):
        fail(f"quality: evals {[(e[1], e[2]) for e in evals]}")
    if len(splices) != 1 or events[splices[0] + 1] != ("step", 6):
        fail(f"quality: splice events at {splices}, expected one just "
             "before step index 6")
    spliced = events[splices[0]][1]
    check_layer0_kept(cfg.model, state.net, spliced, "step 8")

    host = {"data": [e[1] for e in events if e[0] == "data"],
            "step": [r[3] for r in runs], "eval": [e[3] for e in evals],
            "save": [e[1] for e in events if e[0] == "save"]}
    if [len(v) for v in host.values()] != [8, 8, 3, 2]:
        fail(f"quality: host timings {host}")

    with open(ckpt / "train.jsonl") as f:
        lines = [json.loads(line) for line in f]
    train_lines = [r for r in lines if "total" in r]
    rates = [r["steps_per_sec"] for r in train_lines]
    if [r["step"] for r in train_lines] != list(range(1, 9)) or \
            [("depth_consistency" in r) for r in train_lines] != \
            [False] * 2 + [True] * 6:
        fail("quality: the jsonl does not show 2 warm-up steps without "
             "depth_consistency, then 6 with it")
    abs_rel = {r["step"]: r["eval_abs_rel"] for r in lines
               if "eval_abs_rel" in r}
    if sorted(abs_rel) != [3, 6, 8] or not all(
            np.isfinite(v) for v in abs_rel.values()):
        fail(f"quality: eval_abs_rel at {abs_rel}")
    best = ckpt / "best_params.npz"
    meta = read_params_npz_meta(str(best))
    with np.load(best) as data:
        keys = {k for k in data.files if not k.startswith("__meta_")}
    if keys != set(jax_from_state_dict(state.net.state_dict())):
        fail("quality: best_params.npz is not in the JAX package's key "
             "format")
    if meta.get("eval_abs_rel") != min(abs_rel.values()) or \
            meta.get("step") not in (3, 6, 8):
        fail(f"quality: best export meta {meta} vs evals {abs_rel}")
    import_params_npz(cfg.model, str(best))

    # Resume: a second call with a longer horizon starts at step 8.
    with tracing_trainer() as events:
        state, _ = train_main(["--config=kitti_ldi3_quality", "--set", *sets,
                               "train.max_steps=10"])
    steps = [e[1] for e in events if e[0] == "step"]
    if steps != [8, 9] or state.step != 10 or any(
            e[0] == "splice" for e in events):
        fail(f"quality resume: steps {steps}, final step {state.step}")
    check_layer0_kept(cfg.model, state.net, spliced, "step 10")

    results = runner.main(["--config=kitti_ldi3_quality", "--set", *sets,
                           "--num_batches", "2", "--image_dir",
                           str(workdir / "eval_images")])
    png = workdir / "eval_images" / "eval_grid.png"
    if not png.read_bytes().startswith(b"\x89PNG") or not all(
            np.isfinite(v) for v in results.values()):
        fail(f"quality eval CLI: {results}")
    def secs(v):
        return "[" + ", ".join(f"{x:.4f}" for x in v) + "]"

    return (f"8 steps (phases {want_phases}), launches per step "
            f"{ {r[1]: r[2] for r in runs} }, per eval batch "
            f"{evals[0][2]}; eval_abs_rel {abs_rel}; best export step "
            f"{meta['step']}; spliced once before step index 6, layer 0 "
            f"bitwise kept to step 10; resumed at step 8; peak memory "
            f"{peak:.2f} GiB; eval CLI on the checkpoint: abs_rel "
            f"{results['abs_rel']:.4f}, psnr {results['psnr']:.3f}, "
            f"occ_abs_rel {results['occ_abs_rel']:.4f}; host seconds (card "
            f"synchronised) of steps 1-8: batch generation "
            f"{secs(host['data'])}, step {secs(host['step'])}, evals at "
            f"3/6/8 {secs(host['eval'])}, checkpoint saves at 4/8 "
            f"{secs(host['save'])}; the jsonl's steps_per_sec {secs(rates)} "
            "(each window holds the step's batch generation, the step, and "
            "the eval and save that follow the step before)")


def vjp_bound(values, coords, weights, out_hw):
    """lsi_splat_vjp's bound: the forward's inputs read twice (once for the
    sums, once for the combine), the cotangents once, against the float32
    operations per pixel and per in-image corner (as in phase 11)."""
    n, hs, ws, c = values.shape
    cot = 4 * n * out_hw[0] * out_hw[1] * (c + 1)
    return bound(2 * nbytes(values, coords, weights) + cot,
                 20 * n * hs * ws
                 + (2 * c + 2) * 2 * corners_in_image(coords, *out_hw)
                 + (2 * c + 12) * n * hs * ws)


def quality_timing(dev, smi: str) -> dict:
    """Phase 14: the quality step (full, warm-up) and the eval step at b8,
    then each kernel on the step's own inputs, held to its plain version;
    returns the kernel readings as {name: (times, bound, max abs err,
    library ms)}."""
    cfg = build_config("kitti_ldi3_quality", QUALITY_SETS[:2])
    b, h, w = cfg.data.batch_size, cfg.data.height, cfg.data.width
    state = create_state(cfg, seed=0, device=dev)
    steps = {"full": make_train_step(cfg),
             "warm-up": make_train_step(cfg.replace(loss=dataclasses.replace(
                 cfg.loss, consistency_weight=0.0)))}
    batch = next(batch_stream(cfg.data, seed=0, device=dev))
    eval_batch = next(batch_stream(runner.eval_data_config(cfg.data), seed=1,
                                   device=dev))
    torch.cuda.synchronize()
    for name, fn in steps.items():
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: fn(state, batch), iters=10)
        log("timing", f"{smi} | quality step ({name}) kitti_ldi3_quality "
            f"b{b} {h}x{w}: {ms:.3f} ms ({1e3 / ms:.3f} steps/s, "
            f"{1e3 * b / ms:.1f} examples/s); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    eval_step = runner.build_eval_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: eval_step(state.net, eval_batch), iters=10)
    log("timing", f"{smi} | eval step kitti_ldi3_quality b{b} {h}x{w}: "
        f"{ms:.3f} ms per batch; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with recording() as calls:
        steps["full"](state, batch)
    del state, batch, eval_batch, steps
    shapes = [tuple(c[0].shape) for c in calls["splat_fwd"]]
    full = [c for c in calls["splat_fwd"] if c[0].shape[1] == 3 * h]
    layer0 = [c for c in calls["splat_fwd"] if c[0].shape[1] == h]
    if len(full) != 6 or len(layer0) != 4 or len(calls["gather_fwd"]) != 2:
        fail(f"one quality step recorded K1 at {shapes} and "
             f"{len(calls['gather_fwd'])} gathers")
    out = {}
    t, bnd, err = time_k1("on the b8 quality step's own inputs (full LDI)",
                          smi, *full[0])
    out["splat_fwd_full"] = (t, bnd, err, None)
    t, bnd, err = time_k1("on the b8 quality step's own inputs (layer 0 "
                          "alone, the disocclusion mask)", smi, *layer0[0])
    out["splat_fwd_layer0"] = (t, bnd, err, None)
    values, coords, weights, out_hw, _ = full[0]
    n, _, _, c = values.shape
    gen = torch.Generator(device=dev).manual_seed(5)
    cot = (torch.randn((n,) + out_hw + (c,), generator=gen, device=dev),
           torch.randn((n,) + out_hw + (1,), generator=gen, device=dev))
    fns = {
        "plain": lambda: splat_cuda._plain_vjp(values, coords, weights, *cot,
                                               out_hw, (True, True, True)),
        "kernel": lambda: splat_cuda.splat_vjp(values, coords, weights, *cot,
                                               out_hw)}
    err = check_vjp("lsi_splat_vjp on the b8 quality step's own inputs",
                    fns["kernel"](), fns["plain"]())
    t, readings = in_turns(fns, iters=10)
    bnd = vjp_bound(values, coords, weights, out_hw)
    out["splat_vjp"] = (t, bnd, err, None)
    log("timing", f"{smi} | lsi_splat_vjp on the b8 quality step's own "
        f"inputs {tuple(values.shape)} -> {out_hw}: "
        f"{1e3 * t['kernel']:.1f} us/call {readings['kernel']}, plain "
        f"(autograd through splat_bilinear) {1e3 * t['plain']:.1f} us/call; "
        f"bound {1e3 * bnd[0]:.1f} us ({bnd[1]}); max abs err {err:.3e} "
        f"(rtol {VJP_RTOL}, atol {VJP_ATOL_OF_MAX}*max|ref|)")
    del full, layer0, values, coords, weights, cot
    image, gcoords = calls["gather_fwd"][0]
    t, bnd, err, lib = time_gather_fwd("on the b8 quality step's own inputs",
                                       smi, image, gcoords)
    out["gather_fwd"] = (t, bnd, err, lib)
    out["gather_bwd_coords"] = time_gather_bwd(
        "on the b8 quality step's own inputs", smi, image, gcoords, gen)
    return out


def mpi_run(dev, workdir: Path) -> str:
    """Phase 16: the training CLI on mpi_baseline at its widths, its resume,
    the eval CLI, and the refused layer-0 freeze; returns the summary."""
    ckpt = workdir / "mpi_run"
    sets = MPI_SETS + [f"train.checkpoint_dir={ckpt}"]
    cfg = build_config("mpi_baseline", sets)
    torch.cuda.reset_peak_memory_stats()
    with tracing_trainer() as events:
        state, _ = train_main(["--config=mpi_baseline", "--set", *sets])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = [e[1] for e in events if e[0] == "step"]
    runs = [e for e in events if e[0] == "run"]
    evals = [e for e in events if e[0] == "eval"]
    if steps != list(range(8)) or [r[1] for r in runs] != ["full"] * 8:
        fail(f"mpi: steps {steps}, phases {[r[1] for r in runs]}")
    for i, (_, _, launched, _) in enumerate(runs):
        if launched != MPI_STEP:
            fail(f"mpi: step {i + 1} launched {launched}, expected {MPI_STEP}")
    if [e[1] for e in evals] != [3, 6, 8] or any(e[2] != MPI_EVAL
                                                 for e in evals):
        fail(f"mpi: evals {[(e[1], e[2]) for e in evals]}")
    with open(ckpt / "train.jsonl") as f:
        lines = [json.loads(line) for line in f]
    train_lines = [r for r in lines if "total" in r]
    parts = ("photo_mpi", "alpha_coverage", "smoothness", "total",
             "grad_norm")
    if [r["step"] for r in train_lines] != list(range(1, 9)) or not all(
            np.isfinite(r[k]) for r in train_lines for k in parts):
        fail(f"mpi: train lines {train_lines}")
    abs_rel = {r["step"]: r["eval_abs_rel"] for r in lines
               if "eval_abs_rel" in r}
    coverage = [r["eval_coverage"] for r in lines if "eval_coverage" in r]
    if sorted(abs_rel) != [3, 6, 8] or not all(
            np.isfinite(v) for v in list(abs_rel.values()) + coverage):
        fail(f"mpi: eval_abs_rel at {abs_rel}, coverage {coverage}")
    best = ckpt / "best_params.npz"
    meta = read_params_npz_meta(str(best))
    with np.load(best) as data:
        keys = {k for k in data.files if not k.startswith("__meta_")}
    if keys != set(jax_from_state_dict(state.net.state_dict())) or not any(
            k.startswith("mpi_head/") for k in keys):
        fail("mpi: best_params.npz is not the MPI's params in the JAX "
             "package's key format")
    if meta.get("eval_abs_rel") != min(abs_rel.values()):
        fail(f"mpi: best export meta {meta} vs evals {abs_rel}")
    import_params_npz(cfg.model, str(best))

    with tracing_trainer() as events:
        state, _ = train_main(["--config=mpi_baseline", "--set", *sets,
                               "train.max_steps=10"])
    steps = [e[1] for e in events if e[0] == "step"]
    if steps != [8, 9] or state.step != 10:
        fail(f"mpi resume: steps {steps}, final step {state.step}")

    before = counts()
    results = runner.main(["--config=mpi_baseline", "--set", *sets,
                           "--num_batches", "2", "--image_dir",
                           str(workdir / "mpi_images")])
    eval_cli = {k: v - before[k] for k, v in counts().items()}
    png = workdir / "mpi_images" / "eval_grid.png"
    if (eval_cli != {k: 2 * v for k, v in MPI_EVAL.items()}
            or not png.read_bytes().startswith(b"\x89PNG")
            or not all(np.isfinite(v) for v in results.values())):
        fail(f"mpi eval CLI: {results}, launches {eval_cli}")
    try:
        train_main(["--config=mpi_baseline", "--set", *sets,
                    f"train.checkpoint_dir={workdir / 'mpi_freeze'}",
                    "train.freeze_layer0_step=4"])
    except ValueError as e:
        refused = str(e)
    else:
        fail("mpi: train.freeze_layer0_step=4 was not refused")
    last = train_lines[-1]
    return (f"8 steps, launches per step {runs[0][2]}, per eval batch "
            f"{evals[0][2]}; step 8 " + ", ".join(
                f"{k} {last[k]:.5f}" for k in parts)
            + f"; eval_abs_rel {abs_rel}, eval_coverage {coverage}; best "
            f"export step {meta['step']}; resumed at step 8 to 10; peak "
            f"memory {peak:.2f} GiB; eval CLI: abs_rel "
            f"{results['abs_rel']:.4f}, psnr {results['psnr']:.3f}, "
            f"psnr_full {results['psnr_full']:.3f}, coverage "
            f"{results['coverage']:.4f}, launches {eval_cli}; "
            f"freeze_layer0_step=4 refused: ValueError({refused!r})")


def loss_options_run(dev):
    """Phase 17: kitti_ldi3_b16 with the candidate gathers and the SSIM mix
    for OPTION_STEPS steps; the candidate gather on the step's own inputs
    held to the plain gather. Returns (summary, launches, the max abs errs
    of the two gather kernels, what phase 18 times)."""
    cfg = build_config("kitti_ldi3_b16", OPTION_SETS)
    state = create_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg)
    stream = batch_stream(cfg.data, seed=0, device=dev)
    batches = [next(stream) for _ in range(OPTION_STEPS)]
    torch.cuda.synchronize()
    reset_counts()
    per_step, history = [], []
    for i, batch in enumerate(batches):
        before = counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in counts().items()})
        history.append({k: float(v) for k, v in metrics.items()})
        if not all(np.isfinite(v) for v in history[-1].values()):
            fail(f"options step {i + 1}: non-finite metrics {history[-1]}")
    launched = counts()
    if any(c != {name: 1 for name in KERNELS} for c in per_step):
        fail(f"options: launches per step {per_step}, expected one each")
    with recording() as calls:
        step(state, batches[0])
    image, coords = calls["gather_fwd"][0]
    n, h, w, _ = image.shape
    if tuple(coords.shape) != (n, 9 * cfg.model.num_layers * h, w, 2):
        fail(f"options: the candidate gather's coordinates are "
             f"{tuple(coords.shape)}")
    got = gather_cuda.gather_fwd(image, coords)
    ref = bilinear_sample(image, coords)
    fwd_err = max(check_close(f"candidate gather {k}", g, r, 1e-5, 1e-6)
                  for k, g, r in zip(("sampled", "valid"), got, ref))
    del got, ref
    gen = torch.Generator(device=dev).manual_seed(6)
    cot = (torch.randn(coords.shape[:-1] + (3,), generator=gen, device=dev),
           torch.randn(coords.shape[:-1] + (1,), generator=gen, device=dev))
    bwd_err = check_vjp("candidate gather d_coords",
                        [gather_cuda.gather_bwd_coords(image, coords, *cot)],
                        [gather_cuda._plain_coords_vjp(image, coords, *cot)])
    del cot
    summary = (f"kitti_ldi3_b16 at {n}x{h}x{w} with {OPTION_SETS[1:]}: "
               f"{OPTION_STEPS} steps; launches per step {per_step[0]}; "
               "metrics " + "; ".join(
                   ", ".join(f"{k} {v:.5f}" for k, v in sorted(m.items()))
                   for m in history)
               + f"; the candidate gather on the step's own inputs (image "
               f"{tuple(image.shape)}, coords {tuple(coords.shape)}) vs the "
               f"plain gather: sampled/valid max abs err {fwd_err:.3e}, "
               f"d_coords {bwd_err:.3e}")
    return (summary, launched, {"gather_fwd": fwd_err,
                                "gather_bwd_coords": bwd_err},
            (cfg, state, batches[0], image, coords))


def mpi_timing(dev, smi: str) -> dict:
    """Phase 18, MPI half: the MPI step and eval step at b8, then
    lsi_gather_fwd and K1 (the planes' gradient) on the step's own inputs;
    returns {name: max abs err}."""
    cfg = get_config("mpi_baseline")
    b, h, w = cfg.data.batch_size, cfg.data.height, cfg.data.width
    state = create_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg)
    batch = next(batch_stream(cfg.data, seed=0, device=dev))
    eval_batch = next(batch_stream(runner.eval_data_config(cfg.data), seed=1,
                                   device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch), iters=10)
    log("timing", f"{smi} | mpi_baseline step b{b} {h}x{w} "
        f"(D={cfg.model.num_planes}): {ms:.3f} ms ({1e3 / ms:.3f} steps/s, "
        f"{1e3 * b / ms:.1f} examples/s); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    eval_step = runner.build_eval_step(cfg)
    ms = cuda_ms(lambda: eval_step(state.net, eval_batch), iters=10)
    log("timing", f"{smi} | mpi_baseline eval step b{b} {h}x{w}: {ms:.3f} ms "
        "per batch")
    with recording() as calls:
        step(state, batch)
    del state, batch, eval_batch
    if [len(v) for v in calls.values()] != [1, 1]:
        fail(f"one MPI step recorded {[len(v) for v in calls.values()]} "
             "K1 and gather launches")
    image, coords = calls["gather_fwd"][0]
    _, _, g_err, _ = time_gather_fwd("on the b8 mpi_baseline step's own "
                                     "inputs (B*D planes)", smi, image, coords)
    values, kcoords, weights, out_hw, snap = calls["splat_fwd"][0]
    if snap or tuple(values.shape) != tuple(coords.shape[:-1]) + (4,):
        fail(f"the MPI step's K1 launch is not the planes' gradient: "
             f"snap {snap}, values {tuple(values.shape)}")
    _, _, k_err = time_k1("on the b8 mpi_baseline step's own inputs (the "
                          "planes' gradient, unsnapped; bound of d_image "
                          "alone)", smi, *calls["splat_fwd"][0],
                          bnd=k1_image_grad_bound(values, kcoords, out_hw))
    # The library call computing the same function: grid_sample's backward
    # for its input, with the same cotangent.
    img = image.permute(0, 3, 1, 2).contiguous().requires_grad_()
    _, hi, wi, _ = image.shape
    scale = torch.tensor([2.0 / (wi - 1), 2.0 / (hi - 1)], device=dev)
    grid = (coords * scale - 1.0).contiguous()
    gs_out = torch.nn.functional.grid_sample(img, grid, **GS_KW)
    gs_cot = values.permute(0, 3, 1, 2)
    lib = cuda_ms(lambda: torch.autograd.grad(gs_out, img, gs_cot,
                                              retain_graph=True), iters=20)
    (lib_grad,) = torch.autograd.grad(gs_out, img, gs_cot)
    diff = (lib_grad.permute(0, 2, 3, 1)
            - splat_cuda.splat(values, kcoords, weights, out_hw,
                               snap=False)[0]).abs().max().item()
    log("timing", f"{smi} | grid_sample backward (input only) on the same "
        f"inputs: {1e3 * lib:.1f} us; its gradient vs K1's accum: max abs "
        f"diff {diff:.3e}")
    return {"gather_fwd": g_err, "splat_fwd": k_err}


def options_timing(dev, smi: str, recorded) -> dict:
    """Phase 18, loss-options half: the b16 step with the options in turns
    with the plain b16 step, then both gather kernels on the candidate
    gathers' own inputs; returns {name: max abs err}."""
    cfg, state, batch, image, coords = recorded
    steps = {"plain": make_train_step(build_config("kitti_ldi3_b16",
                                                   OPTION_SETS[:1])),
             "kernel": make_train_step(cfg)}
    fns = {k: (lambda fn=fn: fn(state, batch)) for k, fn in steps.items()}
    torch.cuda.reset_peak_memory_stats()
    t, readings = in_turns(fns, iters=5)
    b = batch.src_image.shape[0]
    log("timing", f"{smi} | train step kitti_ldi3_b16 b{b} with "
        f"{OPTION_SETS[1:]}: {t['kernel']:.3f} ms ({1e3 / t['kernel']:.3f} "
        f"steps/s) {readings['kernel']}; without them (in turns) "
        f"{t['plain']:.3f} ms {readings['plain']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, batch
    label = "on the b16 step's candidate gathers (9 offsets stacked)"
    _, _, f_err, _ = time_gather_fwd(label, smi, image, coords)
    _, _, b_err, _ = time_gather_bwd(label, smi, image, coords,
                                     torch.Generator(device=dev).manual_seed(7))
    return {"gather_fwd": f_err, "gather_bwd_coords": b_err}


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

    # 2. Build: one nvcc per library, all started together.
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(build.LIBRARIES)) as pool:
        paths = dict(zip(build.LIBRARIES,
                         pool.map(build.build, build.LIBRARIES)))
    for name in build.LIBRARIES:
        build.load(name)
    log("build", f"{', '.join(build.LIBRARIES)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s -> "
        + ", ".join(str(p.relative_to(REPO)) for p in paths.values()))

    # 3. K1 vs plain at the serving path's shape.
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
    del acc_ref, ws_ref, acc_1, ws_1, acc_2, ws_2

    # 4. Golden check against the JAX outputs, float32 with TF32 off.
    errs = with_tf32_off(lambda: golden_serve(dev))
    log("golden", "port on CUDA vs JAX (CPU) at 2x32x64, float32: max abs "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (LDI atol {GOLDEN_LDI_ATOL}, render atol {GOLDEN_RENDER_ATOL})")

    # 5. The serving path at full width.
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

    reset_counts()
    results = []
    for i, image in enumerate(images):
        ldi = model.predict_ldi(image)
        results.append((ldi, poses[i % 2], model.render(ldi, poses[i % 2])))
    torch.cuda.synchronize()
    serve_counts = counts()
    if serve_counts["splat_fwd"] != REQUESTS:
        fail(f"K1 launched {serve_counts['splat_fwd']} times for {REQUESTS} "
             "renders")

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
        f"launches {serve_counts['splat_fwd']} = renders {REQUESTS}; covered "
        "pixels " + ", ".join(f"{c:.1%}" for c in covered))
    # The render's own K1 inputs, recorded during one more render.
    with recording() as serve_calls:
        model.render(results[0][0], results[0][1])
    if [len(v) for v in serve_calls.values()] != [1, 0]:
        fail(f"one render recorded {serve_calls}")
    del results

    # 6. Serving timing.
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
    del model
    # K1 and plain in turns (plain, K1, K1, plain), at the b8 render shape
    # with random +-40 px targets, then on the b8 render's own inputs.
    k1, k1_bound, _ = time_k1("at random +-40 px", smi, values, coords,
                              weights, OUT_HW, iters=50)
    del values, coords, weights
    _, _, err = time_k1("on the b8 kitti_ldi2 render's own inputs", smi,
                        *serve_calls["splat_fwd"][0], iters=50)
    max_err = max(max_err, err)
    del serve_calls

    # 7. SplatFn, forward (K1) and VJP (K2 + K3), at the training splat's
    # shape.
    rng = np.random.default_rng(2)
    s_in = splat_inputs(rng, dev, TRAIN_SPLAT_SHAPE, snap_zone=True)
    n, hs, ws, c = TRAIN_SPLAT_SHAPE
    gen = torch.Generator(device=dev).manual_seed(3)
    s_cot = (torch.randn((n,) + OUT_HW + (c,), generator=gen, device=dev),
             torch.randn((n,) + OUT_HW + (1,), generator=gen, device=dev))
    out_k, vjp_k = grads_of(lambda *a: splat_cuda.SplatFn.apply(*a, OUT_HW),
                            s_in, s_cot)
    out_p, vjp_p = grads_of(lambda *a: splat_bilinear(*a, OUT_HW), s_in,
                            s_cot)
    torch.cuda.synchronize()
    # K1 at the training shape: SplatFn's forward against the plain splat.
    train_fwd_err = 0.0
    for name, got, ref in zip(("accum", "wsum"), out_k, out_p):
        atol = SPLAT_ATOL_OF_MAX * ref.abs().max().item()
        train_fwd_err = max(train_fwd_err, check_close(
            f"SplatFn {name} at the training shape", got, ref, SPLAT_RTOL,
            atol))
    max_err = max(max_err, train_fwd_err)
    vjp_err = check_vjp("splat VJP (d_values, d_coords, d_weights)", vjp_k,
                        vjp_p)
    frac = s_in[1][..., 0] - torch.floor(s_in[1][..., 0])
    snapped = ((frac < 1e-4) | (frac > 1 - 1e-4)) & (s_in[1][..., 0].abs()
                                                      < 1e5)
    if vjp_k[1][..., 0][snapped].abs().max().item() != 0.0:
        fail("splat VJP: a coordinate gradient in a snap zone is not 0")
    first = splat_cuda.splat_vjp(*s_in, *s_cot, OUT_HW)
    second = splat_cuda.splat_vjp(*s_in, *s_cot, OUT_HW)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail("lsi_splat_vjp is not bitwise repeatable")
    del out_k, out_p, vjp_k, vjp_p, first, second
    log("vjp", f"SplatFn forward (K1) vs the plain splat at "
        f"{TRAIN_SPLAT_SHAPE} -> {OUT_HW}: max abs err {train_fwd_err:.3e} "
        f"(rtol {SPLAT_RTOL}, atol {SPLAT_ATOL_OF_MAX}*max|ref|); SplatFn "
        f"backward (lsi_splat_vjp) vs autograd through the plain splat: max "
        f"abs err {vjp_err:.3e} (rtol {VJP_RTOL}, atol "
        f"{VJP_ATOL_OF_MAX}*max|ref|); "
        f"{int(snapped.sum())} snap-zone x fractions with zero gradient; two "
        "launches bitwise equal")

    # 8. The gather (K4) at the inverse warp's shapes.
    g_in = gather_inputs(rng, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    g_cot = (torch.randn(g_in[1].shape[:-1] + (3,), generator=gen,
                         device=dev),
             torch.randn(g_in[1].shape[:-1] + (1,), generator=gen,
                         device=dev))
    out_k, grad_k = grads_of(gather_cuda.GatherFn.apply, g_in, g_cot)
    out_p, grad_p = grads_of(bilinear_sample, g_in, g_cot)
    torch.cuda.synchronize()
    fwd_err = max(check_close("gather sampled", out_k[0], out_p[0], 1e-5,
                              1e-6),
                  check_close("gather valid", out_k[1], out_p[1], 1e-5, 1e-6))
    bwd_err = check_vjp("gather VJP (d_image, d_coords)", grad_k, grad_p)
    only_valid = gather_cuda.gather_bwd_coords(
        g_in[0], g_in[1], torch.zeros_like(g_cot[0]), g_cot[1])
    valid_part = only_valid.abs().max().item()
    if valid_part == 0.0:
        fail("gather: the valid mass carries no coordinate gradient")
    partial = ((out_p[1] > 0) & (out_p[1] < 1)).float().mean().item()
    del out_k, grad_k, out_p, grad_p, only_valid
    log("gather", f"GatherFn vs autograd through the plain gather at image "
        f"{GATHER_IMAGE}, coords {tuple(g_in[1].shape)}: sampled/valid max "
        f"abs err {fwd_err:.3e}, d_image/d_coords {bwd_err:.3e}; "
        f"{partial:.2%} of samples partly off-image, |d_coords| from the "
        f"valid cotangent alone up to {valid_part:.3f}")

    # 9. Golden train: the port on CUDA against JAX's numbers.
    summary = with_tf32_off(lambda: golden_train(dev))
    log("golden-train", "toy kitti_ldi3_b16 (2x32x64, float32, TF32 off) "
        "on CUDA vs JAX (CPU): " + summary)

    # 10. The training step at full width.
    config = get_config("kitti_ldi3_b16")
    config = dataclasses.replace(config, data=dataclasses.replace(
        config.data, dataset="synthetic"))
    b, h, w = config.data.batch_size, config.data.height, config.data.width
    state = create_state(config, seed=0, device=dev)
    n_params = sum(p.numel() for p in state.net.parameters())
    step = make_train_step(config)
    stream = batch_stream(config.data, seed=0, device=dev)
    batches = [next(stream) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()

    reset_counts()
    per_step, history = [], []
    for i, batch in enumerate(batches):
        before = counts()
        params = {k: p.detach().clone()
                  for k, p in state.net.named_parameters()}
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in counts().items()})
        history.append({k: float(v) for k, v in metrics.items()})
        if not all(np.isfinite(v) for v in history[-1].values()):
            fail(f"train step {i + 1}: non-finite metrics {history[-1]}")
        same = all(torch.equal(p, params[k])
                   for k, p in state.net.named_parameters())
        if i == 0 and not same:
            fail("train step 1 (lr = 0) changed the parameters")
        if i == 1 and same:
            fail("train step 2 left the parameters unchanged")
    train_counts = counts()
    want = {name: 1 for name in KERNELS}
    if any(c != want for c in per_step):
        fail(f"launches per train step {per_step}, expected {want}")
    log("train", f"kitti_ldi3_b16 ({n_params} params, "
        f"{config.model.compute_dtype}, photo_mode="
        f"{config.loss.photo_mode}) at {b}x{h}x{w}, synthetic two-plane "
        f"scenes: {TRAIN_STEPS} steps; launches per step {per_step[0]}; "
        "params bitwise kept at step 1 (lr 0), moved at step 2; metrics "
        + "; ".join(", ".join(f"{k} {v:.5f}" for k, v in sorted(m.items()))
                    for m in history))

    # 11. Training timing.
    step_ms = {}
    for bb in (16, 8):
        batch = Batch(**{f.name: getattr(batches[0], f.name)[:bb]
                         for f in dataclasses.fields(Batch)})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms[bb] = cuda_ms(lambda: step(state, batch), iters=10)
        log("timing", f"{smi} | train step kitti_ldi3_b16 b{bb} {h}x{w}: "
            f"{step_ms[bb]:.3f} ms ({1e3 / step_ms[bb]:.3f} steps/s, "
            f"{1e3 * bb / step_ms[bb]:.1f} examples/s); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # The step's own K1 and gather inputs, recorded during one more step
    # (after the timed steps, whose peak memory the copies would raise).
    with recording() as train_calls:
        step(state, batches[0])
    if [len(v) for v in train_calls.values()] != [1, 1]:
        fail(f"one train step recorded {train_calls}")
    del state, batches, stream

    kernels = {}
    # K1 at the training splat's shape, then on the b16 step's own inputs.
    time_k1("at random +-40 px", smi, *s_in, OUT_HW)
    _, _, err = time_k1("on the b16 kitti_ldi3_b16 step's own inputs", smi,
                        *train_calls["splat_fwd"][0])
    max_err = max(max_err, err)
    # lsi_splat_vjp.
    t, readings = in_turns({
        "plain": lambda: splat_cuda._plain_vjp(*s_in, *s_cot, OUT_HW,
                                               (True, True, True)),
        "kernel": lambda: splat_cuda.splat_vjp(*s_in, *s_cot, OUT_HW)},
        iters=10)
    bnd = vjp_bound(*s_in, OUT_HW)
    kernels["splat_vjp"] = dict(
        replaces="lsi_tpu/kernels/splat_pallas.py:335", t=t, bound=bnd,
        err=vjp_err, library=None)
    log("timing", f"{smi} | lsi_splat_vjp at {TRAIN_SPLAT_SHAPE} -> "
        f"{OUT_HW}: {1e3 * t['kernel']:.1f} us/call {readings['kernel']}, "
        f"plain (autograd through splat_bilinear) {1e3 * t['plain']:.1f} "
        f"us/call {readings['plain']}; bound {1e3 * bnd[0]:.1f} us "
        f"({bnd[1]})")
    del s_in, s_cot

    # The gather and its yardstick, F.grid_sample (bilinear, zeros,
    # align_corners=True) on [image, 1], which gives sampled and valid: at
    # random +-40 px, then on the b16 step's own inputs.
    image, gcoords = g_in
    t, bnd, _, lib_fwd = time_gather_fwd("at random +-40 px", smi, image,
                                         gcoords)
    kernels["gather_fwd"] = dict(
        replaces="lsi_tpu/kernels/gather_pallas.py:76", t=t, bound=bnd,
        err=fwd_err, library=lib_fwd)
    _, _, err, _ = time_gather_fwd(
        "on the b16 kitti_ldi3_b16 step's own inputs", smi,
        *train_calls["gather_fwd"][0])
    kernels["gather_fwd"]["err"] = max(fwd_err, err)
    del train_calls
    t, bnd, err, lib_bwd = time_gather_bwd(
        "at random +-40 px", smi, image, gcoords,
        torch.Generator(device=dev).manual_seed(8))
    kernels["gather_bwd_coords"] = dict(
        replaces="lsi_tpu/kernels/gather_pallas.py:104", t=t, bound=bnd,
        err=max(bwd_err, err), library=lib_bwd)

    del image, gcoords, g_in, g_cot

    # 12. Golden quality: the two-prediction step against JAX's numbers.
    summary = with_tf32_off(lambda: golden_quality(dev))
    log("golden-quality", "toy kitti_ldi3_quality (2x32x64, float32, TF32 "
        "off) on CUDA vs JAX (CPU): " + summary)
    log("golden-quality", "H12 denormals: " + denormal_probe(dev))

    # 13. The quality recipe through the training CLI, at full width.
    (REPO / "_scratch").mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO / "_scratch"))
    try:
        reset_counts()
        summary = quality_run(dev, workdir)
        quality_counts = counts()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("quality", f"kitti_ldi3_quality at {QUALITY_SETS}: " + summary
        + f"; launches in all {quality_counts}")
    for name in KERNELS:
        if quality_counts[name] == 0:
            fail(f"{name} was not launched by the quality run")

    # 14. Quality timing, and each kernel on the quality step's inputs.
    quality = quality_timing(dev, smi)
    max_err = max(max_err, quality["splat_fwd_full"][2],
                  quality["splat_fwd_layer0"][2])
    for name in ("splat_vjp", "gather_fwd", "gather_bwd_coords"):
        kernels[name]["err"] = max(kernels[name]["err"], quality[name][2])

    # 15. Golden MPI: the MPI baseline against JAX's numbers, H14.
    summary = with_tf32_off(lambda: golden_mpi(dev))
    log("golden-mpi", "toy mpi_baseline (D=4, 2x16x64, float32, TF32 off) "
        "on CUDA vs JAX (CPU): " + summary)

    # 16. The MPI baseline through the training and eval CLIs.
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO / "_scratch"))
    try:
        reset_counts()
        summary = mpi_run(dev, workdir)
        mpi_counts = counts()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("mpi", f"mpi_baseline at {MPI_SETS}: " + summary
        + f"; launches in all {mpi_counts}")
    for name in ("splat_fwd", "gather_fwd"):
        if mpi_counts[name] == 0:
            fail(f"{name} was not launched by the MPI run")

    # 17. The loss options on the b16 training step.
    summary, option_counts, errs, recorded = loss_options_run(dev)
    log("options", summary + f"; launches in all {option_counts}")
    for name, err in errs.items():
        kernels[name]["err"] = max(kernels[name]["err"], err)

    # 18. Timing: the MPI step, the kernels' new roles, the options.
    errs = mpi_timing(dev, smi)
    max_err = max(max_err, errs["splat_fwd"])
    kernels["gather_fwd"]["err"] = max(kernels["gather_fwd"]["err"],
                                       errs["gather_fwd"])
    for name, err in options_timing(dev, smi, recorded).items():
        kernels[name]["err"] = max(kernels[name]["err"], err)
    del recorded

    total = {name: serve_counts[name] + train_counts[name]
             + quality_counts[name] + mpi_counts[name] + option_counts[name]
             for name in KERNELS}
    entries = [{
        "name": "splat_fwd", "route": "cuda",
        "source": "lsi_tpu_torch/csrc/splat_fwd.cu",
        "replaces": "lsi_tpu/kernels/splat_pallas.py:141",
        "launches": total["splat_fwd"], "max_abs_err": max_err,
        "ms": k1["kernel"], "plain_ms": k1["plain"],
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
        "library_ms": None}]
    for name, k in kernels.items():
        entries.append({
            "name": name, "route": "cuda",
            "source": "lsi_tpu_torch/csrc/splat_bwd.cu",
            "replaces": k["replaces"], "launches": total[name],
            "max_abs_err": k["err"], "ms": k["t"]["kernel"],
            "plain_ms": k["t"]["plain"], "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1], "library_ms": k["library"]})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
