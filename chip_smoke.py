#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path, its training step, its
training CLI (the quality recipe), the MPI baseline, the multi-process
paths (the height-sharded render, data-parallel training), training from
disk (materialized shards, KITTI and SYNTHIA layouts) and the trajectory
sweep once on one NVIDIA GPU.

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
             plain version in turns, at random +-40 px and on the b16
             step's own inputs and cotangents (recorded from one step),
             beside its bound; F.grid_sample on the same inputs as the
             gathers' library yardstick (forward; backward for the grid).
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
             step's wait for its batch (online scenes, made by the
             Trainer's prefetch thread), step, eval and checkpoint save,
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

19. window  — K1 and lsi_splat_vjp in their windowed mode (max_dy,
             fold_h, base_offset) on one shard's own inputs (shard 1 of 4
             of the kitti_ldi2 b8 LDI at 256x768, as
             render_forward_spatial builds them) against the plain
             windowed splat and its autograd VJP, at phases 3 and 7's
             tolerances, timed in turns beside their bounds.
20. spatial — render_forward_spatial of the kitti_ldi2 LDI at 256x768
             over 4 spawned ranks sharing cuda:0 through gloo
             (pallas_max_dy 2), at b1 and b8: rgb within 1e-5 of the
             single-device windowed render, disparity and coverage, the
             LDI gradient of a loss through the halo exchange against the
             windowed render's; one windowed K1 and lsi_splat_vjp per rank;
             the share of the unwindowed render's weight the window drops.
21. dp     — two data-parallel steps of kitti_ldi3_quality at its widths
             (256x768, global b8, multi-object scenes) on 2 gloo ranks on
             cuda:0 against the one-process step on the same global
             batches (float32, TF32 off, cuDNN deterministic): loss parts,
             step-1 gradients (also against one process whose network
             runs on the ranks' shares), parameters; three wrong
             reductions read alike must each fail a bound; then bf16:
             finite loss parts, launches per rank.
22. torchrun — torchrun --standalone --nproc_per_node=2 -m
             lsi_tpu_torch.train --config=kitti_ldi3_quality
             --dist_backend gloo at 256x768 b8: 2 steps with an eval and a
             checkpoint, a resume to 3 that splices layer 0 at the freeze;
             rank 0 alone prints and writes.
The ranks of 20-22 share one card: they show the windowed kernels, the
halo exchange and the gradient reduction right at full width, and
measure no multi-GPU scaling.
23. shards — python -m lsi_tpu_torch.data.materialize writes 64
             multi-object scenes at 256x768 with 8 worker processes
             (timed); then phase 13's run of kitti_ldi3_quality through
             the training CLI from those shards (data.root,
             data.prefetch=2): launches per step kind and per eval as
             phase 13's, the step's wait for each batch and the jsonl's
             steps_per_sec beside phase 13's online readings; 6 batches
             through the prefetcher (pinned buffers, a side stream)
             bitwise equal to the synchronous stream's.
24. datasets — python -m lsi_tpu_torch.data.layouts writes a KITTI raw
             tree (375x1242 PNGs, 2 drives of 24 frames, calibration, OXTS
             packets, Velodyne scans on every other frame) and a
             SYNTHIA-SEQS sequence (760x1280, 16 frames, 16-bit depth)
             from synthetic scenes; kitti_ldi3_quality trains through the
             CLI on its own dataset (kitti, no override) for 4 steps with
             an eval against the LiDAR ground truth and a checkpoint; one
             batch of temporal pairs (OXTS poses) through the quality
             step (loss parts and gradient finite); synthia_ldi2_splat
             trains 3 steps on SYNTHIA. Launches per step and eval
             asserted; which decoder each reader used. Then every kernel
             of the temporal step and of one more SYNTHIA step, on that
             step's own recorded inputs and cotangents, against its plain
             version (tolerances of phases 3, 7 and 8), and timed.
25. trajectory — the eval CLI's --trajectory_gif on trajectory_sweep
             (kitti_ldi2 widths, 256x768, bf16, fresh weights): 60 views
             in 8 K1 launches, 60 frames in the GIF (without PIL: the
             option refuses and the frames go out as PNGs written and
             decoded by the standard library); one chunk of 8 poses
             against 8 single-pose renders within 1e-5; the sweep's ms
             and frames/s.

The line before the last two is {"kernels": [...]}, then the card's name
and power limit as nvidia-smi prints them, and last
{"ok": true, "device": {...}}. Each kernel's ``launches`` counts the
main paths (phases 5, 10, 13, 16, 17, 21's bf16 steps, 23, 24 and 25,
each counted from 0); the windowed modes' count phase 20's ranks. Every
entry's ``ms`` and ``plain_ms`` are CUDA-event time per call (host work
in the wrapper included); the windowed entries also carry ``device_ms``,
the kernel alone by torch.profiler.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from lsi_tpu_torch.api import LSIModel
from lsi_tpu_torch.config import Config, build_config, get_config
from lsi_tpu_torch.data.pipeline import (Batch, batch_stream, decode_batch,
                                         make_dataset)
from lsi_tpu_torch.geometry.homography import plane_homography
from lsi_tpu_torch.geometry.ldi import LDI, render_forward
from lsi_tpu_torch.geometry.ldi import splat_inputs as ldi_splat_inputs
from lsi_tpu_torch.geometry.transforms import pose_from_euler, translation_pose
from lsi_tpu_torch.kernels import build, gather_cuda, splat_cuda
from lsi_tpu_torch.evaluation import runner
from lsi_tpu_torch.models.convert import (jax_from_state_dict,
                                          state_dict_from_jax)
from lsi_tpu_torch.models.ldi_predictor import freeze_layer0_grad_mask
from lsi_tpu_torch.models.mpi import MPI, mpi_source_disparity, render_mpi
from lsi_tpu_torch.ops.gather import bilinear_sample
from lsi_tpu_torch.ops.splat import splat_bilinear
from lsi_tpu_torch.parallel import launch
from lsi_tpu_torch.parallel.mesh import ProcessPlan
from lsi_tpu_torch.parallel.spatial import shard_splat_args
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
# lsi_splat_vjp on a step's own cotangents gets, on top, float32's
# rounding bound for its sums: 2 gamma_n T per element (both sides round,
# each within gamma_n = n u / (1 - n u) of T, u = 2^-24, n = 4 (C + 2)
# products and sums; Higham's bound for a dot product), where T is the sum
# of the magnitudes of the terms that the element adds (splat_vjp_terms).
# The composite's cotangents are g_accum = g / wsum and g_wsum =
# -g . accum / wsum^2, so where wsum is small an element's terms
# v . g_accum[k] and g_wsum[k] cancel: its rounding follows T, which
# there exceeds the element and the tensor's largest entry.
FLOAT32_UNIT_ROUNDOFF = 2.0 ** -24
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
# The data-parallel step (phase 21) against one process, float32, TF32
# off, cuDNN deterministic (scripts/dp_gap_by_cause.py on an H100: free
# to choose its algorithms, cuDNN leaves the one-process step 0.989 in
# cosine and 15% of the largest entry from itself; deterministic, 2e-6).
# The ranks' network sees 8 images where one process's sees 16, and cuDNN
# rounds those otherwise: 4.6% of the largest entry, cosine 0.9985, norm
# 0.7% from the one-process step. So the step is held three ways:
# - its loss parts against the one-process step's at 3e-5 relative (sound
#   runs read up to 4.1e-6, a mean of per-rank ratios 1.96e-4);
# - its gradient against the one-process step's: cosine 0.99 and norm 5%
#   (sound 0.9985 and 0.7%; gradients averaged instead of summed read
#   -50%, a rank's own gradient without the all-reduce 0.94 and -34%);
# - its gradient against one process whose network runs on the ranks'
#   shares (launch.per_share_forward; the ranks' shapes, no reduction) at
#   2e-4 of the largest entry (sound: equal in every printed digit; a
#   mean of per-rank ratios about 4e-3).
# The three wrong reductions are read in the same run, and each must fail
# one of these bounds.
DP_LOSS_RTOL = 3e-5
DP_GRAD_COS = 0.99
DP_NORM_RTOL = 0.05
DP_SHARES_ATOL_OF_MAX = 2e-4
# The height-sharded render (phases 19-20): kitti_ldi2's LDI over 4 ranks,
# JAX's default window, a pose with a small vertical component; rgb held
# to the single-device windowed render as __graft_entry__.dryrun_multichip
# holds JAX's (1e-5).
SPATIAL_S = 4
SPATIAL_MAX_DY = 2
SPATIAL_T = [-0.3, 0.007, 0.0]
SPATIAL_RGB_ATOL = 1e-5
# Seconds a spawned group of ranks (and each collective) may take, and a
# torchrun call.
RANK_TIMEOUT_S = 300
TORCHRUN_TIMEOUT_S = 240
# The torchrun run (phase 22): the preset at its widths on multi-object
# scenes, the warm-up, eval, checkpoint and freeze boundaries moved into
# 3 steps (the freeze at the resume).
TORCHRUN_SETS = ["data.dataset=synthetic", "data.synthetic_scene=multi",
                 "loss.consistency_start_step=1", "train.eval_every=2",
                 "train.eval_batches=1", "train.freeze_layer0_step=2",
                 "train.checkpoint_every=2", "train.log_every=1"]

# Training from disk (phases 23-24): 64 materialized scenes (one shard);
# KITTI raw at 375x1242, two drives (the train split and the held-out
# one) of 24 frames; SYNTHIA-SEQS at 760x1280, 16 frames; layouts and
# shards written by 8 worker processes. A KITTI eval batch has no
# target-view ground truth, so only the render launches K1. The SYNTHIA
# preset renders by the splat alone.
SHARD_COUNT = 64
SHARD_WORKERS = 8
KITTI_DRIVES, KITTI_FRAMES = 2, 24
SYNTHIA_FRAMES = 16
KITTI_EVAL_LAUNCHES = {"splat_fwd": 1, "splat_vjp": 0, "gather_fwd": 0,
                       "gather_bwd_coords": 0}
SPLAT_STEP = {"splat_fwd": 1, "splat_vjp": 1, "gather_fwd": 0,
              "gather_bwd_coords": 0}
# The trajectory sweep (phase 25): 60 views in chunks of 8 poses, one K1
# launch each; a chunk against single renders as K1 against plain.
TRAJECTORY_CHUNKS = 8
TRAJECTORY_ATOL = 1e-5

# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def run(cmd, cwd=None) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True,
                          cwd=cwd).stdout.strip()


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


def kernel_device_us(fn, kernel: str, iters: int = 20) -> float:
    """Mean device time in us, per call of ``fn``, of the CUDA kernels whose
    name holds ``kernel`` (torch.profiler, after warm-up): the kernel
    alone, where a small kernel's calls are bound by the host's work
    around each launch and CUDA events would time that."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and kernel in e.name]
    if len(us) != iters:
        fail(f"the profiler saw {len(us)} {kernel} launches in {iters} calls")
    return sum(us) / iters


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
                rtol: float, atol: float, slack=None) -> float:
    """``got`` within ``atol + rtol |ref|`` (plus ``slack``, a tensor of
    ``ref``'s shape, where given) of ``ref`` everywhere."""
    err = (got - ref).abs()
    allowed = atol + rtol * ref.abs()
    if slack is not None:
        allowed = allowed + slack
    bad = err > allowed
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements off, max abs err "
             f"{err.max().item():.3e} (rtol {rtol}, atol {atol:.3e}"
             + ("" if slack is None else
                f", rounding slack up to {slack.max().item():.3e} and "
                f"{slack[bad].max().item():.3e} where off") + ")")
    return err.max().item()


def check_vjp(name: str, got, ref, slack=(None, None, None)) -> float:
    """Each gradient against the plain one: VJP_RTOL, VJP_ATOL_OF_MAX,
    plus ``slack`` (per gradient, a tensor or None)."""
    err = 0.0
    for i, (g, r, s) in enumerate(zip(got, ref, slack)):
        atol = VJP_ATOL_OF_MAX * r.abs().max().item()
        err = max(err, check_close(f"{name}[{i}]", g, r, VJP_RTOL, atol, s))
    return err


def splat_vjp_terms(values, coords, weights, g_accum, g_wsum, out_hw):
    """Per element of (d_values, d_coords, d_weights), the sum T of the
    magnitudes of the terms that lsi_splat_vjp adds into it: the plain VJP
    on |values|, |weights| and |cotangents| (whose bilinear fractions are
    >= 0) for d_values and d_weights; for d_coords the upper bound |w|
    sum_k Q_k (|d frac_k / dx| <= 1), where Q_k = |v| . |g_accum[k]| +
    |g_wsum[k]| at the in-image corner k, read as the plain VJP's d_weights
    at the integer coordinate of that corner."""
    v, w, ga, gw = (t.abs() for t in (values, weights, g_accum, g_wsum))
    t_values, _, t_weights = splat_cuda._plain_vjp(
        v, coords, w, ga, gw, out_hw, (True, False, True))
    base = torch.floor(coords)
    q = torch.zeros_like(weights)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        corner = base + base.new_tensor([dx, dy])
        q += splat_cuda._plain_vjp(v, corner, w, ga, gw, out_hw,
                                   (False, False, True))[2]
    return t_values, (w * q).expand_as(coords), t_weights


def splat_vjp_gamma(channels: int) -> float:
    """gamma_n for lsi_splat_vjp's sums over ``channels`` values."""
    n = 4 * (channels + 2)
    return n * FLOAT32_UNIT_ROUNDOFF / (1 - n * FLOAT32_UNIT_ROUNDOFF)


def splat_vjp_slack(values, coords, weights, g_accum, g_wsum, out_hw):
    """2 gamma_n T for (d_values, d_coords, d_weights): float32's
    rounding bound for the difference of two orders of the same sums."""
    gamma = splat_vjp_gamma(values.shape[-1])
    return tuple(2 * gamma * t for t in splat_vjp_terms(
        values, coords, weights, g_accum, g_wsum, out_hw))


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


class Recorded:
    """``fn`` (a kernel wrapper called through its module's global name)
    with its arguments passed to ``record`` first. The launch counters
    that ``fn`` keeps on itself under that global name read and write
    ``fn``'s own."""

    def __init__(self, fn, record):
        self.fn, self.record = fn, record

    def __call__(self, *args, **kwargs):
        self.record(*args, **kwargs)
        return self.fn(*args, **kwargs)

    def _counter(name):
        return property(lambda self: getattr(self.fn, name),
                        lambda self, v: setattr(self.fn, name, v))

    launches = _counter("launches")
    window_launches = _counter("window_launches")


@contextlib.contextmanager
def recording():
    """Record the arguments (cloned) of every unwindowed kernel launch made
    inside, as {"splat_fwd": [(values, coords, weights, out_hw, snap)],
    "gather_fwd": [(image, coords)], "splat_vjp": [(values, coords,
    weights, g_accum, g_wsum, out_hw)], "gather_bwd_coords": [(image,
    coords, g_sampled, g_valid)]}: the main path's own inputs. The
    launches themselves run and count as usual."""
    calls = {"splat_fwd": [], "gather_fwd": [], "splat_vjp": [],
             "gather_bwd_coords": []}
    launch_splat = splat_cuda._launch_splat
    launch_gather = gather_cuda._launch_gather_fwd
    vjp, bwd = splat_cuda.splat_vjp, gather_cuda.gather_bwd_coords

    def splat(values, coords, weights, out_hw, snap, tiling=None,
              window=(-1, 1, 0)):
        if window[0] < 0:
            calls["splat_fwd"].append((values.clone(), coords.clone(),
                                       weights.clone(), tuple(out_hw), snap))
        return launch_splat(values, coords, weights, out_hw, snap, tiling,
                            window)

    def gather(image, coords, tiling=None):
        calls["gather_fwd"].append((image.clone(), coords.clone()))
        return launch_gather(image, coords, tiling)

    def record_vjp(values, coords, weights, g_accum, g_wsum, out_hw,
                   needs=(True, True, True), max_dy=-1, **kw):
        if max_dy < 0:
            calls["splat_vjp"].append(tuple(t.clone() for t in (
                values, coords, weights, g_accum, g_wsum)) + (tuple(out_hw),))

    def record_bwd(*tensors):
        calls["gather_bwd_coords"].append(tuple(t.clone() for t in tensors))

    splat_cuda._launch_splat, gather_cuda._launch_gather_fwd = splat, gather
    splat_cuda.splat_vjp = Recorded(vjp, record_vjp)
    gather_cuda.gather_bwd_coords = Recorded(bwd, record_bwd)
    try:
        yield calls
    finally:
        splat_cuda._launch_splat = launch_splat
        gather_cuda._launch_gather_fwd = launch_gather
        splat_cuda.splat_vjp, gather_cuda.gather_bwd_coords = vjp, bwd


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
                    iters: int = 20, cot=None):
    """lsi_gather_bwd_coords against the plain coordinate VJP (autograd
    through bilinear_sample) on these inputs with the cotangents ``cot``
    (random where None; VJP tolerances), both timed in turns, and
    F.grid_sample's backward for the grid alone on the same inputs; logs
    and returns (times, bound, max abs err, grid_sample ms)."""
    c = image.shape[-1]
    if cot is None:
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
        f"{1e3 * bnd[0]:.1f} us ({bnd[1]}), "
        f"{100 * bnd[0] / t['kernel']:.0f}% of it; max abs err {err:.3e} "
        f"(rtol {VJP_RTOL}, atol {VJP_ATOL_OF_MAX}*max|ref|)")
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
    batch is taken from the Trainer's data iterator (the prefetch thread
    makes it; the seconds are what the step waited for it), ("run",
    phase, launches, seconds) after each step,
    ("eval", step, launches, seconds) after each eval, ("save", seconds)
    after each checkpoint, ("splice", state dict) after the splice from
    the best export. Seconds are the host's, synchronised."""
    events = []
    cls = trainer_mod.Trainer
    phase, run_step, run_eval, splice = (cls.phase, cls.run_step,
                                         cls.run_eval,
                                         cls.splice_best_layer0)
    stream, save = trainer_mod.make_dataset, trainer_mod.CheckpointManager.save
    in_eval = []

    def delta(before):
        return {k: v - before[k] for k, v in counts().items()}

    def traced_stream(*args, **kwargs):
        batches = stream(*args, **kwargs)
        try:
            while True:
                batch, s = host_seconds(lambda: next(batches))
                if not in_eval:
                    events.append(("data", s))
                yield batch
        finally:
            batches.close()

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
    trainer_mod.make_dataset = traced_stream
    trainer_mod.CheckpointManager.save = traced_save
    try:
        yield events
    finally:
        (cls.phase, cls.run_step, cls.run_eval,
         cls.splice_best_layer0) = phase, run_step, run_eval, splice
        trainer_mod.make_dataset = stream
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


def traced_cli(tag: str, config: str, sets, phases, step_launches: dict,
               evals_at, eval_launches: dict, saves: int):
    """The training CLI on ``config`` with ``sets``, traced: each step's
    phase must be ``phases``' and its launches ``step_launches[phase]``,
    evals must come after the steps ``evals_at``, each launching
    ``eval_launches``, and ``saves`` checkpoints be written. Returns the
    final state, the events and the host seconds (card synchronised) by
    kind: "data" (the step's wait for its batch), "step", "eval", "save"."""
    with tracing_trainer() as events:
        state, _ = train_main([f"--config={config}", "--set", *sets])
    torch.cuda.synchronize()
    steps = [e[1] for e in events if e[0] == "step"]
    runs = [e for e in events if e[0] == "run"]
    evals = [e for e in events if e[0] == "eval"]
    if steps != list(range(len(phases))) or [r[1] for r in runs] != phases:
        fail(f"{tag}: steps {steps}, phases {[r[1] for r in runs]}")
    for i, (_, name, launched, _) in enumerate(runs):
        if launched != step_launches[name]:
            fail(f"{tag}: step {i + 1} ({name}) launched {launched}, "
                 f"expected {step_launches[name]}")
    if [e[1] for e in evals] != list(evals_at) or any(
            e[2] != eval_launches for e in evals):
        fail(f"{tag}: evals {[(e[1], e[2]) for e in evals]}")
    host = {"data": [e[1] for e in events if e[0] == "data"],
            "step": [r[3] for r in runs], "eval": [e[3] for e in evals],
            "save": [e[1] for e in events if e[0] == "save"]}
    if [len(v) for v in host.values()] != [len(phases), len(phases),
                                           len(evals_at), saves]:
        fail(f"{tag}: host timings {host}")
    return state, events, host


def secs(v) -> str:
    return "[" + ", ".join(f"{x:.4f}" for x in v) + "]"


def quality_run(dev, workdir: Path):
    """Phase 13: the training CLI on the quality preset, its resume and
    the eval CLI; returns the summary for the log line, the host seconds
    of the first run (``traced_cli``) and its jsonl's steps_per_sec."""
    ckpt = workdir / "quality_run"
    sets = QUALITY_SETS + [f"train.checkpoint_dir={ckpt}"]
    cfg = build_config("kitti_ldi3_quality", sets)
    torch.cuda.reset_peak_memory_stats()
    want_phases = ["warmup"] * 2 + ["full"] * 4 + ["freeze"] * 2
    state, events, host = traced_cli(
        "quality", "kitti_ldi3_quality", sets, want_phases, STEP_LAUNCHES,
        (3, 6, 8), EVAL_LAUNCHES, 2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    runs = [e for e in events if e[0] == "run"]
    evals = [e for e in events if e[0] == "eval"]
    splices = [i for i, e in enumerate(events) if e[0] == "splice"]
    if len(splices) != 1 or events[splices[0] + 1] != ("step", 6):
        fail(f"quality: splice events at {splices}, expected one just "
             "before step index 6")
    spliced = events[splices[0]][1]
    check_layer0_kept(cfg.model, state.net, spliced, "step 8")

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
    return (f"8 steps (phases {want_phases}), launches per step "
            f"{ {r[1]: r[2] for r in runs} }, per eval batch "
            f"{evals[0][2]}; eval_abs_rel {abs_rel}; best export step "
            f"{meta['step']}; spliced once before step index 6, layer 0 "
            f"bitwise kept to step 10; resumed at step 8; peak memory "
            f"{peak:.2f} GiB; eval CLI on the checkpoint: abs_rel "
            f"{results['abs_rel']:.4f}, psnr {results['psnr']:.3f}, "
            f"occ_abs_rel {results['occ_abs_rel']:.4f}; host seconds (card "
            f"synchronised) of steps 1-8: the step's wait for its batch "
            f"(online scenes, made by the prefetch thread) "
            f"{secs(host['data'])}, step {secs(host['step'])}, evals at "
            f"3/6/8 {secs(host['eval'])}, checkpoint saves at 4/8 "
            f"{secs(host['save'])}; the jsonl's steps_per_sec {secs(rates)} "
            "(each window holds the step's wait for its batch, the step, "
            "and the eval and save that follow the step before)",
            host, rates)


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


def time_vjp(label: str, smi: str, values, coords, weights, g_accum, g_wsum,
             out_hw, iters: int = 10):
    """lsi_splat_vjp against autograd through the plain splat on these
    inputs and cotangents (VJP tolerances), both timed in turns; logs and
    returns (times, bound, max abs err)."""
    fns = {
        "plain": lambda: splat_cuda._plain_vjp(values, coords, weights,
                                               g_accum, g_wsum, out_hw,
                                               (True, True, True)),
        "kernel": lambda: splat_cuda.splat_vjp(values, coords, weights,
                                               g_accum, g_wsum, out_hw)}
    ref = fns["plain"]()
    got = fns["kernel"]()
    slack = splat_vjp_slack(values, coords, weights, g_accum, g_wsum,
                            out_hw)
    err = check_vjp(f"lsi_splat_vjp {label}", got, ref, slack)
    scale = ", ".join(f"{r.abs().max().item():.3e}" for r in ref)
    # How much of the rounding slack the run used: the elements beyond
    # VJP_RTOL and VJP_ATOL_OF_MAX alone, and their largest err / slack.
    beyond, used = 0, 0.0
    for g, r, sl in zip(got, ref, slack):
        e = (g - r).abs()
        out = e > VJP_ATOL_OF_MAX * r.abs().max() + VJP_RTOL * r.abs()
        beyond += int(out.sum())
        if out.any():
            used = max(used, (e[out] / sl[out]).max().item())
    del ref, got, slack
    t, readings = in_turns(fns, iters=iters)
    bnd = vjp_bound(values, coords, weights, out_hw)
    log("timing", f"{smi} | lsi_splat_vjp {label} {tuple(values.shape)} -> "
        f"{tuple(out_hw)}: {1e3 * t['kernel']:.1f} us/call "
        f"{readings['kernel']}, plain (autograd through splat_bilinear) "
        f"{1e3 * t['plain']:.1f} us/call; bound {1e3 * bnd[0]:.1f} us "
        f"({bnd[1]}); {100 * bnd[0] / t['kernel']:.0f}% of the bound; max "
        f"abs err {err:.3e} (rtol {VJP_RTOL}, atol {VJP_ATOL_OF_MAX}"
        f"*max|ref|, plus float32's rounding slack 2 gamma_n T; max|ref| of "
        f"d_values, d_coords, d_weights {scale}); {beyond} elements beyond "
        f"rtol and atol alone, using up to {used:.3f} of their slack")
    return t, bnd, err


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
    t, bnd, err = time_vjp("on the b8 quality step's own inputs", smi,
                           values, coords, weights, *cot, out_hw)
    out["splat_vjp"] = (t, bnd, err, None)
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
    if [len(v) for v in calls.values()] != [1, 1, 0, 0]:
        fail(f"one MPI step recorded {[len(v) for v in calls.values()]} "
             "launches")
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


# ---------------------------------------------------------------------
# Phases 19-22: the windowed kernels, the height-sharded render, the
# data-parallel step and the data-parallel CLI. The ranks are spawned
# processes sharing cuda:0 through gloo (NCCL refuses two ranks on one
# device): they show the windowed kernels, the halo exchange and the
# gradient reduction right on the card at full width, and measure no
# multi-GPU scaling.

def spatial_ldi(dev, b: int):
    """The kitti_ldi2 LDI (random weights from seed 0) of b random images
    (numpy seed 5) at 256x768, and a pose with a small vertical component
    (so halo strips carry splats across the shard boundaries)."""
    config = get_config("kitti_ldi2")
    h, w = config.data.height, config.data.width
    model = LSIModel.init(0, config, h, w, device=dev)
    rng = np.random.default_rng(5)
    image = torch.from_numpy(rng.uniform(size=(b, h, w, 3))
                             .astype(np.float32)).to(dev)
    with torch.no_grad():
        ldi = model.predict_ldi(image)
    ldi = LDI(textures=ldi.textures.float().contiguous(),
              disparities=ldi.disparities.float().contiguous(),
              intrinsics=ldi.intrinsics.float().contiguous())
    pose = translation_pose([SPATIAL_T] * b).to(dev)
    return ldi, pose, config.render.zbuffer_scale


def global_shift(ldi, pose, zscale):
    """The per-image soft z-buffer shift of the whole LDI (what the space
    group's max gives each shard)."""
    seen = []
    ldi_splat_inputs(ldi, pose, None, zscale,
                     global_max=lambda t: (seen.append(t), t)[1])
    return seen[0]


def window_phase(dev, smi: str, ldi, pose, zscale):
    """Phase 19: K1 and lsi_splat_vjp windowed, on one shard's own inputs
    (shard 1 of 4, as render_forward_spatial builds them), against the
    plain windowed splat and its autograd VJP, timed in turns."""
    hd = ldi.height // SPATIAL_S
    k = 1
    shard = LDI(textures=ldi.textures[:, :, k * hd:(k + 1) * hd],
                disparities=ldi.disparities[:, :, k * hd:(k + 1) * hd],
                intrinsics=ldi.intrinsics)
    shift = global_shift(ldi, pose, zscale)
    with torch.no_grad():
        values, coords, weights, out_hw, window = shard_splat_args(
            shard, pose, None, zscale, k * hd, SPATIAL_MAX_DY,
            lambda t: shift)
    max_dy, fold_h, base_offset = window
    base = splat_cuda.window_base_rows(values.shape[1], out_hw[0], *window)
    kw = dict(max_dy=max_dy, fold_h=fold_h, base_offset=base_offset)

    def plain():
        return splat_bilinear(values, coords, weights, out_hw,
                              max_dy_window=max_dy, base_rows=base.to(dev))

    got = splat_cuda.splat(values, coords, weights, out_hw, **kw)
    ref = plain()
    fwd_err = max(check_close(f"K1 windowed {name}", g, r, SPLAT_RTOL,
                              SPLAT_ATOL_OF_MAX * r.abs().max().item())
                  for name, g, r in zip(("accum", "wsum"), got, ref))
    gen = torch.Generator(device=dev).manual_seed(11)
    cot = [torch.randn(t.shape, generator=gen, device=dev) for t in ref]
    needs = (True, True, True)
    vjp_err = check_vjp(
        "lsi_splat_vjp windowed",
        splat_cuda.splat_vjp(values, coords, weights, *cot, out_hw, **kw),
        splat_cuda._plain_vjp(values, coords, weights, *cot, out_hw, needs,
                              *window))
    dropped = 1.0 - ref[1].sum().item() / splat_bilinear(
        values, coords, weights, out_hw)[1].sum().item()
    del got, ref
    t_fwd, r_fwd = in_turns({
        "plain": plain,
        "kernel": lambda: splat_cuda.splat(values, coords, weights, out_hw,
                                           **kw)}, iters=20)
    t_vjp, r_vjp = in_turns({
        "plain": lambda: splat_cuda._plain_vjp(
            values, coords, weights, *cot, out_hw, needs, *window),
        "kernel": lambda: splat_cuda.splat_vjp(
            values, coords, weights, *cot, out_hw, **kw)}, iters=10)
    # The kernels alone: at a shard's size the wrapper's host work around
    # each launch (checks, two torch.zeros, ctypes) outlasts the kernel,
    # so CUDA events around back-to-back calls time the host.
    dev_fwd = kernel_device_us(lambda: splat_cuda.splat(
        values, coords, weights, out_hw, **kw), "splat_fwd_kernel")
    dev_vjp = kernel_device_us(lambda: splat_cuda.splat_vjp(
        values, coords, weights, *cot, out_hw, **kw), "splat_vjp_kernel")
    b_fwd = k1_bound(values, coords, weights, out_hw)
    b_vjp = vjp_bound(values, coords, weights, out_hw)
    label = (f"shard {k} of {SPATIAL_S} ({tuple(values.shape)} -> "
             f"{out_hw}, window {window})")
    log("timing", f"{smi} | K1 windowed on {label}: kernel {dev_fwd:.1f} us "
        f"(profiler), {1e3 * t_fwd['kernel']:.1f} us/call {r_fwd['kernel']}"
        f" (events, the wrapper's host work included), plain "
        f"{1e3 * t_fwd['plain']:.1f} us/call {r_fwd['plain']}; bound "
        f"{1e3 * b_fwd[0]:.1f} us ({b_fwd[1]}); max abs err {fwd_err:.3e}")
    log("timing", f"{smi} | lsi_splat_vjp windowed on {label}: kernel "
        f"{dev_vjp:.1f} us (profiler), {1e3 * t_vjp['kernel']:.1f} us/call "
        f"{r_vjp['kernel']} (events), plain "
        f"(autograd) {1e3 * t_vjp['plain']:.1f} us/call {r_vjp['plain']}; "
        f"bound {1e3 * b_vjp[0]:.1f} us ({b_vjp[1]}); max abs err "
        f"{vjp_err:.3e}")
    log("window", f"windowed K1 and lsi_splat_vjp on {label} match the "
        f"plain windowed splat (K1 max abs err {fwd_err:.3e}, rtol "
        f"{SPLAT_RTOL}, atol {SPLAT_ATOL_OF_MAX}*max|ref|; VJP {vjp_err:.3e},"
        f" rtol {VJP_RTOL}, atol {VJP_ATOL_OF_MAX}*max|ref|); the window "
        f"drops {dropped:.4%} of this shard's splat weight")
    # The kernels line's "ms" is CUDA-event time per call, as every other
    # entry's; "device_ms" beside it is the kernel alone.
    return {
        "splat_fwd_window": dict(t=t_fwd, bound=b_fwd, err=fwd_err,
                                 device_ms=dev_fwd / 1e3,
                                 replaces="lsi_tpu/kernels/splat_pallas.py:141"),
        "splat_vjp_window": dict(t=t_vjp, bound=b_vjp, err=vjp_err,
                                 device_ms=dev_vjp / 1e3,
                                 replaces="lsi_tpu/kernels/splat_pallas.py:335")}


def spatial_phase(dev, workdir: Path) -> dict:
    """Phase 20: render_forward_spatial of kitti_ldi2's LDI at 256x768 over
    4 gloo ranks on cuda:0, at b1 and b8, against the single-device
    windowed render (rgb, disparity, coverage) and its LDI gradient;
    returns the windowed kernels' launches on this main path."""
    launches = {"splat_fwd_window": 0, "splat_vjp_window": 0}
    for b in (1, 8):
        ldi, pose, zscale = spatial_ldi(dev, b)
        rng = np.random.default_rng(6)
        target = rng.uniform(size=(b,) + tuple(ldi.textures.shape[2:4])
                             + (3,)).astype(np.float32)
        arrays = {k: getattr(ldi, k).cpu().numpy()
                  for k in ("textures", "disparities", "intrinsics")}
        t0 = time.perf_counter()
        ranks = launch.spawn(launch.spatial_render, SPATIAL_S, arrays,
                             pose.cpu().numpy(), zscale, SPATIAL_MAX_DY,
                             target, init_file=workdir / f"store_b{b}",
                             device=str(dev), backend="gloo",
                             space=SPATIAL_S, timeout_s=RANK_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        disp = ldi.disparities.clone().requires_grad_()
        ref = render_forward(
            LDI(ldi.textures, disp, ldi.intrinsics), pose,
            zbuffer_scale=zscale, pallas_max_dy=SPATIAL_MAX_DY)
        loss = ((ref["rgb"] - torch.from_numpy(target).to(dev)) ** 2).mean()
        loss.backward()
        exact = render_forward(ldi, pose, zbuffer_scale=zscale)
        dropped = 1.0 - (ref["coverage"].sum() / exact["coverage"].sum()
                         ).item()
        hd = ldi.height // SPATIAL_S
        errs = {}
        for key in ("rgb", "disparity", "coverage"):
            got = torch.cat([torch.from_numpy(r[key]) for r in ranks], 1)
            want = ref[key].detach().cpu()
            if key == "rgb":
                errs[key] = check_close("spatial rgb", got, want, 0.0,
                                        SPATIAL_RGB_ATOL)
            else:
                errs[key] = check_close(
                    f"spatial {key}", got, want, SPLAT_RTOL,
                    SPLAT_ATOL_OF_MAX * want.abs().max().item())
        grad = torch.cat([torch.from_numpy(r["grad_disparities"])
                          for r in ranks], 2)
        want = disp.grad.cpu()
        errs["grad"] = check_close("spatial LDI gradient", grad, want,
                                   VJP_RTOL, VJP_ATOL_OF_MAX
                                   * want.abs().max().item())
        losses = [r["loss"] for r in ranks]
        if max(abs(v - loss.item()) for v in losses) > 1e-5 * loss.item():
            fail(f"spatial loss {losses} vs {loss.item()}")
        per_rank = [r["launches"] for r in ranks]
        for r in per_rank:
            if r["splat_fwd_window"] != 1 or r["splat_vjp_window"] != 1:
                fail(f"spatial b{b}: launches per rank {per_rank}, expected "
                     "one windowed K1 and one windowed lsi_splat_vjp")
            for name in launches:
                launches[name] += r[name]
        log("spatial", f"kitti_ldi2 b{b} at {tuple(ldi.textures.shape)}, "
            f"{SPATIAL_S} gloo ranks on {dev} (shards of {hd} rows, "
            f"pallas_max_dy {SPATIAL_MAX_DY}, pose t={SPATIAL_T}): vs the "
            "single-device windowed render max abs err "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (rgb atol {SPATIAL_RGB_ATOL}; LDI gradient rtol {VJP_RTOL},"
            f" atol {VJP_ATOL_OF_MAX}*max|ref|); the window drops "
            f"{dropped:.4%} of the unwindowed render's splat weight; "
            f"launches per rank {per_rank[0]}; {seconds:.1f} s for the "
            "spawn, render and backward")
        del ldi, disp, ref, exact
    return launches


def dp_phase(dev, smi: str, workdir: Path) -> dict:
    """Phase 21: two data-parallel steps of kitti_ldi3_quality at its
    widths (256x768, global b8 on multi-object scenes) on 2 gloo ranks on
    cuda:0, against the one-process step on the same global batches,
    float32 with TF32 off and cuDNN deterministic, beside three wrong
    reductions read the same way; then in bf16. Returns the bf16 run's
    launches (summed over the ranks)."""
    sets = ["data.dataset=synthetic", "data.synthetic_scene=multi",
            "loss.consistency_start_step=0"]
    cfg = build_config("kitti_ldi3_quality", sets)
    stream = batch_stream(cfg.data, seed=0, device="cpu")
    t0 = time.perf_counter()
    batches = [{f.name: getattr(b, f.name).numpy() for f in
                dataclasses.fields(Batch) if getattr(b, f.name) is not None}
               for b in (next(stream), next(stream))]
    data_s = time.perf_counter() - t0
    state = create_state(cfg, seed=0, device="cpu")
    params = {k: v.numpy().copy() for k, v in state.net.state_dict().items()}
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  compute_dtype=dtype))
        exact = dtype == "float32"
        t0 = time.perf_counter()
        # Step-1 gradients in float32 only, with TF32 off and cuDNN
        # deterministic.
        ranks = launch.spawn(launch.train_steps, 2, c, params, batches,
                             exact, not exact, exact,
                             init_file=workdir / f"store_{dtype}",
                             device=str(dev), backend="gloo",
                             timeout_s=RANK_TIMEOUT_S)
        out[dtype] = (ranks, time.perf_counter() - t0)
    ranks, seconds = out["float32"]
    c32 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="float32"))
    n = cfg.data.batch_size

    def one_process(sl=slice(None), shares=1):
        cudnn = torch.backends.cudnn
        old = (cudnn.deterministic, cudnn.benchmark)
        try:
            return with_tf32_off(lambda: launch.train_steps(
                ProcessPlan(device=dev), c32, params,
                [{k: v[sl] for k, v in b.items()} for b in batches],
                deterministic=True, net_shares=shares))
        finally:
            cudnn.deterministic, cudnn.benchmark = old

    one, again, shares = one_process(), one_process(), one_process(shares=2)
    halves = [one_process(slice(0, n // 2)), one_process(slice(n // 2, n))]

    def flat(grads):
        return np.concatenate([grads[k].ravel() for k in sorted(one["grads"])]
                              ).astype(np.float64)

    def reading(metrics, grads):
        """Loss parts' largest relative gap to the one-process step;
        cosine and norm ratio - 1 of the gradient to its; largest
        difference to the per-share step's over its largest entry."""
        g, w, s = flat(grads), flat(one["grads"]), flat(shares["grads"])
        return {
            "loss": max(abs(metrics[k] - v) / max(abs(v), 1e-12)
                        for k, v in one["metrics"][0].items()
                        if k != "grad_norm"),
            "cos": g @ w / (np.linalg.norm(g) * np.linalg.norm(w)),
            "norm": np.linalg.norm(g) / np.linalg.norm(w) - 1.0,
            "shares": np.abs(g - s).max() / np.abs(s).max()}

    def fails(r):
        return [name for name, bad in (
            ("loss", r["loss"] > DP_LOSS_RTOL),
            ("cosine", r["cos"] < DP_GRAD_COS),
            ("norm", abs(r["norm"]) > DP_NORM_RTOL),
            ("shares", r["shares"] > DP_SHARES_ATOL_OF_MAX)) if bad]

    def show(r):
        return (f"loss {r['loss']:.3e}, cosine {r['cos']:.6f}, norm "
                f"{r['norm']:+.3e}, vs shares {r['shares']:.3e}")

    sound = reading(ranks[0]["metrics"][0], ranks[0]["grads"])
    if fails(sound):
        fail(f"dp step 1 vs one process: {show(sound)} (bounds: loss "
             f"{DP_LOSS_RTOL}, cosine {DP_GRAD_COS}, norm {DP_NORM_RTOL}, "
             f"shares {DP_SHARES_ATOL_OF_MAX} of the largest)")
    faults = {
        "mean of per-rank ratios": reading(
            {k: (halves[0]["metrics"][0][k] + halves[1]["metrics"][0][k]) / 2
             for k in one["metrics"][0]},
            {k: (halves[0]["grads"][k] + halves[1]["grads"][k]) / 2
             for k in one["grads"]}),
        "gradients averaged": reading(
            ranks[0]["metrics"][0],
            {k: v / 2 for k, v in ranks[0]["grads"].items()}),
        "no gradient all-reduce": reading(ranks[0]["metrics"][0],
                                          ranks[0]["local_grads"])}
    for name, r in faults.items():
        if not fails(r):
            fail(f"dp: the wrong reduction '{name}' passes every bound "
                 f"({show(r)})")
    spread = reading(again["metrics"][0], again["grads"])
    later = max(abs(r["metrics"][1][k] - v) / max(abs(v), 1e-12)
                for r in ranks for k, v in one["metrics"][1].items()
                if k != "grad_norm")
    if later > DP_LOSS_RTOL:
        fail(f"dp step-2 loss parts {later:.3e} relative from the "
             f"one-process step's (bound {DP_LOSS_RTOL})")
    start = params
    got, want = ranks[0]["params"][-1], one["params"][-1]
    names = sorted(want)
    diff = np.concatenate([(got[k] - want[k]).ravel() for k in names])
    moved = np.concatenate([(want[k] - start[k]).ravel() for k in names])
    mine = np.concatenate([(got[k] - start[k]).ravel() for k in names])
    cos = moved @ mine / (np.linalg.norm(moved) * np.linalg.norm(mine))
    mean_share = np.abs(diff).mean() / np.abs(moved).mean()
    if cos < TRAIN_PARAM_COS or mean_share > TRAIN_PARAM_MEAN:
        fail(f"dp parameters after step 2: movement cosine {cos:.4f}, mean "
             f"difference {mean_share:.3f} of the mean movement")
    same = all(np.array_equal(ranks[0]["params"][-1][k],
                              ranks[1]["params"][-1][k]) for k in params)
    if not same:
        fail("dp: the ranks' parameters differ")
    log("dp", f"kitti_ldi3_quality (float32, TF32 off, cuDNN "
        f"deterministic) at 256x768, global b8 on 2 gloo ranks on {dev} vs "
        f"one process: step 1 {show(sound)} (bounds: loss {DP_LOSS_RTOL}, "
        f"cosine {DP_GRAD_COS}, norm {DP_NORM_RTOL}, vs the per-share step "
        f"{DP_SHARES_ATOL_OF_MAX} of its largest entry); step-2 loss parts "
        f"{later:.3e}; the one-process step against itself {show(spread)}; "
        "wrong reductions, each failing a bound: "
        + "; ".join(f"{name} {show(r)} (fails {', '.join(fails(r))})"
                    for name, r in faults.items())
        + f"; grad_norm {ranks[0]['metrics'][0]['grad_norm']:.6f} vs "
        f"{one['metrics'][0]['grad_norm']:.6f}; parameters after step 2: "
        f"movement cosine {cos:.6f} (bound {TRAIN_PARAM_COS}), mean "
        f"difference {mean_share:.4f} of the mean movement (bound "
        f"{TRAIN_PARAM_MEAN}); the ranks' parameters bitwise equal; "
        f"{seconds:.1f} s for the spawn and 2 steps; {data_s:.2f} s to "
        "make the 2 global batches")
    ranks, seconds = out["bfloat16"]
    for r in ranks:
        for m in r["metrics"]:
            if not all(np.isfinite(v) for v in m.values()):
                fail(f"dp bf16: non-finite metrics {m}")
        for i, l in enumerate(r["launches"]):
            want = dict(FULL_STEP, splat_fwd_window=0, splat_vjp_window=0)
            if l != want:
                fail(f"dp bf16 step {i + 1} launches {l}, expected {want}")
    total = {k: sum(l[k] for r in ranks for l in r["launches"])
             for k in KERNELS}
    log("dp", f"kitti_ldi3_quality (bf16) on 2 gloo ranks: metrics "
        + "; ".join(", ".join(f"{k} {v:.5f}" for k, v in sorted(m.items()))
                    for m in ranks[0]["metrics"])
        + f"; launches per rank per step {ranks[0]['launches'][0]}; "
        f"{seconds:.1f} s")
    return total


def torchrun_phase(dev, workdir: Path) -> str:
    """Phase 22: torchrun --standalone --nproc_per_node=2 -m
    lsi_tpu_torch.train --config=kitti_ldi3_quality --dist_backend gloo,
    on the card: 2 steps with an eval (the best export) and a checkpoint,
    then a resume to step 3 that splices layer 0 from the export at the
    freeze; only rank 0 writes and prints."""
    ckpt = workdir / "torchrun"
    sets = TORCHRUN_SETS + [f"train.checkpoint_dir={ckpt}"]
    outs = []
    for horizon in (2, 3):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node=2", "-m", "lsi_tpu_torch.train",
               "--config=kitti_ldi3_quality", "--device", str(dev),
               "--dist_backend", "gloo", "--set", *sets,
               f"train.max_steps={horizon}"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=TORCHRUN_TIMEOUT_S)
        if proc.returncode != 0:
            fail(f"torchrun to step {horizon}: rc {proc.returncode}\n"
                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        outs.append((proc.stdout, time.perf_counter() - t0))
    first, second = outs[0][0], outs[1][0]
    if (first.count("config: ") != 1 or first.count("backend gloo") != 1
            or "done at step 2" not in first or "done at step 3" not in second
            or second.count("[freeze] layer-0 spliced") != 1):
        fail(f"torchrun output:\n{first[-2000:]}\n{second[-2000:]}")
    files = sorted(p.name for p in ckpt.iterdir())
    want = ["best_params.npz", "checkpoint_00000002.pt",
            "checkpoint_00000003.pt", "eval_images", "train.jsonl"]
    if files != want:
        fail(f"torchrun wrote {files}, expected {want}")
    with open(ckpt / "train.jsonl") as f:
        lines = [json.loads(line) for line in f]
    steps = [(r["step"], "eval_psnr" in r) for r in lines]
    if steps != [(1, False), (2, False), (2, True), (3, False), (3, True)]:
        fail(f"torchrun jsonl lines {steps}: not one line per step and eval")
    return (f"2 steps ({outs[0][1]:.1f} s) and a resume to 3 ({outs[1][1]:.1f}"
            f" s, the splice at the freeze broadcast from rank 0); one config "
            f"print, one line per step and eval in train.jsonl ({len(lines)}),"
            f" files {files}; eval_abs_rel "
            + ", ".join(f"{r['eval_abs_rel']:.4f}" for r in lines
                        if "eval_abs_rel" in r))


# ---------------------------------------------------------------------
# Phases 23-25: training from disk (materialized shards; KITTI and SYNTHIA
# layouts through the native loader) and the trajectory sweep.

def same_batches(a: Batch, b: Batch) -> bool:
    return all(
        (x is None and y is None) or (x is not None and y is not None
                                      and x.dtype == y.dtype
                                      and torch.equal(x, y))
        for x, y in ((getattr(a, f.name), getattr(b, f.name))
                     for f in dataclasses.fields(Batch)))


def prefetch_matches_sync(cfg, dev, n: int) -> None:
    """``n`` batches through the prefetcher (pinned buffers, side stream)
    bitwise equal to the same batches made on this thread."""
    sync = batch_stream(cfg, seed=0, device=dev)
    pre = make_dataset(cfg, seed=0, device=dev)
    try:
        for i in range(n):
            got = next(pre)
            # Work on the consumer's stream between takes: a copy the
            # stream did not wait for, or memory handed out early, shows
            # as a difference.
            junk = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
            junk.fill_(i)
            if not same_batches(got, next(sync)):
                fail(f"prefetched batch {i} differs from the synchronous one")
            del got, junk
    finally:
        pre.close()


def shards_phase(dev, smi: str, workdir: Path, online_host: dict,
                 online_rates) -> str:
    """Phase 23: materialize 64 multi-object scenes at 256x768 with worker
    processes through the CLI, train the quality preset from them through
    the training CLI with data.prefetch=2, and hold the prefetched batches
    bitwise to the synchronous stream."""
    shards = workdir / "shards"
    h, w = get_config("kitti_ldi3_quality").data.height, \
        get_config("kitti_ldi3_quality").data.width
    t0 = time.perf_counter()
    out = run([sys.executable, "-m", "lsi_tpu_torch.data.materialize",
               "--out", str(shards), "--scene", "multi", "--height", str(h),
               "--width", str(w), "--count", str(SHARD_COUNT), "--workers",
               str(SHARD_WORKERS)], cwd=REPO)
    t_mat = time.perf_counter() - t0
    ckpt = workdir / "shards_run"
    sets = QUALITY_SETS + [f"data.root={shards}", "data.prefetch=2",
                           f"train.checkpoint_dir={ckpt}"]
    want_phases = ["warmup"] * 2 + ["full"] * 4 + ["freeze"] * 2
    t0 = time.perf_counter()
    _, _, host = traced_cli("shards", "kitti_ldi3_quality", sets,
                            want_phases, STEP_LAUNCHES, (3, 6, 8),
                            EVAL_LAUNCHES, 2)
    wall = time.perf_counter() - t0
    with open(ckpt / "train.jsonl") as f:
        rates = [r["steps_per_sec"] for r in map(json.loads, f)
                 if "total" in r]
    cfg = build_config("kitti_ldi3_quality", sets)
    prefetch_matches_sync(cfg.data, dev, 6)
    return (f"{smi} | materialize CLI: {SHARD_COUNT} multi-object scenes at "
            f"{h}x{w}, {SHARD_WORKERS} workers, {t_mat:.2f} s ({out}); "
            f"kitti_ldi3_quality from the shards (data.prefetch=2), 8 steps "
            f"in {wall:.2f} s: the step's wait for its batch "
            f"{secs(host['data'])} s, step {secs(host['step'])} s, the "
            f"jsonl's steps_per_sec {secs(rates)}; phase 13 online: wait "
            f"{secs(online_host['data'])} s, step "
            f"{secs(online_host['step'])} s, steps_per_sec "
            f"{secs(online_rates)}; 6 prefetched batches bitwise equal to the "
            "synchronous stream's")


def decoders() -> str:
    """Which image decoders the readers used, and what was available."""
    from lsi_tpu_torch import native
    from lsi_tpu_torch.data import kitti, synthia
    try:
        import PIL
        pil = f"PIL {PIL.__version__}"
    except ImportError:
        pil = "no PIL"
    built = "built" if native.available() else \
        f"not built ({native.build_error()[:300]})"
    return (f"KITTI reader {dict(kitti.DECODED)}, SYNTHIA reader "
            f"{dict(synthia.DECODED)}; native loader {built}; {pil}")


def first_calls(calls: dict) -> dict:
    """The first recorded launch of each kernel (what is held to the
    plain version), the rest dropped to free their copies."""
    return {k: v[:1] for k, v in calls.items()}


def hold_recorded(label: str, smi: str, calls: dict) -> dict:
    """Each kernel recorded in ``calls`` (``recording()``), on its first
    launch's own inputs and cotangents, held to its plain version and
    timed beside it; returns {kernel: max abs err}."""
    errs = {}
    if calls["splat_fwd"]:
        errs["splat_fwd"] = time_k1(label, smi, *calls["splat_fwd"][0])[2]
    if calls["splat_vjp"]:
        errs["splat_vjp"] = time_vjp(label, smi, *calls["splat_vjp"][0])[2]
    if calls["gather_fwd"]:
        errs["gather_fwd"] = time_gather_fwd(label, smi,
                                             *calls["gather_fwd"][0])[2]
    if calls["gather_bwd_coords"]:
        image, coords, *cot = calls["gather_bwd_coords"][0]
        errs["gather_bwd_coords"] = time_gather_bwd(
            label + " and cotangents", smi, image, coords, None, cot=cot)[2]
    return errs


def datasets_phase(dev, smi: str, workdir: Path):
    """Phase 24: kitti_ldi3_quality and synthia_ldi2_splat through the
    training CLI from generated KITTI raw and SYNTHIA-SEQS layouts at the
    datasets' own image sizes, with the presets' own datasets; then every
    kernel on the temporal KITTI step's and the SYNTHIA step's own inputs
    against its plain version. Returns the launches of the main path and
    {kernel: max abs err}."""
    from lsi_tpu_torch.data import kitti, layouts, synthia
    kitti.DECODED.clear()
    synthia.DECODED.clear()
    t0 = time.perf_counter()
    for kind, frames, extra in (
            ("kitti", KITTI_FRAMES, ["--drives", str(KITTI_DRIVES)]),
            ("synthia", SYNTHIA_FRAMES, [])):
        run([sys.executable, "-m", "lsi_tpu_torch.data.layouts", kind,
             "--out", str(workdir / kind), "--frames", str(frames),
             "--workers", str(SHARD_WORKERS)] + extra, cwd=REPO)
    t_write = time.perf_counter() - t0

    reset_counts()
    ckpt = workdir / "kitti_run"
    sets = [f"data.root={workdir / 'kitti'}", "train.max_steps=4",
            "train.eval_every=4", "train.eval_batches=1",
            "train.checkpoint_every=4", "train.log_every=1",
            f"train.checkpoint_dir={ckpt}"]
    state, _, host = traced_cli("kitti", "kitti_ldi3_quality", sets,
                                ["warmup"] * 4, STEP_LAUNCHES, (4,),
                                KITTI_EVAL_LAUNCHES, 1)
    with open(ckpt / "train.jsonl") as f:
        lines = [json.loads(line) for line in f]
    rates = [r["steps_per_sec"] for r in lines if "total" in r]
    abs_rel = [r["eval_abs_rel"] for r in lines if "eval_abs_rel" in r]
    if len(abs_rel) != 1 or not np.isfinite(abs_rel[0]) or not list(
            ckpt.glob("checkpoint_*")) or not (ckpt /
                                               "best_params.npz").exists():
        fail(f"kitti: eval_abs_rel {abs_rel}, files "
             f"{sorted(os.listdir(ckpt))}")
    kitti_summary = (f"steps_per_sec {secs(rates)}, the step's wait for its "
                     f"batch {secs(host['data'])} s, step "
                     f"{secs(host['step'])} s, eval_abs_rel against LiDAR "
                     f"{abs_rel[0]:.4f}")

    # One batch of temporal pairs (OXTS poses) through the quality step.
    cfg = build_config("kitti_ldi3_quality", sets + [
        "data.kitti_pairs=temporal"])
    it = make_dataset(cfg.data, seed=0, device=dev)
    try:
        batch = next(it)
    finally:
        it.close()
    moved = batch.pose_src2trg[:, :3, 3].norm(dim=-1)
    # The loss parts and the gradient must be finite, and the gradient
    # not zero.
    with recording() as calls:
        _, metrics = make_train_step(cfg)(state, batch)
    temporal_calls = first_calls(calls)
    del calls, batch
    temporal = {k: float(v) for k, v in metrics.items()}
    if not (all(np.isfinite(v) for v in temporal.values())
            and temporal["grad_norm"] > 0 and bool((moved > 0.5).all())):
        fail(f"kitti temporal: metrics {temporal}, translations {moved}")

    ckpt = workdir / "synthia_run"
    sets = [f"data.root={workdir / 'synthia'}", "train.max_steps=3",
            "train.log_every=1", f"train.checkpoint_dir={ckpt}"]
    s_state, _, s_host = traced_cli("synthia", "synthia_ldi2_splat", sets,
                                    ["full"] * 3, {"full": SPLAT_STEP}, (),
                                    {}, 1)
    with open(ckpt / "train.jsonl") as f:
        s_rates = [r["steps_per_sec"] for r in map(json.loads, f)
                   if "total" in r]
    # One more SYNTHIA step, its kernels' inputs recorded.
    cfg = build_config("synthia_ldi2_splat", sets)
    it = make_dataset(cfg.data, seed=1, device=dev)
    try:
        batch = next(it)
    finally:
        it.close()
    with recording() as calls:
        _, metrics = make_train_step(cfg)(s_state, batch)
    synthia_calls = first_calls(calls)
    del calls, batch, s_state, state
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        fail(f"synthia: metrics {metrics}")
    launched = counts()
    recorded = [[len(c[k]) for k in KERNELS]
                for c in (temporal_calls, synthia_calls)]
    if recorded != [[1, 1, 1, 1], [1, 1, 0, 0]]:
        fail(f"datasets: the temporal and SYNTHIA steps recorded {recorded} "
             f"launches of {list(KERNELS)}")
    log("datasets", f"{smi} | layouts written in {t_write:.2f} s (KITTI raw "
        f"{KITTI_DRIVES} drives x {KITTI_FRAMES} frames at "
        f"{layouts.KITTI_HW[0]}x{layouts.KITTI_HW[1]}, SYNTHIA-SEQS "
        f"{SYNTHIA_FRAMES} frames at {layouts.SYNTHIA_HW[0]}x"
        f"{layouts.SYNTHIA_HW[1]}, {SHARD_WORKERS} workers); "
        f"kitti_ldi3_quality from KITTI (its own dataset, 256x768 b8, 4 "
        f"warm-up steps, launches per step {STEP_LAUNCHES['warmup']} as "
        f"phase 13's warm-up, per eval batch {KITTI_EVAL_LAUNCHES}): "
        f"{kitti_summary}; one temporal batch through the quality step, "
        f"translations {[round(float(v), 3) for v in moved]} m, total "
        f"{temporal['total']:.5f}, grad_norm {temporal['grad_norm']:.5f}; "
        f"synthia_ldi2_splat from SYNTHIA (256x768 b8, 3 steps, launches "
        f"per step {SPLAT_STEP}): steps_per_sec {secs(s_rates)}, the step's "
        f"wait for its batch {secs(s_host['data'])} s, step "
        f"{secs(s_host['step'])} s; decoders: {decoders()}")
    errs = hold_recorded("on the temporal KITTI quality step's own inputs",
                         smi, temporal_calls)
    del temporal_calls
    for k, v in hold_recorded("on the b8 synthia_ldi2_splat step's own "
                              "inputs", smi, synthia_calls).items():
        errs[k] = max(errs[k], v)
    return launched, errs


def read_png_stdlib(path) -> np.ndarray:
    """Decode an 8-bit RGB PNG written by ``png.write_png`` (filter 0
    on every row) with zlib alone."""
    data = Path(path).read_bytes()
    pos, idat, hw = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hw = (int.from_bytes(body[4:8], "big"),
                  int.from_bytes(body[:4], "big"))
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        hw[0], 1 + 3 * hw[1])
    return rows[:, 1:].reshape(hw[0], hw[1], 3)


def trajectory_phase(dev, smi: str, workdir: Path) -> dict:
    """Phase 25: the eval CLI's --trajectory_gif on trajectory_sweep
    (kitti_ldi2 widths, fresh weights) where PIL exists, else its frames
    written as PNGs by the standard library; 8 K1 launches per 60-view
    sweep; one chunk against 8 single-pose renders; the sweep's time.
    Returns the launches of the sweep."""
    import importlib.util
    from lsi_tpu_torch.evaluation import video
    from lsi_tpu_torch.evaluation.trajectory import render_trajectory
    from lsi_tpu_torch.geometry.transforms import camera_trajectory
    from lsi_tpu_torch.models import build_model

    sets = [f"train.checkpoint_dir={workdir / 'no_checkpoint'}"]
    cfg = build_config("trajectory_sweep", sets)
    net = build_model(cfg.model)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net = net.to(dev)
    reset_counts()
    frames = runner.trajectory_frames(cfg, net, dev)
    sweep = counts()
    if sweep != {"splat_fwd": TRAJECTORY_CHUNKS, "splat_vjp": 0,
                 "gather_fwd": 0, "gather_bwd_coords": 0}:
        fail(f"trajectory: a 60-view sweep launched {sweep}")
    if tuple(frames.shape) != (60, 1, cfg.data.height, cfg.data.width, 3) \
            or not torch.isfinite(frames).all():
        fail(f"trajectory: frames {tuple(frames.shape)} or non-finite")
    want = (frames.clamp(0, 1) * 255).to(torch.uint8)[:, 0].cpu().numpy()
    if importlib.util.find_spec("PIL") is not None:
        from PIL import Image, ImageSequence
        gif = workdir / "sweep.gif"
        reset_counts()
        runner.main(["--config=trajectory_sweep", "--num_batches", "1",
                     "--trajectory_gif", str(gif), "--set", *sets])
        cli = counts()
        if cli["splat_fwd"] != TRAJECTORY_CHUNKS + EVAL_LAUNCHES["splat_fwd"]:
            fail(f"trajectory CLI launched {cli}")
        got = [np.asarray(f.convert("RGB"))
               for f in ImageSequence.Iterator(Image.open(gif))]
        written = f"the eval CLI wrote {gif.name}, {len(got)} frames"
    else:
        try:
            video.save_gif(frames, str(workdir / "sweep.gif"))
            fail("trajectory: save_gif ran without PIL")
        except RuntimeError as e:
            refused = str(e)
        paths = video.save_frames(frames, str(workdir / "frames"))
        got = [read_png_stdlib(p) for p in paths]
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            fail("trajectory: the PNG frames decode to other pixels")
        written = (f"no PIL: --trajectory_gif refuses ({refused}); "
                   f"{len(got)} PNG frames written by the standard library, "
                   "decoded pixels equal to the frames'")
    if len(got) != 60:
        fail(f"trajectory: {len(got)} frames written")

    # One chunk of 8 poses against 8 single-pose renders.
    it = make_dataset(cfg.data, seed=1, device=dev)
    try:
        batch = decode_batch(next(it))
    finally:
        it.close()
    with torch.no_grad():
        ldi = net(batch.src_image[:1], batch.intrinsics[:1])
        poses = camera_trajectory(8, (0.15, 0.0, 0.0),
                                  (0.0, 0.0, 0.01)).to(dev)
        chunk = render_trajectory(ldi, poses=poses)
        err = max((chunk[i] - render_forward(ldi, p[None])["rgb"]
                   ).abs().max().item() for i, p in enumerate(poses))
    if err > TRAJECTORY_ATOL:
        fail(f"trajectory: a chunk is {err:.3e} from single renders")
    sweep_ms = cuda_ms(lambda: render_trajectory(
        ldi, 60, (0.15, 0.0, 0.0), (0.0, 0.0, 0.01), cfg.render), iters=5)
    log("trajectory", f"{smi} | trajectory_sweep (L={cfg.model.num_layers}, "
        f"{cfg.data.height}x{cfg.data.width}, {cfg.model.compute_dtype}, "
        f"fresh weights): 60 views in {sweep['splat_fwd']} K1 launches; "
        f"{written}; one chunk of 8 poses vs 8 single-pose renders: max abs "
        f"err {err:.3e} (atol {TRAJECTORY_ATOL}); sweep {sweep_ms:.3f} ms "
        f"({6e4 / sweep_ms:.1f} frames/s, the extreme-pose window check "
        f"included)")
    return sweep


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
    if [len(v) for v in serve_calls.values()] != [1, 0, 0, 0]:
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
    if [len(v) for v in train_calls.values()] != [1, 1, 1, 1]:
        fail(f"one train step recorded {train_calls}")
    del state, batches, stream

    kernels = {}
    # K1 at the training splat's shape, then on the b16 step's own inputs.
    time_k1("at random +-40 px", smi, *s_in, OUT_HW)
    _, _, err = time_k1("on the b16 kitti_ldi3_b16 step's own inputs", smi,
                        *train_calls["splat_fwd"][0])
    max_err = max(max_err, err)
    # lsi_splat_vjp at random +-40 px, then on the b16 step's own inputs
    # and cotangents.
    t, bnd, err = time_vjp("at random +-40 px", smi, *s_in, *s_cot, OUT_HW)
    kernels["splat_vjp"] = dict(
        replaces="lsi_tpu/kernels/splat_pallas.py:335", t=t, bound=bnd,
        err=max(vjp_err, err), library=None)
    del s_in, s_cot
    _, _, err = time_vjp("on the b16 kitti_ldi3_b16 step's own inputs", smi,
                         *train_calls["splat_vjp"][0])
    kernels["splat_vjp"]["err"] = max(kernels["splat_vjp"]["err"], err)

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
    t, bnd, err, lib_bwd = time_gather_bwd(
        "at random +-40 px", smi, image, gcoords,
        torch.Generator(device=dev).manual_seed(8))
    kernels["gather_bwd_coords"] = dict(
        replaces="lsi_tpu/kernels/gather_pallas.py:104", t=t, bound=bnd,
        err=max(bwd_err, err), library=lib_bwd)
    own = train_calls["gather_bwd_coords"][0]
    _, _, err, _ = time_gather_bwd(
        "on the b16 kitti_ldi3_b16 step's own inputs and cotangents", smi,
        own[0], own[1], None, cot=own[2:])
    kernels["gather_bwd_coords"]["err"] = max(
        kernels["gather_bwd_coords"]["err"], err)
    del train_calls, own

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
        summary, online_host, online_rates = quality_run(dev, workdir)
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

    # 19-22: the windowed kernels on a shard's own inputs, the spatial
    # render over 4 ranks, the data-parallel step over 2, the torchrun CLI.
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_",
                                    dir=REPO / "_scratch"))
    try:
        ldi, pose, zscale = spatial_ldi(dev, 8)
        kernels.update(window_phase(dev, smi, ldi, pose, zscale))
        del ldi, pose
        torch.cuda.empty_cache()
        window_counts = spatial_phase(dev, workdir)
        torch.cuda.empty_cache()
        dp_counts = dp_phase(dev, smi, workdir)
        torch.cuda.empty_cache()
        log("torchrun", "kitti_ldi3_quality through torchrun "
            "--nproc_per_node=2 --dist_backend gloo at 256x768 b8: "
            + torchrun_phase(dev, workdir))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # 23-25: training from shards and from dataset layouts, the sweep.
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_",
                                    dir=REPO / "_scratch"))
    try:
        torch.cuda.empty_cache()
        reset_counts()
        log("shards", shards_phase(dev, smi, workdir, online_host,
                                   online_rates))
        shard_counts = counts()
        dataset_counts, errs = datasets_phase(dev, smi, workdir)
        max_err = max(max_err, errs["splat_fwd"])
        for name in ("splat_vjp", "gather_fwd", "gather_bwd_coords"):
            kernels[name]["err"] = max(kernels[name]["err"], errs[name])
        trajectory_counts = trajectory_phase(dev, smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name, c in (("shards", shard_counts), ("datasets", dataset_counts)):
        missing = [k for k in KERNELS if c[k] == 0]
        if missing:
            fail(f"{missing} not launched by the {name} phase")

    total = {name: serve_counts[name] + train_counts[name]
             + quality_counts[name] + mpi_counts[name] + option_counts[name]
             + dp_counts[name] + shard_counts[name] + dataset_counts[name]
             + trajectory_counts[name] for name in KERNELS}
    total.update(window_counts)
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
            "source": "lsi_tpu_torch/csrc/" + (
                "splat_fwd.cu" if name == "splat_fwd_window"
                else "splat_bwd.cu"),
            "replaces": k["replaces"], "launches": total[name],
            "max_abs_err": k["err"], "ms": k["t"]["kernel"],
            "plain_ms": k["t"]["plain"], "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1], "library_ms": k.get("library"),
            **({"device_ms": k["device_ms"]} if "device_ms" in k else {})})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
