#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path, its training step, its
training CLI (the quality recipe), the MPI baseline, the multi-process
paths (the height-sharded render, data-parallel training), training from
disk (materialized shards, KITTI and SYNTHIA layouts), the trajectory
sweep, the high-resolution preset, the LDI-vs-planes comparison, the
collapse rollback, the TPU kernels' windowed route, the deterministic
splat and the refuted training knobs once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). Phases, one line each (timing
phases may print several); any failure ends the run with a non-zero exit
and no result line:

1. device  — require CUDA; card name and power limit, torch/CUDA/nvcc.
2. build   — build every kernel library from lsi_tpu_torch/csrc, one nvcc
             per source, all started together: splat_fwd (K1: the box
             kernel lsi_splat_fwd, and the band kernel lsi_splat_band, its
             windowed mode), splat_sort (K1-D: lsi_splat_sort, its
             count, scan, fill, sum and long-run kernels) and splat_bwd
             (lsi_splat_vjp,
             lsi_gather_fwd, lsi_gather_bwd_coords).
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
             gradients); whether K1 keeps a float32 denormal weight (H12):
             the box kernel's two paths and the band kernel must flush it.
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
             step per batch; lsi_gather_fwd and K1 in its d_image role (no
             weights, no wsum) on
             the MPI step's own inputs, each beside its plain version, its
             bound and F.grid_sample (forward; backward for the input);
             the b16 step with the loss options in turns with the plain
             b16 step; the gather kernels on the candidate gathers' own
             inputs beside grid_sample (forward; backward for the grid).

19. window  — K1 and lsi_splat_vjp in their windowed mode (max_dy,
             fold_h, base_offset; K1 as splat launches it, and its box and
             band kernels side by side) on one shard's own inputs (shard
             1 of 4
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
26. highres-serve — highres_b64 (BASELINE.md config 4: L=2,
             base_filters=32, num_scales=5, bf16) at 512x1536, random
             weights from a seed: 4 requests of batch 64 through
             LSIModel.predict_ldi -> LSIModel.render, one K1 launch each
             at (64, 1024, 1536, 4) -> (512, 1536); predict, render and
             end-to-end ms and frames/s after warm-up; peak memory.
27. highres-train — the remat step of a toy highres_b64 (float32, TF32
             off) against JAX's jax.checkpoint step in
             tests/data/torch_golden_remat_toy.npz; the b64 step
             through make_train_step on a KITTI batch read at 512x1536
             from phase 24's layout, first without remat as a probe (an
             OutOfMemoryError is printed as its reading), then with remat
             (ms, steps/s, peak memory of each, with nothing else held);
             both first steps' metrics, from one state, within
             REMAT_RTOL of each other; 3 steps through the training CLI
             (--config=highres_b64, its own dataset) with an eval against
             the LiDAR ground truth and a checkpoint; K1 and
             lsi_splat_vjp on the b64 step's own inputs and cotangents
             against their plain versions per chunk of 8 images (phases 3
             and 7's tolerances, the VJP with phase 24's rounding slack),
             timed beside their bounds.
28. compare, rollback — python -m lsi_tpu_torch.evaluation.compare at the
             presets' widths (synthetic_sanity, mpi_baseline), 3 steps
             each, one table whose rows are the evaluations on the same 8
             held-out batches; then kitti_ldi3_quality at its widths from
             phase 23's shards with the collapse rollback on and a
             collapse forced at step 4: every parameter bitwise the best
             export's, a fresh optimizer, the checkpoint taken at once.
29. route  — the TPU kernels' route, render.use_pallas="on": (a)
             kitti_ldi3_quality through the training CLI with --set
             render.use_pallas=on from phase 23's shards (256x768 b8, its
             window of 8 rows): 6 steps and an eval, every launch
             windowed, window_dropped_frac and its warning; the route's
             full step and the "auto" step on one batch, in turns; (b)
             lsi_gather_fwd and lsi_gather_bwd_coords windowed (K4-W) on
             that step's own inputs, at random +-40 px with a window of 2,
             and with a window that drops nothing against the exact
             kernels; the windowed K1 and lsi_splat_vjp on the step's own
             (8, 768, 768, 4) -> (256, 768) inputs; each held to its plain
             version, timed by CUDA events and alone by torch.profiler;
             (c) the route at toy size against JAX's interpret-mode
             kernels in tests/data/torch_golden_pallas_toy.npz (the gather,
             two quality and two MPI steps); (d) kitti_ldi2 serving b8 on
             the route beside "auto" (an over-rotated pose warns), the
             trajectory sweep (window 16), mpi_baseline for 3 steps
             (homography gather at 2); the windowed K1 as splat launches
             it (splat_cuda.use_band's choice) and its box and band
             kernels side by side, held and timed on the route step's,
             the MPI step's (the planes' gradient), the serving render's
             and the sweep's own inputs.
30. sort, knobs — the deterministic splat K1-D (render.splat_method=
             "sort"): (a) on the b8 kitti_ldi2 render's, the
             kitti_ldi3_quality step's full LDI's and a height shard's
             own inputs (window 2), three launches bitwise equal, held to
             the plain sort splat and to K1, timed by CUDA events and
             alone by torch.profiler, kernel by kernel (a call runs
             splat_sort.cu's kernels and memsets, nothing else), beside
             K1's bound and a deterministic index_put_, with its longest
             run and the share of targets on the long-run path; (b) kitti_ldi2 b8 serving with "sort", two passes
             bitwise equal, every render one K1-D launch; (c) the first
             quality step's loss parts against "scatter"'s on one batch,
             and kitti_ldi3_quality through the training CLI from phase
             23's shards with "sort" (6 steps and an eval, no K1 launch),
             two renders of the trained LDI bitwise equal; (d) the refuted
             knobs at the preset's widths: the EMA teacher (the ramp's
             formula, bitwise), consistency_stop_step with
             photo_layer0_weight through the CLI (the step switches), and
             deep_heads_stopgrad_trunk (the trunk's gradient exactly 0
             under deep-layer terms).

The line before the last two is {"kernels": [...]}, then the card's name
and power limit as nvidia-smi prints them, and last
{"ok": true, "device": {...}}. Each kernel's ``launches`` counts the
main paths (phases 5, 10, 13, 16, 17, 21's bf16 steps, 23, 24, 25, 26,
27 (less the probe without remat) and 28, each counted from 0); the
windowed modes' count phase 20's ranks and phase 29's main paths (its CLI
run, serving, MPI steps and sweep), the highres entries phases 26 and
27's, ``splat_sort`` (K1-D) phase 30's serving and CLI run. Every
entry's ``ms`` and ``plain_ms`` are CUDA-event time per call (host work
in the wrapper included; the highres entries' plain versions
run chunk by chunk); the windowed entries (``splat_fwd_window``, the
box kernel's window, and ``splat_vjp_window`` timed on the route step's
own full-width inputs, ``splat_band``, the band kernel, on the route MPI
step's own, K4-W's two kernels on the route step's gather) also carry
``device_ms``, the kernel alone by torch.profiler (null where its trace
missed launches twice); ``splat_sort``'s is every kernel of the call
(count, scan, fill, sum, long runs, the memset), and its ``library_ms`` index_put_ (accumulate, under
torch.use_deterministic_algorithms).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
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
from lsi_tpu_torch.ops.splat import corner_contributions, splat_bilinear
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
GOLDEN_REMAT = REPO / "tests" / "data" / "torch_golden_remat_toy.npz"
GOLDEN_PALLAS = REPO / "tests" / "data" / "torch_golden_pallas_toy.npz"

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

# The high-resolution preset (phases 26-27): highres_b64 (BASELINE.md
# config 4) at 512x1536, b64, bf16, L=2. A render splats the LDI
# (64, 1024, 1536, 4) into (64, 512, 1536): one K1 launch; a training step
# (photo_mode="splat", remat) launches K1 and lsi_splat_vjp once each
# (SPLAT_STEP), a KITTI eval batch K1 once. The plain VJP of all 64 images
# does not fit beside its autograd graph, so both kernels are held to
# their plain versions per chunk of images: the splat is per image, so
# that is the same comparison.
HIGHRES_REQUESTS = 4
HIGHRES_CHUNK = 8
HIGHRES_CLI_STEPS = 3
# The b64 step with and without remat, from one state on one batch (cuDNN
# deterministic): every first-step metric, grad_norm included, within
# REMAT_RTOL of the other's, relative to the larger of its magnitude and
# REMAT_FLOOR. PR 8's runs read total and grad_norm equal to 5 digits
# (grad_norm 1.27236 against 1.27237, 1.47878 against 1.47878); a
# recompute in another precision moves them at bf16's 3.9e-3.
REMAT_RTOL, REMAT_FLOOR = 1e-4, 1e-6
# The comparison (phase 28): synthetic_sanity and mpi_baseline at their
# widths, a few steps each.
COMPARE_STEPS = 3
# The rollback (phase 28): kitti_ldi3_quality at its widths from phase
# 23's shards, no freeze, warm-up to step 2, evals after steps 2 and 4;
# the one after step 4 reads abs_rel 1 higher than it is.
ROLLBACK_SETS = ["data.dataset=synthetic", "train.max_steps=4",
                 "loss.consistency_start_step=2", "train.eval_every=2",
                 "train.eval_batches=1", "train.freeze_layer0_step=0",
                 "train.freeze_layer0_from_best=false",
                 "train.checkpoint_every=100", "train.log_every=1",
                 "train.collapse_rollback_threshold=0.05"]
ROLLBACK_COLLAPSE = (4, 1.0)

# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor cores.
# The TPU kernels' route (phase 29): kitti_ldi3_quality from phase 23's
# shards with render.use_pallas=on (its published window, pallas_max_dy
# 8): the warm-up to step 2, then full steps, an eval after step 6 and a
# checkpoint at the end; no freeze. Every launch of the path windowed.
ROUTE_ON = ["data.dataset=synthetic", "data.synthetic_scene=multi",
            "render.use_pallas=on"]
ROUTE_SETS = ROUTE_ON + [
    "train.max_steps=6", "loss.consistency_start_step=2",
    "train.eval_every=6", "train.eval_batches=1",
    "train.freeze_layer0_step=0", "train.freeze_layer0_from_best=false",
    "train.checkpoint_every=100", "train.log_every=1"]
ROUTE_PHASES = ["warmup"] * 2 + ["full"] * 4
# K4-W at random +-40 px across and +-ROUTE_RANDOM_DY rows at a window of
# ROUTE_RANDOM_MAX_DY, so that most corners are dropped.
ROUTE_RANDOM_DY, ROUTE_RANDOM_MAX_DY = 8, 2
# The route's golden on the card: loss parts 1e-4 relative (phase 12's),
# the window's share 1e-6; the gather cases at the CPU test's 2e-5 plus
# 2e-5 relative (the interpret-mode kernels' bf16x6 sums); step-1
# gradients of the MPI at phase 12's 5e-4 of the largest, of the quality
# recipe at the CPU test's 5e-3, set from scripts/route_golden_spread.py
# on the card (8 seeds of the toy step; H100, 700 W): a sound port reads
# 1.7e-4 to 4.3e-3 of the largest (8.3e-4 on this fixture, seed 0), JAX's
# own lax-equivalent route 1.9e-4 to 7.0e-3 from its interpret-mode
# kernels; a gather that breaks the window reads 5.0e-2 or more (exact
# d_coords, a window one row wider). Faults in the snap stay inside the
# sound spread; the per-kernel holds catch those.
ROUTE_LOSS_RTOL = 1e-4
ROUTE_DROP_ATOL = 1e-6
ROUTE_GATHER_TOL = (2e-5, 2e-5)
ROUTE_GRAD_OF_MAX = {"quality": 5e-3, "mpi": QUALITY_GRAD_ATOL_OF_MAX}
# The MPI baseline on the route (its homography gather at the preset's
# window, 2 rows): steps through make_train_step.
ROUTE_MPI_STEPS = 3
# An over-rotated serving pose: 0.15 rad about x moves rows by ~fy * 0.15,
# far beyond kitti_ldi2's 2-row window.
OVER_ROTATED = ([[0.15, 0.0, 0.0]], [[0.0, -0.5, 0.0]])

# The deterministic splat (phase 30), K1-D (render.splat_method="sort"):
# three launches on each input set bitwise equal; kitti_ldi2 serving,
# kitti_ldi3_quality from phase 23's shards (the warm-up to step 2, full
# steps, an eval after step 6) with every render on K1-D and none on K1.
# A step renders as phase 13's (6 warm-up, 10 full, 3 an eval), the VJP
# and the gathers are the same kernels.
SORT_SERVE_REQUESTS = 3
SORT_ON = ["data.dataset=synthetic", "data.synthetic_scene=multi",
           "render.splat_method=sort"]
SORT_SETS = SORT_ON + [
    "train.max_steps=6", "loss.consistency_start_step=2",
    "train.eval_every=6", "train.eval_batches=1",
    "train.freeze_layer0_step=0", "train.freeze_layer0_from_best=false",
    "train.checkpoint_every=100", "train.log_every=1"]
SORT_PHASES = ["warmup"] * 2 + ["full"] * 4
SORT_STEP = {"warmup": 6, "full": 10}
SORT_EVAL = 3
# The first step's loss parts, sort against scatter on one batch and one
# state (cuDNN deterministic): the same sums in another order; phase 12's
# relative tolerance of the loss parts.
SORT_LOSS_RTOL = 1e-4
# The four refuted knobs on kitti_ldi3_quality at its widths (phase 30
# (d)): the EMA teacher for 3 steps (its targets live from step 1), the
# stop step (2) with photo_layer0_weight through the training CLI for 4
# steps from phase 23's shards (one more gather a direction: the layer-0
# inverse warp), the deep heads under a loss of deep-layer terms alone.
KNOB_STEPS = 3
STOP_SETS = ["data.dataset=synthetic", "data.synthetic_scene=multi",
             "loss.consistency_start_step=0", "loss.consistency_stop_step=2",
             "loss.photo_layer0_weight=0.1", "train.max_steps=4",
             "train.eval_every=0", "train.freeze_layer0_step=0",
             "train.freeze_layer0_from_best=false",
             "train.checkpoint_every=100", "train.log_every=1"]
STOP_PHASES = ["full"] * 2 + ["stop"] * 2
STOP_LAUNCHES = {
    "full": {"splat_fwd": 10, "splat_vjp": 6, "gather_fwd": 4,
             "gather_bwd_coords": 4},
    "stop": {"splat_fwd": 6, "splat_vjp": 4, "gather_fwd": 4,
             "gather_bwd_coords": 4}}
DEEP_ONLY_SETS = ["data.dataset=synthetic", "data.synthetic_scene=multi",
                  "model.deep_heads_stopgrad_trunk=true",
                  "loss.photo_mode=inverse_warp",
                  "loss.inverse_warp_weight=0", "loss.smoothness_weight=0",
                  "loss.symmetric=false", "loss.consistency_anchor_weight=0",
                  "loss.consistency_weight=1"]
# The loss parts of the quality recipe's full step, as JAX names them.
QUALITY_PARTS = {"photo_inverse_warp", "photo_splat", "smoothness",
                 "window_dropped_frac", "depth_consistency", "depth_anchor",
                 "total", "grad_norm"} | {
    k + "_rev" for k in ("photo_inverse_warp", "photo_splat", "smoothness",
                         "window_dropped_frac")}

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


def kernel_device_us(fn, kernel: str, iters: int = 20,
                     required: bool = True):
    """Mean device time in us, per call of ``fn``, of the CUDA kernels whose
    name holds ``kernel`` (torch.profiler, after warm-up): the kernel
    alone, where a small kernel's calls are bound by the host's work
    around each launch and CUDA events would time that. A trace that
    misses launches is taken again once; then, unless ``required``, the
    reading is None (not measured)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    for _ in range(2):
        with torch.profiler.profile(activities=[cuda]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
        if len(us) == iters:
            return sum(us) / iters
    if required:
        fail(f"the profiler saw {len(us)} {kernel} launches in {iters} calls")
    return None


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


def corners_in_image(coords: torch.Tensor, h: int, w: int,
                     max_dy: int = -1, fold_h: int = 1,
                     base_offset: int = 0) -> int:
    """How many of the coordinates' 4 bilinear corners lie in an h x w
    image (the data-dependent part of the kernels' work) and, with
    ``max_dy >= 0``, in the window around their row's base row
    ``r % fold_h + base_offset``."""
    x0 = torch.floor(coords[..., 0])
    y0 = torch.floor(coords[..., 1])
    base = (torch.arange(coords.shape[1], device=coords.device) % fold_h
            + base_offset)[None, :, None].float()
    total = 0
    for dy in (0, 1):
        for dx in (0, 1):
            inside = ((x0 + dx >= 0) & (x0 + dx <= w - 1)
                      & (y0 + dy >= 0) & (y0 + dy <= h - 1))
            if max_dy >= 0:
                inside &= ((y0 + dy - base >= -max_dy)
                           & (y0 + dy - base <= max_dy + 1))
            total += int(inside.sum())
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


def splat_vjp_terms(values, coords, weights, g_accum, g_wsum, out_hw,
                    window=(-1, 1, 0)):
    """Per element of (d_values, d_coords, d_weights), the sum T of the
    magnitudes of the terms that lsi_splat_vjp adds into it: the plain VJP
    on |values|, |weights| and |cotangents| (whose bilinear fractions are
    >= 0) for d_values and d_weights; for d_coords the upper bound |w|
    sum_k Q_k (|d frac_k / dx| <= 1), where Q_k = |v| . |g_accum[k]| +
    |g_wsum[k]| at the in-image (and, with a ``window`` (max_dy, fold_h,
    base_offset), in-window) corner k, read as the plain VJP's d_weights
    at the integer coordinate of that corner."""
    v, w, ga, gw = (t.abs() for t in (values, weights, g_accum, g_wsum))
    t_values, _, t_weights = splat_cuda._plain_vjp(
        v, coords, w, ga, gw, out_hw, (True, False, True), *window)
    base = torch.floor(coords)
    q = torch.zeros_like(weights)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        corner = base + base.new_tensor([dx, dy])
        q += splat_cuda._plain_vjp(v, corner, w, ga, gw, out_hw,
                                   (False, False, True), *window)[2]
    return t_values, (w * q).expand_as(coords), t_weights


def splat_vjp_gamma(channels: int) -> float:
    """gamma_n for lsi_splat_vjp's sums over ``channels`` values."""
    n = 4 * (channels + 2)
    return n * FLOAT32_UNIT_ROUNDOFF / (1 - n * FLOAT32_UNIT_ROUNDOFF)


def splat_vjp_slack(values, coords, weights, g_accum, g_wsum, out_hw,
                    window=(-1, 1, 0)):
    """2 gamma_n T for (d_values, d_coords, d_weights): float32's
    rounding bound for the difference of two orders of the same sums."""
    gamma = splat_vjp_gamma(values.shape[-1])
    return tuple(2 * gamma * t for t in splat_vjp_terms(
        values, coords, weights, g_accum, g_wsum, out_hw, window))


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


def with_cudnn_deterministic(fn):
    cudnn = torch.backends.cudnn
    old = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        return fn()
    finally:
        cudnn.deterministic, cudnn.benchmark = old


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
def recording(windowed: bool = False):
    """Record the arguments (cloned) of every unwindowed kernel launch made
    inside, as {"splat_fwd": [(values, coords, weights, out_hw, snap)],
    "gather_fwd": [(image, coords)], "splat_vjp": [(values, coords,
    weights, g_accum, g_wsum, out_hw)], "gather_bwd_coords": [(image,
    coords, g_sampled, g_valid)]}: the main path's own inputs. With
    ``windowed``, of every windowed launch instead, each with its window
    appended (K1: (max_dy, fold_h, base_offset); lsi_splat_vjp: a dict of
    them; the gathers: (max_dy, fold_h)). The launches themselves run and
    count as usual."""
    calls = {"splat_fwd": [], "gather_fwd": [], "splat_vjp": [],
             "gather_bwd_coords": []}
    launch_splat = splat_cuda._launch_splat
    launch_gather = gather_cuda._launch_gather_fwd
    vjp, bwd = splat_cuda.splat_vjp, gather_cuda.gather_bwd_coords

    def splat(values, coords, weights, out_hw, snap, tiling=None,
              window=(-1, 1, 0)):
        if (window[0] >= 0) == windowed:
            calls["splat_fwd"].append(
                (values.clone(), coords.clone(),
                 None if weights is None else weights.clone(),
                 tuple(out_hw), snap) + ((window,) if windowed else ()))
        return launch_splat(values, coords, weights, out_hw, snap, tiling,
                            window)

    def gather(image, coords, tiling=None, window=(-1, 1)):
        if (window[0] >= 0) == windowed:
            calls["gather_fwd"].append((image.clone(), coords.clone())
                                       + ((window,) if windowed else ()))
        return launch_gather(image, coords, tiling, window)

    def record_vjp(values, coords, weights, g_accum, g_wsum, out_hw,
                   needs=(True, True, True), max_dy=-1, fold_h=None,
                   base_offset=0):
        if (max_dy >= 0) == windowed:
            calls["splat_vjp"].append(tuple(t.clone() for t in (
                values, coords, weights, g_accum, g_wsum)) + (tuple(out_hw),)
                + ((dict(max_dy=max_dy, fold_h=fold_h,
                         base_offset=base_offset),) if windowed else ()))

    def record_bwd(image, coords, g_sampled, g_valid, max_dy=-1,
                   fold_h=None):
        if (max_dy >= 0) == windowed:
            calls["gather_bwd_coords"].append(tuple(t.clone() for t in (
                image, coords, g_sampled, g_valid))
                + ((max_dy, fold_h) if windowed else ()))

    splat_cuda._launch_splat, gather_cuda._launch_gather_fwd = splat, gather
    splat_cuda.splat_vjp = Recorded(vjp, record_vjp)
    gather_cuda.gather_bwd_coords = Recorded(bwd, record_bwd)
    try:
        yield calls
    finally:
        splat_cuda._launch_splat = launch_splat
        gather_cuda._launch_gather_fwd = launch_gather
        splat_cuda.splat_vjp, gather_cuda.gather_bwd_coords = vjp, bwd


def k1_bound(values, coords, weights, out_hw, window=(-1, 1, 0)):
    """K1's bound: each input read and accum (and, with weights, wsum)
    written once, against 2 P float32 operations per in-image (and
    in-window) corner, P = C (+ 1 with weights). Without weights (the
    gather's image gradient) that is the function grid_sample's backward
    for its input computes: the cotangent and the coordinates read once,
    d_image written once."""
    n, _, _, c = values.shape
    planes = c + (weights is not None)
    return bound(nbytes(*(t for t in (values, coords, weights)
                          if t is not None))
                 + 4 * n * out_hw[0] * out_hw[1] * planes,
                 2 * planes * corners_in_image(coords, *out_hw, *window))


def check_k1(label: str, got, ref) -> float:
    """K1's outputs against the plain splat's (SPLAT_RTOL, and
    SPLAT_ATOL_OF_MAX of the largest entry); wsum None on both sides
    without weights."""
    if (got[1] is None) != (ref[1] is None):
        fail(f"K1 {label}: wsum {got[1] is None} vs plain {ref[1] is None}")
    return max(check_close(f"K1 {label} {name}", g, r, SPLAT_RTOL,
                           SPLAT_ATOL_OF_MAX * r.abs().max().item())
               for name, g, r in zip(("accum", "wsum"), got, ref)
               if r is not None)


def time_k1(label: str, smi: str, values, coords, weights, out_hw,
            snap: bool = True, iters: int = 20):
    """K1 against the plain splat on these inputs (check_k1), then both
    timed in turns; logs and returns (times, bound, max abs err)."""
    ref = splat_bilinear(values, coords, weights, out_hw, snap=snap)
    got = splat_cuda.splat(values, coords, weights, out_hw, snap=snap)
    err = check_k1(label, got, ref)
    del ref, got
    t, readings = in_turns({
        "plain": lambda: splat_bilinear(values, coords, weights, out_hw,
                                        snap=snap),
        "kernel": lambda: splat_cuda.splat(values, coords, weights, out_hw,
                                           snap=snap)}, iters=iters)
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


def gather_bwd_bound(image, coords, cot, window=(-1, 1)):
    """lsi_gather_bwd_coords' bound: image, coordinates and cotangents read
    and d_coords written once, against 20 float32 operations per sample
    and 2C+2 per in-image (and in-window) corner."""
    _, hi, wi, c = image.shape
    return bound(nbytes(image, coords, *cot) + nbytes(coords),
                 20 * coords[..., 0].numel()
                 + (2 * c + 2) * corners_in_image(coords, hi, wi, *window))


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
        k.window_launches = 0
    splat_cuda.splat.band_launches = 0
    splat_cuda.splat.sort_launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def window_counts() -> dict:
    """The windowed launches since the last reset, as the kernels line
    names them: K1's split into the box kernel's (``splat_fwd_window``)
    and the band kernel's (``splat_band``)."""
    out = {name + "_window": k.window_launches
           for name, k in KERNELS.items()}
    out["splat_band"] = splat_cuda.splat.band_launches
    out["splat_fwd_window"] -= out["splat_band"]
    return out


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
    ``path`` (the toy kitti_ldi3_b16, the toy mpi_baseline, or the toy
    highres_b64 with remat); returns the summary for the log line.

    A fixture with ``step1_ldi`` (the remat one) holds the step-1
    gradient in its two halves, as tests/test_torch_remat.py does: the
    loss's gradient at JAX's LDI, and the network's backward of JAX's LDI
    cotangent against JAX's (``step1_net_vjp``); its grad_norm is held
    from step 2 on. End to end, one projected coordinate at the image's
    right edge falls on the other side of it in the two frameworks, where
    the splat's gradient jumps (ROADMAP H10)."""
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

    halves = "step1_ldi/textures" in golden
    if halves:
        grads, want_key, ldi_err = step1_halves(state, batches[0], cfg,
                                                section, dev, label)
    else:
        grads = loss_and_grads(state, batches[0], cfg)[1]
        want_key = "step1_grads/"
    want = {k: v.to(dev)
            for k, v in state_dict_from_jax(section(want_key),
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
            if halves and i == 0 and k == "grad_norm":
                continue
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
    return ((f"step-1 loss gradient at JAX's LDI max abs err {ldi_err:.3e}; "
             "the network's backward of JAX's LDI cotangent " if halves
             else "step-1 grads ")
            + f"max abs err {g_err:.3e} (max |grad| {g_max:.3e}); "
            "max rel err over 3 steps "
            + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
            + f"; params after 3 steps: max diff "
            f"{diff.abs().max().item():.3e}, mean diff / mean move "
            f"{mean_ratio:.4f}, cosine {cosine:.5f}")


def step1_halves(state, batch, cfg, section, dev, label):
    """The step-1 gradient of a remat fixture in its two halves: the
    loss's gradient at JAX's LDI against JAX's (TRAIN_GRAD_ATOL_OF_MAX of
    the largest), then the (checkpointed) network's backward of JAX's LDI
    cotangent. Returns that backward by parameter name, the key of JAX's
    and the first half's max abs err."""
    from lsi_tpu_torch.losses.losses import total_loss
    b = decode_batch(batch)
    ldi = {k: torch.from_numpy(v).to(dev).requires_grad_()
           for k, v in section("step1_ldi/").items()}
    total = total_loss(LDI(ldi["textures"], ldi["disparities"],
                           b.intrinsics), b.trg_image, b.pose_src2trg,
                       cfg.loss, cfg.render, gt_disparity=b.gt_disparity,
                       gt_valid=b.gt_valid)["total"]
    total.backward()
    cot = {k: torch.from_numpy(v).to(dev)
           for k, v in section("step1_ldi_grad/").items()}
    c_max = max(v.abs().max().item() for v in cot.values())
    ldi_err = max(check_close(f"{label} loss gradient at JAX's LDI {k}",
                              ldi[k].grad, v, 0.0,
                              TRAIN_GRAD_ATOL_OF_MAX * c_max)
                  for k, v in cot.items())
    params = dict(state.net.named_parameters())
    pred = trainer_mod.apply_net(state.net, b.src_image, b.intrinsics,
                                 cfg.train.remat_decoder)
    grads = torch.autograd.grad((pred.textures, pred.disparities),
                                list(params.values()),
                                (cot["textures"], cot["disparities"]))
    return dict(zip(params, grads)), "step1_net_vjp/", ldi_err


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
    pixels 0..2 with K1's shared-memory path, its global-atomics path, the
    band kernel (the windowed K1) and the plain index_add_, and report
    each wsum. JAX on the CPU flushes denormals to 0; torch on the CPU
    keeps them. Every path must flush the 1e-39 as JAX does."""
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
    window = (0, 1, 0)
    band = splat_cuda._launch_splat(
        values, coords, weights, out_hw, True,
        splat_cuda.band_tiling(values.shape, out_hw, window), window)[1]
    plain = splat_bilinear(values, coords, weights, out_hw)[1]
    want = [0.0] + plain.flatten().tolist()[1:]
    for name, wsum in (("shared-memory path", shared),
                       ("global atomics", glob), ("band kernel", band)):
        if wsum.flatten().tolist() != want:
            fail(f"H12: K1's {name} gives wsum {wsum.flatten().tolist()}, "
                 f"not {want}")
    return (f"wsum of weights [1e-39, 2e-38, 1]: K1 shared-memory path "
            f"{shared.flatten().tolist()}, K1 global atomics "
            f"{glob.flatten().tolist()}, the band kernel (windowed K1) "
            f"{band.flatten().tolist()}, plain index_add_ "
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


def vjp_bound(values, coords, weights, out_hw, window=(-1, 1, 0)):
    """lsi_splat_vjp's bound: the forward's inputs read twice (once for the
    sums, once for the combine), the cotangents once, against the float32
    operations per pixel and per in-image (and in-window) corner (as in
    phase 11)."""
    n, hs, ws, c = values.shape
    cot = 4 * n * out_hw[0] * out_hw[1] * (c + 1)
    return bound(2 * nbytes(values, coords, weights) + cot,
                 20 * n * hs * ws
                 + (2 * c + 2) * 2 * corners_in_image(coords, *out_hw,
                                                      *window)
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
    if snap or weights is not None or tuple(values.shape) != tuple(
            coords.shape[:-1]) + (4,):
        fail(f"the MPI step's K1 launch is not the planes' gradient: "
             f"snap {snap}, weights {weights is not None}, values "
             f"{tuple(values.shape)}")
    _, _, k_err = time_k1("on the b8 mpi_baseline step's own inputs (the "
                          "planes' gradient: unsnapped, no weights, no "
                          "wsum)", smi, *calls["splat_fwd"][0])
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
    # each launch (checks, allocations, ctypes) outlasts the kernel, so
    # CUDA events around back-to-back calls time the host.
    band = splat_cuda.band_plan(values, out_hw, window, weights) is not None
    dev_fwd = kernel_device_us(lambda: splat_cuda.splat(
        values, coords, weights, out_hw, **kw),
        "splat_band_kernel" if band else "splat_fwd_kernel")
    dev_vjp = kernel_device_us(lambda: splat_cuda.splat_vjp(
        values, coords, weights, *cot, out_hw, **kw), "splat_vjp_kernel")
    b_fwd = k1_bound(values, coords, weights, out_hw, window)
    b_vjp = vjp_bound(values, coords, weights, out_hw, window)
    label = (f"shard {k} of {SPATIAL_S} ({tuple(values.shape)} -> "
             f"{out_hw}, window {window})")
    log("timing", f"{smi} | K1 windowed (use_band's choice) on {label}: "
        f"kernel {dev_fwd:.1f} us (profiler), "
        f"{1e3 * t_fwd['kernel']:.1f} us/call {r_fwd['kernel']}"
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
    # The band kernel on the same inputs, beside the box kernel: the
    # reading use_band's rule rests on.
    band_vs_box(f"on shard {k} of {SPATIAL_S}", smi, values, coords,
                weights, out_hw, True, window)
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
            zbuffer_scale=zscale, use_pallas="on",
            pallas_max_dy=SPATIAL_MAX_DY)
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
            want = dict(FULL_STEP, splat_fwd_window=0, splat_vjp_window=0,
                        splat_sort=0)
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
            "checkpoint_00000003.pt", "eval_images", "run_stamp.json",
            "train.jsonl"]
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


# ---------------------------------------------------------------------
# Phases 26-28: the high-resolution preset (serving and training), the
# LDI-vs-planes comparison and the collapse rollback.

def highres_images(dev, b: int, h: int, w: int, seed: int):
    """A request's images, drawn on the card from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((b, h, w, 3), generator=gen, device=dev)


def highres_serve(dev, smi: str):
    """Phase 26: highres_b64 at its widths, random weights from seed 0:
    4 requests of batch 64 at 512x1536 through LSIModel.predict_ldi ->
    LSIModel.render, one K1 launch a render; then predict, render and end
    to end by CUDA events after warm-up, frames/s and peak memory. Returns
    the launches."""
    config = get_config("highres_b64")
    b, h, w = config.data.batch_size, config.data.height, config.data.width
    model = LSIModel.init(0, config, h, w, device=dev)
    poses = [translation_pose([[-0.3, 0.0, 0.0]] * b).to(dev),
             pose_from_euler([[0.0, 0.03, 0.0]] * b,
                             [[-0.1, 0.0, 0.0]] * b).to(dev)]
    cfg_m = config.model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(HIGHRES_REQUESTS):
        ldi = model.predict_ldi(highres_images(dev, b, h, w, 10 + i))
        rgb = model.render(ldi, poses[i % 2])
        d = ldi.disparities
        if tuple(rgb.shape) != (b, h, w, 3) or not (
                torch.isfinite(rgb).all() and torch.isfinite(d).all()
                and torch.isfinite(ldi.textures).all()):
            fail(f"highres serve: request {i}: rgb {tuple(rgb.shape)} or "
                 "non-finite values")
        if (d.min() < cfg_m.min_disparity - 1e-6
                or d.max() > cfg_m.max_disparity + 1e-6
                or (d[:, 1:] > d[:, :-1] + 1e-6).any()):
            fail("highres serve: LDI disparities out of range or order")
        del ldi, rgb
    torch.cuda.synchronize()
    served = counts()
    if served != {"splat_fwd": HIGHRES_REQUESTS, "splat_vjp": 0,
                  "gather_fwd": 0, "gather_bwd_coords": 0}:
        fail(f"highres serve: {HIGHRES_REQUESTS} renders launched {served}")
    peak_serve = torch.cuda.max_memory_allocated() / 2**30
    image = highres_images(dev, b, h, w, 20)
    ldi = model.predict_ldi(image)
    t_pred = cuda_ms(lambda: model.predict_ldi(image), iters=3, warmup=1)
    t_rend = cuda_ms(lambda: model.render(ldi, poses[0]), iters=5)
    t_e2e = cuda_ms(lambda: model.render(model.predict_ldi(image),
                                         poses[0]), iters=3, warmup=1)
    n_params = sum(p.numel() for p in model.net.parameters())
    log("highres-serve", f"{smi} | highres_b64 ({n_params} params, "
        f"{cfg_m.compute_dtype}, L={cfg_m.num_layers}) at {b}x{h}x{w}: "
        f"{HIGHRES_REQUESTS} requests served, K1 launches "
        f"{served['splat_fwd']} = renders; peak memory of the requests "
        f"{peak_serve:.2f} GiB; predict {t_pred:.3f} ms "
        f"({1e3 * b / t_pred:.1f} frames/s), render {t_rend:.3f} ms "
        f"({1e3 * b / t_rend:.1f} frames/s), end-to-end {t_e2e:.3f} ms "
        f"({1e3 * b / t_e2e:.1f} frames/s)")
    del model, ldi, image
    return served


def chunks(n: int):
    return [slice(i, min(i + HIGHRES_CHUNK, n))
            for i in range(0, n, HIGHRES_CHUNK)]


def hold_k1_chunked(label: str, smi: str, values, coords, weights, out_hw,
                    snap: bool = True):
    """K1 on these inputs against the plain splat per chunk of images (the
    splat is per image, so this is the whole comparison), then timed in
    turns: K1 on all images at once, the plain splat chunk by chunk.
    Returns (times, bound, max abs err)."""
    got = splat_cuda.splat(values, coords, weights, out_hw, snap=snap)
    refs = [splat_bilinear(values[c], coords[c], weights[c], out_hw,
                           snap=snap) for c in chunks(values.shape[0])]
    err = 0.0
    for i, name in enumerate(("accum", "wsum")):
        ref = torch.cat([r[i] for r in refs])
        err = max(err, check_close(f"K1 {label} {name}", got[i], ref,
                                   SPLAT_RTOL,
                                   SPLAT_ATOL_OF_MAX * ref.abs().max().item()))
        del ref
    del got, refs
    t, readings = in_turns({
        "plain": lambda: [splat_bilinear(values[c], coords[c], weights[c],
                                         out_hw, snap=snap)
                          for c in chunks(values.shape[0])],
        "kernel": lambda: splat_cuda.splat(values, coords, weights, out_hw,
                                           snap=snap)}, iters=3)
    bnd = k1_bound(values, coords, weights, out_hw)
    log("timing", f"{smi} | K1 splat {label} {tuple(values.shape)} -> "
        f"{tuple(out_hw)}: {1e3 * t['kernel']:.1f} us/call "
        f"{readings['kernel']}, plain index_add_ in chunks of "
        f"{HIGHRES_CHUNK} images {1e3 * t['plain']:.1f} us/call "
        f"{readings['plain']}; bound {1e3 * bnd[0]:.1f} us ({bnd[1]}), "
        f"{100 * bnd[0] / t['kernel']:.0f}% of it; max abs err {err:.3e}")
    return t, bnd, err


def hold_vjp_chunked(label: str, smi: str, values, coords, weights, g_accum,
                     g_wsum, out_hw):
    """lsi_splat_vjp on these inputs and cotangents against autograd
    through the plain splat per chunk of images, at phase 7's tolerances
    plus the rounding slack of phase 24 (splat_vjp_slack), then timed in
    turns: the kernel on all images at once, the plain VJP chunk by
    chunk. Returns (times, bound, max abs err)."""
    n = values.shape[0]
    got = splat_cuda.splat_vjp(values, coords, weights, g_accum, g_wsum,
                               out_hw)
    refs, slacks = [], []
    for c in chunks(n):
        args = (values[c], coords[c], weights[c], g_accum[c], g_wsum[c])
        refs.append(splat_cuda._plain_vjp(*args, out_hw, (True, True, True)))
        slacks.append(splat_vjp_slack(*args, out_hw))
    ref = [torch.cat([r[i] for r in refs]) for i in range(3)]
    slack = [torch.cat([s[i] for s in slacks]) for i in range(3)]
    del refs, slacks
    err = check_vjp(f"lsi_splat_vjp {label}", got, ref, slack)
    scale = ", ".join(f"{r.abs().max().item():.3e}" for r in ref)
    del got, ref, slack
    t, readings = in_turns({
        "plain": lambda: [splat_cuda._plain_vjp(
            values[c], coords[c], weights[c], g_accum[c], g_wsum[c], out_hw,
            (True, True, True)) for c in chunks(n)],
        "kernel": lambda: splat_cuda.splat_vjp(values, coords, weights,
                                               g_accum, g_wsum, out_hw)},
        iters=2)
    bnd = vjp_bound(values, coords, weights, out_hw)
    log("timing", f"{smi} | lsi_splat_vjp {label} {tuple(values.shape)} -> "
        f"{tuple(out_hw)}: {1e3 * t['kernel']:.1f} us/call "
        f"{readings['kernel']}, plain (autograd through splat_bilinear) in "
        f"chunks of {HIGHRES_CHUNK} images {1e3 * t['plain']:.1f} us/call; "
        f"bound {1e3 * bnd[0]:.1f} us ({bnd[1]}), "
        f"{100 * bnd[0] / t['kernel']:.0f}% of it; max abs err {err:.3e} "
        f"(rtol {VJP_RTOL}, atol {VJP_ATOL_OF_MAX}*max|ref| plus the "
        f"rounding slack; max|ref| of d_values, d_coords, d_weights "
        f"{scale})")
    return t, bnd, err


def highres_train(dev, smi: str, workdir: Path):
    """Phase 27: the remat golden check; the b64 highres_b64 step with
    remat through make_train_step on a KITTI batch (ms, steps/s, peak
    memory), the step without remat as a probe (its OutOfMemoryError, if
    any, is a reading); 3 steps through the training CLI on the KITTI
    layout with an eval and a checkpoint; K1 and lsi_splat_vjp held and
    timed on the step's own recorded inputs and cotangents. Returns the
    launches of the main path and the two kernels' readings."""
    summary = with_tf32_off(lambda: golden_train(dev, GOLDEN_REMAT,
                                                 "golden-remat"))
    log("golden-remat", "toy highres_b64 with remat (2x32x96, float32, "
        "TF32 off) on CUDA vs JAX's jax.checkpoint step (CPU): " + summary)

    kitti_root = workdir / "kitti"
    cfg = build_config("highres_b64", [f"data.root={kitti_root}"])
    b, h, w = cfg.data.batch_size, cfg.data.height, cfg.data.width
    it = make_dataset(cfg.data, seed=0, device=dev)
    try:
        batch, t_batch = host_seconds(lambda: next(it))
    finally:
        it.close()
    launched = {k: 0 for k in KERNELS}

    def add(c):
        for k in launched:
            launched[k] += c[k]

    # The probe without remat runs first, so that each peak counts the
    # step alone (and the batch): the remat step's recorded inputs are
    # held only after both readings.
    readings, first_metrics = {}, {}
    for remat in (False, True):
        c = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  remat_decoder=remat))
        state = create_state(c, seed=0, device=dev)
        step = make_train_step(c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        oom = None
        try:
            # The first step, whose metrics the two settings compare, with
            # deterministic cuDNN algorithms; the timed steps and their
            # peak with the defaults.
            (state, metrics), first = host_seconds(
                lambda: with_cudnn_deterministic(lambda: step(state, batch)))
            per_step = counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(state, batch), iters=3, warmup=0)
        except torch.OutOfMemoryError as e:
            if remat:
                raise
            oom = str(e).splitlines()[0][:200]
        if oom is not None:
            # The probe is a reading; the traceback that held its tensors
            # is gone here.
            readings[remat] = (f"OutOfMemoryError at a peak of "
                               f"{torch.cuda.max_memory_allocated() / 2**30:.2f}"
                               f" GiB: {oom}")
            del state, step
            torch.cuda.empty_cache()
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30
        m = {k: float(v) for k, v in metrics.items()}
        if per_step != SPLAT_STEP or not all(np.isfinite(v)
                                             for v in m.values()):
            fail(f"highres step (remat {remat}): launches {per_step}, "
                 f"metrics {m}")
        first_metrics[remat] = m
        readings[remat] = (f"first step {first:.2f} s (cuDNN "
                           f"deterministic), then {ms:.1f} ms a "
                           f"step ({1e3 / ms:.3f} steps/s, "
                           f"{1e3 * b / ms:.1f} examples/s), peak memory "
                           f"{peak:.2f} GiB; total {m['total']:.7g}, "
                           f"grad_norm {m['grad_norm']:.7g}")
        if remat:
            add(counts())
            with recording() as calls:
                step(state, batch)
            calls = first_calls(calls)
            if [len(calls[k]) for k in KERNELS] != [1, 1, 0, 0]:
                fail(f"highres: one step recorded "
                     f"{ {k: len(v) for k, v in calls.items()} } launches")
        del state, step
        torch.cuda.empty_cache()
    del batch
    log("highres-train", f"{smi} | highres_b64 at {b}x{h}x{w} "
        f"({cfg.model.compute_dtype}, photo_mode={cfg.loss.photo_mode}) on "
        f"a KITTI batch (made in {t_batch:.2f} s), launches per step "
        f"{SPLAT_STEP}: with remat {readings[True]}; without remat (a "
        f"probe, run first) {readings[False]}")
    # Remat recomputes the forward in the backward: from the same state on
    # the same batch the first step's metrics must agree.
    if False in first_metrics:
        m0, m1 = first_metrics[False], first_metrics[True]
        rel = {k: abs(m1[k] - m0[k]) / max(abs(m0[k]), REMAT_FLOOR)
               for k in m0}
        if set(m0) != set(m1) or max(rel.values()) > REMAT_RTOL:
            fail(f"highres: the remat step's first metrics {m1} vs the "
                 f"step without remat {m0} (rtol {REMAT_RTOL})")
        worst = max(rel, key=rel.get)
        log("highres-train", f"remat vs no remat, first step: every metric "
            f"within rtol {REMAT_RTOL} (largest {worst}, {rel[worst]:.3e}; "
            f"grad_norm {m1['grad_norm']:.7g} vs {m0['grad_norm']:.7g})")
    else:
        log("highres-train", "remat vs no remat not compared: the probe "
            "without remat did not fit")

    # The training CLI on the KITTI layout, its own dataset.
    ckpt = workdir / "highres_run"
    sets = [f"data.root={kitti_root}",
            f"train.max_steps={HIGHRES_CLI_STEPS}",
            f"train.eval_every={HIGHRES_CLI_STEPS}", "train.eval_batches=1",
            f"train.checkpoint_every={HIGHRES_CLI_STEPS}",
            "train.log_every=1", f"train.checkpoint_dir={ckpt}"]
    reset_counts()
    _, _, host = traced_cli("highres", "highres_b64", sets,
                            ["full"] * HIGHRES_CLI_STEPS,
                            {"full": SPLAT_STEP}, (HIGHRES_CLI_STEPS,),
                            KITTI_EVAL_LAUNCHES, 1)
    add(counts())
    with open(ckpt / "train.jsonl") as f:
        lines = [json.loads(line) for line in f]
    rates = [r["steps_per_sec"] for r in lines if "total" in r]
    abs_rel = [r["eval_abs_rel"] for r in lines if "eval_abs_rel" in r]
    if len(abs_rel) != 1 or not np.isfinite(abs_rel[0]) or not (
            ckpt / f"checkpoint_{HIGHRES_CLI_STEPS:08d}.pt").exists():
        fail(f"highres CLI: eval_abs_rel {abs_rel}, files "
             f"{sorted(os.listdir(ckpt))}")
    log("highres-train", f"highres_b64 through the training CLI on KITTI "
        f"raw (data.root, no dataset override), {HIGHRES_CLI_STEPS} steps "
        f"with remat: steps_per_sec {secs(rates)}, the step's wait for its "
        f"batch {secs(host['data'])} s, step {secs(host['step'])} s, eval "
        f"{secs(host['eval'])} s (eval_abs_rel against LiDAR "
        f"{abs_rel[0]:.4f}), checkpoint save {secs(host['save'])} s")

    kernels = {}
    label = "on the b64 highres_b64 step's own inputs"
    t, bnd, err = hold_k1_chunked(label, smi, *calls["splat_fwd"][0])
    kernels["splat_fwd_highres"] = dict(
        replaces="lsi_tpu/kernels/splat_pallas.py:141", t=t, bound=bnd,
        err=err, library=None)
    t, bnd, err = hold_vjp_chunked(label + " and cotangents", smi,
                                   *calls["splat_vjp"][0])
    kernels["splat_vjp_highres"] = dict(
        replaces="lsi_tpu/kernels/splat_pallas.py:335", t=t, bound=bnd,
        err=err, library=None)
    return launched, kernels


def compare_phase(smi: str) -> None:
    """Phase 28, first half: python -m lsi_tpu_torch.evaluation.compare at
    the presets' widths, COMPARE_STEPS steps each, both scored on the same
    8 held-out batches; the table's rows must be the evaluations'."""
    from lsi_tpu_torch.evaluation import compare
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results, wall = host_seconds(lambda: compare.main(
            [str(COMPARE_STEPS)]))
    text = out.getvalue()
    table = text[text.index("metric "):].strip()
    rows = {ln.split()[0]: [float(x) for x in ln.split()[1:]]
            for ln in table.splitlines()[1:]}
    for col, (name, _) in enumerate(compare.PRESETS):
        got = results[name]["metrics"]
        if not rows or any(abs(rows[k][col] - got[k]) > 5e-5 for k in rows) \
                or not all(np.isfinite(v) for v in got.values()):
            fail(f"compare: table {rows} vs {name}'s evaluation {got}")
    widths = {name: (r["config"].data.height, r["config"].data.width,
                     r["config"].data.batch_size)
              for name, r in results.items()}
    log("compare", f"{smi} | synthetic_sanity and mpi_baseline at their "
        f"widths {widths}, {COMPARE_STEPS} steps each on two-plane scenes, "
        f"both evaluated on the same 8 held-out batches, in {wall:.2f} s:\n"
        + table)


def rollback_phase(dev, workdir: Path) -> str:
    """Phase 28, second half: kitti_ldi3_quality at its widths from phase
    23's shards, evals every 2 steps with the best export, the rollback on;
    the eval after step 4 reads abs_rel 1 higher than it is (a forced
    collapse). Every parameter must come back bitwise from the export of
    step 2, the optimizer start afresh, and step 4 be checkpointed at
    once."""
    from lsi_tpu_torch.train.checkpoint import CheckpointManager
    ckpt = workdir / "rollback_run"
    cfg = build_config("kitti_ldi3_quality", ROLLBACK_SETS + [
        f"data.root={workdir / 'shards'}", f"train.checkpoint_dir={ckpt}"])
    trainer = trainer_mod.Trainer(cfg, device=dev)
    launch.force_collapse(trainer, *ROLLBACK_COLLAPSE)
    state, metrics = trainer.train()
    meta = read_params_npz_meta(str(ckpt / "best_params.npz"))
    best = import_params_npz(cfg.model, str(ckpt / "best_params.npz"))
    kept = all(torch.equal(p.detach().cpu(), best[k])
               for k, p in state.net.named_parameters())
    saved = CheckpointManager(str(ckpt)).restore(
        create_state(cfg, seed=1, device=dev))
    saved_kept = all(torch.equal(p.detach().cpu(), best[k])
                     for k, p in saved.net.named_parameters())
    with open(ckpt / "rollback_state.json") as f:
        used = json.load(f)["count"]
    if not (metrics.get("rollback") == 1.0 and meta["step"] == 2 and kept
            and saved_kept and saved.step == 4 and used == 1
            and state.opt_state.count == 0
            and all(not v.any() for v in state.opt_state.mu.values())):
        fail(f"rollback: metrics {metrics}, export {meta}, params kept "
             f"{kept}, checkpoint step {saved.step} kept {saved_kept}, "
             f"budget {used}, optimizer count {state.opt_state.count}")
    return (f"kitti_ldi3_quality at {cfg.data.height}x{cfg.data.width} "
            f"b{cfg.data.batch_size} from the shards, collapse forced at "
            f"step {ROLLBACK_COLLAPSE[0]} (eval_abs_rel_drift "
            f"{metrics['eval_abs_rel_drift']:.4f}): every parameter bitwise "
            f"the step-{meta['step']} export's (eval_abs_rel "
            f"{meta['eval_abs_rel']:.4f}), Adam's moments and count zero, "
            f"the checkpoint of step 4 written at once and equal, budget "
            f"{used}/{cfg.train.collapse_max_rollbacks}")


# ---------------------------------------------------------------------
# Phase 29: the TPU kernels' route (render.use_pallas="on").

def route_counts() -> dict:
    return {**counts(), **window_counts()}


def all_windowed(tag: str, launched: dict) -> None:
    """Every launch counted in ``launched`` (route_counts) windowed."""
    for name in KERNELS:
        windowed = launched[name + "_window"] + (
            launched["splat_band"] if name == "splat_fwd" else 0)
        if launched[name] != windowed:
            fail(f"{tag}: {windowed} of {launched[name]} {name} launches "
                 "windowed")


def dy_warnings(fn):
    """``fn()`` and the window warnings it gave."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in caught
                 if "dy-window" in str(w.message)]


def route_cli(workdir: Path, shards: Path):
    """Phase 29 (a): the training CLI on kitti_ldi3_quality with
    --set render.use_pallas=on, from phase 23's shards; every launch
    windowed. Returns the summary and its launches."""
    ckpt = workdir / "route_run"
    sets = ROUTE_SETS + [f"data.root={shards}", f"train.checkpoint_dir={ckpt}"]
    reset_counts()
    (_, _, host), warned = dy_warnings(lambda: traced_cli(
        "route", "kitti_ldi3_quality", sets, ROUTE_PHASES, STEP_LAUNCHES,
        (len(ROUTE_PHASES),), EVAL_LAUNCHES, 1))
    launched = route_counts()
    all_windowed("route CLI", launched)
    with open(ckpt / "train.jsonl") as f:
        lines = [json.loads(line) for line in f]
    train_lines = [r for r in lines if "total" in r]
    drops = [r["window_dropped_frac"] for r in train_lines]
    rates = [r["steps_per_sec"] for r in train_lines]
    evals = [r for r in lines if "eval_abs_rel" in r]
    if len(train_lines) != len(ROUTE_PHASES) or len(evals) != 1 or not all(
            np.isfinite(v) for r in lines for v in r.values()
            if isinstance(v, float)):
        fail(f"route CLI: jsonl {lines}")
    if any(d > 1e-4 for d in drops) != bool(warned) or len(warned) > 1:
        fail(f"route CLI: window_dropped_frac {drops}, warnings {warned}")
    return (f"kitti_ldi3_quality through the training CLI with --set "
            f"render.use_pallas=on from phase 23's shards: "
            f"{len(ROUTE_PHASES)} steps (phases {ROUTE_PHASES}) and an eval, "
            f"every one of {launched} launches windowed; steps_per_sec "
            f"{secs(rates)}; host s a step {secs(host['step'])}; "
            f"window_dropped_frac {secs(drops)}; warned "
            f"{len(warned)} time(s){': ' + warned[0] if warned else ''}; "
            f"eval_abs_rel {evals[0]['eval_abs_rel']:.4f}, eval_psnr "
            f"{evals[0]['eval_psnr']:.3f}, eval_window_dropped_frac "
            f"{evals[0]['eval_window_dropped_frac']:.6f}"), launched


def route_step(dev, smi: str) -> dict:
    """Phase 29 (a): the route's quality step and the "auto" step on the
    same batch, in turns (auto, on, on, auto); then the route's step
    recorded. Returns the first windowed call of each kernel (K1 and
    lsi_splat_vjp at the full LDI)."""
    cfg = build_config("kitti_ldi3_quality", ROUTE_ON)
    auto = cfg.replace(render=dataclasses.replace(cfg.render,
                                                  use_pallas="auto"))
    b, h, w = cfg.data.batch_size, cfg.data.height, cfg.data.width
    state = create_state(cfg, seed=0, device=dev)
    batch = next(batch_stream(cfg.data, seed=0, device=dev))
    on_step, auto_step = make_train_step(cfg), make_train_step(auto)
    t, readings = in_turns({"plain": lambda: auto_step(state, batch),
                            "kernel": lambda: on_step(state, batch)},
                           iters=10)
    log("timing", f"{smi} | quality step kitti_ldi3_quality b{b} {h}x{w} "
        f"(full): render.use_pallas=on {t['kernel']:.3f} ms "
        f"({1e3 / t['kernel']:.3f} steps/s) {readings['kernel']}, \"auto\" "
        f"{t['plain']:.3f} ms ({1e3 / t['plain']:.3f} steps/s) "
        f"{readings['plain']} on the same batch, in turns; on / auto "
        f"{t['kernel'] / t['plain']:.4f}")
    with recording(windowed=True) as calls:
        on_step(state, batch)
    full = [c for c in calls["splat_fwd"]
            if c[0].shape[1] == 3 * h and c[2] is not None]
    vjp = [c for c in calls["splat_vjp"] if c[0].shape[1] == 3 * h]
    got = [len(calls["splat_fwd"]), len(calls["splat_vjp"]),
           len(calls["gather_fwd"]), len(calls["gather_bwd_coords"])]
    if got != [FULL_STEP[k] for k in ("splat_fwd", "splat_vjp", "gather_fwd",
                                      "gather_bwd_coords")] or not full \
            or not vjp:
        fail(f"route: one windowed quality step recorded {got}")
    # The backward runs the gathers in reverse order: pair the first
    # forward with its own backward.
    fwd = calls["gather_fwd"][0]
    bwd = [c for c in calls["gather_bwd_coords"]
           if torch.equal(c[1], fwd[1])]
    if not bwd:
        fail("route: no recorded gather backward at the first forward's "
             "coordinates")
    return {"splat_fwd": full[0], "splat_vjp": vjp[0], "gather_fwd": fwd,
            "gather_bwd_coords": bwd[0]}


def hold_timed(label: str, smi: str, name: str, kernel, plain, check,
               kernel_name: str, bnd, iters: int = 10) -> dict:
    """A kernel call against its plain version (``check(got, ref)``
    returns the max abs err or fails), both timed in turns by CUDA
    events, and the kernel alone by torch.profiler; logs and returns the
    kernels line's reading."""
    err = check(kernel(), plain())
    t, readings = in_turns({"plain": plain, "kernel": kernel}, iters=iters)
    dev_us = kernel_device_us(kernel, kernel_name, required=False)
    alone = ("not measured (the profiler's trace missed launches)"
             if dev_us is None else
             f"{dev_us:.1f} us, {100 * bnd[0] / (dev_us / 1e3):.0f}% of the "
             "bound")
    log("timing", f"{smi} | {name} {label}: {1e3 * t['kernel']:.1f} us/call "
        f"{readings['kernel']} (events), plain {1e3 * t['plain']:.1f} us/call "
        f"{readings['plain']}; bound {1e3 * bnd[0]:.1f} us ({bnd[1]}), "
        f"{100 * bnd[0] / t['kernel']:.0f}% of it by events; the kernel "
        f"alone (profiler) {alone}; max abs err {err:.3e}")
    return dict(t=t, bound=bnd, err=err, library=None,
                device_ms=None if dev_us is None else dev_us / 1e3)


def hold_window_k1(label: str, smi: str, values, coords, weights, out_hw,
                   snap, window, tiling=None) -> dict:
    """The windowed K1 on a recorded launch's own inputs, as ``splat``
    launches it (use_band's choice of kernel) or with ``tiling`` (a
    BandTiling: the band kernel), against the plain windowed splat
    (check_k1), timed (hold_timed)."""
    base = splat_cuda.window_base_rows(values.shape[1], out_hw[0],
                                       *window).to(values.device)
    band = isinstance(tiling if tiling is not None else splat_cuda.band_plan(
        values, out_hw, window, weights), splat_cuda.BandTiling)
    name = "the band kernel" if band else "the box kernel"
    return hold_timed(
        f"{label} ({tuple(values.shape)} -> {out_hw}, window {window}"
        + ("" if weights is not None else ", no weights") + ")", smi,
        f"K1 windowed ({name}"
        + (", use_band's choice)" if tiling is None else ")"),
        lambda: splat_cuda._launch_splat(values, coords, weights, out_hw,
                                         snap, tiling, window),
        lambda: splat_bilinear(values, coords, weights, out_hw, snap=snap,
                               max_dy_window=window[0], base_rows=base),
        lambda got, ref: check_k1(f"windowed {label}", got, ref),
        "splat_band_kernel" if band else "splat_fwd_kernel",
        k1_bound(values, coords, weights, out_hw, window))


def band_vs_box(label: str, smi: str, values, coords, weights, out_hw, snap,
                window) -> float:
    """The band kernel and the box kernel on the same windowed inputs,
    each held to the plain windowed splat and timed (the readings
    use_band's rule rests on); returns the larger max abs err."""
    err = 0.0
    for tiling in (
            splat_cuda.band_tiling(values.shape, out_hw, window,
                                   weights=weights is not None,
                                   aligned16=values.data_ptr() % 16 == 0),
            splat_cuda.splat_tiling(values.shape, out_hw,
                                    aligned16=values.data_ptr() % 16 == 0)):
        err = max(err, hold_window_k1(label, smi, values, coords, weights,
                                      out_hw, snap, window, tiling)["err"])
    return err


def hold_gather_window(label: str, smi: str, image, coords, window,
                       cot) -> tuple:
    """lsi_gather_fwd and lsi_gather_bwd_coords windowed against the plain
    windowed gather and its autograd VJP (phases 11 and 18's
    tolerances), timed."""
    max_dy, fold_h = window
    _, hi, wi, c = image.shape

    def check_fwd(got, ref):
        return max(check_close(f"K4-W {label} {k}", g, r, 1e-5, 1e-6)
                   for k, g, r in zip(("sampled", "valid"), got, ref))

    sampled = gather_cuda.gather_fwd(image, coords, *window)
    fwd = hold_timed(
        label, smi, "lsi_gather_fwd windowed",
        lambda: gather_cuda.gather_fwd(image, coords, *window),
        lambda: bilinear_sample(image, coords, max_dy=max_dy, fold_h=fold_h),
        check_fwd, "gather_fwd_kernel",
        bound(nbytes(image, coords, *sampled),
              20 * coords[..., 0].numel()
              + 2 * (c + 1) * corners_in_image(coords, hi, wi, *window)))
    bwd = hold_timed(
        label + " and cotangents", smi, "lsi_gather_bwd_coords windowed",
        lambda: gather_cuda.gather_bwd_coords(image, coords, *cot, *window),
        lambda: gather_cuda._plain_coords_vjp(image, coords, *cot, *window),
        lambda g, r: check_vjp(f"K4-W {label} d_coords", [g], [r]),
        "gather_bwd_coords_kernel", gather_bwd_bound(image, coords,
                                                            cot, window))
    return fwd, bwd


def route_inputs(dev, rng, dy: float, max_dy: int, away_from_snap=False):
    """A (8, 256, 768, 3) image and (8, 768, 768, 2) coordinates folding
    3 layers, +-40 px across and +-dy rows from each row's base row; with
    ``away_from_snap``, no fraction within 1e-3 of an integer."""
    n, hi, wi, c = 8, 256, 768, 3
    hs = 3 * hi
    image = rng.uniform(size=(n, hi, wi, c)).astype(np.float32)
    x = np.arange(wi, dtype=np.float32)[None, None, :] + rng.uniform(
        -40, 40, (n, hs, wi)).astype(np.float32)
    y = (np.arange(hs, dtype=np.float32) % hi)[None, :, None] + rng.uniform(
        -dy, dy, (n, hs, wi)).astype(np.float32)
    coords = np.stack([x, y], -1)
    if away_from_snap:
        f = coords - np.floor(coords)
        coords = np.where((f < 1e-3) | (f > 1 - 1e-3), coords + 0.01, coords)
    gen = torch.Generator(device=dev).manual_seed(max_dy + 17)
    image, coords = (torch.from_numpy(a.astype(np.float32)).to(dev)
                     for a in (image, coords))
    cot = (torch.randn(coords.shape[:-1] + (c,), generator=gen, device=dev),
           torch.randn(coords.shape[:-1] + (1,), generator=gen, device=dev))
    return image, coords, cot


def route_kernels(dev, smi: str, own: dict) -> dict:
    """Phase 29 (b): K4-W on the route step's own inputs (window 8), on
    random inputs at a window of 2, and, away from the snap zones with a
    window that drops nothing, against the exact kernels; then the
    windowed K1 and lsi_splat_vjp on the step's own inputs. Returns the
    kernels line's readings of the windowed kernels."""
    out = {}
    image, coords, window = own["gather_fwd"]
    g_image, g_coords, g_s, g_v, *g_window = own["gather_bwd_coords"]
    if not (torch.equal(image, g_image) and torch.equal(coords, g_coords)
            and tuple(window) == tuple(g_window)):
        fail("route: the recorded gather forward and backward differ")
    del g_image, g_coords
    fwd, bwd = hold_gather_window(
        f"on the b8 route step's own inputs (window {window})", smi, image,
        coords, window, (g_s, g_v))
    out["gather_fwd_window"] = dict(
        fwd, replaces="lsi_tpu/kernels/gather_pallas.py:61")
    out["gather_bwd_coords_window"] = dict(
        bwd, replaces="lsi_tpu/kernels/gather_pallas.py:104")
    dropped = 1.0 - (gather_cuda.gather_fwd(image, coords, *window)[1].sum()
                     / gather_cuda.gather_fwd(image, coords)[1].sum()).item()
    del image, coords, g_s, g_v

    rng = np.random.default_rng(29)
    image, coords, cot = route_inputs(dev, rng, ROUTE_RANDOM_DY,
                                      ROUTE_RANDOM_MAX_DY)
    window = gather_cuda.gather_window(image, coords, ROUTE_RANDOM_MAX_DY)
    fwd, bwd = hold_gather_window(
        f"at random +-40 px, +-{ROUTE_RANDOM_DY} rows (window {window})",
        smi, image, coords, window, cot)
    random_drop = 1.0 - (gather_cuda.gather_fwd(image, coords, *window)[1]
                         .sum() / gather_cuda.gather_fwd(image, coords)[1]
                         .sum()).item()
    for k, r in (("gather_fwd_window", fwd), ("gather_bwd_coords_window",
                                              bwd)):
        out[k]["err"] = max(out[k]["err"], r["err"])

    image, coords, cot = route_inputs(dev, rng, 1.0, 8, away_from_snap=True)
    wide = gather_cuda.gather_fwd(image, coords, 8)
    exact = gather_cuda.gather_fwd(image, coords)
    same = max(check_close(f"K4-W wide window vs exact {k}", a, b, 0.0, 1e-6)
               for k, a, b in zip(("sampled", "valid"), wide, exact))
    d_wide = gather_cuda.gather_bwd_coords(image, coords, *cot, 8)
    d_exact = gather_cuda.gather_bwd_coords(image, coords, *cot)
    same = max(same, check_close("K4-W wide window vs exact d_coords",
                                 d_wide, d_exact, 0.0, 1e-6))
    bitwise = all(torch.equal(a, b) for a, b in zip(
        wide + (d_wide,), exact + (d_exact,)))
    del image, coords, cot, wide, exact, d_wide, d_exact

    out["splat_fwd_window"] = hold_window_k1(
        "on the b8 route step's own inputs", smi, *own["splat_fwd"])
    band_vs_box("on the b8 route step's own inputs", smi, *own["splat_fwd"])
    values, coords, weights, g_accum, g_wsum, out_hw, vkw = own["splat_vjp"]
    vwin = (vkw["max_dy"], vkw["fold_h"] or out_hw[0], vkw["base_offset"])
    slack = splat_vjp_slack(values, coords, weights, g_accum, g_wsum, out_hw,
                            vwin)
    label = (f"on the b8 route step's own inputs ({tuple(values.shape)} -> "
             f"{out_hw}, window {vwin})")
    out["splat_vjp_window"] = hold_timed(
        label + " and cotangents", smi, "lsi_splat_vjp windowed",
        lambda: splat_cuda.splat_vjp(values, coords, weights, g_accum,
                                     g_wsum, out_hw, **vkw),
        lambda: splat_cuda._plain_vjp(values, coords, weights, g_accum,
                                      g_wsum, out_hw, (True, True, True),
                                      *vwin),
        lambda g, r: check_vjp("lsi_splat_vjp windowed route", g, r, slack),
        "splat_vjp_kernel", vjp_bound(values, coords, weights, out_hw, vwin))
    log("route", f"K4-W held to the plain windowed gather on the route "
        f"step's own inputs (the window drops {dropped:.4%} of the valid "
        f"mass) and at random +-40 px (drops {random_drop:.4%}); a window "
        f"that drops nothing, away from the snap zones, is the exact "
        f"kernels' gather within {same:.3e} (bitwise: {bitwise}); the "
        f"windowed K1 (the box and the band kernel) and lsi_splat_vjp held "
        f"on the step's own inputs")
    return out


def golden_pallas(dev) -> str:
    """Phase 29 (c): the route at toy size on the card (float32, TF32
    off, cuDNN deterministic) against JAX's interpret-mode kernels in
    tests/data/torch_golden_pallas_toy.npz; returns the summary."""
    with np.load(GOLDEN_PALLAS) as g:
        golden = {k: g[k] for k in g.files}

    def section(src, prefix):
        return {k[len(prefix):]: v for k, v in src.items()
                if k.startswith(prefix)}

    def on(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    gather_err = 0.0
    for i in range(2):
        case = section(golden, f"gather{i}/")
        img = on(case["image"]).requires_grad_()
        crd = on(case["coords"]).requires_grad_()
        outs = gather_cuda.GatherFn.apply(img, crd, int(case["max_dy"]))
        grads = torch.autograd.grad(outs, (img, crd), (
            on(case["g_sampled"]), on(case["g_valid"])))
        for name, got in zip(("sampled", "valid", "d_image", "d_coords"),
                             outs + grads):
            rtol, atol = ROUTE_GATHER_TOL
            if name == "d_coords":
                rtol, atol = 0.0, atol * float(np.abs(case[name]).max())
            gather_err = max(gather_err, check_close(
                f"golden-route gather{i} {name}", got.detach(),
                on(case[name]), rtol, atol))
    summary = [f"gather_pallas_diff (interpret) vs GatherFn windowed: max "
               f"abs err {gather_err:.3e}"]
    for name, fixture in (("quality", GOLDEN_QUALITY), ("mpi", GOLDEN_MPI)):
        g = section(golden, f"{name}/")
        cfg = Config.from_dict(json.loads(bytes(g["__config__"]).decode()))
        with np.load(fixture) as f:
            start = {k: f[k] for k in f.files}
        state = create_state(cfg, device=dev)
        state.net.load_state_dict(state_dict_from_jax(
            section(start, "params/"), cfg.model))
        # The fixture's own batch fields (the MPI's tilted poses) replace
        # the starting fixture's.
        batches = [Batch(**{k: on(v) for k, v in {
            **section(start, f"batch{i}/"),
            **section(g, f"batch{i}/")}.items()}) for i in range(2)]
        before = route_counts()
        grads = loss_and_grads(state, batches[0], cfg)[1]
        launched = {k: v - before[k] for k, v in route_counts().items()}
        all_windowed(f"golden-route {name}", launched)
        want = {k: v.to(dev) for k, v in state_dict_from_jax(
            section(g, "step1_grads/"), cfg.model).items()}
        g_max = max(v.abs().max().item() for v in want.values())
        g_err = max(check_close(f"golden-route {name} grad {k}", grads[k],
                                want[k], 0.0,
                                ROUTE_GRAD_OF_MAX[name] * g_max)
                    for k in want)
        step = make_train_step(cfg)
        metrics_want = section(g, "metrics/")
        worst, drop_err = 0.0, 0.0
        for i, batch in enumerate(batches):
            state, metrics = step(state, batch)
            if sorted(metrics) != sorted(metrics_want):
                fail(f"golden-route {name} metrics {sorted(metrics)} vs "
                     f"{sorted(metrics_want)}")
            for k, v in metrics_want.items():
                got, ref = float(metrics[k]), float(v[i])
                if k.startswith("window_dropped_frac"):
                    ok = abs(got - ref) <= ROUTE_DROP_ATOL
                    drop_err = max(drop_err, abs(got - ref))
                else:
                    rtol = (TRAIN_NORM_RTOL[i] if k == "grad_norm"
                            else ROUTE_LOSS_RTOL)
                    ok = abs(got - ref) <= 1e-7 + rtol * abs(ref)
                    if k != "grad_norm":
                        worst = max(worst, abs(got - ref) / max(abs(ref),
                                                                1e-12))
                if not ok:
                    fail(f"golden-route {name} {k} at step {i + 1}: {got} "
                         f"vs JAX {ref}")
        drops = metrics_want.get("window_dropped_frac")
        summary.append(
            f"toy {name} (window {cfg.render.pallas_max_dy}): step-1 grads "
            f"max abs err {g_err:.3e} (max |grad| {g_max:.3e}, atol "
            f"{ROUTE_GRAD_OF_MAX[name]}*max); loss parts over 2 steps max "
            f"rel err {worst:.2e} (rtol {ROUTE_LOSS_RTOL})"
            + ("" if drops is None else
               f"; window_dropped_frac JAX {secs(drops)}, max abs err "
               f"{drop_err:.2e} (atol {ROUTE_DROP_ATOL})"))
    return "; ".join(summary)


def route_serving(dev, smi: str):
    """Phase 29 (d): kitti_ldi2 serving on the route (b8, 4 requests and
    one over-rotated pose, which must warn), frames/s beside "auto".
    Returns the summary, the launches of the requests and one render's K1
    launch (recorded)."""
    config = get_config("kitti_ldi2")
    h, w = config.data.height, config.data.width
    on_cfg = config.replace(render=dataclasses.replace(config.render,
                                                       use_pallas="on"))
    model = LSIModel.init(0, on_cfg, h, w, device=dev)
    auto = LSIModel(config, model.net)
    rng = np.random.default_rng(1)
    images = [torch.from_numpy(rng.uniform(size=(BATCH, h, w, 3)).astype(
        np.float32)).to(dev) for _ in range(REQUESTS)]
    pose = translation_pose([[-0.3, 0.0, 0.0]] * BATCH).to(dev)
    over = pose_from_euler(OVER_ROTATED[0] * BATCH,
                           OVER_ROTATED[1] * BATCH).to(dev)
    torch.cuda.synchronize()
    reset_counts()
    rendered, quiet = dy_warnings(lambda: [
        model.render(model.predict_ldi(im), pose) for im in images])
    ldi = model.predict_ldi(images[0])
    _, warned = dy_warnings(lambda: model.render(ldi, over))
    torch.cuda.synchronize()
    launched = route_counts()
    all_windowed("route serving", launched)
    if launched["splat_fwd"] != REQUESTS + 1 or len(warned) != 1 or quiet:
        fail(f"route serving: launches {launched}, warnings {quiet} then "
             f"{warned} (one expected, for the over-rotated pose)")
    if not all(torch.isfinite(r).all() for r in rendered):
        fail("route serving: non-finite renders")
    err = (model.render(ldi, pose) - auto.render(ldi, pose)).abs().max().item()
    with recording(windowed=True) as calls:
        model.render(ldi, pose)
    image = images[0]
    t, readings = in_turns({
        "plain": lambda: auto.render(auto.predict_ldi(image), pose),
        "kernel": lambda: model.render(model.predict_ldi(image), pose)},
        iters=20)
    return (f"{smi} | kitti_ldi2 b{BATCH} {h}x{w} on the route: "
            f"{REQUESTS} requests and one over-rotated pose, {launched}, all "
            f"windowed; the over-rotated pose warned ({warned[0]}); "
            f"on vs auto render max abs diff at t=-0.3 {err:.3e}; "
            f"end-to-end {t['kernel']:.3f} ms ({1e3 * BATCH / t['kernel']:.1f}"
            f" frames/s) {readings['kernel']}, \"auto\" {t['plain']:.3f} ms "
            f"({1e3 * BATCH / t['plain']:.1f} frames/s) {readings['plain']}, "
            "in turns"), launched, calls["splat_fwd"][0]


def route_trajectory(dev, smi: str, workdir: Path):
    """Phase 29 (d): the trajectory sweep on the route (windowed K1 at
    trajectory_sweep's window of 16): 8 windowed launches, the frames
    beside "auto"'s; returns the summary, the launches and the first
    chunk's K1 launch (recorded)."""
    from lsi_tpu_torch.evaluation.trajectory import render_trajectory
    from lsi_tpu_torch.models import build_model
    cfg = build_config("trajectory_sweep", [
        "render.use_pallas=on",
        f"train.checkpoint_dir={workdir / 'no_checkpoint'}"])
    auto = cfg.replace(render=dataclasses.replace(cfg.render,
                                                  use_pallas="auto"))
    net = build_model(cfg.model)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net = net.to(dev)
    reset_counts()
    with recording(windowed=True) as calls:
        frames, warned = dy_warnings(lambda: runner.trajectory_frames(
            cfg, net, dev))
    launched = route_counts()
    all_windowed("route trajectory", launched)
    # The sweep's rotation moves rows by at most ~4 at 768 px: the window
    # of 16 keeps everything, so the sweep must not warn.
    if launched["splat_fwd"] != TRAJECTORY_CHUNKS or warned or not \
            torch.isfinite(frames).all():
        fail(f"route trajectory: {launched}, warnings {warned}")
    err = (frames - runner.trajectory_frames(auto, net, dev)).abs().max()
    it = make_dataset(cfg.data, seed=1, device=dev)
    try:
        batch = decode_batch(next(it))
    finally:
        it.close()
    with torch.no_grad():
        ldi = net(batch.src_image[:1], batch.intrinsics[:1])
    t, readings = in_turns({
        "plain": lambda: render_trajectory(ldi, 60, (0.15, 0.0, 0.0),
                                           (0.0, 0.0, 0.01), auto.render),
        "kernel": lambda: render_trajectory(ldi, 60, (0.15, 0.0, 0.0),
                                            (0.0, 0.0, 0.01), cfg.render)},
        iters=5)
    return (f"{smi} | trajectory_sweep on the route (window "
            f"{cfg.render.pallas_max_dy}): 60 views in "
            f"{launched['splat_fwd_window']} windowed K1 launches, no "
            f"warning, frames {err.item():.3e} from auto's at most; the "
            f"sweep of one LDI (phase 25's) {t['kernel']:.3f} ms "
            f"{readings['kernel']}, auto {t['plain']:.3f} ms "
            f"{readings['plain']}, in turns"), launched, \
        calls["splat_fwd"][0]


def route_mpi(dev, smi: str):
    """Phase 29 (d): mpi_baseline at its widths on the route (the
    homography gather windowed at 2 rows), ROUTE_MPI_STEPS steps through
    make_train_step, then its step beside "auto"'s; returns the summary,
    the launches and one step's K1 launch (the planes' gradient: K4-W's,
    snapped, windowed, no weights; recorded)."""
    cfg = build_config("mpi_baseline", ["render.use_pallas=on"])
    auto = cfg.replace(render=dataclasses.replace(cfg.render,
                                                  use_pallas="auto"))
    state = create_state(cfg, seed=0, device=dev)
    stream = batch_stream(cfg.data, seed=0, device=dev)
    batches = [next(stream) for _ in range(ROUTE_MPI_STEPS)]
    step = make_train_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    history = []
    for batch in batches:
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    torch.cuda.synchronize()
    launched = route_counts()
    all_windowed("route mpi", launched)
    per_step = {k: MPI_STEP[k] * ROUTE_MPI_STEPS for k in MPI_STEP}
    if {k: launched[k] for k in KERNELS} != per_step or not all(
            np.isfinite(v) for m in history for v in m.values()):
        fail(f"route mpi: launches {launched}, metrics {history}")
    auto_step = make_train_step(auto)
    t, readings = in_turns({"plain": lambda: auto_step(state, batches[0]),
                            "kernel": lambda: step(state, batches[0])},
                           iters=5)
    with recording(windowed=True) as calls:
        step(state, batches[0])
    if len(calls["splat_fwd"]) != 1 or calls["splat_fwd"][0][2] is not None:
        fail(f"route mpi: one step recorded {calls['splat_fwd']} as K1")
    b, h, w = cfg.data.batch_size, cfg.data.height, cfg.data.width
    return (f"{smi} | mpi_baseline b{b} {h}x{w} on the route (window "
            f"{cfg.render.pallas_max_dy}): {ROUTE_MPI_STEPS} steps, "
            f"{launched}, all windowed; photo_mpi "
            + ", ".join(f"{m['photo_mpi']:.5f}" for m in history)
            + f"; step {t['kernel']:.3f} ms {readings['kernel']}, auto "
            f"{t['plain']:.3f} ms {readings['plain']}, in turns"), launched, \
        calls["splat_fwd"][0]


def route_phase(dev, smi: str, workdir: Path, shards: Path):
    """Phase 29: the TPU kernels' route. Returns the windowed kernels'
    readings for the kernels line and the launches of its main paths
    ((a) the CLI run, (d) serving, the sweep, the MPI steps)."""
    summary, launched = route_cli(workdir, shards)
    log("route", summary)
    own = route_step(dev, smi)
    torch.cuda.empty_cache()
    kernels = route_kernels(dev, smi, own)
    del own
    torch.cuda.empty_cache()
    log("route", "golden (toy, float32, TF32 off, cuDNN deterministic) vs "
        "JAX's kernels in interpret mode: " + with_tf32_off(
            lambda: with_cudnn_deterministic(lambda: golden_pallas(dev))))
    summary, more, serve_k1 = route_serving(dev, smi)
    log("route", summary)
    launched = {k: v + more[k] for k, v in launched.items()}
    torch.cuda.empty_cache()
    summary, more, mpi_k1 = route_mpi(dev, smi)
    log("route", summary)
    launched = {k: v + more[k] for k, v in launched.items()}
    torch.cuda.empty_cache()
    summary, more, sweep_k1 = route_trajectory(dev, smi, workdir)
    log("route", summary)
    launched = {k: v + more[k] for k, v in launched.items()}
    # The band kernel on the MPI's own inputs (use_band's choice there: the
    # kernels line's entry) and the serving render's, each beside the box
    # kernel; the box kernel beside the band kernel on the sweep's own.
    label = "on the route MPI step's own inputs (the planes' gradient)"
    band = kernels["splat_band"] = dict(
        hold_window_k1(label, smi, *mpi_k1),
        replaces="lsi_tpu/kernels/splat_pallas.py:141")
    band["err"] = max(band["err"], band_vs_box(label, smi, *mpi_k1))
    label = "on the route's b8 kitti_ldi2 serving render's own inputs"
    band["err"] = max(band["err"],
                      hold_window_k1(label, smi, *serve_k1)["err"],
                      band_vs_box(label, smi, *serve_k1))
    box = kernels["splat_fwd_window"]
    box["err"] = max(box["err"], band_vs_box(
        "on the route sweep's own inputs (a chunk of 8 poses)", smi,
        *sweep_k1))
    return kernels, launched

# ------------------------------------------------ phase 30: sort splat

#: K1-D's kernels by kind (their names in splat_sort.cu) and the memset of
#: its counts; any other kernel in a call fails hold_sort.
SORT_KINDS = (("splat_sort_count", "count"), ("splat_sort_scan", "scan"),
              ("splat_sort_fill", "fill"), ("splat_sort_sum", "sum"),
              ("splat_sort_long", "long"), ("Memset", "memset"))


def call_device_us(fn, iters: int = 10):
    """Mean device time in us per call of ``fn`` of every CUDA kernel,
    copy and memset it launches (torch.profiler, after warm-up), that time
    by kind (SORT_KINDS), and the names of any other kernels."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name, others = {}, set()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for pat, k in SORT_KINDS if pat in e.name), None)
            if name is None:
                others.add(e.name)
                name = "other"
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / iters)
    return sum(by_name.values()), by_name, sorted(others)


def sort_runs(coords, out_hw, snap, window) -> dict:
    """The runs K1-D sorts on these inputs, counted with PyTorch: a
    target's run is its live corners (in the image, in the window, a
    fraction above 0). The longest, the mean over covered targets, and
    the share of targets (and of covered ones) whose run is longer than
    SORT_SHORT_RUN, the ones the long-run kernel takes."""
    base = None if window[0] < 0 else splat_cuda.window_base_rows(
        coords.shape[1], out_hw[0], *window).to(coords.device)
    ones = torch.ones(coords.shape[:-1] + (1,), device=coords.device)
    idx, frac = corner_contributions(ones, coords, None, out_hw, snap,
                                     None if base is None else window[0],
                                     base)
    targets = coords.shape[0] * out_hw[0] * out_hw[1]
    live = (idx < targets) & (frac[:, 0] > 0)
    runs = torch.bincount(idx[live], minlength=targets)
    covered = int((runs > 0).sum())
    longs = int((runs > splat_cuda.SORT_SHORT_RUN).sum())
    return dict(longest=int(runs.max()), live=int(live.sum()),
                mean=float(live.sum()) / max(covered, 1),
                long_share=longs / targets,
                long_share_covered=longs / max(covered, 1))


def sort_library_ms(values, coords, weights, out_hw, snap, window) -> float:
    """The library yardstick of K1-D: one index_put_(accumulate=True) of
    the prebuilt (4 N P, C + 1) corner payload (ops.splat's
    corner_contributions) under torch.use_deterministic_algorithms(True),
    the same function summed deterministically in one call; CUDA events,
    the payload built outside the timing."""
    base = None if window[0] < 0 else splat_cuda.window_base_rows(
        values.shape[1], out_hw[0], *window).to(values.device)
    idx, contrib = corner_contributions(
        values, coords, weights, out_hw, snap,
        None if base is None else window[0], base)
    out = torch.zeros(values.shape[0] * out_hw[0] * out_hw[1] + 1,
                      contrib.shape[1], device=values.device)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return cuda_ms(lambda: out.index_put_((idx,), contrib,
                                              accumulate=True), iters=10)
    finally:
        torch.use_deterministic_algorithms(before)


def hold_sort(label: str, smi: str, values, coords, weights, out_hw, snap,
              window=(-1, 1, 0)) -> dict:
    """K1-D on one input set: three launches bitwise equal, held to the
    plain sort splat and to K1 (the same function) at phase 3's
    tolerances, timed in turns with the plain version by CUDA events,
    alone by torch.profiler (every kernel of the call, which must be
    splat_sort.cu's or a memset), beside K1's bound and index_put_, with
    the runs it sorts (:func:`sort_runs`)."""
    kw = dict(snap=snap, max_dy=window[0], fold_h=window[1],
              base_offset=window[2])
    base = None if window[0] < 0 else splat_cuda.window_base_rows(
        values.shape[1], out_hw[0], *window).to(values.device)

    def kernel():
        return splat_cuda.splat(values, coords, weights, out_hw,
                                deterministic=True, **kw)

    def plain():
        return splat_bilinear(values, coords, weights, out_hw, snap=snap,
                              max_dy_window=None if base is None
                              else window[0], base_rows=base, method="sort")

    runs = [kernel() for _ in range(3)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for r in runs[1:]
               for a, b in zip(runs[0], r)):
        fail(f"K1-D {label}: three launches are not bitwise equal")
    err = max(check_k1(f"K1-D {label} vs the plain sort splat", runs[0],
                       plain()),
              check_k1(f"K1-D {label} vs K1", runs[0],
                       splat_cuda.splat(values, coords, weights, out_hw,
                                        **kw)))
    del runs
    t, readings = in_turns({"plain": plain, "kernel": kernel}, iters=10)
    dev_us, parts, others = call_device_us(kernel)
    if others or not {"count", "scan", "fill", "sum"} <= set(parts):
        fail(f"K1-D {label}: a call ran {sorted(parts)} and other kernels "
             f"{others}; want splat_sort.cu's kernels and memsets alone")
    runs = sort_runs(coords, out_hw, snap, window)
    bnd = k1_bound(values, coords, weights, out_hw, window)
    lib = sort_library_ms(values, coords, weights, out_hw, snap, window)
    log("timing", f"{smi} | K1-D {label} ({tuple(values.shape)} -> "
        f"{tuple(out_hw)}, window {window}): {1e3 * t['kernel']:.1f} us/call"
        f" {readings['kernel']} (events), plain sort splat "
        f"{1e3 * t['plain']:.1f} us/call {readings['plain']}; index_put_ "
        f"(deterministic, accumulate) {1e3 * lib:.1f} us; bound "
        f"{1e3 * bnd[0]:.1f} us ({bnd[1]}), {100 * bnd[0] / t['kernel']:.0f}%"
        f" of it by events; alone (profiler, every kernel of the call, "
        f"splat_sort.cu's and memsets only) {dev_us:.1f} us: "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f"; runs: {runs['live']} live corners, longest {runs['longest']},"
        f" mean {runs['mean']:.2f} a covered target, "
        f"{100 * runs['long_share']:.3f}% of targets "
        f"({100 * runs['long_share_covered']:.3f}% of covered) longer than "
        f"{splat_cuda.SORT_SHORT_RUN} (the long-run kernel's)"
        f"; three launches bitwise equal; max abs err {err:.3e}")
    return dict(t=t, bound=bnd, err=err, library=lib, device_ms=dev_us / 1e3)


def sort_inputs(dev):
    """Phase 30 (a)'s input sets, recorded from the main paths: the b8
    kitti_ldi2 render's K1 launch, the kitti_ldi3_quality step's full-LDI
    K1 launch, and shard 1 of 4 of the kitti_ldi2 b8 LDI as
    render_forward_spatial builds it (window 2). Also the quality step's
    state and batch, for (c)'s sort-against-scatter step."""
    config = get_config("kitti_ldi2")
    h, w = config.data.height, config.data.width
    model = LSIModel.init(0, config, h, w, device=dev)
    rng = np.random.default_rng(1)
    image = torch.from_numpy(rng.uniform(size=(BATCH, h, w, 3)).astype(
        np.float32)).to(dev)
    pose = translation_pose([[-0.3, 0.0, 0.0]] * BATCH).to(dev)
    with recording() as serve:
        model.render(model.predict_ldi(image), pose)
    del model, image
    cfg = build_config("kitti_ldi3_quality", QUALITY_SETS[:2])
    state = create_state(cfg, seed=0, device=dev)
    batch = next(batch_stream(cfg.data, seed=0, device=dev))
    with recording() as calls:
        make_train_step(cfg)(state, batch)
    full = [c for c in calls["splat_fwd"] if c[0].shape[1] == 3 * h
            and c[2] is not None]
    del calls
    ldi, spose, zscale = spatial_ldi(dev, BATCH)
    hd = ldi.height // SPATIAL_S
    shard = LDI(textures=ldi.textures[:, :, hd:2 * hd],
                disparities=ldi.disparities[:, :, hd:2 * hd],
                intrinsics=ldi.intrinsics)
    shift = global_shift(ldi, spose, zscale)
    with torch.no_grad():
        values, coords, weights, out_hw, window = shard_splat_args(
            shard, spose, None, zscale, hd, SPATIAL_MAX_DY, lambda t: shift)
    sets = [("on the b8 kitti_ldi2 render's own inputs",
             *serve["splat_fwd"][0]),
            ("on the b8 kitti_ldi3_quality step's own inputs (full LDI)",
             *full[0]),
            ("on a height shard's own inputs (shard 1 of 4, window 2)",
             values, coords, weights, out_hw, True, window)]
    return sets, (cfg, state, batch)


def sort_serving(dev, smi: str) -> str:
    """Phase 30 (b): kitti_ldi2 with render.splat_method=sort serves b8
    requests twice (cuDNN deterministic, so that the LDIs repeat); every
    render one K1-D launch and no K1, the two passes bitwise equal."""
    config = get_config("kitti_ldi2")
    config = config.replace(render=dataclasses.replace(
        config.render, splat_method="sort"))
    h, w = config.data.height, config.data.width
    model = LSIModel.init(0, config, h, w, device=dev)
    rng = np.random.default_rng(1)
    images = [torch.from_numpy(rng.uniform(size=(BATCH, h, w, 3)).astype(
        np.float32)).to(dev) for _ in range(SORT_SERVE_REQUESTS)]
    pose = translation_pose([[-0.3, 0.0, 0.0]] * BATCH).to(dev)
    torch.cuda.synchronize()
    reset_counts()
    passes = [with_cudnn_deterministic(lambda: [
        model.render(model.predict_ldi(im), pose) for im in images])
        for _ in range(2)]
    torch.cuda.synchronize()
    launched = (splat_cuda.splat.launches, splat_cuda.splat.sort_launches)
    if launched != (0, 2 * SORT_SERVE_REQUESTS):
        fail(f"sort serving: K1 and K1-D launches {launched} for "
             f"{2 * SORT_SERVE_REQUESTS} renders")
    if not all(torch.equal(a, b) for a, b in zip(*passes)):
        fail("sort serving: two passes over the same requests differ")
    if not all(torch.isfinite(r).all() for r in passes[0]):
        fail("sort serving: non-finite renders")
    ms = cuda_ms(lambda: model.render(model.predict_ldi(images[0]), pose),
                 iters=10)
    return (f"{smi} | kitti_ldi2 b{BATCH} {h}x{w} with "
            f"render.splat_method=sort: {SORT_SERVE_REQUESTS} requests "
            f"served twice, bitwise equal; K1-D launches {launched[1]}, K1 "
            f"{launched[0]}; end-to-end {ms:.3f} ms "
            f"({1e3 * BATCH / ms:.1f} frames/s)"), launched[1]


def sort_training(dev, smi: str, workdir: Path, shards: Path, step_case):
    """Phase 30 (c): the first step's loss parts with "sort" against
    "scatter" on one state and batch; the training CLI on
    kitti_ldi3_quality with render.splat_method=sort from phase 23's
    shards, every render K1-D (no K1 launch), an eval; two renders of the
    trained model's LDI bitwise equal. Returns the summary and K1-D's
    launches."""
    cfg, state, batch = step_case
    sort_cfg = cfg.replace(render=dataclasses.replace(cfg.render,
                                                      splat_method="sort"))
    parts = {name: with_cudnn_deterministic(
        lambda c=c: {k: float(v.detach()) for k, v in
                     loss_and_grads(state, batch, c)[0].items()})
        for name, c in (("scatter", cfg), ("sort", sort_cfg))}
    worst = 0.0
    for k, v in parts["scatter"].items():
        rel = abs(parts["sort"][k] - v) / max(abs(v), 1e-12)
        if rel > SORT_LOSS_RTOL and abs(parts["sort"][k] - v) > 1e-7:
            fail(f"sort step: {k} {parts['sort'][k]} vs scatter {v}")
        worst = max(worst, rel)
    steps = {"plain": make_train_step(cfg), "kernel": make_train_step(sort_cfg)}
    t, readings = in_turns({k: (lambda f=f: f(state, batch))
                            for k, f in steps.items()}, iters=5)
    log("timing", f"{smi} | quality step (full) kitti_ldi3_quality b8 "
        f"{cfg.data.height}x{cfg.data.width}: render.splat_method=sort "
        f"{t['kernel']:.3f} ms {readings['kernel']}, \"scatter\" "
        f"{t['plain']:.3f} ms {readings['plain']} on the same batch, in "
        f"turns; sort / scatter {t['kernel'] / t['plain']:.4f}")
    del state, batch, steps
    torch.cuda.empty_cache()
    ckpt = workdir / "sort_run"
    sets = SORT_SETS + [f"data.root={shards}", f"train.checkpoint_dir={ckpt}"]
    steps = {k: dict(v, splat_fwd=0) for k, v in STEP_LAUNCHES.items()}
    reset_counts()
    trained, _, host = traced_cli(
        "sort", "kitti_ldi3_quality", sets, SORT_PHASES, steps,
        (len(SORT_PHASES),), dict(EVAL_LAUNCHES, splat_fwd=0), 1)
    launched = splat_cuda.splat.sort_launches
    want = sum(SORT_STEP[p] for p in SORT_PHASES) + SORT_EVAL
    if launched != want or splat_cuda.splat.launches:
        fail(f"sort CLI: K1-D launched {launched} (want {want}), K1 "
             f"{splat_cuda.splat.launches}")
    with open(ckpt / "train.jsonl") as f:
        lines = [json.loads(line) for line in f]
    evals = [r for r in lines if "eval_psnr" in r]
    if len(evals) != 1 or not all(np.isfinite(v) for r in lines
                                  for v in r.values()
                                  if isinstance(v, float)):
        fail(f"sort CLI: jsonl {lines}")
    run_cfg = build_config("kitti_ldi3_quality", sets)
    batch = next(batch_stream(run_cfg.data, seed=3, device=dev))
    batch = decode_batch(batch)
    with torch.no_grad():
        ldi = trained.net(batch.src_image, batch.intrinsics)
        renders = [render_forward(ldi, batch.pose_src2trg,
                                  zbuffer_scale=run_cfg.render.zbuffer_scale,
                                  splat_method="sort") for _ in range(2)]
    if not all(torch.equal(renders[0][k], renders[1][k])
               for k in ("rgb", "disparity", "coverage")):
        fail("sort: two renders of the trained model's LDI differ")
    return (f"kitti_ldi3_quality b8: the first step's loss parts with "
            f"render.splat_method=sort within {worst:.2e} of \"scatter\"'s "
            f"on one state and batch (total {parts['sort']['total']:.6f} vs "
            f"{parts['scatter']['total']:.6f}); through the training CLI "
            f"from phase 23's shards: {len(SORT_PHASES)} steps (phases "
            f"{SORT_PHASES}) and an eval, K1-D launches {launched}, K1 0; "
            f"host s a step {secs(host['step'])}; eval_psnr "
            f"{evals[0]['eval_psnr']:.3f}; two renders of the trained LDI "
            "bitwise equal"), launched


def knob_teacher(dev) -> str:
    """Phase 30 (d): the EMA teacher on kitti_ldi3_quality at its widths
    for KNOB_STEPS steps: the teacher after each update equals the ramp's
    formula applied on the card to the recorded parameters, bitwise;
    finite loss parts named as JAX names them."""
    cfg = build_config("kitti_ldi3_quality", QUALITY_SETS[:2] + [
        "loss.consistency_ema_teacher=true"])
    state = create_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg)
    stream = batch_stream(cfg.data, seed=0, device=dev)
    decays, totals = [], []
    for t in range(KNOB_STEPS):
        before = {k: v.clone() for k, v in state.ema_params.items()}
        state, metrics = step(state, next(stream))
        d = trainer_mod.ema_decay(cfg, t)
        keep = float(np.float32(1) - np.float32(d))
        for k, p in state.net.named_parameters():
            if not torch.equal(state.ema_params[k],
                               before[k] * d + p.detach() * keep):
                fail(f"EMA teacher: {k} after step {t + 1} is not the ramp")
        metrics = {k: float(v) for k, v in metrics.items()}
        if set(metrics) != QUALITY_PARTS or not all(
                map(np.isfinite, metrics.values())):
            fail(f"EMA teacher step {t + 1}: {metrics}")
        decays.append(d)
        totals.append(metrics["total"])
    return (f"consistency_ema_teacher: {KNOB_STEPS} steps, the teacher the "
            f"ramp bitwise (d {secs(decays)}), total {secs(totals)}")


def knob_stop(workdir: Path, shards: Path) -> str:
    """Phase 30 (d): consistency_stop_step=2 and photo_layer0_weight=0.1
    through the training CLI from phase 23's shards: the step function
    switches at the stop step (the pseudo-label's launches and part gone,
    the anchor kept), photo_layer0 named both ways."""
    ckpt = workdir / "stop_run"
    sets = STOP_SETS + [f"data.root={shards}", f"train.checkpoint_dir={ckpt}"]
    reset_counts()
    traced_cli("stop", "kitti_ldi3_quality", sets, STOP_PHASES,
               STOP_LAUNCHES, (), EVAL_LAUNCHES, 1)
    with open(ckpt / "train.jsonl") as f:
        lines = [json.loads(line) for line in f if "total" in line]
    names = [set(r) - {"step", "steps_per_sec", "frames_per_sec", "wall_s"}
             for r in lines]
    layer0 = {"photo_layer0", "photo_layer0_rev"}
    want = [QUALITY_PARTS | layer0] * 2 + [
        (QUALITY_PARTS | layer0) - {"depth_consistency"}] * 2
    if names != want or not all(np.isfinite(r["total"]) for r in lines):
        fail(f"stop step: jsonl parts {names}")
    return ("consistency_stop_step=2, photo_layer0_weight=0.1 through the "
            f"training CLI: phases {STOP_PHASES}, depth_consistency at "
            "steps 1-2 only, photo_layer0 "
            + ", ".join(f"{r['photo_layer0']:.5f}" for r in lines)
            + ", total " + ", ".join(f"{r['total']:.5f}" for r in lines))


def knob_deep(dev) -> str:
    """Phase 30 (d): deep_heads_stopgrad_trunk under a loss of deep-layer
    terms alone: every trunk and layer-0 head gradient exactly 0, the deep
    branch's not; then two steps of the quality recipe with the deep
    heads, finite and named as JAX names them."""
    cfg = build_config("kitti_ldi3_quality", DEEP_ONLY_SETS)
    state = create_state(cfg, seed=0, device=dev)
    batch = next(batch_stream(cfg.data, seed=0, device=dev))
    grads = loss_and_grads(state, batch, cfg)[1]
    trunk = [k for k in grads if k.split(".")[0] in ("unet", "disp_head",
                                                     "tex_head")]
    moved = [k for k, g in grads.items() if g.abs().any()]
    if [k for k in trunk if k in moved] or not {
            "deep_trunk.weight", "disp_head_deep.weight"} <= set(moved):
        fail(f"deep heads: gradients on {moved}")
    full = build_config("kitti_ldi3_quality", QUALITY_SETS[:2] + [
        "model.deep_heads_stopgrad_trunk=true"])
    state = create_state(full, seed=0, device=dev)
    step = make_train_step(full)
    totals = []
    for b in (batch, next(batch_stream(full.data, seed=1, device=dev))):
        state, metrics = step(state, b)
        metrics = {k: float(v) for k, v in metrics.items()}
        if set(metrics) != QUALITY_PARTS or not all(
                map(np.isfinite, metrics.values())):
            fail(f"deep heads step: {metrics}")
        totals.append(metrics["total"])
    return (f"deep_heads_stopgrad_trunk: with deep-layer terms alone the "
            f"{len(trunk)} trunk and layer-0 head tensors take exactly 0, "
            f"{len(moved)} deep tensors a gradient; 2 quality steps, total "
            f"{secs(totals)}")


def sort_phase(dev, smi: str, workdir: Path, shards: Path):
    """Phase 30: the deterministic splat and the refuted knobs. Returns
    K1-D's reading for the kernels line (on the b8 render's own inputs,
    its error the largest of the three sets) and its launches on the main
    paths ((b) serving, (c) the CLI run)."""
    t0 = time.perf_counter()
    sets, step_case = sort_inputs(dev)
    readings = [hold_sort(label, smi, *args) for label, *args in sets]
    del sets
    torch.cuda.empty_cache()
    reading = dict(readings[0], replaces="lsi_tpu/ops/splat.py:145",
                   err=max(r["err"] for r in readings))
    summary, served = sort_serving(dev, smi)
    log("sort", summary)
    torch.cuda.empty_cache()
    summary, trained = sort_training(dev, smi, workdir, shards, step_case)
    del step_case
    log("sort", summary)
    torch.cuda.empty_cache()
    log("knobs", knob_teacher(dev))
    torch.cuda.empty_cache()
    log("knobs", knob_stop(workdir, shards))
    torch.cuda.empty_cache()
    log("knobs", knob_deep(dev))
    log("sort", f"phase 30 took {time.perf_counter() - t0:.1f} s")
    return reading, served + trained


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
        spatial_counts = spatial_phase(dev, workdir)
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

        # 26-28: the high-resolution preset, the comparison, the rollback
        # (on phase 24's KITTI layout and phase 23's shards).
        torch.cuda.empty_cache()
        highres_counts = highres_serve(dev, smi)
        torch.cuda.empty_cache()
        trained, highres_kernels = highres_train(dev, smi, workdir)
        highres_counts = {k: highres_counts[k] + trained[k]
                          for k in KERNELS}
        kernels.update(highres_kernels)
        torch.cuda.empty_cache()
        reset_counts()
        compare_phase(smi)
        log("rollback", rollback_phase(dev, workdir))
        compare_counts = counts()

        # 29: the TPU kernels' route (render.use_pallas="on"), the quality
        # recipe from phase 23's shards, serving, the sweep and the MPI.
        torch.cuda.empty_cache()
        route_kernels_read, route_launches = route_phase(
            dev, smi, workdir, workdir / "shards")

        # 30: the deterministic splat (render.splat_method="sort") and the
        # four refuted knobs, from phase 23's shards.
        torch.cuda.empty_cache()
        kernels["splat_sort"], total_sort = sort_phase(
            dev, smi, workdir, workdir / "shards")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name, c in (("shards", shard_counts), ("datasets", dataset_counts),
                    ("comparison and rollback", compare_counts)):
        missing = [k for k in KERNELS if c[k] == 0]
        if missing:
            fail(f"{missing} not launched by the {name} phase")
    if not (highres_counts["splat_fwd"] and highres_counts["splat_vjp"]):
        fail(f"the highres phases launched {highres_counts}")

    total = {name: serve_counts[name] + train_counts[name]
             + quality_counts[name] + mpi_counts[name] + option_counts[name]
             + dp_counts[name] + shard_counts[name] + dataset_counts[name]
             + trajectory_counts[name] + highres_counts[name]
             + compare_counts[name] for name in KERNELS}
    total.update(spatial_counts)
    # The windowed K1 and K2 entries: times on the route step's own
    # full-width inputs (phase 29), errors of phases 19 and 29.
    for name in ("splat_fwd_window", "splat_vjp_window"):
        total[name] += route_launches[name]
        kernels[name] = dict(
            route_kernels_read[name], replaces=kernels[name]["replaces"],
            err=max(kernels[name]["err"], route_kernels_read[name]["err"]))
    for name in ("gather_fwd_window", "gather_bwd_coords_window",
                 "splat_band"):
        if route_launches[name] == 0:
            fail(f"{name} was not launched by the route's main paths")
        total[name] = route_launches[name]
        kernels[name] = route_kernels_read[name]
    if total_sort == 0:
        fail("splat_sort was not launched by phase 30's main paths")
    total["splat_sort"] = total_sort
    total["splat_fwd_highres"] = highres_counts["splat_fwd"]
    total["splat_vjp_highres"] = highres_counts["splat_vjp"]
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
                "splat_band.cu" if name == "splat_band"
                else "splat_sort.cu" if name == "splat_sort"
                else "splat_fwd.cu" if name.startswith("splat_fwd")
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
