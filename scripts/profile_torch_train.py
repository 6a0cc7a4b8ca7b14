"""Where a training step's time goes on the card: torch.profiler over a few
steps of the port's ``make_train_step``, device time split by kernel name.

    python scripts/profile_torch_train.py [--config kitti_ldi3_b16]
        [--batch 16] [--steps 5] [--trace train_trace.json]

Runs the preset at its published widths on two-plane synthetic scenes
(``data.dataset="synthetic"``; params from seed 0), three warm-up steps,
then profiles ``--steps`` steps of one batch. Prints the card's name and
power limit, wall ms per step (host clock, synchronised), device-busy ms
per step (the union of kernel intervals), the idle share, kernel and host
time in each of the step's profiler ranges (forward and loss, backward,
optimizer), kernel time by kind, the hand-written kernels' ms per step
and launches, and the kernels with the most device time. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lsi_tpu_torch.config import get_config  # noqa: E402
from lsi_tpu_torch.data.pipeline import batch_stream  # noqa: E402
from lsi_tpu_torch.kernels import build  # noqa: E402
from lsi_tpu_torch.train.trainer import (create_state,  # noqa: E402
                                         make_train_step)

# Name fragments of the port's own kernels (csrc/*.cu).
OWN_KERNELS = ("splat_fwd_kernel", "splat_vjp_kernel", "gather_fwd_kernel",
               "gather_bwd_coords_kernel")
# Kinds of kernel by name fragment; the first that matches wins.
GROUPS = (
    ("own kernels K1-K4", OWN_KERNELS),
    ("cuDNN layout conversions", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions", ("xmma", "implicit_gemm", "cudnn", "conv")),
    ("GroupNorm", ("GroupNorm", "RowwiseMoments", "ComputeInternalGradients",
                   "ComputeFusedParams", "group_norm")),
    ("dtype and layout copies", ("copy_kernel", "CatArrayBatchedCopy")),
    ("reductions", ("reduce_kernel",)),
    ("index ops (plain gathers, index_add)", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise",)),
    ("other", ()),
)


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="kitti_ldi3_b16")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--top", type=int, default=30)
    parser.add_argument("--trace", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    for name in build.LIBRARIES:
        build.load(name)

    cfg = get_config(args.config)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, dataset="synthetic", batch_size=args.batch))
    state = create_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg)
    batch = next(batch_stream(cfg.data, seed=0, device=dev))
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)

    # Device-side events: the kernels, and the train step's profiler ranges
    # (train_step/forward_loss, /backward, /optimizer) as device spans.
    per_name = collections.defaultdict(lambda: [0.0, 0])
    intervals, spans = [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        r = evt.time_range
        if evt.name.startswith("train_step/"):
            spans.append((r.start, r.end, evt.name))
            continue
        intervals.append((r.start, r.end))
        per_name[evt.name][0] += r.elapsed_us()
        per_name[evt.name][1] += 1
    kernel_ms = sum(v[0] for v in per_name.values()) / 1e3 / args.steps
    busy_ms = busy_us(intervals) / 1e3 / args.steps
    print(f"{smi} | {args.config} b{args.batch} "
          f"{cfg.data.height}x{cfg.data.width} "
          f"({cfg.model.compute_dtype}), {args.steps} profiled steps")
    print(f"wall {wall:.3f} ms/step under the profiler; device busy "
          f"{busy_ms:.3f} ms/step (kernel time summed {kernel_ms:.3f}); "
          f"idle share {1 - busy_ms / wall:.3f}")
    if not intervals:
        print("the profiler recorded no device time")
        return

    def per_step(us):
        return us / 1e3 / args.steps

    by_span = collections.Counter()
    for start, end in intervals:
        owner = [n for s_, e_, n in spans if s_ <= start < e_]
        by_span[owner[0] if owner else "(outside the ranges)"] += end - start
    print("kernel time by range (ms/step): " + ", ".join(
        f"{n} {per_step(us):.3f}" for n, us in sorted(by_span.items())))
    print("host time by range (ms/step): " + ", ".join(
        f"{e.key} {per_step(e.cpu_time_total):.3f}"
        for e in prof.key_averages() if e.key.startswith("train_step/")))
    by_group = collections.Counter()
    for name, (us, _) in per_name.items():
        by_group[next(g for g, frags in GROUPS
                      if not frags or any(f in name for f in frags))] += us
    print("kernel time by kind (ms/step, share): " + "; ".join(
        f"{g} {per_step(us):.3f} ({per_step(us) / kernel_ms:.1%})"
        for g, us in by_group.most_common()))
    for frag in OWN_KERNELS:
        us = sum(v[0] for k, v in per_name.items() if frag in k)
        n = sum(v[1] for k, v in per_name.items() if frag in k)
        print(f"own kernel {frag}: {per_step(us):.3f} ms/step, "
              f"{n / args.steps:g} launches/step")
    print("top kernels by device time (ms/step, share, launches/step):")
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in ranked[:args.top]:
        print(f"  {per_step(us):8.3f}  {per_step(us) / kernel_ms:6.1%}  "
              f"{n / args.steps:6g}  {name[:150]}")


if __name__ == "__main__":
    main()
