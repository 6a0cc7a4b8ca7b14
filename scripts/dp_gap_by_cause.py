#!/usr/bin/env python3
"""Where the data-parallel step of kitti_ldi3_quality departs from the
one-process step on the card, and what a wrong reduction would read.

    python scripts/dp_gap_by_cause.py [--device cuda] [--repeats 3]
                                      [--out FILE]

At the preset's widths (256x768, global batch 8, multi-object synthetic
scenes, random weights from seed 0, float32 with TF32 off), for the
quality graph and for the same graph without the consistency terms, and
with cuDNN free to choose its algorithms and with
``cudnn.deterministic``, it reads the step-1 gradient of:

* the one-process step, ``--repeats`` times (the first is the reference;
  the others give its run-to-run spread: K1's atomics, ROADMAP H8/H13);
* one process whose network runs on each rank's half of the batch and
  whose loss takes the whole batch (the ranks' convolution shapes
  without the reduction);
* the 2-rank data-parallel step (``parallel.launch.train_steps`` over
  gloo ranks sharing the card), twice;
* three wrong reductions: the mean of the per-rank ratio losses and
  their gradients (what averaging per-rank gradients computes), the
  gradients averaged instead of summed, and one rank's gradient with no
  all-reduce.

Each against the reference: the loss parts' largest relative gap, the
gradients' cosine, norm ratio - 1, and largest absolute difference over
the largest entry (with its parameter). ``chip_smoke.py`` phase 21 holds
the data-parallel step to bounds set from these readings.

``--device cpu`` checks the script at toy widths (no card needed).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from lsi_tpu_torch.config import build_config  # noqa: E402
from lsi_tpu_torch.data.pipeline import Batch, batch_stream  # noqa: E402
from lsi_tpu_torch.parallel import launch  # noqa: E402
from lsi_tpu_torch.parallel.mesh import ProcessPlan  # noqa: E402
from lsi_tpu_torch.train import trainer  # noqa: E402

GRAPHS = {
    "quality": [],
    "no-consistency": ["loss.consistency_weight=0",
                       "loss.consistency_anchor_weight=0"],
}
TOY = ["model.base_filters=8", "model.num_scales=2", "data.height=32",
       "data.width=64", "data.batch_size=4"]


def set_numerics(deterministic: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = False


def step1(res) -> tuple:
    """(loss parts, summed gradient, this rank's gradient) of step 1."""
    return res["metrics"][0], res["grads"], res["local_grads"]


def one_process(cfg, params, arrays, dev, sl=slice(None), shares=1):
    """Step 1 of one process on ``arrays[sl]``, the network run on
    ``shares`` parts of the batch (``launch.per_share_forward``)."""
    return step1(launch.train_steps(
        ProcessPlan(device=dev), cfg, params,
        [{k: v[sl] for k, v in arrays.items()}], tf32=False,
        deterministic=torch.backends.cudnn.deterministic, net_shares=shares))


def reading(parts, grads, ref_parts, ref_grads) -> dict:
    names = list(ref_grads)
    g = np.concatenate([grads[k].ravel() for k in names]).astype(np.float64)
    w = np.concatenate([ref_grads[k].ravel() for k in names]).astype(
        np.float64)
    diff = {k: float(np.abs(grads[k] - ref_grads[k]).max()) for k in names}
    at = max(diff, key=diff.get)
    loss = max(abs(parts[k] - v) / max(abs(v), 1e-12)
               for k, v in ref_parts.items() if k != "grad_norm")
    return {"loss_rel": loss,
            "cosine": float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w))),
            "norm_rel": float(np.linalg.norm(g) / np.linalg.norm(w) - 1.0),
            "max_abs_of_largest": diff[at] / float(np.abs(w).max()),
            "at": at}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the readings as JSON")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    toy = TOY if dev.type == "cpu" else []
    work = Path(tempfile.mkdtemp(prefix="dp_gap_"))
    rows = []
    for graph, extra in GRAPHS.items():
        cfg = build_config("kitti_ldi3_quality", [
            "data.dataset=synthetic", "data.synthetic_scene=multi",
            "loss.consistency_start_step=0", "model.compute_dtype=float32",
            *extra, *toy])
        b = next(batch_stream(cfg.data, seed=0, device="cpu"))
        arrays = {f.name: getattr(b, f.name).numpy()
                  for f in dataclasses.fields(Batch)
                  if getattr(b, f.name) is not None}
        params = {k: v.numpy().copy() for k, v in trainer.create_state(
            cfg, seed=0, device="cpu").net.state_dict().items()}
        n = cfg.data.batch_size
        for det in (False, True):
            set_numerics(det)
            ref = one_process(cfg, params, arrays, dev)[:2]

            def row(kind, parts, grads):
                r = dict(graph=graph, deterministic=det, kind=kind,
                         **reading(parts, grads, *ref))
                rows.append(r)
                print(json.dumps(r), flush=True)

            for _ in range(args.repeats - 1):
                row("sound: one process again", *one_process(
                    cfg, params, arrays, dev)[:2])
            for _ in range(2):
                row("sound: one process, network on the rank halves",
                    *one_process(cfg, params, arrays, dev, shares=2)[:2])
            for i in range(2):
                ranks = [step1(r) for r in launch.spawn(
                    launch.train_steps, 2, cfg, params, [arrays], True,
                    False, det, init_file=work / f"store_{graph}_{det}_{i}",
                    device=str(dev), backend="gloo", timeout_s=300)]
                row("sound: 2 ranks (rank 0)", ranks[0][0], ranks[0][1])
            half = [one_process(cfg, params, arrays, dev, slice(0, n // 2)),
                    one_process(cfg, params, arrays, dev, slice(n // 2, n))]
            row("fault: mean of per-rank ratios",
                {k: (half[0][0][k] + half[1][0][k]) / 2 for k in ref[0]},
                {k: (half[0][1][k] + half[1][1][k]) / 2 for k in ref[1]})
            row("fault: gradients averaged, not summed", ranks[0][0],
                {k: v / 2 for k, v in ranks[0][1].items()})
            row("fault: no gradient all-reduce (rank 0)", ranks[0][0],
                ranks[0][2])
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
