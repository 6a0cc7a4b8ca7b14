"""Where the card's step-1 gradients of the two-prediction (quality) loss
part from the CPU's, on the golden quality fixture.

    python scripts/quality_grad_by_part.py [--device cuda] [--out FILE]
    python scripts/quality_grad_by_part.py --device cpu

Reads tests/data/torch_golden_quality_toy.npz
(scripts/make_torch_golden_quality.py): the toy cut of kitti_ldi3_quality
(2x32x64, float32), its initial params, batch 0 and JAX's eager step-1
gradients. With TF32 off it takes the gradient of each summed loss part
(and of ``total``) at those params, with the port:

* ``cpu``: on the CPU (the plain splat and gather);
* ``card``, ``card again``: on ``--device`` twice (the kernels; K1 sums
  float atomics in no fixed order, ROADMAP H8);
* ``card, plain kernels``: on ``--device`` with the plain splat and
  gather in place of the kernels;

and prints, for each pair, each part's largest gradient difference as a
fraction of the largest fixture gradient, with the parameter where it
sits. Then the loss alone, with the network out of the way:

* on the LDI pair the card predicted, card vs CPU: the difference of the
  loss's gradients with respect to that LDI;
* on the CPU, at the LDI pair the CPU predicted and at the card's: each
  part's gradient with respect to the LDI, and the discrete decisions the
  two LDIs take differently: splat and gather coordinates in another
  pixel (floor) or snap zone (ROADMAP H10), and target pixels whose
  splat weight crosses 0 or the 1e-30 floor (``coverage > 0``, the
  disocclusion mask ``coverage <= 0``, ``wsum > 1e-30``);
* on the CPU, how far each part's gradient with respect to the LDI moves
  when the LDI moves by uniform noise of ``--perturb`` (the size of the
  card's difference), with the consistency terms as they are and with
  their target pixels of splat weight at most F dropped, F = 1e-6, 1e-3,
  1e-2: where the steepness sits.

``--out`` writes the numbers as JSON. ``--device cpu`` runs every variant
on the CPU, where the "card" LDI is the CPU's plus that noise (a check of
the script).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lsi_tpu_torch.config import Config  # noqa: E402
from lsi_tpu_torch.data.pipeline import Batch, decode_batch  # noqa: E402
from lsi_tpu_torch.geometry import ldi as ldi_mod  # noqa: E402
from lsi_tpu_torch.geometry.ldi import LDI  # noqa: E402
from lsi_tpu_torch.kernels import gather_cuda, splat_cuda  # noqa: E402
from lsi_tpu_torch.losses import losses  # noqa: E402
from lsi_tpu_torch.models.convert import state_dict_from_jax  # noqa: E402
from lsi_tpu_torch.ops.splat import MIN_FRACTION  # noqa: E402
from lsi_tpu_torch.train.trainer import (apply_model_pair,  # noqa: E402
                                         create_state)

GOLDEN_QUALITY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              os.pardir, "tests", "data",
                              "torch_golden_quality_toy.npz")
LDI_NAMES = ("src textures", "src disparities", "trg textures",
             "trg disparities")


def load_fixture():
    with np.load(GOLDEN_QUALITY) as g:
        golden = {k: g[k] for k in g.files}

    def section(prefix):
        return {k[len(prefix):]: v for k, v in golden.items()
                if k.startswith(prefix)}

    cfg = Config.from_dict(json.loads(bytes(golden["__config__"]).decode()))
    return (cfg, state_dict_from_jax(section("params/"), cfg.model),
            section("batch0/"),
            state_dict_from_jax(section("step1_grads/"), cfg.model))


def loss_parts(cfg, pred, pred_trg, arrays, dev):
    """The summed parts of the two-prediction loss (and ``total``)."""
    b = decode_batch(Batch(**{k: torch.from_numpy(v).to(dev)
                              for k, v in arrays.items()}))
    parts = losses.total_loss_bidirectional(
        pred, pred_trg, b.src_image, b.trg_image, b.pose_src2trg, cfg.loss,
        cfg.render, gt_disparity=b.gt_disparity, gt_valid=b.gt_valid)
    return {k: v for k, v in parts.items()
            if not k.startswith("window_dropped_frac")}


def grads_by_part(cfg, params, arrays, dev):
    """({part: {param: grad}}, the predicted LDI pair), on the CPU."""
    state = create_state(cfg, device=dev)
    state.net.load_state_dict(params)
    b = decode_batch(Batch(**{k: torch.from_numpy(v).to(dev)
                              for k, v in arrays.items()}))
    pred, pred_trg = apply_model_pair(state.net, b.src_image, b.trg_image,
                                      b.intrinsics)
    parts = loss_parts(cfg, pred, pred_trg, arrays, dev)
    named = list(state.net.named_parameters())
    out = {}
    for name, value in parts.items():
        grads = torch.autograd.grad(value, [p for _, p in named],
                                    retain_graph=True, allow_unused=True)
        out[name] = {k: (torch.zeros_like(p) if g is None else g).cpu()
                     for (k, p), g in zip(named, grads)}
    ldi = [t.detach().cpu().clone()
           for t in (pred.textures, pred.disparities, pred_trg.textures,
                     pred_trg.disparities, pred.intrinsics)]
    return out, ldi


def ldi_grads_by_part(cfg, ldi, arrays, dev):
    """{part: [d part / d each LDI tensor]} at a fixed LDI pair, on
    ``dev``."""
    leaves = [t.clone().to(dev).requires_grad_() for t in ldi[:4]]
    k = ldi[4].to(dev)
    pred = LDI(textures=leaves[0], disparities=leaves[1], intrinsics=k)
    pred_trg = LDI(textures=leaves[2], disparities=leaves[3], intrinsics=k)
    parts = loss_parts(cfg, pred, pred_trg, arrays, dev)
    out = {}
    for name, value in parts.items():
        grads = torch.autograd.grad(value, leaves, retain_graph=True,
                                    allow_unused=True)
        out[name] = [(torch.zeros_like(t) if g is None else g).cpu()
                     for t, g in zip(leaves, grads)]
    return out


@contextlib.contextmanager
def plain_kernels():
    """The plain splat and gather on every device."""
    saved = splat_cuda.check_device, gather_cuda.check_device
    splat_cuda.check_device = gather_cuda.check_device = lambda d: False
    try:
        yield
    finally:
        splat_cuda.check_device, gather_cuda.check_device = saved


@contextlib.contextmanager
def recording():
    """Record every render splat (coordinates, output weight) and gather
    (coordinates) made inside, in call order."""
    calls = []
    splat_fn, gather_fn = ldi_mod.SplatFn, ldi_mod.GatherFn

    class RecordSplat:
        @staticmethod
        def apply(values, coords, weights, out_hw, *route):
            accum, wsum = splat_fn.apply(values, coords, weights, out_hw,
                                         *route)
            calls.append(("splat", coords.detach().cpu(), tuple(out_hw),
                          wsum.detach().cpu()))
            return accum, wsum

    class RecordGather:
        @staticmethod
        def apply(image, coords, *route):
            calls.append(("gather", coords.detach().cpu(),
                          tuple(image.shape[1:3]), None))
            return gather_fn.apply(image, coords, *route)

    ldi_mod.SplatFn, ldi_mod.GatherFn = RecordSplat, RecordGather
    try:
        yield calls
    finally:
        ldi_mod.SplatFn, ldi_mod.GatherFn = splat_fn, gather_fn


@contextlib.contextmanager
def consistency_weight_floor(floor: float):
    """``depth_consistency`` (the pseudo-label and the anchor) with its
    rendered splat weight cut to 0 at or below ``floor``, which drops those
    target pixels from its mask (the disocclusion mask is untouched)."""
    consistency, render = losses.depth_consistency, losses.render_forward

    def floored_render(*args, **kwargs):
        out = render(*args, **kwargs)
        keep = out["coverage"] > floor
        return {**out, "coverage": out["coverage"] * keep,
                "disparity": out["disparity"] * keep}

    def floored(*args, **kwargs):
        losses.render_forward = floored_render
        try:
            return consistency(*args, **kwargs)
        finally:
            losses.render_forward = render

    losses.depth_consistency = floored
    try:
        yield
    finally:
        losses.depth_consistency = consistency


def flips(a, b):
    """Per call, the decisions two recordings take differently:
    coordinates (with a corner in the image) in another pixel or snap
    zone, and target pixels whose weight crosses 0 or 1e-30."""
    def zone(c, f):
        frac = c - f
        return (frac < MIN_FRACTION) | (frac > 1 - MIN_FRACTION)

    rows = []
    for (kind, ca, hw, wa), (_, cb, _, wb) in zip(a, b):
        h, w = hw
        inside = ((ca[..., 0] > -1) & (ca[..., 0] < w)
                  & (ca[..., 1] > -1) & (ca[..., 1] < h))
        fa, fb = torch.floor(ca), torch.floor(cb)
        row = {"kind": kind, "shape": list(ca.shape[:3]),
               "inside": int(inside.sum()),
               "max_abs_diff": float((ca - cb)[inside].abs().max())
               if inside.any() else 0.0,
               "floor": int(((fa != fb).any(-1) & inside).sum()),
               "snap_zone": 0, "wsum>0": 0, "wsum>1e-30": 0}
        if kind == "splat":
            row["snap_zone"] = int(((zone(ca, fa) != zone(cb, fb)).any(-1)
                                    & inside).sum())
            row["wsum>0"] = int(((wa > 0) != (wb > 0)).sum())
            row["wsum>1e-30"] = int(((wa > 1e-30) != (wb > 1e-30)).sum())
        rows.append(row)
    return rows


def compare(a, b, g_max):
    """{part: (largest difference / g_max, parameter)}."""
    out = {}
    for part in a:
        k, err = max(((k, float((a[part][k] - b[part][k]).abs().max()))
                      for k in a[part]), key=lambda kv: kv[1])
        out[part] = (err / g_max, k)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--perturb", type=float, default=2e-6,
                        help="the size of the uniform noise added to the "
                        "LDI in the sensitivity section (and, with --device "
                        "cpu, to the LDI that stands in for the card's)")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA card (or --device cpu)")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True,
                             capture_output=True, text=True).stdout.strip()
        print(smi)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    cfg, params, arrays, fixture = load_fixture()
    g_max = max(float(v.abs().max()) for v in fixture.values())

    runs = {}
    runs["cpu"], ldi_cpu = grads_by_part(cfg, params, arrays, cpu)
    runs["card"], ldi_card = grads_by_part(cfg, params, arrays, dev)
    runs["card again"], _ = grads_by_part(cfg, params, arrays, dev)
    with plain_kernels():
        runs["card, plain kernels"], _ = grads_by_part(cfg, params, arrays,
                                                       dev)
    gen = torch.Generator().manual_seed(0)
    ldi_noisy = [t + args.perturb * (2 * torch.rand(t.shape, generator=gen)
                                     - 1) for t in ldi_cpu[:4]] + ldi_cpu[4:]
    if dev.type == "cpu":
        ldi_card = ldi_noisy
    report = {"largest fixture |grad|": g_max, "pairs": {}}
    for name in ("cpu", "card"):
        err, leaf = compare({"total": runs[name]["total"]},
                            {"total": fixture}, g_max)["total"]
        report["pairs"][f"{name} vs fixture (JAX eager)"] = {
            "total": [err, leaf]}
    for a, b in (("card", "cpu"), ("card again", "card"),
                 ("card, plain kernels", "cpu"),
                 ("card", "card, plain kernels")):
        report["pairs"][f"{a} vs {b}"] = {
            part: list(v) for part, v in compare(runs[a], runs[b],
                                                 g_max).items()}
    for pair, parts in report["pairs"].items():
        print(f"{pair} (largest difference / largest fixture |grad| "
              f"{g_max:.3e}):")
        for part, (err, leaf) in sorted(parts.items(),
                                        key=lambda kv: -kv[1][0]):
            print(f"  {part:24s} {err:.3e}  at {leaf}")

    report["LDI card vs cpu"] = {
        name: float((a - b).abs().max())
        for name, a, b in zip(LDI_NAMES, ldi_card, ldi_cpu)}
    print("the predicted LDI, card vs cpu, max abs: " + ", ".join(
        f"{n} {v:.3e}" for n, v in report["LDI card vs cpu"].items()))

    # The loss alone on the card's LDI, card vs CPU.
    on_dev = ldi_grads_by_part(cfg, ldi_card, arrays, dev)["total"]
    on_cpu = ldi_grads_by_part(cfg, ldi_card, arrays, cpu)["total"]
    key = "loss alone on the card's LDI, card vs cpu"
    report[key] = {}
    for name, a, b in zip(LDI_NAMES, on_dev, on_cpu):
        err, ref = float((a - b).abs().max()), float(b.abs().max())
        report[key][name] = [err, ref]
        print(f"{key}, d total / d {name}: {err:.3e} (largest {ref:.3e})")

    # The loss alone on the CPU, at the CPU's LDI and at the card's.
    with recording() as rec_cpu:
        at_cpu = ldi_grads_by_part(cfg, ldi_cpu, arrays, cpu)
    with recording() as rec_card:
        at_card = ldi_grads_by_part(cfg, ldi_card, arrays, cpu)
    ref = max(float(g.abs().max()) for g in at_cpu["total"])
    key = "loss alone on the cpu, card's LDI vs cpu's"
    report[key] = {"largest |d total / d LDI|": ref}
    errs = {part: max(float((a - b).abs().max())
                      for a, b in zip(at_card[part], at_cpu[part]))
            for part in at_cpu}
    print(f"{key}: largest difference of d part / d LDI, over the largest "
          f"|d total / d LDI| {ref:.3e}:")
    for part, err in sorted(errs.items(), key=lambda kv: -kv[1]):
        report[key][part] = err
        print(f"  {part:24s} {err / ref:.3e}")
    rows = flips(rec_card, rec_cpu)
    report["decisions, card's LDI vs cpu's"] = rows
    print("decisions taken differently at the card's LDI and the cpu's, "
          "per render splat and gather (in call order):")
    print("  kind   shape        inside  max|dcoord|  floor  snap  "
          "wsum>0  wsum>1e-30")
    for r in rows:
        print(f"  {r['kind']:6s} {str(r['shape']):12s} {r['inside']:6d}  "
              f"{r['max_abs_diff']:.3e}  {r['floor']:5d} "
              f"{r['snap_zone']:5d} {r['wsum>0']:7d} {r['wsum>1e-30']:11d}")

    # Where the steepness sits: the CPU's LDI against itself plus noise.
    key = f"sensitivity on the cpu to LDI noise of {args.perturb:g}"
    report[key] = {}
    print(f"{key}: largest difference of d part / d LDI (absolute), with "
          "the consistency terms' target pixels of splat weight <= F "
          "dropped:")
    for floor in (0.0, 1e-6, 1e-3, 1e-2):
        with consistency_weight_floor(floor):
            at_cpu = ldi_grads_by_part(cfg, ldi_cpu, arrays, cpu)
            at_noisy = ldi_grads_by_part(cfg, ldi_noisy, arrays, cpu)
        row = {part: [max(float((a - b).abs().max())
                          for a, b in zip(at_noisy[part], at_cpu[part])),
                      max(float(a.abs().max()) for a in at_cpu[part])]
               for part in at_cpu}
        report[key][f"F={floor:g}"] = row
        print(f"  F = {floor:g}: " + ", ".join(
            f"{part} {d:.2e} (largest {m:.2e})"
            for part, (d, m) in sorted(row.items(),
                                       key=lambda kv: -kv[1][0])
            if part in ("total", "depth_consistency", "depth_anchor",
                        "photo_splat", "photo_splat_rev")))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
