#!/usr/bin/env python3
"""How far lsi_splat_vjp departs from autograd through the plain splat on a
training step's own cotangents, against float32's rounding bound.

    python scripts/splat_vjp_rounding.py [--device cuda] [--steps 6]
                                         [--out FILE]

Trains synthia_ldi2_splat at its preset's widths (L=2, b8, 256x768, bf16,
random weights from seed 0) from a generated SYNTHIA-SEQS layout
(``lsi_tpu_torch.data.layouts``, 760x1280) and records every step's
lsi_splat_vjp inputs and cotangents. For each step and each gradient
(d_values, d_coords, d_weights) it prints the elements beyond
``chip_smoke.py``'s VJP_RTOL and VJP_ATOL_OF_MAX alone, the elements
beyond them plus the rounding slack 2 gamma_n T
(``chip_smoke.splat_vjp_slack``), the largest error over its slack, and
at the largest error: the error, the reference and T. Two planted faults
(the plain VJP with the coordinates moved by 1/256 px, and with g_wsum
scaled by 1 + 1e-3) must fail the bound with the slack.

``--device cpu`` checks the script at toy widths (no card needed; the
wrapper there runs the plain VJP, so every error reads 0).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from lsi_tpu_torch.config import build_config  # noqa: E402
from lsi_tpu_torch.data import layouts  # noqa: E402
from lsi_tpu_torch.data.pipeline import make_dataset  # noqa: E402
from lsi_tpu_torch.kernels import splat_cuda  # noqa: E402
from lsi_tpu_torch.train.trainer import create_state, make_train_step  # noqa: E402

TOY = ["model.base_filters=8", "model.num_scales=2", "data.height=32",
       "data.width=64", "data.batch_size=2"]


def beyond(got, ref, slack=None) -> torch.Tensor:
    """Where ``got`` lies beyond VJP_RTOL and VJP_ATOL_OF_MAX of ``ref``
    (plus ``slack``)."""
    allowed = (cs.VJP_ATOL_OF_MAX * ref.abs().max()
               + cs.VJP_RTOL * ref.abs())
    if slack is not None:
        allowed = allowed + slack
    return (got - ref).abs() > allowed


def read(values, coords, weights, g_accum, g_wsum, out_hw) -> dict:
    """The kernel against the plain VJP on one step's inputs."""
    ref = splat_cuda._plain_vjp(values, coords, weights, g_accum, g_wsum,
                                out_hw, (True, True, True))
    got = splat_cuda.splat_vjp(values, coords, weights, g_accum, g_wsum,
                               out_hw)
    slack = cs.splat_vjp_slack(values, coords, weights, g_accum, g_wsum,
                               out_hw)
    out = {}
    for name, g, r, s in zip(("d_values", "d_coords", "d_weights"), got,
                             ref, slack):
        err = (g - r).abs()
        old = beyond(g, r)
        worst = int(err.argmax())
        t = s.flatten()[worst].item() / (
            2 * cs.splat_vjp_gamma(values.shape[-1]))
        out[name] = dict(
            beyond_rtol_atol=int(old.sum()),
            beyond_with_slack=int(beyond(g, r, s).sum()),
            max_err_over_slack=(err[old] / s[old]).max().item()
            if old.any() else 0.0,
            max_err=err.max().item(), ref_there=r.flatten()[worst].item(),
            terms_there=t, max_ref=r.abs().max().item())
    planted = {
        "coords + 1/256 px": splat_cuda._plain_vjp(
            values, coords + 1 / 256, weights, g_accum, g_wsum, out_hw,
            (True, True, True)),
        "g_wsum * (1 + 1e-3)": splat_cuda._plain_vjp(
            values, coords, weights, g_accum, g_wsum * (1 + 1e-3), out_hw,
            (True, True, True))}
    out["planted"] = {k: sum(int(beyond(g, r, s).sum())
                             for g, r, s in zip(got, v, slack))
                      for k, v in planted.items()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    toy = args.device == "cpu"
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        layouts.write_synthia_seqs(tmp, frames=4 if toy else 16,
                                   hw=(64, 128) if toy else
                                   layouts.SYNTHIA_HW, workers=0 if toy
                                   else 8)
        cfg = build_config("synthia_ldi2_splat",
                           [f"data.root={tmp}"] + (TOY if toy else []))
        state = create_state(cfg, seed=0, device=args.device)
        step = make_train_step(cfg)
        it = make_dataset(cfg.data, seed=0, device=args.device)
        try:
            for i in range(args.steps):
                batch = next(it)
                with cs.recording() as calls:
                    state, metrics = step(state, batch)
                del batch
                for rec in calls["splat_vjp"]:
                    row = dict(step=i + 1, total=float(metrics["total"]),
                               **read(*rec))
                    print(json.dumps(row), flush=True)
                    rows.append(row)
                del calls
        finally:
            it.close()
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
