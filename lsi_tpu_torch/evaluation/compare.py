"""The LDI against layered planes (MPI) on the same held-out batches.

    python -m lsi_tpu_torch.evaluation.compare [steps] [scene] \
        [--device cpu] [--set KEY=VALUE ...]

PyTorch counterpart of ``scripts/compare_ldi_mpi.py``: train the LDI model
(``synthetic_sanity``, 2 layers) and the MPI baseline (``mpi_baseline``)
for the same number of steps on the same synthetic scene family
(``two_plane`` or ``multi``), evaluate both with
``evaluation.runner.evaluate`` on the same 8 held-out batches (seed 4242)
and print one table of the metrics both report. ``steps`` defaults to
2000, ``scene`` to ``two_plane``; ``--set`` overrides apply to both
presets (toy widths on the CPU); ``--device`` is the card unless ``cpu``
is asked for.

On ``multi`` scenes both presets' ``render.pallas_max_dy`` is widened to
8, as the JAX script does (their pose jitter rotates): the vertical
window of the TPU kernels' route. It changes nothing under the presets'
``render.use_pallas="auto"`` (exact); with ``--set render.use_pallas=on``
it is the window that route renders and gathers with.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Dict, Sequence

from lsi_tpu_torch.config import Config, build_config
from lsi_tpu_torch.device import resolve_device
from lsi_tpu_torch.evaluation.runner import eval_data_config, evaluate
from lsi_tpu_torch.train.trainer import Trainer

#: The two presets, LDI first, with their table headings.
PRESETS = (("synthetic_sanity", "LDI (2-layer)"),
           ("mpi_baseline", "MPI (planes)"))
#: The held-out batches both models are scored on.
EVAL_BATCHES = 8
EVAL_SEED = 4242


def comparison_config(name: str, steps: int, scene: str,
                      overrides: Sequence[str], checkpoint_dir: str
                      ) -> Config:
    """``name`` with ``overrides``, on ``scene`` scenes, training ``steps``
    steps into ``checkpoint_dir`` with no in-training eval and one
    checkpoint at the end (the JAX script's schedule), the window widened
    to 8 rows on ``multi`` scenes (module docstring)."""
    cfg = build_config(name, overrides)
    if scene == "multi":
        cfg = cfg.replace(render=dataclasses.replace(cfg.render,
                                                     pallas_max_dy=8))
    return cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_scene=scene),
        train=dataclasses.replace(
            cfg.train, max_steps=steps, log_every=max(50, steps // 10),
            eval_every=0, checkpoint_every=steps,
            checkpoint_dir=checkpoint_dir))


def compare(steps: int = 2000, scene: str = "two_plane", device="cuda",
            overrides: Sequence[str] = ()) -> Dict[str, dict]:
    """Train and evaluate both presets; ``{name: {"config", "net",
    "metrics"}}``. The runs checkpoint in a temporary directory, removed
    at the end."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="lsi_compare_") as root:
        configs = {name: comparison_config(name, steps, scene, overrides,
                                           f"{root}/{name}_{scene}")
                   for name, _ in PRESETS}
        held_out = {eval_data_config(c.data) for c in configs.values()}
        if len(held_out) != 1:
            raise ValueError(f"the presets' held-out data differ: "
                             f"{held_out}; the comparison needs the same "
                             "batches")
        results = {}
        for name, cfg in configs.items():
            print(f"=== training {name} ({cfg.model.family}) for {steps} "
                  f"steps on {scene} scenes ===", flush=True)
            state, _ = Trainer(cfg, device=device).train()
            metrics = evaluate(cfg, state.net, num_batches=EVAL_BATCHES,
                               seed=EVAL_SEED, device=device)
            print({k: round(v, 4) for k, v in sorted(metrics.items())},
                  flush=True)
            results[name] = {"config": cfg, "net": state.net,
                             "metrics": metrics}
    return results


def table(results: Dict[str, dict]) -> str:
    """One row per metric both models report: name, LDI, MPI."""
    (a, head_a), (b, head_b) = PRESETS
    ma, mb = results[a]["metrics"], results[b]["metrics"]
    lines = [f"{'metric':24s} {head_a:>14s} {head_b:>14s}"]
    for k in sorted(set(ma) & set(mb)):
        lines.append(f"{k:24s} {ma[k]:14.4f} {mb[k]:14.4f}")
    return "\n".join(lines)


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(
        prog="python -m lsi_tpu_torch.evaluation.compare")
    ap.add_argument("steps", nargs="?", type=int, default=2000,
                    help="train steps per model")
    ap.add_argument("scene", nargs="?", default="two_plane",
                    choices=("two_plane", "multi"))
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="dotted overrides applied to both presets")
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)
    results = compare(args.steps, args.scene, args.device, args.set)
    print("\n" + table(results), flush=True)
    return results


if __name__ == "__main__":
    main()
