"""Training CLI:

    python -m lsi_tpu_torch.train --config=kitti_ldi3_quality \
        --set data.dataset=synthetic train.max_steps=20000

PyTorch counterpart of ``lsi_tpu/train/__main__.py``: a named preset plus
dotted ``--set key=value`` overrides. ``--device`` (default ``cuda``)
takes the place of JAX's ``JAX_PLATFORMS``: the run is on the card unless
``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse

from lsi_tpu_torch.config import PRESETS, build_config
from lsi_tpu_torch.train.trainer import Trainer


def main(argv=None):
    """Train; returns ``(state, last metrics)``."""
    ap = argparse.ArgumentParser(prog="python -m lsi_tpu_torch.train")
    ap.add_argument("--config", default="kitti_ldi2",
                    help=f"preset: {sorted(PRESETS)}")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="dotted config overrides, e.g. train.max_steps=100")
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)
    cfg = build_config(args.config, args.set)
    print(f"config: {cfg}")
    state, metrics = Trainer(cfg, device=args.device).train()
    print(f"done at step {state.step}: {metrics}")
    return state, metrics


if __name__ == "__main__":
    main()
