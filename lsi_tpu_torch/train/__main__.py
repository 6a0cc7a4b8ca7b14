"""Training CLI:

    python -m lsi_tpu_torch.train --config=kitti_ldi3_quality \
        --set data.dataset=synthetic train.max_steps=20000

PyTorch counterpart of ``lsi_tpu/train/__main__.py``: a named preset plus
dotted ``--set key=value`` overrides. ``--device`` (default ``cuda``)
takes the place of JAX's ``JAX_PLATFORMS``: the run is on the card unless
``--device cpu`` asks for the CPU.

Under ``torchrun`` the run is data-parallel (the ``Trainer`` with a
``parallel.mesh`` plan; ``data.batch_size`` is the global batch):

    torchrun --standalone --nproc_per_node=2 -m lsi_tpu_torch.train \
        --config=kitti_ldi3_quality --dist_backend gloo --set ...

``--dist_backend`` is ``nccl`` (the default on the card: one GPU per
rank) or ``gloo`` (the CPU, or several ranks sharing one GPU).
"""

from __future__ import annotations

import argparse
import os

from lsi_tpu_torch.config import PRESETS, build_config
from lsi_tpu_torch.parallel.mesh import destroy, make_process_plan
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
    ap.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                    help="data-parallel backend under torchrun (default: "
                         "nccl on the card, gloo on the CPU)")
    args = ap.parse_args(argv)
    cfg = build_config(args.config, args.set)
    plan = None
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        plan = make_process_plan(device=args.device,
                                 backend=args.dist_backend)
    if plan is None or plan.is_main:
        print(f"config: {cfg}")
    try:
        state, metrics = Trainer(cfg, device=args.device, plan=plan).train()
    finally:
        if plan is not None:
            destroy(plan)
    if plan is None or plan.is_main:
        print(f"done at step {state.step}: {metrics}")
    return state, metrics


if __name__ == "__main__":
    main()
