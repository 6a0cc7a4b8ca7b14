"""How far the port's step-1 gradients on the TPU kernels' route
(``render.use_pallas="on"``) lie from the JAX package's interpret-mode
kernels, over several seeds, and how far planted faults in the gather
move them: the readings behind the route golden's gradient bounds
(``tests/test_torch_pallas_route.py``, ``chip_smoke.py`` phase 29).

Two modes:

    JAX_PLATFORMS=cpu python scripts/route_golden_spread.py make \\
        --seeds 0 1 2 3 4 5 --out _scratch/route_spread.npz

runs the JAX package on the CPU with its Pallas kernels in interpret mode
(``LSI_TPU_FORCE_PALLAS=1``, a few minutes) and stores, per recipe (the
toy ``kitti_ldi3_quality`` and ``mpi_baseline`` cuts of
``make_torch_golden_pallas.py``) and seed, the starting parameters
(``create_state`` at that seed), the first batch of the seed's synthetic
stream (the MPI's poses tilted as that script tilts them) and the step-1
gradients, both through the interpret-mode kernels and through JAX's
route with the two kernels replaced by their lax equivalents (the
windowed lax splat, and its transpose for the gather, as
``tests/test_torch_pallas_route.py`` does). Seed 0 is the committed
fixture's step.

    python scripts/route_golden_spread.py read _scratch/route_spread.npz \\
        [--device cpu]

runs the port only (no JAX; on the card unless ``--device cpu``: float32,
TF32 off, cuDNN deterministic) and prints, per recipe, seed and fault,
the largest gradient error as a fraction of the largest entry of JAX's
interpret-mode gradients, and beside it how far JAX's own lax-equivalent
route lies from them and how far the port lies from that route. The
faults are planted in the port's gather by patching its wrapper:

* ``d_image unsnapped``: the image cotangent splatted without the
  fraction snap (windowed still);
* ``d_coords unsnapped``: the coordinate cotangent of the windowed gather
  with unsnapped fractions (plain version), so a fraction in a snap zone
  keeps its gradient;
* ``d_coords unwindowed``: the coordinate cotangent of the exact gather;
* ``gather window + 1``: every windowed gather one row wider (forward
  and backward);
* ``splat VJP unwindowed``: the windowed splat's backward (K2) taken
  without its window.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import sys
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

RECIPES = ("quality", "mpi")


def lax_route():
    """JAX's route with its Pallas kernels replaced by their lax
    equivalents, as a context manager."""
    import importlib

    import jax
    import jax.numpy as jnp

    from lsi_tpu.ops.splat import splat_bilinear

    # ``lsi_tpu.kernels`` exports functions of the same names as its
    # modules.
    splat_pallas = importlib.import_module("lsi_tpu.kernels.splat_pallas")
    gather_pallas = importlib.import_module("lsi_tpu.kernels.gather_pallas")

    def splat_window(values, coords, weights, out_hw, max_dx, max_dy,
                     block_rows, fold_h=None, base_offset=0):
        return splat_bilinear(values, coords, weights, out_hw,
                              max_dy_window=max_dy)

    def gather_window(image, coords, max_dx, max_dy, block_rows):
        image = image.astype(jnp.float32)
        n, hs, ws, _ = coords.shape
        c = image.shape[-1]

        def splat(values):
            return splat_bilinear(values, coords, jnp.ones((n, hs, ws, 1)),
                                  image.shape[1:3], max_dy_window=max_dy)[0]

        _, vjp = jax.vjp(splat, jnp.ones((n, hs, ws, c + 1), jnp.float32))
        (g,) = vjp(jnp.concatenate(
            [image, jnp.ones(image.shape[:-1] + (1,))], -1))
        return g[..., :c], g[..., c:]

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        splat_pallas, "splat_pallas_diff", splat_window))
    stack.enter_context(mock.patch.object(
        gather_pallas, "gather_pallas_diff", gather_window))
    return stack


def make(seeds, out: str) -> None:
    os.environ["LSI_TPU_FORCE_PALLAS"] = "1"
    sys.path.insert(0, HERE)
    import jax
    from jax.experimental.pallas import tpu as pltpu

    from lsi_tpu.config import get_config
    from lsi_tpu.data.pipeline import _batch_stream
    from lsi_tpu.train.trainer import create_state
    from make_torch_golden_mpi import toy_mpi
    from make_torch_golden_pallas import (MPI_MAX_DY, MPI_TILT,
                                          QUALITY_MAX_DY, flat, mpi_loss,
                                          on_route, quality_loss,
                                          tilt_poses)
    from make_torch_golden_quality import toy_quality

    arrays = {}
    with pltpu.force_tpu_interpret_mode():
        for name, toy, max_dy, loss, tilt in (
                ("quality", toy_quality, QUALITY_MAX_DY, quality_loss, 0.0),
                ("mpi", toy_mpi, MPI_MAX_DY, mpi_loss, MPI_TILT)):
            cfg = on_route(toy(get_config), max_dy)
            arrays[f"{name}/__config__"] = np.frombuffer(
                json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8)
            for seed in seeds:
                state = create_state(cfg, jax.random.key(seed))
                batch = tilt_poses(next(_batch_stream(cfg.data, seed, True)),
                                   tilt)
                grads = jax.grad(loss(cfg))(state.params, batch,
                                            state.apply_fn)
                with lax_route():
                    lax_grads = jax.grad(loss(cfg))(state.params, batch,
                                                    state.apply_fn)
                pre = f"{name}/s{seed}/"
                arrays.update({pre + "step1_grads_lax/" + k: v
                               for k, v in flat(lax_grads).items()})
                arrays.update({pre + "params/" + k: v
                               for k, v in flat(state.params).items()})
                arrays.update({pre + "step1_grads/" + k: v
                               for k, v in flat(grads).items()})
                arrays.update({pre + "batch/" + f.name: np.asarray(
                    getattr(batch, f.name)) for f in dataclasses.fields(batch)
                    if getattr(batch, f.name) is not None})
                print(f"{name} seed {seed} done", flush=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


def faults():
    """{name: context manager factory} of the planted faults."""
    import torch

    from lsi_tpu_torch.kernels import gather_cuda, splat_cuda
    from lsi_tpu_torch.ops import gather as plain_gather

    exact_bwd = gather_cuda.gather_bwd_coords
    gather_apply = gather_cuda.GatherFn.apply
    splat_vjp = splat_cuda.splat_vjp

    def unsnapped_coords(image, coords, g_sampled, g_valid, max_dy=-1,
                         fold_h=None):
        with mock.patch.object(plain_gather, "snap_fraction",
                               lambda f: f), torch.enable_grad():
            return gather_cuda._plain_coords_vjp(image, coords, g_sampled,
                                                 g_valid, max_dy, fold_h)

    def unwindowed_coords(image, coords, g_sampled, g_valid, max_dy=-1,
                          fold_h=None):
        return exact_bwd(image, coords, g_sampled, g_valid)

    def wider_gather(image, coords, max_dy=-1, fold_h=None):
        return gather_apply(image, coords, max_dy + (max_dy >= 0), fold_h)

    def unwindowed_splat_vjp(*args, max_dy=-1, fold_h=None, base_offset=0):
        return splat_vjp(*args)

    # The wrappers count their launches on their module's globals, which
    # these replace while they are planted.
    for fn in (unsnapped_coords, unwindowed_coords, unwindowed_splat_vjp):
        fn.launches = fn.window_launches = 0

    return {
        "sound": contextlib.nullcontext,
        "d_image unsnapped": lambda: mock.patch.object(
            gather_cuda, "splat",
            functools.partial(gather_cuda.splat, snap=False)),
        "d_coords unsnapped": lambda: mock.patch.object(
            gather_cuda, "gather_bwd_coords", unsnapped_coords),
        "d_coords unwindowed": lambda: mock.patch.object(
            gather_cuda, "gather_bwd_coords", unwindowed_coords),
        "gather window + 1": lambda: mock.patch.object(
            gather_cuda.GatherFn, "apply", wider_gather),
        "splat VJP unwindowed": lambda: mock.patch.object(
            splat_cuda, "splat_vjp", unwindowed_splat_vjp),
    }


def read(path: str, device: str) -> None:
    import torch

    from lsi_tpu_torch.config import Config
    from lsi_tpu_torch.data.pipeline import Batch
    from lsi_tpu_torch.models.convert import state_dict_from_jax
    from lsi_tpu_torch.train.trainer import create_state, loss_and_grads

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}

    def section(prefix):
        return {k[len(prefix):]: v for k, v in arrays.items()
                if k.startswith(prefix)}

    planted = faults()
    worst = {}  # (recipe, reading) -> (least, largest) over the seeds
    for name in RECIPES:
        cfg = Config.from_dict(json.loads(
            bytes(arrays[f"{name}/__config__"]).decode()))
        seeds = sorted({int(k.split("/")[1][1:]) for k in arrays
                        if k.startswith(f"{name}/s")})
        for seed in seeds:
            pre = f"{name}/s{seed}/"
            state = create_state(cfg, device=dev)
            state.net.load_state_dict(state_dict_from_jax(
                section(pre + "params/"), cfg.model))
            batch = Batch(**{k: torch.from_numpy(v).to(dev)
                             for k, v in section(pre + "batch/").items()})
            want = state_dict_from_jax(section(pre + "step1_grads/"),
                                       cfg.model)
            lax = (state_dict_from_jax(section(pre + "step1_grads_lax/"),
                                       cfg.model)
                   if f"{pre}step1_grads_lax/" in " ".join(arrays) else None)

            def record(label, got, ref):
                err = max(float((got[k].cpu() - v).abs().max())
                          for k, v in ref.items()) / max(
                              float(v.abs().max()) for v in ref.values())
                lo, hi = worst.get((name, label), (err, err))
                worst[(name, label)] = (min(lo, err), max(hi, err))
                print(f"{name} seed {seed} {label}: {err:.3e} of the "
                      "largest", flush=True)

            if lax is not None:
                record("JAX lax route", lax, want)
            for fault, patch in planted.items():
                with patch():
                    grads = loss_and_grads(state, batch, cfg)[1]
                record(fault, grads, want)
                if fault == "sound" and lax is not None:
                    record("sound vs JAX lax route", grads, lax)
    for (name, label), (lo, hi) in worst.items():
        print(f"{name} {label}: over {len(seeds)} seeds from {lo:.3e} to "
              f"{hi:.3e} of the largest")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    m = sub.add_parser("make")
    m.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    m.add_argument("--out", required=True)
    r = sub.add_parser("read")
    r.add_argument("path")
    r.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.mode == "make":
        make(args.seeds, args.out)
    else:
        read(args.path, args.device)


if __name__ == "__main__":
    main()
