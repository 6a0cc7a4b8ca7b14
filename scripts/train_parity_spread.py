"""How far the train step's gradients and parameter paths can agree, on
the CPU: the spread the tolerances of the train-step comparisons rest on.

    JAX_PLATFORMS=cpu python scripts/train_parity_spread.py
    JAX_PLATFORMS=cpu python scripts/train_parity_spread.py --quality

Reads tests/data/torch_golden_train_toy.npz (scripts/make_torch_golden_train.py)
and prints, for each of its three batches at its initial params:

* the largest difference between JAX's jitted and eager gradients of the
  same loss, beside the largest gradient. The splat and gather gradients
  jump where a projected coordinate crosses a pixel or snap-zone edge, so
  the reference disagrees with itself where a few coordinates sit at an
  edge;
* the same for the port on the CPU against JAX's jitted gradients;

then, on batch 0, the port's gradients against the fixture's step-1
gradients as a fraction of the largest one (what the golden train checks
hold to a limit), sound and with three planted faults: the splat loss's
gradient dropped, the splat VJP's coordinate gradient zeroed, and the
gather's ``valid`` cotangent dropped; then runs the port's train step on the CPU for the three steps and prints
the parameters' distance from the fixture's: the largest difference, the
mean difference over the mean movement, and the cosine of the movements.

With ``--quality`` it reads tests/data/torch_golden_quality_toy.npz
(scripts/make_torch_golden_quality.py) instead: the two-prediction loss of
the toy quality recipe on its two batches, and the step-1 gradients with
four planted faults of the two-prediction terms (the pseudo-label's
gradient dropped, the anchor's gradient dropped, ``deep_only`` and
``stop_target`` ignored); no parameter paths.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "tests", "data")
GOLDEN = os.path.join(DATA, "torch_golden_train_toy.npz")
GOLDEN_QUALITY = os.path.join(DATA, "torch_golden_quality_toy.npz")


def quality_spread() -> None:
    """The --quality report (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import torch

    from lsi_tpu.config import get_config as j_get_config
    from lsi_tpu.data.pipeline import Batch as JBatch
    from lsi_tpu.data.pipeline import decode_batch as j_decode
    from lsi_tpu.losses.losses import \
        total_loss_bidirectional as j_total_loss_bidirectional
    from lsi_tpu.models.ldi_predictor import LDIPredictor as JLDIPredictor
    from lsi_tpu_torch.config import Config
    from lsi_tpu_torch.data.pipeline import Batch
    from lsi_tpu_torch.losses import losses
    from lsi_tpu_torch.models.convert import state_dict_from_jax
    from lsi_tpu_torch.train.trainer import create_state, loss_and_grads
    from make_torch_golden_quality import flat, toy_quality

    with np.load(GOLDEN_QUALITY) as g:
        golden = {k: g[k] for k in g.files}

    def section(prefix):
        return {k[len(prefix):]: v for k, v in golden.items()
                if k.startswith(prefix)}

    cfg = Config.from_dict(json.loads(bytes(golden["__config__"]).decode()))
    jcfg = toy_quality(j_get_config)
    tree = {}
    for key, v in section("params/").items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    model = JLDIPredictor(jcfg.model)
    state = create_state(cfg, device="cpu")
    state.net.load_state_dict(state_dict_from_jax(section("params/"),
                                                  cfg.model))

    for i in range(2):
        arrays = section(f"batch{i}/")

        def loss(params):
            b = j_decode(JBatch(**arrays))
            n = b.src_image.shape[0]
            both = model.apply(
                {"params": params},
                jnp.concatenate([b.src_image, b.trg_image]),
                jnp.concatenate([b.intrinsics, b.intrinsics]))
            src, trg = (both.replace(textures=both.textures[sl],
                                     disparities=both.disparities[sl],
                                     intrinsics=both.intrinsics[sl])
                        for sl in (slice(0, n), slice(n, None)))
            return j_total_loss_bidirectional(
                src, trg, b.src_image, b.trg_image, b.pose_src2trg,
                jcfg.loss, jcfg.render, gt_disparity=b.gt_disparity,
                gt_valid=b.gt_valid)["total"]

        eager = flat(jax.grad(loss)(tree))
        jitted = flat(jax.jit(jax.grad(loss))(tree))
        port = loss_and_grads(state, Batch(**{
            k: torch.from_numpy(v) for k, v in arrays.items()}), cfg)[1]
        g_max = max(float(np.abs(v).max()) for v in jitted.values())
        jit_eager = max(float(np.abs(eager[k] - jitted[k]).max())
                        for k in eager)
        for name, ref in (("jit", jitted), ("eager", eager)):
            want = state_dict_from_jax(ref, cfg.model)
            err = max(float((port[k] - want[k]).abs().max()) for k in want)
            print(f"batch {i}: port (CPU) vs JAX {name} {err:.3e} "
                  f"({err / g_max:.2e} of the largest |grad| {g_max:.3e})")
        print(f"batch {i}: JAX jit vs eager {jit_eager:.3e} "
              f"({jit_eager / g_max:.2e} of the largest)")

    batch0 = Batch(**{k: torch.from_numpy(v)
                      for k, v in section("batch0/").items()})
    want = state_dict_from_jax(section("step1_grads/"), cfg.model)
    g_max = max(float(v.abs().max()) for v in want.values())

    def step1_error(c=cfg) -> float:
        grads = loss_and_grads(state, batch0, c)[1]
        return max(float((grads[k] - want[k]).abs().max())
                   for k in want) / g_max

    print(f"step-1 gradients on batch 0 vs the fixture (JAX eager), max abs "
          f"err / largest |grad| ({g_max:.3e}): sound {step1_error():.3e}")
    consistency = losses.depth_consistency

    def detached(**flags):
        def term(*a, **k):
            out = consistency(*a, **k)
            return out.detach() if all(k.get(f) for f in flags) else out
        return term

    faults = {
        "pseudo-label gradient dropped": detached(disocc_only=True),
        "anchor gradient dropped": detached(visible_only=True),
        "deep_only ignored": lambda *a, **k: consistency(
            *a, **{**k, "deep_only": False}),
        "stop_target ignored": lambda *a, **k: consistency(
            *a, **{**k, "stop_target": False}),
    }
    for name, planted in faults.items():
        losses.depth_consistency = planted
        try:
            print(f"  planted fault, {name}: {step1_error():.3e}")
        finally:
            losses.depth_consistency = consistency


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quality", action="store_true",
                        help="the two-prediction (quality) fixture")
    if parser.parse_args(argv).quality:
        quality_spread()
        return
    train_spread()


def train_spread() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from lsi_tpu.config import get_config as j_get_config
    from lsi_tpu.data.pipeline import Batch as JBatch
    from lsi_tpu.data.pipeline import decode_batch as j_decode
    from lsi_tpu.losses import total_loss as j_total_loss
    from lsi_tpu.models.ldi_predictor import LDIPredictor as JLDIPredictor
    from lsi_tpu_torch.config import Config
    from lsi_tpu_torch.data.pipeline import Batch
    from lsi_tpu_torch.kernels import gather_cuda, splat_cuda
    from lsi_tpu_torch.losses import losses
    from lsi_tpu_torch.models.convert import state_dict_from_jax
    from lsi_tpu_torch.train.trainer import (create_state, loss_and_grads,
                                             make_train_step)
    from make_torch_golden_train import flat, toy_config

    with np.load(GOLDEN) as g:
        golden = {k: g[k] for k in g.files}

    def section(prefix):
        return {k[len(prefix):]: v for k, v in golden.items()
                if k.startswith(prefix)}

    cfg = Config.from_dict(json.loads(bytes(golden["__config__"]).decode()))
    jcfg = toy_config(j_get_config)
    tree = {}
    for key, v in section("params/").items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    model = JLDIPredictor(jcfg.model)
    start = state_dict_from_jax(section("params/"), cfg.model)
    state = create_state(cfg, device="cpu")
    state.net.load_state_dict(start)

    for i in range(3):
        arrays = section(f"batch{i}/")

        def loss(params):
            b = j_decode(JBatch(**arrays))
            pred = model.apply({"params": params}, b.src_image, b.intrinsics)
            return j_total_loss(pred, b.trg_image, b.pose_src2trg, jcfg.loss,
                                jcfg.render, gt_disparity=b.gt_disparity,
                                gt_valid=b.gt_valid)["total"]

        eager = flat(jax.grad(loss)(tree))
        jitted = flat(jax.jit(jax.grad(loss))(tree))
        port = loss_and_grads(state, Batch(**{
            k: torch.from_numpy(v) for k, v in arrays.items()}), cfg)[1]
        want = state_dict_from_jax(jitted, cfg.model)
        g_max = max(float(np.abs(v).max()) for v in jitted.values())
        print(f"batch {i}: largest |grad| {g_max:.3e}; JAX jit vs eager "
              f"{max(float(np.abs(eager[k] - jitted[k]).max()) for k in eager):.3e}; "
              f"port (CPU) vs JAX jit "
              f"{max(float((port[k] - want[k]).abs().max()) for k in want):.3e}")

    batch0 = Batch(**{k: torch.from_numpy(v)
                      for k, v in section("batch0/").items()})
    want = state_dict_from_jax(section("step1_grads/"), cfg.model)
    g_max = max(float(v.abs().max()) for v in want.values())

    def step1_error() -> float:
        grads = loss_and_grads(state, batch0, cfg)[1]
        return max(float((grads[k] - want[k]).abs().max()) for k in want) / g_max

    splat_loss, plain_vjp = losses.view_synthesis_splat, splat_cuda._plain_vjp
    coords_vjp = gather_cuda._plain_coords_vjp
    faults = {
        "splat loss gradient dropped": (
            losses, "view_synthesis_splat",
            lambda *a, **k: tuple(x.detach() if torch.is_tensor(x) else x
                                  for x in splat_loss(*a, **k))),
        "splat VJP coordinate gradient zeroed": (
            splat_cuda, "_plain_vjp",
            lambda *a: tuple(g if i != 1 or g is None else 0 * g
                             for i, g in enumerate(plain_vjp(*a)))),
        "gather valid cotangent dropped": (
            gather_cuda, "_plain_coords_vjp",
            lambda im, crd, gs, gv: coords_vjp(im, crd, gs, 0 * gv)),
    }
    print(f"step-1 gradients on batch 0 vs the fixture, max abs err / "
          f"largest |grad| ({g_max:.3e}): sound {step1_error():.3e}")
    for name, (module, attr, planted) in faults.items():
        original = getattr(module, attr)
        setattr(module, attr, planted)
        try:
            print(f"  planted fault, {name}: {step1_error():.3e}")
        finally:
            setattr(module, attr, original)

    step = make_train_step(cfg)
    for i in range(3):
        state, _ = step(state, Batch(**{
            k: torch.from_numpy(v) for k, v in section(f"batch{i}/").items()}))
    want = state_dict_from_jax(section("step3_params/"), cfg.model)
    got = state.net.state_dict()
    names = sorted(want)
    diff = torch.cat([(got[k] - want[k]).flatten() for k in names])
    moved = torch.cat([(want[k] - start[k]).flatten() for k in names])
    mine = torch.cat([(got[k] - start[k]).flatten() for k in names])
    print(f"params after 3 port steps (CPU) vs the fixture: max diff "
          f"{float(diff.abs().max()):.3e}, mean diff / mean move "
          f"{float(diff.abs().mean() / moved.abs().mean()):.4f}, cosine "
          f"{float((moved @ mine) / (moved.norm() * mine.norm())):.5f}")


if __name__ == "__main__":
    main()
