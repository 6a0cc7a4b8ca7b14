"""Write the golden fixture that holds the port's ``remat_decoder`` train
step to JAX's ``jax.checkpoint`` step.

Runs the JAX package's train step on the CPU (its lax path) for a toy cut
of the ``highres_b64`` preset: L=2, layer 0's texture from the input,
``photo_mode="splat"``, ``remat_decoder=True`` (the whole model apply under
``jax.checkpoint``), but ``base_filters=8``, ``num_scales=2``, float32
compute, 32x96, batch 2, ``warmup_steps=2``, on two-plane synthetic
batches. The arrays are those of ``scripts/make_torch_golden_train.py``
(the initial params, 3 batches, the metrics of 3 steps, the step-1
gradients, the params after 3 steps) and, for the first batch, the
model's LDI and the gradient of the loss with respect to it:

    step1_ldi/{textures,disparities}        the LDI of batch 0
    step1_ldi_grad/{textures,disparities}   d total / d LDI there
    step1_net_vjp/<flax path>               that cotangent pulled back
                                            through the jax.checkpoint'd
                                            model apply

``tests/test_torch_remat.py`` and ``chip_smoke.py`` read it. Regenerate
with:

    JAX_PLATFORMS=cpu python scripts/make_torch_golden_remat.py
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from make_torch_golden_train import flat, make_golden_train  # noqa: E402

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, "tests", "data",
                           "torch_golden_remat_toy.npz")


def toy_config(get_config):
    """The toy cut of highres_b64 (either package's ``get_config``)."""
    cfg = get_config("highres_b64")
    assert cfg.train.remat_decoder
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, base_filters=8, num_scales=2,
                                  compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, dataset="synthetic", height=32,
                                 width=96, batch_size=2),
        train=dataclasses.replace(cfg.train, warmup_steps=2))


def ldi_and_cotangent(cfg, arrays) -> dict:
    """Batch 0's LDI under the fixture's initial params, and the gradient
    of the loss with respect to it (the cotangent the network's backward
    takes)."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp

    from lsi_tpu.data.pipeline import Batch, decode_batch
    from lsi_tpu.losses import total_loss
    from lsi_tpu.models.ldi_predictor import LDIPredictor

    params = {}
    for key, v in arrays.items():
        if key.startswith("params/"):
            *path, leaf = key[len("params/"):].split("/")
            node = params
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(v)
    batch = decode_batch(Batch(**{k[len("batch0/"):]: v
                                  for k, v in arrays.items()
                                  if k.startswith("batch0/")}))
    ldi = LDIPredictor(cfg.model).apply({"params": params}, batch.src_image,
                                        batch.intrinsics)

    def loss(textures, disparities):
        pred = dc.replace(ldi, textures=textures, disparities=disparities)
        return total_loss(pred, batch.trg_image, batch.pose_src2trg,
                          cfg.loss, cfg.render,
                          gt_disparity=batch.gt_disparity,
                          gt_valid=batch.gt_valid)["total"]

    g_tex, g_disp = jax.grad(loss, argnums=(0, 1))(ldi.textures,
                                                   ldi.disparities)
    apply = jax.checkpoint(
        lambda p: LDIPredictor(cfg.model).apply({"params": p},
                                                batch.src_image,
                                                batch.intrinsics))
    out, pull = jax.vjp(apply, params)
    (vjp,) = pull(dc.replace(out, textures=g_tex, disparities=g_disp,
                             intrinsics=jnp.zeros_like(out.intrinsics)))
    arrays = {"step1_ldi/textures": np.asarray(ldi.textures),
              "step1_ldi/disparities": np.asarray(ldi.disparities),
              "step1_ldi_grad/textures": np.asarray(g_tex),
              "step1_ldi_grad/disparities": np.asarray(g_disp)}
    arrays.update({"step1_net_vjp/" + k: v for k, v in flat(vjp).items()})
    return arrays


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), os.pardir))
    from lsi_tpu.config import get_config
    cfg = toy_config(get_config)
    arrays = make_golden_train(args.seed, cfg)
    arrays.update(ldi_and_cotangent(cfg, arrays))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {os.path.abspath(args.out)} "
          f"({os.path.getsize(args.out)} bytes, {len(arrays)} arrays)")


if __name__ == "__main__":
    main()
