"""Write the golden fixture that holds the port's train step to JAX's.

Runs the JAX package's train step on the CPU (its lax path) for a toy cut
of the ``kitti_ldi3_b16`` preset: L=3, predicted layer-0 texture,
``photo_mode="both"``, default smoothness, but ``base_filters=8``,
``num_scales=2``, float32 compute, 32x64, batch 2, ``warmup_steps=2``, on
two-plane synthetic batches (``data.dataset="synthetic"``). Stores in one
``.npz``:

    params/<flax path>, __config__      the initial model (LSIModel.save's
                                        format)
    batch<i>/<field>                    the 3 batches, i = 0..2
    metrics/<name>   (3,)               loss parts and grad_norm per step
    step1_grads/<flax path>             every gradient of the first step
    step3_params/<flax path>            the parameters after 3 steps

``chip_smoke.py`` (on the GPU, without JAX) and ``tests/test_torch_train.py``
read it. Regenerate with:

    JAX_PLATFORMS=cpu python scripts/make_torch_golden_train.py
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, "tests", "data",
                           "torch_golden_train_toy.npz")
STEPS = 3


def toy_config(get_config):
    """The toy cut of kitti_ldi3_b16 (either package's ``get_config``)."""
    cfg = get_config("kitti_ldi3_b16")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, base_filters=8, num_scales=2,
                                  compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, dataset="synthetic", height=32,
                                 width=64, batch_size=2),
        train=dataclasses.replace(cfg.train, warmup_steps=2))


def flat(tree) -> dict:
    """Flax param tree -> {'a/b/c': np.ndarray}."""
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def make_golden_train(seed: int = 0, cfg=None) -> dict:
    """The fixture's arrays for ``cfg`` (default: the toy kitti_ldi3_b16)."""
    import jax

    from lsi_tpu.config import get_config
    from lsi_tpu.data.pipeline import _batch_stream, decode_batch
    from lsi_tpu.losses import total_loss
    from lsi_tpu.train.trainer import create_state, make_train_step

    cfg = cfg or toy_config(get_config)
    state = create_state(cfg, jax.random.key(seed))
    stream = _batch_stream(cfg.data, seed, True)
    batches = [next(stream) for _ in range(STEPS)]

    arrays = {"params/" + k: v for k, v in flat(state.params).items()}
    arrays["__config__"] = np.frombuffer(
        json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8)
    for i, batch in enumerate(batches):
        for f in dataclasses.fields(batch):
            x = getattr(batch, f.name)
            if x is not None:
                arrays[f"batch{i}/{f.name}"] = np.asarray(x)

    # The first step's gradients, as the train step's loss_fn takes them
    # (through jax.checkpoint with train.remat_decoder).
    apply = state.apply_fn
    if cfg.train.remat_decoder:
        apply = jax.checkpoint(apply)

    def loss(params, batch):
        batch = decode_batch(batch)
        pred = apply({"params": params}, batch.src_image, batch.intrinsics)
        return total_loss(pred, batch.trg_image, batch.pose_src2trg,
                          cfg.loss, cfg.render,
                          gt_disparity=batch.gt_disparity,
                          gt_valid=batch.gt_valid)["total"]

    grads = jax.grad(loss)(state.params, batches[0])
    arrays.update({"step1_grads/" + k: v for k, v in flat(grads).items()})

    step = make_train_step(cfg)
    history = {}
    for batch in batches:
        state, metrics = step(state, batch)
        for k, v in metrics.items():
            history.setdefault(k, []).append(float(v))
    arrays.update({"metrics/" + k: np.asarray(v, np.float32)
                   for k, v in history.items()})
    arrays.update({"step3_params/" + k: v
                   for k, v in flat(state.params).items()})
    return arrays


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    arrays = make_golden_train(args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {os.path.abspath(args.out)} "
          f"({os.path.getsize(args.out)} bytes, {len(arrays)} arrays)")


if __name__ == "__main__":
    main()
