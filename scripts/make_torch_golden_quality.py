"""Write the golden fixture that holds the port's two-prediction training
(the quality recipe) to the JAX package's.

Runs the JAX package on the CPU (its lax path, ``use_pallas="off"`` in
effect) for a toy cut of the ``kitti_ldi3_quality`` preset: L=3,
predicted layer-0 texture, symmetric photometric loss, the disocclusion
pseudo-label and the visible anchor, but ``base_filters=8``,
``num_scales=2``, float32 compute, 32x64, batch 2, multi-object synthetic
scenes, and the phase boundaries moved into 6 steps (warm-up until step 2,
an eval every 2 steps, the layer-0 freeze from the best export at step 4,
a checkpoint every 3). Stores in one ``.npz``:

    params/<flax path>, __config__   the initial model (LSIModel.save's
                                     format; the Trainer starts from it too)
    batch<i>/<field>                 2 training batches, i = 0..1
    metrics/<name>   (2,)            loss parts and grad_norm of 2 full
                                     two-prediction steps on those batches
    step1_grads/<flax path>          every gradient of the first step
    trainer/jsonl                    train.jsonl of a 6-step Trainer run
                                     (utf-8 bytes)
    trainer/best_step                the step of its best_params.npz
    trainer/params/<flax path>       its parameters after 6 steps

``chip_smoke.py`` (phase 12, on the GPU, without JAX),
``tests/test_torch_consistency.py`` and ``tests/test_torch_trainer.py``
read it. Regenerate with:

    JAX_PLATFORMS=cpu python scripts/make_torch_golden_quality.py
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, "tests", "data",
                           "torch_golden_quality_toy.npz")
STEPS = 2
TRAINER_STEPS = 6


def toy_quality(get_config):
    """The toy cut of kitti_ldi3_quality (either package's
    ``get_config``), with the phase boundaries inside 6 steps."""
    cfg = get_config("kitti_ldi3_quality")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, base_filters=8, num_scales=2,
                                  compute_dtype="float32"),
        loss=dataclasses.replace(cfg.loss, consistency_start_step=2),
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 synthetic_scene="multi", height=32,
                                 width=64, batch_size=2),
        train=dataclasses.replace(cfg.train, warmup_steps=2,
                                  max_steps=TRAINER_STEPS, eval_every=2,
                                  eval_batches=1, freeze_layer0_step=4,
                                  checkpoint_every=3, log_every=1))


def flat(tree) -> dict:
    """Flax param tree -> {'a/b/c': np.ndarray}."""
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def make_golden_quality(seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from lsi_tpu.config import get_config
    from lsi_tpu.data.pipeline import _batch_stream, decode_batch
    from lsi_tpu.losses.losses import total_loss_bidirectional
    from lsi_tpu.train.checkpoint import read_params_npz_meta
    from lsi_tpu.train.trainer import Trainer, create_state, make_train_step

    cfg = toy_quality(get_config)
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
    # (one forward over src and trg stacked on the batch axis).
    def loss(params, batch):
        batch = decode_batch(batch)
        b = batch.src_image.shape[0]
        both = state.apply_fn(
            {"params": params},
            jnp.concatenate([batch.src_image, batch.trg_image]),
            jnp.concatenate([batch.intrinsics, batch.intrinsics]))
        pred, pred_trg = (
            both.replace(textures=both.textures[sl],
                         disparities=both.disparities[sl],
                         intrinsics=both.intrinsics[sl])
            for sl in (slice(0, b), slice(b, None)))
        return total_loss_bidirectional(
            pred, pred_trg, batch.src_image, batch.trg_image,
            batch.pose_src2trg, cfg.loss, cfg.render,
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

    # The Trainer: every phase of the recipe inside 6 steps.
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = Trainer(cfg.replace(train=dataclasses.replace(
            cfg.train, checkpoint_dir=ckpt, seed=seed)))
        t_state, _ = trainer.train()
        with open(os.path.join(ckpt, "train.jsonl"), "rb") as f:
            arrays["trainer/jsonl"] = np.frombuffer(f.read(), np.uint8)
        arrays["trainer/best_step"] = np.asarray(int(read_params_npz_meta(
            os.path.join(ckpt, "best_params.npz"))["step"]))
        arrays.update({"trainer/params/" + k: v
                       for k, v in flat(t_state.params).items()})
    return arrays


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    arrays = make_golden_quality(args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {os.path.abspath(args.out)} "
          f"({os.path.getsize(args.out)} bytes, {len(arrays)} arrays)")


if __name__ == "__main__":
    main()
