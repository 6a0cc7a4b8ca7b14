"""Write the golden fixture that holds the port's training knobs
``loss.consistency_ema_teacher``, ``loss.consistency_stop_step``,
``loss.photo_layer0_weight`` and ``model.deep_heads_stopgrad_trunk`` to
the JAX package's.

Runs the JAX package on the CPU (its lax path) for the toy cut of the
``kitti_ldi3_quality`` preset that ``scripts/make_torch_golden_quality.py``
records (L=3, predicted layer-0 texture, the symmetric two-prediction
loss, ``base_filters=8``, ``num_scales=2``, float32 compute, 32x64,
batch 2, multi-object synthetic scenes), no evals, no freeze, 4 steps:

    teacher/...  consistency_ema_teacher (decay 0.999, so the ramp
                 (t + 1) / (t + 10) rules), consistency_start_step 1: a
                 Trainer run, the warm-up step gating both teacher terms
    stop/...     consistency_stop_step 2, photo_layer0_weight 0.1: a
                 Trainer run, the pseudo-label dropped from step 2
    deep/...     deep_heads_stopgrad_trunk: 3 steps of make_train_step,
                 and the step-1 gradients of the full loss and of a loss
                 of deep-layer terms alone (the trunk's are exactly 0)

Each run stores:

    <run>/__config__                 its config (JSON bytes)
    <run>/params/<flax path>         the initial parameters
    <run>/final/<flax path>          the parameters after the run
    teacher/ema/<flax path>          the teacher after the run
    teacher|stop/jsonl               the Trainer's train.jsonl
    deep/batch<i>/<field>            its 3 batches
    deep/metrics/<name>  (3,)        its metrics per step
    deep/step1_grads/<flax path>     the full loss's step-1 gradients
    deep/deep_only_grads/<flax path> the deep-only loss's

``tests/test_torch_refuted.py`` reads it. Regenerate with:

    JAX_PLATFORMS=cpu python scripts/make_torch_golden_refuted.py
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
                           "torch_golden_refuted_toy.npz")
STEPS = 4
DEEP_STEPS = 3


def toy_refuted(get_config, run: str):
    """The toy quality recipe with ``run``'s knobs (either package's
    ``get_config``): "teacher", "stop", "deep" or "deep_only" (the deep
    model under a loss of deep-layer terms alone)."""
    cfg = get_config("kitti_ldi3_quality")
    model = dataclasses.replace(cfg.model, base_filters=8, num_scales=2,
                                compute_dtype="float32")
    loss = dataclasses.replace(cfg.loss, consistency_start_step=0)
    if run == "teacher":
        loss = dataclasses.replace(loss, consistency_ema_teacher=True,
                                   consistency_start_step=1)
    elif run == "stop":
        loss = dataclasses.replace(loss, consistency_stop_step=2,
                                   photo_layer0_weight=0.1)
    elif run in ("deep", "deep_only"):
        model = dataclasses.replace(model, deep_heads_stopgrad_trunk=True)
    else:
        raise ValueError(run)
    if run == "deep_only":
        # The pseudo-label alone, on the deep layers alone: a zero weight
        # for every term that reads layer 0, and the term's source layer
        # 0 and target detached.
        loss = dataclasses.replace(
            loss, photo_mode="inverse_warp", inverse_warp_weight=0.0,
            smoothness_weight=0.0, symmetric=False,
            consistency_anchor_weight=0.0, consistency_weight=1.0,
            consistency_deep_only=True, consistency_stop_target=True)
    return dataclasses.replace(
        cfg, model=model, loss=loss,
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 synthetic_scene="multi", height=32,
                                 width=64, batch_size=2),
        train=dataclasses.replace(cfg.train, warmup_steps=2,
                                  max_steps=STEPS, eval_every=0,
                                  freeze_layer0_step=0,
                                  freeze_layer0_from_best=False,
                                  checkpoint_every=100, log_every=1))


def flat(tree) -> dict:
    """Flax param tree -> {'a/b/c': np.ndarray}."""
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def config_bytes(cfg) -> np.ndarray:
    return np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(),
                         np.uint8)


def trainer_run(run: str, seed: int) -> dict:
    """JAX's Trainer over ``STEPS`` steps of ``run``'s config."""
    import jax

    from lsi_tpu.config import get_config
    from lsi_tpu.train.trainer import Trainer, create_state

    cfg = toy_refuted(get_config, run)
    start = create_state(cfg, jax.random.key(seed))
    out = {f"{run}/__config__": config_bytes(cfg)}
    out.update({f"{run}/params/{k}": v
                for k, v in flat(start.params).items()})
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = Trainer(cfg.replace(train=dataclasses.replace(
            cfg.train, checkpoint_dir=ckpt, seed=seed)))
        state, _ = trainer.train()
        with open(os.path.join(ckpt, "train.jsonl"), "rb") as f:
            out[f"{run}/jsonl"] = np.frombuffer(f.read(), np.uint8)
    out.update({f"{run}/final/{k}": v for k, v in flat(state.params).items()})
    if state.ema_params is not None:
        out.update({f"{run}/ema/{k}": v
                    for k, v in flat(state.ema_params).items()})
    return out


def deep_run(seed: int) -> dict:
    """The deep-heads model: 3 train steps, and step-1 gradients under the
    full loss and under the deep-only loss."""
    import jax
    import jax.numpy as jnp

    from lsi_tpu.config import get_config
    from lsi_tpu.data.pipeline import _batch_stream, decode_batch
    from lsi_tpu.losses.losses import total_loss_bidirectional
    from lsi_tpu.train.trainer import create_state, make_train_step

    cfg = toy_refuted(get_config, "deep")
    state = create_state(cfg, jax.random.key(seed))
    stream = _batch_stream(cfg.data, seed, True)
    batches = [next(stream) for _ in range(DEEP_STEPS)]
    out = {"deep/__config__": config_bytes(cfg)}
    out.update({f"deep/params/{k}": v for k, v in flat(state.params).items()})
    for i, batch in enumerate(batches):
        for f in dataclasses.fields(batch):
            x = getattr(batch, f.name)
            if x is not None:
                out[f"deep/batch{i}/{f.name}"] = np.asarray(x)

    def loss(params, batch, loss_cfg):
        # As the train step's loss_fn: one forward over src and trg.
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
            batch.pose_src2trg, loss_cfg, cfg.render,
            gt_disparity=batch.gt_disparity,
            gt_valid=batch.gt_valid)["total"]

    grads = jax.grad(loss)(state.params, batches[0], cfg.loss)
    out.update({f"deep/step1_grads/{k}": v for k, v in flat(grads).items()})
    deep_only = toy_refuted(get_config, "deep_only")
    grads = jax.grad(loss)(state.params, batches[0], deep_only.loss)
    out.update({f"deep/deep_only_grads/{k}": v
                for k, v in flat(grads).items()})

    step = make_train_step(cfg)
    history = {}
    for batch in batches:
        state, metrics = step(state, batch)
        for k, v in metrics.items():
            history.setdefault(k, []).append(float(v))
    out.update({f"deep/metrics/{k}": np.asarray(v, np.float32)
                for k, v in history.items()})
    out.update({f"deep/final/{k}": v for k, v in flat(state.params).items()})
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    arrays = {}
    for run in ("teacher", "stop"):
        arrays.update(trainer_run(run, args.seed))
    arrays.update(deep_run(args.seed))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {os.path.abspath(args.out)} "
          f"({os.path.getsize(args.out)} bytes, {len(arrays)} arrays)")


if __name__ == "__main__":
    main()
