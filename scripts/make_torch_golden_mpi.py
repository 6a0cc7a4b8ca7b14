"""Write the golden fixture that holds the port's MPI baseline to the JAX
package's.

Runs the JAX package on the CPU (its lax path) for a toy cut of the
``mpi_baseline`` preset: D=4 planes, ``base_filters=8``, ``num_scales=2``,
float32 compute, 16x64, batch 2, two-plane synthetic scenes,
``warmup_steps=2``. Stores in one ``.npz``:

    __config__, params/<flax path>   the toy config and initial model
    batch<i>/<field>                 3 training batches, i = 0..2
    metrics/<name>   (3,)            loss parts and grad_norm per step
    step1_grads/<flax path>          every gradient of the first step
    step3_params/<flax path>         the parameters after 3 steps
    homography/<name>                plane_homography for fixed poses:
                                     K_src, K_trg, pose, normal, depth, out
    render/<name>                    render_mpi of a fixed MPI under a
                                     rotation + translation: colors,
                                     alphas (in (0, 1), some exactly 0),
                                     depths, intrinsics, pose, cotangents
                                     g_rgb/g_alpha/g_disparity, outputs
                                     rgb/alpha/disparity, and the VJP
                                     d_colors/d_alphas
    render_id/<name>                 the same under the identity pose with
                                     dyadic intrinsics (the warp samples
                                     exact pixels), alphas exactly 0 and 1
                                     in patches: both clips at their
                                     bounds, where jnp.clip's gradient is
                                     0.5, and cumprod factors of 0
    srcdisp/<name>                   mpi_source_disparity of render_id's
                                     MPI: out, cotangent g, VJP d_alphas
    trainer/jsonl                    train.jsonl of a 6-step Trainer run
                                     (evals every 2, checkpoints every 3)
    trainer/best_step                the step of its best_params.npz
    trainer/params/<flax path>       its parameters after 6 steps
    trainer/eval/<metric>            evaluation.runner.evaluate of those
                                     params, 2 batches

``chip_smoke.py`` (phase 15, on the GPU, without JAX),
``tests/test_torch_mpi.py`` and ``tests/test_torch_mpi_train.py`` read it.
Regenerate with:

    JAX_PLATFORMS=cpu python scripts/make_torch_golden_mpi.py
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
                           "torch_golden_mpi_toy.npz")
STEPS = 3
TRAINER_STEPS = 6
EVAL_BATCHES = 2


def toy_mpi(get_config):
    """The toy cut of mpi_baseline (either package's ``get_config``)."""
    cfg = get_config("mpi_baseline")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, num_planes=4, base_filters=8,
                                  num_scales=2, compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, height=16, width=64,
                                 batch_size=2),
        train=dataclasses.replace(cfg.train, warmup_steps=2,
                                  max_steps=TRAINER_STEPS, eval_every=2,
                                  eval_batches=1, checkpoint_every=3,
                                  log_every=1))


def fixed_mpi(rng: np.random.Generator, b=2, d=4, h=16, w=32,
              exact_bounds=False) -> dict:
    """An MPI as numpy arrays: colours in [0, 1], alphas in [0.05, 0.95]
    with a patch of exact zeros in every plane; with ``exact_bounds`` also
    a patch of exact ones in every plane, plane 1 opaque over a quarter of
    the image, and dyadic intrinsics (fx = fy = 16, cx = w/2, cy = h/2)
    so the identity pose maps every pixel to itself exactly."""
    colors = rng.uniform(size=(b, d, h, w, 3)).astype(np.float32)
    alphas = rng.uniform(0.05, 0.95, (b, d, h, w, 1)).astype(np.float32)
    alphas[:, :, 2:5, 3:9] = 0.0
    if exact_bounds:
        alphas[:, :, 9:12, 10:17] = 1.0
        alphas[:, 1, : h // 2, : w // 2] = 1.0
        fx = fy = 16.0
    else:
        fx, fy = 20.0, 18.0
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]], np.float32)
    return {"colors": colors, "alphas": alphas,
            "intrinsics": np.broadcast_to(K, (b, 3, 3)).copy()}


def flat(tree) -> dict:
    """Flax param tree -> {'a/b/c': np.ndarray}."""
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def render_case(rng, case: dict, pose: np.ndarray, depths) -> dict:
    """render_mpi of ``case`` and its VJP with random cotangents."""
    import jax
    import jax.numpy as jnp

    from lsi_tpu.models.mpi import MPI, render_mpi

    K = jnp.asarray(case["intrinsics"])

    def fn(colors, alphas):
        out = render_mpi(MPI(colors=colors, alphas=alphas, depths=depths,
                             intrinsics=K), jnp.asarray(pose))
        return out["rgb"], out["alpha"], out["disparity"]

    outs, vjp = jax.vjp(fn, jnp.asarray(case["colors"]),
                        jnp.asarray(case["alphas"]))
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    d_colors, d_alphas = vjp(tuple(jnp.asarray(c) for c in cots))
    out = dict(case, depths=np.asarray(depths), pose=pose)
    out.update(zip(("rgb", "alpha", "disparity"), map(np.asarray, outs)))
    out.update(zip(("g_rgb", "g_alpha", "g_disparity"), cots))
    out.update(d_colors=np.asarray(d_colors), d_alphas=np.asarray(d_alphas))
    return out


def make_golden_mpi(seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from lsi_tpu.config import get_config
    from lsi_tpu.data.pipeline import _batch_stream, decode_batch
    from lsi_tpu.evaluation.runner import evaluate
    from lsi_tpu.geometry.homography import plane_homography
    from lsi_tpu.geometry.transforms import pose_from_euler, translation_pose
    from lsi_tpu.losses.losses import mpi_total_loss
    from lsi_tpu.models.mpi import MPI, mpi_source_disparity, plane_depths
    from lsi_tpu.train.checkpoint import read_params_npz_meta
    from lsi_tpu.train.trainer import Trainer, create_state, make_train_step

    cfg = toy_mpi(get_config)
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

    # The first step's gradients, as the train step's loss_fn takes them.
    def loss(params, batch):
        batch = decode_batch(batch)
        pred = state.apply_fn({"params": params}, batch.src_image,
                              batch.intrinsics)
        return mpi_total_loss(pred, batch.src_image, batch.trg_image,
                              batch.pose_src2trg, cfg.loss,
                              gt_disparity=batch.gt_disparity,
                              gt_valid=batch.gt_valid,
                              render_cfg=cfg.render)["total"]

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

    # plane_homography for a rotation + translation and several planes.
    rng = np.random.default_rng(seed + 7)
    hom = {"K_src": fixed_mpi(rng)["intrinsics"],
           "K_trg": fixed_mpi(rng, exact_bounds=True)["intrinsics"],
           "pose": np.asarray(pose_from_euler([[0.02, -0.03, 0.01],
                                               [-0.01, 0.04, 0.0]],
                                              [[-0.2, 0.05, 0.1],
                                               [0.1, 0.0, -0.3]])),
           "normal": np.array([[0, 0, 1], [0.1, -0.2, 0.97]], np.float32),
           "depth": np.array([2.5, 7.0], np.float32)}
    hom["out"] = np.asarray(plane_homography(*map(jnp.asarray, (
        hom["K_src"], hom["K_trg"], hom["pose"], hom["normal"],
        hom["depth"]))))
    arrays.update({"homography/" + k: v for k, v in hom.items()})

    depths = plane_depths(4, 1.0, 100.0)
    pose = np.asarray(pose_from_euler([[0.01, -0.02, 0.0]] * 2,
                                      [[-0.3, 0.05, 0.1]] * 2))
    arrays.update({"render/" + k: v for k, v in render_case(
        rng, fixed_mpi(rng), pose, depths).items()})
    ident = fixed_mpi(rng, exact_bounds=True)
    arrays.update({"render_id/" + k: v for k, v in render_case(
        rng, ident, np.asarray(translation_pose([[0.0, 0.0, 0.0]] * 2)),
        depths).items()})

    def src_disp(alphas):
        return mpi_source_disparity(MPI(
            colors=jnp.asarray(ident["colors"]), alphas=alphas,
            depths=depths, intrinsics=jnp.asarray(ident["intrinsics"])))

    out, vjp = jax.vjp(src_disp, jnp.asarray(ident["alphas"]))
    g = rng.standard_normal(out.shape).astype(np.float32)
    arrays.update({"srcdisp/out": np.asarray(out), "srcdisp/g": g,
                   "srcdisp/d_alphas": np.asarray(vjp(jnp.asarray(g))[0])})

    # The Trainer: evals, the best export and checkpoints inside 6 steps.
    with tempfile.TemporaryDirectory() as ckpt:
        tcfg = cfg.replace(train=dataclasses.replace(
            cfg.train, checkpoint_dir=ckpt, seed=seed))
        t_state, _ = Trainer(tcfg).train()
        with open(os.path.join(ckpt, "train.jsonl"), "rb") as f:
            arrays["trainer/jsonl"] = np.frombuffer(f.read(), np.uint8)
        arrays["trainer/best_step"] = np.asarray(int(read_params_npz_meta(
            os.path.join(ckpt, "best_params.npz"))["step"]))
        arrays.update({"trainer/params/" + k: v
                       for k, v in flat(t_state.params).items()})
        results = evaluate(tcfg, t_state.params, num_batches=EVAL_BATCHES)
        arrays.update({"trainer/eval/" + k: np.asarray(v, np.float64)
                       for k, v in results.items()})
    return arrays


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    arrays = make_golden_mpi(args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {os.path.abspath(args.out)} "
          f"({os.path.getsize(args.out)} bytes, {len(arrays)} arrays)")


if __name__ == "__main__":
    main()
