"""Write the golden fixture that holds the port's windowed route
(``render.use_pallas="on"``) to the JAX package's TPU kernels.

Runs the JAX package on the CPU with ``LSI_TPU_FORCE_PALLAS=1`` and
``use_pallas="on"``: its Pallas kernels (the windowed splat K1/K2 and the
windowed, snapped gather ``gather_pallas_diff``) in interpret mode, one
process, serially. Stores in one ``.npz``:

    gather<i>/{image, coords, max_dy}   toy gather inputs: layers folded
                                        into the coordinate rows, some
                                        coordinates in the snap zones
    gather<i>/{g_sampled, g_valid}      cotangents
    gather<i>/{sampled, valid,          gather_pallas_diff's outputs and
               d_image, d_coords}       VJP at those cotangents
    quality/__config__                  the toy kitti_ldi3_quality cut of
                                        scripts/make_torch_golden_quality.py
                                        with use_pallas="on" and
                                        pallas_max_dy=QUALITY_MAX_DY
    quality/metrics/<name>   (2,)       loss parts (window_dropped_frac
                                        included) and grad_norm of 2 steps
    quality/step1_grads/<flax path>     every gradient of the first step
    mpi/__config__, mpi/metrics/<name>, the same for the toy mpi_baseline
    mpi/step1_grads/<flax path>         cut of scripts/make_torch_golden_mpi.py
                                        at pallas_max_dy=MPI_MAX_DY
    mpi/batch<i>/pose_src2trg           its batches' poses tilted by
                                        MPI_TILT rad about x (their stereo
                                        baselines move no row, so nothing
                                        would leave the window)

The steps start from the parameters of ``torch_golden_quality_toy.npz`` and
``torch_golden_mpi_toy.npz`` and take their first two batches (the fields
stored under ``<name>/batch<i>/`` replacing theirs), so after regenerating
either of those, regenerate this one too.
``tests/test_torch_pallas_route.py`` and ``chip_smoke.py`` (phase 29, on
the GPU, without JAX) read it. Regenerate with (a few minutes: interpret
mode):

    JAX_PLATFORMS=cpu python scripts/make_torch_golden_pallas.py
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ["LSI_TPU_FORCE_PALLAS"] = "1"

DATA = os.path.join(HERE, os.pardir, "tests", "data")
DEFAULT_OUT = os.path.join(DATA, "torch_golden_pallas_toy.npz")
STEPS = 2
# Windows narrow enough that the toy scenes' motion overflows them.
QUALITY_MAX_DY = 0
MPI_MAX_DY = 0
MPI_TILT = 0.03
# (seed, batch, image height, width, channels, folded layers, max_dy).
GATHER_CASES = ((0, 1, 8, 16, 3, 2, 1), (1, 2, 8, 24, 4, 3, 0))


def on_route(cfg, max_dy: int):
    """``cfg`` with the TPU kernels' route at a window of ``max_dy``."""
    return cfg.replace(render=dataclasses.replace(
        cfg.render, use_pallas="on", pallas_max_dy=max_dy))


def flat(tree) -> dict:
    """Flax param tree -> {'a/b/c': np.ndarray}."""
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def gather_case(seed, n, h, w, c, layers, max_dy) -> dict:
    """gather_pallas_diff and its VJP on folded coordinates: each row
    near its base row, +-3 px across and +-(max_dy + 2) rows, so the
    window drops some corners; 5% of fractions within 3e-5 of an
    integer (the snap zones)."""
    import jax
    import jax.numpy as jnp

    from lsi_tpu.kernels.gather_pallas import gather_pallas_diff
    from lsi_tpu.kernels.splat_pallas import DEFAULT_MAX_DX

    rng = np.random.default_rng(seed)
    hs = layers * h
    image = rng.uniform(size=(n, h, w, c)).astype(np.float32)
    x = np.arange(w)[None, None, :] + rng.uniform(-3, 3, (n, hs, w))
    y = ((np.arange(hs) % h)[None, :, None]
         + rng.uniform(-(max_dy + 2), max_dy + 2, (n, hs, w)))
    for a in (x, y):
        near = rng.uniform(size=a.shape) < 0.05
        a[near] = np.round(a[near]) + rng.choice([-3e-5, 3e-5], near.sum())
    coords = np.stack([x, y], -1).astype(np.float32)
    g_sampled = rng.standard_normal((n, hs, w, c)).astype(np.float32)
    g_valid = rng.standard_normal((n, hs, w, 1)).astype(np.float32)

    def fn(img, crd):
        return gather_pallas_diff(img, crd, DEFAULT_MAX_DX, max_dy, 32)

    (sampled, valid), vjp = jax.vjp(fn, jnp.asarray(image),
                                    jnp.asarray(coords))
    d_image, d_coords = vjp((jnp.asarray(g_sampled), jnp.asarray(g_valid)))
    return {"image": image, "coords": coords, "max_dy": np.asarray(max_dy),
            "g_sampled": g_sampled, "g_valid": g_valid,
            "sampled": np.asarray(sampled), "valid": np.asarray(valid),
            "d_image": np.asarray(d_image), "d_coords": np.asarray(d_coords)}


def load_start(path: str, state, tilt: float = 0.0):
    """The parameters and the first STEPS batches of an existing golden
    fixture, as JAX arrays shaped as ``state.params``; with ``tilt``, the
    batches' poses turned by that many radians about x."""
    import jax
    import jax.numpy as jnp

    from lsi_tpu.data.pipeline import Batch

    with np.load(path) as g:
        golden = {k: g[k] for k in g.files}
    params = jax.tree_util.tree_map_with_path(
        lambda kp, v: jnp.asarray(golden["params/" + "/".join(
            str(getattr(k, "key", k)) for k in kp)]), state.params)
    batches = [Batch(**{k[len(f"batch{i}/"):]: jnp.asarray(v)
                        for k, v in golden.items()
                        if k.startswith(f"batch{i}/")})
               for i in range(STEPS)]
    batches = [tilt_poses(b, tilt) for b in batches]
    return params, batches, json.loads(bytes(golden["__config__"]).decode())


def tilt_poses(batch, tilt: float):
    """``batch`` with its poses turned by ``tilt`` rad about x (as it is
    where ``tilt`` is 0)."""
    if not tilt:
        return batch
    import jax.numpy as jnp

    from lsi_tpu.geometry.transforms import pose_from_euler

    n = batch.pose_src2trg.shape[0]
    turn = pose_from_euler(jnp.asarray([[tilt, 0.0, 0.0]] * n),
                           jnp.zeros((n, 3)))
    return batch.replace(pose_src2trg=jnp.einsum(
        "bij,bjk->bik", turn, batch.pose_src2trg, precision="highest"))


def steps(cfg, path: str, loss, tilt: float = 0.0) -> dict:
    """STEPS train steps of ``cfg`` from ``path``'s parameters and batches
    (``make_train_step``; poses tilted by ``tilt``, which are stored), and
    the first step's gradients of ``loss``."""
    import jax

    from lsi_tpu.train.trainer import create_state, make_train_step

    state = create_state(cfg, jax.random.key(0))
    params, batches, recorded = load_start(path, state, tilt)
    state = state.replace(params=params)
    grads = jax.grad(loss)(params, batches[0], state.apply_fn)
    out = {"__config__": np.frombuffer(
        json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8)}
    if tilt:
        out.update({f"batch{i}/pose_src2trg": np.asarray(b.pose_src2trg)
                    for i, b in enumerate(batches)})
    out.update({"step1_grads/" + k: v for k, v in flat(grads).items()})
    step = make_train_step(cfg)
    history = {}
    for batch in batches:
        state, metrics = step(state, batch)
        for k, v in metrics.items():
            history.setdefault(k, []).append(float(v))
    out.update({"metrics/" + k: np.asarray(v, np.float32)
                for k, v in history.items()})
    return out, recorded


def quality_loss(cfg):
    """The two-prediction step's loss (one forward over src and trg
    stacked on the batch axis, as the train step takes it)."""
    import jax.numpy as jnp

    from lsi_tpu.data.pipeline import decode_batch
    from lsi_tpu.losses.losses import total_loss_bidirectional

    def loss(params, batch, apply_fn):
        batch = decode_batch(batch)
        b = batch.src_image.shape[0]
        both = apply_fn({"params": params},
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

    return loss


def mpi_loss(cfg):
    """The MPI baseline's loss, as the train step takes it."""
    from lsi_tpu.data.pipeline import decode_batch
    from lsi_tpu.losses.losses import mpi_total_loss

    def loss(params, batch, apply_fn):
        batch = decode_batch(batch)
        pred = apply_fn({"params": params}, batch.src_image,
                        batch.intrinsics)
        return mpi_total_loss(pred, batch.src_image, batch.trg_image,
                              batch.pose_src2trg, cfg.loss,
                              gt_disparity=batch.gt_disparity,
                              gt_valid=batch.gt_valid,
                              render_cfg=cfg.render)["total"]

    return loss


def make_golden_pallas() -> dict:
    from jax.experimental.pallas import tpu as pltpu

    from lsi_tpu.config import get_config
    from lsi_tpu.geometry.ldi import resolve_use_pallas
    from make_torch_golden_mpi import toy_mpi
    from make_torch_golden_quality import toy_quality

    if not resolve_use_pallas("on"):
        raise RuntimeError("LSI_TPU_FORCE_PALLAS did not take effect")
    arrays = {}
    with pltpu.force_tpu_interpret_mode():
        for i, case in enumerate(GATHER_CASES):
            arrays.update({f"gather{i}/{k}": v
                           for k, v in gather_case(*case).items()})
        for name, toy, max_dy, fixture, loss, tilt in (
                ("quality", toy_quality, QUALITY_MAX_DY,
                 "torch_golden_quality_toy.npz", quality_loss, 0.0),
                ("mpi", toy_mpi, MPI_MAX_DY, "torch_golden_mpi_toy.npz",
                 mpi_loss, MPI_TILT)):
            base = toy(get_config)
            cfg = on_route(base, max_dy)
            out, recorded = steps(cfg, os.path.join(DATA, fixture),
                                  loss(cfg), tilt)
            if recorded != json.loads(json.dumps(dataclasses.asdict(base))):
                raise RuntimeError(f"{fixture} was recorded with another "
                                   "config than this script's toy cut")
            arrays.update({f"{name}/{k}": v for k, v in out.items()})
    return arrays


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    arrays = make_golden_pallas()
    np.savez_compressed(args.out, **arrays)
    for k in sorted(arrays):
        if "/metrics/" in k or k.endswith(("max_dy",)):
            print(k, arrays[k])
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
