"""The port's height-sharded render (``lsi_tpu_torch/parallel/spatial.py``)
over gloo ranks on the CPU against JAX: ``tests/test_spatial.py``'s cases
at its tolerances (pure translation, vertical motion, motion beyond the
window, the LDI gradient, a 2x2 data x space grid, the thin-shard
ValueError), at S = 2 and 4.

The JAX numbers are those of its windowed single-device render, assembled
as test_spatial.py assembles it, which JAX's ``render_forward_spatial`` is
held to there ("spatial must equal the windowed global reference"), eager
as JAX's tests run. JAX's spatial render itself is not called: eager,
shard_map takes ~25 s a call here; jitted, XLA moves the projection's
coordinates by an ulp, which flips pixel-edge decisions (4e-4 in rgb,
ROADMAP H10); and it shifts the first shard's coordinates by -pad, which
rounds (2.1e-5 in rgb at one pixel of the beyond-window case), where the
port keeps the first shard unshifted and equals the windowed render
(``shard_splat_args``; PARITY.md).

JAX runs first, in this process; the port's ranks are spawned processes
(``parallel.launch.spawn``: the ``spawn`` start method, a file store under
``tmp_path``, one thread each, a timeout on every collective and join),
which import neither JAX nor this file. One spawn per grid runs all of
that grid's cases.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import concurrent.futures

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsi_tpu.geometry import projection
from lsi_tpu.geometry.ldi import LDI as JLDI
from lsi_tpu.geometry.ldi import _window_dropped_fraction
from lsi_tpu.geometry.transforms import translation_pose
from lsi_tpu.ops.splat import splat_bilinear
from lsi_tpu.utils.helpers import divide_safe
from lsi_tpu_torch.geometry.ldi import LDI, render_forward
from lsi_tpu_torch.parallel import launch
from lsi_tpu_torch.parallel.mesh import ProcessPlan
from lsi_tpu_torch.parallel.spatial import render_forward_spatial

TOL = dict(rtol=1e-5, atol=1e-5)          # tests/test_spatial.py
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ZSCALE = 30.0

# name: (pose translation, max_dy) -- test_spatial.py's motions.
CASES = {
    "pure_translation": ([-0.3, 0.0, 0.0], 1),
    "vertical_motion": ([-0.2, 0.02, 0.0], 2),
    "beyond_window": ([-0.1, 0.15, 0.0], 2),
}


def make_ldi(rng, b=1, l=2, h=32, w=128):
    """tests/test_spatial.py's LDI, as numpy."""
    tex = rng.uniform(size=(b, l, h, w, 3)).astype(np.float32)
    disp = np.sort(rng.uniform(0.05, 0.5, (b, l, h, w, 1)),
                   axis=1)[:, ::-1].astype(np.float32).copy()
    K = np.array([[0.9 * w, 0, (w - 1) / 2], [0, 0.9 * w, (h - 1) / 2],
                  [0, 0, 1]], np.float32)
    return {"textures": tex, "disparities": disp,
            "intrinsics": np.broadcast_to(K, (b, 3, 3)).copy()}


def j_ldi(a):
    return JLDI(textures=jnp.asarray(a["textures"]),
                disparities=jnp.asarray(a["disparities"]),
                intrinsics=jnp.asarray(a["intrinsics"]))


def pose_of(t, b):
    return np.asarray(translation_pose(np.tile(np.asarray([t], np.float32),
                                               (b, 1))))


def jax_windowed_render(ldi, pose, max_dy):
    """JAX's single-device windowed render, assembled as
    tests/test_spatial.py::test_spatial_window_matches_windowed_global
    assembles it: the render ``render_forward_spatial`` is held to."""
    b, l, h, w, _ = ldi.textures.shape
    rep = lambda m: jnp.repeat(m, l, axis=0)
    tc, td, valid = projection.forward_project(
        ldi.disparities.reshape(b * l, h, w, 1), rep(ldi.intrinsics),
        rep(ldi.intrinsics), rep(pose))
    tc = tc.reshape(b, l * h, w, 2)
    td = td.reshape(b, l * h, w, 1)
    valid = valid.reshape(b, l * h, w, 1)
    d_shift = jax.lax.stop_gradient(jnp.maximum(jnp.max(
        jnp.where(valid > 0, td, -jnp.inf), axis=(1, 2, 3), keepdims=True),
        0.0))
    weights = jnp.exp(jnp.float32(ZSCALE) * (td - d_shift)) * valid
    payload = jnp.concatenate(
        [ldi.textures.astype(jnp.float32).reshape(b, l * h, w, 3), td], -1)
    accum, wsum = splat_bilinear(payload, tc, weights, (h, w),
                                 max_dy_window=max_dy)
    out = divide_safe(accum, wsum, eps=0.0)
    return {"rgb": out[..., :3], "disparity": out[..., 3:], "coverage": wsum}


def jax_case(arrays, pose, max_dy, target):
    """JAX's windowed render, and its loss and LDI gradient (eager)."""
    ldi = j_ldi(arrays)
    pose = jnp.asarray(pose)

    def loss(disp):
        l2 = JLDI(textures=ldi.textures, disparities=disp,
                  intrinsics=ldi.intrinsics)
        return jnp.mean((jax_windowed_render(l2, pose, max_dy)["rgb"]
                         - target) ** 2)

    res = {k: np.asarray(v) for k, v in
           jax_windowed_render(ldi, pose, max_dy).items()}
    value, grad = jax.value_and_grad(loss)(ldi.disparities)
    res.update(loss=float(value), grad=np.asarray(grad))
    return res


def assemble(results, key, b, h):
    """The ranks' (B_local, hd, ...) pieces back into the global array."""
    data = 1 + max(r["data_rank"] for r in results)
    space = 1 + max(r["space_rank"] for r in results)
    bl, hd = b // data, h // space
    out = None
    for r in results:
        v = r[key]
        if out is None:
            out = np.zeros((b, h) + v.shape[2:], v.dtype)
        out[r["data_rank"] * bl:(r["data_rank"] + 1) * bl,
            r["space_rank"] * hd:(r["space_rank"] + 1) * hd] = v
    return out


GRIDS = {(1, 2): 1, (1, 4): 1, (2, 2): 2}   # (data, space): batch


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """Per (data x space) grid and case: (JAX's result, the port ranks'
    results, the arrays). JAX runs first; then the grids' ranks, the
    three groups spawned at once (each spawn mostly waits for its
    processes to start)."""
    jax_res, spawns = {}, {}
    for (data, space), b in GRIDS.items():
        rng = np.random.default_rng(0)
        arrays = make_ldi(rng, b=b)
        _, _, h, w, _ = arrays["textures"].shape
        target = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
        cases = list(CASES) if data == 1 else ["pure_translation"]
        args = []
        for name in cases:
            t, max_dy = CASES[name]
            pose = pose_of(t, b)
            jax_res[(data, space), name] = (jax_case(arrays, pose, max_dy,
                                                     target), arrays)
            args.append((launch.spatial_render,
                         (arrays, pose, ZSCALE, max_dy, target)))
        spawns[(data, space)] = (cases, args)
    with concurrent.futures.ThreadPoolExecutor(len(GRIDS)) as pool:
        ranks = {grid: pool.submit(
            launch.spawn, launch.in_turn, grid[0] * grid[1], args,
            init_file=tmp_path_factory.mktemp("store") / "store",
            device="cpu", space=grid[1])
            for grid, (_, args) in spawns.items()}
        ranks = {grid: f.result() for grid, f in ranks.items()}
    return {grid: {name: (jax_res[grid, name][0],
                          [r[i] for r in ranks[grid]],
                          jax_res[grid, name][1])
                   for i, name in enumerate(cases)}
            for grid, (cases, _) in spawns.items()}


@pytest.mark.parametrize("grid", [(1, 2), (1, 4)])
@pytest.mark.parametrize("case", list(CASES))
def test_spatial_render_matches_jax(grids, grid, case):
    jax_res, ranks, arrays = grids[grid][case]
    b, _, h = arrays["textures"].shape[:3]
    for key in ("rgb", "disparity", "coverage"):
        np.testing.assert_allclose(assemble(ranks, key, b, h), jax_res[key],
                                   **TOL, err_msg=key)
    if case == "beyond_window":
        # The motion really exceeds the window (else the case is vacuous):
        # the port's exact render differs.
        ldi = LDI(*(torch.from_numpy(arrays[k])
                    for k in ("textures", "disparities", "intrinsics")))
        exact = render_forward(ldi, torch.tensor(pose_of(CASES[case][0], b)),
                               zbuffer_scale=ZSCALE)["rgb"].numpy()
        assert np.abs(exact - jax_res["rgb"]).max() > 1e-3


@pytest.mark.parametrize("grid", [(1, 2), (1, 4)])
@pytest.mark.parametrize("case", list(CASES))
def test_spatial_render_gradient_matches_jax(grids, grid, case):
    """The loss over the global image and its gradient with respect to the
    LDI's disparities, through the halo exchange's backward."""
    jax_res, ranks, arrays = grids[grid][case]
    b, _, h = arrays["textures"].shape[:3]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], jax_res["loss"], rtol=1e-5)
    grad = np.moveaxis(assemble(
        [dict(r, g=np.moveaxis(r["grad_disparities"], 2, 1)) for r in ranks],
        "g", b, h), 1, 2)
    np.testing.assert_allclose(grad, jax_res["grad"], **GRAD_TOL)
    assert np.abs(grad).max() > 0


def test_spatial_composes_with_data_axis(grids):
    """2 x 2 (data x space): batch and height shard independently."""
    jax_res, ranks, arrays = grids[(2, 2)]["pure_translation"]
    b, _, h = arrays["textures"].shape[:3]
    assert sorted((r["data_rank"], r["space_rank"]) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    np.testing.assert_allclose(assemble(ranks, "rgb", b, h), jax_res["rgb"],
                               **TOL)
    grad = np.moveaxis(assemble(
        [dict(r, g=np.moveaxis(r["grad_disparities"], 2, 1)) for r in ranks],
        "g", b, h), 1, 2)
    np.testing.assert_allclose(grad, jax_res["grad"], **GRAD_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_render_matches_the_spatial_render(grids, case):
    """The single-device windowed render (the spatial render's reference
    on the card) equals the spatial render."""
    jax_res, ranks, arrays = grids[(1, 4)][case]
    t, max_dy = CASES[case]
    ldi = LDI(*(torch.from_numpy(arrays[k])
                for k in ("textures", "disparities", "intrinsics")))
    out = render_forward(ldi, torch.tensor(pose_of(t, 1)),
                         zbuffer_scale=ZSCALE, use_pallas="on",
                         pallas_max_dy=max_dy)
    for key in ("rgb", "disparity", "coverage"):
        np.testing.assert_allclose(out[key].numpy(),
                                   assemble(ranks, key, 1, 32), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_render_matches_jax(case):
    """``render_forward(..., use_pallas="on", pallas_max_dy=)`` (one
    process) against JAX's windowed render, and its ``window_dropped_frac``
    against JAX's count of the dropped tent mass on the same projection;
    a render at another ``out_hw`` takes the exact splat, as JAX's route
    does."""
    rng = np.random.default_rng(3)
    arrays = make_ldi(rng, b=2)
    t, max_dy = CASES[case]
    pose = pose_of(t, 2).copy()
    ldi = LDI(*(torch.from_numpy(arrays[k])
                for k in ("textures", "disparities", "intrinsics")))
    out = render_forward(ldi, torch.from_numpy(pose), zbuffer_scale=ZSCALE,
                         use_pallas="on", pallas_max_dy=max_dy)
    jldi = j_ldi(arrays)
    want = jax_windowed_render(jldi, jnp.asarray(pose), max_dy)
    for key in ("rgb", "disparity", "coverage"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   **TOL)
    b, l, h, w, _ = arrays["textures"].shape
    rep = lambda m: jnp.repeat(m, l, axis=0)
    tc, _, valid = projection.forward_project(
        jldi.disparities.reshape(b * l, h, w, 1), rep(jldi.intrinsics),
        rep(jldi.intrinsics), rep(jnp.asarray(pose)))
    dropped = _window_dropped_fraction(tc.reshape(b, l * h, w, 2),
                                       valid.reshape(b, l * h, w, 1),
                                       (h, w), max_dy)
    np.testing.assert_allclose(float(out["window_dropped_frac"]),
                               float(dropped), rtol=1e-5, atol=1e-7)
    # Only the motion beyond the window drops tent mass.
    assert (float(out["window_dropped_frac"]) > 0.0) == (
        case == "beyond_window")
    other = render_forward(ldi, torch.from_numpy(pose), out_hw=(h + 2, w),
                           zbuffer_scale=ZSCALE, use_pallas="on",
                           pallas_max_dy=max_dy)
    exact = render_forward(ldi, torch.from_numpy(pose), out_hw=(h + 2, w),
                           zbuffer_scale=ZSCALE)
    for key in ("rgb", "disparity", "coverage"):
        assert torch.equal(other[key], exact[key])
    assert float(other["window_dropped_frac"]) == 0.0


def test_spatial_rejects_thin_shards():
    """pad = max_dy + 2 rows must fit a shard (raised before any
    collective, so one process shows it)."""
    rng = np.random.default_rng(0)
    a = make_ldi(rng, h=8)
    plan = ProcessPlan(rank=0, world_size=4, space=4)
    shard = LDI(*(torch.from_numpy(a[k][:, :, :2] if k != "intrinsics"
                                   else a[k])
                  for k in ("textures", "disparities", "intrinsics")))
    with pytest.raises(ValueError, match="halo pad"):
        render_forward_spatial(shard, torch.eye(4)[None], plan,
                               pallas_max_dy=2)
