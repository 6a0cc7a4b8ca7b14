"""The deterministic splat (``render.splat_method="sort"``) against the
JAX package's sort path.

The plain sort splat (the CPU path of K1-D, ``splat_cuda.splat(...,
deterministic=True)``) against ``lsi_tpu.ops.splat.splat_bilinear(...,
method="sort")``: forward and the three gradients, snapped, unsnapped
(the gather's transpose), windowed with ``base_rows``, every corner off
the image, NaN coordinates (ROADMAP H11), and two calls bitwise equal.
Then every caller JAX threads ``splat_method`` through, with "sort":
the render, the splat loss, the two-prediction loss, an eval batch and
the trajectory sweep. The halo render's "sort" case is in
tests/test_torch_spatial.py.

JAX runs on its lax path (the CPU default); no Pallas kernel runs here.
K1-D itself runs only on a CUDA card: tests/test_torch_cuda.py.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsi_tpu.config import LossConfig as JLossConfig
from lsi_tpu.config import RenderConfig as JRenderConfig
from lsi_tpu.config import get_config as j_get_config
from lsi_tpu.data import pipeline as jpipe
from lsi_tpu.evaluation import runner as jrunner
from lsi_tpu.evaluation import trajectory as jtraj
from lsi_tpu.geometry import ldi as jldi
from lsi_tpu.losses import losses as jlosses
from lsi_tpu.ops import gather as jgather
from lsi_tpu.ops import splat as jsplat
from lsi_tpu_torch.config import LossConfig, RenderConfig, get_config
from lsi_tpu_torch.data import pipeline as tpipe
from lsi_tpu_torch.evaluation import runner as trunner
from lsi_tpu_torch.evaluation import trajectory as ttraj
from lsi_tpu_torch.geometry.ldi import LDI, render_forward
from lsi_tpu_torch.kernels import splat_cuda
from lsi_tpu_torch.losses import losses as tlosses
from lsi_tpu_torch.models.convert import state_dict_from_jax
from lsi_tpu_torch.models.ldi_predictor import LDIPredictor
from lsi_tpu_torch.ops import splat as tsplat
from test_torch_consistency import GOLDEN as QUALITY_GOLDEN
from test_torch_consistency import RENDER
from test_torch_consistency import check as check_pair
from test_torch_consistency import quality_loss, scene, toy_quality
from test_torch_losses import check as check_one
from test_torch_losses import ldi_case
from test_torch_splat import OUT_HW, cotangents, splat_case
from test_torch_trajectory import FRAME_ATOL, pair
from test_torch_train import unflatten

SORT = RenderConfig(splat_method="sort")
J_SORT = JRenderConfig(splat_method="sort")
KINDS = ["random", "integer", "near_integer", "out_of_image", "huge"]


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def jax_sort(values, coords, weights, out_hw=OUT_HW, **kw):
    acc, ws = jsplat.splat_bilinear(jnp.asarray(values), jnp.asarray(coords),
                                    jnp.asarray(weights), out_hw,
                                    method="sort", **kw)
    return np.asarray(acc), np.asarray(ws)


# ------------------------------------------------------ the plain version

@pytest.mark.parametrize("kind", KINDS)
def test_sort_splat_matches_jax(rng, kind):
    """The same products, summed in the same sorted order from 0.0: JAX's
    sums, bitwise."""
    values, coords, weights = splat_case(rng, kind)
    acc, ws = tsplat.splat_bilinear(*t(values, coords, weights), OUT_HW,
                                    method="sort")
    j_acc, j_ws = jax_sort(values, coords, weights)
    np.testing.assert_array_equal(acc.numpy(), j_acc)
    np.testing.assert_array_equal(ws.numpy(), j_ws)
    # The same function as the scatter path: sums of the same terms.
    ref = tsplat.splat_bilinear(*t(values, coords, weights), OUT_HW)
    torch.testing.assert_close(acc, ref[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ws, ref[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_sort_splat_gradients_match_jax(rng, kind):
    """SplatFn with the deterministic forward: its three gradients against
    jax.vjp of JAX's sort path (the scatter path's VJP, as the port's
    backward is), at tests/test_torch_splat.py's 1e-5."""
    values, coords, weights = splat_case(rng, kind)
    g_accum, g_wsum = cotangents(rng, values.shape[0], values.shape[-1])
    _, f = jax.vjp(lambda v, c, w: jsplat.splat_bilinear(
        v, c, w, OUT_HW, method="sort"), *map(jnp.asarray, (values, coords,
                                                           weights)))
    want = [np.asarray(d) for d in f((jnp.asarray(g_accum),
                                      jnp.asarray(g_wsum)))]
    ins = [x.requires_grad_() for x in t(values, coords, weights)]
    outs = splat_cuda.SplatFn.apply(*ins, OUT_HW, -1, None, 0, True)
    got = torch.autograd.grad(outs, ins, t(g_accum, g_wsum))
    for name, g, w in zip(("d_values", "d_coords", "d_weights"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("max_dy,offset", [(0, 0), (1, 3), (2, 2)])
def test_windowed_sort_splat_matches_jax(rng, max_dy, offset):
    """The window with explicit base rows (a height shard's: r % fold_h +
    offset), through the wrapper's CPU path."""
    values, coords, weights = splat_case(rng, "random")
    out_hw = (OUT_HW[0] + 2 * offset, OUT_HW[1])
    base = np.arange(values.shape[1]) % OUT_HW[0] + offset
    coords = coords + np.array([0.0, offset], np.float32)
    acc, ws = splat_cuda.splat(*t(values, coords, weights), out_hw,
                               max_dy=max_dy, fold_h=OUT_HW[0],
                               base_offset=offset, deterministic=True)
    j_acc, j_ws = jax_sort(values, coords, weights, out_hw,
                           max_dy_window=max_dy,
                           base_rows=jnp.asarray(base, jnp.int32))
    np.testing.assert_array_equal(acc.numpy(), j_acc)
    np.testing.assert_array_equal(ws.numpy(), j_ws)
    full = jax_sort(values, coords, weights, out_hw)[1]
    assert float(ws.sum()) < float(full.sum())  # the window dropped some


def test_unsnapped_sort_splat_is_jax_gather_transpose(rng):
    """snap=False (the gather's image gradient): the transpose of JAX's
    exact bilinear gather, whose VJP in the image sums the same corner
    terms."""
    values, coords, weights = splat_case(rng, "out_of_image")
    acc, ws = tsplat.splat_bilinear(*t(values, coords, weights), OUT_HW,
                                    snap=False, method="sort")
    image = jnp.zeros((values.shape[0],) + OUT_HW + (values.shape[-1] + 1,))
    _, f = jax.vjp(lambda im: jgather.bilinear_sample(
        im, jnp.asarray(coords))[0], image)
    (want,) = f(jnp.asarray(np.concatenate([values * weights, weights], -1)))
    want = np.asarray(want)
    np.testing.assert_allclose(acc.numpy(), want[..., :-1], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ws.numpy(), want[..., -1:], rtol=1e-5,
                               atol=1e-5)


def test_sort_splat_all_out_of_bounds(rng):
    values, coords, weights = splat_case(rng, "random")
    coords = coords + np.array([-4.0 * OUT_HW[1], 0.0], np.float32)
    acc, ws = tsplat.splat_bilinear(*t(values, coords, weights), OUT_HW,
                                    method="sort")
    j_acc, j_ws = jax_sort(values, coords, weights)
    assert not np.abs(j_acc).any() and not np.abs(j_ws).any()
    assert not acc.abs().any() and not ws.abs().any()


def test_sort_splat_nan_coordinates(rng):
    """ROADMAP H11 as recorded: the port drops a pixel with a NaN
    coordinate. JAX on the CPU converts the NaN x to 0 and adds NaN to the
    four pixels at x 0 and 1 around the pixel's row; everywhere else the
    two agree bitwise."""
    values, coords, weights = splat_case(rng, "random", n=1)
    bad = coords.copy()
    bad[0, 5, 7] = [np.nan, 3.5]
    acc, ws = tsplat.splat_bilinear(*t(values, bad, weights), OUT_HW,
                                    method="sort")
    j_acc, j_ws = jax_sort(values, bad, weights)
    nan = np.isnan(j_acc).any(-1)
    assert nan.sum() == 4 and nan[0, 3:5, :2].all()
    np.testing.assert_array_equal(acc.numpy()[~nan], j_acc[~nan])
    np.testing.assert_array_equal(ws.numpy()[~nan], j_ws[~nan])
    keep = np.ones_like(weights)
    keep[0, 5, 7] = 0.0
    want = tsplat.splat_bilinear(*t(values, coords, weights * keep), OUT_HW,
                                 method="sort")
    torch.testing.assert_close(acc, want[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ws, want[1], rtol=1e-6, atol=1e-6)


def test_sort_splat_is_bitwise_repeatable(rng):
    """Two calls bitwise equal, also through the wrapper, which on the CPU
    takes the plain version and counts no launch."""
    args = t(*splat_case(rng, "huge"))
    first = tsplat.splat_bilinear(*args, OUT_HW, method="sort")
    before = (splat_cuda.splat.launches, splat_cuda.splat.sort_launches)
    for _ in range(2):
        again = splat_cuda.splat(*args, OUT_HW, deterministic=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert (splat_cuda.splat.launches,
            splat_cuda.splat.sort_launches) == before


def test_sort_splat_refuses_what_int32_keys_cannot_hold():
    """K1-D's keys are int32: 4 N Hs Ws corners below 2^31 and N out_h
    out_w targets below INT_MAX, else ValueError before any launch; the
    largest shape in the repo (highres b64, 403M corners) fits."""
    splat_cuda.check_sort_sizes((64, 1024, 1536, 4), (512, 1536))
    with pytest.raises(ValueError):
        splat_cuda.check_sort_sizes((384, 1024, 1536, 4), (512, 1536))
    with pytest.raises(ValueError):
        splat_cuda.check_sort_sizes((1, 8, 8, 4), (2**16, 2**15))
    with pytest.raises(ValueError):
        tsplat.splat_bilinear(*t(*splat_case(np.random.default_rng(0),
                                             "random")), OUT_HW,
                              method="segment")


# --------------------------------------------------------------- callers

@pytest.mark.parametrize("use_pallas", ["auto", "on"])
def test_render_sort_matches_jax(rng, use_pallas):
    """render_forward with splat_method="sort": JAX's exact sort render
    ("auto"), and on the windowed route the port's windowed scatter render,
    the same function (JAX's route is its Pallas kernel, deterministic
    already); gradients in the textures and disparities."""
    case = ldi_case(rng)
    tex, disp, K, pose = case[:4]

    def loss(ldi, pose, trg, *_):
        out = render_forward(ldi, pose, zbuffer_scale=50.0,
                             splat_method="sort", use_pallas=use_pallas,
                             pallas_max_dy=1)
        return ((out["rgb"] - trg) ** 2).mean() + out["disparity"].mean()

    if use_pallas == "auto":
        def jloss(ldi, pose, trg, *_):
            out = jldi.render_forward(ldi, pose, zbuffer_scale=50.0,
                                      splat_method="sort")
            return (jnp.mean((out["rgb"] - trg) ** 2)
                    + jnp.mean(out["disparity"]))
        check_one(case, jloss, loss)
        return
    args = t(tex, disp, K)
    outs = []
    for method in ("sort", "scatter", "sort"):
        outs.append(render_forward(
            LDI(*args), torch.from_numpy(pose), zbuffer_scale=50.0,
            splat_method=method, use_pallas="on", pallas_max_dy=0))
    for k in ("rgb", "disparity", "coverage"):
        assert torch.equal(outs[0][k], outs[2][k])
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=1e-5,
                                   atol=1e-6)
    assert float(outs[0]["window_dropped_frac"]) > 0


def test_splat_loss_sort_matches_jax(rng):
    check_one(ldi_case(rng),
              lambda ldi, pose, trg, *_: jlosses.view_synthesis_splat(
                  ldi, trg, pose, J_SORT),
              lambda ldi, pose, trg, *_: tlosses.view_synthesis_splat(
                  ldi, trg, pose, SORT))


def test_bidirectional_loss_sort_matches_jax(rng):
    """The quality recipe's two-prediction loss (photometric splat both
    ways, the disocclusion pseudo-label, the visible anchor) with every
    render on the sort splat."""
    kw = quality_loss()
    jcfg, tcfg = JLossConfig(**kw), LossConfig(**kw)
    jr = JRenderConfig(splat_method="sort", **RENDER)
    tr = RenderConfig(splat_method="sort", **RENDER)
    check_pair(scene(rng),
               lambda s, d, pose, src, trg, gt, gv:
               jlosses.total_loss_bidirectional(
                   s, d, src, trg, pose, jcfg, jr, gt_disparity=gt,
                   gt_valid=gv)["total"],
               lambda s, d, pose, src, trg, gt, gv:
               tlosses.total_loss_bidirectional(
                   s, d, src, trg, pose, tcfg, tr, gt_disparity=gt,
                   gt_valid=gv)["total"])


def test_eval_step_sort_matches_jax():
    """One eval step of the toy quality model with render.splat_method
    "sort" (the tolerances of tests/test_torch_eval.py)."""
    golden = np.load(QUALITY_GOLDEN)
    params = {k[len("params/"):]: golden[k] for k in golden.files
              if k.startswith("params/")}

    def sort(cfg):
        return cfg.replace(render=dataclasses.replace(cfg.render,
                                                      splat_method="sort"))

    cfg, jcfg = sort(toy_quality(get_config)), sort(toy_quality(j_get_config))
    net = LDIPredictor(cfg.model)
    net.load_state_dict(state_dict_from_jax(params, cfg.model))
    batch = next(jpipe._batch_stream(jrunner.eval_data_config(jcfg.data), 1,
                                     True))
    want, j_rgb, _ = jrunner.build_eval_step(jcfg)(unflatten(params), batch)
    got, rgb, _ = trunner.build_eval_step(cfg)(
        net, tpipe.Batch(**{k: torch.from_numpy(np.asarray(v))
                            for k, v in dataclasses.asdict(batch).items()}))
    assert sorted(got) == sorted(want)
    pixels = np.prod(batch.trg_image.shape[:3])
    for k, v in want.items():
        if "_delta_" in k:
            share = float(want["occ_fraction"]) if "occ" in k else 1.0
            atol, rtol = 1.0001 / (pixels * share), 0.0
        else:
            atol, rtol = 1e-6, 1e-4
        np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=1e-4)


def test_trajectory_sort_matches_jax():
    """Arbitrary poses (translations only, exact projections: the H10
    practice of tests/test_torch_trajectory.py) rendered with the sort
    splat: JAX's frames within 1e-5."""
    rng = np.random.default_rng(0)
    h, w = 32, 64
    disp = np.full((1, 2, h, w, 1), 0.25)
    disp[:, 0, 8:24, 16:40] = 0.5
    disp[:, 1] = 0.125
    K = np.array([[[64.0, 0, 31.5], [0, 64.0, 15.5], [0, 0, 1]]])
    jl, tl = pair(rng.uniform(size=(1, 2, h, w, 3)), disp, K)
    poses = torch.zeros(5, 4, 4) + torch.eye(4)
    poses[:, 0, 3] = torch.tensor([0.2, -0.1, 0.05, -0.15, 0.1])
    want, _ = jtraj._render_poses(jl, jnp.asarray(poses.numpy()), J_SORT,
                                  chunk=2)
    got = ttraj.render_trajectory(tl, poses=poses, render_cfg=SORT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FRAME_ATOL, rtol=0)
    again = ttraj.render_trajectory(tl, poses=poses, render_cfg=SORT)
    assert torch.equal(got, again)
