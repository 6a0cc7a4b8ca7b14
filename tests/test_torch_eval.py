"""The port's evaluation vs the JAX package's: PSNR, the mask-aware SSIM
and the depth metrics, the occluded-region metrics, the eval step on a
model and a multi-object batch, the eval data split, and the image grid.

JAX runs on its lax path (the CPU default); no Pallas kernel runs here.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lsi_tpu.config import get_config as j_get_config
from lsi_tpu.data import pipeline as jpipe
from lsi_tpu.evaluation import metrics as jmetrics
from lsi_tpu.evaluation import occlusion as jocc
from lsi_tpu.evaluation import runner as jrunner
from lsi_tpu.geometry.ldi import LDI as JLDI
from lsi_tpu_torch.config import get_config
from lsi_tpu_torch.data import pipeline as tpipe
from lsi_tpu_torch.evaluation import metrics as tmetrics
from lsi_tpu_torch.evaluation import occlusion as tocc
from lsi_tpu_torch.evaluation import runner as trunner
from lsi_tpu_torch.geometry.ldi import LDI
from lsi_tpu_torch.models.convert import state_dict_from_jax
from lsi_tpu_torch.models.ldi_predictor import LDIPredictor
from test_torch_consistency import GOLDEN, scene, toy_quality
from test_torch_train import unflatten

# Metrics: the same float32 arithmetic in the same order, on the CPU: 1e-5.
RTOL = 1e-5


def images(rng, b=2, h=24, w=32):
    pred = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(
        np.float32)
    mask = (rng.uniform(size=(b, h, w, 1)) < 0.8).astype(np.float32)
    return pred, target, mask


@pytest.mark.parametrize("masked", [False, True])
def test_psnr_and_ssim_match_jax(rng, masked):
    pred, target, mask = images(rng)
    m = mask if masked else None
    for name in ("psnr", "ssim"):
        got = getattr(tmetrics, name)(
            torch.from_numpy(pred), torch.from_numpy(target),
            mask=None if m is None else torch.from_numpy(m))
        want = getattr(jmetrics, name)(jnp.asarray(pred), jnp.asarray(target),
                                       mask=m)
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("with_valid", [False, True])
def test_depth_metrics_match_jax(rng, with_valid):
    gt = rng.uniform(0.05, 0.6, (2, 12, 16, 1)).astype(np.float32)
    gt[0, :2] = 0.0  # no ground truth there
    pred = (gt * rng.uniform(0.7, 1.4, gt.shape)).astype(np.float32)
    valid = (rng.uniform(size=gt.shape) < 0.7).astype(np.float32) \
        if with_valid else None
    got = tmetrics.depth_metrics(
        torch.from_numpy(pred), torch.from_numpy(gt),
        None if valid is None else torch.from_numpy(valid))
    want = jmetrics.depth_metrics(jnp.asarray(pred), jnp.asarray(gt), valid)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)


def test_occlusion_metrics_match_jax(rng):
    (tex, disp, *_), K, pose, _, trg, gt, gv = scene(rng)
    got = tocc.occlusion_metrics(
        LDI(*map(torch.from_numpy, (tex, disp, K))), torch.from_numpy(pose),
        torch.from_numpy(gt), trg_gt_valid=torch.from_numpy(gv),
        trg_image=torch.from_numpy(trg))
    want = jax.jit(jocc.occlusion_metrics)(
        JLDI(*map(jnp.asarray, (tex, disp, K))), jnp.asarray(pose),
        jnp.asarray(gt), trg_gt_valid=jnp.asarray(gv),
        trg_image=jnp.asarray(trg))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)
    assert float(got["occ_fraction"]) > 0


def test_eval_step_matches_jax():
    """One eval step of the toy quality model (the golden fixture's
    params) on a held-out multi-object batch. The model's float32
    convolutions sum in another order than XLA's: 1e-4 on the ratios and
    errors; the delta_* counts may differ by one pixel of their mask."""
    golden = np.load(GOLDEN)
    params = {k[len("params/"):]: golden[k] for k in golden.files
              if k.startswith("params/")}
    cfg, jcfg = toy_quality(get_config), toy_quality(j_get_config)
    net = LDIPredictor(cfg.model)
    net.load_state_dict(state_dict_from_jax(params, cfg.model))
    data = trunner.eval_data_config(cfg.data)
    assert dataclasses.asdict(data) == dataclasses.asdict(
        jrunner.eval_data_config(jcfg.data))
    batch = next(jpipe._batch_stream(jrunner.eval_data_config(jcfg.data), 1,
                                     True))
    want, j_rgb, _ = jrunner.build_eval_step(jcfg)(unflatten(params), batch)
    got, rgb, ldi = trunner.build_eval_step(cfg)(
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
    assert not ldi.textures.requires_grad


def test_image_grid_matches_jax(rng, tmp_path):
    """The grid PNG (written with zlib, no image package) decodes to the
    pixels of the JAX package's (written with PIL)."""
    b, h, w = 3, 8, 12
    src = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    trg = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    rendered = rng.uniform(-0.2, 1.2, (b, h, w, 3)).astype(np.float32)
    tex = rng.uniform(size=(b, 2, h, w, 3)).astype(np.float32)
    disp = rng.uniform(0.1, 0.8, (b, 2, h, w, 1)).astype(np.float32)
    K = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    fields = dict(src_image=src, trg_image=trg, intrinsics=K,
                  pose_src2trg=np.tile(np.eye(4, dtype=np.float32),
                                       (b, 1, 1)))
    jrunner.export_image_grid(jpipe.Batch(**fields), rendered,
                              JLDI(*map(jnp.asarray, (tex, disp, K))),
                              str(tmp_path / "jax"))
    trunner.export_image_grid(
        tpipe.Batch(**{k: torch.from_numpy(v) for k, v in fields.items()}),
        torch.from_numpy(rendered), LDI(*map(torch.from_numpy,
                                             (tex, disp, K))),
        str(tmp_path / "port"))
    pngs = [np.asarray(Image.open(tmp_path / d / "eval_grid.png"))
            for d in ("jax", "port")]
    assert pngs[0].shape == (b * h, 4 * w, 3)
    np.testing.assert_array_equal(pngs[1], pngs[0])
