"""The port's training losses vs the JAX package's, values and gradients
(``jax.grad`` vs autograd) in the LDI's textures and disparities, at L=3
with ties: two layers equal over part of the image (ties in the min over
layers), every layer in the image over most of it (ties in the max of
``valid``), and layers pushed off the image (ties among invalid layers).

JAX runs on its lax path (the CPU default); no Pallas kernel runs here.
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
from lsi_tpu.geometry import transforms as jtf
from lsi_tpu.geometry.ldi import LDI as JLDI
from lsi_tpu.losses import losses as jlosses
from lsi_tpu_torch.config import LossConfig, RenderConfig
from lsi_tpu_torch.geometry.ldi import LDI
from lsi_tpu_torch.losses import losses as tlosses

B, L, H, W = 2, 3, 16, 24


def ldi_case(rng):
    """(textures, disparities, K, pose, target, gt disparity, gt valid)."""
    tex = rng.uniform(size=(B, L, H, W, 3)).astype(np.float32)
    d0 = rng.uniform(0.25, 0.5, (B, 1, H, W, 1))
    disp = np.concatenate([d0, 0.6 * d0, 0.35 * d0], 1).astype(np.float32)
    # Layer 2 equals layer 1 on the left half: the min over layers ties.
    tex[:, 2, :, :W // 2] = tex[:, 1, :, :W // 2]
    disp[:, 2, :, :W // 2] = disp[:, 1, :, :W // 2]
    K = np.tile(np.array([[30.0, 0, (W - 1) / 2], [0, 30.0, (H - 1) / 2],
                          [0, 0, 1]], np.float32)[None], (B, 1, 1))
    pose = np.array(jtf.pose_from_euler(
        np.array([[0.0, 0.02, 0.0], [0.01, -0.03, 0.0]], np.float32),
        np.array([[-0.3, 0.0, 0.0], [0.2, 0.05, -0.1]], np.float32)))
    target = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    gt = rng.uniform(0.2, 0.6, (B, H, W, 1)).astype(np.float32)
    gt_valid = (rng.uniform(size=(B, H, W, 1)) < 0.7).astype(np.float32)
    return tex, disp, K, pose, target, gt, gt_valid


def run_both(case, jfn, tfn, has_aux=False):
    """Value and gradient in (textures, disparities) of one scalar loss,
    given as jfn(JLDI, *inputs) and tfn(LDI, *inputs); with ``has_aux``
    jfn returns (value, aux), and aux comes back last."""
    tex, disp, K, pose, target, gt, gt_valid = case
    rest = (pose, target, gt, gt_valid)

    def jloss(t, d):
        return jfn(JLDI(textures=t, disparities=d, intrinsics=jnp.asarray(K)),
                   *map(jnp.asarray, rest))

    j_val, j_grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=has_aux))(jnp.asarray(tex),
                                                 jnp.asarray(disp))
    j_val, aux = j_val if has_aux else (j_val, None)
    t = torch.from_numpy(tex).requires_grad_()
    d = torch.from_numpy(disp).requires_grad_()
    val = tfn(LDI(t, d, torch.from_numpy(K)), *map(torch.from_numpy, rest))
    grads = torch.autograd.grad(val, (t, d), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, (t, d))]
    return (float(val.detach()), [g.numpy() for g in grads],
            float(j_val), [np.asarray(g) for g in j_grads], aux)


def check(case, jfn, tfn, has_aux=False):
    """Compare value and gradients; returns jfn's aux."""
    val, grads, j_val, j_grads, aux = run_both(case, jfn, tfn, has_aux)
    assert np.isfinite(val) and val > 0
    # Same float32 math; the projection's 3x3 algebra sums in another
    # order, so coordinates and sampled colours differ by ~1e-5 px and
    # ~1e-7: 1e-5 on the value. Gradients: rtol 1e-4, plus 2e-3 of the
    # largest entry, because the Charbonnier slope x / sqrt(x^2 + eps^2)
    # turns fastest at a residual near 0 (curvature 1 / eps = 1e4), where
    # a 1e-7 residual difference moves it by 1e-3.
    np.testing.assert_allclose(val, j_val, rtol=1e-5)
    for name, g, jg in zip(("textures", "disparities"), grads, j_grads):
        scale = np.abs(jg).max()
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=2e-3 * scale,
                                   err_msg=name)
    return aux


def test_case_has_ties_and_invalid_layers(rng):
    """The inputs below exercise what the tie-splitting gradients need."""
    tex, disp, K, pose, target, _, _ = ldi_case(rng)
    from lsi_tpu_torch.geometry.ldi import gather_target_per_layer
    _, valid, _ = gather_target_per_layer(
        LDI(*map(torch.from_numpy, (tex, disp, K))),
        torch.from_numpy(target), torch.from_numpy(pose))
    valid = valid[..., 0]
    full = (valid > 0.5).all(dim=1).float().mean()
    none = (valid <= 0.5).all(dim=1).float().mean()
    some = ((valid <= 0.5).sum(dim=1) >= 2).float().mean()
    assert float(full) > 0.5        # any_valid ties at 1.0
    assert float(none) > 0.0        # pixels invalid in every layer
    assert float(some) > 0.02       # several invalid layers tie at 1e3


@pytest.mark.parametrize("min_over_layers,margin", [(True, 0.0),
                                                    (True, 0.02),
                                                    (False, 0.0)])
def test_inverse_warp_loss_matches_jax(rng, min_over_layers, margin):
    check(ldi_case(rng),
          lambda ldi, pose, trg, *_: jlosses.view_synthesis_inverse_warp(
              ldi, trg, pose, min_over_layers=min_over_layers,
              layer0_margin=margin),
          lambda ldi, pose, trg, *_: tlosses.view_synthesis_inverse_warp(
              ldi, trg, pose, min_over_layers=min_over_layers,
              layer0_margin=margin))


def test_splat_loss_matches_jax(rng):
    check(ldi_case(rng),
          lambda ldi, pose, trg, *_: jlosses.view_synthesis_splat(
              ldi, trg, pose, JRenderConfig()),
          lambda ldi, pose, trg, *_: tlosses.view_synthesis_splat(
              ldi, trg, pose, RenderConfig()))


@pytest.mark.parametrize("edge_aware,gate_deep", [(True, True),
                                                  (True, False),
                                                  (False, True)])
def test_smoothness_matches_jax(rng, edge_aware, gate_deep):
    check(ldi_case(rng),
          lambda ldi, *_: jlosses.disparity_smoothness(ldi, edge_aware,
                                                       gate_deep),
          lambda ldi, *_: tlosses.disparity_smoothness(ldi, edge_aware,
                                                       gate_deep))


def test_depth_supervision_matches_jax(rng):
    check(ldi_case(rng),
          lambda ldi, pose, trg, gt, gv: jlosses.depth_supervision(ldi, gt,
                                                                   gv),
          lambda ldi, pose, trg, gt, gv: tlosses.depth_supervision(ldi, gt,
                                                                   gv))


@pytest.mark.parametrize("photo_mode", ["both", "inverse_warp", "splat"])
def test_total_loss_matches_jax(rng, photo_mode):
    """Every part, and the gradient of ``total``; depth supervision on."""
    kw = dict(photo_mode=photo_mode, smoothness_weight=0.05,
              depth_supervision_weight=0.1, min_layer0_margin=0.01)
    jcfg = JLossConfig(**kw)
    tcfg = LossConfig(**kw)
    case = ldi_case(rng)
    parts = {}

    def jfn(ldi, pose, trg, gt, gv):
        out = jlosses.total_loss(ldi, trg, pose, jcfg, JRenderConfig(),
                                 gt_disparity=gt, gt_valid=gv)
        return out["total"], out

    def tfn(ldi, pose, trg, gt, gv):
        out = tlosses.total_loss(ldi, trg, pose, tcfg, RenderConfig(),
                                 gt_disparity=gt, gt_valid=gv)
        parts.update({k: float(v.detach()) for k, v in out.items()})
        return out["total"]

    want = check(case, jfn, tfn, has_aux=True)
    assert sorted(parts) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(parts[k], float(v), rtol=1e-5,
                                   atol=1e-8, err_msg=k)


@pytest.mark.parametrize("field,value", [("photo_layer0_weight", 0.1)])
def test_unported_loss_options_raise(rng, field, value):
    tex, disp, K, pose, target, _, _ = ldi_case(rng)
    ldi = LDI(*map(torch.from_numpy, (tex, disp, K)))
    cfg = dataclasses.replace(LossConfig(), **{field: value})
    with pytest.raises(NotImplementedError):
        tlosses.total_loss(ldi, torch.from_numpy(target),
                           torch.from_numpy(pose), cfg, RenderConfig())
