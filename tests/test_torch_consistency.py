"""The port's two-prediction losses vs the JAX package's: the disocclusion
mask, ``depth_consistency`` over the flag combinations the presets use and
each flag alone, and ``total_loss_bidirectional``, values and gradients
(``jax.grad`` vs autograd) in both predictions' textures and disparities;
the four stop-gradients; and the two-prediction train step (one fused
forward over src and trg) against ``lsi_tpu.train.trainer.make_train_step``.

The scene has a foreground block in the source's layer 0, so splatting
layer 0 leaves a disoccluded band beside it that the deeper layers fill.
Inputs stay where the soft z-buffer weights are far above float32's
denormals (disparity in [0.01, 1], ``zbuffer_scale`` 50: weights >= e^-50):
JAX on the CPU flushes denormals to zero and torch does not, so the tests
that decide ``coverage > 0``, ``coverage <= 0`` and ``wsum > 1e-30`` would
otherwise compare two different rules (ROADMAP H12).

JAX runs on its lax path (the CPU default); no Pallas kernel runs here.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsi_tpu.config import LossConfig as JLossConfig
from lsi_tpu.config import RenderConfig as JRenderConfig
from lsi_tpu.config import get_config as j_get_config
from lsi_tpu.data import pipeline as jpipe
from lsi_tpu.evaluation import occlusion as jocc
from lsi_tpu.geometry import transforms as jtf
from lsi_tpu.geometry.ldi import LDI as JLDI
from lsi_tpu.losses import losses as jlosses
from lsi_tpu.models.ldi_predictor import LDIPredictor as JLDIPredictor
from lsi_tpu.train import trainer as jtrainer
from lsi_tpu_torch.config import LossConfig, RenderConfig, get_config
from lsi_tpu_torch.evaluation import occlusion as tocc
from lsi_tpu_torch.geometry.ldi import LDI
from lsi_tpu_torch.losses import losses as tlosses
from lsi_tpu_torch.models.convert import state_dict_from_jax
from lsi_tpu_torch.train import trainer as ttrainer
from test_torch_train import (check_metrics, check_params, flat, torch_batch,
                              unflatten)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_quality_toy.npz")
B, L, H, W = 2, 3, 16, 24
RENDER = dict(zbuffer_scale=50.0)


def scene(rng):
    """Two predictions (src, trg) with a foreground block in layer 0,
    images, the pose, and ground truth."""
    def ldi(rng):
        tex = rng.uniform(size=(B, L, H, W, 3)).astype(np.float32)
        d0 = rng.uniform(0.25, 0.35, (B, 1, H, W, 1))
        d0[:, :, 4:12, 8:16] += 0.3  # the foreground block
        ratio1 = rng.uniform(0.45, 0.55, d0.shape)
        disp = np.concatenate([d0, ratio1 * d0, 0.3 * ratio1 * d0], 1)
        return tex, disp.astype(np.float32)

    tex_s, disp_s = ldi(rng)
    tex_t, disp_t = ldi(rng)
    K = np.tile(np.array([[30.0, 0, (W - 1) / 2], [0, 30.0, (H - 1) / 2],
                          [0, 0, 1]], np.float32)[None], (B, 1, 1))
    pose = np.array(jtf.pose_from_euler(
        np.array([[0.0, 0.02, 0.0], [0.01, -0.03, 0.0]], np.float32),
        np.array([[-0.3, 0.0, 0.0], [0.25, 0.05, -0.1]], np.float32)))
    src = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    trg = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    gt = rng.uniform(0.2, 0.6, (B, H, W, 1)).astype(np.float32)
    gt_valid = (rng.uniform(size=(B, H, W, 1)) < 0.7).astype(np.float32)
    return (tex_s, disp_s, tex_t, disp_t), K, pose, src, trg, gt, gt_valid


def run_both(case, jfn, tfn, has_aux=False):
    """Value and gradients in (tex_src, disp_src, tex_trg, disp_trg) of
    jfn(JLDI, JLDI, pose, src, trg, gt, gv) and the same tfn on LDIs."""
    leaves, K, *rest = case

    def jloss(ts, ds, tt, dt):
        k = jnp.asarray(K)
        return jfn(JLDI(textures=ts, disparities=ds, intrinsics=k),
                   JLDI(textures=tt, disparities=dt, intrinsics=k),
                   *map(jnp.asarray, rest))

    j_val, j_grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=has_aux))(
            *map(jnp.asarray, leaves))
    j_val, aux = j_val if has_aux else (j_val, None)
    tl = [torch.from_numpy(x).requires_grad_() for x in leaves]
    k = torch.from_numpy(K)
    val = tfn(LDI(tl[0], tl[1], k), LDI(tl[2], tl[3], k),
              *map(torch.from_numpy, rest))
    grads = torch.autograd.grad(val, tl, allow_unused=True)
    grads = [np.zeros_like(x) if g is None else g.numpy()
             for g, x in zip(grads, leaves)]
    return (float(val.detach()), grads, float(j_val),
            [np.asarray(g) for g in j_grads], aux)


def check(case, jfn, tfn, has_aux=False):
    """Value at rtol 1e-5, gradients at rtol 1e-4 plus 2e-3 of the largest
    entry: the tolerances of tests/test_torch_losses.py, for the same
    reasons (the projection's 3x3 algebra sums in another order; the
    Charbonnier slope turns fastest near a zero residual)."""
    val, grads, j_val, j_grads, aux = run_both(case, jfn, tfn, has_aux)
    assert np.isfinite(val) and val > 0
    np.testing.assert_allclose(val, j_val, rtol=1e-5)
    names = ("tex_src", "disp_src", "tex_trg", "disp_trg")
    for name, g, jg in zip(names, grads, j_grads):
        scale = np.abs(jg).max()
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=2e-3 * scale,
                                   err_msg=name)
    return grads, aux


def both_ldis(case, requires_grad=False):
    leaves, K = case[0], torch.from_numpy(case[1])
    t = [torch.from_numpy(x).requires_grad_(requires_grad) for x in leaves]
    return LDI(t[0], t[1], K), LDI(t[2], t[3], K), t


# ----------------------------------------------------- disocclusion mask

def test_disocclusion_mask_matches_jax(rng):
    case = scene(rng)
    (tex, disp, *_), K, pose = case[0], case[1], case[2]
    got = tocc.disocclusion_mask(
        LDI(*map(torch.from_numpy, (tex, disp, K))), torch.from_numpy(pose),
        out_hw=(H, W))
    want = np.asarray(jocc.disocclusion_mask(
        JLDI(*map(jnp.asarray, (tex, disp, K))), jnp.asarray(pose),
        out_hw=(H, W)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # The case has a disoccluded band, and layer 0 covers most pixels.
    assert 0.02 < float(got.mean()) < 0.5


def test_disocclusion_mask_records_no_graph(rng):
    """The mask is a constant: its layer-0 render runs under no_grad, so
    it records no SplatFn node (its VJP can never run) and the guard
    against direct kernel calls on tensors that require grad stays
    quiet."""
    src, _, leaves = both_ldis(scene(rng), requires_grad=True)
    mask = tocc.disocclusion_mask(src, torch.from_numpy(scene(rng)[2]))
    assert mask.grad_fn is None and not mask.requires_grad
    assert torch.is_grad_enabled()


# ----------------------------------------------------- depth_consistency

FLAGS = ("stop_target", "disocc_only", "visible_only", "deep_only")
# The presets' two calls (the pseudo-label term of kitti_ldi3_quality and
# synthetic_multi, and their anchor), no flag, and each flag alone.
CONSISTENCY_CASES = {
    "quality_pseudo_label": dict(stop_target=True, disocc_only=True,
                                 deep_only=True),
    "anchor": dict(visible_only=True),
    "plain": {},
    **{f: {f: True} for f in FLAGS},
}


@pytest.mark.parametrize("name", sorted(CONSISTENCY_CASES))
def test_depth_consistency_matches_jax(rng, name):
    kw = CONSISTENCY_CASES[name]
    check(scene(rng),
          lambda s, t, pose, *_: jlosses.depth_consistency(
              s, t, pose, JRenderConfig(**RENDER), **kw),
          lambda s, t, pose, *_: tlosses.depth_consistency(
              s, t, pose, RenderConfig(**RENDER), **kw))


def consistency_grads(case, **kw):
    src, trg, leaves = both_ldis(case, requires_grad=True)
    loss = tlosses.depth_consistency(src, trg, torch.from_numpy(case[2]),
                                     RenderConfig(**RENDER), **kw)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(
        torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]


def test_deep_only_detaches_only_layer0_disparity(rng):
    case = scene(rng)
    _, d_src, _, _ = consistency_grads(case, deep_only=True)
    assert float(d_src[:, 0].abs().max()) == 0.0
    assert float(d_src[:, 1:].abs().max()) > 0.0
    _, d_src, _, _ = consistency_grads(case)
    assert float(d_src[:, 0].abs().max()) > 0.0


def test_stop_target_detaches_target_layer0_disparity(rng):
    case = scene(rng)
    *_, d_trg = consistency_grads(case, stop_target=True)
    assert float(d_trg.abs().max()) == 0.0
    *_, d_trg = consistency_grads(case)
    assert float(d_trg[:, 0].abs().max()) > 0.0
    assert float(d_trg[:, 1:].abs().max()) == 0.0  # only layer 0 is read


def test_disocc_mask_carries_no_gradient(rng):
    """With ``disocc_only`` the gradient equals that of the same loss with
    the mask given as a constant: nothing flows through the mask."""
    case = scene(rng)
    got = consistency_grads(case, disocc_only=True)
    src, trg, leaves = both_ldis(case, requires_grad=True)
    pose = torch.from_numpy(case[2])
    mask = tocc.disocclusion_mask(src, pose, out_hw=(H, W)).clone()
    out = tlosses.render_forward(src, pose, out_hw=(H, W),
                                 zbuffer_scale=RENDER["zbuffer_scale"])
    wsum = out["coverage"]
    disp = tlosses.divide_safe(out["disparity"] * wsum, wsum, eps=1e-30)
    m = (wsum > 1e-30).float() * mask
    err = tlosses._charbonnier(disp - trg.disparities[:, 0])
    loss = tlosses.divide_safe((err * m).sum(), m.sum())
    want = [torch.zeros_like(x) if g is None else g for g, x in zip(
        torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------------------------- total_loss_bidirectional

def quality_loss(**change):
    base = dataclasses.asdict(get_config("kitti_ldi3_quality").loss)
    base.update(change)
    return base


BIDIRECTIONAL_CASES = {
    "kitti_ldi3_quality": quality_loss(),
    # The trainer's consistency warm-up step: the pseudo-label off, the
    # anchor on.
    "quality_warmup": quality_loss(consistency_weight=0.0),
    "symmetric_only": quality_loss(consistency_weight=0.0,
                                   consistency_anchor_weight=0.0),
    "consistency_not_symmetric": quality_loss(symmetric=False,
                                              depth_supervision_weight=0.1),
}


@pytest.mark.parametrize("name", sorted(BIDIRECTIONAL_CASES))
def test_total_loss_bidirectional_matches_jax(rng, name):
    kw = BIDIRECTIONAL_CASES[name]
    jcfg, tcfg = JLossConfig(**kw), LossConfig(**kw)
    parts = {}

    def jfn(s, t, pose, src, trg, gt, gv):
        out = jlosses.total_loss_bidirectional(
            s, t, src, trg, pose, jcfg, JRenderConfig(**RENDER),
            gt_disparity=gt, gt_valid=gv)
        return out["total"], out

    def tfn(s, t, pose, src, trg, gt, gv):
        out = tlosses.total_loss_bidirectional(
            s, t, src, trg, pose, tcfg, RenderConfig(**RENDER),
            gt_disparity=gt, gt_valid=gv)
        parts.update({k: float(v.detach()) for k, v in out.items()})
        return out["total"]

    _, want = check(scene(rng), jfn, tfn, has_aux=True)
    assert sorted(parts) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(parts[k], float(v), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    assert ("depth_consistency" in parts) == (kw["consistency_weight"] > 0)
    assert ("photo_splat_rev" in parts) == kw["symmetric"]


@pytest.mark.parametrize("knob,value", [("consistency_ema_teacher", True),
                                        ("consistency_stop_step", 10)])
def test_refuted_consistency_knobs_raise(rng, knob, value):
    """The two knobs JAX's two-prediction loss takes, against JAX: with the
    EMA teacher (``consistency_ema_teacher``) the pseudo-label's and the
    anchor's targets are the teacher's predictions, constants (given here
    as a third and fourth LDI; their layer 0 is read, the students'
    layer 0 is not, so the targets' gradient is exactly 0); the stop step
    is the Trainer's switch and leaves the loss as it is. Values and
    gradients at ``check``'s tolerances (tests/test_torch_refuted.py holds
    the trainer's side)."""
    case = scene(rng)
    kw = quality_loss(**{knob: value})
    jcfg, tcfg = JLossConfig(**kw), LossConfig(**kw)
    teachers = scene(rng)[0] if knob == "consistency_ema_teacher" else None
    K = case[1]

    def jkw():
        if teachers is None:
            return {}
        k = jnp.asarray(K)
        return dict(ldi_src_teacher=JLDI(*map(jnp.asarray, teachers[:2]), k),
                    ldi_trg_teacher=JLDI(*map(jnp.asarray, teachers[2:]), k))

    def tkw():
        if teachers is None:
            return {}
        k = torch.from_numpy(K)
        return dict(
            ldi_src_teacher=LDI(*map(torch.from_numpy, teachers[:2]), k),
            ldi_trg_teacher=LDI(*map(torch.from_numpy, teachers[2:]), k))

    parts = {}

    def jfn(s, t, pose, src, trg, gt, gv):
        out = jlosses.total_loss_bidirectional(
            s, t, src, trg, pose, jcfg, JRenderConfig(**RENDER),
            gt_disparity=gt, gt_valid=gv, **jkw())
        return out["total"], out

    def tfn(s, t, pose, src, trg, gt, gv):
        out = tlosses.total_loss_bidirectional(
            s, t, src, trg, pose, tcfg, RenderConfig(**RENDER),
            gt_disparity=gt, gt_valid=gv, **tkw())
        parts.update({k: float(v.detach()) for k, v in out.items()})
        return out["total"]

    _, want = check(case, jfn, tfn, has_aux=True)
    assert sorted(parts) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(parts[k], float(v), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    if teachers is not None:
        # The targets came from the teacher: the live second prediction
        # gives other terms.
        live = tlosses.total_loss_bidirectional(
            *both_ldis(case)[:2], *map(torch.from_numpy, case[3:5]),
            torch.from_numpy(case[2]), tcfg, RenderConfig(**RENDER),
            gt_disparity=torch.from_numpy(case[5]),
            gt_valid=torch.from_numpy(case[6]))
        assert abs(float(live["depth_consistency"])
                   - parts["depth_consistency"]) > 1e-4


# ------------------------------------------------ the two-prediction step

def toy_quality(get):
    """The toy cut of kitti_ldi3_quality that
    scripts/make_torch_golden_quality.py records: 32x64, base_filters 8,
    2 scales, float32, batch 2, multi-object scenes, the phase boundaries
    inside 6 steps."""
    cfg = get("kitti_ldi3_quality")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, base_filters=8, num_scales=2,
                                  compute_dtype="float32"),
        loss=dataclasses.replace(cfg.loss, consistency_start_step=2),
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 synthetic_scene="multi", height=32,
                                 width=64, batch_size=2),
        train=dataclasses.replace(cfg.train, warmup_steps=2, max_steps=6,
                                  eval_every=2, eval_batches=1,
                                  freeze_layer0_step=4, checkpoint_every=3,
                                  log_every=1))


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def test_apply_model_pair_equals_two_forwards(rng):
    """GroupNorm normalises per sample, so one forward over src and trg
    stacked on the batch axis equals two forwards."""
    cfg = toy_quality(get_config)
    state = ttrainer.create_state(cfg, seed=3, device="cpu")
    a = torch.from_numpy(rng.uniform(size=(2, 32, 64, 3)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(size=(2, 32, 64, 3)).astype(np.float32))
    K = torch.eye(3).expand(2, 3, 3) * 20.0
    pa, pb = ttrainer.apply_model_pair(state.net, a, b, K)
    for pair, ref in ((pa, state.net(a, K)), (pb, state.net(b, K))):
        # Convolutions over a batch of 4 vs 2 may pick other algorithms:
        # float32 rounding.
        torch.testing.assert_close(pair.textures, ref.textures, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(pair.disparities, ref.disparities,
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(pair.intrinsics, ref.intrinsics)


def test_two_prediction_step_matches_jax(golden):
    """Three steps of the toy quality step (one fused forward over src and
    trg, both directions of every term) from the same params and batches
    as JAX's ``make_train_step`` (no mesh plan), at the golden train
    tolerances (tests/test_torch_train.py). The warm-up and freeze steps
    are held to JAX's Trainer in tests/test_torch_trainer.py."""
    jcfg, cfg = toy_quality(j_get_config), toy_quality(get_config)
    params = {k[len("params/"):]: v for k, v in golden.items()
              if k.startswith("params/")}
    start = state_dict_from_jax(params, cfg.model)
    stream = jpipe._batch_stream(jcfg.data, 0, True)
    batches = [next(stream) for _ in range(3)]
    j_state = jtrainer.TrainState.create(
        apply_fn=JLDIPredictor(jcfg.model).apply, params=unflatten(params),
        tx=jtrainer.make_optimizer(jcfg))
    j_step = jtrainer.make_train_step(jcfg)
    state = ttrainer.create_state(cfg, device="cpu")
    state.net.load_state_dict(start)
    step = ttrainer.make_train_step(cfg)
    for i, b in enumerate(batches):
        j_state, j_metrics = j_step(j_state, b)
        state, metrics = step(state, torch_batch(dataclasses.asdict(b)))
        assert sorted(metrics) == sorted(j_metrics)
        check_metrics(metrics, j_metrics, i)
    want = state_dict_from_jax(flat(j_state.params), cfg.model)
    lr = ttrainer.make_lr_schedule(cfg)
    check_params(state.net.state_dict(), want, start,
                 sum(lr(c) for c in range(3)))
