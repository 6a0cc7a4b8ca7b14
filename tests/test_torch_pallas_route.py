"""The TPU kernels' route (``render.use_pallas="on"``) through the port on
the CPU, against the JAX package.

Two references, neither a Pallas call in tier-1:

* JAX's own route with its two Pallas kernels replaced, for this test
  process only, by their lax equivalents: the windowed splat by
  ``ops/splat.splat_bilinear(..., max_dy_window=)`` (the oracle JAX holds
  its kernel to) and ``gather_pallas_diff`` by that splat's transpose
  (``tests/test_torch_gather_window.py``). Everything else, which gathers
  and renders the route windows, at which window, ``window_dropped_frac``,
  is the JAX package's code: render, per-layer gather, inverse-warp and
  candidate losses, splat loss, homography warp, MPI loss.
* ``tests/data/torch_golden_pallas_toy.npz``, JAX's real kernels in
  interpret mode (``scripts/make_torch_golden_pallas.py``):
  ``gather_pallas_diff`` and its VJP, and two train steps each of the
  toy quality recipe and the toy MPI baseline on the route.

"auto" keeps the exact route bitwise; the API and the Trainer warn.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses
import functools
import importlib
import importlib.util
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsi_tpu.geometry.ldi as jldi_mod
from lsi_tpu.config import RenderConfig as JRenderConfig
from lsi_tpu.geometry import homography as jhom
from lsi_tpu.geometry import transforms as jtf
from lsi_tpu.losses import losses as jlosses
from lsi_tpu.models import mpi as jmpi
from lsi_tpu.ops.splat import splat_bilinear as j_splat
from lsi_tpu_torch import api as tapi
from lsi_tpu_torch.config import (Config, LossConfig, RenderConfig,
                                  build_config)
from lsi_tpu_torch.geometry import homography as thom
from lsi_tpu_torch.geometry import ldi as tldi_mod
from lsi_tpu_torch.geometry.ldi import LDI, render_forward
from lsi_tpu_torch.kernels import gather_cuda
from lsi_tpu_torch.losses import losses as tlosses
from lsi_tpu_torch.models import mpi as tmpi
from lsi_tpu_torch.models.convert import state_dict_from_jax
from lsi_tpu_torch.ops.gather import bilinear_sample
from lsi_tpu_torch.ops.splat import splat_bilinear
from lsi_tpu_torch.train import trainer as ttrainer
from test_torch_gather_window import jax_gather
from test_torch_train import torch_batch

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLDEN = os.path.join(DATA, "torch_golden_pallas_toy.npz")
SPREAD_SCRIPT = os.path.join(os.path.dirname(HERE), "scripts",
                             "route_golden_spread.py")
H, W, L = 16, 48, 2
# Projected coordinates agree to ~1e-5 px under a rotation (3x3 algebra
# summed in another order); the fractions and the exp(scale * d) weights
# pass that on (tests/test_torch_geometry.py measures ~2e-5).
VAL = dict(rtol=1e-4, atol=1e-4)
# Gradients, as tests/test_torch_consistency.py holds them: rtol 1e-4
# plus 2e-3 of the largest entry. Under a rotation a coordinate's
# rounding can move a sample across a pixel edge or a min over layers to
# another layer (ROADMAP H10), which moves a few entries that much.
GRAD_RTOL, GRAD_OF_MAX = 1e-4, 2e-3
# The golden (JAX's kernels in interpret mode):
# * the gather within 2e-5 plus 2e-5 relative: the interpret-mode kernels
#   sum bf16x6 products of the HIGHEST-precision MXU emulation, 2.8e-5 from
#   float32 sums at a d_image entry of 0.89;
# * loss parts 1e-5 relative, window_dropped_frac 1e-6;
# * step-1 gradients: the MPI's within 2e-4 of the largest (H13's CPU
#   bound, tests/test_torch_train.py; it reads 1.5e-6); the quality
#   recipe's within 5e-3 of the largest. Its window drops corners, which
#   leaves target pixels covered by deep layers' exp(-scale * d) weights
#   alone, where the consistency terms are steep in the LDI (ROADMAP H13).
#   scripts/route_golden_spread.py reads it over 8 seeds of the toy step:
#   the port 2.6e-3 on this fixture (seed 0) and 1.8e-4 to 7.0e-3 in all,
#   tracking JAX's own lax-equivalent route, which sits 1.9e-4 to 7.0e-3
#   from its interpret-mode kernels (the port is that route to 3.1e-5 to
#   2.9e-3); a gather that breaks the window reads 5.0e-2 or more. A
#   fixture made at another seed needs the bound read again.
GOLDEN_GATHER_TOL = dict(rtol=2e-5, atol=2e-5)
GOLDEN_LOSS_RTOL = 1e-5
GOLDEN_DROP_ATOL = 1e-6
GOLDEN_GRAD_OF_MAX = {"quality": 5e-3, "mpi": 2e-4}
# The kernel modules (``lsi_tpu.kernels`` exports functions of the same
# names as its modules).
jsp = importlib.import_module("lsi_tpu.kernels.splat_pallas")
jgp = importlib.import_module("lsi_tpu.kernels.gather_pallas")


def jitted(fn, **static):
    """``fn`` with ``static`` keyword arguments, jitted: JAX's op-by-op
    first calls cost seconds a shape; one compile costs less."""
    return jax.jit(functools.partial(fn, **static))


@pytest.fixture
def jax_route(monkeypatch):
    """JAX's use_pallas="on" route on the CPU with its Pallas kernels
    replaced by their lax equivalents (module docstring)."""
    def splat_window(values, coords, weights, out_hw, max_dx, max_dy,
                     block_rows, fold_h=None, base_offset=0):
        return j_splat(values, coords, weights, out_hw, max_dy_window=max_dy)

    def gather_window(image, coords, max_dx, max_dy, block_rows):
        return jax_gather(image.astype(jnp.float32), coords, max_dy)

    monkeypatch.setattr(jldi_mod, "resolve_use_pallas",
                        lambda flag: flag in (True, "on"))
    monkeypatch.setattr(jsp, "splat_pallas_diff", splat_window)
    monkeypatch.setattr(jgp, "gather_pallas_diff", gather_window)


def scene(seed, b=1):
    """An LDI (numpy) and a pose with vertical motion and a rotation, so
    a window of 1-2 rows drops content; a target image."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(size=(b, L, H, W, 3)).astype(np.float32)
    disp = np.sort(rng.uniform(0.05, 0.5, (b, L, H, W, 1)),
                   axis=1)[:, ::-1].astype(np.float32).copy()
    K = np.array([[0.9 * W, 0, (W - 1) / 2], [0, 0.9 * W, (H - 1) / 2],
                  [0, 0, 1]], np.float32)
    K = np.broadcast_to(K, (b, 3, 3)).copy()
    pose = np.asarray(jtf.pose_from_euler([[0.06, -0.01, 0.01]] * b,
                                          [[-0.2, 0.1, 0.02]] * b))
    trg = rng.uniform(size=(b, H, W, 3)).astype(np.float32)
    return tex, disp, K, pose, trg


def both_ldis(tex, disp, K):
    t = [torch.from_numpy(x).requires_grad_() for x in (tex, disp)]
    return (jldi_mod.LDI(textures=jnp.asarray(tex),
                         disparities=jnp.asarray(disp),
                         intrinsics=jnp.asarray(K)),
            LDI(t[0], t[1], torch.from_numpy(K)), t)


def value_and_grads(case, jfn, tfn):
    """``jfn(jax LDI, pose, trg)`` and ``tfn(port LDI, pose, trg)``, each
    a scalar; their values and gradients in (textures, disparities)."""
    tex, disp, K, pose, trg = case

    def jloss(t, d):
        return jfn(jldi_mod.LDI(textures=t, disparities=d,
                                intrinsics=jnp.asarray(K)),
                   jnp.asarray(pose), jnp.asarray(trg))

    j_val, j_grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(tex), jnp.asarray(disp))
    _, ldi, leaves = both_ldis(tex, disp, K)
    val = tfn(ldi, torch.from_numpy(pose), torch.from_numpy(trg))
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    np.testing.assert_allclose(float(val), float(j_val), rtol=1e-5,
                               atol=1e-7)
    for name, g, jg, x in zip(("textures", "disparities"), grads, j_grads,
                              leaves):
        g = torch.zeros_like(x) if g is None else g
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=GRAD_RTOL,
                                   atol=GRAD_OF_MAX * np.abs(jg).max(),
                                   err_msg=name)
    return float(val)


def test_resolve_use_pallas_needs_no_environment(monkeypatch):
    """"on"/True take the windowed route, "auto"/"off"/False the exact one,
    JAX's LSI_TPU_FORCE_PALLAS changes nothing, and other values raise."""
    monkeypatch.setenv("LSI_TPU_FORCE_PALLAS", "1")
    for flag, want in (("on", True), (True, True), ("auto", False),
                       ("off", False), (False, False)):
        assert tldi_mod.resolve_use_pallas(flag) is want
    with pytest.raises(ValueError):
        tldi_mod.resolve_use_pallas("tpu")


@pytest.mark.parametrize("max_dy", [1, 2])
def test_render_forward_on_matches_jax(jax_route, max_dy):
    """The windowed render and its window_dropped_frac against JAX's
    route; a target of another size renders exactly on both."""
    tex, disp, K, pose, _ = scene(1)
    jl, tl, _ = both_ldis(tex, disp, K)
    kw = dict(zbuffer_scale=30.0, use_pallas="on", pallas_max_dy=max_dy)
    want = jitted(jldi_mod.render_forward, **kw)(jl, jnp.asarray(pose))
    got = render_forward(tl, torch.from_numpy(pose), **kw)
    for key in ("rgb", "disparity", "coverage"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), **VAL, err_msg=key)
    drop = float(got["window_dropped_frac"])
    assert abs(drop - float(want["window_dropped_frac"])) <= 1e-6
    assert drop > 1e-3
    other = render_forward(tl, torch.from_numpy(pose), out_hw=(H + 4, W),
                           **kw)
    j_other = jitted(jldi_mod.render_forward, out_hw=(H + 4, W), **kw)(
        jl, jnp.asarray(pose))
    np.testing.assert_allclose(other["rgb"].detach().numpy(),
                               np.asarray(j_other["rgb"]), **VAL)
    assert float(other["window_dropped_frac"]) == 0.0


def test_gather_target_per_layer_on_matches_jax(jax_route):
    """The per-layer gather through the windowed, snapped gather: samples,
    valid and the projection's disparity, and the gradient of a loss of
    them in the LDI."""
    def jfn(ldi, pose, trg):
        s, v, d = jldi_mod.gather_target_per_layer_folded(
            ldi, trg, pose, use_pallas="on", pallas_max_dy=1)
        return jnp.sum(s * s) + jnp.sum(v * 0.3) + jnp.sum(d * v)

    def tfn(ldi, pose, trg):
        s, v, d = tldi_mod.gather_target_per_layer_folded(
            ldi, trg, pose, use_pallas="on", pallas_max_dy=1)
        return (s * s).sum() + (v * 0.3).sum() + (d * v).sum()

    value_and_grads(scene(2), jfn, tfn)


@pytest.mark.parametrize("radius", [0, 1])
def test_inverse_warp_loss_on_matches_jax(jax_route, radius):
    """The inverse-warp loss on the route (the candidates' window
    pallas_max_dy + r), value and gradients, and its window diagnostic:
    radius 0 only, as JAX."""
    cfg = dict(use_pallas="on", pallas_max_dy=1)
    diags = {}

    def jfn(ldi, pose, trg, return_diag=False):
        return jlosses.view_synthesis_inverse_warp(
            ldi, trg, pose, candidate_radius=radius,
            render_cfg=JRenderConfig(**cfg), return_diag=return_diag)

    def tfn(ldi, pose, trg):
        loss, diags["port"] = tlosses.view_synthesis_inverse_warp(
            ldi, trg, pose, candidate_radius=radius,
            render_cfg=RenderConfig(**cfg), return_diag=True)
        return loss

    case = scene(3)
    value_and_grads(case, jfn, tfn)
    tex, disp, K, pose, trg = case
    _, diags["jax"] = jax.jit(functools.partial(jfn, return_diag=True))(
        both_ldis(tex, disp, K)[0], jnp.asarray(pose), jnp.asarray(trg))
    assert sorted(diags["port"]) == sorted(diags["jax"]) == (
        ["window_dropped_frac"] if radius == 0 else [])
    for k, v in diags["port"].items():
        assert float(v) > 1e-3
        assert abs(float(v) - float(diags["jax"][k])) <= 1e-6


def test_splat_loss_on_matches_jax(jax_route):
    """The splat loss on the route (its render windowed), value and
    gradients, and its window_dropped_frac."""
    rcfg = dict(zbuffer_scale=30.0, use_pallas="on", pallas_max_dy=1)
    diags = {}

    def jfn(ldi, pose, trg):
        return jlosses.view_synthesis_splat(ldi, trg, pose,
                                            JRenderConfig(**rcfg))

    def tfn(ldi, pose, trg):
        loss, diags["port"] = tlosses.view_synthesis_splat(
            ldi, trg, pose, RenderConfig(**rcfg), return_diag=True)
        return loss

    case = scene(4)
    value_and_grads(case, jfn, tfn)
    tex, disp, K, pose, trg = case
    _, want = jax.jit(lambda ldi, trg, pose: jlosses.view_synthesis_splat(
        ldi, trg, pose, JRenderConfig(**rcfg), return_diag=True))(
        both_ldis(tex, disp, K)[0], jnp.asarray(trg), jnp.asarray(pose))
    drop = float(diags["port"]["window_dropped_frac"])
    assert abs(drop - float(want["window_dropped_frac"])) <= 1e-6
    assert drop > 1e-3


def mpi_case(seed, d=3, b=1):
    rng = np.random.default_rng(seed)
    colors = rng.uniform(size=(b, d, H, W, 3)).astype(np.float32)
    alphas = rng.uniform(0.05, 0.95, (b, d, H, W, 1)).astype(np.float32)
    depths = np.array([2.0, 5.0, 20.0][:d], np.float32)
    return colors, alphas, depths


def test_homography_warp_and_mpi_on_match_jax(jax_route):
    """The homography warp on the route (windowed where the target's
    height is a multiple of the source's, exact otherwise), and the MPI
    render through it, values and gradients in the planes."""
    tex, disp, K, pose, trg = scene(6)
    colors, alphas, depths = mpi_case(7)
    b, d = colors.shape[:2]
    hom = np.asarray(jitted(jhom.plane_homography)(
        jnp.asarray(K), jnp.asarray(K), jnp.asarray(pose),
        jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (b, 3)),
        jnp.full((b,), 4.0)))
    img = tex[:, 0]
    for out_hw in ((H, W), (2 * H, W), (H + 3, W)):
        want = jitted(jhom.homography_warp, out_hw=out_hw, use_pallas="on",
                      pallas_max_dy=0)(jnp.asarray(img), jnp.asarray(hom))
        got = thom.homography_warp(torch.from_numpy(img),
                                   torch.from_numpy(hom), out_hw,
                                   use_pallas="on", pallas_max_dy=0)
        for g, r in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **VAL)
    kw = dict(use_pallas="on", pallas_max_dy=0)

    def jrender(c, a):
        out = jmpi.render_mpi(jmpi.MPI(colors=c, alphas=a,
                                       depths=jnp.asarray(depths),
                                       intrinsics=jnp.asarray(K)),
                              jnp.asarray(pose), **kw)
        return sum(jnp.sum(v * (i + 1)) for i, v in enumerate(out.values()))

    j_val, j_grads = jax.jit(jax.value_and_grad(jrender, argnums=(0, 1)))(
        jnp.asarray(colors), jnp.asarray(alphas))
    c, a = (torch.from_numpy(x).requires_grad_() for x in (colors, alphas))
    out = tmpi.render_mpi(tmpi.MPI(c, a, torch.from_numpy(depths),
                                   torch.from_numpy(K)),
                          torch.from_numpy(pose), **kw)
    val = sum((v * (i + 1)).sum() for i, v in enumerate(out.values()))
    np.testing.assert_allclose(float(val), float(j_val), rtol=1e-5)
    for g, jg in zip(torch.autograd.grad(val, (c, a)), j_grads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=GRAD_RTOL,
                                   atol=GRAD_OF_MAX * np.abs(jg).max())
    # The exact route differs: the window does drop samples here.
    exact = tmpi.render_mpi(tmpi.MPI(c, a, torch.from_numpy(depths),
                                     torch.from_numpy(K)),
                            torch.from_numpy(pose))
    assert float((exact["alpha"] - out["alpha"]).abs().max()) > 1e-3


def test_auto_route_is_the_exact_route_bitwise():
    """"auto" (the default) and "off" render, gather and score exactly as
    the plain exact functions do, bitwise, with no window diagnostic from
    the gather and a zero one from the render."""
    tex, disp, K, pose, trg = scene(8)
    ldi = LDI(*map(torch.from_numpy, (tex, disp, K)))
    pose_t, trg_t = torch.from_numpy(pose), torch.from_numpy(trg)
    out = render_forward(ldi, pose_t, zbuffer_scale=30.0)
    payload, coords, weights, _ = tldi_mod.splat_inputs(ldi, pose_t, None,
                                                        30.0)
    accum, wsum = splat_bilinear(payload, coords, weights, (H, W))
    plain = tldi_mod.composite(accum, wsum)
    for key in ("rgb", "disparity", "coverage"):
        assert torch.equal(out[key], plain[key])
    assert float(out["window_dropped_frac"]) == 0.0
    for flag in ("off", False):
        again = render_forward(ldi, pose_t, zbuffer_scale=30.0,
                               use_pallas=flag, pallas_max_dy=0)
        assert torch.equal(again["rgb"], out["rgb"])
    s, v, _ = tldi_mod.gather_target_per_layer_folded(ldi, trg_t, pose_t,
                                                      use_pallas="auto")
    tc, _, front = tldi_mod.project_layers_folded(ldi, pose_t)
    ps, pv = bilinear_sample(trg_t, tc.reshape(1, L * H, W, 2))
    assert torch.equal(s, ps.reshape(s.shape))
    assert torch.equal(v, front * pv.reshape(v.shape))
    losses = [tlosses.view_synthesis_inverse_warp(
        ldi, trg_t, pose_t, candidate_radius=1,
        render_cfg=RenderConfig(use_pallas=flag, pallas_max_dy=0),
        return_diag=True) for flag in ("auto", "off")]
    assert torch.equal(losses[0][0], losses[1][0])
    assert losses[0][1] == losses[1][1] == {}


def test_api_render_warns_on_over_rotated_pose():
    """``render`` on the route warns when the window drops content: an
    over-rotated pose warns, "auto" and window_check=False do not."""
    cfg = build_config("kitti_ldi2", [
        "model.base_filters=8", "model.num_scales=2",
        "model.compute_dtype=float32", "data.height=16", "data.width=48"])
    model = tapi.LSIModel.init(0, cfg, device="cpu")
    image = torch.rand(1, 16, 48, 3,
                       generator=torch.Generator().manual_seed(0))
    ldi = model.predict_ldi(image)
    pose = torch.from_numpy(np.asarray(jtf.pose_from_euler(
        [[0.15, 0.0, 0.0]], [[0.0, -0.5, 0.0]])))
    for render_cfg, warns in ((RenderConfig(use_pallas="on"), 1),
                              (RenderConfig(), 0),
                              (RenderConfig(use_pallas="on",
                                            window_check=False), 0)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tapi.render(ldi, pose, config=render_cfg)
        assert len([x for x in w if "dy-window" in str(x.message)]) == warns


def test_trainer_warns_once_on_the_route(tmp_path):
    """The Trainer on the route logs window_dropped_frac every step and
    warns once, at the first log step whose drop is above the tolerance;
    "auto" logs 0 and never warns."""
    sets = ["model.base_filters=8", "model.num_scales=2",
            "model.compute_dtype=float32", "data.dataset=synthetic",
            "data.synthetic_scene=multi", "data.height=16",
            "data.width=32", "data.batch_size=2", "train.max_steps=3",
            "train.eval_every=0", "train.log_every=1",
            "train.checkpoint_every=100", "loss.photo_mode=splat"]
    for route, warns in (("on", 1), ("auto", 0)):
        cfg = build_config("kitti_ldi2", sets + [
            f"render.use_pallas={route}", "render.pallas_max_dy=0",
            f"train.checkpoint_dir={tmp_path / route}"])
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            ttrainer.Trainer(cfg, device="cpu").train()
        assert len([x for x in w if "dy-window" in str(x.message)]) == warns
        with open(tmp_path / route / "train.jsonl") as f:
            drops = [json.loads(line)["window_dropped_frac"] for line in f]
        assert len(drops) == 3
        assert (max(drops) > 1e-4) if route == "on" else max(drops) == 0.0


# ------------------------------------------------------------- the golden

@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def section(golden, prefix):
    return {k[len(prefix):]: v for k, v in golden.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("case", [0, 1])
def test_gather_matches_golden_pallas_kernel(golden, case):
    """``GatherFn`` with a window against ``gather_pallas_diff`` in
    interpret mode: sampled, valid and d_image within 2e-5 plus 2e-5
    relative, d_coords within 2e-5 of its largest entry."""
    g = section(golden, f"gather{case}/")
    img = torch.from_numpy(g["image"]).requires_grad_()
    crd = torch.from_numpy(g["coords"]).requires_grad_()
    s, v = gather_cuda.GatherFn.apply(img, crd, int(g["max_dy"]))
    ((s * torch.from_numpy(g["g_sampled"])).sum()
     + (v * torch.from_numpy(g["g_valid"])).sum()).backward()
    for name, got in (("sampled", s), ("valid", v), ("d_image", img.grad)):
        np.testing.assert_allclose(got.detach().numpy(), g[name],
                                   **GOLDEN_GATHER_TOL, err_msg=name)
    np.testing.assert_allclose(
        crd.grad.numpy(), g["d_coords"], rtol=0,
        atol=GOLDEN_GATHER_TOL["atol"] * np.abs(g["d_coords"]).max())
    assert (g["valid"] < 0.999).mean() > 0.05


def golden_start(golden, name, fixture):
    """The golden's section for ``name``, its config, and a CPU state and
    two batches at the parameters and batches JAX took."""
    g = section(golden, f"{name}/")
    cfg = Config.from_dict(json.loads(bytes(g["__config__"]).decode()))
    assert cfg.render.use_pallas == "on"
    with np.load(os.path.join(DATA, fixture)) as f:
        start = {k: f[k] for k in f.files}
    state = ttrainer.create_state(cfg, device="cpu")
    state.net.load_state_dict(state_dict_from_jax(
        section(start, "params/"), cfg.model))
    # The fixture's own batch fields (the MPI's tilted poses) replace the
    # starting fixture's.
    batches = [torch_batch({**section(start, f"batch{i}/"),
                            **section(g, f"batch{i}/")}) for i in range(2)]
    return g, cfg, state, batches


@pytest.mark.parametrize("name,fixture", [
    ("quality", "torch_golden_quality_toy.npz"),
    ("mpi", "torch_golden_mpi_toy.npz")])
def test_two_steps_match_golden_pallas_route(golden, name, fixture):
    """Two train steps of the toy quality recipe and the toy MPI baseline
    on the route, from the parameters and batches JAX took: the step-1
    gradients (GOLDEN_GRAD_OF_MAX of the largest), then every loss part
    (1e-5 relative), window_dropped_frac (1e-6) and grad_norm per step. The
    window drops content in both (the MPI's loss differs from the exact
    route's)."""
    g, cfg, state, batches = golden_start(golden, name, fixture)
    grads = ttrainer.loss_and_grads(state, batches[0], cfg)[1]
    want = state_dict_from_jax(section(g, "step1_grads/"), cfg.model)
    g_max = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(grads[k].numpy(), v.numpy(), rtol=0,
                                   atol=GOLDEN_GRAD_OF_MAX[name] * g_max,
                                   err_msg=k)
    metrics_want = section(g, "metrics/")
    if name == "quality":
        assert float(metrics_want["window_dropped_frac"].max()) > 1e-4
    else:
        exact = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, use_pallas="auto"))
        parts = ttrainer.loss_and_grads(state, batches[0], exact)[0]
        assert abs(float(parts["total"])
                   - float(metrics_want["total"][0])) > 1e-4
    step = ttrainer.make_train_step(cfg)
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch)
        assert sorted(metrics) == sorted(metrics_want)
        for k, v in metrics_want.items():
            if k.startswith("window_dropped_frac"):
                tol = dict(rtol=0, atol=GOLDEN_DROP_ATOL)
            elif k == "grad_norm":
                tol = dict(rtol=2e-3, atol=1e-7)
            else:
                tol = dict(rtol=GOLDEN_LOSS_RTOL, atol=1e-7)
            np.testing.assert_allclose(float(metrics[k]), float(v[i]),
                                       **tol, err_msg=f"{k} at step {i + 1}")


@pytest.mark.parametrize("fault", ["d_coords unwindowed",
                                   "gather window + 1"])
def test_golden_pallas_route_sees_window_faults(golden, fault):
    """The quality golden's gradient bound catches a gather that breaks
    the window: with the fault planted in the port's gather wrapper (as
    ``scripts/route_golden_spread.py`` plants it), the step-1 gradients
    leave GOLDEN_GRAD_OF_MAX of the largest."""
    spec = importlib.util.spec_from_file_location(
        "route_golden_spread", SPREAD_SCRIPT)
    spread = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(spread)
    g, cfg, state, batches = golden_start(
        golden, "quality", "torch_golden_quality_toy.npz")
    with spread.faults()[fault]():
        grads = ttrainer.loss_and_grads(state, batches[0], cfg)[1]
    want = state_dict_from_jax(section(g, "step1_grads/"), cfg.model)
    g_max = max(float(np.abs(v.numpy()).max()) for v in want.values())
    err = max(float((grads[k] - v).abs().max()) for k, v in want.items())
    assert err > GOLDEN_GRAD_OF_MAX["quality"] * g_max


def test_mpi_loss_takes_the_route():
    """``mpi_total_loss`` defaults to the exact warp, as JAX's; the
    Trainer's step passes ``render`` (one windowed gather launch on the
    card)."""
    colors, alphas, depths = mpi_case(9)
    tex, disp, K, pose, trg = scene(9)
    mpi = tmpi.MPI(*map(torch.from_numpy, (colors, alphas, depths, K)))
    lc = LossConfig()
    args = (mpi, torch.from_numpy(tex[:, 0]), torch.from_numpy(trg),
            torch.from_numpy(pose), lc)
    default = tlosses.mpi_total_loss(*args)
    off = tlosses.mpi_total_loss(*args, render_cfg=RenderConfig())
    on = tlosses.mpi_total_loss(
        *args, render_cfg=RenderConfig(use_pallas="on", pallas_max_dy=0))
    assert torch.equal(default["total"], off["total"])
    assert not torch.equal(default["total"], on["total"])
    assert dataclasses.asdict(RenderConfig()) == dataclasses.asdict(
        JRenderConfig())
