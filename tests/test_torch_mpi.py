"""The port's MPI baseline (models/mpi.py, losses.mpi_total_loss) vs the
JAX package's lax path: ``MPIPredictor`` from converted Flax weights
(float32 tightly, bfloat16 loosely: ROADMAP H7) and the converter both
ways, ``plane_depths``, ``mpi_source_disparity``, ``render_mpi`` (values,
and gradients in the colours and alphas), the clips at alphas exactly 0
and 1 (ROADMAP H14: ``jnp.clip``'s gradient is 0.5 there, ``torch.clamp``
would give 1), ``cumprod`` through a factor of exactly 0, and
``mpi_total_loss`` (parts, and ``jax.grad`` vs autograd).

Fixed MPIs and their JAX renders come from
tests/data/torch_golden_mpi_toy.npz (scripts/make_torch_golden_mpi.py),
which chip_smoke.py holds the card to as well. Tolerances: values within
1e-5, gradients within 1e-4 of the largest.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsi_tpu.api import default_intrinsics as j_default_intrinsics
from lsi_tpu.config import LossConfig as JLossConfig
from lsi_tpu.config import ModelConfig as JModelConfig
from lsi_tpu.geometry import transforms as jtf
from lsi_tpu.losses import losses as jlosses
from lsi_tpu.models import mpi as jmpi
from lsi_tpu_torch.config import LossConfig, get_config
from lsi_tpu_torch.losses import losses as tlosses
from lsi_tpu_torch.models import build_model, convert
from lsi_tpu_torch.models import mpi as tmpi
from test_torch_model import flat_params

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_mpi_toy.npz")
H, W = 16, 32
VAL_ATOL = 1e-5
GRAD_ATOL_OF_MAX = 1e-4
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def section(golden, prefix):
    return {k[len(prefix):]: v for k, v in golden.items()
            if k.startswith(prefix)}


def t(x):
    return torch.from_numpy(np.array(x))


def mpi_cfg(dtype="float32", d=4):
    return dataclasses.replace(get_config("mpi_baseline").model,
                               num_planes=d, base_filters=8, num_scales=2,
                               compute_dtype=dtype)


def jax_predictor(cfg):
    return jmpi.build_mpi_predictor(JModelConfig(**dataclasses.asdict(cfg)))


@pytest.fixture(scope="module")
def jax_params():
    """A Flax init of the toy MPI predictor (its params are float32 for
    either compute dtype)."""
    net = jax_predictor(mpi_cfg())
    return jax.jit(net.init)(jax.random.key(0), jnp.zeros((1, H, W, 3)),
                             j_default_intrinsics(1, H, W))["params"]


def close(got, want, atol=VAL_ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=err_msg)


def grads_close(got, want, err_msg=""):
    want = np.asarray(want)
    close(got, want, GRAD_ATOL_OF_MAX * np.abs(want).max(), err_msg)


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predictor_matches_flax(rng, jax_params, dtype):
    cfg = mpi_cfg(dtype)
    jnet, params = jax_predictor(cfg), jax_params
    net = build_model(cfg)
    assert isinstance(net, tmpi.MPIPredictor)
    net.load_state_dict(convert.state_dict_from_jax(flat_params(params), cfg))
    image = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    K = np.asarray(j_default_intrinsics(2, H, W))
    want = jax.jit(jnet.apply)({"params": params}, jnp.asarray(image),
                               jnp.asarray(K))
    with torch.no_grad():
        got = net(t(image), t(K))
    for name in ("colors", "alphas", "depths", "intrinsics"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=TOL[dtype] if name == "depths"
                                   else 0, atol=TOL[dtype], err_msg=name)


def test_converter_round_trips_mpi_params(jax_params):
    cfg = mpi_cfg()
    flat = flat_params(jax_params)
    assert any(k.startswith("mpi_head/") for k in flat)
    sd = convert.state_dict_from_jax(flat, cfg)
    assert set(sd) == set(build_model(cfg).state_dict())
    back = convert.jax_from_state_dict(sd)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_converter_rejects_ldi_weights_for_an_mpi(jax_params):
    cfg = mpi_cfg()
    flat = flat_params(jax_params)
    flat["disp_head/bias"] = flat.pop("mpi_head/bias")
    with pytest.raises(KeyError):
        convert.state_dict_from_jax(flat, cfg)


@pytest.mark.parametrize("d,near,far", [(4, 1.0, 100.0), (16, 1.0, 100.0),
                                        (7, 0.5, 80.0), (1, 2.0, 10.0)])
def test_plane_depths_match_jax(d, near, far):
    """The same float32 ramp as jnp.linspace, whose compiled program
    rounds some entries one ulp of the largest (1.0) apart; at the far
    planes' small disparities that is up to 8.3e-7 relative, hence 1e-6."""
    got = tmpi.plane_depths(d, near, far).numpy()
    want = np.asarray(jmpi.plane_depths(d, near, far))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (np.diff(got) > 0).all()


# -------------------------------------------------------- render and H14

def test_clip01_gradient_is_jnp_clips():
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    xt = t(x).requires_grad_()
    (g,) = torch.autograd.grad(tmpi.clip01(xt).sum(), xt)
    want = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert g[1] == g[3] == 0.5  # torch.clamp would give 1


def golden_mpi(case):
    return tmpi.MPI(colors=t(case["colors"]).requires_grad_(),
                    alphas=t(case["alphas"]).requires_grad_(),
                    depths=t(case["depths"]), intrinsics=t(case["intrinsics"]))


@pytest.mark.parametrize("name", ["render", "render_id"])
def test_render_matches_jax_fixture(golden, name):
    """render_mpi against JAX's values and VJP. ``render`` warps under a
    rotation and translation (alphas in (0, 1) and exactly 0);
    ``render_id`` under the identity pose, where every sample is an exact
    pixel: alphas exactly 0 and 1 reach both clips at their bounds, and
    the opaque patch puts zeros into the transmittance's cumprod."""
    case = section(golden, name + "/")
    mpi = golden_mpi(case)
    out = tmpi.render_mpi(mpi, t(case["pose"]))
    keys = ("rgb", "alpha", "disparity")
    for k in keys:
        close(out[k].detach(), case[k], err_msg=k)
    d_colors, d_alphas = torch.autograd.grad(
        [out[k] for k in keys], (mpi.colors, mpi.alphas),
        [t(case["g_" + k]) for k in keys])
    grads_close(d_colors, case["d_colors"], "d_colors")
    grads_close(d_alphas, case["d_alphas"], "d_alphas")
    if name == "render_id":
        a = case["alphas"][..., 0]
        assert (a == 0).any() and (a == 1).any()
        # At the bounds the gradients are JAX's to float32 rounding.
        at = (a == 0) | (a == 1)
        close(d_alphas[..., 0][t(at)], case["d_alphas"][..., 0][at], 1e-6)


def test_render_id_exercises_both_bounds(golden):
    """The identity-pose case really reaches the clips' bounds: a clamp
    there (gradient 1 at the bounds) moves the alphas' VJP far beyond
    the tolerance above."""
    case = section(golden, "render_id/")
    clip = tmpi.clip01
    try:
        tmpi.clip01 = lambda x: x.clamp(0.0, 1.0)
        mpi = golden_mpi(case)
        out = tmpi.render_mpi(mpi, t(case["pose"]))
        keys = ("rgb", "alpha", "disparity")
        (d_alphas,) = torch.autograd.grad(
            [out[k] for k in keys], (mpi.alphas,),
            [t(case["g_" + k]) for k in keys])
    finally:
        tmpi.clip01 = clip
    want = case["d_alphas"]
    assert np.abs(d_alphas.numpy() - want).max() > 0.05 * np.abs(want).max()


def test_source_disparity_matches_jax_fixture(golden):
    """mpi_source_disparity with alphas exactly 0 and 1 (the source clip
    at its bounds, a cumprod factor of exactly 0)."""
    case = section(golden, "srcdisp/")
    ident = section(golden, "render_id/")
    mpi = golden_mpi(ident)
    out = tmpi.mpi_source_disparity(mpi)
    close(out.detach(), case["out"])
    (d_alphas,) = torch.autograd.grad(out, mpi.alphas, t(case["g"]))
    grads_close(d_alphas, case["d_alphas"])
    at = (ident["alphas"] == 0) | (ident["alphas"] == 1)
    close(d_alphas[t(at)], case["d_alphas"][at], 1e-6)


def test_cumprod_through_an_opaque_plane_matches_jax(rng):
    """A plane with alpha exactly 1 zeroes the transmittance behind it:
    the exclusive cumprod's gradient there against JAX's."""
    a = rng.uniform(0.1, 0.9, (1, 5, 3, 4)).astype(np.float32)
    a[:, 2] = 1.0
    a[:, 3, 0] = 1.0
    g = rng.standard_normal(a.shape).astype(np.float32)

    def j_trans(x):
        tr = jnp.cumprod(1.0 - x, axis=1)
        return jnp.concatenate([jnp.ones_like(tr[:, :1]), tr[:, :-1]], 1)

    want, vjp = jax.vjp(j_trans, jnp.asarray(a))
    at = t(a).requires_grad_()
    got = tmpi._exclusive_transmittance(at)
    close(got.detach(), want, 1e-7)
    (d,) = torch.autograd.grad(got, at, t(g))
    grads_close(d, vjp(jnp.asarray(g))[0])
    assert float(got.detach()[:, 3:].abs().max()) == 0.0


# ----------------------------------------------------------------- loss

@pytest.mark.parametrize("smooth,supervised", [(0.01, False), (0.05, True),
                                               (0.0, True)])
def test_mpi_total_loss_matches_jax(rng, smooth, supervised):
    """Parts and gradients in the MPI's colours and alphas."""
    b, d = 2, 4
    colors = rng.uniform(size=(b, d, H, W, 3)).astype(np.float32)
    alphas = rng.uniform(0.02, 0.98, (b, d, H, W, 1)).astype(np.float32)
    alphas[:, 0, :4, :6] = 0.0
    depths = np.asarray(jmpi.plane_depths(d))
    K = np.asarray(j_default_intrinsics(b, H, W))
    pose = np.asarray(jtf.pose_from_euler(
        np.array([[0.0, 0.02, 0.0], [0.01, -0.03, 0.0]], np.float32),
        np.array([[-0.3, 0.0, 0.0], [0.2, 0.05, -0.1]], np.float32)))
    src, trg = (rng.uniform(size=(b, H, W, 3)).astype(np.float32)
                for _ in range(2))
    gt = rng.uniform(0.01, 0.9, (b, H, W, 1)).astype(np.float32)
    gv = (rng.uniform(size=(b, H, W, 1)) < 0.7).astype(np.float32)
    kw = dict(smoothness_weight=smooth,
              depth_supervision_weight=0.3 if supervised else 0.0)
    extra = (gt, gv) if supervised else (None, None)

    def jloss(c, a):
        parts = jlosses.mpi_total_loss(
            jmpi.MPI(colors=c, alphas=a, depths=jnp.asarray(depths),
                     intrinsics=jnp.asarray(K)),
            jnp.asarray(src), jnp.asarray(trg), jnp.asarray(pose),
            JLossConfig(**kw), gt_disparity=None if extra[0] is None
            else jnp.asarray(gt), gt_valid=None if extra[1] is None
            else jnp.asarray(gv))
        return parts["total"], parts

    (j_total, j_parts), j_grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(colors),
                                              jnp.asarray(alphas))
    mpi = tmpi.MPI(t(colors).requires_grad_(), t(alphas).requires_grad_(),
                   t(depths), t(K))
    parts = tlosses.mpi_total_loss(
        mpi, t(src), t(trg), t(pose), LossConfig(**kw),
        gt_disparity=None if extra[0] is None else t(gt),
        gt_valid=None if extra[1] is None else t(gv))
    assert sorted(parts) == sorted(j_parts)
    assert ("depth_supervision" in parts) == supervised
    for k, v in j_parts.items():
        np.testing.assert_allclose(float(parts[k].detach()), float(v),
                                   rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    # Gradients: rtol 1e-4 plus 5e-4 of the largest, not 1e-4, because
    # the Charbonnier slope turns fastest at a residual near 0 (curvature
    # 1 / eps = 1e4), where the warp's 1e-7 differences in the render move
    # it most (measured: 1.9e-4 of the largest colour gradient, at 2 of
    # 12288 entries).
    grads = torch.autograd.grad(parts["total"], (mpi.colors, mpi.alphas))
    for name, g, jg in zip(("colors", "alphas"), grads, j_grads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=5e-4 * np.abs(jg).max(),
                                   err_msg=name)
