"""PyTorch port vs the JAX package: pose algebra, projection, helpers and
the LDI render.

The same numpy inputs go through ``lsi_tpu`` (JAX on the CPU) and
``lsi_tpu_torch``; each test states its tolerance. The render is also held
against the numpy loop oracle and against the JAX Pallas kernel in
interpret mode; the projection's and the render's gradients against
``jax.vjp``.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_np
from lsi_tpu.geometry import projection as jproj
from lsi_tpu.geometry import transforms as jtf
from lsi_tpu.geometry.ldi import LDI as JLDI
from lsi_tpu.geometry.ldi import render_forward as j_render
from lsi_tpu.utils import helpers as jhelp
from lsi_tpu_torch.geometry import projection as tproj
from lsi_tpu_torch.geometry import transforms as ttf
from lsi_tpu_torch.geometry.ldi import LDI, render_forward
from lsi_tpu_torch.utils import helpers as thelp


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, rtol, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


ANGLES = np.array([[0.1, -0.2, 0.05], [-0.03, 0.3, 0.2]], np.float32)
TRANS = np.array([[0.5, -0.1, 0.2], [-0.3, 0.0, 1.0]], np.float32)

# Pose algebra: float32 trig and 3x3 products, both exact f32 -> 1e-6.
POSE_CASES = {
    "make_pose": (lambda m: m.make_pose(
        m.euler_to_rotation(ANGLES), TRANS)),
    "identity": lambda m: m.identity_pose((2,)),
    "translation": lambda m: m.translation_pose(TRANS),
    "euler": lambda m: m.pose_from_euler(ANGLES, TRANS),
    "invert": lambda m: m.invert_pose(m.pose_from_euler(ANGLES, TRANS)),
    "compose": lambda m: m.compose_poses(
        m.pose_from_euler(ANGLES, TRANS),
        m.pose_from_euler(ANGLES[::-1].copy(), TRANS[::-1].copy())),
    "relative": lambda m: m.relative_pose(
        m.pose_from_euler(ANGLES, TRANS), m.translation_pose(TRANS)),
    "trajectory": lambda m: m.camera_trajectory(
        7, (0.15, 0.0, 0.05), (0.0, 0.1, 0.0)),
}


@pytest.mark.parametrize("case", sorted(POSE_CASES))
def test_pose_algebra_matches_jax(case):
    close(POSE_CASES[case](ttf), POSE_CASES[case](jtf), rtol=0, atol=1e-6)


def test_intrinsics_helpers_match_jax():
    K = jproj.intrinsics_matrix(np.array([50.0, 60.0]), 55.0,
                                np.array([15.5, 20.0]), 11.5)
    tK = tproj.intrinsics_matrix(t([50.0, 60.0]), 55.0, t([15.5, 20.0]), 11.5)
    close(tK, K, rtol=0, atol=0)
    close(tproj.invert_intrinsics(tK), jproj.invert_intrinsics(K),
          rtol=1e-7, atol=0)
    close(tproj.scale_intrinsics(tK, 0.5, 2.0),
          jproj.scale_intrinsics(K, 0.5, 2.0), rtol=1e-7, atol=0)
    d = np.array([0.0, 1e-9, 0.5, 2.0], np.float32)
    close(tproj.disparity_to_depth(t(d)), jproj.disparity_to_depth(d),
          rtol=1e-7, atol=0)
    close(tproj.depth_to_disparity(t(d)), jproj.depth_to_disparity(d),
          rtol=1e-7, atol=0)


def _projection_case(rng, b=2, h=12, w=16):
    disp = rng.uniform(0.05, 1.0, (b, h, w, 1)).astype(np.float32)
    K = np.stack([np.array([[30.0, 0, 7.5], [0, 28.0, 5.5], [0, 0, 1]],
                           np.float32)] * b)
    K2 = K.copy()
    K2[:, 0, 0] = 33.0
    pose = np.asarray(jtf.pose_from_euler(
        np.array([[0.02, -0.05, 0.01], [0.0, 0.1, -0.02]], np.float32),
        np.array([[0.1, -0.02, 0.05], [-0.2, 0.0, 0.1]], np.float32)))
    return disp, K, K2, pose


@pytest.mark.parametrize("row_offset", [0, 5])
def test_forward_project_matches_oracle_and_jax(rng, row_offset):
    disp, K, K2, pose = _projection_case(rng)
    coords, tdisp, valid = tproj.forward_project(
        t(disp), t(K), t(K2), t(pose), row_offset=row_offset)
    j_coords, j_tdisp, j_valid = jproj.forward_project(
        jnp.asarray(disp), jnp.asarray(K), jnp.asarray(K2),
        jnp.asarray(pose), row_offset=row_offset)
    # Same float32 algebra in another summation order: ~1e-5 px at |x|~40.
    close(coords, j_coords, rtol=1e-5, atol=1e-4)
    close(tdisp, j_tdisp, rtol=1e-5, atol=1e-6)
    close(valid, j_valid, rtol=0, atol=0)
    if row_offset:
        return
    for i in range(disp.shape[0]):
        c, d, v = reference_np.unproject_project_np(
            disp[i, ..., 0], K[i], K2[i], pose[i])
        # float32 against the float64 oracle.
        close(coords[i], c, rtol=1e-4, atol=1e-3)
        close(tdisp[i, ..., 0], d, rtol=1e-4, atol=1e-5)
        close(valid[i, ..., 0], v, rtol=0, atol=0)


def test_forward_project_clamps_behind_camera():
    """Points behind / at the target camera plane: valid 0, finite huge
    coordinates from the MIN_DEPTH denominator clamp, equal to JAX."""
    h, w = 4, 6
    disp = np.full((1, h, w, 1), 0.5, np.float32)  # z = 2
    K = np.array([[[10.0, 0, 2.5], [0, 10.0, 1.5], [0, 0, 1]]], np.float32)
    pose = np.asarray(jtf.translation_pose(
        np.array([[0.0, 0.0, -2.0]], np.float32)))  # z_trg = 0 exactly
    coords, tdisp, valid = tproj.forward_project(t(disp), t(K), t(K),
                                                 t(pose))
    j = jproj.forward_project(jnp.asarray(disp), jnp.asarray(K),
                              jnp.asarray(K), jnp.asarray(pose))
    assert torch.isfinite(coords).all()
    assert float(coords.abs().max()) > 1e5
    assert float(valid.max()) == 0.0 and float(tdisp.abs().max()) == 0.0
    close(coords, j[0], rtol=1e-6, atol=0)


def test_divide_safe_values_and_grad():
    num = np.array([1.0, 2.0, 3.0, -4.0], np.float32)
    den = np.array([2.0, 0.0, 1e-9, -8.0], np.float32)
    for eps in (0.0, 1e-8):
        close(thelp.divide_safe(t(num), t(den), eps),
              jhelp.divide_safe(num, den, eps), rtol=0, atol=0)
    n = t(num).requires_grad_()
    d = t(den).requires_grad_()
    thelp.divide_safe(n, d, eps=1e-8).sum().backward()
    assert torch.isfinite(n.grad).all() and torch.isfinite(d.grad).all()
    assert float(n.grad[1]) == 0.0 and float(d.grad[1]) == 0.0


def test_flatten_unflatten_layers(rng):
    x = rng.uniform(size=(2, 3, 4, 5, 1)).astype(np.float32)
    flat = thelp.flatten_layers(t(x))
    close(flat, jhelp.flatten_layers(x), rtol=0, atol=0)
    close(thelp.unflatten_layers(flat, 3), x, rtol=0, atol=0)


# --------------------------------------------------------------- render

def make_K(fx=60.0, fy=60.0, cx=15.5, cy=11.5):
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def ldi_pair(tex, disp, K):
    """The same LDI for both packages."""
    return (LDI(t(tex), t(disp), t(K)),
            JLDI(textures=jnp.asarray(tex), disparities=jnp.asarray(disp),
                 intrinsics=jnp.asarray(K)))


def two_layer(rng, b=1, h=24, w=32):
    tex = rng.uniform(size=(b, 2, h, w, 3)).astype(np.float32)
    disp = np.concatenate([
        rng.uniform(0.4, 0.6, (b, 1, h, w, 1)),
        rng.uniform(0.1, 0.2, (b, 1, h, w, 1))], axis=1).astype(np.float32)
    K = np.tile(make_K(cx=(w - 1) / 2, cy=(h - 1) / 2)[None], (b, 1, 1))
    return tex, disp, K


def test_render_matches_np_oracle(rng):
    tex, disp, K = two_layer(rng, h=10, w=12)
    pose = np.asarray(jtf.pose_from_euler(
        np.array([0.01, -0.02, 0.005], np.float32),
        np.array([0.08, 0.02, -0.05], np.float32)))[None]
    out = render_forward(ldi_pair(tex, disp, K)[0], t(pose),
                         zbuffer_scale=20.0)
    ref = reference_np.render_ldi_np(tex[0], disp[0, ..., 0], K[0], pose[0],
                                     20.0)
    # float32 against the float64 oracle (as tests/test_ldi_render.py).
    close(out["rgb"][0], ref["rgb"], rtol=1e-3, atol=1e-4)
    close(out["disparity"][0, ..., 0], ref["disparity"], rtol=1e-3,
          atol=1e-4)
    close(out["coverage"][0, ..., 0], ref["coverage"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("out_hw", [None, (20, 40)])
def test_render_matches_jax_lax_path(rng, out_hw):
    """Rotation + translation, two images, and a resampled output size
    (the port takes the same kernel for any out_hw)."""
    tex, disp, K = two_layer(rng, b=2)
    pose = np.asarray(jtf.pose_from_euler(
        np.array([[0.02, -0.03, 0.01], [0.0, 0.05, 0.0]], np.float32),
        np.array([[-0.1, 0.02, 0.0], [0.15, 0.0, -0.05]], np.float32)))
    tl, jl = ldi_pair(tex, disp, K)
    out = render_forward(tl, t(pose), out_hw=out_hw, zbuffer_scale=50.0)
    ref = j_render(jl, jnp.asarray(pose), out_hw=out_hw, zbuffer_scale=50.0,
                   use_pallas="off")
    # Coordinates agree to ~1e-5 px (3x3 algebra summed in another
    # order); the bilinear fractions and the exp(50 * d) weights pass that
    # on to the composite, measured up to ~2e-5.
    for k in ("rgb", "disparity", "coverage"):
        close(out[k], ref[k], rtol=1e-4, atol=1e-4)
    assert float(out["window_dropped_frac"]) == 0.0


def test_render_matches_jax_pallas_kernel_interpret(rng, monkeypatch):
    """The port's exact splat == the TPU kernel (interpret mode) on a
    translation-only pose, where the kernel's dy window drops nothing."""
    monkeypatch.setenv("LSI_TPU_FORCE_PALLAS", "1")
    from jax.experimental.pallas import tpu as pltpu

    h, w = 16, 128
    tex = rng.uniform(size=(1, 2, h, w, 3)).astype(np.float32)
    disp = np.sort(rng.uniform(0.1, 0.5, (1, 2, h, w, 1)),
                   axis=1)[:, ::-1].astype(np.float32)
    K = make_K(40.0, 40.0, (w - 1) / 2, (h - 1) / 2)[None]
    pose = np.asarray(jtf.translation_pose(
        np.array([[-0.2, 0, 0]], np.float32)))
    tl, jl = ldi_pair(tex, disp, K)
    with pltpu.force_tpu_interpret_mode():
        ref = j_render(jl, jnp.asarray(pose), zbuffer_scale=20.0,
                       use_pallas=True, check_window=True)
    assert float(ref["window_dropped_frac"]) == 0.0
    out = render_forward(tl, t(pose), zbuffer_scale=20.0)
    # Tolerances of tests/test_pallas.py's render comparison.
    close(out["rgb"], ref["rgb"], rtol=1e-4, atol=1e-4)
    close(out["disparity"], ref["disparity"], rtol=1e-4, atol=1e-4)
    close(out["coverage"], ref["coverage"], rtol=1e-4, atol=1e-5)


def test_identity_pose_renders_nearest_layer(rng):
    """At identity pose the much nearer layer 0 dominates the blend."""
    tex, disp, K = two_layer(rng)
    out = render_forward(ldi_pair(tex, disp, K)[0], ttf.identity_pose((1,)),
                         zbuffer_scale=100.0)
    close(out["rgb"], tex[:, 0], rtol=0, atol=2e-3)
    close(out["disparity"], disp[:, 0], rtol=0, atol=1e-3)


def test_high_scale_approaches_hard_zbuffer():
    h, w = 16, 16
    tex = np.zeros((1, 2, h, w, 3), np.float32)
    tex[:, 0] = 1.0
    disp = np.concatenate([np.full((1, 1, h, w, 1), 0.5),
                           np.full((1, 1, h, w, 1), 0.1)],
                          axis=1).astype(np.float32)
    K = make_K(cx=7.5, cy=7.5)[None]
    out = render_forward(ldi_pair(tex, disp, K)[0], ttf.identity_pose((1,)),
                         zbuffer_scale=200.0)
    close(out["rgb"], np.ones((1, h, w, 3)), rtol=0, atol=1e-4)


# ------------------------------------------------------------ gradients

def test_forward_project_grads_match_jax(rng):
    """The VJP of the projection in the disparity, through the
    denominator's clamp (a ``where``: no gradient where it clamps) and the
    ``valid`` product; one row sits exactly at the target camera plane."""
    disp, K, K2, pose = _projection_case(rng)
    disp[:, 0] = 0.5
    pose = pose.copy()
    pose[0, 2, 3] = -2.0  # z_trg = 0 for the first image's d = 0.5 row
    pose[0, :3, :3] = np.eye(3)
    g = [rng.normal(size=s).astype(np.float32)
         for s in ((2, 12, 16, 2), (2, 12, 16, 1), (2, 12, 16, 1))]

    def jfn(d):
        return jproj.forward_project(d, jnp.asarray(K), jnp.asarray(K2),
                                     jnp.asarray(pose))

    _, f = jax.vjp(jfn, jnp.asarray(disp))
    (want,) = f(tuple(jnp.asarray(x) for x in g))
    d = t(disp).requires_grad_()
    out = tproj.forward_project(d, t(K), t(K2), t(pose))
    assert float(out[2][0, 0].max()) == 0.0  # the clamped row is invalid
    # valid is a comparison: no gradient in either package.
    (got,) = torch.autograd.grad(out[:2], (d,), tuple(t(x) for x in g[:2]))
    assert torch.isfinite(got).all()
    # Same float32 chain in another order: 1e-5 of the largest entry.
    close(got, want, rtol=1e-5, atol=1e-5 * np.abs(np.asarray(want)).max())


def test_render_grads_match_jax(rng):
    """The VJP of render_forward in the textures and disparities: the
    detached d_shift max, the exp(scale * d) weights, the splat's VJP and
    divide_safe, against the JAX lax path."""
    tex, disp, K = two_layer(rng, b=2)
    pose = np.array(jtf.pose_from_euler(
        np.array([[0.02, -0.03, 0.01], [0.0, 0.05, 0.0]], np.float32),
        np.array([[-0.1, 0.02, 0.0], [0.15, 0.0, -0.05]], np.float32)))
    g = [rng.normal(size=s).astype(np.float32)
         for s in ((2, 24, 32, 3), (2, 24, 32, 1), (2, 24, 32, 1))]

    def jfn(tx, dp):
        out = j_render(JLDI(textures=tx, disparities=dp,
                            intrinsics=jnp.asarray(K)), jnp.asarray(pose),
                       zbuffer_scale=20.0, use_pallas="off")
        return out["rgb"], out["disparity"], out["coverage"]

    _, f = jax.vjp(jax.jit(jfn), jnp.asarray(tex), jnp.asarray(disp))
    want = f(tuple(jnp.asarray(x) for x in g))
    tx = t(tex).requires_grad_()
    dp = t(disp).requires_grad_()
    out = render_forward(LDI(tx, dp, t(K)), t(pose), zbuffer_scale=20.0)
    got = torch.autograd.grad((out["rgb"], out["disparity"],
                               out["coverage"]), (tx, dp),
                              tuple(t(x) for x in g))
    # Coordinates ~1e-5 px apart (see test_render_matches_jax_lax_path),
    # passed on through the bilinear fractions and exp(20 d): 1e-4 of the
    # largest entry.
    for name, a, b in zip(("textures", "disparities"), got, want):
        scale = np.abs(np.asarray(b)).max()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
