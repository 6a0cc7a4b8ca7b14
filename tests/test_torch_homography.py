"""The port's plane-induced homography (geometry/homography.py) vs the JAX
package's lax path: ``plane_homography`` (identity pose, pointwise
projection, JAX's values), ``homography_warp`` (values, valid mass, the
VJP in the image and in the homography), the mapped-z floor of 1e-8 (not
sign-preserving, no gradient through the replaced entries), far-away and
non-finite coordinates, and ``plane_sweep_volume``.

Tolerances: values within 1e-5, gradients within 1e-4 of the largest.
The warp on CUDA tensors (the gather kernel K4) is held to this CPU path
in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsi_tpu.geometry import homography as jhom
from lsi_tpu.geometry import transforms as jtf
from lsi_tpu_torch.geometry import homography as thom
from lsi_tpu_torch.geometry.transforms import identity_pose

VAL_ATOL = 1e-5
GRAD_ATOL_OF_MAX = 1e-4


def make_K(fx=50.0, fy=46.0, cx=15.5, cy=11.5, b=2):
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return np.broadcast_to(K, (b, 3, 3)).copy()


def some_pose():
    return np.asarray(jtf.pose_from_euler(
        np.array([[0.03, -0.01, 0.02], [-0.02, 0.04, 0.0]], np.float32),
        np.array([[0.2, -0.1, 0.1], [-0.3, 0.05, -0.2]], np.float32)))


def t(x):
    return torch.from_numpy(np.array(x))


def assert_grads_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_ATOL_OF_MAX * np.abs(w).max())


def test_identity_pose_gives_identity():
    K = make_K()
    h = thom.plane_homography(t(K), t(K), identity_pose((2,)),
                              torch.tensor([[0.0, 0.0, 1.0]] * 2),
                              torch.tensor([5.0, 0.5]))
    np.testing.assert_allclose(h.numpy(), np.broadcast_to(np.eye(3), (2, 3, 3)),
                               atol=1e-5)


def test_plane_homography_matches_pointwise_projection():
    """Points ON the plane, projected through the full geometry into the
    target, map back to their source pixels."""
    K = make_K()
    pose = some_pose()
    normal = np.array([[0, 0, 1], [0.1, -0.2, 0.97]], np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = np.array([4.0, 2.5], np.float32)
    h = thom.plane_homography(t(K), t(K), t(pose), t(normal),
                              t(depth)).numpy()
    for b in range(2):
        for x, y in [(5.0, 3.0), (20.0, 14.0), (11.0, 8.0)]:
            ray = np.linalg.inv(K[b]) @ np.array([x, y, 1.0])
            p_cam = ray * depth[b] / (normal[b] @ ray)  # on n^T X = d
            uvw = K[b] @ (pose[b, :3, :3] @ p_cam + pose[b, :3, 3])
            mapped = h[b] @ np.array([uvw[0] / uvw[2], uvw[1] / uvw[2], 1.0])
            np.testing.assert_allclose(mapped[:2] / mapped[2], [x, y],
                                       atol=1e-3)


def test_plane_homography_matches_jax():
    K_src, K_trg = make_K(), make_K(40.0, 38.0, 16.0, 12.0)
    pose = some_pose()
    normal = np.array([[0, 0, 1], [0.1, -0.2, 0.97]], np.float32)
    depth = np.array([2.5, 7.0], np.float32)
    got = thom.plane_homography(*map(t, (K_src, K_trg, pose, normal, depth)))
    want = jhom.plane_homography(*map(jnp.asarray, (K_src, K_trg, pose,
                                                    normal, depth)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def warp_case(rng, b=2, h=12, w=20, c=4):
    image = rng.uniform(size=(b, h, w, c)).astype(np.float32)
    hom = np.asarray(jhom.plane_homography(
        jnp.asarray(make_K(b=b)), jnp.asarray(make_K(b=b)),
        jnp.asarray(some_pose()[:b]),
        jnp.asarray(np.array([[0, 0, 1]] * b, np.float32)),
        jnp.asarray(np.array([3.0, 6.0][:b], np.float32))))
    return image, hom


@pytest.mark.parametrize("out_hw", [None, (9, 24)])
def test_warp_values_and_grads_match_jax(rng, out_hw):
    image, hom = warp_case(rng)
    img_t = t(image).requires_grad_()
    hom_t = t(hom).requires_grad_()
    warped, valid = thom.homography_warp(img_t, hom_t, out_hw)
    (j_warped, j_valid), vjp = jax.vjp(
        lambda i, m: jhom.homography_warp(i, m, out_hw),
        jnp.asarray(image), jnp.asarray(hom))
    np.testing.assert_allclose(warped.detach().numpy(), np.asarray(j_warped),
                               rtol=0, atol=VAL_ATOL)
    np.testing.assert_allclose(valid.detach().numpy(), np.asarray(j_valid),
                               rtol=0, atol=VAL_ATOL)
    assert 0.0 < float(valid.detach().mean()) < 1.0  # some leave the image
    g_w = rng.standard_normal(warped.shape).astype(np.float32)
    g_v = rng.standard_normal(valid.shape).astype(np.float32)
    got = torch.autograd.grad((warped, valid), (img_t, hom_t),
                              (t(g_w), t(g_v)))
    assert_grads_close(got, vjp((jnp.asarray(g_w), jnp.asarray(g_v))))


def test_identity_homography_reproduces_the_image(rng):
    image = rng.uniform(size=(1, 8, 10, 3)).astype(np.float32)
    out, valid = thom.homography_warp(t(image), torch.eye(3)[None])
    np.testing.assert_array_equal(out.numpy(), image)
    np.testing.assert_array_equal(valid.numpy(), 1.0)


def test_denominator_floor_matches_jax(rng):
    """Rows of the target whose mapped z is 0, tiny negative or tiny
    positive: z becomes +1e-8 (not sign-preserving), the coordinates land
    ~1e8 px away (no sample, no valid mass) and the replaced entries get
    no gradient; elsewhere the warp samples normally."""
    h, w = 8, 10
    image = rng.uniform(size=(1, h, w, 3)).astype(np.float32)
    # z = 0.25 * (y - 2): 0 on row 2, and the rows beyond it positive.
    hom = np.array([[[1.0, 0.0, 0.3], [0.0, 1.0, 0.2],
                     [0.0, 0.25, -0.5]]], np.float32)
    coords = thom.homography_coords(t(hom), (h, w))
    assert (coords[0, 2].abs() > 1e6).all()          # z == 0 -> +1e-8
    assert (coords[0, 2, 1:, 0] > 0).all()           # positive: not -1e-8
    hom_t = t(hom).requires_grad_()
    img_t = t(image).requires_grad_()
    warped, valid = thom.homography_warp(img_t, hom_t)
    (j_warped, j_valid), vjp = jax.vjp(jhom.homography_warp,
                                       jnp.asarray(image), jnp.asarray(hom))
    np.testing.assert_allclose(warped.detach().numpy(), np.asarray(j_warped),
                               rtol=0, atol=VAL_ATOL)
    np.testing.assert_allclose(valid.detach().numpy(), np.asarray(j_valid),
                               rtol=0, atol=VAL_ATOL)
    assert float(valid[0, 2].abs().max()) == 0.0
    assert float(valid[0, 6:, :4].min()) > 0.0
    g_w = rng.standard_normal(warped.shape).astype(np.float32)
    g_v = rng.standard_normal(valid.shape).astype(np.float32)
    got = torch.autograd.grad((warped, valid), (img_t, hom_t),
                              (t(g_w), t(g_v)))
    assert_grads_close(got, vjp((jnp.asarray(g_w), jnp.asarray(g_v))))
    # Tiny negative z: the floor replaces it by +1e-8, and no gradient
    # reaches the homography through those entries.
    tiny = t(np.array([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                        [0.0, 0.0, -5e-9]]], np.float32)).requires_grad_()
    c = thom.homography_coords(tiny, (2, 3))
    np.testing.assert_allclose(c[0, 1, 1].detach().numpy(), [1e8, 1e8],
                               rtol=1e-6)
    (g,) = torch.autograd.grad(c.sum(), tiny)
    assert float(g[0, 2].abs().max()) == 0.0


def test_degenerate_homography_is_non_finite_as_in_jax(rng):
    """A singular plane map (a zero target camera) inverts to non-finite
    entries in both packages; the warp then samples nothing finite from
    it, as JAX's lax gather does (the CUDA kernel drops such coordinates
    instead, ROADMAP H11)."""
    K, pose = make_K(b=1), some_pose()[:1]
    zero = np.zeros_like(K)
    n, d = np.array([[0, 0, 1]], np.float32), np.array([3.0], np.float32)
    got = thom.plane_homography(*map(t, (K, zero, pose, n, d)))
    want = jhom.plane_homography(*map(jnp.asarray, (K, zero, pose, n, d)))
    assert not torch.isfinite(got).all()
    assert not np.isfinite(np.asarray(want)).all()
    image = rng.uniform(size=(1, 6, 8, 3)).astype(np.float32)
    warped, valid = thom.homography_warp(t(image), got)
    j_warped, j_valid = jhom.homography_warp(jnp.asarray(image), want)
    assert not torch.isfinite(warped).any()
    assert not np.isfinite(np.asarray(j_warped)).any()


def test_far_coordinates_sample_nothing(rng):
    """A homography that throws every pixel ~1e6 px away: zero samples,
    zero valid mass and zero gradients, as in JAX."""
    image = rng.uniform(size=(1, 6, 8, 3)).astype(np.float32)
    hom = np.array([[[1.0, 0.0, 1e6], [0.0, 1.0, -1e6], [0, 0, 1.0]]],
                   np.float32)
    img_t = t(image).requires_grad_()
    warped, valid = thom.homography_warp(img_t, t(hom))
    j_warped, j_valid = jhom.homography_warp(jnp.asarray(image),
                                             jnp.asarray(hom))
    assert float(warped.abs().max()) == 0.0 == float(np.abs(j_warped).max())
    assert float(valid.abs().max()) == 0.0 == float(np.abs(j_valid).max())
    (g,) = torch.autograd.grad(warped.sum(), img_t)
    assert float(g.abs().max()) == 0.0


def test_plane_sweep_volume_matches_jax(rng):
    image = rng.uniform(size=(2, 10, 14, 3)).astype(np.float32)
    K_src, K_trg = make_K(), make_K(44.0, 40.0, 7.0, 5.0)
    pose = some_pose()
    depths = np.array([1.0, 2.0, 4.0, 8.0], np.float32)
    vol, valid = thom.plane_sweep_volume(*map(t, (image, K_src, K_trg, pose,
                                                  depths)), out_hw=(8, 12))
    j_vol, j_valid = jhom.plane_sweep_volume(
        *map(jnp.asarray, (image, K_src, K_trg, pose, depths)),
        out_hw=(8, 12))
    assert vol.shape == (2, 4, 8, 12, 3) and valid.shape == (2, 4, 8, 12, 1)
    np.testing.assert_allclose(vol.numpy(), np.asarray(j_vol), rtol=0,
                               atol=VAL_ATOL)
    np.testing.assert_allclose(valid.numpy(), np.asarray(j_valid), rtol=0,
                               atol=VAL_ATOL)
