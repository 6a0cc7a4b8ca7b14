"""The windowed, snapped gather (K4-W, ``render.use_pallas="on"``): the
port's plain version and ``GatherFn`` with a window on CPU tensors, held
to the JAX package without a Pallas call.

JAX's TPU gather (``lsi_tpu/kernels/gather_pallas.py:gather_pallas_diff``)
is K2's tent sums of ``[image, 1]``: the transpose of the windowed splat.
So the reference here is ``jax.vjp`` of the lax windowed splat
(``lsi_tpu/ops/splat.py:splat_bilinear(..., max_dy_window=)``) with
respect to its values, at the cotangent ``[image, 1]``; ``jax.grad``
through that gives the coordinate and image gradients.
``tests/test_torch_pallas_route.py`` holds the same functions to
``gather_pallas_diff`` itself, recorded in interpret mode by
``scripts/make_torch_golden_pallas.py``. The kernels run only on a CUDA
card: ``tests/test_torch_cuda.py``.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsi_tpu.ops.splat import splat_bilinear as j_splat
from lsi_tpu_torch.kernels import gather_cuda
from lsi_tpu_torch.ops.gather import bilinear_sample

H, W, C = 8, 16, 3
# Values and valid: the same float32 products in another order.
VAL_ATOL = 1e-5
# Gradients: 1e-5 of the largest entry.
GRAD_OF_MAX = 1e-5


def folded_case(seed, layers, max_dy, n=2, snap=False, spread=None):
    """An (N, H, W, C) image and (N, layers * H, W, 2) coordinates: each
    row within +-3 px across and +-(max_dy + 2) rows (``spread``) of its
    base row, so the window drops corners; with ``snap``, 10% of the
    fractions within 3e-5 of an integer."""
    rng = np.random.default_rng(seed)
    hs = layers * H
    dy = max_dy + 2 if spread is None else spread
    image = rng.uniform(size=(n, H, W, C)).astype(np.float32)
    x = np.arange(W)[None, None, :] + rng.uniform(-3, 3, (n, hs, W))
    y = (np.arange(hs) % H)[None, :, None] + rng.uniform(-dy, dy, (n, hs, W))
    if snap:
        for a in (x, y):
            near = rng.uniform(size=a.shape) < 0.1
            a[near] = (np.round(a[near])
                       + rng.choice([-3e-5, 3e-5], near.sum()))
    coords = np.stack([x, y], -1).astype(np.float32)
    g_s = rng.standard_normal((n, hs, W, C)).astype(np.float32)
    g_v = rng.standard_normal((n, hs, W, 1)).astype(np.float32)
    return image, coords, g_s, g_v


def jax_gather(image, coords, max_dy):
    """The TPU gather's semantics from the lax windowed splat: its VJP in
    the values at the cotangent [image, 1] (base row ``row % H``)."""
    n, hs, ws, _ = coords.shape
    c = image.shape[-1]

    def splat(values):
        return j_splat(values, coords, jnp.ones((n, hs, ws, 1)),
                       image.shape[1:3], max_dy_window=max_dy)[0]

    _, vjp = jax.vjp(splat, jnp.ones((n, hs, ws, c + 1), jnp.float32))
    (g,) = vjp(jnp.concatenate([image, jnp.ones(image.shape[:-1] + (1,))],
                               -1))
    return g[..., :c], g[..., c:]


@functools.partial(jax.jit, static_argnums=4)
def _jax_reference(image, coords, g_s, g_v, max_dy):
    def loss(img, crd):
        s, v = jax_gather(img, crd, max_dy)
        return jnp.sum(s * g_s) + jnp.sum(v * g_v)

    s, v = jax_gather(image, coords, max_dy)
    return (s, v) + jax.grad(loss, argnums=(0, 1))(image, coords)


def jax_reference(image, coords, g_s, g_v, max_dy):
    """(sampled, valid, d_image, d_coords) of the JAX reference (jitted:
    one compile a shape, faster than JAX's op-by-op first calls)."""
    return [np.asarray(a) for a in _jax_reference(
        *map(jnp.asarray, (image, coords, g_s, g_v)), max_dy)]


def port(image, coords, g_s, g_v, max_dy, fn=None):
    """(sampled, valid, d_image, d_coords) of ``GatherFn`` with a window
    (or ``fn``) on CPU tensors."""
    img = torch.from_numpy(image).requires_grad_()
    crd = torch.from_numpy(coords).requires_grad_()
    if fn is None:
        s, v = gather_cuda.GatherFn.apply(img, crd, max_dy)
    else:
        s, v = fn(img, crd)
    ((s * torch.from_numpy(g_s)).sum()
     + (v * torch.from_numpy(g_v)).sum()).backward()
    return [a.detach().numpy() for a in (s, v, img.grad, crd.grad)]


def assert_matches(got, want):
    for name, g, r in zip(("sampled", "valid"), got[:2], want[:2]):
        np.testing.assert_allclose(g, r, rtol=0, atol=VAL_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=VAL_ATOL,
                               err_msg="d_image")
    np.testing.assert_allclose(got[3], want[3], rtol=0,
                               atol=GRAD_OF_MAX * np.abs(want[3]).max(),
                               err_msg="d_coords")


@pytest.mark.parametrize("snap", [False, True], ids=["random", "snap"])
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("max_dy", [0, 1, 2, 8])
def test_windowed_gather_matches_transposed_jax_splat(max_dy, layers, snap):
    """``GatherFn`` with a window (its plain version on the CPU) against
    the transposed lax windowed splat: values, valid, and both gradients;
    some corners dropped, and the coordinate gradient 0 in the snap
    zones."""
    case = folded_case(10 * max_dy + layers, layers, max_dy, snap=snap)
    want = jax_reference(*case, max_dy)
    got = port(*case, max_dy)
    assert_matches(got, want)
    exact_valid = bilinear_sample(*map(torch.from_numpy, case[:2]))[1]
    dropped = (exact_valid.numpy() - want[1] > 1e-3).mean()
    # A window of H rows or more around a row of the image keeps it all.
    assert (dropped > 0.02) if max_dy < H - 1 else (dropped == 0)
    if snap:
        coords = case[1]
        for axis in (0, 1):
            f = coords[..., axis] - np.floor(coords[..., axis])
            zone = (f < 1e-4) | (f > 1 - 1e-4)
            assert zone.any()
            assert (got[3][..., axis][zone] == 0).all()


@pytest.mark.parametrize("radius", [1, 2])
def test_stacked_candidate_offsets_match_per_offset_jax(radius):
    """The inverse warp's candidate gathers: the (2r+1)^2 offsets stacked
    along the folded rows in one windowed gather at pallas_max_dy + r
    (their base rows stay ``row % H``) against JAX's gather of each
    offset on its own."""
    max_dy, layers = 1, 2
    image, coords, _, _ = folded_case(7, layers, max_dy, n=1, snap=True)
    offs = [(dx, dy) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]
    stacked = np.concatenate(
        [coords + np.asarray(o, np.float32) for o in offs], 1)
    k = len(offs)
    rng = np.random.default_rng(8)
    g_s = rng.standard_normal(stacked.shape[:-1] + (C,)).astype(np.float32)
    g_v = rng.standard_normal(stacked.shape[:-1] + (1,)).astype(np.float32)
    got = port(image, stacked, g_s, g_v, max_dy + radius)
    rows = layers * H
    parts = [jax_reference(image, stacked[:, i * rows:(i + 1) * rows],
                           g_s[:, i * rows:(i + 1) * rows],
                           g_v[:, i * rows:(i + 1) * rows], max_dy + radius)
             for i in range(k)]
    want = [np.concatenate([p[j] for p in parts], 1) for j in (0, 1, 3)]
    want.insert(2, sum(p[2] for p in parts))  # d_image sums over offsets
    assert_matches(got, want)


def test_wide_window_away_from_snap_zones_is_the_exact_gather():
    """A window that drops nothing, on coordinates with no fraction in a
    snap zone: the windowed gather equals the exact one, values and
    gradients."""
    image, coords, g_s, g_v = folded_case(3, 2, 2, spread=1.5)
    f = coords - np.floor(coords)
    coords = np.where((f < 1e-3) | (f > 1 - 1e-3), coords + 0.01,
                      coords).astype(np.float32)
    windowed = port(image, coords, g_s, g_v, H + 2)
    exact = port(image, coords, g_s, g_v, -1)
    for g, r in zip(windowed, exact):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)
    inside = ((coords[..., 0] >= 0) & (coords[..., 0] <= W - 1)
              & (coords[..., 1] >= 0) & (coords[..., 1] <= H - 1))
    assert (windowed[1][..., 0][inside] > 0.999).all()


def test_plain_windowed_gather_defaults_to_folded_rows():
    """``bilinear_sample(..., max_dy)`` measures rows from ``row % H`` by
    default, and from ``row % fold_h`` where a fold is given."""
    image, coords, _, _ = folded_case(4, 2, 1, n=1)
    img, crd = torch.from_numpy(image), torch.from_numpy(coords)
    a = bilinear_sample(img, crd, max_dy=1)
    b = bilinear_sample(img, crd, max_dy=1, fold_h=H)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = bilinear_sample(img, crd, max_dy=1, fold_h=2 * H)
    assert not torch.equal(a[1], c[1])


@pytest.mark.parametrize("max_dy,fold_h", [(1, 5), (1, 2 * H), (0, 0)])
def test_bad_gather_window_raises(max_dy, fold_h):
    """A window whose fold does not divide the coordinate rows, or exceeds
    the image, raises ValueError before any launch, in both directions."""
    image, coords, g_s, g_v = folded_case(5, 2, 1, n=1)
    img, crd = torch.from_numpy(image), torch.from_numpy(coords)
    with pytest.raises(ValueError):
        gather_cuda.gather_fwd(img, crd, max_dy, fold_h)
    with pytest.raises(ValueError):
        gather_cuda.gather_bwd_coords(img, crd, torch.from_numpy(g_s),
                                      torch.from_numpy(g_v), max_dy, fold_h)
    with pytest.raises(ValueError):
        gather_cuda.GatherFn.apply(img, crd, max_dy, fold_h)


def test_cpu_windowed_gather_counts_no_launch():
    """CPU tensors take the plain version: no launch counted, windowed or
    not."""
    image, coords, g_s, g_v = folded_case(6, 2, 1, n=1)
    before = (gather_cuda.gather_fwd.launches,
              gather_cuda.gather_fwd.window_launches,
              gather_cuda.gather_bwd_coords.launches,
              gather_cuda.gather_bwd_coords.window_launches)
    port(image, coords, g_s, g_v, 1)
    assert (gather_cuda.gather_fwd.launches,
            gather_cuda.gather_fwd.window_launches,
            gather_cuda.gather_bwd_coords.launches,
            gather_cuda.gather_bwd_coords.window_launches) == before
