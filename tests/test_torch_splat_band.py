"""The band kernel's arithmetic (the windowed K1, ``csrc/splat_band.cu``)
on the CPU, and the gather's image gradient without unit weights.

The kernel runs only on a CUDA card (``tests/test_torch_cuda.py``); its
plan (``splat_cuda.band_tiling``) is checked in
``tests/test_torch_tiling.py``. Here the plain windowed splat is run as
the kernel runs it: band by band, on the source rows the plan visits
(``band_source_rows``), each band clipped to its own target rows, then
stitched. That must equal the JAX package's lax windowed splat
(``lsi_tpu/ops/splat.py:splat_bilinear(..., max_dy_window, base_rows)``)
on the whole image: a source row the band does not visit has no corner
in its rows. No Pallas call is made.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsi_tpu.ops import gather as jgather
from lsi_tpu.ops.splat import splat_bilinear as j_splat
from lsi_tpu_torch.kernels import gather_cuda, splat_cuda
from lsi_tpu_torch.ops.splat import splat_bilinear
from test_torch_gather_window import folded_case, jax_reference

# The same float32 products summed in another order: 1e-6 relative, and
# 1e-6 of the largest entry.
RTOL = 1e-6
ATOL_OF_MAX = 1e-6


def band_case(seed, c, window, layers, ws, snap_zone):
    """Windowed-splat inputs: each source row within max_dy + 3 rows of its
    base row ``r % fold_h + base_offset`` in a target of ``fold_h + 2
    base_offset + 1`` rows, a third of them on integer rows (corners
    exactly on window and band edges), 5% at +-1e6; with ``snap_zone``,
    10% of the fractions within 3e-5 of an integer, else none within 1e-3
    (where the snapped and unsnapped splats agree)."""
    max_dy, fold_h, base_offset = window
    rng = np.random.default_rng(seed)
    n, hs = 2, layers * fold_h
    values = rng.uniform(size=(n, hs, ws, c)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, (n, hs, ws, 1)).astype(np.float32)
    base = np.arange(hs) % fold_h + base_offset
    x = np.arange(ws)[None, None] + rng.uniform(-6, 6, (n, hs, ws))
    y = base[None, :, None] + rng.uniform(-max_dy - 3, max_dy + 3,
                                          (n, hs, ws))
    y[:, :, ::3] = np.round(y[:, :, ::3])
    for a in (x, y):
        if snap_zone:
            near = rng.uniform(size=a.shape) < 0.1
            a[near] = np.round(a[near]) + rng.choice([-3e-5, 3e-5],
                                                     near.sum())
        else:
            f = a - np.floor(a)
            a[(f < 1e-3) | (f > 1 - 1e-3)] += 0.01
    x[rng.uniform(size=x.shape) < 0.05] = 1e6
    y[rng.uniform(size=y.shape) < 0.05] = -1e6
    coords = np.stack([x, y], -1).astype(np.float32)
    return values, coords, weights, (fold_h + 2 * base_offset + 1, ws)


def banded_splat(values, coords, weights, out_hw, window, snap, rows):
    """The plain windowed splat, run band by band as the band kernel runs
    it in bands of ``rows`` target rows, and stitched."""
    max_dy, fold_h, base_offset = window
    n, hs, _, c = values.shape
    out_h, out_w = out_hw
    band_rows = rows
    accum = torch.full((n, out_h, out_w, c), float("nan"))
    wsum = None if weights is None else torch.full((n, out_h, out_w, 1),
                                                   float("nan"))
    for t0 in range(0, out_h, band_rows):
        rows = min(band_rows, out_h - t0)
        src = torch.tensor(splat_cuda.band_source_rows(
            t0, rows, window, hs // fold_h), dtype=torch.int64)
        a, w = splat_bilinear(
            values[:, src], coords[:, src],
            None if weights is None else weights[:, src], out_hw,
            snap=snap, max_dy_window=max_dy,
            base_rows=src % fold_h + base_offset)
        accum[:, t0:t0 + rows] = a[:, t0:t0 + rows]
        if wsum is not None:
            wsum[:, t0:t0 + rows] = w[:, t0:t0 + rows]
    return accum, wsum


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def jax_splat(values, coords, weights, out_h, out_w, max_dy, base_key):
    fold_h, base_offset, hs = base_key
    base = jnp.arange(hs, dtype=jnp.int32) % fold_h + base_offset
    return j_splat(values, coords, weights, (out_h, out_w),
                   max_dy_window=max_dy, base_rows=base)


# (max_dy, fold_h, base_offset), layers, width: fold_h below the target's
# height, base_offset > 0, ragged widths and band heights.
BAND_CASES = [((0, 12, 2), 1, 40), ((2, 10, 3), 2, 33), ((8, 16, 1), 3, 24),
              ((16, 24, 0), 2, 17)]


@pytest.mark.parametrize("case", range(len(BAND_CASES)))
@pytest.mark.parametrize("snap", [True, False], ids=["snapped", "unsnapped"])
@pytest.mark.parametrize("c", [1, 3, 4, 5])
def test_band_by_band_equals_jax_windowed_splat(c, snap, case):
    """In the bands of ``band_tiling``'s plan, and of 3 and 7 rows (ragged
    last bands); snapped on inputs with fractions in the snap zones,
    unsnapped on inputs with none near them (JAX's lax splat always
    snaps); at C = 3 without weights, as the gather's image gradient,
    against JAX with unit weights."""
    window, layers, ws = BAND_CASES[case]
    values, coords, weights, out_hw = band_case(10 * case + c, c, window,
                                                layers, ws, snap)
    ones = np.ones_like(weights)
    if c == 3:
        weights = None
    want = jax_splat(values, coords, ones if weights is None else weights,
                     *out_hw, window[0],
                     (window[1], window[2], coords.shape[1]))
    plan = splat_cuda.band_tiling(values.shape, out_hw, window,
                                  weights=weights is not None)
    inputs = [None if a is None else torch.from_numpy(a)
              for a in (values, coords, weights)]
    for rows in (plan.rows, 3, 7):
        got = banded_splat(*inputs, out_hw, window, snap, rows)
        for name, g, w in zip(("accum", "wsum"), got, want):
            if g is None:
                continue
            w = np.asarray(w)
            assert np.abs(w).max() > 0
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                       atol=ATOL_OF_MAX * np.abs(w).max(),
                                       err_msg=f"{name}, bands of {rows}")


def record_splat_weights(monkeypatch):
    """The ``weights`` argument of every K1 call made through
    ``gather_cuda``'s ``splat``."""
    seen = []
    splat = gather_cuda.splat

    def recorder(values, coords, weights, *args, **kwargs):
        seen.append(weights)
        return splat(values, coords, weights, *args, **kwargs)

    monkeypatch.setattr(gather_cuda, "splat", recorder)
    return seen


@pytest.mark.parametrize("max_dy", [-1, 2], ids=["exact", "window 2"])
def test_gather_fn_image_gradient_without_unit_weights(monkeypatch, max_dy):
    """GatherFn's image gradient splats the ``sampled`` cotangent with no
    weights and no wsum, and equals jax.grad through JAX's gather: the lax
    bilinear gather (exact), or the transposed lax windowed splat (K4-W,
    as tests/test_torch_gather_window.py holds it)."""
    seen = record_splat_weights(monkeypatch)
    image, coords, g_s, g_v = folded_case(7, 3, max(max_dy, 0), snap=True)
    img = torch.from_numpy(image).requires_grad_()
    crd = torch.from_numpy(coords)
    s, v = gather_cuda.GatherFn.apply(img, crd, max_dy)
    ((s * torch.from_numpy(g_s)).sum()
     + (v * torch.from_numpy(g_v)).sum()).backward()
    assert seen == [None]
    if max_dy >= 0:
        want = jax_reference(image, coords, g_s, g_v, max_dy)[2]
    else:
        def loss(im):
            js, jv = jgather.bilinear_sample(im, jnp.asarray(coords))
            return jnp.sum(js * g_s) + jnp.sum(jv * g_v)
        want = np.asarray(jax.grad(loss)(jnp.asarray(image)))
    np.testing.assert_allclose(img.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_plain_splat_without_weights_is_the_unit_weight_splat():
    """``splat_bilinear(..., weights=None)`` (the CPU side of K1 without
    weights) is the unit-weight splat's accum, bitwise, and has no wsum."""
    values, coords, weights, out_hw = band_case(3, 3, (2, 10, 3), 2, 33,
                                                True)
    v, c = torch.from_numpy(values), torch.from_numpy(coords)
    base = torch.arange(v.shape[1]) % 10 + 3
    for kw in ({}, dict(max_dy_window=2, base_rows=base)):
        accum, wsum = splat_bilinear(v, c, None, out_hw, **kw)
        want, _ = splat_bilinear(v, c, torch.ones(v.shape[:-1] + (1,)),
                                 out_hw, **kw)
        assert wsum is None and torch.equal(accum, want)
    accum, wsum = splat_cuda.splat(v, c, None, out_hw, max_dy=2, fold_h=10,
                                   base_offset=3)
    assert wsum is None and torch.equal(
        accum, splat_bilinear(v, c, None, out_hw, max_dy_window=2,
                              base_rows=base)[0])
