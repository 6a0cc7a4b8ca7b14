"""The rounding slack that ``chip_smoke.py`` gives lsi_splat_vjp on a
step's own cotangents: ``splat_vjp_terms`` against a float64 loop over
the terms, the plain float32 VJP within float32's bound of the float64
one where the terms cancel, and planted faults beyond it.

The kernel itself runs only on a CUDA card (chip_smoke.py phases 11, 14
and 24 hold it with this slack).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lsi_tpu_torch.kernels import splat_cuda

OUT_HW = (5, 7)
MIN_FRACTION = 1e-4


def cancelling_case(seed: int, spread: float):
    """Splat inputs and the composite's cotangents (g / wsum and
    -g . accum / wsum^2, wsum down to ~1e-6), whose terms cancel."""
    rng = np.random.default_rng(seed)
    n, hs, ws, c = 2, 6, 8, 4
    oh, ow = OUT_HW
    values = rng.uniform(0, 1, (n, hs, ws, c)).astype(np.float32)
    x = rng.uniform(-spread, ow - 1 + spread, (n, hs, ws))
    y = rng.uniform(-spread, oh - 1 + spread, (n, hs, ws))
    # Some fractions inside the snap zones.
    x[:, ::3] = np.round(x[:, ::3]) + 5e-5
    coords = np.stack([x, y], -1).astype(np.float32)
    weights = rng.uniform(0, 2, (n, hs, ws, 1)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (values, coords, weights)]
    accum, wsum = splat_cuda.splat(*t, OUT_HW)
    wsum = wsum + 1e-6
    g = torch.from_numpy(rng.normal(size=(n, oh, ow, c)).astype(np.float32))
    g_wsum = -(g * accum).sum(-1, keepdim=True) / wsum ** 2
    return (*t, g / wsum, g_wsum)


def float64_vjp(values, coords, weights, g_accum, g_wsum):
    """(d_values, d_coords, d_weights) in float64 and their terms' T, one
    source pixel and corner at a time."""
    v, co, w, ga, gw = (t.double().numpy() for t in (
        values, coords, weights, g_accum, g_wsum))
    oh, ow = OUT_HW
    d = [np.zeros(v.shape), np.zeros(co.shape), np.zeros(w.shape)]
    t = [np.zeros(v.shape), np.zeros(co.shape), np.zeros(w.shape)]

    def snap(f):
        return 0.0 if f < MIN_FRACTION else 1.0 if f > 1 - MIN_FRACTION else f

    for b, i, j in np.ndindex(v.shape[:3]):
        x, y = co[b, i, j]
        x0, y0 = np.floor(x), np.floor(y)
        fx, fy = snap(x - x0), snap(y - y0)
        live = [MIN_FRACTION <= f <= 1 - MIN_FRACTION
                for f in (x - x0, y - y0)]
        frac = [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
        dfx = [-(1 - fy), 1 - fy, -fy, fy]
        dfy = [-(1 - fx), -fx, 1 - fx, fx]
        vv, ww = v[b, i, j], w[b, i, j, 0]
        for k, (dx, dy) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
            xi, yi = int(x0) + dx, int(y0) + dy
            if not (0 <= xi < ow and 0 <= yi < oh):
                continue
            g_a, g_w = ga[b, yi, xi], gw[b, yi, xi, 0]
            q = vv @ g_a + g_w
            big_q = np.abs(vv) @ np.abs(g_a) + abs(g_w)
            d[0][b, i, j] += ww * frac[k] * g_a
            t[0][b, i, j] += abs(ww) * frac[k] * np.abs(g_a)
            d[1][b, i, j] += ww * q * np.array([dfx[k] * live[0],
                                                dfy[k] * live[1]])
            t[1][b, i, j] += abs(ww) * big_q
            d[2][b, i, j, 0] += frac[k] * q
            t[2][b, i, j, 0] += frac[k] * big_q
    return d, t


@pytest.mark.parametrize("seed,spread", [(0, 1.5), (1, 0.2), (2, 3.0)])
def test_splat_vjp_slack_bounds_float32_rounding(seed, spread):
    inputs = cancelling_case(seed, spread)
    d64, t64 = float64_vjp(*inputs)
    terms = chip_smoke.splat_vjp_terms(*inputs, OUT_HW)
    for got, want in zip(terms, t64):
        np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-6,
                                   atol=0)
    # The terms cancel: T well above the gradients it bounds.
    assert t64[2].max() > 2 * np.abs(d64[2]).max()
    slack = chip_smoke.splat_vjp_slack(*inputs, OUT_HW)
    plain = splat_cuda._plain_vjp(*inputs, OUT_HW, (True, True, True))
    for p, want, s in zip(plain, d64, slack):
        # One float32 order within half the slack (gamma_n T) of float64.
        assert (np.abs(p.double().numpy() - want)
                <= s.double().numpy() / 2).all()
    # A coordinate off by 1/256 px or g_wsum off by 1e-3 is beyond
    # rtol, atol and the slack.
    values, coords, weights, g_accum, g_wsum = inputs
    for fault in ((values, coords + 1 / 256, weights, g_accum, g_wsum),
                  (values, coords, weights, g_accum, g_wsum * 1.001)):
        wrong = splat_cuda._plain_vjp(*fault, OUT_HW, (True, True, True))
        off = 0
        for w, p, s in zip(wrong, plain, slack):
            allowed = (chip_smoke.VJP_ATOL_OF_MAX * p.abs().max()
                       + chip_smoke.VJP_RTOL * p.abs() + s)
            off += int(((w - p).abs() > allowed).sum())
        assert off > 0
