"""The port's windowed plain splat (``ops/splat.splat_bilinear`` with
``max_dy_window`` and ``base_rows``) against JAX's, forward and the
gradients for values, coordinates and weights; ``SplatFn`` and the K1/K2
wrappers with a window on CPU tensors; the window's argument checks.

JAX runs its lax oracle (``lsi_tpu/ops/splat.py``), the semantics of the
TPU kernel's window; the tolerances are ``tests/test_spatial.py``'s
(1e-5 forward, rtol 1e-4 / atol 1e-6 gradients). The CUDA kernels' window
is held to this plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsi_tpu.ops import splat as jsplat
from lsi_tpu_torch.kernels import splat_cuda
from lsi_tpu_torch.ops import splat as tsplat

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def window_case(rng, max_dy, fold_h=8, base_offset=3, layers=2, n=2, w=32,
                reach=3):
    """Folded-layer inputs around base rows ``r % fold_h + base_offset``
    in a target of ``fold_h + 2 base_offset`` rows: rows up to ``max_dy +
    reach`` away, every fifth pixel on an integer row (corners exactly on
    the window's edges), some far outside."""
    hs = layers * fold_h
    out_h = fold_h + 2 * base_offset
    values = rng.uniform(size=(n, hs, w, 4)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, (n, hs, w, 1)).astype(np.float32)
    base = np.arange(hs) % fold_h + base_offset
    x = (np.arange(w, dtype=np.float32)[None, None]
         + rng.uniform(-6, 6, (n, hs, w)))
    y = base[None, :, None] + rng.uniform(-max_dy - reach, max_dy + reach,
                                          (n, hs, w))
    y[:, :, ::5] = np.round(y[:, :, ::5])
    x[:, :, 7::31] = 1e6
    coords = np.stack([x, y], -1).astype(np.float32)
    return values, coords, weights, base, (out_h, w)


def jax_splat(values, coords, weights, out_hw, max_dy, base):
    return jsplat.splat_bilinear(
        values, coords, weights, out_hw, max_dy_window=max_dy,
        base_rows=None if base is None else jnp.asarray(base, jnp.int32))


@pytest.mark.parametrize("base_offset", [0, 3])
@pytest.mark.parametrize("max_dy", [0, 1, 2])
def test_windowed_plain_splat_matches_jax(rng, max_dy, base_offset):
    values, coords, weights, base, out_hw = window_case(
        rng, max_dy, base_offset=base_offset)
    base_t = torch.from_numpy(base)
    t_in = [torch.from_numpy(a).requires_grad_()
            for a in (values, coords, weights)]
    acc, ws = tsplat.splat_bilinear(*t_in, out_hw, max_dy_window=max_dy,
                                    base_rows=base_t)
    j_in = [jnp.asarray(a) for a in (values, coords, weights)]
    (j_acc, j_ws), vjp = jax.vjp(
        lambda *a: jax_splat(*a, out_hw, max_dy, base), *j_in)
    np.testing.assert_allclose(acc.detach().numpy(), np.asarray(j_acc),
                               **FWD_TOL)
    np.testing.assert_allclose(ws.detach().numpy(), np.asarray(j_ws),
                               **FWD_TOL)
    # The window really drops corners here, and keeps some at its edges.
    full = tsplat.splat_bilinear(*(t.detach() for t in t_in), out_hw)[1]
    assert float(full.sum()) > float(ws.detach().sum()) + 1.0
    g_acc = rng.standard_normal(acc.shape).astype(np.float32)
    g_ws = rng.standard_normal(ws.shape).astype(np.float32)
    grads = torch.autograd.grad((acc, ws), t_in, (torch.from_numpy(g_acc),
                                                  torch.from_numpy(g_ws)))
    j_grads = vjp((jnp.asarray(g_acc), jnp.asarray(g_ws)))
    for name, g, jg in zip(("values", "coords", "weights"), grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD_TOL,
                                   err_msg=name)


def test_default_base_rows_are_row_mod_out_h(rng):
    """Without ``base_rows`` the base row is ``row % out_h`` (the folded
    layers' contract), as in JAX."""
    values, coords, weights, _, out_hw = window_case(rng, 1, fold_h=14,
                                                     base_offset=0)
    got = tsplat.splat_bilinear(*map(torch.from_numpy,
                                     (values, coords, weights)), out_hw,
                                max_dy_window=1)
    want = jax_splat(values, coords, weights, out_hw, 1, None)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **FWD_TOL)


def test_edge_rows_are_kept_and_the_next_dropped():
    """A source pixel exactly on row base + d: corner rows base + d and
    base + d + 1 with fractions 1 and 0; the window keeps the rows
    [base - m, base + m + 1] and drops the rest, one row at a time."""
    m, fold_h, base_offset = 1, 4, 4
    out_hw = (fold_h + 2 * base_offset, 8)
    for d, kept in ((-m - 1, False), (-m, True), (m, True), (m + 1, True),
                    (m + 2, False)):
        coords = torch.zeros(1, fold_h, 8, 2)
        coords[..., 0] = torch.arange(8.0)
        coords[..., 1] = (torch.arange(fold_h)[:, None] + base_offset
                          + d).float()
        values = torch.ones(1, fold_h, 8, 1)
        weights = torch.ones(1, fold_h, 8, 1)
        _, ws = splat_cuda.splat(values, coords, weights, out_hw, max_dy=m,
                                 fold_h=fold_h, base_offset=base_offset)
        assert float(ws.sum()) == (fold_h * 8 if kept else 0.0), d


@pytest.mark.parametrize("max_dy", [0, 2])
def test_splat_fn_window_on_cpu_matches_jax(rng, max_dy):
    """``SplatFn`` with (max_dy, fold_h, base_offset) on CPU tensors: the
    plain windowed splat forward, its autograd VJP backward (the path
    ``splat_vjp`` takes on the CPU), against JAX."""
    fold_h, base_offset = 8, 4
    values, coords, weights, base, out_hw = window_case(
        rng, max_dy, fold_h=fold_h, base_offset=base_offset, layers=3)
    t_in = [torch.from_numpy(a).requires_grad_()
            for a in (values, coords, weights)]
    acc, ws = splat_cuda.SplatFn.apply(*t_in, out_hw, max_dy, fold_h,
                                       base_offset)
    j_in = [jnp.asarray(a) for a in (values, coords, weights)]
    (j_acc, j_ws), vjp = jax.vjp(
        lambda *a: jax_splat(*a, out_hw, max_dy, base), *j_in)
    np.testing.assert_allclose(acc.detach().numpy(), np.asarray(j_acc),
                               **FWD_TOL)
    np.testing.assert_allclose(ws.detach().numpy(), np.asarray(j_ws),
                               **FWD_TOL)
    g = (torch.from_numpy(rng.standard_normal(acc.shape).astype(np.float32)),
         torch.from_numpy(rng.standard_normal(ws.shape).astype(np.float32)))
    grads = torch.autograd.grad((acc, ws), t_in, g)
    j_grads = vjp(tuple(jnp.asarray(x.numpy()) for x in g))
    for name, a, b in zip(("values", "coords", "weights"), grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)
    direct = splat_cuda.splat_vjp(*(t.detach() for t in t_in), *g, out_hw,
                                  max_dy=max_dy, fold_h=fold_h,
                                  base_offset=base_offset)
    for a, b in zip(direct, grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unwindowed_calls_are_unchanged(rng):
    """max_dy = -1 (the default) is the exact splat: fold_h and
    base_offset are ignored."""
    values, coords, weights, _, out_hw = window_case(rng, 1)
    args = [torch.from_numpy(a) for a in (values, coords, weights)]
    want = tsplat.splat_bilinear(*args, out_hw)
    for got in (splat_cuda.splat(*args, out_hw),
                splat_cuda.SplatFn.apply(*args, out_hw),
                splat_cuda.splat(*args, out_hw, max_dy=-1, fold_h=5,
                                 base_offset=99)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("fold_h, base_offset, match", [
    (5, 0, "multiple of fold_h"),     # 16 source rows, fold 5
    (8, 7, "inside the target"),      # base rows [7, 15) in 14 rows
    (8, -1, "inside the target"),
])
def test_window_arguments_are_checked(rng, fold_h, base_offset, match):
    values, coords, weights, _, out_hw = window_case(rng, 1)
    args = [torch.from_numpy(a) for a in (values, coords, weights)]
    with pytest.raises(ValueError, match=match):
        splat_cuda.splat(*args, out_hw, max_dy=1, fold_h=fold_h,
                         base_offset=base_offset)
    g = (torch.zeros(2, *out_hw, 4), torch.zeros(2, *out_hw, 1))
    with pytest.raises(ValueError, match=match):
        splat_cuda.splat_vjp(*args, *g, out_hw, max_dy=1, fold_h=fold_h,
                             base_offset=base_offset)
