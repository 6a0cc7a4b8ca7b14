"""The port's plain splat (the CUDA kernel's CPU path and its reference)
vs the numpy loop oracle and the JAX lax splat; its VJP and tent sums (the
plain form of K2 + K3) vs jax.vjp; SplatFn on CPU tensors; the wrappers'
dispatch and input checks.

The kernel itself runs only on a CUDA card: tests/test_torch_cuda.py.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_np
from lsi_tpu.ops import gather as jgather
from lsi_tpu.ops import splat as jsplat
from lsi_tpu_torch.kernels import splat_cuda
from lsi_tpu_torch.ops import splat as tsplat

OUT_HW = (16, 128)


def splat_case(rng, kind, n=2, layers=2, c=4):
    """Folded-layer splat inputs (N, L*16, 128) of one kind of coordinate."""
    h, w = OUT_HW
    hs = layers * h
    values = rng.uniform(size=(n, hs, w, c)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, (n, hs, w, 1)).astype(np.float32)
    bx = np.broadcast_to(np.arange(w, dtype=np.float32), (n, hs, w))
    by = np.broadcast_to((np.arange(hs, dtype=np.float32) % h)[:, None],
                         (n, hs, w))
    if kind == "integer":
        x, y = bx + 3.0, by - 1.0
    elif kind == "near_integer":  # fractions inside the snap zones
        x = bx + rng.choice([-5e-5, 5e-5, 0.5], (n, hs, w)).astype(np.float32)
        y = by + rng.choice([-5e-5, 5e-5], (n, hs, w)).astype(np.float32)
    else:
        x = bx + rng.uniform(-8, 8, (n, hs, w)).astype(np.float32)
        y = by + rng.uniform(-1.5, 1.5, (n, hs, w)).astype(np.float32)
    x, y = x.copy(), y.copy()
    if kind == "out_of_image":
        x[:, :, :10] = rng.uniform(-3.0, -1.0, (n, hs, 10))
        x[:, :, -10:] = rng.uniform(w, w + 2.0, (n, hs, 10))
        y[:, :4] = -2.5
    if kind == "huge":
        far = rng.uniform(size=(n, hs, w)) < 0.2
        x[far] = rng.choice([1e6, -1e6, 3.4e38], int(far.sum()))
        y[rng.uniform(size=(n, hs, w)) < 0.2] = -1e6
    coords = np.stack([x, y], -1).astype(np.float32)
    return values, coords, weights


@pytest.mark.parametrize(
    "kind", ["random", "integer", "near_integer", "out_of_image", "huge"])
def test_plain_splat_matches_oracle_and_jax(rng, kind):
    values, coords, weights = splat_case(rng, kind)
    acc, ws = tsplat.splat_bilinear(torch.from_numpy(values),
                                    torch.from_numpy(coords),
                                    torch.from_numpy(weights), OUT_HW)
    j_acc, j_ws = jsplat.splat_bilinear(jnp.asarray(values),
                                        jnp.asarray(coords),
                                        jnp.asarray(weights), OUT_HW)
    # Both sum float32 contributions with one scatter-add; the order may
    # differ: 1e-5.
    np.testing.assert_allclose(acc.numpy(), np.asarray(j_acc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ws.numpy(), np.asarray(j_ws), rtol=1e-5,
                               atol=1e-5)
    for i in range(values.shape[0]):
        r_acc, r_ws = reference_np.splat_np(values[i], coords[i],
                                            weights[i, ..., 0], OUT_HW)
        # float32 against the float64 oracle.
        np.testing.assert_allclose(acc[i].numpy(), r_acc, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(ws[i, ..., 0].numpy(), r_ws, rtol=1e-4,
                                   atol=1e-5)


def test_plain_splat_drops_non_finite_coords(rng):
    """inf/nan coordinates never reach the integer conversion: dropped."""
    values, coords, weights = splat_case(rng, "random", n=1)
    bad = coords.copy()
    bad[0, 0, :3] = [[np.nan, 2.0], [np.inf, 2.0], [2.0, -np.inf]]
    keep = np.ones(weights.shape, np.float32)
    keep[0, 0, :3] = 0.0
    acc, ws = tsplat.splat_bilinear(torch.from_numpy(values),
                                    torch.from_numpy(bad),
                                    torch.from_numpy(weights), OUT_HW)
    want = tsplat.splat_bilinear(torch.from_numpy(values),
                                 torch.from_numpy(coords),
                                 torch.from_numpy(weights * keep), OUT_HW)
    np.testing.assert_allclose(acc.numpy(), want[0].numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ws.numpy(), want[1].numpy(), rtol=1e-6,
                               atol=1e-6)


def test_snap_fraction_matches_jax():
    f = np.array([0.0, 5e-5, 1e-4, 0.3, 1 - 1e-4, 1 - 5e-5, 1.0],
                 np.float32)
    np.testing.assert_array_equal(
        tsplat.snap_fraction(torch.from_numpy(f)).numpy(),
        np.asarray(jsplat.snap_fraction(jnp.asarray(f))))


def test_wrapper_takes_plain_version_on_cpu_and_does_not_count(rng):
    values, coords, weights = (torch.from_numpy(a)
                               for a in splat_case(rng, "random", c=3))
    before = splat_cuda.splat.launches
    acc, ws = splat_cuda.splat(values, coords, weights, OUT_HW)
    ref = tsplat.splat_bilinear(values, coords, weights, OUT_HW)
    assert torch.equal(acc, ref[0]) and torch.equal(ws, ref[1])
    assert splat_cuda.splat.launches == before


BAD_INPUTS = {
    "float64_values": lambda v, c, w: (v.double(), c, w),
    "coords_shape": lambda v, c, w: (v, c[..., :1].contiguous(), w),
    "weights_shape": lambda v, c, w: (v, c, w[:, :-1].contiguous()),
    "non_contiguous": lambda v, c, w: (v.transpose(1, 2), c, w),
    "too_many_channels": lambda v, c, w: (v.repeat(1, 1, 1, 3), c, w),
    "meta_device": lambda v, c, w: (v.to("meta"), c.to("meta"),
                                    w.to("meta")),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrapper_rejects_bad_inputs(case):
    args = BAD_INPUTS[case](torch.zeros(1, 4, 4, 4), torch.zeros(1, 4, 4, 2),
                            torch.zeros(1, 4, 4, 1))
    with pytest.raises((ValueError, TypeError)):
        splat_cuda.splat(*args, (4, 4))


# ------------------------------------------------ the VJP (K2 + K3 plain)

def cotangents(rng, n, c):
    return (rng.normal(size=(n,) + OUT_HW + (c,)).astype(np.float32),
            rng.normal(size=(n,) + OUT_HW + (1,)).astype(np.float32))


def jax_splat_vjp(values, coords, weights, g_accum, g_wsum):
    _, f = jax.vjp(lambda v, c, w: jsplat.splat_bilinear(v, c, w, OUT_HW),
                   jnp.asarray(values), jnp.asarray(coords),
                   jnp.asarray(weights))
    return [np.asarray(d) for d in f((jnp.asarray(g_accum),
                                      jnp.asarray(g_wsum)))]


def snap_live(coords):
    """1 where a coordinate's fraction carries a gradient (not snapped)."""
    f = coords - np.floor(coords)
    return ((f >= tsplat.MIN_FRACTION)
            & (f <= np.float32(1.0) - np.float32(tsplat.MIN_FRACTION)))


@pytest.mark.parametrize(
    "kind", ["random", "integer", "near_integer", "out_of_image", "huge"])
def test_plain_splat_vjp_matches_jax(rng, kind):
    """The plain VJP (autograd through splat_bilinear: the CPU path of
    SplatFn's backward) against jax.vjp of the lax splat, including the
    zero coordinate gradient in snap zones; and the same VJP assembled from
    tent_sums the way the CUDA kernel assembles it."""
    values, coords, weights = splat_case(rng, kind)
    g_accum, g_wsum = cotangents(rng, values.shape[0], values.shape[-1])
    ref = jax_splat_vjp(values, coords, weights, g_accum, g_wsum)
    if kind == "near_integer":  # every y fraction lies in a snap zone
        assert np.abs(ref[1][..., 1]).max() == 0.0

    args = [torch.from_numpy(a) for a in (values, coords, weights, g_accum,
                                          g_wsum)]
    got = splat_cuda.splat_vjp(*args, OUT_HW)
    # Sums of 4 float32 products per output in another order: 1e-5.
    for name, g, r in zip(("d_values", "d_coords", "d_weights"), got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5,
                                   err_msg=name)

    # The kernel's algebra: S0/SX/SY of [g_accum, g_wsum] at the snapped
    # corners, then d_values = w S0, d_weights = v.S0 + S0_w,
    # d_coords = w (v.SX + SX_w, v.SY + SY_w) where the fraction is live.
    s0, sx, sy = tsplat.tent_sums(torch.cat(args[3:5], -1), args[1],
                                  snap=True)
    v = torch.cat([args[0], torch.ones_like(args[2])], -1)
    w = args[2]
    live = torch.from_numpy(snap_live(coords))
    kernel_like = (w * s0[..., :-1],
                   torch.stack([(v * sx).sum(-1), (v * sy).sum(-1)], -1)
                   * w * live,
                   (v * s0).sum(-1, keepdim=True))
    for name, g, r in zip(("d_values", "d_coords", "d_weights"), kernel_like,
                          ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("snap", [True, False])
def test_tent_sums_match_jax(rng, snap):
    """S0 is the bilinear gather (snapped or not); SX and SY are its x and
    y derivatives (JAX's jvp), except where a snapped fraction is flat."""
    _, coords, _ = splat_case(rng, "random")
    image = rng.normal(size=(coords.shape[0],) + OUT_HW + (3,)).astype(
        np.float32)
    s0, sx, sy = tsplat.tent_sums(torch.from_numpy(image),
                                  torch.from_numpy(coords), snap=snap)
    if snap:
        # The splat VJP with unit weights and values is S0 in d_values.
        ones = np.ones(coords.shape[:-1] + (1,), np.float32)
        ref = jax_splat_vjp(np.ones(coords.shape[:-1] + (3,), np.float32),
                            coords, ones, image, 0 * ones[:, :16])[0]
        np.testing.assert_allclose(s0.numpy(), ref, rtol=1e-5, atol=1e-5)
        return
    fn = lambda c: jgather.bilinear_sample(jnp.asarray(image), c)[0]
    want0 = np.asarray(fn(jnp.asarray(coords)))
    np.testing.assert_allclose(s0.numpy(), want0, rtol=1e-5, atol=1e-5)
    for axis, got in ((0, sx), (1, sy)):
        tangent = np.zeros_like(coords)
        tangent[..., axis] = 1.0
        _, want = jax.jvp(fn, (jnp.asarray(coords),), (jnp.asarray(tangent),))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("needs", [(True, True, True), (False, True, False),
                                   (True, False, True)])
def test_splat_fn_on_cpu_matches_autograd(rng, needs):
    """SplatFn's backward returns exactly the gradients autograd asks for,
    equal to autograd through the plain splat."""
    values, coords, weights = splat_case(rng, "random")
    g_accum, g_wsum = (torch.from_numpy(a) for a in
                       cotangents(rng, values.shape[0], values.shape[-1]))
    outs = []
    for fn in (splat_cuda.SplatFn.apply, tsplat.splat_bilinear):
        ins = [torch.from_numpy(a).requires_grad_(need)
               for a, need in zip((values, coords, weights), needs)]
        accum, wsum = fn(*ins, OUT_HW)
        (accum * g_accum + wsum * g_wsum).sum().backward()
        outs.append([t.grad for t in ins])
    for got, want, need in zip(*outs, needs):
        assert (got is None) == (not need)
        if need:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_splat_refuses_tensors_that_require_grad(rng):
    """The kernel wrappers record no autograd node: a direct call on a
    tensor that requires grad raises instead of dropping the gradient."""
    values, coords, weights = (torch.from_numpy(a)
                               for a in splat_case(rng, "random", n=1))
    g = cotangents(rng, 1, 4)
    with pytest.raises(RuntimeError, match="autograd"):
        splat_cuda.splat(values.requires_grad_(), coords, weights, OUT_HW)
    with pytest.raises(RuntimeError, match="autograd"):
        splat_cuda.splat_vjp(values, coords, weights,
                             *(torch.from_numpy(a) for a in g), OUT_HW)
    with torch.no_grad():
        splat_cuda.splat(values, coords, weights, OUT_HW)
    before = splat_cuda.splat_vjp.launches
    values.requires_grad_(False)
    splat_cuda.splat_vjp(values, coords, weights,
                         *(torch.from_numpy(a) for a in g), OUT_HW)
    assert splat_cuda.splat_vjp.launches == before  # CPU calls do not count


def test_unsnapped_splat_is_the_gather_transpose(rng):
    """snap=False gives the exact transpose of the plain gather (the
    gather's image gradient): <splat(g), I> == <g, gather(I)>."""
    values, coords, _ = splat_case(rng, "out_of_image")
    ones = np.ones(coords.shape[:-1] + (1,), np.float32)
    image = rng.normal(size=(values.shape[0],) + OUT_HW + (4,)).astype(
        np.float32)
    accum, _ = splat_cuda.splat(*(torch.from_numpy(a)
                                  for a in (values, coords, ones)),
                                OUT_HW, snap=False)
    from lsi_tpu_torch.ops.gather import bilinear_sample
    sampled, _ = bilinear_sample(torch.from_numpy(image),
                                 torch.from_numpy(coords))
    lhs = float((accum.double() * torch.from_numpy(image).double()).sum())
    rhs = float((torch.from_numpy(values).double() * sampled.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(rhs)
