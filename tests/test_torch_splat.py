"""The port's plain splat (the CUDA kernel's CPU path and its reference)
vs the numpy loop oracle and the JAX lax splat; the wrapper's dispatch
and input checks.

The kernel itself runs only on a CUDA card: tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import reference_np
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
