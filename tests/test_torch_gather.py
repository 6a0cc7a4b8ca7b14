"""The port's bilinear gather (K4's plain version and CPU path) vs the JAX
lax gather and the numpy loop oracle: values, the ``valid`` mass and the
VJP in the coordinates and the image; ``GatherFn`` on CPU tensors; the
per-layer inverse-warp gather of ``geometry/ldi.py`` with its gradients.

The kernels themselves run only on a CUDA card: tests/test_torch_cuda.py.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_np
from lsi_tpu.geometry import transforms as jtf
from lsi_tpu.geometry.ldi import LDI as JLDI
from lsi_tpu.geometry.ldi import gather_target_per_layer as j_gather_layers
from lsi_tpu.ops import gather as jgather
from lsi_tpu_torch.geometry.ldi import (LDI, gather_target_per_layer,
                                        gather_target_per_layer_folded)
from lsi_tpu_torch.kernels import gather_cuda
from lsi_tpu_torch.ops import gather as tgather

IMG_HW = (12, 20)


def gather_case(rng, kind, n=2, hs=9, ws=20, c=3):
    """(N, Hi, Wi, C) image and (N, Hs, Ws, 2) coordinates of one kind."""
    h, w = IMG_HW
    image = rng.uniform(size=(n, h, w, c)).astype(np.float32)
    x = rng.uniform(-0.5, w - 0.5, (n, hs, ws))
    y = rng.uniform(-0.5, h - 0.5, (n, hs, ws))
    if kind == "border":  # corners straddling every edge of the image
        x[:, :, :5] = rng.uniform(-1.5, 0.5, (n, hs, 5))
        x[:, :, -5:] = rng.uniform(w - 1.5, w + 0.5, (n, hs, 5))
        y[:, :3] = rng.uniform(-1.5, 0.5, (n, 3, ws))
        y[:, -3:] = rng.uniform(h - 1.5, h + 0.5, (n, 3, ws))
    elif kind == "integer":
        x = np.round(x)
        y = np.round(y)
    elif kind == "huge":
        x[rng.uniform(size=x.shape) < 0.2] = 1e6
        y[rng.uniform(size=y.shape) < 0.2] = -1e6
    coords = np.stack([x, y], -1).astype(np.float32)
    return image, coords


KINDS = ["random", "border", "integer", "huge"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_gather_matches_jax_and_oracle(rng, kind):
    image, coords = gather_case(rng, kind)
    sampled, valid = tgather.bilinear_sample(torch.from_numpy(image),
                                             torch.from_numpy(coords))
    j_sampled, j_valid = jgather.bilinear_sample(jnp.asarray(image),
                                                 jnp.asarray(coords))
    # The same float32 products, summed in the same order: 1e-6.
    np.testing.assert_allclose(sampled.numpy(), np.asarray(j_sampled),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(valid.numpy(), np.asarray(j_valid), rtol=1e-6,
                               atol=1e-6)
    for i in range(image.shape[0]):
        r_sampled, r_valid = reference_np.bilinear_sample_np(image[i],
                                                             coords[i])
        # float32 against the float64 oracle.
        np.testing.assert_allclose(sampled[i].numpy(), r_sampled, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(valid[i, ..., 0].numpy(), r_valid,
                                   rtol=1e-5, atol=1e-5)


def jax_vjp(image, coords, g_sampled, g_valid):
    _, f = jax.vjp(jgather.bilinear_sample, jnp.asarray(image),
                   jnp.asarray(coords))
    d_image, d_coords = f((jnp.asarray(g_sampled), jnp.asarray(g_valid)))
    return np.asarray(d_image), np.asarray(d_coords)


def cotangents(rng, coords, c):
    shape = coords.shape[:-1]
    return (rng.normal(size=shape + (c,)).astype(np.float32),
            rng.normal(size=shape + (1,)).astype(np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_plain_gather_vjp_matches_jax(rng, kind):
    """Autograd through the plain gather, GatherFn on CPU tensors, and the
    coordinate VJP of ``gather_bwd_coords``' CPU path (with the ``valid``
    cotangent, which is non-zero only near the border): all equal to
    ``jax.vjp`` in the image and the coordinates."""
    image, coords = gather_case(rng, kind)
    g_sampled, g_valid = cotangents(rng, coords, image.shape[-1])
    d_image_ref, d_coords_ref = jax_vjp(image, coords, g_sampled, g_valid)
    if kind == "border":  # the valid mass carries a gradient there
        _, d_only_valid = jax_vjp(image, coords, 0 * g_sampled, g_valid)
        assert np.abs(d_only_valid).max() > 0.1

    for fn in (tgather.bilinear_sample, gather_cuda.GatherFn.apply):
        img = torch.from_numpy(image).requires_grad_()
        crd = torch.from_numpy(coords).requires_grad_()
        sampled, valid = fn(img, crd)
        d_image, d_coords = torch.autograd.grad(
            (sampled, valid), (img, crd),
            (torch.from_numpy(g_sampled), torch.from_numpy(g_valid)))
        # Sums of 4 float32 products in another order: 1e-5.
        np.testing.assert_allclose(d_image.numpy(), d_image_ref, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(d_coords.numpy(), d_coords_ref, rtol=1e-5,
                                   atol=1e-5)

    d_coords = gather_cuda.gather_bwd_coords(
        torch.from_numpy(image), torch.from_numpy(coords),
        torch.from_numpy(g_sampled), torch.from_numpy(g_valid))
    np.testing.assert_allclose(d_coords.numpy(), d_coords_ref, rtol=1e-5,
                               atol=1e-5)


def test_gather_fn_computes_only_the_grads_asked_for(rng):
    image, coords = gather_case(rng, "random")
    crd = torch.from_numpy(coords).requires_grad_()
    sampled, valid = gather_cuda.GatherFn.apply(torch.from_numpy(image), crd)
    (sampled.sum() + valid.sum()).backward()
    assert crd.grad is not None and torch.isfinite(crd.grad).all()


def test_gather_wrappers_take_plain_version_on_cpu(rng):
    image, coords = (torch.from_numpy(a) for a in gather_case(rng, "border"))
    before = (gather_cuda.gather_fwd.launches,
              gather_cuda.gather_bwd_coords.launches)
    sampled, valid = gather_cuda.gather_fwd(image, coords)
    ref = tgather.bilinear_sample(image, coords)
    assert torch.equal(sampled, ref[0]) and torch.equal(valid, ref[1])
    g = torch.ones_like(sampled)
    d = gather_cuda.gather_bwd_coords(image, coords, g, torch.ones_like(valid))
    assert d.shape == coords.shape
    assert (gather_cuda.gather_fwd.launches,
            gather_cuda.gather_bwd_coords.launches) == before


def test_gather_wrappers_reject_bad_inputs_and_grad(rng):
    image, coords = (torch.from_numpy(a) for a in gather_case(rng, "random"))
    with pytest.raises(RuntimeError, match="autograd"):
        gather_cuda.gather_fwd(image.clone().requires_grad_(), coords)
    with torch.no_grad():  # no graph is recorded: allowed
        gather_cuda.gather_fwd(image.clone().requires_grad_(), coords)
    bad = {
        "dtype": (image.double(), coords),
        "coords_shape": (image, coords[..., :1].contiguous()),
        "batch": (image[:1], coords),
        "channels": (image.repeat(1, 1, 1, 3), coords),
        "non_contiguous": (image.transpose(1, 2), coords),
    }
    for case, args in bad.items():
        with pytest.raises((ValueError, TypeError)):
            gather_cuda.gather_fwd(*args)


# ------------------------------------------------- per-layer inverse warp

def three_layer_case(rng, b=2, h=16, w=24):
    tex = rng.uniform(size=(b, 3, h, w, 3)).astype(np.float32)
    d0 = rng.uniform(0.3, 0.5, (b, 1, h, w, 1))
    disp = np.concatenate([d0, 0.6 * d0, 0.3 * d0], 1).astype(np.float32)
    K = np.tile(np.array([[30.0, 0, (w - 1) / 2], [0, 30.0, (h - 1) / 2],
                          [0, 0, 1]], np.float32)[None], (b, 1, 1))
    pose = np.array(jtf.pose_from_euler(
        np.array([[0.01, -0.02, 0.0], [0.0, 0.03, 0.01]], np.float32),
        np.array([[-0.3, 0.02, 0.0], [0.25, 0.0, -0.05]], np.float32)))
    target = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    return tex, disp, K, pose, target


def test_gather_target_per_layer_matches_jax_with_grads(rng):
    """Values, then the VJP into the LDI's disparities (through the
    projection and the gather) and the target image, against JAX. The
    translation pushes parts of every layer off the image, so the valid
    mass and its gradient matter."""
    tex, disp, K, pose, target = three_layer_case(rng)
    g = [rng.normal(size=s).astype(np.float32)
         for s in ((2, 3, 16, 24, 3), (2, 3, 16, 24, 1), (2, 3, 16, 24, 1))]

    def jfn(d, trg):
        return j_gather_layers(JLDI(textures=jnp.asarray(tex), disparities=d,
                                    intrinsics=jnp.asarray(K)),
                               trg, jnp.asarray(pose))

    j_out, f = jax.vjp(jax.jit(jfn), jnp.asarray(disp), jnp.asarray(target))
    j_dd, j_dt = f(tuple(jnp.asarray(x) for x in g))

    d = torch.from_numpy(disp).requires_grad_()
    trg = torch.from_numpy(target).requires_grad_()
    out = gather_target_per_layer(LDI(torch.from_numpy(tex), d,
                                      torch.from_numpy(K)),
                                  trg, torch.from_numpy(pose))
    valid = out[1].detach().numpy()
    assert 0.05 < (valid < 1).mean() < 0.95  # part of the mass off-image
    # Coordinates agree to ~1e-5 px (3x3 algebra in another order).
    for got, want in zip(out, j_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    dd, dt = torch.autograd.grad(out, (d, trg),
                                 tuple(torch.from_numpy(x) for x in g))
    # The disparity gradient scales with fx * |t| / z^2 (~30 px per unit
    # disparity): 1e-4 of its largest entry.
    np.testing.assert_allclose(dd.numpy(), np.asarray(j_dd), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(j_dd)).max())
    np.testing.assert_allclose(dt.numpy(), np.asarray(j_dt), rtol=1e-4,
                               atol=1e-4)

    folded = gather_target_per_layer_folded(
        LDI(torch.from_numpy(tex), torch.from_numpy(disp),
            torch.from_numpy(K)), torch.from_numpy(target),
        torch.from_numpy(pose))
    for got, want in zip(folded, out):
        assert torch.equal(got, want.detach().reshape(got.shape))
