"""The port's CUDA kernels on the card: K1 (forward splat), the splat VJP
(K2 + K3) and the bilinear gather (K4) against their plain versions, their
launch counts, the render and golden fixture on CUDA, K1 at the layer-0
render's shape and the no-grad disocclusion render, one train step of
each kind (single and two predictions), the MPI baseline's plane warp
(GatherFn with the image's gradient, K1 unsnapped) at its shapes, the MPI
step and the candidate gathers, and the windowed modes of K1 (the box
kernel's window and the band kernel) and the splat VJP (the
height-sharded render's splat) against the plain windowed splat; K1
without weights (the gather's image gradient); the deterministic splat
K1-D (``render.splat_method="sort"``) against the plain sort splat on the
card and, bitwise, on the CPU, repeated and on a second stream, with its
launch count, its int32 limit and the sort render.

Every test needs a CUDA card (marker ``gpu``) and skips without one. The
file imports no JAX, so it also runs where JAX is not installed; there,
skip the JAX-only conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses
import os

import numpy as np
import pytest
import torch

from lsi_tpu_torch.api import LSIModel
from lsi_tpu_torch.config import get_config
from lsi_tpu_torch.config import RenderConfig
from lsi_tpu_torch.data.pipeline import Batch, batch_stream
from lsi_tpu_torch.evaluation.occlusion import disocclusion_mask
from lsi_tpu_torch.geometry.ldi import LDI, render_forward
from lsi_tpu_torch.losses.losses import (depth_consistency,
                                         view_synthesis_inverse_warp)
from lsi_tpu_torch.models.mpi import MPI, plane_depths, render_mpi
from lsi_tpu_torch.geometry.transforms import pose_from_euler
from lsi_tpu_torch.kernels import build, gather_cuda, splat_cuda
from lsi_tpu_torch.ops.gather import bilinear_sample
from lsi_tpu_torch.ops.splat import splat_bilinear
from lsi_tpu_torch.train.trainer import create_state, make_train_step

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_toy.npz")
# The kernel wrappers, each with its launch count.
KERNELS = (splat_cuda.splat, splat_cuda.splat_vjp, gather_cuda.gather_fwd,
           gather_cuda.gather_bwd_coords)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def splat_inputs(seed, n, hs, ws, c, out_hw, kind):
    rng = np.random.default_rng(seed)
    ho, wo = out_hw
    values = rng.uniform(size=(n, hs, ws, c)).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (n, hs, ws, 1)).astype(np.float32)
    x = np.broadcast_to(np.arange(ws, dtype=np.float32), (n, hs, ws)).copy()
    y = np.broadcast_to((np.arange(hs, dtype=np.float32) % ho)[:, None],
                        (n, hs, ws)).copy()
    if kind == "integer":
        x += 2.0
    else:
        x += rng.uniform(-6, 6, (n, hs, ws)).astype(np.float32)
        y += rng.uniform(-2, 2, (n, hs, ws)).astype(np.float32)
    if kind == "huge":
        x[rng.uniform(size=(n, hs, ws)) < 0.1] = 1e6
        y[rng.uniform(size=(n, hs, ws)) < 0.1] = -1e6
        x[0, 0, :3] = [np.nan, np.inf, -np.inf]
    coords = np.stack([x, y], -1)
    return values, coords, weights


@pytest.mark.parametrize("c", [1, 3, 4, 8])
@pytest.mark.parametrize("kind", ["random", "integer", "huge"])
def test_kernel_matches_plain(cuda, kind, c):
    out_hw = (16, 128)
    args = [torch.from_numpy(a).to(cuda)
            for a in splat_inputs(0, 2, 32, 128, c, out_hw, kind)]
    acc, ws = splat_cuda.splat(*args, out_hw)
    ref = splat_bilinear(*args, out_hw)
    torch.cuda.synchronize()
    # float32 atomics sum in another order: 1e-5.
    torch.testing.assert_close(acc, ref[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ws, ref[1], rtol=1e-5, atol=1e-5)


# The coordinate kinds the tiled kernels must handle: targets that stay
# near the source (a render), random +-40 px shifts, a vertical spread of
# more than 200 rows (a tile's box overflows shared memory: the global
# path), every corner off the image, and +-1e6 / inf / nan.
COORD_KINDS = ["coherent", "random40", "overflow", "off_image", "nonfinite"]
# (N, Hs, Ws) sources folding two layers of (Ho, Wo) targets; ragged sizes.
SIZES = {"ragged": (2, 26, 77, (13, 77)), "even": (2, 64, 192, (32, 192))}


def tiled_coords(rng, n, hs, ws, out_hw, kind):
    """(n, hs, ws, 2) coordinates into an out_hw image, of one kind."""
    ho, wo = out_hw
    x = (np.arange(ws, dtype=np.float32)[None, None, :]
         + np.zeros((n, hs, 1), np.float32))
    y = (np.arange(hs, dtype=np.float32) % ho)[None, :, None] + 0 * x
    if kind == "coherent":
        x += 3.0 + rng.uniform(-0.6, 0.6, x.shape)
        y += rng.uniform(-0.6, 0.6, y.shape)
    elif kind == "random40":
        x += rng.uniform(-40, 40, x.shape)
        y += rng.uniform(-3, 3, y.shape)
    elif kind == "overflow":
        y = rng.uniform(-1, ho, y.shape)
        x += rng.uniform(-2, 2, x.shape)
    elif kind == "off_image":
        x += np.where(rng.uniform(size=x.shape) < 0.5, -wo - 5.0, wo + 5.0)
    else:
        x += rng.uniform(-2, 2, x.shape)
        y += rng.uniform(-2, 2, y.shape)
        x[rng.uniform(size=x.shape) < 0.1] = 1e6
        y[rng.uniform(size=y.shape) < 0.1] = -1e6
        x[:, 0, :3] = [np.nan, np.inf, -np.inf]
        y[:, 1, :2] = [np.nan, np.inf]
    return np.stack([x, y], -1).astype(np.float32)


def splat_case(seed, c, size, kind):
    n, hs, ws, out_hw = SIZES[size]
    if kind == "overflow":
        out_hw = (260, ws)
    rng = np.random.default_rng(seed)
    values = rng.uniform(size=(n, hs, ws, c)).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (n, hs, ws, 1)).astype(np.float32)
    return (values, tiled_coords(rng, n, hs, ws, out_hw, kind), weights,
            out_hw)


def assert_splat_close(got, ref):
    """K1's tolerance: rtol 1e-5, atol 1e-5 * max|ref| (float32 atomics
    sum in another order)."""
    for g, r in zip(got, ref):
        atol = 1e-5 * max(float(r.abs().max()), 1e-30)
        torch.testing.assert_close(g, r, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("kind", COORD_KINDS)
@pytest.mark.parametrize("snap", [True, False])
@pytest.mark.parametrize("c", range(1, 9))
def test_tiled_splat_matches_plain(cuda, c, snap, kind, size):
    """K1 (shared-memory and global paths) against the plain splat."""
    *arrays, out_hw = splat_case(10 + c, c, size, kind)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    got = splat_cuda.splat(*args, out_hw, snap=snap)
    ref = splat_bilinear(*args, out_hw, snap=snap)
    torch.cuda.synchronize()
    assert_splat_close(got, ref)
    if kind == "off_image":
        assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("tiling", [
    dict(smem_bytes=0),             # every block on the global path
    dict(smem_bytes=200 * 1024),    # above 48 KB: the opt-in attribute
    dict(block_x=32, rows_per_thread=2),
    dict(block_x=128),
    dict(block_x=256, rows_per_thread=3),
])
@pytest.mark.parametrize("c", [3, 4])
def test_splat_tilings_agree(cuda, c, tiling):
    """Every launch shape the wrapper can choose gives the same splat,
    with and without the float4 path."""
    *arrays, out_hw = splat_case(20, c, "ragged", "random40")
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    ref = splat_bilinear(*args, out_hw)
    for aligned16 in (True, False):
        t = splat_cuda.splat_tiling(args[0].shape, out_hw,
                                    aligned16=aligned16, **tiling)
        got = splat_cuda._launch_splat(*args, out_hw, True, t)
        torch.cuda.synchronize()
        assert_splat_close(got, ref)


def test_splat_takes_misaligned_views(cuda):
    *arrays, out_hw = splat_case(21, 4, "ragged", "coherent")
    values, coords, weights = (torch.from_numpy(a).to(cuda) for a in arrays)
    flat = torch.empty(coords.numel() + 1, device=cuda)
    shifted = flat[1:].view(coords.shape)  # 4 bytes off an 8-byte boundary
    shifted.copy_(coords)
    vflat = torch.empty(values.numel() + 1, device=cuda)
    vshifted = vflat[1:].view(values.shape)
    vshifted.copy_(values)
    got = splat_cuda.splat(vshifted, shifted, weights, out_hw)
    ref = splat_bilinear(values, coords, weights, out_hw)
    torch.cuda.synchronize()
    assert_splat_close(got, ref)


def test_kernel_counts_launches_and_rejects_bad_inputs(cuda):
    args = [torch.from_numpy(a).to(cuda)
            for a in splat_inputs(1, 1, 16, 128, 4, (16, 128), "random")]
    before = splat_cuda.splat.launches
    splat_cuda.splat(*args, (16, 128))
    assert splat_cuda.splat.launches == before + 1
    with pytest.raises(ValueError):
        splat_cuda.splat(args[0].transpose(1, 2), args[1], args[2], (16, 128))
    with pytest.raises(ValueError):
        splat_cuda.splat(args[0], args[1].cpu(), args[2], (16, 128))
    assert splat_cuda.splat.launches == before + 1


def test_render_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(2)
    b, l, h, w = 2, 2, 24, 64
    tex = torch.from_numpy(rng.uniform(size=(b, l, h, w, 3)).astype(np.float32))
    disp = torch.from_numpy(np.sort(rng.uniform(0.05, 0.6, (b, l, h, w, 1)),
                                    axis=1)[:, ::-1].astype(np.float32).copy())
    K = torch.tensor([[50.0, 0, 31.5], [0, 50.0, 11.5], [0, 0, 1]]).expand(
        b, 3, 3).contiguous()
    pose = pose_from_euler([[0.0, 0.03, 0.0]] * b, [[-0.2, 0.0, 0.0]] * b)
    ref = render_forward(LDI(tex, disp, K), pose)
    got = render_forward(LDI(tex.to(cuda), disp.to(cuda), K.to(cuda)),
                         pose.to(cuda))
    # Same float32 math; atomics and the GPU's fused multiply-adds round
    # differently (see the golden tolerance in chip_smoke.py).
    for k in ("rgb", "disparity"):
        torch.testing.assert_close(got[k].cpu(), ref[k], rtol=0, atol=1e-3)
    torch.testing.assert_close(got["coverage"].cpu(), ref["coverage"],
                               rtol=1e-3, atol=1e-5)


def test_golden_fixture_on_cuda(cuda):
    """JAX's outputs (CPU, float32) reproduced on the card, TF32 off."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = LSIModel.load(GOLDEN, device=cuda)
        with np.load(GOLDEN) as g:
            gold = {k: torch.from_numpy(g[k]).to(cuda)
                    for k in g.files if not k.startswith(("params/", "__"))}
        ldi = model.predict_ldi(gold["image"], gold["intrinsics"])
        with torch.inference_mode():
            out = render_forward(ldi, gold["pose"], zbuffer_scale=50.0)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    torch.testing.assert_close(ldi.textures, gold["ldi_textures"], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(ldi.disparities, gold["ldi_disparities"],
                               rtol=0, atol=1e-4)
    for k in ("rgb", "disparity"):
        torch.testing.assert_close(out[k], gold[k], rtol=0, atol=1e-3)
    torch.testing.assert_close(out["coverage"], gold["coverage"], rtol=1e-3,
                               atol=1e-5)


# --------------------------------------------- K2/K3 (splat VJP) and K4

def gather_inputs(seed, n, hi, wi, c, hs, ws):
    """Image and render-like coordinates that cross every border, with
    +-1e6 outliers."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(n, hi, wi, c)).astype(np.float32)
    x = (np.arange(ws, dtype=np.float32)[None, None, :]
         + rng.uniform(-6, 6, (n, hs, ws)).astype(np.float32))
    y = ((np.arange(hs, dtype=np.float32) % hi)[None, :, None]
         + rng.uniform(-2, 2, (n, hs, ws)).astype(np.float32))
    x[rng.uniform(size=x.shape) < 0.05] = 1e6
    y[rng.uniform(size=y.shape) < 0.05] = -1e6
    return image, np.stack([x, y], -1)


def cotangents_like(seed, *tensors):
    gen = torch.Generator(device=tensors[0].device).manual_seed(seed)
    return [torch.randn(t.shape, generator=gen, device=t.device)
            for t in tensors]


@pytest.mark.parametrize("c", [1, 3, 4, 8])
@pytest.mark.parametrize("kind", ["random", "integer", "huge"])
def test_splat_fn_backward_matches_plain(cuda, kind, c):
    """SplatFn (K1 forward, lsi_splat_vjp backward) against autograd
    through the plain splat, for each input's gradient."""
    out_hw = (16, 128)
    arrays = splat_inputs(3, 2, 32, 128, c, out_hw, kind)
    if kind == "random":  # some fractions inside the snap zones
        arrays[1][0, :4, :, 0] = np.round(arrays[1][0, :4, :, 0]) + 5e-5
    # Non-finite coordinates: the plain gradient is nan there (nan * 0),
    # the kernel's 0; both drop the pixel in the forward. Compare finite.
    arrays[1][~np.isfinite(arrays[1])] = 1e6
    grads = []
    for fn in (splat_cuda.SplatFn.apply, splat_bilinear):
        ins = [torch.from_numpy(a).to(cuda).requires_grad_() for a in arrays]
        outs = fn(*ins, out_hw)
        cots = cotangents_like(7, *outs)
        grads.append(torch.autograd.grad(outs, ins, cots))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        # Sums of 4 corner terms in another order: 1e-5 of the largest.
        atol = 1e-5 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


def test_splat_vjp_is_bitwise_repeatable_and_counts(cuda):
    args = [torch.from_numpy(a).to(cuda)
            for a in splat_inputs(4, 2, 32, 128, 4, (16, 128), "huge")]
    cots = cotangents_like(8, torch.empty(2, 16, 128, 4, device=cuda),
                           torch.empty(2, 16, 128, 1, device=cuda))
    before = splat_cuda.splat_vjp.launches
    a = splat_cuda.splat_vjp(*args, *cots, (16, 128))
    b = splat_cuda.splat_vjp(*args, *cots, (16, 128))
    assert splat_cuda.splat_vjp.launches == before + 2
    for x, y in zip(a, b):  # a gather with no atomics
        assert torch.equal(x, y)
    # The nan/inf coordinates at [0, 0, :3] drop their pixels: no gradient.
    for x in a:
        assert float(x[0, 0, :3].abs().max()) == 0.0
    with pytest.raises(RuntimeError, match="autograd"):
        splat_cuda.splat(args[0].requires_grad_(), *args[1:], (16, 128))


@pytest.mark.parametrize("c", [1, 3, 8])
def test_gather_fn_matches_plain(cuda, c):
    """GatherFn (lsi_gather_fwd; lsi_gather_bwd_coords and the unsnapped K1
    for the image) against autograd through the plain gather, with a
    non-zero cotangent on ``valid``."""
    image, coords = gather_inputs(5, 2, 16, 128, c, 48, 128)
    results = []
    for fn in (gather_cuda.GatherFn.apply, bilinear_sample):
        img = torch.from_numpy(image).to(cuda).requires_grad_()
        crd = torch.from_numpy(coords).to(cuda).requires_grad_()
        outs = fn(img, crd)
        cots = cotangents_like(9, *outs)
        results.append((outs, torch.autograd.grad(outs, (img, crd), cots)))
    torch.cuda.synchronize()
    (outs, grads), (ref_outs, ref_grads) = results
    for got, want in zip(outs, ref_outs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for got, want in zip(grads, ref_grads):
        # d_image sums float32 atomics; d_coords 4 corner terms: 1e-5.
        atol = 1e-5 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


def gather_case(seed, c, size, kind):
    """A (n, Ho, Wo, c) image and coordinates of ``kind`` folding two
    layers of it (the inverse warp's layout)."""
    n, hs, ws, (hi, wi) = SIZES[size]
    if kind == "overflow":
        hi, hs = 260, 520
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(n, hi, wi, c)).astype(np.float32)
    return image, tiled_coords(rng, n, hs, ws, (hi, wi), kind)


def assert_gather_close(got, ref, coords):
    """sampled/valid at 1e-5 / 1e-6; where a coordinate is not finite the
    plain gather gives nan (nan * 0), the kernel drops the pixel: 0."""
    finite = torch.isfinite(coords).all(-1, keepdim=True)
    for g, r in zip(got, ref):
        torch.testing.assert_close(torch.where(finite, g, 0.0),
                                   torch.where(finite, r, 0.0), rtol=1e-5,
                                   atol=1e-6)
        assert float(torch.where(finite, 0.0, g).abs().max()) == 0.0


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("kind", COORD_KINDS)
@pytest.mark.parametrize("c", range(1, 9))
def test_tiled_gather_matches_plain(cuda, c, kind, size):
    """lsi_gather_fwd against the plain gather."""
    image, coords = (torch.from_numpy(a).to(cuda)
                     for a in gather_case(30 + c, c, size, kind))
    got = gather_cuda.gather_fwd(image, coords)
    ref = bilinear_sample(image, coords)
    torch.cuda.synchronize()
    assert_gather_close(got, ref, coords)


@pytest.mark.parametrize("rows", [1, 2, 3])
@pytest.mark.parametrize("kind", COORD_KINDS)
def test_gather_tilings_are_bitwise_equal(cuda, kind, rows):
    """Any rows per block: the same arithmetic in the same order."""
    image, coords = (torch.from_numpy(a).to(cuda)
                     for a in gather_case(40, 3, "even", kind))
    ref = gather_cuda.gather_fwd(image, coords)
    t = gather_cuda.gather_tiling(image.shape, coords.shape,
                                  max_tile_rows=rows)
    got = gather_cuda._launch_gather_fwd(image, coords, t)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_gather_bwd_coords_is_bitwise_repeatable(cuda):
    image, coords = (torch.from_numpy(a).to(cuda)
                     for a in gather_case(41, 3, "even", "nonfinite"))
    cots = cotangents_like(11, torch.empty(coords.shape[:-1] + (3,),
                                           device=cuda),
                           torch.empty(coords.shape[:-1] + (1,),
                                       device=cuda))
    first = gather_cuda.gather_bwd_coords(image, coords, *cots)
    second = gather_cuda.gather_bwd_coords(image, coords, *cots)
    assert torch.equal(first, second)  # a gather with no atomics
    assert torch.isfinite(first).all()


def test_gather_kernels_count_launches(cuda):
    image, coords = (torch.from_numpy(a).to(cuda)
                     for a in gather_inputs(6, 1, 16, 128, 3, 32, 128))
    before = (gather_cuda.gather_fwd.launches,
              gather_cuda.gather_bwd_coords.launches)
    sampled, valid = gather_cuda.gather_fwd(image, coords)
    g_valid = torch.ones_like(valid)
    d = gather_cuda.gather_bwd_coords(image, coords,
                                      torch.zeros_like(sampled), g_valid)
    assert (gather_cuda.gather_fwd.launches,
            gather_cuda.gather_bwd_coords.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert float(d.abs().max()) > 0  # the valid mass's own gradient
    with pytest.raises(RuntimeError, match="autograd"):
        gather_cuda.gather_fwd(image.requires_grad_(), coords)


def test_train_step_on_cuda_matches_cpu(cuda):
    """One toy step of kitti_ldi3_b16 on the card and on the CPU from the
    same params and batch: every kernel launched once, the same loss."""
    cfg = get_config("kitti_ldi3_b16")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, base_filters=8,
                                       num_scales=2, compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, dataset="synthetic", height=32,
                                 width=64, batch_size=2))
    batch = next(batch_stream(cfg.data, device="cpu"))
    metrics = {}
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            state = create_state(cfg, seed=0, device=dev)
            counts = [k.launches for k in KERNELS]
            b = Batch(**{f.name: getattr(batch, f.name).to(dev)
                         for f in dataclasses.fields(Batch)})
            _, metrics[str(dev)] = make_train_step(cfg)(state, b)
            launched = [k.launches - n for k, n in zip(KERNELS, counts)]
            assert launched == ([0] * 4 if dev == "cpu" else [1] * 4)
    finally:
        torch.backends.cudnn.allow_tf32 = old
    for k, v in metrics["cpu"].items():
        # float32 with TF32 off; grad_norm moves where a coordinate crosses
        # a pixel or snap-zone edge (tests/test_torch_train.py): 1e-3.
        np.testing.assert_allclose(float(metrics[str(cuda)][k]), float(v),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def test_k1_at_the_layer0_render_shape(cuda):
    """The disocclusion mask splats layer 0 alone: (8, 256, 768, 4) ->
    (256, 768) at the quality step's width, one source row per target
    row."""
    args = [torch.from_numpy(a).to(cuda) for a in splat_inputs(
        11, 8, 256, 768, 4, (256, 768), "random")]
    acc, ws = splat_cuda.splat(*args, (256, 768))
    ref = splat_bilinear(*args, (256, 768))
    torch.cuda.synchronize()
    for got, want in zip((acc, ws), ref):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def layered_scene(dev, b=2, h=24, w=64):
    """An L=3 LDI with a foreground block in layer 0 (so splatting layer 0
    leaves a disoccluded band) and a target prediction, both requiring
    grad, and a pose."""
    rng = np.random.default_rng(12)
    ldis = []
    for _ in range(2):
        tex = rng.uniform(size=(b, 3, h, w, 3)).astype(np.float32)
        d0 = rng.uniform(0.25, 0.35, (b, 1, h, w, 1))
        d0[:, :, 6:18, 20:44] += 0.3
        disp = np.concatenate([d0, 0.5 * d0, 0.15 * d0], 1).astype(
            np.float32)
        K = np.tile(np.array([[50.0, 0, (w - 1) / 2], [0, 50.0, (h - 1) / 2],
                              [0, 0, 1]], np.float32), (b, 1, 1))
        ldis.append(LDI(*(torch.from_numpy(a).to(dev).requires_grad_(g)
                          for a, g in ((tex, True), (disp, True),
                                       (K, False)))))
    pose = pose_from_euler([[0.0, 0.02, 0.0]] * b, [[-0.3, 0.0, 0.0]] * b)
    return ldis[0], ldis[1], pose.to(dev)


def test_disocclusion_render_is_a_no_grad_k1_launch(cuda):
    """The mask's layer-0 render on tensors that require grad: one K1
    launch, no autograd node (the direct-call guard stays quiet), the CPU
    path's mask; and a disocc_only consistency backward launches the
    splat VJP once (the main render's), never for the mask."""
    src, trg, pose = layered_scene(cuda)
    counts = [k.launches for k in KERNELS]
    mask = disocclusion_mask(src, pose)
    assert [k.launches - n for k, n in zip(KERNELS, counts)] == [1, 0, 0, 0]
    assert mask.grad_fn is None
    src_cpu, _, pose_cpu = layered_scene("cpu")
    torch.testing.assert_close(mask.cpu(), disocclusion_mask(src_cpu,
                                                             pose_cpu))
    assert 0.0 < float(mask.mean()) < 0.5

    counts = [k.launches for k in KERNELS]
    loss = depth_consistency(src, trg, pose, RenderConfig(), stop_target=True,
                             disocc_only=True, deep_only=True)
    loss.backward()
    assert [k.launches - n for k, n in zip(KERNELS, counts)] == [2, 1, 0, 0]
    assert float(src.disparities.grad[:, 0].abs().max()) == 0.0
    assert float(src.disparities.grad[:, 1:].abs().max()) > 0.0


def test_two_prediction_step_on_cuda_matches_cpu(cuda):
    """One toy step of kitti_ldi3_quality on the card and on the CPU from
    the same params and batch: the launches of the table in PERF.md per
    full step (K1 6 full-LDI renders + 4 layer-0 renders, the VJP 6,
    each gather kernel 2), the same loss parts."""
    cfg = get_config("kitti_ldi3_quality")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, base_filters=8,
                                       num_scales=2, compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 synthetic_scene="multi", height=32,
                                 width=64, batch_size=2))
    batch = next(batch_stream(cfg.data, device="cpu"))
    metrics = {}
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            state = create_state(cfg, seed=0, device=dev)
            counts = [k.launches for k in KERNELS]
            b = Batch(**{f.name: getattr(batch, f.name).to(dev)
                         for f in dataclasses.fields(Batch)})
            _, metrics[str(dev)] = make_train_step(cfg)(state, b)
            launched = [k.launches - n for k, n in zip(KERNELS, counts)]
            assert launched == ([0] * 4 if dev == "cpu" else [10, 6, 2, 2])
    finally:
        torch.backends.cudnn.allow_tf32 = old
    for k, v in metrics["cpu"].items():
        # As the single-prediction step above: 1e-3.
        np.testing.assert_allclose(float(metrics[str(cuda)][k]), float(v),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


# ------------------------------------------- the MPI baseline, candidates

def plane_warp_inputs(seed, n, h, w):
    """MPI-like planes (RGBA) and homography coordinates: each plane
    shifted by its own disparity across, a little vertically, with
    borders crossed and some rows thrown ~1e6 px away (the denominator
    floor)."""
    rng = np.random.default_rng(seed)
    planes = rng.uniform(size=(n, h, w, 4)).astype(np.float32)
    planes[:, :4, :8, 3] = 0.0  # alphas exactly 0 and 1
    planes[:, 4:8, :8, 3] = 1.0
    shift = rng.uniform(-20, 20, (n, 1, 1)).astype(np.float32)
    x = (np.arange(w, dtype=np.float32)[None, None, :] + shift
         + rng.uniform(-0.5, 0.5, (n, h, w)).astype(np.float32))
    y = (np.arange(h, dtype=np.float32)[None, :, None]
         + rng.uniform(-1.5, 1.5, (n, h, w)).astype(np.float32))
    x[:, -2:] = 1e8
    return planes, np.stack([x, y], -1)


@pytest.mark.parametrize("n,h,w", [(16, 16, 64), (128, 128, 256)])
def test_plane_warp_image_grad_matches_plain(cuda, n, h, w):
    """GatherFn on planes that require grad (the MPI render's, folded
    B*D planes; (128, 128, 256) is mpi_baseline's b8 x 16 planes): the
    forward by lsi_gather_fwd, the image's gradient by K1 unsnapped, no
    coordinate gradient asked for; against autograd through the plain
    gather."""
    planes, coords = plane_warp_inputs(13, n, h, w)
    results = []
    for fn in (gather_cuda.GatherFn.apply, bilinear_sample):
        img = torch.from_numpy(planes).to(cuda).requires_grad_()
        crd = torch.from_numpy(coords).to(cuda)
        counts = [k.launches for k in KERNELS]
        outs = fn(img, crd)
        # ``valid`` does not depend on the image: only ``sampled``'s
        # cotangent reaches it.
        (grad,) = torch.autograd.grad(outs[0], img,
                                      cotangents_like(14, outs[0]))
        results.append((outs, grad,
                         [k.launches - c for k, c in zip(KERNELS, counts)]))
    torch.cuda.synchronize()
    (outs, grad, launched), (ref_outs, ref_grad, plain) = results
    assert launched == [1, 0, 1, 0] and plain == [0, 0, 0, 0]
    for got, want in zip(outs, ref_outs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # d_image sums K1's float32 atomics: 1e-5 of the largest.
    torch.testing.assert_close(grad, ref_grad, rtol=1e-4,
                               atol=1e-5 * float(ref_grad.abs().max()))


def toy_mpi(dev, b=2, d=4, h=16, w=32):
    rng = np.random.default_rng(15)
    colors = rng.uniform(size=(b, d, h, w, 3)).astype(np.float32)
    alphas = rng.uniform(0.05, 0.95, (b, d, h, w, 1)).astype(np.float32)
    alphas[:, :, 2:5, 3:9] = 0.0
    K = np.tile(np.array([[20.0, 0, w / 2], [0, 18.0, h / 2], [0, 0, 1]],
                         np.float32), (b, 1, 1))
    return MPI(torch.from_numpy(colors).to(dev).requires_grad_(),
               torch.from_numpy(alphas).to(dev).requires_grad_(),
               plane_depths(d, device=dev), torch.from_numpy(K).to(dev))


def test_render_mpi_on_cuda_matches_cpu(cuda):
    """render_mpi on the card (one gather launch for all planes, one K1
    launch for their gradient) against the CPU path: values and the VJP
    in the colours and alphas."""
    pose = pose_from_euler([[0.01, -0.02, 0.0]] * 2, [[-0.3, 0.05, 0.1]] * 2)
    results = []
    for dev in ("cpu", cuda):
        mpi = toy_mpi(dev)
        counts = [k.launches for k in KERNELS]
        out = render_mpi(mpi, pose.to(dev))
        outs = [out[k] for k in ("rgb", "alpha", "disparity")]
        cots = [c.to(dev) for c in cotangents_like(16, *[o.cpu()
                                                         for o in outs])]
        grads = torch.autograd.grad(outs, (mpi.colors, mpi.alphas), cots)
        results.append(([o.detach().cpu() for o in outs],
                        [g.cpu() for g in grads],
                        [k.launches - c for k, c in zip(KERNELS, counts)]))
    (outs, grads, plain), (c_outs, c_grads, launched) = results
    assert plain == [0, 0, 0, 0] and launched == [1, 0, 1, 0]
    for got, want in zip(c_outs, outs):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for got, want in zip(c_grads, grads):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def test_mpi_step_on_cuda_matches_cpu(cuda):
    """One toy step of mpi_baseline on the card and on the CPU from the
    same params and batch: one gather and one K1 launch, no splat VJP or
    coordinate gather, the same loss parts."""
    cfg = get_config("mpi_baseline")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_planes=4, base_filters=8,
                                       num_scales=2, compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, height=16, width=64,
                                 batch_size=2))
    batch = next(batch_stream(cfg.data, device="cpu"))
    metrics = {}
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            state = create_state(cfg, seed=0, device=dev)
            counts = [k.launches for k in KERNELS]
            b = Batch(**{f.name: getattr(batch, f.name).to(dev)
                         for f in dataclasses.fields(Batch)})
            _, metrics[str(dev)] = make_train_step(cfg)(state, b)
            launched = [k.launches - n for k, n in zip(KERNELS, counts)]
            assert launched == ([0] * 4 if dev == "cpu" else [1, 0, 1, 0])
    finally:
        torch.backends.cudnn.allow_tf32 = old
    for k, v in metrics["cpu"].items():
        np.testing.assert_allclose(float(metrics[str(cuda)][k]), float(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("radius", [1, 2])
def test_candidate_gathers_on_cuda_match_cpu(cuda, radius):
    """The inverse warp with candidate_radius r: one stacked gather (one
    launch of lsi_gather_fwd and of lsi_gather_bwd_coords), the loss and
    its gradients in the LDI against the CPU path."""
    results = []
    for dev in ("cpu", cuda):
        src, _, pose = layered_scene(dev)
        target = torch.from_numpy(np.random.default_rng(17).uniform(
            size=(2, 24, 64, 3)).astype(np.float32)).to(dev)
        counts = [k.launches for k in KERNELS]
        loss = view_synthesis_inverse_warp(src, target, pose,
                                           candidate_radius=radius)
        grads = torch.autograd.grad(loss, (src.textures, src.disparities))
        results.append((float(loss.detach()), [g.cpu() for g in grads],
                        [k.launches - c for k, c in zip(KERNELS, counts)]))
    (loss, grads, plain), (c_loss, c_grads, launched) = results
    assert plain == [0, 0, 0, 0] and launched == [0, 0, 1, 1]
    np.testing.assert_allclose(c_loss, loss, rtol=1e-5)
    for got, want in zip(c_grads, grads):
        # Where two candidates' errors lie within the devices' rounding
        # the min may pick another one (ROADMAP H10): in aggregate.
        assert float((got - want).norm()) <= 1e-3 * float(want.norm())


# ------------------------------------------------------- the dy window

def window_inputs(seed, n, layers, fold_h, ws, c, max_dy, base_offset,
                  kind):
    """Inputs of the windowed splat: rows within max_dy + 3 of each source
    row's base row ``r % fold_h + base_offset`` in a target of ``fold_h +
    2 base_offset`` rows, a third of them on integer rows (corners exactly
    on the window's edges); with ``kind="huge"`` also +-1e6, inf and nan
    coordinates (H9)."""
    rng = np.random.default_rng(seed)
    hs = layers * fold_h
    values = rng.uniform(size=(n, hs, ws, c)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, (n, hs, ws, 1)).astype(np.float32)
    base = np.arange(hs) % fold_h + base_offset
    x = np.arange(ws, dtype=np.float32)[None, None] + rng.uniform(
        -6, 6, (n, hs, ws))
    y = base[None, :, None] + rng.uniform(-max_dy - 3, max_dy + 3,
                                          (n, hs, ws))
    y[:, :, ::3] = np.round(y[:, :, ::3])
    if kind == "huge":
        x[rng.uniform(size=(n, hs, ws)) < 0.1] = 1e6
        y[rng.uniform(size=(n, hs, ws)) < 0.1] = -1e6
        x[0, 0, :3] = [np.nan, np.inf, -np.inf]
    coords = np.stack([x, y], -1).astype(np.float32)
    return values, coords, weights, (fold_h + 2 * base_offset, ws)


# (layers, fold_h, width): whole tiles, and ragged last tiles in both
# directions (K1's tile is 4 x 128 source pixels by default).
WINDOW_SHAPES = [(2, 16, 128), (3, 13, 130)]


@pytest.mark.parametrize("shape", WINDOW_SHAPES)
@pytest.mark.parametrize("max_dy, base_offset", [(0, 0), (1, 3), (2, 4)])
@pytest.mark.parametrize("kind", ["random", "huge"])
def test_windowed_splat_matches_plain(cuda, shape, max_dy, base_offset,
                                      kind):
    """K1 and lsi_splat_vjp with (max_dy, fold_h, base_offset) against the
    plain windowed splat and autograd through it (SplatFn both ways)."""
    layers, fold_h, ws = shape
    *arrays, out_hw = window_inputs(5, 2, layers, fold_h, ws, 4, max_dy,
                                    base_offset, kind)
    base = torch.arange(layers * fold_h, device=cuda) % fold_h + base_offset
    window = (max_dy, fold_h, base_offset)
    outs = []
    for on_card in (True, False):
        ins = [torch.from_numpy(a).to(cuda).requires_grad_() for a in arrays]
        if on_card:
            fwd = splat_cuda.SplatFn.apply(*ins, out_hw, *window)
        else:
            fwd = splat_bilinear(*ins, out_hw, max_dy_window=max_dy,
                                 base_rows=base)
        cots = cotangents_like(9, *fwd)
        outs.append((fwd, torch.autograd.grad(fwd, ins, cots)))
    torch.cuda.synchronize()
    (k_fwd, k_grad), (p_fwd, p_grad) = outs
    for got, want in zip(k_fwd, p_fwd):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    finite = torch.from_numpy(np.isfinite(arrays[1]).all(-1)).to(cuda)
    for got, want in zip(k_grad, p_grad):
        # The plain gradient is nan at non-finite coordinates (H11): the
        # kernel's is 0 there. Compare the finite pixels.
        atol = 1e-5 * float(want[finite].abs().max())
        torch.testing.assert_close(got[finite], want[finite], rtol=1e-4,
                                   atol=atol)
        if (~finite).any():
            assert float(got[~finite].abs().max()) == 0.0


def test_window_drops_corners_from_the_shared_box(cuda):
    """A block whose corners are all dropped by the window writes nothing
    (the dropped corners leave the block's bounding box too), and the
    unwindowed call on the same inputs is unchanged (max_dy = -1)."""
    fold_h, base_offset, ws = 8, 4, 128
    coords = torch.zeros(1, fold_h, ws, 2, device=cuda)
    coords[..., 0] = torch.arange(ws, device=cuda, dtype=torch.float32)
    # Every pixel 3 rows below its base: outside a window of 1.
    coords[..., 1] = (torch.arange(fold_h, device=cuda)[:, None]
                      + base_offset + 3).float()
    values = torch.ones(1, fold_h, ws, 4, device=cuda)
    weights = torch.ones(1, fold_h, ws, 1, device=cuda)
    out_hw = (fold_h + 2 * base_offset, ws)
    acc, wsum = splat_cuda.splat(values, coords, weights, out_hw, max_dy=1,
                                 fold_h=fold_h, base_offset=base_offset)
    assert float(acc.abs().max()) == 0.0 and float(wsum.abs().max()) == 0.0
    acc, wsum = splat_cuda.splat(values, coords, weights, out_hw, max_dy=2,
                                 fold_h=fold_h, base_offset=base_offset)
    assert float(wsum.sum()) == fold_h * ws
    want = splat_bilinear(values, coords, weights, out_hw)
    for got, w in zip(splat_cuda.splat(values, coords, weights, out_hw),
                      want):
        torch.testing.assert_close(got, w, rtol=1e-6, atol=1e-6)


def test_window_arguments_raise_before_a_launch(cuda):
    *arrays, out_hw = window_inputs(6, 1, 2, 8, 64, 4, 1, 3, "random")
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = splat_cuda.splat.launches
    with pytest.raises(ValueError, match="fold_h"):
        splat_cuda.splat(*args, out_hw, max_dy=1, fold_h=5, base_offset=3)
    with pytest.raises(ValueError, match="inside the target"):
        splat_cuda.splat(*args, out_hw, max_dy=1, fold_h=8, base_offset=7)
    assert splat_cuda.splat.launches == before


# ------------------------------------------ the band kernel (K1 windowed)

# (layers, fold_h, width, base_offset), coordinate kind: a whole number of
# warps across, a ragged width whose row bytes are no multiple of 16, and
# one layer of fold_h below the target's height.
BAND_SHAPES = [((2, 16, 128, 3), "huge"), ((3, 13, 77, 0), "random"),
               ((1, 40, 66, 5), "huge")]


def band_plain(values, coords, weights, out_hw, snap, window):
    max_dy, fold_h, base_offset = window
    base = (torch.arange(values.shape[1], device=values.device) % fold_h
            + base_offset)
    return splat_bilinear(values, coords, weights, out_hw, snap=snap,
                          max_dy_window=max_dy, base_rows=base)


def assert_band_close(got, ref):
    assert (got[1] is None) == (ref[1] is None)
    assert_splat_close([g for g in got if g is not None],
                       [r for r in ref if r is not None])


@pytest.mark.parametrize("max_dy", [0, 1, 2, 8, 16])
@pytest.mark.parametrize("snap", [True, False])
@pytest.mark.parametrize("c", range(1, 9))
def test_band_kernel_matches_plain(cuda, c, snap, max_dy):
    """The band kernel, with and without weights, against the plain
    windowed splat: base_offset > 0, fold_h below the target's height,
    ragged widths, +-1e6, inf and nan coordinates, a third of the rows on
    integer targets (corners exactly on the window's edges); also
    ``splat`` itself, which takes the band kernel or the box kernel as
    ``use_band`` says."""
    for (layers, fold_h, ws, bo), kind in BAND_SHAPES:
        *arrays, out_hw = window_inputs(100 + 10 * c + max_dy, 2, layers,
                                        fold_h, ws, c, max_dy, bo, kind)
        values, coords, weights = (torch.from_numpy(a).to(cuda)
                                   for a in arrays)
        window = (max_dy, fold_h, bo)
        for w in (weights, None):
            ref = band_plain(values, coords, w, out_hw, snap, window)
            before = splat_cuda.splat.band_launches
            got = splat_cuda.splat(values, coords, w, out_hw, snap=snap,
                                   max_dy=max_dy, fold_h=fold_h,
                                   base_offset=bo)
            torch.cuda.synchronize()
            assert splat_cuda.splat.band_launches - before == (
                splat_cuda.band_plan(values, out_hw, window, w) is not None)
            assert_band_close(got, ref)
            t = splat_cuda.band_tiling(values.shape, out_hw, window,
                                       weights=w is not None, aligned16=True)
            got = splat_cuda._launch_splat(values, coords, w, out_hw, snap,
                                           t, window)
            torch.cuda.synchronize()
            assert_band_close(got, ref)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("c", [3, 4])
def test_band_heights_agree(cuda, c, weighted):
    """Every band height gives the same splat: corners on the bands' edges
    go to exactly one band, at 1 row a band and at the whole target."""
    *arrays, out_hw = window_inputs(130 + c, 2, 3, 16, 96, c, 2, 3, "huge")
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    if not weighted:
        args[2] = None
    window = (2, 16, 3)
    ref = band_plain(*args, out_hw, True, window)
    for rows in (1, 2, 3, 5, 8, out_hw[0]):
        t = splat_cuda.band_tiling(args[0].shape, out_hw, window,
                                   weights=weighted, aligned16=True,
                                   rows=rows)
        got = splat_cuda._launch_splat(*args, out_hw, True, t, window)
        torch.cuda.synchronize()
        assert_band_close(got, ref)


def test_band_kernel_writes_every_pixel(cuda):
    """accum and wsum come from torch.empty: the band kernel writes every
    pixel, zeros included, and nothing a freed NaN block held survives;
    the launch counts as windowed and as the band kernel's."""
    *arrays, out_hw = window_inputs(140, 2, 2, 16, 128, 4, 1, 3, "random")
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    n, _, ws, c = args[0].shape
    for _ in range(4):  # the caching allocator hands these blocks out next
        torch.full((n, *out_hw, c), float("nan"), device=cuda)
        torch.full((n, *out_hw, 1), float("nan"), device=cuda)
    counters = ("launches", "window_launches", "band_launches")
    before = [getattr(splat_cuda.splat, k) for k in counters]
    window = (1, 16, 3)
    got = splat_cuda._launch_splat(*args, out_hw, True, splat_cuda.band_tiling(
        args[0].shape, out_hw, window), window)
    torch.cuda.synchronize()
    assert [getattr(splat_cuda.splat, k) - b
            for k, b in zip(counters, before)] == [1, 1, 1]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert_band_close(got, band_plain(*args, out_hw, True, (1, 16, 3)))
    assert float(got[1].abs().max()) > 0 and bool((got[1] == 0).any())


def test_band_kernel_takes_misaligned_views(cuda):
    """Coordinates 4 bytes off an 8-byte boundary are copied before their
    float2 loads; values 4 bytes off a 16-byte one take the scalar
    loads."""
    *arrays, out_hw = window_inputs(141, 2, 2, 16, 128, 4, 2, 3, "random")
    values, coords, weights = (torch.from_numpy(a).to(cuda) for a in arrays)
    flat = torch.empty(coords.numel() + 1, device=cuda)
    shifted = flat[1:].view(coords.shape)
    shifted.copy_(coords)
    vflat = torch.empty(values.numel() + 1, device=cuda)
    vshifted = vflat[1:].view(values.shape)
    vshifted.copy_(values)
    window = (2, 16, 3)
    ref = band_plain(values, coords, weights, out_hw, True, window)
    t = splat_cuda.band_tiling(values.shape, out_hw, window)
    got = splat_cuda._launch_splat(vshifted, shifted, weights, out_hw, True,
                                   t, window)
    torch.cuda.synchronize()
    assert_band_close(got, ref)


@pytest.mark.parametrize("snap", [True, False])
@pytest.mark.parametrize("c", range(1, 9))
def test_box_kernel_without_weights_matches_plain(cuda, c, snap):
    """The unwindowed K1 without weights (no wsum) on both of its paths
    (shared memory and global atomics) against the plain splat."""
    *arrays, out_hw = splat_case(150 + c, c, "ragged", "random40")
    values, coords, _ = (torch.from_numpy(a).to(cuda) for a in arrays)
    ref = splat_bilinear(values, coords, None, out_hw, snap=snap)
    for smem_bytes in (32 * 1024, 0):
        t = splat_cuda.splat_tiling(values.shape, out_hw, aligned16=True,
                                    smem_bytes=smem_bytes)
        got = splat_cuda._launch_splat(values, coords, None, out_hw, snap, t)
        torch.cuda.synchronize()
        assert_band_close(got, ref)


# ------------------------------------------ K4-W: the windowed, snapped gather

def windowed_gather_case(seed, c, layers, max_dy, n=2, hi=16, wi=96):
    """An image and coordinates folding ``layers`` layers of it, each row
    within +-(max_dy + 2) rows of its base row (the window drops corners),
    10% of the fractions in the snap zones, 2% at +-1e6."""
    rng = np.random.default_rng(seed)
    hs = layers * hi
    image = rng.uniform(size=(n, hi, wi, c)).astype(np.float32)
    x = np.arange(wi)[None, None, :] + rng.uniform(-6, 6, (n, hs, wi))
    y = ((np.arange(hs) % hi)[None, :, None]
         + rng.uniform(-(max_dy + 2), max_dy + 2, (n, hs, wi)))
    for a in (x, y):
        near = rng.uniform(size=a.shape) < 0.1
        a[near] = np.round(a[near]) + rng.choice([-3e-5, 3e-5], near.sum())
    x[rng.uniform(size=x.shape) < 0.02] = 1e6
    return image, np.stack([x, y], -1).astype(np.float32)


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("max_dy", [0, 2, 8])
@pytest.mark.parametrize("c", [1, 3, 4, 8])
def test_windowed_gather_fn_matches_plain(cuda, c, max_dy, layers):
    """GatherFn windowed (lsi_gather_fwd and lsi_gather_bwd_coords with
    max_dy >= 0, K1 snapped and windowed for the image) against autograd
    through the plain windowed gather on the card; the coordinate gradient
    exactly 0 in the snap zones."""
    image, coords = windowed_gather_case(50 + c, c, layers, max_dy)
    results = []
    for fn in (gather_cuda.GatherFn.apply,
               lambda i, x, m: bilinear_sample(i, x, max_dy=m)):
        img = torch.from_numpy(image).to(cuda).requires_grad_()
        crd = torch.from_numpy(coords).to(cuda).requires_grad_()
        outs = fn(img, crd, max_dy)
        cots = cotangents_like(12, *outs)
        results.append((outs, torch.autograd.grad(outs, (img, crd), cots)))
    torch.cuda.synchronize()
    (outs, grads), (ref_outs, ref_grads) = results
    for got, want in zip(outs, ref_outs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for got, want in zip(grads, ref_grads):
        atol = 1e-5 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)
    f = coords - np.floor(coords)
    zone = torch.from_numpy((f < 1e-4) | (f > 1 - 1e-4)).to(cuda)
    assert bool(zone.any())
    assert float(grads[1][zone].abs().max()) == 0.0


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_windowed_gather_tilings_are_bitwise_equal(cuda, rows):
    """The windowed forward under any rows per block: the base row is the
    row's own, so the results do not depend on the tiling."""
    image, coords = (torch.from_numpy(a).to(cuda)
                     for a in windowed_gather_case(60, 3, 3, 1))
    ref = gather_cuda.gather_fwd(image, coords, 1)
    t = gather_cuda.gather_tiling(image.shape, coords.shape,
                                  max_tile_rows=rows)
    got = gather_cuda._launch_gather_fwd(image, coords, t, window=(1, 16))
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_wide_window_equals_the_exact_gather_kernel(cuda):
    """Away from the snap zones, a window that drops nothing gives what
    the exact kernels give, forward and coordinate backward."""
    rng = np.random.default_rng(61)
    image = torch.from_numpy(rng.uniform(size=(2, 16, 96, 3)).astype(
        np.float32)).to(cuda)
    x = np.arange(96)[None, None, :] + rng.uniform(-6, 6, (2, 32, 96))
    y = (np.arange(32) % 16)[None, :, None] + rng.uniform(-1, 1, (2, 32, 96))
    coords = np.stack([x, y], -1)
    f = coords - np.floor(coords)
    coords = np.where((f < 1e-3) | (f > 1 - 1e-3), coords + 0.01, coords)
    coords = torch.from_numpy(coords.astype(np.float32)).to(cuda)
    wide = gather_cuda.gather_fwd(image, coords, 20)
    exact = gather_cuda.gather_fwd(image, coords)
    cots = cotangents_like(13, *exact)
    d_wide = gather_cuda.gather_bwd_coords(image, coords, *cots, 20)
    d_exact = gather_cuda.gather_bwd_coords(image, coords, *cots)
    torch.cuda.synchronize()
    for g, r in zip(wide + (d_wide,), exact + (d_exact,)):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)


def test_windowed_gather_kernels_count_and_refuse_bad_windows(cuda):
    """Windowed launches count in ``launches`` and ``window_launches``; a
    bad window raises ValueError in the wrapper, and the entry points
    themselves refuse one (cudaErrorInvalidValue) when called around the
    wrapper's check."""
    from lsi_tpu_torch.kernels import build
    image, coords = (torch.from_numpy(a).to(cuda)
                     for a in windowed_gather_case(62, 3, 2, 1))
    fwd, bwd = gather_cuda.gather_fwd, gather_cuda.gather_bwd_coords
    before = (fwd.launches, fwd.window_launches, bwd.launches,
              bwd.window_launches)
    s, v = fwd(image, coords, 1)
    bwd(image, coords, torch.ones_like(s), torch.ones_like(v), 1)
    fwd(image, coords)
    assert (fwd.launches, fwd.window_launches, bwd.launches,
            bwd.window_launches) == (before[0] + 2, before[1] + 1,
                                     before[2] + 1, before[3] + 1)
    with pytest.raises(ValueError):
        fwd(image, coords, 1, 5)
    n, hs, ws, _ = coords.shape
    with pytest.raises(RuntimeError, match="cudaError"):
        build.launch("splat_bwd", "lsi_gather_fwd", cuda, image.data_ptr(),
                     coords.data_ptr(), s.data_ptr(), v.data_ptr(), n, hs,
                     ws, 3, 16, 96, hs, 1, 1, 1, 5)
    with pytest.raises(RuntimeError, match="cudaError"):
        build.launch("splat_bwd", "lsi_gather_bwd_coords", cuda,
                     image.data_ptr(), coords.data_ptr(), s.data_ptr(),
                     v.data_ptr(), torch.empty_like(coords).data_ptr(), n,
                     hs, ws, 3, 16, 96, 1, 64)


def test_route_on_cuda_matches_cpu(cuda):
    """A toy kitti_ldi3_b16 step on the route (render.use_pallas="on") on
    the card and on the CPU from the same params and batch: every kernel
    launched once, windowed, and the same loss parts and
    window_dropped_frac."""
    cfg = get_config("kitti_ldi3_b16")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, base_filters=8,
                                       num_scales=2, compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 synthetic_scene="multi", height=32,
                                 width=64, batch_size=2),
        render=dataclasses.replace(cfg.render, use_pallas="on",
                                   pallas_max_dy=0))
    batch = next(batch_stream(cfg.data, device="cpu"))
    metrics = {}
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            state = create_state(cfg, seed=0, device=dev)
            counts = [(k.launches, k.window_launches) for k in KERNELS]
            b = Batch(**{f.name: getattr(batch, f.name).to(dev)
                         for f in dataclasses.fields(Batch)})
            _, metrics[str(dev)] = make_train_step(cfg)(state, b)
            launched = [(k.launches - n, k.window_launches - m)
                        for k, (n, m) in zip(KERNELS, counts)]
            assert launched == ([(0, 0)] * 4 if dev == "cpu"
                                else [(1, 1)] * 4)
    finally:
        torch.backends.cudnn.allow_tf32 = old
    assert float(metrics["cpu"]["window_dropped_frac"]) > 0
    for k, v in metrics["cpu"].items():
        np.testing.assert_allclose(float(metrics[str(cuda)][k]), float(v),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


# ------------------------------------------ the deterministic splat (K1-D)

def sort_plain(values, coords, weights, out_hw, snap, window, device):
    """The plain sort splat on ``device``: on the CPU its sums run in the
    sorted order, K1-D's order."""
    args = [None if t is None else t.to(device)
            for t in (values, coords, weights)]
    base = None
    if window[0] >= 0:
        base = (torch.arange(values.shape[1], device=device) % window[1]
                + window[2])
    return splat_bilinear(*args, out_hw, snap=snap,
                          max_dy_window=None if base is None else window[0],
                          base_rows=base, method="sort")


def sort_case(seed, c, kind, window):
    """K1-D's inputs: SIZES' ragged shape unwindowed, or
    :func:`window_inputs` (base offsets, integer rows, +-1e6, inf, nan)."""
    if window[0] < 0:
        *arrays, out_hw = splat_case(seed, c, "ragged", kind)
    else:
        max_dy, fold_h, bo = window
        *arrays, out_hw = window_inputs(seed, 2, 2, fold_h, 77, c, max_dy,
                                        bo, "huge" if kind == "nonfinite"
                                        else "random")
    return arrays, out_hw


SORT_WINDOWS = [(-1, 1, 0), (0, 13, 0), (2, 13, 3)]


@pytest.mark.parametrize("window", SORT_WINDOWS)
@pytest.mark.parametrize("kind", ["random40", "nonfinite"])
@pytest.mark.parametrize("snap", [True, False])
@pytest.mark.parametrize("c", range(1, 9))
def test_sort_kernel_matches_plain(cuda, c, snap, kind, window):
    """K1-D, with and without weights, against the plain sort splat on the
    card (1e-5, its index_add_ sums in another order) and on the CPU,
    whose sums run in K1-D's order: bitwise, but where a sum is denormal
    (K1-D flushes it, H12); and against K1, the same function."""
    arrays, out_hw = sort_case(200 + c, c, kind, window)
    values, coords, weights = (torch.from_numpy(a).to(cuda) for a in arrays)
    kw = dict(snap=snap, max_dy=window[0], fold_h=window[1],
              base_offset=window[2])
    for w in (weights, None):
        got = splat_cuda.splat(values, coords, w, out_hw, deterministic=True,
                               **kw)
        torch.cuda.synchronize()
        assert (got[1] is None) == (w is None)
        got = [g for g in got if g is not None]
        on_card = sort_plain(values, coords, w, out_hw, snap, window, cuda)
        assert_splat_close(got, [r for r in on_card if r is not None])
        k1 = splat_cuda.splat(values, coords, w, out_hw, **kw)
        assert_splat_close(got, [r for r in k1 if r is not None])
        on_cpu = sort_plain(values, coords, w, out_hw, snap, window, "cpu")
        for g, r in zip(got, on_cpu):
            r = r.to(cuda)
            tiny = (r != 0) & (r.abs() < torch.finfo(torch.float32).tiny)
            assert torch.equal(g[~tiny], r[~tiny])
            assert not g[tiny].abs().any()


def test_sort_kernel_is_bitwise_repeatable_across_streams(cuda):
    """Launches on the default stream and on a second stream: bitwise
    equal (K1's atomics are not: H8)."""
    arrays, out_hw = sort_case(210, 4, "random40", (-1, 1, 0))
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    first = splat_cuda.splat(*args, out_hw, deterministic=True)
    again = [splat_cuda.splat(*args, out_hw, deterministic=True)
             for _ in range(3)]
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        other = splat_cuda.splat(*args, out_hw, deterministic=True)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    for out in again + [other]:
        assert all(torch.equal(a, b) for a, b in zip(first, out))


def test_sort_kernel_writes_every_pixel(cuda):
    """accum and wsum come from torch.empty: K1-D writes every pixel, the
    uncovered ones 0, and nothing a freed NaN block held survives."""
    arrays, out_hw = sort_case(211, 4, "random40", (2, 13, 3))
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    n, _, _, c = args[0].shape
    for _ in range(4):  # the caching allocator hands these blocks out next
        torch.full((n, *out_hw, c), float("nan"), device=cuda)
        torch.full((n, *out_hw, 1), float("nan"), device=cuda)
    got = splat_cuda.splat(*args, out_hw, max_dy=2, fold_h=13,
                           base_offset=3, deterministic=True)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert bool((got[1] == 0).any()) and float(got[1].abs().max()) > 0


def test_sort_kernel_counts_launches_and_refuses_int32_overflow(cuda):
    """One K1-D launch counts in splat.sort_launches alone (not in K1's
    counters), SplatFn's deterministic backward is one lsi_splat_vjp; a
    splat whose keys would not fit int32 raises ValueError before any
    launch, and the C entry points refuse such sizes themselves."""
    arrays, out_hw = sort_case(212, 3, "random40", (-1, 1, 0))
    ins = [torch.from_numpy(a).to(cuda).requires_grad_() for a in arrays]
    counters = ("launches", "window_launches", "band_launches",
                "sort_launches")
    before = [getattr(splat_cuda.splat, k) for k in counters]
    vjp_before = splat_cuda.splat_vjp.launches
    out = splat_cuda.SplatFn.apply(*ins, out_hw, -1, None, 0, True)
    torch.autograd.grad(out, ins, cotangents_like(13, *out))
    torch.cuda.synchronize()
    assert [getattr(splat_cuda.splat, k) - b
            for k, b in zip(counters, before)] == [0, 0, 0, 1]
    assert splat_cuda.splat_vjp.launches - vjp_before == 1
    with pytest.raises(ValueError):
        splat_cuda.check_sort_sizes((384, 1024, 1536, 4), (512, 1536))
    keys = torch.empty(8, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="lsi_splat_sort_keys"):
        build.launch("splat_sort", "lsi_splat_sort_keys", cuda,
                     keys.data_ptr(), keys.data_ptr(), 384, 1024, 1536,
                     512, 1536, 1, -1, 1, 0)
    assert splat_cuda.splat.sort_launches - before[3] == 1


def test_render_sort_on_cuda_matches_cpu(cuda):
    """render_forward with splat_method="sort" on the card: every render
    one K1-D launch and no K1, the CPU's render within 1e-5, two renders
    bitwise equal."""
    rng = np.random.default_rng(7)
    tex = torch.from_numpy(rng.uniform(size=(2, 2, 32, 64, 3)).astype(
        np.float32))
    disp = torch.from_numpy(rng.uniform(0.05, 0.5, (2, 2, 32, 64, 1))
                            .astype(np.float32))
    K = torch.tensor([[[40.0, 0, 31.5], [0, 40.0, 15.5], [0, 0, 1]]] * 2)
    pose = pose_from_euler([[0.0, 0.02, 0.0]] * 2, [[-0.2, 0.05, 0.0]] * 2)
    ref = render_forward(LDI(tex, disp, K), pose, splat_method="sort")
    ldi = LDI(tex.to(cuda), disp.to(cuda), K.to(cuda))
    before = (splat_cuda.splat.launches, splat_cuda.splat.sort_launches)
    got = [render_forward(ldi, pose.to(cuda), splat_method="sort")
           for _ in range(2)]
    torch.cuda.synchronize()
    assert (splat_cuda.splat.launches - before[0],
            splat_cuda.splat.sort_launches - before[1]) == (0, 2)
    for k in ("rgb", "disparity", "coverage"):
        assert torch.equal(got[0][k], got[1][k])
        torch.testing.assert_close(got[0][k].cpu(), ref[k], rtol=1e-5,
                                   atol=1e-5)
