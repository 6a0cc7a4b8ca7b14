"""The port's CUDA kernel on the card: K1 (forward splat) against its plain
version, its launch count, and the render and golden fixture on CUDA.

Every test needs a CUDA card (marker ``gpu``) and skips without one. The
file imports no JAX, so it also runs where JAX is not installed; there,
skip the JAX-only conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from lsi_tpu_torch.api import LSIModel
from lsi_tpu_torch.geometry.ldi import LDI, render_forward
from lsi_tpu_torch.geometry.transforms import pose_from_euler
from lsi_tpu_torch.kernels import splat_cuda
from lsi_tpu_torch.ops.splat import splat_bilinear

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_toy.npz")


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
