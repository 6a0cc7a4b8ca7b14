"""The trajectory sweep and its video export against the JAX package.

Toy size (32x64, L=2), float32. JAX renders off the TPU with its lax
splat, which is what the port's sweep is held to. The port renders each
chunk of 8 poses in one ``render_forward`` (8 renders for a 60-view
sweep); the frames' PNGs decode to JAX's pixels, and the GIF is JAX's
file byte for byte.

Tolerances. Where every projected coordinate is exact in float32 in both
packages (dyadic intrinsics and disparities, translation-only sweeps: the
H10 practice of the other tests), the frames agree within 1e-5 and the
extreme-pose window fraction within 1e-6. Where a rotation's sine and
cosine differ by an ulp between the packages, a coordinate that moves by
an ulp at a silhouette shifts a corner weight that the soft z-buffer
(exp(50 d)) multiplies by up to ~1e6: there the frames are held in
aggregate, 99% of entries within 1e-5 and all within the golden render
check's 1e-3 (tests/test_torch_api.py), and the fraction within 1e-5.
JAX's own jitted sweep sits 7.4e-4 from its eager renders of the same
poses on the golden LDI; the port reads 8.1e-4 at most, at 0.5% of
entries beyond 1e-5.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from lsi_tpu.config import RenderConfig as JRenderConfig
from lsi_tpu.evaluation import trajectory as jtraj
from lsi_tpu.evaluation import video as jvideo
from lsi_tpu.geometry.ldi import LDI as JLDI
from lsi_tpu_torch.api import LSIModel
from lsi_tpu_torch.config import RenderConfig
from lsi_tpu_torch.evaluation import runner as trunner
from lsi_tpu_torch.evaluation import trajectory as ttraj
from lsi_tpu_torch.evaluation import video as tvideo
from lsi_tpu_torch.geometry.ldi import LDI, render_forward
from lsi_tpu_torch.geometry.transforms import camera_trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_toy.npz")
H, W = 32, 64
FRAME_ATOL = 1e-5
DROP_ATOL = 1e-6
# Rotating sweeps (see the module docstring).
SHARE_WITHIN = 0.99
FRAME_MAX_ATOL = 1e-3
ROT_DROP_ATOL = 1e-5


def pair(tex, disp, K):
    """The same LDI for both packages."""
    arrays = [np.array(x, np.float32) for x in (tex, disp, K)]
    return (JLDI(*(jnp.asarray(a) for a in arrays)),
            LDI(*(torch.from_numpy(a) for a in arrays)))


@pytest.fixture(scope="module")
def exact():
    """An LDI whose projections are exact in float32: focal 64, centres at
    half pixels, disparities 1/2, 1/4 (a box in front) and 1/8."""
    rng = np.random.default_rng(0)
    tex = rng.uniform(size=(2, 2, H, W, 3))
    disp = np.full((2, 2, H, W, 1), 0.25)
    disp[:, 0, 8:24, 16:40] = 0.5
    disp[:, 1] = 0.125
    K = np.tile(np.array([[64.0, 0, 31.5], [0, 64.0, 15.5], [0, 0, 1]]),
                (2, 1, 1))
    return pair(tex, disp, K)


@pytest.fixture(scope="module")
def golden():
    """JAX's LDI of the golden image (the fixture's recorded output) and
    the port's, predicted with the same weights converted from the
    fixture's JAX export."""
    with np.load(GOLDEN) as g:
        gold = {k: g[k] for k in g.files if not k.startswith("params/")}
    model = LSIModel.load(GOLDEN, device="cpu")
    with torch.no_grad():
        tldi = model.predict_ldi(torch.from_numpy(gold["image"]),
                                 torch.from_numpy(gold["intrinsics"]))
    jldi, _ = pair(gold["ldi_textures"], gold["ldi_disparities"],
                   gold["intrinsics"])
    return jldi, tldi


def sweep_pair(jldi, tldi, mt, mr, max_dy, n=60):
    want, jdrop = jtraj._render_canonical_sweep(
        jldi, jnp.asarray(mt, jnp.float32), jnp.asarray(mr, jnp.float32), n,
        JRenderConfig(pallas_max_dy=max_dy), check=True)
    got, drop = ttraj._render_canonical_sweep(
        tldi, mt, mr, n, RenderConfig(pallas_max_dy=max_dy))
    assert got.shape == (n,) + tuple(tldi.textures.shape[:1]) + (H, W, 3)
    return got.numpy(), np.asarray(want), drop, float(jdrop)


def assert_aggregate(got, want):
    err = np.abs(got - want)
    assert (err <= FRAME_ATOL).mean() >= SHARE_WITHIN, (err > FRAME_ATOL
                                                        ).mean()
    assert err.max() <= FRAME_MAX_ATOL, err.max()


@pytest.mark.parametrize("mt,max_dy", [((0.15, 0.0, 0.0), 2),
                                       ((0.15, 0.05, 0.0), 1)])
def test_canonical_sweep_matches_jax(exact, mt, max_dy):
    """Exact projections: frames within 1e-5, the window fraction (0, and
    a partial drop from the vertical motion) within 1e-6."""
    got, want, drop, jdrop = sweep_pair(*exact, mt, (0.0, 0.0, 0.0), max_dy)
    np.testing.assert_allclose(got, want, atol=FRAME_ATOL, rtol=0)
    assert abs(drop - jdrop) <= DROP_ATOL
    assert (jdrop > 0.01) == (mt[1] > 0)


@pytest.mark.parametrize("mr,max_dy", [((0.0, 0.0, 0.01), 16),
                                       ((0.02, 0.0, 0.02), 1)])
def test_rotating_sweep_matches_jax(golden, mr, max_dy):
    """The golden LDI under the runner's sweep and one whose rotation
    about x overflows a 1-row window."""
    jldi, _ = golden
    _, tldi = pair(jldi.textures, jldi.disparities, jldi.intrinsics)
    got, want, drop, jdrop = sweep_pair(jldi, tldi, (0.15, 0.0, 0.0), mr,
                                        max_dy)
    assert_aggregate(got, want)
    assert abs(drop - jdrop) <= ROT_DROP_ATOL
    assert (jdrop > 0.01) == (max_dy == 1)


def test_sweep_with_converted_weights_matches_jax(golden, monkeypatch):
    """Each package's own LDI through its own ``render_trajectory``, the
    port in 8 renders (chunks of 8 poses) for 60 views."""
    jldi, tldi = golden
    np.testing.assert_allclose(tldi.textures.numpy(),
                               np.asarray(jldi.textures), atol=1e-4)
    np.testing.assert_allclose(tldi.disparities.numpy(),
                               np.asarray(jldi.disparities), atol=1e-4)
    renders = []

    def counted(ldi, pose, **kw):
        renders.append(ldi.batch)
        return render_forward(ldi, pose, **kw)

    monkeypatch.setattr(ttraj, "render_forward", counted)
    want = jtraj.render_trajectory(jldi, 60,
                                   render_cfg=JRenderConfig(pallas_max_dy=16))
    jtraj.flush_window_warnings()
    got = ttraj.render_trajectory(tldi, 60,
                                  render_cfg=RenderConfig(pallas_max_dy=16))
    assert renders == [16] * 7 + [8]
    assert_aggregate(got.numpy(), np.asarray(want))


def test_given_poses_match_jax(exact):
    """Arbitrary poses (11, chunks of 4), translations only: frames as
    JAX's per-pose path within 1e-5."""
    jldi, tldi = exact
    poses = camera_trajectory(11, (0.2, -0.03, 0.05))
    want, _ = jtraj._render_poses(jldi, jnp.asarray(poses.numpy()),
                                  JRenderConfig(), chunk=4)
    got, _ = ttraj._render_poses(tldi, poses, RenderConfig(), chunk=4)
    assert got.shape == (11, 2, H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FRAME_ATOL, rtol=0)


def test_chunk_equals_single_renders(golden):
    """One chunk of 8 poses against 8 single-pose renders."""
    _, tldi = golden
    poses = camera_trajectory(8, (0.15, 0.0, 0.0), (0.0, 0.0, 0.02))
    got = ttraj.render_trajectory(tldi, poses=poses)
    with torch.no_grad():
        for i, pose in enumerate(poses):
            one = render_forward(tldi, pose.expand(2, 4, 4))["rgb"]
            np.testing.assert_allclose(got[i].numpy(), one.numpy(),
                                       atol=FRAME_ATOL, rtol=0)


@pytest.mark.parametrize("mr,max_dy", [((0.0, 0.0, 0.01), 16),
                                       ((0.02, 0.0, 0.02), 1)])
def test_window_warning_matches_jax(golden, mr, max_dy):
    """The port warns (synchronously) exactly where JAX does."""
    mt = (0.15, 0.0, 0.0)
    jldi, tldi = golden
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jtraj.render_trajectory(jldi, 24, mt, mr,
                                JRenderConfig(pallas_max_dy=max_dy))
        jtraj.flush_window_warnings()
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        ttraj.render_trajectory(tldi, 24, mt, mr,
                                RenderConfig(pallas_max_dy=max_dy))
    jn = [w for w in jw if "dy-window" in str(w.message)]
    tn = [w for w in tw if "dy-window" in str(w.message)]
    assert len(tn) == len(jn) == (1 if max_dy == 1 else 0)


def test_save_frames_and_gif_match_jax(golden, tmp_path):
    jldi, _ = golden
    frames = np.array(jtraj.render_trajectory(
        jldi, 12, render_cfg=JRenderConfig(window_check=False)))
    frames[0, 1, 0, :4, 0] = [-0.5, 1.5, 0.999, 0.0]  # clipped both ways
    jpaths = jvideo.save_frames(frames, str(tmp_path / "j"), batch_index=1)
    tpaths = tvideo.save_frames(torch.from_numpy(frames), str(tmp_path / "t"),
                                batch_index=1)
    assert [p.split("/")[-1] for p in tpaths] == [p.split("/")[-1]
                                                  for p in jpaths]
    for a, b in zip(tpaths, jpaths):
        np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                      np.asarray(Image.open(b)))
    jgif = jvideo.save_gif(frames, str(tmp_path / "j.gif"), fps=12)
    tgif = tvideo.save_gif(torch.from_numpy(frames), str(tmp_path / "t.gif"),
                           fps=12)
    assert open(tgif, "rb").read() == open(jgif, "rb").read()
    decoded = [np.asarray(f.convert("RGB"))
               for f in ImageSequence.Iterator(Image.open(tgif))]
    assert len(decoded) == 12


def test_runner_writes_the_trajectory_gif(tmp_path, capsys):
    """``--trajectory_gif`` on the CPU: the trajectory_sweep preset at toy
    widths, fresh weights, 60 frames in the GIF."""
    gif = tmp_path / "sweep.gif"
    sets = ["model.base_filters=8", "model.num_scales=2", "data.height=32",
            "data.width=64", f"train.checkpoint_dir={tmp_path / 'none'}"]
    trunner.main(["--config=trajectory_sweep", "--device", "cpu",
                  "--num_batches", "1", "--trajectory_gif", str(gif),
                  "--set", *sets])
    assert f"trajectory gif: {gif}" in capsys.readouterr().out
    frames = list(ImageSequence.Iterator(Image.open(gif)))
    assert len(frames) == 60 and frames[0].size == (64, 32)
