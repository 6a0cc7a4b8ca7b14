"""The port's public API vs the JAX package's: configs, the .npz model
format both ways, predict_ldi -> render end to end, the golden fixture,
RenderConfig handling, and that the port never imports JAX.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsi_tpu.api as japi
import lsi_tpu.config as jconfig
from lsi_tpu.geometry import transforms as jtf
from lsi_tpu_torch import api as tapi
from lsi_tpu_torch import config as tconfig
from lsi_tpu_torch.geometry.ldi import render_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_toy.npz")
H, W = 32, 64


def toy_config(module, dtype="float32"):
    return module.Config(model=module.ModelConfig(
        base_filters=8, num_scales=2, compute_dtype=dtype))


@pytest.mark.parametrize("name", ["ModelConfig", "RenderConfig", "LossConfig",
                                  "DataConfig", "TrainConfig", "Config"])
def test_config_dataclasses_match_jax(name):
    """The port's copy of lsi_tpu/config.py: same fields, same defaults."""
    mine = getattr(tconfig, name)
    ref = getattr(jconfig, name)
    assert ([f.name for f in dataclasses.fields(mine)]
            == [f.name for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(mine()) == dataclasses.asdict(ref())


def test_config_presets_match_jax():
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    for name in jconfig.PRESETS:
        assert (dataclasses.asdict(tconfig.get_config(name))
                == dataclasses.asdict(jconfig.get_config(name))), name


def test_default_intrinsics_matches_jax():
    np.testing.assert_array_equal(
        tapi.default_intrinsics(3, H, W).numpy(),
        np.asarray(japi.default_intrinsics(3, H, W)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_jax_saved_model_and_serve(tmp_path, rng, dtype):
    """LSIModel.load reads lsi_tpu.api.LSIModel.save's file; predict_ldi
    -> render then agrees with the JAX API. float32: 1e-5 on the LDI, 1e-3
    on the render (the fraction snap moves a corner's weight by up to 1e-4
    when a coordinate crosses its edge, which ~1e-5 px differences reach
    at a few pixels). bf16: 2e-2 on the LDI, where the frameworks round to
    bf16 at other places."""
    jm = japi.LSIModel.init(jax.random.key(3), toy_config(jconfig, dtype),
                            H, W)
    path = str(tmp_path / "model.npz")
    jm.save(path)
    tm = tapi.LSIModel.load(path, device="cpu")
    assert tm.config == toy_config(tconfig, dtype)

    img = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    pose = np.array(jtf.pose_from_euler(
        np.array([[0.0, 0.02, 0.0], [0.01, 0.0, 0.0]], np.float32),
        np.array([[-0.1, 0.0, 0.0], [0.05, 0.0, 0.02]], np.float32)))
    j_ldi = jm.predict_ldi(jnp.asarray(img))
    j_rgb = jm.render(j_ldi, jnp.asarray(pose))
    t_ldi = tm.predict_ldi(torch.from_numpy(img))
    t_rgb = tm.render(t_ldi, torch.from_numpy(pose))
    ldi_tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(t_ldi.textures.numpy(),
                               np.asarray(j_ldi.textures), atol=ldi_tol)
    np.testing.assert_allclose(t_ldi.disparities.numpy(),
                               np.asarray(j_ldi.disparities), atol=ldi_tol)
    if dtype == "float32":
        np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb),
                                   atol=1e-3)
    assert t_rgb.shape == (2, H, W, 3) and torch.isfinite(t_rgb).all()


def test_save_round_trips_both_ways(tmp_path):
    """The port's save is read by the JAX package's load, params bitwise."""
    tm = tapi.LSIModel.init(5, toy_config(tconfig), H, W, device="cpu")
    path = str(tmp_path / "port.npz")
    tm.save(path)
    jm = japi.LSIModel.load(path)
    assert dataclasses.asdict(jm.config) == dataclasses.asdict(tm.config)
    back = tapi.LSIModel.load(path, device="cpu")
    for k, v in tm.net.state_dict().items():
        assert torch.equal(v, back.net.state_dict()[k]), k
    img = np.random.default_rng(1).uniform(size=(1, H, W, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        tm.predict_ldi(torch.from_numpy(img)).disparities.numpy(),
        np.asarray(jm.predict_ldi(jnp.asarray(img)).disparities), atol=1e-5)


def test_golden_fixture_on_cpu():
    """The fixture chip_smoke.py holds the CUDA path to, on the CPU path
    (same tolerances as the script)."""
    model = tapi.LSIModel.load(GOLDEN, device="cpu")
    with np.load(GOLDEN) as g:
        gold = {k: g[k] for k in g.files if not k.startswith("params/")}
    ldi = model.predict_ldi(torch.from_numpy(gold["image"]),
                            torch.from_numpy(gold["intrinsics"]))
    with torch.inference_mode():
        out = render_forward(ldi, torch.from_numpy(gold["pose"]),
                             zbuffer_scale=model.config.render.zbuffer_scale)
    np.testing.assert_allclose(ldi.textures.numpy(), gold["ldi_textures"],
                               atol=1e-4)
    np.testing.assert_allclose(ldi.disparities.numpy(),
                               gold["ldi_disparities"], atol=1e-4)
    for k in ("rgb", "disparity"):
        np.testing.assert_allclose(out[k].numpy(), gold[k], atol=1e-3)
    np.testing.assert_allclose(out["coverage"].numpy(), gold["coverage"],
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("field,value", [("use_pallas", "on"),
                                         ("use_pallas", "off"),
                                         ("splat_method", "sort")])
def test_render_rejects_tpu_only_config(field, value):
    """Every RenderConfig value the JAX package renders with: the
    deterministic ``splat_method="sort"`` renders JAX's sort render (its
    exact lax path, the same sums in the same order, so within float32
    rounding of the projection) and is bitwise repeatable; ``use_pallas``
    "off" renders as "auto" (exact) and "on" takes the windowed route of
    ``render_forward``."""
    tm = tapi.LSIModel.init(0, toy_config(tconfig), H, W, device="cpu")
    ldi = tm.predict_ldi(torch.rand(1, H, W, 3,
                                    generator=torch.Generator().manual_seed(0)))
    pose = torch.from_numpy(np.array(jtf.translation_pose([[-0.2, 0.1, 0]])))
    cfg = dataclasses.replace(tconfig.RenderConfig(), **{field: value})
    if field == "splat_method":
        from lsi_tpu.geometry.ldi import LDI as JLDI
        got = tapi.render(ldi, pose, config=cfg)
        assert torch.equal(got, tapi.render(ldi, pose, config=cfg))
        want = japi.render(
            JLDI(*(jnp.asarray(t.numpy()) for t in (
                ldi.textures, ldi.disparities, ldi.intrinsics))),
            jnp.asarray(pose.numpy()), config=jconfig.RenderConfig(
                splat_method="sort"))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        with pytest.raises(ValueError):
            tapi.render(ldi, pose, config=dataclasses.replace(
                cfg, splat_method="segment"))
        return
    got = tapi.render(ldi, pose, config=cfg)
    want = render_forward(ldi, pose, zbuffer_scale=cfg.zbuffer_scale,
                          use_pallas=value,
                          pallas_max_dy=cfg.pallas_max_dy)["rgb"]
    assert torch.equal(got, want)
    if value == "off":
        assert torch.equal(got, tapi.render(ldi, pose))


def test_render_ignores_window_fields():
    """pallas_max_dy and window_check have no effect: the splat is exact."""
    tm = tapi.LSIModel.init(0, toy_config(tconfig), H, W, device="cpu")
    ldi = tm.predict_ldi(torch.rand(1, H, W, 3,
                                    generator=torch.Generator().manual_seed(0)))
    pose = torch.from_numpy(np.array(jtf.translation_pose([[-0.2, 0.1, 0]])))
    a = tapi.render(ldi, pose)
    b = tapi.render(ldi, pose, config=tconfig.RenderConfig(
        pallas_max_dy=0, window_check=False))
    assert torch.equal(a, b)


def test_init_checks_image_size():
    with pytest.raises(ValueError):
        tapi.LSIModel.init(0, toy_config(tconfig), 30, 64, device="cpu")


def test_entry_points_default_to_cuda(tmp_path):
    """Without ``device`` the model and spawned ranks go to the card; with
    no card that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        tapi.LSIModel.init(0, toy_config(tconfig), H, W)
    path = str(tmp_path / "model.npz")
    tapi.LSIModel.init(0, toy_config(tconfig), H, W, device="cpu").save(path)
    with pytest.raises((AssertionError, RuntimeError)):
        tapi.LSIModel.load(path)
    from lsi_tpu_torch.parallel import launch
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(launch.spatial_render, 2,
                     init_file=str(tmp_path / "store"))


def test_port_never_imports_jax():
    """A fresh interpreter serves predict_ldi -> render, takes one train
    step of a toy kitti_ldi3_b16, and trains a toy kitti_ldi3_quality and
    a toy mpi_baseline for one step each through the training CLI (the
    first with ``--dist_backend``) and scores them through the eval CLI,
    renders height-sharded and differentiates on a one-rank plan in this
    interpreter (the parallel modules), compares both families through
    the comparison CLI, writes shards through the materialize CLI, trains
    a step each from generated KITTI and SYNTHIA layouts through the native
    loader, and writes a trajectory GIF through the eval CLI from the
    shards, all through the port, with neither JAX nor any module of the
    JAX package loaded."""
    code = textwrap.dedent("""
        import dataclasses
        import math
        import sys
        import torch
        from lsi_tpu_torch import Config, LSIModel, ModelConfig
        from lsi_tpu_torch.config import get_config
        from lsi_tpu_torch.data.pipeline import batch_stream
        from lsi_tpu_torch.geometry.transforms import translation_pose
        from lsi_tpu_torch.train.trainer import create_state, make_train_step
        cfg = Config(model=ModelConfig(base_filters=8, num_scales=2))
        model = LSIModel.init(0, cfg, 32, 64, device="cpu")
        ldi = model.predict_ldi(torch.rand(1, 32, 64, 3))
        rgb = model.render(ldi, translation_pose([[-0.1, 0.0, 0.0]]))
        assert rgb.shape == (1, 32, 64, 3) and torch.isfinite(rgb).all()
        cfg = get_config("kitti_ldi3_b16")
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, base_filters=8,
                                           num_scales=2),
            data=dataclasses.replace(cfg.data, dataset="synthetic",
                                     height=32, width=64, batch_size=2))
        state = create_state(cfg, seed=0, device="cpu")
        step = make_train_step(cfg)
        state, metrics = step(state, next(batch_stream(cfg.data,
                                                       device="cpu")))
        assert all(math.isfinite(float(v)) for v in metrics.values())
        assert float(metrics["photo_splat"]) > 0 and state.step == 1
        import tempfile
        import lsi_tpu_torch.evaluation.metrics
        import lsi_tpu_torch.evaluation.occlusion
        import lsi_tpu_torch.train.checkpoint
        import lsi_tpu_torch.train.metrics
        from lsi_tpu_torch.evaluation.runner import main as eval_main
        from lsi_tpu_torch.train.__main__ import main as train_main
        with tempfile.TemporaryDirectory() as ckpt:
            sets = ["model.base_filters=8", "model.num_scales=2",
                    "data.dataset=synthetic", "data.synthetic_scene=multi",
                    "data.height=16", "data.width=32", "data.batch_size=2",
                    "train.max_steps=1", "train.eval_every=1",
                    "train.eval_batches=1", "train.freeze_layer0_step=1",
                    "loss.consistency_start_step=0",
                    f"train.checkpoint_dir={ckpt}"]
            state, metrics = train_main(["--config=kitti_ldi3_quality",
                                         "--device", "cpu", "--dist_backend",
                                         "gloo", "--set", *sets])
            assert state.step == 1 and "depth_consistency" in metrics
            results = eval_main(["--config=kitti_ldi3_quality", "--device",
                                 "cpu", "--num_batches", "1", "--set", *sets])
            assert math.isfinite(results["abs_rel"])
        with tempfile.TemporaryDirectory() as ckpt:
            sets = ["model.num_planes=4", "model.base_filters=8",
                    "model.num_scales=2", "data.height=16", "data.width=32",
                    "data.batch_size=2", "train.max_steps=1",
                    "train.eval_every=1", "train.eval_batches=1",
                    f"train.checkpoint_dir={ckpt}"]
            state, metrics = train_main(["--config=mpi_baseline", "--device",
                                         "cpu", "--set", *sets])
            assert state.step == 1 and "photo_mpi" in metrics
            results = eval_main(["--config=mpi_baseline", "--device", "cpu",
                                 "--num_batches", "1", "--set", *sets])
            assert math.isfinite(results["abs_rel"])
        import numpy as np
        from lsi_tpu_torch.parallel import launch, mesh, reduce, spatial
        arrays = {"textures": np.random.rand(1, 2, 16, 32, 3),
                  "disparities": np.full((1, 2, 16, 32, 1), 0.2),
                  "intrinsics": np.array([[[30.0, 0, 16], [0, 30, 8],
                                           [0, 0, 1]]])}
        arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
        pose = translation_pose([[-0.1, 0.0, 0.0]]).numpy()
        out = launch.spatial_render(mesh.ProcessPlan(), arrays, pose, 50.0,
                                    1, target=np.zeros((1, 16, 32, 3),
                                                       np.float32))
        assert out["rgb"].shape == (1, 16, 32, 3)
        assert np.isfinite(out["grad_disparities"]).all()
        from lsi_tpu_torch.evaluation import compare
        results = compare.main(["1", "--device", "cpu", "--set",
                                "model.base_filters=8", "model.num_scales=2",
                                "model.num_planes=4", "data.height=16",
                                "data.width=32", "data.batch_size=2"])
        assert sorted(results) == ["mpi_baseline", "synthetic_sanity"]
        import lsi_tpu_torch.data.kitti_oxts
        import lsi_tpu_torch.data.splits
        import lsi_tpu_torch.device
        import lsi_tpu_torch.evaluation.png
        from lsi_tpu_torch import native
        from lsi_tpu_torch.data import kitti, layouts, synthia
        from lsi_tpu_torch.data.materialize import main as materialize_main
        with tempfile.TemporaryDirectory() as d:
            materialize_main(["--out", d + "/shards", "--count", "4",
                              "--height", "16", "--width", "32",
                              "--workers", "1"])
            layouts.write_kitti_raw(d + "/kitti", drives=2, frames=2,
                                    hw=(24, 80))
            layouts.write_synthia_seqs(d + "/synthia", frames=2, hw=(24, 40))
            sets = ["model.base_filters=8", "model.num_scales=2",
                    "data.height=16", "data.width=32", "data.batch_size=2",
                    "train.max_steps=1", "train.eval_every=1",
                    "train.eval_batches=1", "train.freeze_layer0_step=1",
                    "loss.consistency_start_step=0",
                    f"train.checkpoint_dir={d}/ckpt"]
            state, _ = train_main(["--config=kitti_ldi3_quality", "--device",
                                   "cpu", "--set", *sets,
                                   f"data.root={d}/kitti"])
            assert state.step == 1 and native.available()
            state, _ = train_main(["--config=synthia_ldi2_splat", "--device",
                                   "cpu", "--set", *sets[:-4],
                                   f"data.root={d}/synthia",
                                   f"train.checkpoint_dir={d}/s"])
            assert state.step == 1
            assert kitti.DECODED["native"] > 0
            assert synthia.DECODED["native_depth16"] > 0
            eval_main(["--config=trajectory_sweep", "--device", "cpu",
                       "--num_batches", "1", "--trajectory_gif",
                       d + "/sweep.gif", "--set", *sets[:5],
                       "data.dataset=synthetic", f"data.root={d}/shards",
                       f"train.checkpoint_dir={d}/none"])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "lsi_tpu"))
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
