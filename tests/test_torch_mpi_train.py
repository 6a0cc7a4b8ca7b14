"""The MPI baseline's training and evaluation through the port vs the JAX
package's: the golden train step (loss parts, step-1 gradients, params
after 3 steps; chip_smoke.py holds the card to the same fixture), and the
training CLI on the CPU (``--device cpu``) against a recorded 6-step run
of JAX's Trainer on the toy ``mpi_baseline`` (jsonl lines and keys, eval
metrics, best-export step, params), the eval CLI on its checkpoint
against JAX's ``evaluate`` of the recorded params, a resume, and the
layer-0 freeze refused for the MPI family.

JAX's Trainer never runs here: its run is recorded in
tests/data/torch_golden_mpi_toy.npz by scripts/make_torch_golden_mpi.py.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import json
import os

import numpy as np
import pytest
import torch

from lsi_tpu_torch.config import Config
from lsi_tpu_torch.evaluation.runner import main as eval_main
from lsi_tpu_torch.models.convert import state_dict_from_jax
from lsi_tpu_torch.models.mpi import MPIPredictor
from lsi_tpu_torch.train import checkpoint as tckpt
from lsi_tpu_torch.train import trainer as ttrainer
from lsi_tpu_torch.train.__main__ import main as train_main
from test_torch_train import (GRAD_ATOL_OF_MAX, check_metrics, check_params,
                              torch_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_mpi_toy.npz")

# The toy run's overrides of mpi_baseline (scripts/make_torch_golden_mpi.py
# toy_mpi): D=4, base_filters 8, 2 scales, float32, 16x64 b2, evals every
# 2 steps, checkpoints every 3.
TOY_SETS = ["model.num_planes=4", "model.base_filters=8",
            "model.num_scales=2", "model.compute_dtype=float32",
            "data.height=16", "data.width=64", "data.batch_size=2",
            "train.warmup_steps=2", "train.max_steps=6", "train.eval_every=2",
            "train.eval_batches=1", "train.checkpoint_every=3",
            "train.log_every=1"]
# Eval metrics of the port's params after 6 steps against JAX's (as in
# tests/test_torch_trainer.py): the params follow slightly different
# paths after step 2, and the eval renders with them.
EVAL_RTOL = 1e-3


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def section(golden, prefix):
    return {k[len(prefix):]: v for k, v in golden.items()
            if k.startswith(prefix)}


def jsonl(text):
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def test_golden_mpi_fixture_on_cpu(golden):
    """The train step chip_smoke.py holds the card to, on the CPU path:
    loss parts per step, the first step's gradients within 2e-4 of the
    largest, and the params after 3 steps."""
    cfg = Config.from_dict(json.loads(bytes(golden["__config__"]).decode()))
    assert cfg.model.family == "mpi" and cfg.model.num_planes == 4
    start = state_dict_from_jax(section(golden, "params/"), cfg.model)
    state = ttrainer.create_state(cfg, device="cpu")
    assert isinstance(state.net, MPIPredictor)
    state.net.load_state_dict(start)
    batches = [torch_batch(section(golden, f"batch{i}/")) for i in range(3)]
    grads = ttrainer.loss_and_grads(state, batches[0], cfg)[1]
    want = state_dict_from_jax(section(golden, "step1_grads/"), cfg.model)
    atol = GRAD_ATOL_OF_MAX * max(float(v.abs().max())
                                  for v in want.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    step = ttrainer.make_train_step(cfg)
    metrics_want = section(golden, "metrics/")
    assert {"photo_mpi", "alpha_coverage", "smoothness"} <= set(metrics_want)
    for i, b in enumerate(batches):
        state, metrics = step(state, b)
        assert sorted(metrics) == sorted(metrics_want)
        check_metrics(metrics, {k: v[i] for k, v in metrics_want.items()}, i)
    want = state_dict_from_jax(section(golden, "step3_params/"), cfg.model)
    lr = ttrainer.make_lr_schedule(cfg)
    check_params(state.net.state_dict(), want, start,
                 sum(lr(c) for c in range(3)))


@pytest.fixture(scope="module")
def cli_run(golden, tmp_path_factory):
    """The training CLI on the toy mpi_baseline from the fixture's initial
    params; then the eval CLI on its checkpoint; then a resume to 8."""
    ckpt = str(tmp_path_factory.mktemp("mpi_run"))
    sets = TOY_SETS + [f"train.checkpoint_dir={ckpt}"]
    cfg = Config.from_dict(json.loads(bytes(golden["__config__"]).decode()))
    start = state_dict_from_jax(section(golden, "params/"), cfg.model)
    create = ttrainer.create_state

    def create_from_fixture(cfg, seed=0, device="cuda"):
        state = create(cfg, seed, device)
        state.net.load_state_dict(start)
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer, "create_state", create_from_fixture)
        state, _ = train_main(["--config=mpi_baseline", "--device", "cpu",
                               "--set", *sets])
        params6 = {k: v.clone() for k, v in state.net.state_dict().items()}
        with open(os.path.join(ckpt, "train.jsonl")) as f:
            lines = jsonl(f.read())
        img = str(tmp_path_factory.mktemp("mpi_eval_images"))
        results = eval_main(["--config=mpi_baseline", "--device", "cpu",
                             "--num_batches", "2", "--image_dir", img,
                             "--set", *sets])
        resumed, _ = train_main(["--config=mpi_baseline", "--device", "cpu",
                                 "--set", *sets, "train.max_steps=8"])
    with open(os.path.join(ckpt, "train.jsonl")) as f:
        lines_after = jsonl(f.read())
    return dict(cfg=cfg, dir=ckpt, sets=sets, start=start, params6=params6,
                lines=lines, results=results, img=img, resumed=resumed,
                lines_after=lines_after)


def test_cli_config_is_the_fixtures(golden, cli_run):
    from lsi_tpu_torch.config import build_config
    cfg = build_config("mpi_baseline", cli_run["sets"])
    assert cfg.model == cli_run["cfg"].model
    assert cfg.loss == cli_run["cfg"].loss
    assert cfg.data == cli_run["cfg"].data


def test_cli_run_matches_jax_run(golden, cli_run):
    """The same jsonl lines with the same keys, step by step; the loss
    parts at the golden train tolerances; evals at 2, 4 and 6 within
    EVAL_RTOL (the delta_* counts within one pixel of their mask)."""
    want = jsonl(bytes(golden["trainer/jsonl"]).decode())
    got = cli_run["lines"]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), g["step"]
    train = [(g, w) for g, w in zip(got, want) if "total" in w]
    assert len(train) == 6
    parts = set(section(golden, "metrics/"))  # loss parts and grad_norm
    for i, (g, w) in enumerate(train):
        check_metrics(g, {k: w[k] for k in parts}, min(i, 2))
    evals = [(g, w) for g, w in zip(got, want) if "eval_psnr" in w]
    assert [w["step"] for _, w in evals] == [2, 4, 6]
    data = cli_run["cfg"].data
    pixels = data.batch_size * data.height * data.width
    for g, w in evals:
        for k in w:
            if not k.startswith("eval_"):
                continue
            rtol, atol = ((0.0, 1.0001 / pixels) if "_delta_" in k
                          else (EVAL_RTOL, 1e-6))
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=f"{k} at {w['step']}")


def test_cli_best_export_matches_jax_run(golden, cli_run):
    npz = os.path.join(cli_run["dir"], "best_params.npz")
    meta = tckpt.read_params_npz_meta(npz)
    assert meta["step"] == int(golden["trainer/best_step"])
    with np.load(npz) as data:
        assert sorted(k for k in data.files if not k.startswith("__")) == \
            sorted(section(golden, "trainer/params/"))
    best = tckpt.import_params_npz(cli_run["cfg"].model, npz)
    assert set(best) == set(cli_run["params6"])


def test_cli_params_match_jax_run(golden, cli_run):
    cfg = cli_run["cfg"]
    want = state_dict_from_jax(section(golden, "trainer/params/"), cfg.model)
    lr = ttrainer.make_lr_schedule(cfg)
    check_params(cli_run["params6"], want, cli_run["start"],
                 sum(lr(c) for c in range(cfg.train.max_steps)))


def test_eval_cli_matches_jax_evaluate(golden, cli_run):
    """The eval CLI restores the step-6 checkpoint and scores 2 held-out
    batches: the MPI's metrics (psnr and ssim where alpha > 0.5,
    psnr_full, coverage, depth of the expected source disparity) against
    JAX's evaluate of its own step-6 params, and the image grid."""
    want = section(golden, "trainer/eval/")
    got = cli_run["results"]
    assert sorted(got) == sorted(want)
    assert "window_dropped_frac" not in got and "coverage" in got
    data = cli_run["cfg"].data
    pixels = 2 * data.batch_size * data.height * data.width
    for k, v in want.items():
        rtol, atol = ((0.0, 1.0001 / pixels) if "delta_" in k
                      else (EVAL_RTOL, 1e-6))
        np.testing.assert_allclose(got[k], float(v), rtol=rtol, atol=atol,
                                   err_msg=k)
    png = os.path.join(cli_run["img"], "eval_grid.png")
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_cli_resumes_from_the_checkpoint(cli_run):
    assert cli_run["resumed"].step == 8
    steps = [r["step"] for r in cli_run["lines_after"] if "total" in r]
    assert steps == [1, 2, 3, 4, 5, 6, 7, 8]
    assert [r["step"] for r in cli_run["lines_after"]
            if "eval_psnr" in r] == [2, 4, 6, 8]


def test_layer0_freeze_is_refused_for_the_mpi_family(tmp_path):
    """``train.freeze_layer0_step`` is an LDI mechanism: the Trainer
    raises ValueError for an MPI, as JAX's does."""
    with pytest.raises(ValueError, match="LDI-family"):
        train_main(["--config=mpi_baseline", "--device", "cpu", "--set",
                    *TOY_SETS, f"train.checkpoint_dir={tmp_path}",
                    "train.freeze_layer0_step=4"])


def test_mpi_trains_from_the_preset_at_toy_size(tmp_path):
    """The preset's own defaults (bf16, 16 planes) at a toy size: a step
    and an eval through the CLI, finite."""
    state, metrics = train_main([
        "--config=mpi_baseline", "--device", "cpu", "--set",
        "model.base_filters=4", "data.height=16", "data.width=32",
        "data.batch_size=1", "train.max_steps=1", "train.eval_every=1",
        "train.eval_batches=1", f"train.checkpoint_dir={tmp_path}"])
    assert state.step == 1 and state.net.mpi_head.weight.shape[0] == 35
    assert all(np.isfinite(v) for v in metrics.values())
    assert state.net.unet.dtype == torch.bfloat16
