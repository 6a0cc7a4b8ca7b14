"""The port's training harness vs the JAX package's: the Trainer against
a recorded 6-step run of JAX's Trainer on the toy quality recipe (phases
per step, eval metrics, best export, layer-0 splice and freeze, params),
the golden two-prediction fixture chip_smoke.py uses, checkpoints and
resume, the params ``.npz`` both ways between the packages, the layer-0
splice, the jsonl writer, the CLI's overrides, and the Trainer's checks.

JAX's Trainer (orbax, the prefetch thread) never runs here: its run is
recorded in tests/data/torch_golden_quality_toy.npz by
scripts/make_torch_golden_quality.py.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsi_tpu.config import get_config as j_get_config
from lsi_tpu.models.ldi_predictor import \
    splice_layer0_params as j_splice_layer0_params
from lsi_tpu.train import checkpoint as jckpt
from lsi_tpu.train.__main__ import apply_override as j_apply_override
from lsi_tpu.train.metrics import MetricWriter as JMetricWriter
from lsi_tpu_torch.config import (Config, apply_override, build_config,
                                  get_config)
from lsi_tpu_torch.models.convert import (jax_from_state_dict,
                                          state_dict_from_jax)
from lsi_tpu_torch.models.ldi_predictor import (LDIPredictor,
                                                freeze_layer0_grad_mask,
                                                splice_layer0_params)
from lsi_tpu_torch.train import checkpoint as tckpt
from lsi_tpu_torch.train import trainer as ttrainer
from lsi_tpu_torch.train.__main__ import main as train_main
from lsi_tpu_torch.train.metrics import MetricWriter
from test_torch_consistency import GOLDEN, toy_quality
from test_torch_train import (check_metrics, check_params, flat, torch_batch,
                              unflatten)

# The golden quality fixture's step-1 gradients: within 2e-4 of the
# largest, the golden train step's limit. The fixture holds JAX's eager
# gradients, and the port on the CPU reads 1.5e-5 of the largest against
# them; planted faults in the two-prediction terms read 0.31 to 1.85
# (scripts/train_parity_spread.py --quality).
QUALITY_GRAD_ATOL_OF_MAX = 2e-4

# The Trainer's eval metrics after 2, 4 and 6 steps against JAX's: the
# params have followed slightly different paths since step 2 (ROADMAP H10:
# the splat and gather gradients jump at pixel edges, and Adam turns the
# difference into steps of up to lr), and the eval renders and compares
# with those params: 1e-3 (measured: at most 6.3e-4, ssim at step 6). The
# delta_* metrics count pixels under a ratio threshold, so a 1e-4 change
# of one pixel's depth moves them by that pixel's share of the mask: they
# may differ by one pixel (measured: one, delta_1.25^3 at step 6).
EVAL_RTOL = 1e-3


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def section(golden, prefix):
    return {k[len(prefix):]: v for k, v in golden.items()
            if k.startswith(prefix)}


def golden_start(golden, cfg):
    return state_dict_from_jax(section(golden, "params/"), cfg.model)


def jsonl(text):
    return [json.loads(line) for line in text.splitlines() if line.strip()]


# ------------------------------------------------------ golden fixtures

def test_golden_quality_fixture_on_cpu(golden):
    """The fixture chip_smoke.py holds the CUDA two-prediction step to, on
    the CPU path: loss parts (both steps see the same params: the first
    has lr 0) at the golden train tolerances, and the first step's
    gradients within QUALITY_GRAD_ATOL_OF_MAX of the largest."""
    cfg = Config.from_dict(json.loads(bytes(golden["__config__"]).decode()))
    assert cfg == toy_quality(get_config)
    start = golden_start(golden, cfg)
    state = ttrainer.create_state(cfg, device="cpu")
    state.net.load_state_dict(start)
    batches = [torch_batch(section(golden, f"batch{i}/")) for i in range(2)]
    grads = ttrainer.loss_and_grads(state, batches[0], cfg)[1]
    want = state_dict_from_jax(section(golden, "step1_grads/"), cfg.model)
    atol = QUALITY_GRAD_ATOL_OF_MAX * max(float(v.abs().max())
                                          for v in want.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    step = ttrainer.make_train_step(cfg)
    metrics_want = section(golden, "metrics/")
    assert {"depth_consistency", "depth_anchor", "photo_splat_rev",
            "window_dropped_frac_rev"} <= set(metrics_want)
    for i, b in enumerate(batches):
        state, metrics = step(state, b)
        assert sorted(metrics) == sorted(metrics_want)
        check_metrics(metrics, {k: v[i] for k, v in metrics_want.items()}, i)


@pytest.fixture(scope="module")
def port_run(golden, tmp_path_factory):
    """The port's Trainer over the golden run's 6 steps, from the same
    initial params (the fixture's) and the same data streams."""
    cfg = toy_quality(get_config)
    ckpt = str(tmp_path_factory.mktemp("quality_run"))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                checkpoint_dir=ckpt))
    start = golden_start(golden, cfg)
    create = ttrainer.create_state

    def create_from_fixture(cfg, seed=0, device="cuda"):
        state = create(cfg, seed, device)
        state.net.load_state_dict(start)
        return state

    splices = []
    trainer = ttrainer.Trainer(cfg, device="cpu")
    splice = trainer.splice_best_layer0

    def record_splice(state):
        state = splice(state)
        splices.append({k: v.detach().clone()
                        for k, v in state.net.state_dict().items()})
        return state

    trainer.splice_best_layer0 = record_splice
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer, "create_state", create_from_fixture)
        state, _ = trainer.train()
    with open(os.path.join(ckpt, "train.jsonl")) as f:
        lines = jsonl(f.read())
    return dict(cfg=cfg, dir=ckpt, state=state, lines=lines, start=start,
                splices=splices)


def test_trainer_phases_match_jax_run(golden, port_run):
    """The same jsonl lines, step by step, with the same keys: warm-up
    steps without ``depth_consistency``, then the full step, evals at 2,
    4 and 6; the freeze keeps the full loss."""
    want = jsonl(bytes(golden["trainer/jsonl"]).decode())
    got = port_run["lines"]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), g["step"]
    train_lines = [r for r in got if "total" in r]
    assert ["depth_consistency" in r for r in train_lines] == \
        [False, False, True, True, True, True]
    assert [r["step"] for r in got if "eval_abs_rel" in r] == [2, 4, 6]


def test_trainer_eval_metrics_match_jax_run(golden, port_run):
    want = [r for r in jsonl(bytes(golden["trainer/jsonl"]).decode())
            if "eval_psnr" in r]
    got = [r for r in port_run["lines"] if "eval_psnr" in r]
    data = port_run["cfg"].data
    pixels = data.batch_size * data.height * data.width
    for g, w in zip(got, want):
        for k in w:
            if not k.startswith("eval_"):
                continue
            if "_delta_" in k:  # a count: one pixel of its mask
                mask = pixels * (w["eval_occ_fraction"] if "occ" in k else 1)
                rtol, atol = 0.0, 1.0001 / mask
            else:
                rtol, atol = EVAL_RTOL, 1e-6
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=f"{k} at {w['step']}")


def test_trainer_best_export_and_splice_match_jax_run(golden, port_run):
    """The best export is the same step's, in JAX's key format, with its
    metadata inside (no json sidecar); the splice ran once, at the freeze
    step, and layer 0 stayed bitwise equal to the spliced values to the
    end."""
    cfg = port_run["cfg"]
    npz = os.path.join(port_run["dir"], "best_params.npz")
    assert not os.path.exists(os.path.join(port_run["dir"],
                                           "best_params.json"))
    meta = tckpt.read_params_npz_meta(npz)
    assert meta["step"] == int(golden["trainer/best_step"])
    assert meta == jckpt.read_params_npz_meta(npz)
    with np.load(npz) as data:
        assert sorted(k for k in data.files if not k.startswith("__")) == \
            sorted(section(golden, "trainer/params/"))
    assert len(port_run["splices"]) == 1
    spliced = port_run["splices"][0]
    final = port_run["state"].net.state_dict()
    owned = freeze_layer0_grad_mask(
        cfg.model, {k: torch.ones_like(v) for k, v in final.items()})
    for k, v in final.items():
        keep = owned[k] == 0
        assert torch.equal(v[keep], spliced[k][keep]), k
    assert any(not torch.equal(v, spliced[k]) for k, v in final.items())


def test_trainer_params_match_jax_run(golden, port_run):
    cfg = port_run["cfg"]
    want = state_dict_from_jax(section(golden, "trainer/params/"), cfg.model)
    lr = ttrainer.make_lr_schedule(cfg)
    check_params(port_run["state"].net.state_dict(), want, port_run["start"],
                 sum(lr(c) for c in range(cfg.train.max_steps)))


# ------------------------------------------------- checkpoints, resume

def small_cfg(tmp_path, **train):
    cfg = toy_quality(get_config)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, height=16, width=32),
        train=dataclasses.replace(cfg.train, checkpoint_dir=str(tmp_path),
                                  **train))


def test_checkpoint_restore_returns_the_same_state(tmp_path):
    cfg = small_cfg(tmp_path)
    state = ttrainer.create_state(cfg, seed=1, device="cpu")
    step = ttrainer.make_train_step(cfg)
    from lsi_tpu_torch.data.pipeline import batch_stream
    stream = batch_stream(cfg.data, device="cpu")
    for _ in range(2):
        state, _ = step(state, next(stream))
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state)
    assert mgr.steps() == [2, 3]  # rotation
    fresh = mgr.restore(ttrainer.create_state(cfg, seed=2, device="cpu"))
    assert fresh.step == state.step == 2
    for k, v in state.net.state_dict().items():
        assert torch.equal(fresh.net.state_dict()[k], v), k
    for a, b in ((fresh.opt_state.mu, state.opt_state.mu),
                 (fresh.opt_state.nu, state.opt_state.nu)):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert dataclasses.replace(fresh.opt_state, mu={}, nu={}) == \
        dataclasses.replace(state.opt_state, mu={}, nu={})
    empty = tckpt.CheckpointManager(str(tmp_path / "none"))
    template = ttrainer.create_state(cfg, device="cpu")
    assert empty.restore(template) is template


def test_trainer_resumes_from_the_latest_checkpoint(tmp_path):
    """A second run in the same directory starts at the checkpoint's step
    and appends to the jsonl; the splice does not run again past the
    freeze step."""
    cfg = small_cfg(tmp_path, max_steps=5, checkpoint_every=5)
    state, _ = ttrainer.Trainer(cfg, device="cpu").train()
    assert state.step == 5
    frozen = {k: v.clone() for k, v in state.net.state_dict().items()}
    trainer = ttrainer.Trainer(cfg, device="cpu")
    trainer.splice_best_layer0 = None  # must not be called
    state, metrics = trainer.train(max_steps=7)
    assert state.step == 7 and "eval_abs_rel" in metrics
    with open(tmp_path / "train.jsonl") as f:
        steps = [r["step"] for r in jsonl(f.read()) if "total" in r]
    assert steps == [1, 2, 3, 4, 5, 6, 7]
    owned = freeze_layer0_grad_mask(
        cfg.model, {k: torch.ones_like(v) for k, v in frozen.items()})
    for k, v in state.net.state_dict().items():
        assert torch.equal(v[owned[k] == 0], frozen[k][owned[k] == 0]), k


def test_fresh_start_drops_another_runs_artifacts(tmp_path):
    """A fresh start in a reused directory removes the stale best export
    and does not take its drift baseline from the stale jsonl."""
    cfg = small_cfg(tmp_path, max_steps=2, freeze_layer0_step=4)
    (tmp_path / "best_params.json").write_text('{"step": 9}')
    tckpt.export_params_npz(LDIPredictor(cfg.model).state_dict(),
                            str(tmp_path / "best_params.npz"),
                            meta={"step": 9, "eval_abs_rel": 1e-4})
    (tmp_path / "train.jsonl").write_text(
        json.dumps({"step": 9, "eval_abs_rel": 1e-4}) + "\n")
    _, metrics = ttrainer.Trainer(cfg, device="cpu").train()
    assert metrics["eval_abs_rel_drift"] == 0.0
    assert tckpt.read_params_npz_meta(
        str(tmp_path / "best_params.npz"))["step"] == 2
    assert not (tmp_path / "best_params.json").exists()


def test_trainer_closes_its_streams(tmp_path, monkeypatch):
    """train() stops the threads of both its streams, the training one
    and the eval one, on its way out."""
    made, make = [], ttrainer.make_dataset

    def recorded(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(ttrainer, "make_dataset", recorded)
    cfg = small_cfg(tmp_path, max_steps=2, freeze_layer0_step=4)
    _, metrics = ttrainer.Trainer(cfg, device="cpu").train()
    assert "eval_abs_rel" in metrics and len(made) == 2
    assert not any(p._thread.is_alive() for p in made)


def test_nan_loss_halts_and_dumps_outside_the_checkpoints(tmp_path,
                                                          monkeypatch):
    cfg = small_cfg(tmp_path, max_steps=3, eval_every=0,
                    freeze_layer0_step=0, freeze_layer0_from_best=False)
    create = ttrainer.create_state

    def poisoned(*a, **kw):
        state = create(*a, **kw)
        with torch.no_grad():
            state.net.disp_head.bias.fill_(float("nan"))
        return state

    monkeypatch.setattr(ttrainer, "create_state", poisoned)
    with pytest.raises(FloatingPointError):
        ttrainer.Trainer(cfg, device="cpu").train()
    assert (tmp_path / "nan_debug_params_step1.npz").exists()
    assert tckpt.CheckpointManager(str(tmp_path)).latest_step() is None


CHECKS = {
    "from_best_needs_freeze_step": ({"freeze_layer0_step": 0}, ValueError),
    "from_best_needs_best_export": ({"save_best_params": False}, ValueError),
    "from_best_needs_eval_before_freeze": ({"eval_every": 5}, ValueError),
    "freeze_after_stage": ({"stage_layer0_steps": 5}, ValueError),
    "freeze_after_warmup": ({"freeze_layer0_step": 1}, ValueError),
    "collapse_rollback": ({"collapse_rollback_threshold": 0.1},
                          NotImplementedError),
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_trainer_rejects_bad_schedules(tmp_path, case):
    change, error = CHECKS[case]
    with pytest.raises(error):
        ttrainer.Trainer(small_cfg(tmp_path, **change), device="cpu")


def test_profile_dir_writes_a_trace(tmp_path):
    cfg = small_cfg(tmp_path, max_steps=1, eval_every=0,
                    freeze_layer0_step=0, freeze_layer0_from_best=False,
                    profile_dir=str(tmp_path / "profile"))
    ttrainer.Trainer(cfg, device="cpu").train()
    with open(tmp_path / "profile" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        ttrainer.Trainer(small_cfg(tmp_path))


def test_missing_eval_abs_rel_fails_at_the_first_eval(tmp_path, monkeypatch):
    cfg = small_cfg(tmp_path, max_steps=2)
    from lsi_tpu_torch.evaluation import runner

    def no_depth(cfg):
        step = runner.build_eval_step(cfg)

        def eval_step(net, batch):
            metrics, rgb, ldi = step(net, batch)
            return ({k: v for k, v in metrics.items() if k != "abs_rel"},
                    rgb, ldi)
        return eval_step

    monkeypatch.setattr(ttrainer, "build_eval_step", no_depth)
    with pytest.raises(ValueError, match="eval_abs_rel"):
        ttrainer.Trainer(cfg, device="cpu").train()


# ------------------------------------------------ the params .npz, splice

def test_params_npz_round_trips_between_the_packages(tmp_path):
    """The port's export reads in JAX's import_params_npz, and JAX's export
    in the port's, with the metadata inside in both directions."""
    cfg = toy_quality(get_config)
    net = LDIPredictor(cfg.model)
    net.reset_parameters(torch.Generator().manual_seed(5))
    sd = net.state_dict()
    mine = str(tmp_path / "port.npz")
    tckpt.export_params_npz(sd, mine, meta={"step": 4, "eval_abs_rel": 0.25})
    template = unflatten(jax_from_state_dict(sd))
    template = jax.tree_util.tree_map(jnp.zeros_like, template)
    got = jckpt.import_params_npz(template, mine)
    assert state_dict_from_jax(flat(got), cfg.model).keys() == sd.keys()
    for k, v in state_dict_from_jax(flat(got), cfg.model).items():
        assert torch.equal(v, sd[k]), k
    assert jckpt.read_params_npz_meta(mine) == {"step": 4,
                                                "eval_abs_rel": 0.25}

    theirs = str(tmp_path / "jax.npz")
    jckpt.export_params_npz(got, theirs, meta={"step": 7,
                                               "eval_abs_rel": 0.5})
    back = tckpt.import_params_npz(cfg.model, theirs)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    assert tckpt.read_params_npz_meta(theirs) == {"step": 7,
                                                  "eval_abs_rel": 0.5}


@pytest.mark.parametrize("layer0_from_input", [True, False])
def test_splice_layer0_params_matches_jax(layer0_from_input):
    cfg = dataclasses.replace(toy_quality(get_config).model,
                              layer0_texture_from_input=layer0_from_input)
    jcfg = dataclasses.replace(toy_quality(j_get_config).model,
                               layer0_texture_from_input=layer0_from_input)
    nets = []
    for seed in (1, 2):
        net = LDIPredictor(cfg)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        nets.append(net.state_dict())
    live, best = nets
    got = splice_layer0_params(cfg, live, best)
    want = j_splice_layer0_params(
        jcfg, unflatten(jax_from_state_dict(live)),
        unflatten(jax_from_state_dict(best)))
    want = state_dict_from_jax(flat(want), cfg)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["disp_head.weight"], live["disp_head.weight"])
    assert torch.equal(got["disp_head.weight"][1:],
                       live["disp_head.weight"][1:])


# ------------------------------------------------------- writer and CLI

def test_metric_writer_lines_match_jax(tmp_path):
    for cls, sub in ((MetricWriter, "port"), (JMetricWriter, "jax")):
        w = cls(str(tmp_path / sub))
        w.write(3, {"total": np.float32(0.25), "eval_psnr": 12.5},
                echo=False)
        w.write(4, {"total": 1}, echo=False)
        w.close()
    lines = [jsonl((tmp_path / sub / "train.jsonl").read_text())
             for sub in ("port", "jax")]
    for a, b in zip(*lines):
        a.pop("wall_s")
        b.pop("wall_s")
        assert a == b


OVERRIDES = ["train.max_steps=12", "loss.symmetric=false",
             "loss.consistency_weight=0.25", "data.dataset=synthetic",
             "train.freeze_fallback_live=yes", "model.num_layers=2"]


def test_apply_override_matches_jax():
    cfg, jcfg = get_config("kitti_ldi3_quality"), \
        j_get_config("kitti_ldi3_quality")
    for ov in OVERRIDES:
        cfg, jcfg = apply_override(cfg, ov), j_apply_override(jcfg, ov)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert build_config("kitti_ldi3_quality", OVERRIDES) == cfg


@pytest.mark.parametrize("preset", ["kitti_ldi3_quality", "synthetic_multi"])
def test_quality_presets_pass_the_train_check(preset):
    ttrainer.check_train_config(get_config(preset))


def test_cli_trains_and_evaluates_on_cpu(tmp_path, capsys):
    """python -m lsi_tpu_torch.train --device cpu, then the eval CLI on
    its checkpoint (toy widths; the quality preset's phases)."""
    from lsi_tpu_torch.evaluation.runner import main as eval_main
    sets = ["model.base_filters=8", "model.num_scales=2",
            "data.dataset=synthetic", "data.synthetic_scene=multi",
            "data.height=16", "data.width=32", "data.batch_size=2",
            "train.max_steps=3", "loss.consistency_start_step=1",
            "train.eval_every=1", "train.eval_batches=1",
            "train.freeze_layer0_step=2", "train.checkpoint_every=3",
            "train.log_every=1", f"train.checkpoint_dir={tmp_path}"]
    state, metrics = train_main(["--config=kitti_ldi3_quality", "--device",
                                 "cpu", "--set", *sets])
    assert state.step == 3 and np.isfinite(metrics["total"])
    results = eval_main(["--config=kitti_ldi3_quality", "--device", "cpu",
                         "--num_batches", "1", "--image_dir",
                         str(tmp_path / "img"), "--set", *sets])
    assert "evaluating checkpoint step 3" in capsys.readouterr().out
    assert np.isfinite(results["abs_rel"]) and "occ_psnr" in results
    assert (tmp_path / "img" / "eval_grid.png").exists()
