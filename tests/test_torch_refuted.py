"""The training knobs ``loss.consistency_ema_teacher``,
``loss.consistency_stop_step``, ``loss.photo_layer0_weight`` and
``model.deep_heads_stopgrad_trunk`` against the JAX package.

Model level, directly against JAX's functions: the deep-heads predictor's
forward and its pullback, its layer-0 partition (freeze mask, splice) and
its weights through both packages' files. Step level, against
tests/data/torch_golden_refuted_toy.npz (recorded by
scripts/make_torch_golden_refuted.py: JAX's Trainer and train step never
run here): the EMA teacher's Trainer run (the warm-up gating both teacher
terms, the ramp, the teacher's targets), the stop step's Trainer run (with
``photo_layer0``), and the deep-heads step, whose trunk takes exactly no
gradient from deep-layer terms. The loss-level cases of the teacher and
``photo_layer0`` are in tests/test_torch_consistency.py and
tests/test_torch_losses.py.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from lsi_tpu import api as japi
from lsi_tpu.config import get_config as j_get_config
from lsi_tpu.models.ldi_predictor import LDIPredictor as JLDIPredictor
from lsi_tpu.train import checkpoint as jckpt
from lsi_tpu.models.ldi_predictor import \
    freeze_layer0_grad_mask as j_freeze_mask
from lsi_tpu.models.ldi_predictor import \
    splice_layer0_params as j_splice_layer0_params
from lsi_tpu_torch.api import LSIModel
from lsi_tpu_torch.config import Config, get_config
from lsi_tpu_torch.models.convert import (jax_from_state_dict,
                                          state_dict_from_jax)
from lsi_tpu_torch.models.ldi_predictor import (LDIPredictor,
                                                freeze_layer0_grad_mask,
                                                splice_layer0_params)
from lsi_tpu_torch.train import checkpoint as tckpt
from lsi_tpu_torch.train import trainer as ttrainer
from test_torch_train import (GRAD_ATOL_OF_MAX, check_metrics, check_params,
                              flat, torch_batch, unflatten)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_refuted_toy.npz")
STEPS = 4
DEEP_STEPS = 3
# The modules layer 0's output reads in the deep-heads model: the trunk
# and layer 0's own heads.
LAYER0_MODULES = ("unet", "disp_head", "tex_head")


def toy_refuted(get, run):
    """scripts/make_torch_golden_refuted.py's configs (either package's
    ``get_config``)."""
    cfg = get("kitti_ldi3_quality")
    model = dataclasses.replace(cfg.model, base_filters=8, num_scales=2,
                                compute_dtype="float32")
    loss = dataclasses.replace(cfg.loss, consistency_start_step=0)
    if run == "teacher":
        loss = dataclasses.replace(loss, consistency_ema_teacher=True,
                                   consistency_start_step=1)
    elif run == "stop":
        loss = dataclasses.replace(loss, consistency_stop_step=2,
                                   photo_layer0_weight=0.1)
    else:
        model = dataclasses.replace(model, deep_heads_stopgrad_trunk=True)
    if run == "deep_only":
        loss = dataclasses.replace(
            loss, photo_mode="inverse_warp", inverse_warp_weight=0.0,
            smoothness_weight=0.0, symmetric=False,
            consistency_anchor_weight=0.0, consistency_weight=1.0,
            consistency_deep_only=True, consistency_stop_target=True)
    return dataclasses.replace(
        cfg, model=model, loss=loss,
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 synthetic_scene="multi", height=32,
                                 width=64, batch_size=2),
        train=dataclasses.replace(cfg.train, warmup_steps=2,
                                  max_steps=STEPS, eval_every=0,
                                  freeze_layer0_step=0,
                                  freeze_layer0_from_best=False,
                                  checkpoint_every=100, log_every=1))


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def section(golden, prefix):
    return {k[len(prefix):]: v for k, v in golden.items()
            if k.startswith(prefix)}


def state_of(golden, run, key, model_cfg):
    return state_dict_from_jax(section(golden, f"{run}/{key}/"), model_cfg)


def jsonl(golden, run):
    return [json.loads(line) for line in
            bytes(golden[f"{run}/jsonl"]).decode().splitlines() if line]


def run_trainer(golden, run, tmp_path):
    """The port's Trainer over the fixture's run, from its initial
    parameters (the teacher a copy of them) and the same data stream."""
    cfg = toy_refuted(get_config, run)
    assert cfg == Config.from_dict(json.loads(bytes(
        golden[f"{run}/__config__"]).decode()))
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path)))
    start = state_of(golden, run, "params", cfg.model)
    create = ttrainer.create_state

    def create_from_fixture(cfg, seed=0, device="cuda"):
        state = create(cfg, seed, device)
        state.net.load_state_dict(start)
        if state.ema_params is not None:
            state.ema_params = ttrainer.ema_copy(state)
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer, "create_state", create_from_fixture)
        state, _ = ttrainer.Trainer(cfg, device="cpu").train()
    with open(tmp_path / "train.jsonl") as f:
        lines = [json.loads(line) for line in f]
    return cfg, start, state, lines


def check_lines(got, want):
    """The same steps and keys; the loss parts at the golden train
    tolerances (tight while the params are equal: steps 1-2), grad_norm
    while the params are equal. After real updates the two runs' params
    differ slightly (ROADMAP H10), and the teacher run's gradient is steep
    there: at step 4 JAX's grad_norm reads 1.0617 and the port's 0.7639,
    while at JAX's own step-4 params and teacher the port's reads 1.0632."""
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), g["step"]
        skip = {"step", "steps_per_sec", "frames_per_sec", "wall_s"}
        if i >= 2:
            skip.add("grad_norm")
        check_metrics(g, {k: v for k, v in w.items() if k not in skip}, i)


def lr_sum(cfg, steps):
    lr = ttrainer.make_lr_schedule(cfg)
    return sum(lr(c) for c in range(steps))


# ------------------------------------------------------------ the model

def deep_net(golden):
    cfg = toy_refuted(get_config, "deep")
    net = LDIPredictor(cfg.model)
    net.load_state_dict(state_of(golden, "deep", "params", cfg.model))
    return cfg, net


def test_deep_heads_model_matches_jax(golden):
    """The forward from the same weights: float32 convolutions summed in
    other orders (1e-5). (The pullback through the detached trunk is held
    by the step-level tests below.)"""
    _, net = deep_net(golden)
    jcfg = toy_refuted(j_get_config, "deep")
    params = unflatten(section(golden, "deep/params/"))
    rng = np.random.default_rng(3)
    image = rng.uniform(size=(2, 32, 64, 3)).astype(np.float32)
    K = np.tile(np.array([[30.0, 0, 31.5], [0, 30.0, 15.5], [0, 0, 1]],
                         np.float32), (2, 1, 1))
    out = jax.jit(JLDIPredictor(jcfg.model).apply)({"params": params},
                                                   image, K)
    with torch.no_grad():
        ldi = net(torch.from_numpy(image), torch.from_numpy(K))
    for name in ("textures", "disparities"):
        np.testing.assert_allclose(getattr(ldi, name).numpy(),
                                   np.asarray(getattr(out, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert {k.split(".")[0] for k, _ in net.named_parameters()} == {
        "unet", "deep_trunk", "disp_head", "disp_head_deep",
        "tex_head", "tex_head_deep"}


@pytest.mark.parametrize("layer0_from_input", [True, False])
def test_deep_heads_partition_matches_jax(layer0_from_input):
    """The freeze mask and the splice of the deep-heads model: the trunk
    and layer 0's heads whole, the deep branch not at all."""
    def model(get):
        return dataclasses.replace(
            toy_refuted(get, "deep").model,
            layer0_texture_from_input=layer0_from_input)

    cfg, jcfg = model(get_config), model(j_get_config)
    nets = []
    for seed in (1, 2):
        net = LDIPredictor(cfg)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        nets.append(net.state_dict())
    live, best = nets
    ones = {k: torch.ones_like(v) for k, v in live.items()}
    mask = freeze_layer0_grad_mask(cfg, ones)
    j_mask = state_dict_from_jax(flat(j_freeze_mask(
        jcfg, unflatten(jax_from_state_dict(ones)))), cfg)
    spliced = splice_layer0_params(cfg, live, best)
    j_spliced = state_dict_from_jax(flat(j_splice_layer0_params(
        jcfg, unflatten(jax_from_state_dict(live)),
        unflatten(jax_from_state_dict(best)))), cfg)
    for k in live:
        assert torch.equal(mask[k], j_mask[k]), k
        assert torch.equal(spliced[k], j_spliced[k]), k
        owned = k.split(".")[0] in LAYER0_MODULES
        assert bool((mask[k] == 0).all()) == owned, k
        assert bool((mask[k] == 1).all()) == (not owned), k
    if not layer0_from_input:
        assert "tex_head.weight" in live


def test_deep_heads_weights_round_trip_with_jax(tmp_path):
    """A deep-heads model through JAX's LSIModel.save -> the port's load
    and save (the same file format, every array bitwise) and the port's
    params export -> JAX's import_params_npz (every array bitwise)."""
    jcfg = toy_refuted(j_get_config, "deep")
    with np.load(GOLDEN) as g:
        params = unflatten(section(g, "deep/params/"))
    theirs = str(tmp_path / "jax.npz")
    japi.LSIModel(jcfg, params).save(theirs)
    model = LSIModel.load(theirs, device="cpu")
    assert model.config == toy_refuted(get_config, "deep")
    mine = str(tmp_path / "port.npz")
    model.save(mine)
    with np.load(theirs) as a, np.load(mine) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    exported = str(tmp_path / "export.npz")
    tckpt.export_params_npz(model.net.state_dict(), exported)
    back = flat(jckpt.import_params_npz(params, exported))
    want = flat(params)
    assert {"deep_trunk/kernel", "disp_head_deep/kernel",
            "tex_head_deep/kernel"} <= set(back)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


# ------------------------------------------------------------- the steps

def test_ema_teacher_trainer_matches_jax(golden, tmp_path):
    """The teacher run: the warm-up step gates both teacher terms (no
    depth_consistency, no depth_anchor at step 1), then the teacher's
    targets; the parameters and the teacher after 4 steps."""
    cfg, start, state, lines = run_trainer(golden, "teacher", tmp_path)
    want = jsonl(golden, "teacher")
    check_lines(lines, want)
    assert ["depth_anchor" in r for r in lines] == [False, True, True, True]
    total = lr_sum(cfg, STEPS)
    check_params(state.net.state_dict(),
                 state_of(golden, "teacher", "final", cfg.model), start,
                 total)
    check_params(state.ema_params,
                 state_of(golden, "teacher", "ema", cfg.model), start, total)


def test_ema_teacher_follows_the_ramp(golden):
    """After each step's update the teacher is ema * d + params * (1 - d),
    d = min(decay, (t + 1) / (t + 10)) at the step count t before it,
    bitwise, from a teacher that starts as a copy of the parameters."""
    cfg = toy_refuted(get_config, "teacher")
    state = ttrainer.create_state(cfg, device="cpu")
    state.net.load_state_dict(state_of(golden, "teacher", "params",
                                       cfg.model))
    state.ema_params = ttrainer.ema_copy(state)
    step = ttrainer.make_train_step(cfg)
    batches = [torch_batch(section(golden, f"deep/batch{i}/"))
               for i in range(DEEP_STEPS)]
    assert [ttrainer.ema_decay(cfg, t) for t in range(3)] == [
        float(np.float32(1) / np.float32(10)),
        float(np.float32(2) / np.float32(11)),
        float(np.float32(3) / np.float32(12))]
    assert ttrainer.ema_decay(cfg, 10**6) == float(np.float32(0.999))
    for t, batch in enumerate(batches):
        before = {k: v.clone() for k, v in state.ema_params.items()}
        state, metrics = step(state, batch)
        assert "depth_consistency" in metrics
        d = ttrainer.ema_decay(cfg, t)
        keep = float(np.float32(1) - np.float32(d))
        for k, p in state.net.named_parameters():
            assert torch.equal(state.ema_params[k],
                               before[k] * d + p.detach() * keep), k
    moved = [not torch.equal(state.ema_params[k], p)
             for k, p in state.net.named_parameters()]
    assert any(moved)


def test_stop_step_trainer_matches_jax(golden, tmp_path):
    """The stop run: the pseudo-label term at steps 1-2, dropped from the
    stop step on (the anchor kept), and photo_layer0 both ways at every
    step; the parameters after 4 steps."""
    cfg, start, state, lines = run_trainer(golden, "stop", tmp_path)
    check_lines(lines, jsonl(golden, "stop"))
    assert ["depth_consistency" in r for r in lines] == [True, True, False,
                                                         False]
    assert all("photo_layer0" in r and "photo_layer0_rev" in r
               for r in lines)
    check_params(state.net.state_dict(),
                 state_of(golden, "stop", "final", cfg.model), start,
                 lr_sum(cfg, STEPS))


def test_deep_heads_step_matches_jax(golden):
    """The deep-heads model's step-1 gradients within the golden train
    step's 2e-4 of the largest, and 3 steps of make_train_step."""
    cfg = toy_refuted(get_config, "deep")
    start = state_of(golden, "deep", "params", cfg.model)
    state = ttrainer.create_state(cfg, device="cpu")
    state.net.load_state_dict(start)
    batches = [torch_batch(section(golden, f"deep/batch{i}/"))
               for i in range(DEEP_STEPS)]
    grads = ttrainer.loss_and_grads(state, batches[0], cfg)[1]
    want = state_of(golden, "deep", "step1_grads", cfg.model)
    atol = GRAD_ATOL_OF_MAX * max(float(v.abs().max()) for v in want.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    step = ttrainer.make_train_step(cfg)
    metrics_want = section(golden, "deep/metrics/")
    for i, b in enumerate(batches):
        state, metrics = step(state, b)
        assert sorted(metrics) == sorted(metrics_want)
        check_metrics(metrics, {k: v[i] for k, v in metrics_want.items()}, i)
    check_params(state.net.state_dict(),
                 state_of(golden, "deep", "final", cfg.model), start,
                 lr_sum(cfg, DEEP_STEPS))


def test_deep_terms_leave_the_trunk_without_gradient(golden):
    """Under a loss of deep-layer terms alone (the pseudo-label with its
    source layer 0 and target detached), the trunk and layer 0's heads get
    exactly 0 in both packages, and the deep branch JAX's gradient."""
    cfg = toy_refuted(get_config, "deep_only")
    state = ttrainer.create_state(cfg, device="cpu")
    state.net.load_state_dict(state_of(golden, "deep", "params", cfg.model))
    batch = torch_batch(section(golden, "deep/batch0/"))
    grads = ttrainer.loss_and_grads(state, batch, cfg)[1]
    want = state_of(golden, "deep", "deep_only_grads", cfg.model)
    atol = GRAD_ATOL_OF_MAX * max(float(v.abs().max()) for v in want.values())
    for k, g in grads.items():
        if k.split(".")[0] in LAYER0_MODULES:
            assert not g.abs().any() and not want[k].abs().any(), k
        else:
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                       atol=atol, err_msg=k)
    assert grads["deep_trunk.weight"].abs().max() > 0
    assert grads["disp_head_deep.weight"].abs().max() > 0


def test_freeze_must_follow_the_stop_step(tmp_path):
    """The freeze is the last phase: before the stop step it raises, as
    JAX's Trainer does; at or after it the freeze step drops the
    pseudo-label too."""
    cfg = toy_refuted(get_config, "stop")
    bad = cfg.replace(train=dataclasses.replace(
        cfg.train, freeze_layer0_step=1, checkpoint_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="consistency_stop_step"):
        ttrainer.Trainer(bad, device="cpu")
    ok = cfg.replace(train=dataclasses.replace(
        cfg.train, freeze_layer0_step=3, checkpoint_dir=str(tmp_path)))
    trainer = ttrainer.Trainer(ok, device="cpu")
    assert [trainer.phase(s) for s in range(5)] == [
        "full", "full", "stop", "freeze", "freeze"]
