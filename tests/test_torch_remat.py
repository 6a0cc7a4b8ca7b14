"""``train.remat_decoder`` and the ``highres_b64`` preset in the port.

The remat step (``torch.utils.checkpoint`` around every call of the
network, ``trainer.apply_net``) against the step without it: loss parts,
every gradient and the parameters after two steps within 1e-6, for the
single prediction, the two-prediction (quality) step, the MPI baseline
and the ``stage_layer0`` and ``freeze_layer0`` steps; that it keeps fewer
activations; the remat step against JAX's ``jax.checkpoint`` step on a
toy cut of ``highres_b64`` (``tests/data/torch_golden_remat_toy.npz``,
recorded by ``scripts/make_torch_golden_remat.py``: no JAX train step is
compiled here) at the golden train step's tolerances; every preset passes
the train check and builds; and one ``highres_b64`` step through the
training CLI on a generated KITTI raw tree, its own dataset.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lsi_tpu_torch.config import PRESETS, Config, get_config
from lsi_tpu_torch.data.pipeline import batch_stream, decode_batch
from lsi_tpu_torch.geometry.ldi import LDI
from lsi_tpu_torch.losses.losses import total_loss
from lsi_tpu_torch.models import build_model
from lsi_tpu_torch.models.convert import state_dict_from_jax
from lsi_tpu_torch.train import trainer as ttrainer
from lsi_tpu_torch.train.__main__ import main as train_main
from test_torch_train import check_metrics, check_params, torch_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_remat_toy.npz")
GOLDEN_STEPS = 3
# Same network, same inputs, the forward run twice: the CPU gives the same
# numbers (measured: bitwise); 1e-6 leaves room for a library that picks
# another algorithm for the recompute.
REMAT_ATOL = 1e-6
# The golden train step's bound on the step-1 gradients
# (tests/test_torch_train.py, GRAD_ATOL_OF_MAX).
GRAD_ATOL_OF_MAX = 2e-4
# The loss's gradient with respect to the same LDI in both frameworks:
# the same float32 sums in other orders (measured: 8.7e-7 of the largest).
LDI_GRAD_ATOL_OF_MAX = 1e-5


def toy(preset, remat, **model):
    """``preset`` at toy widths (32x64, base_filters 8, 2 scales, float32,
    batch 2) on multi-object scenes, with ``remat_decoder`` set."""
    cfg = get_config(preset)
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, base_filters=8, num_scales=2,
                                  compute_dtype="float32", **model),
        loss=dataclasses.replace(cfg.loss, consistency_start_step=0),
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 synthetic_scene="multi", height=32,
                                 width=64, batch_size=2),
        train=dataclasses.replace(cfg.train, warmup_steps=2,
                                  remat_decoder=remat))


VARIANTS = {
    "single": ("kitti_ldi3_b16", {}, {}),
    "two_predictions": ("kitti_ldi3_quality", {}, {}),
    "mpi": ("mpi_baseline", {"num_planes": 4}, {}),
    "stage_layer0": ("kitti_ldi3_b16", {}, {"stage_layer0": True}),
    "freeze_layer0": ("kitti_ldi3_quality", {}, {"freeze_layer0": True}),
}


def two_steps(cfg, kw, batches):
    """Step-1 gradients and the metrics and parameters of two steps."""
    state = ttrainer.create_state(cfg, seed=0, device="cpu")
    grads = ttrainer.loss_and_grads(
        state, batches[0], cfg, stage_layer0=kw.get("stage_layer0", False))[1]
    step = ttrainer.make_train_step(cfg, **kw)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return grads, metrics, state.net.state_dict()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_remat_step_equals_the_plain_step(variant):
    preset, model, kw = VARIANTS[variant]
    plain_cfg = toy(preset, False, **model)
    stream = batch_stream(plain_cfg.data, seed=0, device="cpu")
    batches = [next(stream) for _ in range(2)]
    plain = two_steps(plain_cfg, kw, batches)
    remat = two_steps(toy(preset, True, **model), kw, batches)
    for k, g in plain[0].items():
        np.testing.assert_allclose(remat[0][k].numpy(), g.numpy(), rtol=0,
                                   atol=REMAT_ATOL, err_msg=k)
    assert max(float(g.abs().max()) for g in plain[0].values()) > 0
    for got, want in zip(remat[1], plain[1]):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=REMAT_ATOL, err_msg=k)
    for k, p in plain[2].items():
        np.testing.assert_allclose(remat[2][k].numpy(), p.numpy(), rtol=0,
                                   atol=REMAT_ATOL, err_msg=k)


def saved_bytes(cfg):
    """Bytes autograd keeps for the backward of one forward of the network
    (each tensor storage once)."""
    state = ttrainer.create_state(cfg, seed=0, device="cpu")
    batch = decode_batch(next(batch_stream(cfg.data, seed=0, device="cpu")))
    seen = {}

    def pack(t):
        if t.numel():
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ttrainer.apply_net(state.net, batch.src_image, batch.intrinsics,
                           cfg.train.remat_decoder)
    return sum(seen.values())


def test_remat_keeps_fewer_activations():
    """The checkpointed forward keeps none of the network's activations,
    its inputs only: under a tenth of the bytes."""
    plain = saved_bytes(toy("kitti_ldi3_b16", False))
    remat = saved_bytes(toy("kitti_ldi3_b16", True))
    assert remat < 0.1 * plain, (remat, plain)


# --------------------------------------------- against JAX's jax.checkpoint

def highres_toy(get=get_config):
    """scripts/make_torch_golden_remat.py's toy cut of highres_b64."""
    cfg = get("highres_b64")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, base_filters=8, num_scales=2,
                                  compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, dataset="synthetic", height=32,
                                 width=96, batch_size=2),
        train=dataclasses.replace(cfg.train, warmup_steps=2))


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def section(golden, prefix):
    return {k[len(prefix):]: v for k, v in golden.items()
            if k.startswith(prefix)}


def test_remat_fixture_is_the_highres_toy(golden):
    cfg = Config.from_dict(json.loads(bytes(golden["__config__"]).decode()))
    assert cfg == highres_toy()
    assert cfg.train.remat_decoder and cfg.loss.photo_mode == "splat"


def test_remat_step_matches_jax_checkpoint(golden):
    """The port's remat step against JAX's jax.checkpoint step from the
    same params and batches, at the golden train step's tolerances: the
    loss parts of 3 steps, grad_norm after the first, the params after 3
    steps, and the step-1 gradient in its two halves, the loss's gradient
    with respect to JAX's LDI and the checkpointed network's backward of
    JAX's LDI cotangent.

    The step-1 gradient end to end reads 4.3e-3 of the largest entry and
    grad_norm 2.1e-3 from JAX's (measured): the two LDIs are 2e-6 apart,
    and one projected coordinate at the right edge of the 96-pixel image
    falls on the other side of it, where the splat's gradient jumps (JAX's
    own loss at the port's LDI jumps the same way; ROADMAP H10)."""
    cfg = highres_toy()
    start = state_dict_from_jax(section(golden, "params/"), cfg.model)
    state = ttrainer.create_state(cfg, device="cpu")
    state.net.load_state_dict(start)
    batches = [torch_batch(section(golden, f"batch{i}/"))
               for i in range(GOLDEN_STEPS)]

    # The loss's gradient at JAX's LDI.
    b0 = decode_batch(batches[0])
    ldi = {k: torch.from_numpy(v).requires_grad_()
           for k, v in section(golden, "step1_ldi/").items()}
    total = total_loss(LDI(ldi["textures"], ldi["disparities"],
                           b0.intrinsics), b0.trg_image, b0.pose_src2trg,
                       cfg.loss, cfg.render, gt_disparity=b0.gt_disparity,
                       gt_valid=b0.gt_valid)["total"]
    total.backward()
    cot = section(golden, "step1_ldi_grad/")
    atol = LDI_GRAD_ATOL_OF_MAX * max(np.abs(g).max() for g in cot.values())
    for k, g in cot.items():
        np.testing.assert_allclose(ldi[k].grad.numpy(), g, rtol=0, atol=atol,
                                   err_msg=k)
    # The checkpointed network's backward of that cotangent.
    params = dict(state.net.named_parameters())
    pred = ttrainer.apply_net(state.net, b0.src_image, b0.intrinsics,
                              remat=True)
    np.testing.assert_allclose(pred.disparities.detach().numpy(),
                               section(golden, "step1_ldi/")["disparities"],
                               rtol=0, atol=1e-5)
    grads = torch.autograd.grad(
        (pred.textures, pred.disparities), list(params.values()),
        [torch.from_numpy(cot[k]) for k in ("textures", "disparities")])
    want = state_dict_from_jax(section(golden, "step1_net_vjp/"), cfg.model)
    atol = GRAD_ATOL_OF_MAX * max(float(v.abs().max()) for v in want.values())
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=k)

    step = ttrainer.make_train_step(cfg)
    metrics = section(golden, "metrics/")
    for i, b in enumerate(batches):
        state, m = step(state, b)
        assert sorted(m) == sorted(metrics)
        check_metrics(m, {k: v[i] for k, v in metrics.items()
                          if i or k != "grad_norm"}, i)
    lr = ttrainer.make_lr_schedule(cfg)
    check_params(state.net.state_dict(), state_dict_from_jax(
        section(golden, "step3_params/"), cfg.model), start,
        sum(lr(c) for c in range(GOLDEN_STEPS)))


# ----------------------------------------------------- presets and the CLI

@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_preset_passes_the_train_check_and_builds(preset):
    cfg = get_config(preset)
    ttrainer.check_train_config(cfg)
    net = build_model(cfg.model)
    assert sum(p.numel() for p in net.parameters()) > 0


def test_highres_cli_step_on_a_kitti_layout(tmp_path, capsys):
    """python -m lsi_tpu_torch.train --config=highres_b64 with its own
    dataset (KITTI raw, a generated tree) and remat, at toy widths: one
    step, an eval against the LiDAR ground truth and a checkpoint."""
    from lsi_tpu_torch.data import layouts
    layouts.write_kitti_raw(str(tmp_path / "kitti"), drives=2, frames=2,
                            hw=(24, 80))
    sets = ["model.base_filters=8", "model.num_scales=2", "data.height=32",
            "data.width=96", "data.batch_size=2", "train.max_steps=1",
            "train.eval_every=1", "train.eval_batches=1",
            f"data.root={tmp_path / 'kitti'}",
            f"train.checkpoint_dir={tmp_path / 'ckpt'}"]
    state, metrics = train_main(["--config=highres_b64", "--device", "cpu",
                                 "--set", *sets])
    out = capsys.readouterr().out
    assert "remat_decoder=True" in out and "dataset='kitti'" in out
    assert state.step == 1 and np.isfinite(metrics["photo_splat"])
    assert np.isfinite(metrics["eval_abs_rel"])
    assert (tmp_path / "ckpt" / "checkpoint_00000001.pt").exists()
