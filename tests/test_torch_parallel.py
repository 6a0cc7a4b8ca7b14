"""The port's data-parallel training step over two gloo ranks on the CPU
against its one-process step on the same global batch and JAX's step over
a 2-device mesh plan (``tests/test_train.py::
test_sharded_equals_single_device``'s bounds: loss rtol 1e-5, parameters
rtol 1e-4 / atol 1e-6), for ``photo_mode="both"`` and the quality
recipe's two-prediction graph with its consistency terms (the ratio
losses, whose global value is not a mean of per-rank ratios); and the
data-parallel ``Trainer``: only rank 0 writes, evaluations equal a
one-process run's, every rank resumes.

JAX runs first, in this process; the port's ranks are spawned processes
(``parallel.launch``) that import neither JAX nor this file.
"""

import concurrent.futures
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsi_tpu.config import get_config as j_get_config
from lsi_tpu.data import pipeline as jpipe
from lsi_tpu.models.ldi_predictor import LDIPredictor as JLDIPredictor
from lsi_tpu.parallel.mesh import make_mesh_plan
from lsi_tpu.train import trainer as jtrainer
from lsi_tpu_torch.config import get_config
from lsi_tpu_torch.data.pipeline import Batch
from lsi_tpu_torch.models.convert import (jax_from_state_dict,
                                          state_dict_from_jax)
from lsi_tpu_torch.parallel import launch
from lsi_tpu_torch.parallel.mesh import (ProcessPlan, assert_divisible,
                                         batch_slice)
from lsi_tpu_torch.train import trainer as ttrainer

# Bounds, and why. tests/test_train.py::test_sharded_equals_single_device
# holds 8 devices to 1 at loss rtol 1e-5 and parameters rtol 1e-4 /
# atol 1e-6 after one step, which has lr = 0. Here the step-1 gradients
# are held to that parameter bound, the parameters after step 1 too, and
# the loss parts of both steps at rtol 1e-5. After step 2 (the first real
# update) Adam moves an entry whose gradient is rounding noise (conv biases
# ahead of a GroupNorm, ~1e-9) by up to +-lr whichever sign the noise has,
# so the parameters are held as tests/test_torch_train.py holds them
# (check_params: within the step sizes' sum, and in aggregate). Against
# JAX, grad_norm at step 2 is held at test_torch_train.py's 2e-3: the
# splat and gather gradients jump where a coordinate crosses a pixel edge,
# and the two frameworks' coordinates differ by ulps (ROADMAP H10).
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
JAX_NORM_RTOL = 2e-3
MOVED_LOSS_RTOL = 2e-3
MOVED_NORM_RTOL = 5e-2
PARAM_MEAN = 0.2
PARAM_COS = 0.95
STEPS = 2   # step 1 has lr = 0; step 2 moves the parameters


def toy(get, preset, **loss):
    """A toy cut of ``preset``: 32x64, base_filters 8, 2 scales, float32,
    global batch 4, synthetic multi-object scenes (ground truth in both
    views), warm-up 2 steps."""
    cfg = get(preset)
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, base_filters=8, num_scales=2,
                                  compute_dtype="float32"),
        loss=dataclasses.replace(cfg.loss, **loss),
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 synthetic_scene="multi", height=32,
                                 width=64, batch_size=4),
        train=dataclasses.replace(cfg.train, warmup_steps=2))


CONFIGS = {
    # kitti_ldi3_b16's single prediction, both photometric paths.
    "photo_both": ("kitti_ldi3_b16", {}),
    # The quality recipe's full step: both directions, depth_consistency
    # (disocclusion-only, deep-only, stop-target) and depth_anchor.
    "quality": ("kitti_ldi3_quality", {"consistency_start_step": 0}),
}


def unflatten(arrays):
    tree = {}
    for key, v in arrays.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def one_process(cfg, params, batches):
    state = ttrainer.create_state(cfg, device="cpu")
    state.net.load_state_dict({k: torch.from_numpy(v)
                               for k, v in params.items()})
    step = ttrainer.make_train_step(cfg)
    grads, history, after = None, [], []
    for i, b in enumerate(batches):
        batch = Batch(**{k: torch.from_numpy(v) for k, v in b.items()})
        if i == 0:
            grads = {k: v.numpy() for k, v in
                     ttrainer.loss_and_grads(state, batch, cfg)[1].items()}
        state, m = step(state, batch)
        history.append({k: float(v) for k, v in m.items()})
        after.append({k: v.numpy().copy()
                      for k, v in state.net.state_dict().items()})
    return {"metrics": history, "grads": grads, "params": after}


def check_params(got, want, start, lr_sum):
    """tests/test_torch_train.py's check after real updates."""
    names = sorted(want)
    diff = np.concatenate([(got[k] - want[k]).ravel() for k in names])
    moved = np.concatenate([(want[k] - start[k]).ravel() for k in names])
    mine = np.concatenate([(got[k] - start[k]).ravel() for k in names])
    assert np.abs(diff).max() <= 1.5 * lr_sum
    assert np.abs(diff).mean() <= PARAM_MEAN * np.abs(moved).mean()
    assert moved @ mine >= PARAM_COS * np.linalg.norm(moved) * np.linalg.norm(
        mine)


def jax_two_devices(name, params, batches):
    jcfg = toy(j_get_config, CONFIGS[name][0], **CONFIGS[name][1])
    plan = make_mesh_plan(devices=jax.devices()[:2])
    # Copies: the jitted step donates its state, whose CPU buffers may
    # alias numpy memory.
    state = plan.replicate(jtrainer.TrainState.create(
        apply_fn=JLDIPredictor(jcfg.model).apply,
        params=unflatten(jax_from_state_dict(
            {k: torch.tensor(v) for k, v in params.items()})),
        tx=jtrainer.make_optimizer(jcfg)))
    step = jtrainer.make_train_step(jcfg, plan)
    history = []
    for b in batches:
        state, m = step(state, plan.shard_batch(jpipe.Batch(**b)))
        history.append({k: float(v) for k, v in m.items()})
    return {"metrics": history, "params": flat(jax.device_get(state).params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per config: JAX over 2 devices, the port in one process and on 2
    ranks, from the same parameters and global batches. The ranks of both
    configs are spawned at once, after JAX, while this process takes the
    one-process steps."""
    inputs = {}
    for name, (preset, loss) in CONFIGS.items():
        cfg = toy(get_config, preset, **loss)
        state = ttrainer.create_state(cfg, seed=0, device="cpu")
        params = {k: v.numpy().copy()
                  for k, v in state.net.state_dict().items()}
        stream = jpipe._batch_stream(toy(j_get_config, preset,
                                         **loss).data, 0, True)
        batches = [{k: np.asarray(v) for k, v in
                    dataclasses.asdict(next(stream)).items()
                    if v is not None} for _ in range(STEPS)]
        inputs[name] = (cfg, params, batches,
                        jax_two_devices(name, params, batches))
    with concurrent.futures.ThreadPoolExecutor(len(CONFIGS)) as pool:
        ranks = {name: pool.submit(
            launch.spawn, launch.train_steps, 2, cfg, params, batches,
            init_file=tmp_path_factory.mktemp(name) / "store", device="cpu")
            for name, (cfg, params, batches, _) in inputs.items()}
        one = {name: one_process(cfg, params, batches)
               for name, (cfg, params, batches, _) in inputs.items()}
        ranks = {name: f.result() for name, f in ranks.items()}
    return {name: dict(cfg=cfg, start=params, batches=batches, jax=jax_res,
                       ranks=ranks[name], one=one[name])
            for name, (cfg, params, batches, jax_res) in inputs.items()}


def check_metrics(got, want, norm_rtol=LOSS_RTOL):
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            rtol = norm_rtol if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-7,
                                       err_msg=f"{k} at step {i + 1}")


def lr_sum(cfg):
    lr = ttrainer.make_lr_schedule(cfg)
    return sum(lr(c) for c in range(STEPS))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_ranks_equal_one_process(runs, name):
    """The global batch's loss parts, gradient and update on every rank."""
    r = runs[name]
    one = r["one"]
    for rank in r["ranks"]:
        check_metrics(rank["metrics"], one["metrics"])
        for k, g in one["grads"].items():
            np.testing.assert_allclose(rank["grads"][k], g, **PARAM_TOL,
                                       err_msg=k)
        for k, p in one["params"][0].items():
            np.testing.assert_allclose(rank["params"][0][k], p, **PARAM_TOL,
                                       err_msg=k)
        check_params(rank["params"][-1], one["params"][-1], r["start"],
                     lr_sum(r["cfg"]))
    # Step 2 moved the parameters, and every rank holds the same ones.
    assert max(np.abs(one["params"][-1][k] - p).max()
               for k, p in r["start"].items()) > 1e-5
    p0, p1 = (r["ranks"][i]["params"][-1] for i in (0, 1))
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_ranks_equal_jax_two_devices(runs, name):
    r = runs[name]
    if name == "quality":
        assert {"depth_consistency", "depth_anchor",
                "photo_splat_rev"} <= set(r["jax"]["metrics"][0])
    check_metrics(r["ranks"][0]["metrics"], r["jax"]["metrics"],
                  norm_rtol=JAX_NORM_RTOL)
    want = {k: v.numpy() for k, v in
            state_dict_from_jax(r["jax"]["params"], r["cfg"].model).items()}
    check_params(r["ranks"][0]["params"][-1], want, r["start"],
                 lr_sum(r["cfg"]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_per_share_forward_and_local_gradients(runs, name):
    """One process whose network runs on the ranks' shares
    (``launch.per_share_forward``, the single and the paired forward)
    takes the one-process step; the ranks' own gradients sum to the
    global one."""
    r = runs[name]
    shares = launch.train_steps(ProcessPlan(), r["cfg"], r["start"],
                                r["batches"][:1], net_shares=2)
    check_metrics(shares["metrics"], r["one"]["metrics"][:1])
    for k, g in r["one"]["grads"].items():
        np.testing.assert_allclose(shares["grads"][k], g, **PARAM_TOL,
                                   err_msg=k)
        np.testing.assert_allclose(
            r["ranks"][0]["local_grads"][k] + r["ranks"][1]["local_grads"][k],
            r["ranks"][0]["grads"][k], rtol=1e-6, atol=1e-9, err_msg=k)


def test_batch_shares_and_divisibility():
    plan = ProcessPlan(rank=3, world_size=4, space=1)
    assert batch_slice(8, plan) == slice(6, 8)
    plan = ProcessPlan(rank=3, world_size=4, space=2)   # data index 1 of 2
    assert batch_slice(8, plan) == slice(4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        assert_divisible(6, ProcessPlan(rank=0, world_size=4, space=1))


def toy_trainer_config(checkpoint_dir):
    """tests/test_torch_consistency.py's toy quality recipe (warm-up to 2,
    evals every 2 with the best export, the splice and freeze at 4,
    checkpoints every 3), global batch 2."""
    cfg = toy(get_config, "kitti_ldi3_quality", consistency_start_step=2)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=2), train=dataclasses.replace(
        cfg.train, max_steps=6, eval_every=2, eval_batches=1,
        freeze_layer0_step=4, checkpoint_every=3, log_every=1,
        checkpoint_dir=str(checkpoint_dir)))


def listing(d):
    return sorted(os.path.relpath(os.path.join(root, f), d)
                  for root, _, files in os.walk(d) for f in files)


def jsonl(d):
    with open(os.path.join(d, "train.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    one_dir = tmp_path_factory.mktemp("one")
    two_dir = tmp_path_factory.mktemp("two")
    one = ttrainer.Trainer(toy_trainer_config(one_dir), device="cpu").train()
    cfg = toy_trainer_config(two_dir)
    first = launch.spawn(launch.trainer_run, 2, cfg,
                         init_file=tmp_path_factory.mktemp("s1") / "store",
                         device="cpu")
    files = listing(two_dir)
    lines = jsonl(two_dir)
    resumed = launch.spawn(launch.trainer_run, 2, cfg, 8,
                           init_file=tmp_path_factory.mktemp("s2") / "store",
                           device="cpu")
    return dict(one=one, one_dir=one_dir, first=first, files=files,
                lines=lines, resumed=resumed, two_dir=two_dir)


def test_only_rank0_writes(trainer_runs):
    """The 2-rank run leaves exactly the one-process run's files (the
    checkpoints, the best export, the eval grids, one jsonl), and each
    jsonl line once."""
    r = trainer_runs
    assert r["files"] == listing(r["one_dir"])
    assert {"best_params.npz", "train.jsonl"} <= set(r["files"])
    want = [(ln["step"], sorted(ln)) for ln in jsonl(r["one_dir"])]
    got = [(ln["step"], sorted(ln)) for ln in r["lines"]]
    assert got == want


def test_data_parallel_trainer_tracks_one_process(trainer_runs):
    """Rank 0's losses and evals (on whole batches) follow the one-process
    run's; the parameters by test_torch_train.py's aggregate check."""
    r = trainer_runs
    one_lines = {(ln["step"], "eval_psnr" in ln): ln
                 for ln in jsonl(r["one_dir"])}
    for ln in r["lines"]:
        want = one_lines[(ln["step"], "eval_psnr" in ln)]
        for k, v in ln.items():
            if k in ("wall_s", "steps_per_sec", "frames_per_sec"):
                continue
            # Steps 1-2 see the starting parameters (lr = 0 at step 1);
            # later lines follow parameters that Adam moved apart on
            # noise-level gradients: test_torch_train.py's bounds for its
            # step 3 (loss 2e-3, grad_norm 5e-2).
            same = ln["step"] <= 2 and "eval_psnr" not in ln
            rtol = (LOSS_RTOL if same else
                    MOVED_NORM_RTOL if k == "grad_norm" else MOVED_LOSS_RTOL)
            np.testing.assert_allclose(v, want[k], rtol=rtol, atol=1e-6,
                                       err_msg=f"{k} at step {ln['step']}")
    one_state, _ = r["one"]
    start = {k: v.numpy() for k, v in ttrainer.create_state(
        toy_trainer_config(r["one_dir"]), seed=0,
        device="cpu").net.state_dict().items()}
    cfg = toy_trainer_config(r["one_dir"])
    lr = ttrainer.make_lr_schedule(cfg)
    check_params(r["first"][0]["params"],
                 {k: v.numpy() for k, v in one_state.net.state_dict().items()},
                 start, sum(lr(c) for c in range(cfg.train.max_steps)))


def test_every_rank_resumes(trainer_runs):
    """A second 2-rank call with max_steps 8 restores step 6 on both ranks
    (else their collectives would not pair up), appends steps 7-8, and
    leaves the ranks with the same parameters."""
    r = trainer_runs
    assert [x["step"] for x in r["first"]] == [6, 6]
    assert [x["step"] for x in r["resumed"]] == [8, 8]
    steps = [ln["step"] for ln in jsonl(r["two_dir"])
             if "eval_psnr" not in ln and "total" in ln]
    assert steps == [1, 2, 3, 4, 5, 6, 7, 8]
    p0, p1 = (x["params"] for x in r["resumed"])
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


def test_torchrun_runs_the_data_parallel_cli(tmp_path):
    """``torchrun --standalone --nproc_per_node=2 -m lsi_tpu_torch.train
    --device cpu --dist_backend gloo``: rank 0 alone prints the config and
    the steps, and the run ends at the horizon with its eval, best export
    and checkpoint."""
    import subprocess
    import sys
    sets = ["model.base_filters=8", "model.num_scales=2",
            "model.compute_dtype=float32", "data.dataset=synthetic",
            "data.synthetic_scene=multi", "data.height=16", "data.width=32",
            "data.batch_size=2", "train.max_steps=2", "train.eval_every=2",
            "train.eval_batches=1", "train.log_every=1",
            f"train.checkpoint_dir={tmp_path}"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "lsi_tpu_torch.train",
         "--config=kitti_ldi3_quality", "--device", "cpu",
         "--dist_backend", "gloo", "--set", *sets],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=60,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert out.count("config: ") == 1
    # Step 2's line and its eval's line, once each.
    assert out.count("[step 1]") == 1 and out.count("[step 2]") == 2
    assert "backend gloo" in out and "done at step 2" in out
    assert out.count("eval_psnr=") == 1
    assert sorted(os.listdir(tmp_path)) == [
        "best_params.npz", "checkpoint_00000002.pt", "eval_images",
        "train.jsonl"]
