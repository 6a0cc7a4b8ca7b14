"""The port's training step vs the JAX package's: the learning-rate
schedule and the optimizer against optax, the layer-0 freeze mask, three
train steps (plain, ``stage_layer0``, ``freeze_layer0``) against
``lsi_tpu.train.trainer.make_train_step`` on the CPU, the golden train
fixture, the synthetic data and batches (two-plane and multi-object), and
the options the port refuses.

JAX runs on its lax path (the CPU default); no Pallas kernel runs here.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lsi_tpu.config as jconfig
from lsi_tpu.config import get_config as j_get_config
from lsi_tpu.data import pipeline as jpipe
from lsi_tpu.data import synthetic as jsyn
from lsi_tpu.models.ldi_predictor import LDIPredictor as JLDIPredictor
from lsi_tpu.models.ldi_predictor import \
    freeze_layer0_grad_mask as j_freeze_mask
from lsi_tpu.train import trainer as jtrainer
from lsi_tpu_torch.config import Config, get_config
from lsi_tpu_torch.data import pipeline as tpipe
from lsi_tpu_torch.data import synthetic as tsyn
from lsi_tpu_torch.models.convert import (jax_from_state_dict,
                                          state_dict_from_jax)
from lsi_tpu_torch.models.ldi_predictor import (LDIPredictor,
                                                freeze_layer0_grad_mask)
from lsi_tpu_torch.train import trainer as ttrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_train_toy.npz")
STEPS = 3

# Tolerances of the train-step comparisons, and why.
#
# The splat and the gather have gradients that jump where a projected
# coordinate crosses a pixel edge or a snap-zone edge (MIN_FRACTION), and
# the two frameworks' coordinates differ by ~1e-7 px. JAX disagrees with
# itself by as much: on batch 1 of the golden fixture, at the same params,
# its jitted and eager gradients differ by up to 2.5e-4 (largest gradient
# 3.6e-2; scripts/train_parity_spread.py prints these numbers).
# Adam turns such a difference into a step of up to lr for an entry whose
# gradient is that small, so after the first real update the parameters
# follow slightly different paths. Hence:
# * loss parts: tight while the params are equal (steps 1-2, the first
#   step has lr = 0), looser at step 3;
# * grad_norm: 2e-3 at steps 1-2, 5e-2 at step 3;
# * step-1 gradients: within 2e-4 of the largest gradient (5.68e-2). On
#   the fixture's batch 0 JAX's jit and eager gradients differ by 2.6e-6
#   (4.6e-5 of the largest), the port reads 2.1e-5 of it on the CPU and
#   4.9e-5 on the card; planted faults read 3.8e-2 (the gather's valid
#   cotangent dropped) to 0.65 (the splat loss's gradient dropped);
# * params after 3 steps: every entry within the step sizes' sum (the most
#   Adam moves an entry, with slack), and on average within PARAM_MEAN of
#   the average movement, with the movements' cosine above PARAM_COS.
#   Measured on the CPU: 8.5% and 0.986 on the fixture (the same script).
LOSS_RTOL_SAME_PARAMS = 1e-5
LOSS_RTOL_STEP3 = 2e-3
NORM_RTOL_SAME_PARAMS = 2e-3
NORM_RTOL_STEP3 = 5e-2
GRAD_ATOL_OF_MAX = 2e-4
PARAM_MEAN = 0.2
PARAM_COS = 0.95


def toy_config(get):
    """The toy cut of kitti_ldi3_b16 (scripts/make_torch_golden_train.py)."""
    cfg = get("kitti_ldi3_b16")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, base_filters=8, num_scales=2,
                                  compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, dataset="synthetic", height=32,
                                 width=64, batch_size=2),
        train=dataclasses.replace(cfg.train, warmup_steps=2))


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def unflatten(arrays):
    """{'a/b/c': array} -> the nested Flax tree."""
    tree = {}
    for key, v in arrays.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def state_dict(tree, cfg):
    return state_dict_from_jax(flat(tree), cfg.model)


def torch_batch(arrays) -> tpipe.Batch:
    return tpipe.Batch(**{k: torch.from_numpy(np.asarray(v))
                          for k, v in arrays.items()})


def check_metrics(got, want, step):
    same_params = step < 2
    for k, v in want.items():
        if k == "grad_norm":
            rtol = NORM_RTOL_SAME_PARAMS if same_params else NORM_RTOL_STEP3
        else:
            rtol = LOSS_RTOL_SAME_PARAMS if same_params else LOSS_RTOL_STEP3
        np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol,
                                   atol=1e-7, err_msg=f"{k} at step {step}")


def check_params(got, want, start, lr_sum):
    names = sorted(want)
    diff = torch.cat([(got[k] - want[k]).flatten() for k in names])
    moved = torch.cat([(want[k] - start[k]).flatten() for k in names])
    mine = torch.cat([(got[k] - start[k]).flatten() for k in names])
    assert float(diff.abs().max()) <= 1.5 * lr_sum
    assert float(diff.abs().mean()) <= PARAM_MEAN * float(moved.abs().mean())
    assert float(moved @ mine) >= PARAM_COS * float(moved.norm() * mine.norm())


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("warmup,horizon,end", [(2, 10, 0.1), (500, 0, 0.1),
                                                (0, 6, 0.0)])
def test_lr_schedule_matches_optax(warmup, horizon, end):
    cfg = Config(train=dataclasses.replace(
        Config().train, warmup_steps=warmup, decay_steps=horizon,
        max_steps=12, lr_end_factor=end))
    jcfg = jconfig.Config(train=jconfig.TrainConfig(
        **dataclasses.asdict(cfg.train)))
    mine = ttrainer.make_lr_schedule(cfg)
    ref = jtrainer.make_lr_schedule(jcfg)
    if warmup:  # the first step's lr is 0
        assert mine(0) == 0.0 == float(ref(0))
    for count in range(14):
        # Both evaluate in float32; cos may round differently: 1e-6.
        np.testing.assert_allclose(mine(count), float(ref(count)), rtol=1e-6,
                                   atol=1e-12)


def grads_sequence(rng):
    """Gradients for 6 steps: below the clip norm, above it, a nan step, an
    inf step, then finite again."""
    shapes = {"a": (3, 4), "b": (5,)}
    seq = []
    for scale, bad in ((0.1, None), (5.0, None), (0.1, np.nan),
                       (0.1, np.inf), (0.3, None), (2.0, None)):
        g = {k: (scale * rng.normal(size=s)).astype(np.float32)
             for k, s in shapes.items()}
        if bad is not None:
            g["b"][2] = bad
        seq.append(g)
    return seq


def test_optimizer_matches_optax(rng):
    """Clip above and below the norm, Adam, the schedule, and non-finite
    steps skipped with params and moments bitwise kept."""
    cfg = Config(train=dataclasses.replace(
        Config().train, learning_rate=1e-2, warmup_steps=2, max_steps=8,
        grad_clip_norm=1.0))
    jcfg = jconfig.Config(train=jconfig.TrainConfig(
        **dataclasses.asdict(cfg.train)))
    tx = jtrainer.make_optimizer(jcfg)
    opt = ttrainer.Optimizer(cfg)

    init = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    ts = opt.init(tp)
    for i, g in enumerate(grads_sequence(rng)):
        before = [{k: v.clone() for k, v in d.items()}
                  for d in (tp, ts.mu, ts.nu)]
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        t_upd = opt.update(tg, ts, ttrainer.global_norm(tg))
        if t_upd is not None:
            for k in tp:
                tp[k] = tp[k] + t_upd[k]
        finite = np.isfinite(g["b"]).all()
        assert (t_upd is not None) == finite
        if not finite:  # params and both moments bitwise kept
            for now, then in zip((tp, ts.mu, ts.nu), before):
                for k in tp:
                    assert torch.equal(now[k], then[k])
        adam = js.inner_state[1][0]
        assert ts.count == int(adam.count) == int(js.inner_state[1][1].count)
        assert ts.notfinite_count == int(js.notfinite_count)
        assert ts.total_notfinite == int(js.total_notfinite)
        assert ts.last_finite == bool(js.last_finite)
        for k in tp:
            # Same float32 arithmetic in another order: 1e-6, and an atol
            # for moments that cancel to near 0 (scale ~1e-2 and ~1e-4).
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-8,
                                       err_msg=f"{k} at step {i}")
            np.testing.assert_allclose(ts.mu[k].numpy(),
                                       np.asarray(adam.mu[k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(ts.nu[k].numpy(),
                                       np.asarray(adam.nu[k]), rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("layer0_from_input", [True, False])
def test_freeze_layer0_grad_mask_matches_jax(layer0_from_input):
    cfg = dataclasses.replace(
        toy_config(get_config).model,
        layer0_texture_from_input=layer0_from_input)
    jcfg = dataclasses.replace(toy_config(j_get_config).model,
                               layer0_texture_from_input=layer0_from_input)
    net = LDIPredictor(cfg)
    params = unflatten(jax_from_state_dict(net.state_dict()))
    ones = jax.tree_util.tree_map(jnp.ones_like, params)
    want = state_dict_from_jax(flat(j_freeze_mask(jcfg, ones)), cfg)
    mine_in = {k: torch.ones_like(p) for k, p in net.named_parameters()}
    got = freeze_layer0_grad_mask(cfg, mine_in)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert all(float(v.min()) == 1.0 for v in mine_in.values())


# ----------------------------------------------------------- train step

@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def golden_batches(golden):
    return [{k.split("/", 1)[1]: v for k, v in golden.items()
             if k.startswith(f"batch{i}/")} for i in range(STEPS)]


def golden_start(golden, cfg):
    return state_dict_from_jax(
        {k[len("params/"):]: v for k, v in golden.items()
         if k.startswith("params/")}, cfg.model)


@pytest.mark.parametrize("variant", ["plain", "stage_layer0",
                                     "freeze_layer0"])
def test_train_step_matches_jax(golden, variant):
    """Three steps of each variant from the same params and batches."""
    kw = {} if variant == "plain" else {variant: True}
    jcfg = toy_config(j_get_config)
    cfg = toy_config(get_config)
    batches = golden_batches(golden)
    start = golden_start(golden, cfg)

    # The fixture's initial params are jtrainer.create_state(jcfg, key(0))'s.
    j_state = jtrainer.TrainState.create(
        apply_fn=JLDIPredictor(jcfg.model).apply,
        params=unflatten({k[len("params/"):]: v for k, v in golden.items()
                          if k.startswith("params/")}),
        tx=jtrainer.make_optimizer(jcfg))
    j_step = jtrainer.make_train_step(jcfg, **kw)
    state = ttrainer.create_state(cfg, device="cpu")
    state.net.load_state_dict(start)
    step = ttrainer.make_train_step(cfg, **kw)
    for i, b in enumerate(batches):
        j_state, j_metrics = j_step(j_state, jpipe.Batch(**b))
        state, metrics = step(state, torch_batch(b))
        assert sorted(metrics) == sorted(j_metrics)
        check_metrics(metrics, j_metrics, i)
        if i == 0:  # lr = 0 at the first step: nothing moves, in both.
            for k, p in state.net.state_dict().items():
                assert torch.equal(p, start[k]), k
                np.testing.assert_array_equal(
                    state_dict(j_state.params, cfg)[k], start[k])
    assert state.step == int(j_state.step) == STEPS
    want = state_dict(j_state.params, cfg)
    got = state.net.state_dict()
    lr = ttrainer.make_lr_schedule(cfg)
    check_params(got, want, start, sum(lr(c) for c in range(STEPS)))
    if variant == "freeze_layer0":
        frozen = freeze_layer0_grad_mask(
            cfg.model, {k: torch.ones_like(v) for k, v in got.items()})
        for k in got:  # layer 0's entries are bitwise constant
            keep = frozen[k] == 0
            assert torch.equal(got[k][keep], start[k][keep]), k


def test_golden_train_fixture_on_cpu(golden):
    """The fixture chip_smoke.py holds the CUDA train step to, on the CPU
    path, with the same tolerances."""
    cfg = Config.from_dict(json.loads(bytes(golden["__config__"]).decode()))
    assert cfg == toy_config(get_config)
    start = golden_start(golden, cfg)
    state = ttrainer.create_state(cfg, device="cpu")
    state.net.load_state_dict(start)
    step = ttrainer.make_train_step(cfg)
    grads = ttrainer.loss_and_grads(state, torch_batch(
        golden_batches(golden)[0]), cfg)[1]
    want = state_dict_from_jax(
        {k[len("step1_grads/"):]: v for k, v in golden.items()
         if k.startswith("step1_grads/")}, cfg.model)
    atol = GRAD_ATOL_OF_MAX * max(float(v.abs().max()) for v in want.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    for i, b in enumerate(golden_batches(golden)):
        state, metrics = step(state, torch_batch(b))
        check_metrics(metrics, {k[len("metrics/"):]: v[i]
                                for k, v in golden.items()
                                if k.startswith("metrics/")}, i)
    want = state_dict_from_jax(
        {k[len("step3_params/"):]: v for k, v in golden.items()
         if k.startswith("step3_params/")}, cfg.model)
    lr = ttrainer.make_lr_schedule(cfg)
    check_params(state.net.state_dict(), want, start,
                 sum(lr(c) for c in range(STEPS)))


def test_create_state_defaults_to_cuda():
    """Without ``device`` the state goes to the card; with no card that
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        ttrainer.create_state(toy_config(get_config))


# The options the port once refused, each of which the step now takes:
# the refuted knobs (the EMA teacher, the stop step, photo_layer0_weight),
# the collapse rollback and remat_decoder.
UNPORTED = {
    "ema_teacher": ("loss", {"consistency_ema_teacher": True}),
    "consistency_stop_step": ("loss", {"consistency_stop_step": 10}),
    "collapse_rollback": ("train", {"collapse_rollback_threshold": 0.1}),
    "photo_layer0_weight": ("loss", {"photo_layer0_weight": 0.1}),
    "remat_decoder": ("train", {"remat_decoder": True}),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_train_options_raise(golden, case):
    """The toy kitti_ldi3_b16 step with each option builds and takes the
    golden fixture's first step (lr 0, the params JAX's) with JAX's loss
    parts and gradient norm: on this single-prediction step the teacher
    and the stop step change nothing (as in JAX, the teacher serves the
    two-prediction terms); ``photo_layer0`` adds JAX's layer-0-only
    inverse warp (tests/test_torch_refuted.py holds each knob's own
    step)."""
    section, change = UNPORTED[case]
    cfg = toy_config(get_config)
    cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **change)})
    step = ttrainer.make_train_step(cfg)
    state = ttrainer.create_state(cfg, device="cpu")
    state.net.load_state_dict(golden_start(golden, cfg))
    state, metrics = step(state, torch_batch(golden_batches(golden)[0]))
    want = {k[len("metrics/"):]: v[0] for k, v in golden.items()
            if k.startswith("metrics/")}
    if case == "photo_layer0_weight":
        # JAX's part, from the port's LDI of the same params and batch.
        from lsi_tpu.geometry.ldi import LDI as JLDI
        from lsi_tpu.losses.losses import view_synthesis_inverse_warp
        batch = tpipe.decode_batch(torch_batch(golden_batches(golden)[0]))
        with torch.no_grad():
            ldi = state.net(batch.src_image, batch.intrinsics)
        layer0 = JLDI(*(jnp.asarray(x[:, :1].numpy()) for x in (
            ldi.textures, ldi.disparities)), jnp.asarray(
                ldi.intrinsics.numpy()))
        part = 0.1 * view_synthesis_inverse_warp(
            layer0, jnp.asarray(batch.trg_image.numpy()),
            jnp.asarray(batch.pose_src2trg.numpy()), min_over_layers=False)
        np.testing.assert_allclose(float(metrics.pop("photo_layer0")),
                                   float(part), rtol=LOSS_RTOL_SAME_PARAMS)
        for k in ("total", "grad_norm"):
            del want[k]
    both = {"total", "grad_norm"}
    assert sorted(set(metrics) - both) == sorted(set(want) - both)
    check_metrics({k: v for k, v in metrics.items() if k in want}, want, 0)
    assert state.step == 1


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("seed,epoch,index,h,w", [(0, 0, 0, 32, 64),
                                                  (7, 2, 513, 24, 40),
                                                  (2**33 + 5, 1, 3, 16, 48)])
def test_synthetic_scene_is_byte_identical(seed, epoch, index, h, w):
    mine = tsyn.scene_example("two_plane", seed, epoch, index, h, w)
    ref = jsyn.scene_example("two_plane", seed, epoch, index, h, w)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


@pytest.mark.parametrize("seed,epoch,index,h,w", [(0, 0, 0, 32, 64),
                                                  (7, 2, 513, 24, 40)])
def test_multi_scene_is_byte_identical(seed, epoch, index, h, w):
    mine = tsyn.scene_example("multi", seed, epoch, index, h, w)
    ref = jsyn.scene_example("multi", seed, epoch, index, h, w)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def test_multi_batch_stream_matches_jax():
    cfg = dataclasses.replace(toy_config(get_config).data,
                              synthetic_scene="multi")
    jcfg = dataclasses.replace(toy_config(j_get_config).data,
                               synthetic_scene="multi")
    mine = tpipe.batch_stream(cfg, seed=2, device="cpu")
    ref = jpipe._batch_stream(jcfg, 2, True)
    for _ in range(2):
        a, b = next(mine), next(ref)
        for f in dataclasses.fields(tpipe.Batch):
            np.testing.assert_array_equal(getattr(a, f.name).numpy(),
                                          getattr(b, f.name), err_msg=f.name)


def test_batch_stream_matches_jax():
    cfg = dataclasses.replace(toy_config(get_config).data, batch_size=3)
    jcfg = dataclasses.replace(toy_config(j_get_config).data, batch_size=3,
                               split="val")
    cfg = dataclasses.replace(cfg, split="val")
    mine = tpipe.batch_stream(cfg, seed=4, device="cpu")
    ref = jpipe._batch_stream(jcfg, 4, True)
    for _ in range(2):
        a, b = next(mine), next(ref)
        for f in dataclasses.fields(tpipe.Batch):
            np.testing.assert_array_equal(getattr(a, f.name).numpy(),
                                          getattr(b, f.name), err_msg=f.name)


def test_decode_batch_matches_jax(rng):
    u8 = rng.integers(0, 256, (2, 4, 6, 3), dtype=np.uint8)
    f16 = rng.uniform(size=(2, 4, 6, 1)).astype(np.float16)
    K = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy()
    pose = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    fields = dict(src_image=u8, trg_image=u8[::-1].copy(), intrinsics=K,
                  pose_src2trg=pose, gt_disparity=f16)
    mine = tpipe.decode_batch(torch_batch(fields))
    ref = jpipe.decode_batch(jpipe.Batch(**fields))
    for f in dataclasses.fields(tpipe.Batch):
        want = getattr(ref, f.name)
        got = getattr(mine, f.name)
        if want is None:
            assert got is None
            continue
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unported_data_raises():
    """The datasets read from disk raise where JAX's raise: a KITTI or
    SYNTHIA root with no records, a shard root with no shards
    (FileNotFoundError); an unknown dataset (ValueError)."""
    cfg = toy_config(get_config).data
    jcfg = toy_config(j_get_config).data
    for change in ({"dataset": "kitti"}, {"dataset": "synthia"},
                   {"root": "/nonexistent"}):
        with pytest.raises(FileNotFoundError):
            next(jpipe._batch_stream(dataclasses.replace(jcfg, **change),
                                     0, True))
        with pytest.raises(FileNotFoundError):
            next(tpipe.batch_stream(dataclasses.replace(cfg, **change),
                                    device="cpu"))
    with pytest.raises(ValueError, match="unknown dataset"):
        next(tpipe.batch_stream(dataclasses.replace(cfg, dataset="nope"),
                                device="cpu"))
