"""The port's collapse rollback (``train.collapse_rollback_threshold``),
the counterpart of ``lsi_tpu.train.trainer.Trainer._maybe_rollback``: its
preconditions (JAX's ValueErrors), the restore of every parameter from
``best_params.npz`` with a fresh optimizer, the budget and what happens
when it is spent or no export exists yet, the checkpoint taken at once
after a rollback, and the run stamp that tells a reused directory from an
early crash of the same run. The collapse is forced
(``parallel.launch.force_collapse``: one eval's abs_rel raised by 1).

JAX's Trainer (orbax, the prefetch thread) stays out of tier-1; its
rollback is read from ``lsi_tpu/train/trainer.py:394-405, 574-637``. The
data-parallel rollback runs in ``tests/test_torch_parallel.py``'s spawn.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses
import json

import pytest
import torch

from lsi_tpu_torch.config import get_config
from lsi_tpu_torch.parallel.launch import force_collapse
from lsi_tpu_torch.train import checkpoint as tckpt
from lsi_tpu_torch.train import trainer as ttrainer


def rollback_cfg(tmp_path, **train):
    """A toy kitti_ldi3_b16 (16x32, base_filters 8, float32, batch 2, on
    multi-object scenes, which carry ground-truth depth) with evals every
    2 steps and the rollback on."""
    cfg = get_config("kitti_ldi3_b16")
    t = dict(max_steps=4, eval_every=2, eval_batches=1, log_every=1,
             warmup_steps=2, checkpoint_every=100,
             collapse_rollback_threshold=0.05,
             checkpoint_dir=str(tmp_path))
    t.update(train)
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, base_filters=8, num_scales=2,
                                  compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 synthetic_scene="multi", height=16,
                                 width=32, batch_size=2),
        train=dataclasses.replace(cfg.train, **t))


def run(cfg, collapse=None, max_steps=None):
    trainer = ttrainer.Trainer(cfg, device="cpu")
    if collapse is not None:
        force_collapse(trainer, *collapse)
    return trainer.train(max_steps)


def npz_params(cfg):
    return tckpt.import_params_npz(cfg.model, str(
        f"{cfg.train.checkpoint_dir}/best_params.npz"))


def jsonl(tmp_path):
    with open(tmp_path / "train.jsonl") as f:
        return [json.loads(line) for line in f]


def rollback_count(tmp_path):
    with open(tmp_path / "rollback_state.json") as f:
        return json.load(f)["count"]


PRECONDITIONS = {
    "needs_best_export": ({"save_best_params": False}, "save_best_params"),
    "needs_evals": ({"eval_every": 0}, "eval_every > 0"),
    "needs_drift_monitor": ({"drift_warn_threshold": 0.0},
                            "drift_warn_threshold > 0"),
}


@pytest.mark.parametrize("case", sorted(PRECONDITIONS))
def test_rollback_preconditions_raise_as_jax(tmp_path, case):
    """JAX's three ValueErrors (``lsi_tpu/train/trainer.py:394-405``),
    raised when the Trainer is built."""
    change, match = PRECONDITIONS[case]
    with pytest.raises(ValueError, match=match):
        ttrainer.Trainer(rollback_cfg(tmp_path, **change), device="cpu")


def test_rollback_restores_the_best_export_and_reinits_the_optimizer(
        tmp_path, capsys):
    """The eval at step 2 exports; the forced collapse at step 4 restores
    every parameter from that export bitwise, zeroes the optimizer (its
    count too: the warmup replays), checkpoints step 4 at once with the
    restored state, and charges the budget."""
    cfg = rollback_cfg(tmp_path)
    state, metrics = run(cfg, collapse=(4, 1.0))
    assert metrics["rollback"] == 1.0 and metrics["eval_abs_rel_drift"] > 0.9
    assert tckpt.read_params_npz_meta(
        str(tmp_path / "best_params.npz"))["step"] == 2
    best = npz_params(cfg)
    for k, p in state.net.named_parameters():
        assert torch.equal(p.detach(), best[k]), k
    opt = state.opt_state
    assert opt.count == 0 and opt.notfinite_count == 0
    assert all(not v.any() for v in list(opt.mu.values())
               + list(opt.nu.values()))
    assert [ln.get("rollback") for ln in jsonl(tmp_path)
            if "eval_psnr" in ln] == [None, 1.0]
    saved = tckpt.CheckpointManager(str(tmp_path)).restore(
        ttrainer.create_state(cfg, seed=3, device="cpu"))
    assert saved.step == 4 and saved.opt_state.count == 0
    for k, p in saved.net.named_parameters():
        assert torch.equal(p.detach(), best[k]), k
    assert rollback_count(tmp_path) == 1
    out = capsys.readouterr().out
    assert "[rollback]" in out and "(step 2, eval_abs_rel" in out
    assert "rollback 1/2" in out


def test_training_goes_on_from_the_restored_state(tmp_path):
    """After the rollback the schedule starts again: the next step has lr
    0, so the parameters stay the export's, and the step after moves
    them."""
    cfg = rollback_cfg(tmp_path, max_steps=6)
    trainer = ttrainer.Trainer(cfg, device="cpu")
    force_collapse(trainer, 4, 1.0)
    seen, best = [], {}
    step_fn = trainer.run_step

    def spy(phase, state, batch):
        if state.step == 4:   # the export the rollback restored
            best.update(npz_params(cfg))
        state, m = step_fn(phase, state, batch)
        seen.append({k: p.detach().clone()
                     for k, p in state.net.named_parameters()})
        return state, m

    trainer.run_step = spy
    trainer.train()
    assert all(torch.equal(seen[4][k], best[k]) for k in best)   # step 5
    assert any(not torch.equal(seen[5][k], best[k]) for k in best)


def test_spent_budget_continues_without_rollback(tmp_path, capsys):
    """With collapse_max_rollbacks=1 a second collapse is reported and the
    run continues on its live parameters; the budget stays at 1."""
    cfg = rollback_cfg(tmp_path, max_steps=6, collapse_max_rollbacks=1)
    trainer = ttrainer.Trainer(cfg, device="cpu")
    force_collapse(trainer, 4, 1.0)
    force_collapse(trainer, 6, 1.0)
    state, metrics = trainer.train()
    assert "rollback" not in metrics and rollback_count(tmp_path) == 1
    best = npz_params(cfg)
    assert any(not torch.equal(p.detach(), best[k])
               for k, p in state.net.named_parameters())
    assert "rollback budget (1) is spent" in capsys.readouterr().out


def test_budget_survives_a_resume(tmp_path, capsys):
    """The budget is read from rollback_state.json by a resumed run."""
    cfg = rollback_cfg(tmp_path, collapse_max_rollbacks=1)
    run(cfg, collapse=(4, 1.0))
    state, metrics = run(cfg, collapse=(6, 1.0), max_steps=6)
    assert state.step == 6 and "rollback" not in metrics
    assert "budget (1) is spent" in capsys.readouterr().out


def test_no_export_yet_continues(tmp_path, monkeypatch, capsys):
    """A collapse with no best_params.npz to go back to is reported, and
    the run goes on unchanged."""
    monkeypatch.setattr(ttrainer.Trainer, "_maybe_export_best",
                        lambda self, state, step, out: None)
    cfg = rollback_cfg(tmp_path)
    state, metrics = run(cfg, collapse=(4, 1.0))
    assert "rollback" not in metrics and state.opt_state.count == 4
    assert not (tmp_path / "rollback_state.json").exists()
    assert "no best_params.npz exists yet" in capsys.readouterr().out


def crash_now(*args):
    raise KeyboardInterrupt("crash")


def test_a_crash_after_the_rollback_resumes_the_restored_state(tmp_path):
    """The rollback's checkpoint is written before anything else can
    fail: a crash at the next step resumes at step 4 with the restored
    parameters and the budget charged once."""
    cfg = rollback_cfg(tmp_path, max_steps=6)
    trainer = ttrainer.Trainer(cfg, device="cpu")
    force_collapse(trainer, 4, 1.0)
    step_fn = trainer.run_step

    def crash(phase, state, batch):
        return (crash_now if state.step == 4 else step_fn)(phase, state,
                                                            batch)

    trainer.run_step = crash
    with pytest.raises(KeyboardInterrupt):
        trainer.train()
    restored = tckpt.CheckpointManager(str(tmp_path)).restore(
        ttrainer.create_state(cfg, seed=3, device="cpu"))
    assert restored.step == 4 and restored.opt_state.count == 0
    best = npz_params(cfg)
    assert all(torch.equal(p.detach(), best[k])
               for k, p in restored.net.named_parameters())
    assert rollback_count(tmp_path) == 1


def test_early_crash_keeps_the_runs_own_files(tmp_path, capsys):
    """A run that exported and crashed before its first checkpoint starts
    again from step 0 in a directory stamped with its own config: its
    best export and budget stay (ADVICE r5). A run of another config in
    that directory removes them."""
    cfg = rollback_cfg(tmp_path, max_steps=6)
    trainer = ttrainer.Trainer(cfg, device="cpu")
    step_fn = trainer.run_step

    def crash(phase, state, batch):
        return (crash_now if state.step == 3 else step_fn)(phase, state,
                                                            batch)

    trainer.run_step = crash
    with pytest.raises(KeyboardInterrupt):
        trainer.train()
    assert tckpt.CheckpointManager(str(tmp_path)).latest_step() is None
    (tmp_path / "rollback_state.json").write_text('{"count": 1}')
    exported = (tmp_path / "best_params.npz").read_bytes()

    again = ttrainer.Trainer(cfg, device="cpu")
    again.run_step = crash_now
    with pytest.raises(KeyboardInterrupt):
        again.train()
    assert (tmp_path / "best_params.npz").read_bytes() == exported
    assert rollback_count(tmp_path) == 1
    assert "keeping its best export" in capsys.readouterr().out

    other = rollback_cfg(tmp_path, max_steps=6, learning_rate=1e-3)
    assert ttrainer.run_stamp(other) != ttrainer.run_stamp(cfg)
    assert ttrainer.run_stamp(rollback_cfg(tmp_path, max_steps=9)) == \
        ttrainer.run_stamp(cfg)
    again = ttrainer.Trainer(other, device="cpu")
    again.run_step = crash_now
    with pytest.raises(KeyboardInterrupt):
        again.train()
    assert not (tmp_path / "best_params.npz").exists()
    assert not (tmp_path / "rollback_state.json").exists()


def test_rollback_needs_eval_abs_rel(tmp_path, monkeypatch):
    """As JAX: an eval without ground-truth depth fails at once when the
    rollback is on (its signal is eval_abs_rel's drift)."""
    from lsi_tpu_torch.evaluation import runner

    def no_depth(cfg):
        step = runner.build_eval_step(cfg)

        def eval_step(net, batch):
            metrics, rgb, ldi = step(net, batch)
            return ({k: v for k, v in metrics.items() if k != "abs_rel"},
                    rgb, ldi)
        return eval_step

    monkeypatch.setattr(ttrainer, "build_eval_step", no_depth)
    with pytest.raises(ValueError,
                       match="collapse_rollback_threshold requires"):
        run(rollback_cfg(tmp_path))
