"""Run a function on several spawned ranks, and the rank programs that the
multi-process tests and ``chip_smoke.py`` run.

``spawn(fn, world_size, *args, init_file=...)`` starts ``world_size``
processes with the ``spawn`` start method (a child imports this module
afresh: nothing of its parent, JAX included, is inherited), builds each
one's :class:`~lsi_tpu_torch.parallel.mesh.ProcessPlan` through a file
store (``init_file``, so concurrent runs never share a port), calls
``fn(plan, *args)`` and returns the ranks' results in rank order. Any
rank's exception, crash or overrun fails the call; every child is joined
or killed before it returns. Results travel as pickles: keep them numpy
arrays and plain values.

The programs below take numpy inputs and return numpy outputs, so a test
can feed them the arrays it fed the JAX package.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Callable, Dict, List

import numpy as np
import torch

from lsi_tpu_torch.device import resolve_device
from lsi_tpu_torch.parallel.mesh import destroy, make_process_plan

#: Seconds a spawned run may take, and a collective may wait, by default.
DEFAULT_TIMEOUT_S = 60


def _child(fn, rank, world_size, init_file, kw, args, results):
    try:
        torch.set_num_threads(1)
        plan = make_process_plan(rank=rank, world_size=world_size,
                                 init_method="file://" + str(init_file), **kw)
        try:
            out = fn(plan, *args)
        finally:
            destroy(plan)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world_size: int, *args, init_file,
          device="cuda", backend="gloo", space: int = 1,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List:
    """``[fn(plan_r, *args) for r in range(world_size)]``, each on its own
    spawned rank; raises RuntimeError if a rank fails, dies or is not done
    within ``timeout_s`` (which also bounds each collective). The ranks
    run on the card unless ``device="cpu"`` is asked for; with no CUDA
    device the call raises before it starts a process."""
    device = str(resolve_device(device))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    kw = dict(device=device, backend=backend, space=space,
              timeout_s=timeout_s)
    procs = [ctx.Process(target=_child, args=(fn, r, world_size, init_file,
                                              kw, args, results),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: Dict[int, object] = {}
    errors = []
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) + len(errors) < world_size:
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    # Give the others' reports a moment, then stop.
                    time.sleep(1.0)
                    while not results.empty():
                        rank, ok, out = results.get()
                        (got.__setitem__(rank, out) if ok
                         else errors.append(f"rank {rank}:\n{out}"))
                    errors.append(f"a rank died (exit codes "
                                  f"{[p.exitcode for p in procs]})")
                    break
                if time.monotonic() > deadline:
                    errors.append(f"not done within {timeout_s} s")
                    break
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if errors:
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
    return [got[r] for r in range(world_size)]


# ------------------------------------------------------------ programs

def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters in this process."""
    from lsi_tpu_torch.kernels import gather_cuda, splat_cuda
    return {"splat_fwd": splat_cuda.splat.launches,
            "splat_vjp": splat_cuda.splat_vjp.launches,
            "gather_fwd": gather_cuda.gather_fwd.launches,
            "gather_bwd_coords": gather_cuda.gather_bwd_coords.launches,
            "splat_fwd_window": splat_cuda.splat.window_launches,
            "splat_vjp_window": splat_cuda.splat_vjp.window_launches,
            "splat_sort": splat_cuda.splat.sort_launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items()}


def _np(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (a CPU tensor's ``.numpy()`` shares its memory)."""
    return t.detach().cpu().numpy().copy()


def spatial_render(plan, arrays, pose, zbuffer_scale, max_dy, target=None,
                   splat_method="scatter"):
    """The height-sharded render of a global LDI (``arrays``: textures,
    disparities, intrinsics as numpy) on this rank's shard, its splat
    ``splat_method``'s.

    Returns this rank's (data index, space index), its rows of rgb,
    disparity and coverage and the kernel launches of the render (and its
    backward); with ``target`` (B, H, W, 3), also the loss
    ``mean((rgb - target)^2)`` over the global image and batch and its
    gradient with respect to this rank's disparity shard."""
    from lsi_tpu_torch.geometry.ldi import LDI
    from lsi_tpu_torch.parallel.mesh import batch_slice
    from lsi_tpu_torch.parallel.reduce import reduce_sum
    from lsi_tpu_torch.parallel.spatial import (render_forward_spatial,
                                                shard_ldi)
    dev = plan.device
    ldi = LDI(*(torch.from_numpy(arrays[k]).to(dev)
                for k in ("textures", "disparities", "intrinsics")))
    ldi = shard_ldi(ldi, plan)
    disp = ldi.disparities.detach().clone().requires_grad_(target is not None)
    ldi = dataclasses.replace(ldi, disparities=disp)
    bs = batch_slice(arrays["textures"].shape[0], plan)
    pose_t = torch.from_numpy(pose[bs]).to(dev)
    before = launch_counts()
    out = render_forward_spatial(ldi, pose_t, plan,
                                 zbuffer_scale=zbuffer_scale,
                                 pallas_max_dy=max_dy,
                                 splat_method=splat_method)
    res = {"data_rank": plan.data_rank, "space_rank": plan.space_rank,
           **{k: _np(v) for k, v in out.items()}}
    if target is not None:
        hd = disp.shape[2]
        rows = slice(plan.space_rank * hd, (plan.space_rank + 1) * hd)
        trg = torch.from_numpy(target[bs, rows]).to(dev)
        local = ((out["rgb"] - trg) ** 2).sum()
        total = reduce_sum(reduce_sum(local, plan.space_group),
                           plan.data_group)
        loss = total / target.size
        loss.backward()
        res["loss"] = float(loss.detach())
        res["grad_disparities"] = _np(disp.grad)
    res["launches"] = _since(before)
    return res


def per_share_forward(net: torch.nn.Module, batch_size: int,
                      shares: int) -> None:
    """Make ``net`` run each of ``shares`` equal parts of a batch of
    ``batch_size`` examples on its own, as that many data-parallel ranks
    do, and reassemble the whole batch's prediction: one process with the
    ranks' convolution shapes and no reduction. Takes the single forward
    and the paired one of ``trainer.apply_model_pair`` ([src; trg]
    stacked: each share holds its examples of both views)."""
    forward = net.forward
    per = batch_size // shares

    def split(images, intrinsics):
        views = images.shape[0] // batch_size
        idx = [torch.cat([torch.arange(v * batch_size + i * per,
                                       v * batch_size + (i + 1) * per)
                          for v in range(views)]) for i in range(shares)]
        outs = [forward(images[ix], intrinsics[ix]) for ix in idx]
        order = torch.argsort(torch.cat(idx))

        def cat(field):
            return torch.cat([getattr(o, field) for o in outs])[order]
        return dataclasses.replace(outs[0], textures=cat("textures"),
                                   disparities=cat("disparities"),
                                   intrinsics=cat("intrinsics"))

    net.forward = split


def train_steps(plan, cfg, params, batches, collect_grads=True, tf32=True,
                deterministic=False, net_shares=1):
    """``len(batches)`` steps of ``make_train_step(cfg, plan=plan)`` from
    ``params`` (a state dict as numpy), each global batch (a dict of
    numpy arrays) cut to this rank's share; ``tf32=False`` turns TF32 off
    on the card, ``deterministic`` makes cuDNN pick deterministic
    algorithms, and ``net_shares`` runs the network on that many parts of
    the batch (:func:`per_share_forward`). Returns the metrics, the
    parameters and the kernel launches of every step and the step-1
    gradients, this rank's part and the sum over the ranks, as numpy."""
    from lsi_tpu_torch.data.pipeline import Batch
    from lsi_tpu_torch.parallel.mesh import all_reduce_grads, batch_slice
    from lsi_tpu_torch.train import trainer

    dev = plan.device
    if not tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    state = trainer.create_state(cfg, device=dev)
    state.net.load_state_dict({k: torch.from_numpy(v)
                               for k, v in params.items()})
    step = trainer.make_train_step(cfg, plan=plan)
    history, params_after, launches = [], [], []
    grads = local = None
    for i, b in enumerate(batches):
        bs = batch_slice(len(next(iter(b.values()))), plan)
        batch = Batch(**{k: torch.from_numpy(v[bs]).to(dev)
                         for k, v in b.items()})
        if i == 0 and net_shares > 1:
            per_share_forward(state.net, batch.src_image.shape[0],
                              net_shares)
        if i == 0 and collect_grads:
            _, g = trainer.loss_and_grads(state, batch, cfg,
                                          data_group=plan.batch_group)
            local = {k: _np(v) for k, v in g.items()}
            grads = {k: _np(v) for k, v in all_reduce_grads(plan, g).items()}
        before = launch_counts()
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        launches.append(_since(before))
        params_after.append({k: _np(v)
                             for k, v in state.net.state_dict().items()})
    return {"metrics": history, "grads": grads, "local_grads": local,
            "params": params_after, "launches": launches}


def force_collapse(trainer, at_step: int, by: float) -> None:
    """A fault for tests and ``chip_smoke.py``, not for training: make
    ``trainer``'s eval after step ``at_step`` read its ``abs_rel`` ``by``
    higher than it is, a forced geometry collapse, the signal the
    collapse rollback answers. It wraps the public
    :meth:`~lsi_tpu_torch.train.trainer.Trainer.eval_metrics`, so the
    drift, the best export and the rollback all see the forced value."""
    eval_metrics = trainer.eval_metrics

    def run(state, step):
        out = eval_metrics(state, step)
        if step == at_step:
            out["eval_abs_rel"] += by
        return out

    trainer.eval_metrics = run


def trainer_run(plan, cfg, max_steps=None, collapse=None):
    """``Trainer(cfg, plan=plan).train(max_steps)``, with ``collapse``
    ((step, by): :func:`force_collapse`) forced on rank 0's eval: this
    rank's final step, last metrics, parameters (numpy) and optimizer
    count, and rank 0's listing of the checkpoint directory."""
    from lsi_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, plan=plan)
    if collapse is not None:
        force_collapse(trainer, *collapse)
    state, metrics = trainer.train(max_steps)
    d = cfg.train.checkpoint_dir
    files = sorted(os.path.relpath(os.path.join(root, f), d)
                   for root, _, names in os.walk(d) for f in names)
    return {"step": state.step, "metrics": metrics,
            "params": {k: _np(v) for k, v in state.net.state_dict().items()},
            "opt_count": state.opt_state.count,
            "files": files if plan.is_main else None}


def in_turn(plan, calls):
    """``[fn(plan, *args) for fn, args in calls]``: several programs, one
    after another, in one spawn."""
    return [fn(plan, *args) for fn, args in calls]
