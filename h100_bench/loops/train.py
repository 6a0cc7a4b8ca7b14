"""Training in a closed loop: the step function the port's ``Trainer``
runs in its "full" phase (``train.trainer.make_train_step`` of the
configuration as it stands: every loss term on), one batch after
another from a pool, no eval and no checkpoint.

Set-up builds one state (the benchmark's weights, a fresh optimizer)
and drives it through its first ``checked_steps`` steps on pool batches
that all differ, then on through the warm-up steps, and hands that same
state to the window. The check follows those first steps with the
reference from the same weights and batches: each step's loss parts
(``loss_gap``: the largest gap over the reference's total), the first
gradient as the optimizer took it, read from its first moment
(``grad_gap``), and the parameters' change over those steps, read
before the next step moves them (``update_gap``); both by the worst
leaf and the median leaf, against the larger of its reference norm and
the median leaf's, over the leaves whose reference gradient is at least
a thousandth of the median leaf's. And the first step's loss parts
alone, each over its own reference value (``loss1_gap``, the largest:
the same weights on both sides, so only the arithmetic of the network
and the render moves it; from step 2 on, Adam's first update, a sign
for each element, carries any gap of the gradient into every part).
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from h100_bench.harness.spec import port_config
from h100_bench.loops.common import (note, leaf_gaps, make_params, make_pool,
                                     moving_leaves, sync)
from h100_bench.reference.optim import Adam, follow, loss_and_grads
from h100_bench.reference.precision import (BF16_CONVOLUTIONS, CONTROL,
                                            CONTROL_COMPUTE, REFERENCE,
                                            exact_float32)


class ProgramTrain:
    """The port's state and its "full" step function."""

    def __init__(self, cell, params, device):
        from lsi_tpu_torch.data.pipeline import Batch
        from lsi_tpu_torch.models import build_model
        from lsi_tpu_torch.train.trainer import (Optimizer, TrainState,
                                                 make_train_step)
        cfg = port_config(cell.config, cell.traffic)
        with torch.device(device):
            net = build_model(cfg.model)
        net.load_state_dict(params)
        self.state = TrainState(net=net, opt_state=Optimizer(cfg).init(
            {k: p.detach() for k, p in net.named_parameters()}))
        self.step_fn = make_train_step(cfg)
        self.batch_type = Batch

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.state, metrics = self.step_fn(self.state,
                                           self.batch_type(**batch))
        return metrics

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.state.net.named_parameters()}

    def first_moment(self) -> Dict[str, torch.Tensor]:
        return dict(self.state.opt_state.mu)


class ControlTrain:
    """The reference step one precision step below the configuration's."""

    prec = CONTROL

    def __init__(self, cell, params, device):
        self.cfg = cell.config["config"]
        self._params = {k: p.detach().to(self.prec.state, copy=True)
                        for k, p in params.items()}
        self.adam = Adam(self.cfg["train"], self._params)

    def step(self, batch):
        parts, grads = loss_and_grads(self._params, batch, self.cfg,
                                      self.prec)
        self.adam.step(self._params, grads)
        return {k: torch.tensor(v) for k, v in parts.items()}

    def params(self):
        return self._params

    def first_moment(self):
        return dict(self.adam.mu)


class ComputeControlTrain(ControlTrain):
    """The control's arithmetic (fp8 convolutions, a bfloat16 render)
    with the parameters and moments in float32."""

    prec = CONTROL_COMPUTE


class Bf16Train(ControlTrain):
    """The reference step with the port's own precisions (bfloat16
    convolutions, float32 elsewhere): not a control, a witness of how far
    that precision alone moves the numbers (``readings.py``)."""

    prec = BF16_CONVOLUTIONS


ENTRIES = {"program": ProgramTrain, "control": ControlTrain,
           "control_compute": ComputeControlTrain,
           "bf16_reference": Bf16Train}


class Loop:
    unit = "steps"

    def __init__(self, cell, seed, device, entry="program", fault=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = cell.traffic
        self.entry_name, self.fault = entry, fault
        self.steps = 0

    def _batch(self) -> Dict[str, torch.Tensor]:
        return self.pool[self.steps % len(self.pool)]

    def setup(self) -> None:
        t = self.traffic
        at = time.perf_counter()
        self.params = make_params(self.cell.config["config"]["model"],
                                  self.seed, self.device)
        at = note("weights", at)
        self.pool = make_pool(t, self.seed, self.device)
        at = note("inputs", at)
        entry = ENTRIES[self.entry_name](self.cell, self.params, self.device)
        self.entry = self.fault(entry) if self.fault else entry
        at = note("program", at)
        self.losses, self.first = [], None
        for _ in range(t["checked_steps"]):
            self.losses.append(self.entry.step(self._batch()))
            self.steps += 1
            if self.first is None:
                b1 = self.cell.config["config"]["train"]["adam_b1"]
                self.first = {k: m.detach() / (1.0 - b1)
                              for k, m in self.entry.first_moment().items()}
        self.after = {k: p.detach().clone()
                      for k, p in self.entry.params().items()}
        self.losses = [{k: float(v) for k, v in parts.items()}
                       for parts in self.losses]
        for _ in range(t["warmup_steps"]):
            self.entry.step(self._batch())
            self.steps += 1
        sync(self.device)
        note("warm-up", at)

    def iteration(self, i: int, spans=None) -> int:
        self.entry.step(self._batch())
        self.steps += 1
        return 1

    def end_to_end(self, units: int, seconds: float,
                   latencies_s: List[float]) -> Dict[str, float]:
        return {"train_steps_per_s": units / seconds}

    def flops(self, units: int) -> float:
        images = self.traffic["batch_size"] * self.traffic["predictions"]
        return units * images * self.cell.config["flops_per_image"]["train"]

    def free(self) -> None:
        self.entry = None

    def check(self) -> Dict[str, float]:
        exact_float32()
        cfg = self.cell.config["config"]
        n = self.traffic["checked_steps"]
        batches = [self.pool[k % len(self.pool)] for k in range(n)]
        ref_losses, ref_first, ref_after = follow(self.params, batches, cfg,
                                                  REFERENCE)
        loss_gap = 0.0
        part_gaps: Dict[str, float] = {}
        first_gaps: Dict[str, float] = {}
        for step, (prog, ref) in enumerate(zip(self.losses, ref_losses)):
            terms = [k for k in ref if not k.startswith("window_dropped")]
            missing = [k for k in terms if k not in prog]
            if missing:
                raise RuntimeError(f"the step returned no {missing}")
            loss_gap = max(loss_gap, max(abs(prog[k] - ref[k])
                                         for k in terms) / abs(ref["total"]))
            for k in terms:
                gap = abs(prog[k] - ref[k]) / abs(ref[k])
                part_gaps[k] = max(part_gaps.get(k, 0.0), gap)
                if step == 0:
                    first_gaps[k] = gap
        keep = moving_leaves(ref_first)
        delta = {k: self.after[k] - self.params[k] for k in keep}
        ref_delta = {k: ref_after[k] - self.params[k] for k in keep}
        self.leaf_gaps = {"grad": leaf_gaps(self.first, ref_first, keep),
                          "update": leaf_gaps(delta, ref_delta, keep)}
        out = {"loss_gap": loss_gap, "loss1_gap": max(first_gaps.values())}
        out.update({f"loss_gap.{k}": v for k, v in part_gaps.items()})
        out.update({f"loss1_gap.{k}": v for k, v in first_gaps.items()})
        for name, gaps in self.leaf_gaps.items():
            out[f"{name}_gap"] = max(gaps.values())
            out[f"{name}_gap_median"] = statistics.median(gaps.values())
        return out
