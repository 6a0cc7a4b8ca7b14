"""Cells cut to a size the CPU runs in seconds, for the benchmark's own
tests: the network's widths and the images shrunk, the batch and the
pool made small."""

from __future__ import annotations

import copy
import time

import torch

from h100_bench.harness.runner import run_cell
from h100_bench.harness.spec import load_cell

TINY_MODEL = {"base_filters": 8, "num_scales": 2}
TINY_TRAFFIC = {"height": 32, "width": 64, "batch_size": 2, "pool": 2,
                "workers": 2, "check_samples": 2,
                "warmup_passes": 1, "warmup_steps": 1, "views": 10}


def tiny_cell(name: str, **load):
    cell = copy.deepcopy(load_cell(name, **load))
    cfg = cell.config
    cfg["set"] = list(cfg["set"]) + [f"model.{k}={v}"
                                     for k, v in TINY_MODEL.items()]
    cfg["config"]["model"].update(TINY_MODEL)
    if cfg["config"]["render"]["use_pallas"] == "on":
        # A window that drops content at this size too.
        cfg["set"].append("render.pallas_max_dy=1")
        cfg["config"]["render"]["pallas_max_dy"] = 1
    for k, v in TINY_TRAFFIC.items():
        if k in cell.traffic:
            cell.traffic[k] = v
    return cell


def run_tiny(cell, seed: int = 3, seconds: float = 0.2, **kw) -> dict:
    return run_cell(cell, seed, seconds, False, torch.device("cpu"),
                    time.perf_counter(), **kw)
