"""The frozen arithmetic against the counts it stands for."""

import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench.harness.spec import BENCH_DIR
from h100_bench.harness.yardstick import k1_bound_ms, network_flops
from lsi_tpu_torch.config import get_config
from lsi_tpu_torch.models.ldi_predictor import LDIPredictor


def counted(preset: str):
    cfg = get_config(preset)
    with torch.device("meta"):
        net = LDIPredictor(cfg.model)
        image, K = torch.rand(1, 256, 768, 3), torch.eye(3)[None]
    fwd, both = FlopCounterMode(display=False), FlopCounterMode(display=False)
    with fwd:
        net(image, K)
    with both:
        out = net(image, K)
        (out.textures.sum() + out.disparities.sum()).backward()
    return fwd.get_total_flops(), both.get_total_flops(), cfg


@pytest.mark.parametrize("preset, forward_g, train_g", [
    ("kitti_ldi2", 38.40, 114.87), ("kitti_ldi3_quality", 39.20, 117.25)])
def test_network_flops_match_the_flop_counter(preset, forward_g, train_g):
    fwd, both, cfg = counted(preset)
    frozen = network_flops(dataclasses.asdict(cfg.model), 256, 768)
    assert frozen == {"forward": fwd, "train": both}
    assert round(fwd / 1e9, 2) == forward_g
    assert round(both / 1e9, 2) == train_g


@pytest.mark.parametrize("name", ["kitti_ldi2", "kitti_ldi3_quality",
                                  "kitti_ldi3_quality_route"])
def test_config_files_state_the_frozen_counts(name):
    cfg = json.load(open(BENCH_DIR / "configs" / f"{name}.json"))
    frozen = network_flops(cfg["config"]["model"], cfg["image"]["height"],
                           cfg["image"]["width"])
    assert {k: cfg["flops_per_image"][k] for k in frozen} == frozen


def test_k1_bound_of_the_b8_render():
    # PERF.md §6: 35.7 us for K1 on the kitti_ldi2 b8 render's shapes.
    assert round(1e3 * k1_bound_ms(8, 512, 768, 4, 256, 768), 1) == 35.7
