"""The frozen reference against the port's CPU path at a tiny size, in
float32 on both sides (the port's convolutions set to float32 too), for
the serve, sweep and train entries."""

import pytest
import torch

from h100_bench.harness.spec import port_config
from h100_bench.loops.common import (leaf_gaps, make_params, make_pool,
                                     moving_leaves)
from h100_bench.loops.sweep import ProgramSweep, reference_sweep
from h100_bench.loops.train import ProgramTrain
from h100_bench.reference import geometry as ref_geo
from h100_bench.reference import net as ref_net
from h100_bench.reference.optim import follow
from h100_bench.tests.tiny import tiny_cell

CPU = torch.device("cpu")


def float32_cell(name):
    cell = tiny_cell(name)
    cell.config["set"].append("model.compute_dtype=float32")
    cell.config["config"]["model"]["compute_dtype"] = "float32"
    return cell


def setup(name, seed=5):
    cell = float32_cell(name)
    params = make_params(cell.config["config"]["model"], seed, CPU)
    return cell, params, make_pool(cell.traffic, seed, CPU)


@pytest.mark.parametrize("name", ["serve_b16", "sweep60"])
def test_predict_render_and_sweep_match_the_port(name):
    cell, params, pool = setup(name)
    port = ProgramSweep(cell, params, CPU)
    cfg = cell.config["config"]
    sweep_traffic = tiny_cell("sweep60").traffic
    for b in pool:
        ldi = port.predict(b["src_image"], b["intrinsics"])
        ref = ref_net.predict(params, b["src_image"], b["intrinsics"],
                              cfg["model"])
        torch.testing.assert_close(ldi.textures, ref.textures, rtol=0,
                                   atol=1e-5)
        torch.testing.assert_close(ldi.disparities, ref.disparities, rtol=0,
                                   atol=1e-5)
        if "pose_src2trg" in b:
            frames = port.render(ldi, b["pose_src2trg"])
            judged = ref_geo.render_forward(ref, b["pose_src2trg"],
                                            cfg["render"])["rgb"]
            torch.testing.assert_close(frames, judged, rtol=0, atol=1e-4)
        sweep = port.sweep(ldi, sweep_traffic)
        torch.testing.assert_close(
            sweep, reference_sweep(ref, cfg["render"], sweep_traffic,
                                   ref_net.REFERENCE), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["train_quality_b8",
                                  "train_quality_b8_route"])
def test_three_steps_match_the_port(name):
    cell, params, pool = setup(name)
    port = ProgramTrain(cell, params, CPU)
    batches = [pool[k % len(pool)] for k in range(3)]
    parts = [{k: float(v) for k, v in port.step(b).items()} for b in batches]
    losses, first, after = follow(params, batches, cell.config["config"])
    for got, want in zip(parts, losses):
        assert set(want) <= set(got)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
    # The check's measure: leaves whose gradient is nought to rounding
    # move under Adam by round-off alone, element by element.
    keep = moving_leaves(first)
    got = {k: p - params[k] for k, p in port.params().items()}
    want = {k: after[k] - params[k] for k in after}
    # float32 parameters hold a change of ~1e-5 to ~1e-3 of itself.
    assert max(leaf_gaps(got, want, keep).values()) < 1e-3


def test_port_config_refuses_a_file_that_is_not_the_ports():
    cell = tiny_cell("serve_b16")
    cell.config["config"]["render"]["zbuffer_scale"] = 10.0
    with pytest.raises(ValueError, match="zbuffer_scale"):
        port_config(cell.config, cell.traffic)
