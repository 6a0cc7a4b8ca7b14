"""The check against broken runs: the harness's look for a card is
skipped and the rest of a run driven at a size the CPU holds, with the
timed path broken underneath (``faults.py``) or the control in the
port's place (training's also with its parameters and moments in
float32, so that the arithmetic alone has to be seen); ``correct`` must
come out false. A sound run (the port's convolutions in float32 here, so
that no rounding of this tiny network stands in the way) comes out
true."""

import pytest

from h100_bench.faults import FAULTS
from h100_bench.tests.test_reference import float32_cell
from h100_bench.tests.tiny import run_tiny, tiny_cell

SERVING = ["serve_b16", "sweep60"]
TRAINING = ["train_quality_b8", "train_quality_b8_route"]


@pytest.mark.parametrize("name", SERVING + TRAINING)
def test_a_sound_run_is_correct(name):
    r = run_tiny(float32_cell(name))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("name, fault", [
    (n, f) for n in SERVING for f in ("half_batch", "altered")] + [
    (n, f) for n in TRAINING for f in ("half_batch", "unchanged_state")])
def test_a_fault_is_not_correct(name, fault):
    r = run_tiny(tiny_cell(name), fault=FAULTS[fault])
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name, entry", [
    (n, "control") for n in SERVING + TRAINING] + [
    (n, "control_compute") for n in TRAINING])
def test_the_control_is_not_correct(name, entry):
    r = run_tiny(tiny_cell(name), entry=entry)
    assert not r["correct"], r["checks"]
