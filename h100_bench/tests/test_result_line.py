"""``run.py``'s last line and its exits, driven on the CPU with the look
for a card replaced (the cell cut to a tiny size)."""

import json

import pytest
import torch

from h100_bench import run
from h100_bench.harness import device as dev
from h100_bench.harness import spec
from h100_bench.tests.test_reference import float32_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(dev, "require_cards", lambda n: torch.device("cpu"))
    monkeypatch.setattr(dev, "describe", lambda n: {
        "platform": "gpu", "kind": "test", "count": n,
        "power_limit_w": 700.0})
    monkeypatch.setattr(spec, "load_cell", float32_cell)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)


def test_the_last_line_has_the_contracts_keys(on_cpu, capsys):
    assert run.main(["--workload", "serve_b16", "--seed", str(2**31 + 9),
                     "--seconds", "0.2", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS
    assert line["correct"] is True
    assert set(line["metrics"]) == {"serve_frames_per_s",
                                    "serve_batch_ms_p95", "setup_s"}
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    assert err.strip().splitlines()[-1].startswith("check frame_gap")


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "serve_b16", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_the_jax_package_in_the_process_refuses_the_result(on_cpu, capsys,
                                                           monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "lsi_tpu", object())
    assert run.main(["--workload", "serve_b16", "--seed", "1",
                     "--seconds", "0.1"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "lsi_tpu" in err
