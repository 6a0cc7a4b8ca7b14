"""Where a cell's parts are found, by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the model configuration as it is run (the
  preset of ``lsi_tpu_torch/config.py``, its ``--set`` overrides and the
  resolved values the port must reach, which the reference reads);
* ``traffic/<traffic>.json``: the traffic mix, whose ``loop`` names the
  general loop in ``loops/<loop>.py``;
* ``limits/<cell>.json``: the limit of each number the cell's check
  compares;
* ``metrics/<metric>.py``: one per-layer metric's reader.

Adding a cell, a configuration, a traffic mix or a metric adds files and
entries; nothing here is edited.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
#: The sections of a configuration file that the port's resolved config
#: must equal (the data section is the traffic's).
SECTIONS = ("model", "render", "loss", "train")


@dataclasses.dataclass
class Cell:
    """Everything one run of one cell reads."""
    name: str
    chips: int
    config: dict                 # configs/<config>.json
    traffic: dict                # traffic/<traffic>.json
    limits: Dict[str, float]     # limits/<cell>.json
    end_to_end: List[dict]       # BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` (a BENCHMARK.json entry) is reported in
    ``cell``: listed under its ``workloads``, or every cell without one."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT,
              bench_dir: Optional[Path] = None) -> Cell:
    bench_dir = bench_dir or root / "h100_bench"
    spec = _json(root / "BENCHMARK.json")
    entry = [w for w in spec["workloads"] if w["name"] == name]
    if not entry:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in spec['workloads']]}")
    entry = entry[0]
    cfg_entry = [c for c in spec["configs"] if c["name"] == entry["config"]]
    if not cfg_entry:
        raise KeyError(f"no config {entry['config']!r} in BENCHMARK.json")
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=_json(root / cfg_entry[0]["file"]),
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if reports(m, name)])


def port_config(config: dict, traffic: dict):
    """The port's ``Config`` for this configuration and traffic: the preset
    with the file's overrides, the traffic's image size and batch; raises
    where the port's resolved sections differ from the file's."""
    from lsi_tpu_torch.config import apply_override, build_config
    cfg = build_config(config["preset"], config.get("set", []))
    for key in ("height", "width", "batch_size"):
        cfg = apply_override(cfg, f"data.{key}={traffic[key]}")
    resolved = dataclasses.asdict(cfg)
    for section in SECTIONS:
        if resolved[section] != config["config"][section]:
            diff = {k: (resolved[section].get(k), v)
                    for k, v in config["config"][section].items()
                    if resolved[section].get(k) != v}
            raise ValueError(
                f"the port's {config['preset']} {section} section is not "
                f"the configuration's (port, file): {diff}")
    return cfg


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``metrics/<name>.py``'s ``read`` function."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_loop(name: str):
    """``loops/<name>.py``'s ``Loop`` class."""
    module = importlib.import_module(f"h100_bench.loops.{name}")
    return module.Loop
