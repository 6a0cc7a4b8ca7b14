"""The two readings a check's limits are set from, on the card, in one
process: the numbers the check compares for the port on many seeds (the
lower reading), for the control (the reference one precision step
below the configuration's, in the port's place) and for planted faults
(the upper readings).

    python3 h100_bench/readings.py --workload serve_b16 --seconds 3 \
        --seeds 11 12 13 --entries program control \
        --faults half_batch altered --out readings.jsonl

Each run is the benchmark's run (``harness.runner.run_cell``) with a
short window; one JSON line per run, and a summary of each number's
largest reading by entry. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--entries", nargs="*", default=["program"])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--out", default="")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted overrides of the configuration for every "
                   "run (a witness, such as model.compute_dtype=float32)")
    p.add_argument("--exact-float32", action="store_true",
                   help="TF32 off from the start (with --set "
                   "model.compute_dtype=float32: the port in exact float32)")
    p.add_argument("--look", type=int, default=0,
                   help="print the N leaves with the largest gaps")
    args = p.parse_args(argv)
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "_bench_cache/nv"))
    sys.path.insert(0, str(ROOT))
    import torch
    from h100_bench.faults import FAULTS
    from h100_bench.harness import device as dev
    from h100_bench.harness.runner import run_cell
    from h100_bench.harness.spec import load_cell

    cell = load_cell(args.workload)
    if args.exact_float32:
        from h100_bench.reference.precision import exact_float32
        exact_float32()
    for override in args.set:
        key, value = override.split("=", 1)
        section, field = key.split(".")
        old = cell.config["config"][section][field]
        cell.config["config"][section][field] = type(old)(value)
        cell.config["set"] = list(cell.config["set"]) + [override]
    device = dev.require_cards(cell.chips)
    card = dev.describe(cell.chips)
    print(json.dumps(card), flush=True)
    runs = [(e, None) for e in args.entries] + [("program", f)
                                                 for f in args.faults]
    out = open(args.out, "a") if args.out else None
    worst = collections.defaultdict(dict)
    for entry, fault in runs:
        label = entry if fault is None else f"fault:{fault}"
        for seed in args.seeds:
            t = time.perf_counter()
            look = {}

            def on_check(loop, numbers):
                for name, gaps in getattr(loop, "leaf_gaps", {}).items():
                    look[name] = sorted(gaps.items(), key=lambda kv: -kv[1]
                                        )[:args.look]

            r = run_cell(cell, seed, args.seconds, False, device,
                         time.perf_counter(), entry=entry,
                         fault=FAULTS[fault] if fault else None,
                         on_check=on_check if args.look else None)
            line = {"workload": cell.name, "entry": label, "seed": seed,
                    "numbers": r["numbers"],
                    "metrics": {k: m["value"] for k, m in r["metrics"].items()},
                    "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                    "seconds": time.perf_counter() - t, "look": look,
                    "set": args.set,
                    "card": card}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            for k, v in line["numbers"].items():
                if entry == "program" and fault is None:
                    worst[label][k] = max(worst[label].get(k, 0.0), v)
                else:
                    worst[label][k] = min(worst[label].get(k, float("inf")),
                                          v)
            del r
            torch.cuda.empty_cache()
    print("summary (program: largest; control and faults: smallest):",
          json.dumps(worst), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
