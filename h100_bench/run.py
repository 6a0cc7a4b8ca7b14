"""The benchmark of ``lsi_tpu_torch`` on an NVIDIA H100: one run of one cell.

    python3 h100_bench/run.py --workload serve_b16 --seed 7 --seconds 20 \
        --trace 0

Run from the root of a checkout. It loads the cell named in
``BENCHMARK.json`` (its configuration, traffic mix and limits, found by
name under ``h100_bench/``), makes the weights and inputs from
``--seed``, warms up every shape the traffic uses (set-up), measures for
``--seconds``, and checks answers the window produced against the plain
reference in ``h100_bench/reference/``. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics, read by ``metrics/<name>.py`` from a profiled stretch inside the
window, with ``breakdown``), ``device`` (with the card's name and power
limit) and, last, ``checks``: each compared number and its limit, which
also end standard error. It exits non-zero, with no result, without a
card, when the process holds JAX or the JAX package, or on any error.

The port's kernels build into ``lsi_tpu_torch/_build/``; every other
cache of the run is kept under ``_bench_cache/`` in the checkout.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "_bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    import torch
    from h100_bench.harness import device as dev
    from h100_bench.harness.runner import forbidden_modules, run_cell
    from h100_bench.harness.spec import load_cell
    try:
        cell = load_cell(args.workload)
        device = dev.require_cards(cell.chips)
        torch.cuda.set_device(device)
        card = dev.describe(cell.chips)
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device, STARTED)
        found = forbidden_modules()
        if found:
            print(f"the process holds {found}: the benchmark measures the "
                  "port alone", file=sys.stderr)
            return 3
    except dev.NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    result.pop("numbers")
    checks = result.pop("checks")
    result["device"] = {**card, **result["device"]}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
