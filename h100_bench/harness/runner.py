"""One run of one cell: set-up, the measured window (with the traced
stretch inside it when ``trace``), the memory peak, the per-layer
readers, the check against the reference, and the result line.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from h100_bench.harness.spec import Cell, load_loop, load_reader
from h100_bench.harness.trace import Stretch, TraceData, check_launches
from h100_bench.loops.common import Spans, sync

#: Top-level module names the process must not hold (the JAX package and
#: JAX itself), compared whole: ``lsi_tpu_torch`` is not ``lsi_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "lsi_tpu")
TOP = 10


def forbidden_modules(modules=None) -> List[str]:
    names = {m.split(".")[0] for m in (modules if modules is not None
                                       else list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


@dataclasses.dataclass
class RunRecord:
    """What a per-layer reader reads: the cell, the timed window's seconds,
    units and iterations, the two traced stretches, the spans, and the
    loop (its K1 shapes and operation counts)."""
    cell: Cell
    window: Dict[str, float]
    trace: TraceData
    host_trace: TraceData
    spans: Dict[str, List[float]]
    loop: object


class Window:
    """The measured window: iterations back to back for ``seconds``
    (``seconds``, ``units``, ``latencies``). With ``trace``, after it, in
    the same loop: ``trace_iterations`` iterations with CUDA events around
    the calls into the port (``span_ms``), as many under the profiler
    recording the device alone (``device``), and ``host_iterations`` under
    the profiler recording host ranges too (``host``)."""

    def __init__(self, loop, traffic, seconds, trace, device):
        self.loop, self.wanted = loop, seconds
        self.trace, self.dev = trace, device
        self.t = traffic
        self.latencies: List[float] = []
        self.units = self.iterations = 0
        self.span_ms: Dict[str, List[float]] = {}

    def _step(self, spans=None) -> None:
        ts = time.perf_counter()
        u = self.loop.iteration(self.iterations, spans)
        self.latencies.append(time.perf_counter() - ts)
        self.iterations += 1
        self.units += u

    def run(self) -> None:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.wanted:
            self._step()
        sync(self.dev)
        self.seconds = time.perf_counter() - t0
        self.units_timed = self.units
        self.iterations_timed = self.iterations
        if not self.trace:
            return
        spans = Spans()
        for _ in range(self.t["trace_iterations"]):
            self._step(spans)
        sync(self.dev)
        self.span_ms = spans.ms()
        with Stretch(host=False) as self.device:
            for _ in range(self.t["trace_iterations"]):
                self._step()
                self.device.count()
        with Stretch(host=True) as self.host:
            for _ in range(self.t["host_iterations"]):
                self._step()
                self.host.count()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, started: float, entry: str = "program",
             fault: Optional[Callable] = None,
             on_check: Optional[Callable] = None) -> dict:
    """The run's result (the contract's keys, then ``checks``: each number
    that ``limits/<cell>.json`` holds a limit for)."""
    loop = load_loop(cell.traffic["loop"])(cell, seed, device, entry, fault)
    loop.setup()
    sync(device)
    setup_s = time.perf_counter() - started

    window = Window(loop, cell.traffic, seconds, trace, device)
    window.run()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    result = {"correct": False, "attempted": window.iterations, "failed": 0,
              "metrics": {}}
    if trace:
        record = RunRecord(cell=cell, window={
                               "seconds": window.seconds,
                               "units": window.units_timed,
                               "iterations": window.iterations_timed},
                           trace=window.device.data,
                           host_trace=window.host.data,
                           spans=window.span_ms, loop=loop)
        check_launches(record.trace)
        check_launches(record.host_trace)
        for m in cell.per_layer:
            value = load_reader(m["name"])(record)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        trace_dev = {"busy_s": record.trace.busy_s(),
                     "window_s": record.trace.window_s}
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in record.trace.top_ops()[:TOP]],
            "idle_gaps": [[n, s] for n, s
                          in record.host_trace.idle_gaps()[:TOP]]}
    else:
        e2e = loop.end_to_end(window.units_timed, window.seconds,
                              window.latencies)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
        trace_dev = {}
    del window
    loop.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = loop.check()
    if on_check is not None:
        on_check(loop, numbers)
    missing = sorted(set(cell.limits) - set(numbers))
    if missing:
        raise RuntimeError(f"the check read no {missing}")
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in cell.limits.items()}
    failed = [n for n, c in checks.items() if not c["value"] <= c["limit"]]
    result["correct"] = not failed
    result["failed"] = len(failed)
    result["device"] = dict(memory_peak_bytes=peak, **trace_dev)
    result["checks"] = checks
    result["numbers"] = numbers
    return result

