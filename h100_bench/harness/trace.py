"""The traced stretches: ``torch.profiler`` over a fixed number of
iterations of the loop after its timed window, the port's launch counters
read before and after each, and what the readers take from them.

``busy_us`` is ``scripts/profile_torch_train.busy_us`` at commit ee70f4d
(the union of device intervals). The kernel families' event counts are
held against the port's launch counters (``check_launches``): a trace
that lost launches fails the run rather than report a smaller time.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

#: Kernel families: (the launch counter, a fragment of the kernel's name).
#: One launch through the counter's function is one kernel of that name.
FAMILIES = {
    "k1": ("splat.launches", ("splat_fwd_kernel", "splat_band_kernel")),
    "k1_sort": ("splat.sort_launches", ("splat_sort_fill_kernel",)),
    "k2": ("splat_vjp.launches", ("splat_vjp_kernel",)),
    "k4_fwd": ("gather_fwd.launches", ("gather_fwd_kernel",)),
    "k4_bwd": ("gather_bwd_coords.launches", ("gather_bwd_coords_kernel",)),
}
#: Name fragments of every kernel built from ``lsi_tpu_torch/csrc/``.
PORT_KERNELS = ("splat_fwd_kernel", "splat_band_kernel", "splat_vjp_kernel",
                "gather_fwd_kernel", "gather_bwd_coords_kernel",
                "splat_sort_")


def read_counters() -> Dict[str, int]:
    """The port's launch counters (attributes of its kernel wrappers)."""
    from lsi_tpu_torch.kernels import gather_cuda, splat_cuda
    fns = {"splat": splat_cuda.splat, "splat_vjp": splat_cuda.splat_vjp,
           "gather_fwd": gather_cuda.gather_fwd,
           "gather_bwd_coords": gather_cuda.gather_bwd_coords}
    out = {}
    for fn_name, fn in fns.items():
        for attr in ("launches", "window_launches", "band_launches",
                     "sort_launches"):
            if hasattr(fn, attr):
                out[f"{fn_name}.{attr}"] = int(getattr(fn, attr))
    return out


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


@dataclasses.dataclass
class HostOp:
    name: str
    start: float
    end: float
    children: List["HostOp"]


@dataclasses.dataclass
class TraceData:
    """What a traced stretch left: device operations (name, start, end in
    us), host ranges by thread (trees), the runtime launch time of each
    device operation's correlation id, the stretch's wall seconds and
    iterations, and the launch counters' growth over it."""
    device_ops: List[Tuple[str, float, float, int]]
    host_roots: Dict[int, List[HostOp]]
    launch_at: Dict[int, float]
    window_s: float
    iterations: int
    counters: Dict[str, int]

    def busy_s(self) -> float:
        return busy_us([(s, e) for _, s, e, _ in self.device_ops]) / 1e6

    def kernel_us(self, fragments) -> Tuple[float, int]:
        """(device us, events) of the operations whose name holds any of
        ``fragments``."""
        us, n = 0.0, 0
        for name, s, e, _ in self.device_ops:
            if any(f in name for f in fragments):
                us += e - s
                n += 1
        return us, n

    def host_ranges(self, name: str) -> List[Tuple[float, float]]:
        out = []

        def walk(ops):
            for op in ops:
                if op.name == name:
                    out.append((op.start, op.end))
                walk(op.children)
        for roots in self.host_roots.values():
            walk(roots)
        return sorted(out)

    def ops_launched_in(self, name: str) -> int:
        """Device operations whose launch call lies inside a host range
        ``name`` (e.g. ``train_step/optimizer``)."""
        ranges = self.host_ranges(name)
        starts = [s for s, _ in ranges]
        n = 0
        for _, _, _, corr in self.device_ops:
            t = self.launch_at.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            n += i >= 0 and ranges[i][0] <= t <= ranges[i][1]
        return n

    def host_label(self, t: float) -> str:
        """The innermost host range open at time ``t``, on any thread."""
        best = None
        for roots in self.host_roots.values():
            ops = roots
            while ops:
                starts = [o.start for o in ops]
                i = bisect.bisect_right(starts, t) - 1
                if i < 0 or ops[i].end < t:
                    break
                op = ops[i]
                if best is None or op.end - op.start < best.end - best.start:
                    best = op
                ops = op.children
        return best.name if best is not None else "(no host range)"

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle seconds between device operations, summed by what the
        host was doing at each gap's middle, largest first."""
        spans = sorted((s, e) for _, s, e, _ in self.device_ops)
        by_label = collections.Counter()
        end = None
        for s, e in spans:
            if end is not None and s > end:
                by_label[self.host_label((s + end) / 2)] += (s - end) / 1e6
            end = e if end is None else max(end, e)
        return by_label.most_common()

    def top_ops(self) -> List[Tuple[str, float]]:
        by_name = collections.Counter()
        for name, s, e, _ in self.device_ops:
            by_name[name] += (e - s) / 1e6
        return by_name.most_common()


def check_launches(trace: TraceData, families=FAMILIES) -> None:
    """Raise where the trace holds fewer events of a kernel family than
    the port's counters say it launched over the stretch."""
    for fam, (counter, fragments) in families.items():
        want = trace.counters.get(counter, 0)
        _, got = trace.kernel_us(fragments)
        if got < want:
            raise RuntimeError(
                f"the trace lost launches: {got} {fam} kernel events "
                f"against {want} counted by {counter}")


def _host_tree(events) -> Dict[int, List[HostOp]]:
    made = {}

    def make(e):
        op = made.get(id(e))
        if op is None:
            op = HostOp(e.name, e.time_range.start, e.time_range.end, [])
            made[id(e)] = op
        return op

    roots = collections.defaultdict(list)
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        op = make(e)
        if e.cpu_parent is None:
            roots[e.thread].append(op)
        else:
            make(e.cpu_parent).children.append(op)
    for op in made.values():
        op.children.sort(key=lambda o: o.start)
    return {t: sorted(r, key=lambda o: o.start) for t, r in roots.items()}


class Stretch:
    """``with Stretch(host) as s: ...`` profiles the block, the device's
    operations alone or, with ``host``, the host's ranges and operations
    too (which slows the host); ``s.data`` is its :class:`TraceData` once
    the block has closed. Call ``s.count()`` once an iteration."""

    def __init__(self, host: bool):
        self.host = host
        self.data: Optional[TraceData] = None
        self.iterations = 0

    def count(self) -> None:
        self.iterations += 1

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.host:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        torch.cuda.synchronize()
        self._before = read_counters()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        after = read_counters()
        events = self._prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        device_ops = [(e.name, e.time_range.start, e.time_range.end, e.id)
                      for e in events
                      if e.device_type == cuda and not e.is_user_annotation]
        launch_at = {e.id: e.time_range.start for e in events
                     if e.device_type != cuda and e.name.startswith(
                         ("cudaLaunch", "cuLaunch", "cudaMemcpy",
                          "cudaMemset"))}
        self.data = TraceData(
            device_ops=device_ops, host_roots=_host_tree(events),
            launch_at=launch_at, window_s=window_s,
            iterations=self.iterations,
            counters={k: after[k] - self._before.get(k, 0) for k in after})
        return False
