"""What every loop shares: the weights made from the seed on the card,
the input pool on the device, the spans around calls into the port, and
the gap arithmetic of the checks."""

from __future__ import annotations

import contextlib
import math
import random
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

from h100_bench.inputs.pool import make_scenes, stack
from h100_bench.reference.net import param_specs


def note(what: str, since: float) -> float:
    """Print to standard error how long a part of set-up took; return the
    time now."""
    now = time.perf_counter()
    print(f"setup: {what} {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def make_params(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The network's parameters from ``seed`` on ``device``: one draw of a
    unit normal truncated to [-2, 2] for every kernel (Flax's
    lecun_normal, scaled per tensor), zero biases, unit norm scales;
    float32, the type the port keeps them in."""
    specs = param_specs(model)
    total = sum(math.prod(shape) for _, shape, init, _ in specs
                if init == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, off = {}, 0
    for name, shape, init, std in specs:
        n = math.prod(shape)
        if init == "normal":
            out[name] = (flat[off:off + n] * std).view(shape)
            off += n
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def make_pool(traffic: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool"]`` batches of ``batch_size`` scenes of kind
    ``traffic["scene"]`` at the traffic's size, with the ``fields`` its
    loop reads, on ``device``."""
    b, n = traffic["batch_size"], traffic["pool"]
    scenes = make_scenes(traffic["scene"], seed, b * n, traffic["height"],
                         traffic["width"], traffic["workers"],
                         traffic["fields"])
    return [{k: torch.from_numpy(v).to(device)
             for k, v in stack(scenes[i * b:(i + 1) * b]).items()}
            for i in range(n)]


class Reservoir:
    """A sample of ``count`` answers drawn from the seed, uniform over all
    the answers the window gives (Algorithm R): ``offer`` each answer as
    it comes; ``kept`` holds the sample."""

    def __init__(self, seed: int, count: int):
        self.rng = random.Random(int(seed) ^ 0x5A3D1E)
        self.count = count
        self.seen = 0
        self.kept: List = []

    def offer(self, answer) -> None:
        if len(self.kept) < self.count:
            self.kept.append(answer)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.count:
                self.kept[j] = answer
        self.seen += 1


class Spans:
    """CUDA events and a profiler range (``bench/<name>``) around calls
    into the port; ``ms(name)`` reads each span's device ms once the
    stream has been synchronised."""

    def __init__(self):
        self._events: Dict[str, List] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with record_function(f"bench/{name}"):
            start.record()
            yield
            end.record()
        self._events.setdefault(name, []).append((start, end))

    def ms(self) -> Dict[str, List[float]]:
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self._events.items()}


@contextlib.contextmanager
def no_spans(name: str):
    yield


def sync(device) -> None:
    """Wait for the device's work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> Dict[str, float]:
    """Each leaf's ``| ||prog|| - ||ref|| |`` over the larger of
    ``||ref||`` and the median leaf's ``||ref||``, over the leaves
    ``keep``."""
    norms = {k: float(ref[k].float().norm()) for k in keep}
    median = statistics.median(norms.values())
    return {k: abs(float(prog[k].float().norm()) - norms[k])
            / max(norms[k], median) for k in keep}


def moving_leaves(first_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's (the others move under Adam by round-off alone)."""
    norms = {k: float(g.float().norm()) for k, g in first_grad.items()}
    floor = 1e-3 * statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= floor]


def optional_spans(spans: Optional[Spans]):
    return spans if spans is not None else no_spans
