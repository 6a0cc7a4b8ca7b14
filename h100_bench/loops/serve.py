"""Serving in a closed loop: one client sends a batch of images, waits for
its LDIs and rendered frames (``LSIModel.predict_ldi`` then
``LSIModel.render``), and sends the next, cycling a pool of batches with
their stereo poses.

The check compares answers the window produced, at iterations drawn from
the seed: each batch's LDI against the reference network's on the same
images and weights (``ldi_gap``), and its frames against the reference
render of that LDI (``frame_gap``); both the largest absolute gap.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from h100_bench.harness.spec import port_config
from h100_bench.loops.common import (note, make_params, make_pool, max_abs,
                                     optional_spans, Reservoir,
                                     sync)
from h100_bench.reference import geometry as ref_geo
from h100_bench.reference import net as ref_net
from h100_bench.reference.precision import (CONTROL, REFERENCE,
                                            exact_float32)


class ProgramServe:
    """The port: ``LSIModel`` with the benchmark's weights."""

    def __init__(self, cell, params, device):
        from lsi_tpu_torch.api import LSIModel
        from lsi_tpu_torch.models.ldi_predictor import LDIPredictor
        cfg = port_config(cell.config, cell.traffic)
        with torch.device(device):
            net = LDIPredictor(cfg.model)
        net.load_state_dict(params)
        self.model = LSIModel(cfg, net)

    def predict(self, image, K):
        return self.model.predict_ldi(image, K)

    def render(self, ldi, pose):
        return self.model.render(ldi, pose)


class ControlServe:
    """The reference one precision step below the configuration's, in the
    port's place (``precision.CONTROL``)."""

    def __init__(self, cell, params, device):
        self.params = params
        self.cfg = cell.config["config"]

    @torch.no_grad()
    def predict(self, image, K):
        return ref_net.predict(self.params, image, K, self.cfg["model"],
                               CONTROL)

    @torch.no_grad()
    def render(self, ldi, pose):
        return ref_geo.render_forward(ldi, pose, self.cfg["render"],
                                      prec=CONTROL)["rgb"]


ENTRIES = {"program": ProgramServe, "control": ControlServe}


class Loop:
    """The closed loop of one client: predict, then the call that makes
    the frames (here ``render``), then the next request. ``sweep.Loop``
    is this loop with the sweep in place of the render."""

    entries = ENTRIES
    frames_span = "render"

    def __init__(self, cell, seed, device, entry="program", fault=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = cell.traffic
        self.cfg = cell.config["config"]
        self.entry_name, self.fault = entry, fault

    def setup(self) -> None:
        t = self.traffic
        at = time.perf_counter()
        self.params = make_params(self.cfg["model"], self.seed, self.device)
        at = note("weights", at)
        self.pool = make_pool(t, self.seed, self.device)
        at = note("inputs", at)
        entry = self.entries[self.entry_name](self.cell, self.params,
                                              self.device)
        self.entry = self.fault(entry) if self.fault else entry
        at = note("program", at)
        self.sample = Reservoir(self.seed, t["check_samples"])
        for _ in range(t["warmup_passes"]):
            for b in self.pool:
                self.frames(self.entry.predict(b["src_image"],
                                               b["intrinsics"]), b)
        sync(self.device)
        note("warm-up", at)

    def frames(self, ldi, b):
        return self.entry.render(ldi, b["pose_src2trg"])

    def judged(self, ldi, b):
        """The reference's frames of the program's LDI."""
        return ref_geo.render_forward(ldi, b["pose_src2trg"],
                                      self.cfg["render"])["rgb"]

    def units(self) -> int:
        return self.traffic["batch_size"]

    def k1_calls(self) -> List[tuple]:
        """K1's shapes in one iteration: the render's one splat."""
        t, l = self.traffic, self.cfg["model"]["num_layers"]
        return [(t["batch_size"], l * t["height"], t["width"], 4,
                 t["height"], t["width"])]

    def iteration(self, i: int, spans=None) -> int:
        span = optional_spans(spans)
        b = self.pool[i % len(self.pool)]
        with span("predict"):
            ldi = self.entry.predict(b["src_image"], b["intrinsics"])
        with span(self.frames_span):
            frames = self.frames(ldi, b)
        sync(self.device)
        self.sample.offer((i % len(self.pool), ldi.textures,
                           ldi.disparities, frames))
        return self.units()

    def end_to_end(self, units: int, seconds: float,
                   latencies_s: List[float]) -> Dict[str, float]:
        # A window of one batch (a tiny cell on a loaded CPU) has that
        # batch's latency as its tail.
        p95 = (statistics.quantiles(latencies_s, n=20)[18]
               if len(latencies_s) > 1 else latencies_s[0])
        return {"serve_frames_per_s": units / seconds,
                "serve_batch_ms_p95": 1e3 * p95}

    def flops(self, units: int) -> float:
        images = units / self.units() * self.traffic["batch_size"]
        return images * self.cell.config["flops_per_image"]["forward"]

    def free(self) -> None:
        self.entry = None

    @torch.no_grad()
    def check(self) -> Dict[str, float]:
        if not self.sample.kept:
            raise RuntimeError("the window gave no answer")
        exact_float32()
        ldi_gap = frame_gap = 0.0
        for idx, tex, disp, frames in self.sample.kept:
            b = self.pool[idx]
            ref = ref_net.predict(self.params, b["src_image"],
                                  b["intrinsics"], self.cfg["model"],
                                  REFERENCE)
            ldi_gap = max(ldi_gap, max_abs(tex, ref.textures),
                          max_abs(disp, ref.disparities))
            del ref
            judged = self.judged(ref_geo.LDI(tex, disp, b["intrinsics"]), b)
            frame_gap = max(frame_gap, max_abs(frames, judged))
        return {"ldi_gap": ldi_gap, "frame_gap": frame_gap}
