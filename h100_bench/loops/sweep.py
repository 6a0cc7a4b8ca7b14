"""The trajectory sweep in a closed loop: one client sends one image, the
port predicts its LDI (``LSIModel.predict_ldi``) and renders the
canonical sweep of ``views`` poses from it
(``evaluation.trajectory.render_trajectory``, 8 poses a render),
then the next image, cycling a pool.

The check, at requests drawn from the seed: the LDI against the
reference network's (``ldi_gap``) and every frame of the sweep against
the reference sweep of that LDI (``frame_gap``).
"""

from __future__ import annotations

import warnings
from typing import Dict, List

import torch

from h100_bench.loops import serve
from h100_bench.loops.serve import ProgramServe
from h100_bench.reference import geometry as ref_geo
from h100_bench.reference import net as ref_net
from h100_bench.reference.precision import CONTROL, REFERENCE

# The sweep warns when the window of ``render.pallas_max_dy`` rows would
# drop content at its extreme poses, on either route; the warning is for
# users and the benchmark does not print it.
WINDOW_WARNING = "splat dy-window"


class ProgramSweep(ProgramServe):
    def sweep(self, ldi, traffic):
        from lsi_tpu_torch.evaluation.trajectory import render_trajectory
        return render_trajectory(ldi, num_views=traffic["views"],
                                 max_translation=traffic["max_translation"],
                                 max_rotation=traffic["max_rotation"],
                                 render_cfg=self.model.config.render)


class ControlSweep:
    def __init__(self, cell, params, device):
        self.params = params
        self.cfg = cell.config["config"]

    @torch.no_grad()
    def predict(self, image, K):
        return ref_net.predict(self.params, image, K, self.cfg["model"],
                               CONTROL)

    def sweep(self, ldi, traffic):
        return reference_sweep(ldi, self.cfg["render"], traffic, CONTROL)


def reference_sweep(ldi, render, traffic, prec):
    return ref_geo.render_trajectory(
        ldi, render, num_views=traffic["views"],
        max_translation=traffic["max_translation"],
        max_rotation=traffic["max_rotation"], prec=prec)


ENTRIES = {"program": ProgramSweep, "control": ControlSweep}


class Loop(serve.Loop):
    entries = ENTRIES
    frames_span = "trajectory"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        warnings.filterwarnings("ignore", message=WINDOW_WARNING)

    def frames(self, ldi, b):
        return self.entry.sweep(ldi, self.traffic)

    def judged(self, ldi, b):
        return reference_sweep(ldi, self.cfg["render"], self.traffic,
                               REFERENCE)

    def units(self) -> int:
        return self.traffic["views"] * self.traffic["batch_size"]

    def k1_calls(self) -> List[tuple]:
        """K1's shapes in one request: one render of the port's
        ``TRAJECTORY_CHUNK`` poses of the LDI a chunk, the last one
        shorter."""
        t, l = self.traffic, self.cfg["model"]["num_layers"]
        b, views, chunk = (t["batch_size"], t["views"],
                           ref_geo.TRAJECTORY_CHUNK)
        return [(b * min(chunk, views - s), l * t["height"], t["width"], 4,
                 t["height"], t["width"]) for s in range(0, views, chunk)]

    def end_to_end(self, units: int, seconds: float,
                   latencies_s: List[float]) -> Dict[str, float]:
        return {"sweep_views_per_s": units / seconds}
