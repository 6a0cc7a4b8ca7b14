"""Camera-trajectory sweep: one LDI rendered to many novel views.

PyTorch counterpart of ``lsi_tpu/evaluation/trajectory.py`` (BASELINE
config 5: predict once, render 60 poses). JAX renders the poses with
``lax.map(..., batch_size=8)``; here each chunk of 8 poses is ONE
:func:`render_forward` of the LDI repeated 8·B times, so a 60-view sweep
launches the forward splat 8 times.

The route is ``render_cfg.use_pallas``'s and the splat
``render_cfg.splat_method``'s (``geometry.ldi.render_forward``):
exact under "auto" (the lax path JAX takes off the TPU), windowed at
``render.pallas_max_dy`` under "on". For the canonical sinusoidal sweep
the share of the splat that window would drop is checked at the sweep's
two extreme poses, which bound its displacement; for given poses every
windowed render counts its own, as JAX's. The warning
(``geometry.ldi.warn_window_drop``) is given on the calling thread (JAX
defers it to a worker thread, a workaround for its remote device link).
"""

from __future__ import annotations

from typing import Optional

import torch

from lsi_tpu_torch.config import RenderConfig
from lsi_tpu_torch.geometry.ldi import (LDI, project_layers_folded,
                                        render_forward, warn_window_drop,
                                        window_dropped_fraction)
from lsi_tpu_torch.geometry.transforms import (camera_trajectory,
                                               pose_from_euler)


def _repeat(ldi: LDI, k: int) -> LDI:
    """The LDI's batch repeated ``k`` times, pose-major (index j*B + b)."""
    def rep(x):
        return x.repeat((k,) + (1,) * (x.dim() - 1))

    return LDI(rep(ldi.textures), rep(ldi.disparities), rep(ldi.intrinsics))


@torch.no_grad()
def _render_poses(ldi: LDI, poses: torch.Tensor, render_cfg: RenderConfig,
                  chunk: int = 8, check: bool = True):
    """(frames (T, B, H, W, 3), the largest ``window_dropped_frac`` of the
    renders, 0 unless ``check`` and the route is windowed): each chunk of
    ``chunk`` poses in one render."""
    b = ldi.batch
    frames = []
    dropped = 0.0
    for start in range(0, poses.shape[0], chunk):
        p = poses[start:start + chunk]
        k = p.shape[0]
        out = render_forward(_repeat(ldi, k),
                             p.repeat_interleave(b, dim=0),
                             zbuffer_scale=render_cfg.zbuffer_scale,
                             splat_method=render_cfg.splat_method,
                             use_pallas=render_cfg.use_pallas,
                             pallas_max_dy=render_cfg.pallas_max_dy,
                             check_window=check)
        frames.append(out["rgb"].reshape((k, b) + out["rgb"].shape[1:]))
        if check:
            dropped = max(dropped, out["window_dropped_frac"].item())
    return torch.cat(frames), dropped


@torch.no_grad()
def _render_canonical_sweep(ldi: LDI, max_translation, max_rotation,
                            num_views: int, render_cfg: RenderConfig,
                            chunk: int = 8, check: bool = True):
    """The canonical sinusoidal sweep: (frames (T, B, H, W, 3), the share
    of the splat the window drops at the worse extreme pose, 0 unless
    ``check``)."""
    dev = ldi.textures.device
    poses = camera_trajectory(num_views, max_translation,
                              max_rotation).to(dev)
    frames, dropped = _render_poses(ldi, poses, render_cfg, chunk,
                                    check=False)
    if check:
        b, l, h, w = ldi.textures.shape[:4]
        amp = torch.tensor([[1.0], [-1.0]])
        eposes = pose_from_euler(amp * torch.tensor([max_rotation]),
                                 amp * torch.tensor([max_translation])
                                 ).to(dev)
        for pose in eposes:
            tc, _, valid = project_layers_folded(ldi, pose.expand(b, 4, 4))
            dropped = max(dropped, window_dropped_fraction(
                tc.reshape(b, l * h, w, 2), valid.reshape(b, l * h, w, 1),
                (h, w), render_cfg.pallas_max_dy).item())
    return frames, dropped


def render_trajectory(ldi: LDI, num_views: int = 60,
                      max_translation=(0.15, 0.0, 0.0),
                      max_rotation=(0.0, 0.0, 0.02),
                      render_cfg: RenderConfig = RenderConfig(),
                      poses: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Render a smooth sweep; returns (num_views, B, H, W, 3) float32 on
    the LDI's device, without autograd.

    With ``poses`` (T, 4, 4) the LDI is rendered at those poses instead
    of the canonical sweep. With ``render_cfg.window_check``, warns when
    the window of ``render_cfg.pallas_max_dy`` rows drops content: at the
    canonical sweep's extreme poses (the share a windowed render would
    lose, on either route), or in a given pose's windowed render.
    """
    if poses is not None:
        frames, dropped = _render_poses(ldi, poses.to(ldi.textures.device),
                                        render_cfg,
                                        check=render_cfg.window_check)
    else:
        frames, dropped = _render_canonical_sweep(
            ldi, max_translation, max_rotation, num_views, render_cfg,
            check=render_cfg.window_check)
    if render_cfg.window_check:
        warn_window_drop(dropped, render_cfg.pallas_max_dy)
    return frames
