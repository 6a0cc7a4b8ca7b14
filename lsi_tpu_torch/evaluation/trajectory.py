"""Camera-trajectory sweep: one LDI rendered to many novel views.

PyTorch counterpart of ``lsi_tpu/evaluation/trajectory.py`` (BASELINE
config 5: predict once, render 60 poses). JAX renders the poses with
``lax.map(..., batch_size=8)``; here each chunk of 8 poses is ONE
:func:`render_forward` of the LDI repeated 8·B times, so a 60-view sweep
launches the forward splat 8 times.

The render is exact (the lax path JAX takes off the TPU). For the
canonical sinusoidal sweep the share of the splat that the TPU kernel's
vertical window (``render.pallas_max_dy``) would drop is checked at the
sweep's two extreme poses, which bound its displacement, and warned about
on the calling thread (JAX defers the warning to a worker thread, a
workaround for its remote device link).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from lsi_tpu_torch.config import RenderConfig
from lsi_tpu_torch.geometry.ldi import (LDI, project_layers_folded,
                                        render_forward,
                                        window_dropped_fraction)
from lsi_tpu_torch.geometry.transforms import (camera_trajectory,
                                               pose_from_euler)

WINDOW_DROP_TOL = 1e-4


def warn_window_drop(frac: float, max_dy: Optional[int] = None,
                     tol: float = WINDOW_DROP_TOL) -> bool:
    """Warn when the dy window would drop more than ``tol`` of the splat;
    returns whether it warned (``lsi_tpu.geometry.ldi.warn_window_drop``)."""
    if frac > tol:
        extra = f" (pallas_max_dy={max_dy})" if max_dy is not None else ""
        warnings.warn(
            f"splat dy-window{extra} drops {frac:.4%} of valid splat "
            "contributions on this sweep: a windowed render "
            "(render_forward(..., pallas_max_dy=), the height-sharded "
            "render, the TPU kernel) misses content. Raise "
            "render.pallas_max_dy.", RuntimeWarning)
        return True
    return False


def _repeat(ldi: LDI, k: int) -> LDI:
    """The LDI's batch repeated ``k`` times, pose-major (index j*B + b)."""
    def rep(x):
        return x.repeat((k,) + (1,) * (x.dim() - 1))

    return LDI(rep(ldi.textures), rep(ldi.disparities), rep(ldi.intrinsics))


@torch.no_grad()
def _render_poses(ldi: LDI, poses: torch.Tensor, render_cfg: RenderConfig,
                  chunk: int = 8) -> torch.Tensor:
    """(T, B, H, W, 3): each chunk of ``chunk`` poses in one render."""
    b = ldi.batch
    frames = []
    for start in range(0, poses.shape[0], chunk):
        p = poses[start:start + chunk]
        k = p.shape[0]
        out = render_forward(_repeat(ldi, k),
                             p.repeat_interleave(b, dim=0),
                             zbuffer_scale=render_cfg.zbuffer_scale)
        frames.append(out["rgb"].reshape((k, b) + out["rgb"].shape[1:]))
    return torch.cat(frames)


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
    frames = _render_poses(ldi, poses, render_cfg, chunk)
    dropped = 0.0
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
    of the canonical sweep; the render is exact, so no window check.
    Otherwise, with ``render_cfg.window_check``, warns when the window of
    ``render_cfg.pallas_max_dy`` rows would drop content at the sweep's
    extreme poses.
    """
    if poses is not None:
        return _render_poses(ldi, poses.to(ldi.textures.device), render_cfg)
    frames, dropped = _render_canonical_sweep(
        ldi, max_translation, max_rotation, num_views, render_cfg,
        check=render_cfg.window_check)
    if render_cfg.window_check:
        warn_window_drop(dropped, render_cfg.pallas_max_dy)
    return frames
