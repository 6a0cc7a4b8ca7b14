"""Layered-planes (MPI) baseline: alpha-composited fronto-parallel planes.

PyTorch counterpart of ``lsi_tpu/models/mpi.py``. The model predicts, for
D fixed fronto-parallel planes in the source camera, per-plane RGB and
alpha; a novel view warps every plane through its plane-induced
homography and over-composites near to far.

The JAX render unrolls D separate warps. Here the D planes are folded
into the batch axis and warped by ONE gather (``GatherFn``: one launch of
the gather kernel per render, and one unsnapped K1 for the planes'
gradient): every plane is sampled on the same output grid, so the values
are the same. The composite's transmittance is an exclusive ``cumprod``
over the planes.

The two clips to [0, 1] (the source alphas, the warped alpha) are written
``minimum(maximum(x, 0), 1)``: at either bound its gradient is 0.5, as
``jnp.clip``'s is, where ``torch.clamp`` gives 1. A float32 sigmoid
returns exactly 1.0 above a logit of about 17, so a trained MPI reaches
the bound.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from lsi_tpu_torch.config import ModelConfig
from lsi_tpu_torch.geometry.homography import homography_warp, plane_homography
from lsi_tpu_torch.models.ldi_predictor import compute_dtype
from lsi_tpu_torch.models.unet import Conv3x3, UNet, reset_submodules


@dataclasses.dataclass
class MPI:
    """Multi-plane image in a source camera (layouts as in the JAX package).

    Attributes:
      colors: (B, D, H, W, 3) per-plane RGB in [0, 1].
      alphas: (B, D, H, W, 1) per-plane opacity in [0, 1]; plane 0 nearest.
      depths: (D,) plane depths (metres), increasing.
      intrinsics: (B, 3, 3).
    """
    colors: torch.Tensor
    alphas: torch.Tensor
    depths: torch.Tensor
    intrinsics: torch.Tensor


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)``, gradient included: 0.5 at either bound."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def plane_depths(num_planes: int, min_depth: float = 1.0,
                 max_depth: float = 100.0, device=None) -> torch.Tensor:
    """Depths uniform in disparity (the standard MPI spacing), near to far:
    1 / linspace(1/min, 1/max, D) in float32, the ramp written as
    ``jnp.linspace`` writes it (its compiled values differ by up to an
    ulp of the largest)."""
    start = torch.tensor(1.0 / min_depth, dtype=torch.float32, device=device)
    stop = torch.tensor(1.0 / max_depth, dtype=torch.float32, device=device)
    if num_planes == 1:
        return 1.0 / start[None]
    div = num_planes - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    disps = torch.cat([start * (1 - step) + stop * step, stop[None]])
    return 1.0 / disps


class MPIPredictor(nn.Module):
    """image -> MPI: per-plane alpha, and plane colour as a blend of the
    input and one predicted background. Parameter names mirror the Flax
    module: ``unet`` (``UNet_0``) and ``mpi_head``. It takes the
    ``family="mpi"`` ModelConfig itself, so JAX's ``build_mpi_predictor``
    (which unpacks it) has no counterpart: ``models.build_model``
    dispatches."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        if config.family != "mpi":
            raise ValueError(f"MPIPredictor builds family 'mpi', not "
                             f"{config.family!r}")
        self.config = config
        f = config.base_filters
        self.unet = UNet(3, f, config.num_scales, compute_dtype(config))
        # D alphas, D blend weights and one background RGB.
        self.mpi_head = Conv3x3(f, 2 * config.num_planes + 3)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Flax's default init, drawn from ``generator`` in module order."""
        reset_submodules(self, generator)

    def forward(self, image: torch.Tensor, intrinsics: torch.Tensor) -> MPI:
        """image (B, H, W, 3) in [0, 1]; intrinsics (B, 3, 3) -> MPI."""
        cfg = self.config
        d = cfg.num_planes
        feats = self.unet(image.permute(0, 3, 1, 2))
        raw = self.mpi_head(feats).float()               # (B, 2D+3, H, W)
        alphas = torch.sigmoid(raw[:, :d])               # (B, D, H, W)
        blend = torch.sigmoid(raw[:, d:2 * d])[..., None]
        bg = torch.sigmoid(raw[:, 2 * d:]).permute(0, 2, 3, 1)  # (B, H, W, 3)
        img32 = image.float()
        colors = blend * img32[:, None] + (1.0 - blend) * bg[:, None]
        return MPI(colors=colors, alphas=alphas[..., None],
                   depths=plane_depths(d, cfg.min_depth, cfg.max_depth,
                                       device=image.device),
                   intrinsics=intrinsics.float())


def _exclusive_transmittance(a: torch.Tensor) -> torch.Tensor:
    """prod_{d' < d} (1 - a_d') along dim 1 (1 for the nearest plane)."""
    trans = torch.cumprod(1.0 - a, dim=1)
    return torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)


def mpi_source_disparity(mpi: MPI) -> torch.Tensor:
    """Expected source-view disparity of an MPI, (B, H, W, 1): in the
    source camera the planes are aligned, so the over-composite weights
    are w_d = a_d prod_{d' < d} (1 - a_d') and E[disparity] =
    sum_d w_d / depth_d."""
    a = clip01(mpi.alphas[..., 0])                    # (B, D, H, W)
    w = a * _exclusive_transmittance(a)
    return (w / mpi.depths[None, :, None, None]).sum(dim=1)[..., None]


def render_mpi(mpi: MPI, pose_src2trg: torch.Tensor,
               K_trg: Optional[torch.Tensor] = None, out_hw=None):
    """Render an MPI into a novel view (gather only, differentiable).

    Warps every plane into the target camera through its plane-induced
    homography (all D planes in one gather) and over-composites near to
    far: C = sum_d c_d a_d prod_{d' < d} (1 - a_d').
    Returns dict(rgb (B, Ho, Wo, 3), alpha (accumulated opacity) and
    disparity (B, Ho, Wo, 1)), float32.
    """
    b, d, h, w, _ = mpi.colors.shape
    if K_trg is None:
        K_trg = mpi.intrinsics
    oh, ow = (h, w) if out_hw is None else (int(v) for v in out_hw)

    def rep(m):
        return m.float().repeat_interleave(d, dim=0)

    normal = torch.tensor([0.0, 0.0, 1.0],
                          device=mpi.colors.device).expand(b * d, 3)
    h_t2s = plane_homography(rep(mpi.intrinsics), rep(K_trg),
                             rep(pose_src2trg), normal, mpi.depths.repeat(b))
    planes = torch.cat([mpi.colors.float(), mpi.alphas.float()], dim=-1)
    warped, valid = homography_warp(planes.reshape(b * d, h, w, 4), h_t2s,
                                    (oh, ow))
    warped = warped.reshape(b, d, oh, ow, 4)
    a = clip01(warped[..., 3:4]) * valid.reshape(b, d, oh, ow, 1)
    wgt = _exclusive_transmittance(a) * a              # (B, D, Ho, Wo, 1)
    return {
        "rgb": (wgt * warped[..., :3]).sum(dim=1),
        "alpha": wgt.sum(dim=1),
        "disparity": (wgt / mpi.depths[None, :, None, None, None]).sum(dim=1),
    }
