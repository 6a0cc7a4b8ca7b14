"""Public API — the PyTorch counterpart of ``lsi_tpu/api.py``:

    predict_ldi(image, model) -> ldi   # (B, H, W, 3) -> LDI(B, L, H, W, ...)
    render(ldi, pose)         -> image # LDI + (B, 4, 4) pose -> (B, H, W, 3)

Both run under ``torch.inference_mode()``. :class:`LSIModel` bundles
(config, network) and reads and writes the JAX package's ``.npz`` export,
so a file round-trips between the two packages.

``RenderConfig`` fields: ``zbuffer_scale``; ``splat_method``, "scatter"
(the default, K1) or "sort" (K1-D: the same render, bitwise repeatable);
``use_pallas``, "auto" (the default: the exact splat), "off" and False
the same, "on" and True the JAX package's TPU route, a vertical window of
``pallas_max_dy`` rows (``geometry.ldi.render_forward``);
``window_check``: on that route, ``render`` warns when the window drops
content.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from lsi_tpu_torch.config import Config, RenderConfig
from lsi_tpu_torch.geometry import projection
from lsi_tpu_torch.geometry.ldi import (LDI, check_splat_method,
                                        render_forward, resolve_use_pallas,
                                        warn_window_drop)
from lsi_tpu_torch.models.convert import (jax_from_state_dict,
                                          state_dict_from_jax)
from lsi_tpu_torch.models.ldi_predictor import LDIPredictor


def default_intrinsics(batch: int, height: int, width: int,
                       device=None) -> torch.Tensor:
    """A generic driving-camera K when none is supplied (fx ~ 0.95 * W)."""
    fx = 0.95 * width
    K = projection.intrinsics_matrix(fx, fx, (width - 1) / 2.0,
                                     (height - 1) / 2.0, device=device)
    return K.expand(batch, 3, 3).contiguous()


def check_render_config(config: RenderConfig) -> None:
    """Reject RenderConfig values that name no route or splat method."""
    resolve_use_pallas(config.use_pallas)  # raises on a value it does not know
    check_splat_method(config.splat_method)


@torch.inference_mode()
def predict_ldi(image: torch.Tensor, model: LDIPredictor,
                intrinsics: Optional[torch.Tensor] = None) -> LDI:
    """LDI prediction: image (B, H, W, 3) in [0, 1] -> LDI."""
    if intrinsics is None:
        b, h, w, _ = image.shape
        intrinsics = default_intrinsics(b, h, w, device=image.device)
    return model(image, intrinsics)


@torch.inference_mode()
def render(ldi: LDI, pose: torch.Tensor,
           config: Optional[RenderConfig] = None,
           K_trg: Optional[torch.Tensor] = None,
           out_hw=None) -> torch.Tensor:
    """Render an LDI into the camera at ``pose`` (source->target, (B,4,4)).

    Returns the composited novel-view RGB (B, Ho, Wo, 3). For the full
    render dict (disparity, coverage) use ``geometry.ldi.render_forward``.
    On the windowed route with ``config.window_check`` it warns when the
    window dropped content (``geometry.ldi.warn_window_drop``).
    """
    config = config or RenderConfig()
    check_render_config(config)
    out = render_forward(ldi, pose, K_trg=K_trg, out_hw=out_hw,
                         zbuffer_scale=config.zbuffer_scale,
                         splat_method=config.splat_method,
                         use_pallas=config.use_pallas,
                         pallas_max_dy=config.pallas_max_dy,
                         check_window=config.window_check)
    if config.window_check and resolve_use_pallas(config.use_pallas):
        warn_window_drop(out["window_dropped_frac"], config.pallas_max_dy)
    return out["rgb"]


class LSIModel:
    """Bundles (config, network): the user-facing handle.

    >>> model = LSIModel.init(0, config, device="cuda")
    >>> ldi = model.predict_ldi(image)
    >>> novel = model.render(ldi, pose)
    """

    def __init__(self, config: Config, net: LDIPredictor):
        self.config = config
        self.net = net.eval()

    @classmethod
    def init(cls, seed: int, config: Optional[Config] = None,
             height: Optional[int] = None, width: Optional[int] = None,
             device="cuda") -> "LSIModel":
        """Random weights drawn from ``seed`` (on the CPU, so every device
        gets the same ones), moved to ``device`` (the card unless the
        caller asks for the CPU). ``height``/``width`` (default: the
        config's data size) are checked against the UNet's downsampling."""
        config = config or Config()
        h = height or config.data.height
        w = width or config.data.width
        k = 2 ** config.model.num_scales
        if h % k or w % k:
            raise ValueError(
                f"image size {h}x{w} must be divisible by 2**num_scales={k}")
        net = LDIPredictor(config.model)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return cls(config, net.to(device))

    def predict_ldi(self, image: torch.Tensor,
                    intrinsics: Optional[torch.Tensor] = None) -> LDI:
        return predict_ldi(image, self.net, intrinsics)

    def render(self, ldi: LDI, pose: torch.Tensor, **kw) -> torch.Tensor:
        return render(ldi, pose, config=self.config.render, **kw)

    def save(self, path: str) -> None:
        """Write the JAX package's format: ``params/<flax path>`` arrays and
        the config as JSON under ``__config__``."""
        out = {"params/" + k: v
               for k, v in jax_from_state_dict(self.net.state_dict()).items()}
        out["__config__"] = np.frombuffer(
            json.dumps(dataclasses.asdict(self.config)).encode(), np.uint8)
        np.savez(path, **out)

    @classmethod
    def load(cls, path: str, device="cuda") -> "LSIModel":
        """Read a file written by :meth:`save` or by
        ``lsi_tpu.api.LSIModel.save`` onto ``device`` (the card unless the
        caller asks for the CPU)."""
        with np.load(path) as data:
            config = Config.from_dict(
                json.loads(bytes(data["__config__"]).decode()))
            params = {k: data[k] for k in data.files
                      if k.startswith("params/")}
        net = LDIPredictor(config.model)
        net.load_state_dict(state_dict_from_jax(params, config.model))
        return cls(config, net.to(device))
