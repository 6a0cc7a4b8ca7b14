"""LDI prediction heads: image -> per-layer (texture, disparity).

PyTorch counterpart of ``lsi_tpu/models/ldi_predictor.py`` (the forward
pass). L disparity maps come from sigmoids with the depth ordering built
in multiplicatively (deeper layer = smaller disparity by construction);
layer 0's texture is the input image unless
``layer0_texture_from_input=False``, and the other textures are predicted.
Also the layer-0/deep parameter partition: ``freeze_layer0_grad_mask``
and ``splice_layer0_params``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from lsi_tpu_torch.config import ModelConfig
from lsi_tpu_torch.geometry.ldi import LDI
from lsi_tpu_torch.models.unet import Conv3x3, UNet, reset_submodules

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(
            f"compute_dtype must be one of {sorted(_DTYPES)}, "
            f"got {cfg.compute_dtype!r}") from None


def _layer0_owned_channels(cfg: ModelConfig, name: str) -> int:
    """How much of a parameter (``state_dict`` name) layer 0's output
    depends on: -1 for the whole tensor (the shared UNet trunk), N for the
    leading N output channels (channel 0 of ``disp_head``; channels 0-2 of
    ``tex_head`` when layer 0's texture is predicted), 0 for none. Output
    channels are dim 0 of a conv weight and of its bias."""
    module = name.split(".")[0]
    if module == "unet":
        return -1
    if module == "disp_head":
        return 1
    if module == "tex_head" and not cfg.layer0_texture_from_input:
        return 3
    return 0


def freeze_layer0_grad_mask(cfg: ModelConfig,
                            tree: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """Zero the entries of a {parameter name: gradient or update} dict that
    feed layer 0's output (a new dict; the inputs are not changed).

    The trainer applies it to the gradients AND to the optimizer's updates
    (Adam's momentum would otherwise keep moving frozen parameters), so
    layer 0 stays bitwise constant (``train.freeze_layer0_step``).
    """
    out = {}
    for name, g in tree.items():
        n = _layer0_owned_channels(cfg, name)
        if n < 0:
            g = torch.zeros_like(g)
        elif n:
            g = g.clone()
            g[:n] = 0.0
        out[name] = g
    return out


def splice_layer0_params(cfg: ModelConfig, live: Dict[str, torch.Tensor],
                         best: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The value side of :func:`freeze_layer0_grad_mask`'s partition: every
    entry layer 0's output depends on is taken from ``best`` (the run's
    best-eval export), the rest keeps its ``live`` value. A new dict on
    ``live``'s devices and dtypes; the inputs are not changed.

    At the freeze boundary (``train.freeze_layer0_from_best``) this makes
    layer 0 the best geometry the run measured, and the freeze then keeps
    it bitwise constant.
    """
    out = {}
    for name, lv in live.items():
        n = _layer0_owned_channels(cfg, name)
        bv = best[name].to(device=lv.device, dtype=lv.dtype)
        if n < 0:
            lv = bv.clone()
        elif n:
            lv = lv.clone()
            lv[:n] = bv[:n]
        out[name] = lv
    return out


class LDIPredictor(nn.Module):
    """Parameter names mirror the Flax module: ``unet`` (``UNet_0``),
    ``disp_head`` and ``tex_head``."""

    def __init__(self, config: ModelConfig = ModelConfig()):
        super().__init__()
        if config.family != "ldi":
            raise ValueError(f"LDIPredictor builds family 'ldi', not "
                             f"{config.family!r} (models.build_model "
                             "dispatches on the family)")
        if config.deep_heads_stopgrad_trunk:
            raise NotImplementedError(
                "deep_heads_stopgrad_trunk is a refuted knob and is not "
                "ported (ROADMAP 'Do not port')")
        self.config = config
        dtype = compute_dtype(config)
        l = config.num_layers
        f = config.base_filters
        self.unet = UNet(3, f, config.num_scales, dtype)
        self.disp_head = Conv3x3(f, l)
        self.num_tex = l - 1 if config.layer0_texture_from_input else l
        self.tex_head = Conv3x3(f, self.num_tex * 3) if self.num_tex else None

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Flax's default init, drawn from ``generator`` in module order."""
        reset_submodules(self, generator)

    def forward(self, image: torch.Tensor, intrinsics: torch.Tensor) -> LDI:
        """image (B, H, W, 3) in [0, 1]; intrinsics (B, 3, 3) -> LDI."""
        cfg = self.config
        b, h, w, _ = image.shape
        l = cfg.num_layers

        # NHWC -> NCHW view: channels_last in memory.
        feats = self.unet(image.permute(0, 3, 1, 2))

        # Layer 0: d0 = dmin + (dmax - dmin) * sigmoid(raw0).
        # Layer i>0: d_i = d_{i-1} * (r + (cap - r) * sigmoid(raw_i)).
        sig = torch.sigmoid(self.disp_head(feats).float())  # (B, L, H, W)
        d0 = (cfg.min_disparity
              + (cfg.max_disparity - cfg.min_disparity) * sig[:, 0])
        disps = [d0]
        for i in range(1, l):
            ratio = (cfg.ordering_floor
                     + (cfg.ordering_cap - cfg.ordering_floor) * sig[:, i])
            disps.append(disps[-1] * ratio)
        disparity = torch.stack(disps, dim=1)[..., None]  # (B, L, H, W, 1)

        chunks = []
        if cfg.layer0_texture_from_input:
            chunks.append(image.float()[:, None])  # (B, 1, H, W, 3)
        if self.num_tex:
            tex = torch.sigmoid(self.tex_head(feats).float())
            # Channel 3k + c is layer k's colour c, as in the Flax head.
            tex = tex.reshape(b, self.num_tex, 3, h, w).permute(0, 1, 3, 4, 2)
            chunks.append(tex)
        textures = torch.cat(chunks, dim=1).contiguous()

        return LDI(textures=textures, disparities=disparity.contiguous(),
                   intrinsics=intrinsics.float())
