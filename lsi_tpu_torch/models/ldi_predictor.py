"""LDI prediction heads: image -> per-layer (texture, disparity).

PyTorch counterpart of ``lsi_tpu/models/ldi_predictor.py`` (the forward
pass). L disparity maps come from sigmoids with the depth ordering built
in multiplicatively (deeper layer = smaller disparity by construction);
layer 0's texture is the input image unless
``layer0_texture_from_input=False``, and the other textures are predicted.
With ``deep_heads_stopgrad_trunk`` (and L > 1) the deep layers' heads
read the trunk through ``detach()`` and a private 3x3 conv with a ReLU
(``deep_trunk``), so their training cannot move the trunk. Also the
layer-0/deep parameter partition: ``freeze_layer0_grad_mask`` and
``splice_layer0_params``.
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
    channels are dim 0 of a conv weight and of its bias.

    With ``deep_heads_stopgrad_trunk`` the heads ``disp_head`` (1 channel)
    and ``tex_head`` (3, when layer 0's texture is predicted) are layer 0's
    alone, so their leading slice is the whole tensor, and ``deep_trunk``,
    ``disp_head_deep`` and ``tex_head_deep`` count 0."""
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
    ``disp_head`` and ``tex_head``, and with ``deep_heads_stopgrad_trunk``
    ``deep_trunk``, ``disp_head_deep`` and ``tex_head_deep``."""

    def __init__(self, config: ModelConfig = ModelConfig()):
        super().__init__()
        if config.family != "ldi":
            raise ValueError(f"LDIPredictor builds family 'ldi', not "
                             f"{config.family!r} (models.build_model "
                             "dispatches on the family)")
        self.config = config
        dtype = compute_dtype(config)
        l = config.num_layers
        f = config.base_filters
        self.isolated = config.deep_heads_stopgrad_trunk and l > 1
        self.unet = UNet(3, f, config.num_scales, dtype)
        self.num_tex = l - 1 if config.layer0_texture_from_input else l
        if self.isolated:
            # Layer 0's heads on the live trunk, the deep layers' on the
            # private branch.
            self.deep_trunk = Conv3x3(f, f)
            self.disp_head = Conv3x3(f, 1)
            self.disp_head_deep = Conv3x3(f, l - 1)
            self.tex_head = (None if config.layer0_texture_from_input
                             else Conv3x3(f, 3))
            self.tex_head_deep = Conv3x3(f, (l - 1) * 3)
        else:
            self.disp_head = Conv3x3(f, l)
            self.tex_head = (Conv3x3(f, self.num_tex * 3) if self.num_tex
                             else None)

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
        if self.isolated:
            # The deep heads' branch reads the trunk without its gradient.
            feats_deep = torch.relu(self.deep_trunk(feats.detach()))
            raw_disp = torch.cat([self.disp_head(feats),
                                  self.disp_head_deep(feats_deep)], dim=1)
        else:
            raw_disp = self.disp_head(feats)

        # Layer 0: d0 = dmin + (dmax - dmin) * sigmoid(raw0).
        # Layer i>0: d_i = d_{i-1} * (r + (cap - r) * sigmoid(raw_i)); on
        # the isolated branch d_{i-1} is detached, so a deep layer's loss
        # cannot reach layer 0 through the product either.
        sig = torch.sigmoid(raw_disp.float())  # (B, L, H, W)
        d0 = (cfg.min_disparity
              + (cfg.max_disparity - cfg.min_disparity) * sig[:, 0])
        disps = [d0]
        for i in range(1, l):
            ratio = (cfg.ordering_floor
                     + (cfg.ordering_cap - cfg.ordering_floor) * sig[:, i])
            base = disps[-1].detach() if self.isolated else disps[-1]
            disps.append(base * ratio)
        disparity = torch.stack(disps, dim=1)[..., None]  # (B, L, H, W, 1)

        chunks = []
        if cfg.layer0_texture_from_input:
            chunks.append(image.float()[:, None])  # (B, 1, H, W, 3)
        if self.num_tex:
            if self.isolated:
                raw_tex = torch.cat(
                    ([] if self.tex_head is None else [self.tex_head(feats)])
                    + [self.tex_head_deep(feats_deep)], dim=1)
            else:
                raw_tex = self.tex_head(feats)
            tex = torch.sigmoid(raw_tex.float())
            # Channel 3k + c is layer k's colour c, as in the Flax head.
            tex = tex.reshape(b, self.num_tex, 3, h, w).permute(0, 1, 3, 4, 2)
            chunks.append(tex)
        textures = torch.cat(chunks, dim=1).contiguous()

        return LDI(textures=textures, disparities=disparity.contiguous(),
                   intrinsics=intrinsics.float())
