"""The LDI network (UNet trunk, disparity and texture heads) as a function
of a parameter dict named as the port's ``state_dict``.

Copied from ``lsi_tpu_torch/models/unet.py`` and
``models/ldi_predictor.py`` (Flax's padding of the stride-2 conv, the
flipped 4x4 transposed conv, GroupNorm with eps 1e-6 and ``min(8, C)``
groups in float32). The convolutions run in ``prec.conv``
(``precision.py``); the port runs them in the configuration's
``compute_dtype``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference.geometry import LDI
from h100_bench.reference.precision import (REFERENCE, Precision,
                                            conv_operand, conv_result)

GROUPNORM_EPS = 1e-6
# The std of a unit normal truncated to [-2, 2] (Flax's lecun_normal).
TRUNC_STD = 0.87962566103423978


def scale_filters(base_filters: int, num_scales: int) -> List[int]:
    return [min(base_filters * (2 ** i), base_filters * 8)
            for i in range(num_scales)]


def param_specs(model: dict) -> List[Tuple[str, tuple, str, float]]:
    """Every parameter as ``(name, shape, init, std)``: ``init`` is
    "normal" (a unit normal truncated to [-2, 2], times ``std``), "zeros"
    or "ones". Names and shapes are the port's ``state_dict``'s."""
    specs = []

    def conv(name, cin, cout, bias=True):
        std = math.sqrt(1.0 / (9 * cin)) / TRUNC_STD
        specs.append((f"{name}.weight", (cout, cin, 3, 3), "normal", std))
        if bias:
            specs.append((f"{name}.bias", (cout,), "zeros", 0.0))

    def norm(name, c):
        specs.append((f"{name}.weight", (c,), "ones", 0.0))
        specs.append((f"{name}.bias", (c,), "zeros", 0.0))

    f, ns, l = model["base_filters"], model["num_scales"], model["num_layers"]
    filts = scale_filters(f, ns)
    cin = 3
    for i, c in enumerate(filts):
        conv(f"unet.enc{i}a.conv", cin, c)
        if i > 0:
            norm(f"unet.enc{i}a.norm", c)
        conv(f"unet.enc{i}b.conv", c, c)
        norm(f"unet.enc{i}b.norm", c)
        cin = c
    conv("unet.bottleneck.conv", cin, filts[-1])
    norm("unet.bottleneck.norm", filts[-1])
    cin = filts[-1]
    for i in reversed(range(ns)):
        c = filts[i]
        std = math.sqrt(1.0 / (16 * cin)) / TRUNC_STD
        specs.append((f"unet.dec{i}.up.weight", (cin, c, 4, 4), "normal", std))
        specs.append((f"unet.dec{i}.up.bias", (c,), "zeros", 0.0))
        conv(f"unet.dec{i}.skip", c, c, bias=False)
        if i > 0:
            norm(f"unet.dec{i}.norm", c)
        cin = c
    num_tex = l - 1 if model["layer0_texture_from_input"] else l
    if model["deep_heads_stopgrad_trunk"] and l > 1:
        conv("deep_trunk", f, f)
        conv("disp_head", f, 1)
        conv("disp_head_deep", f, l - 1)
        if not model["layer0_texture_from_input"]:
            conv("tex_head", f, 3)
        conv("tex_head_deep", f, (l - 1) * 3)
    else:
        conv("disp_head", f, l)
        if num_tex:
            conv("tex_head", f, num_tex * 3)
    return specs


def _conv3x3(p, name, x, prec, stride=1):
    w = conv_operand(p[f"{name}.weight"], prec)
    b = p.get(f"{name}.bias")
    x = conv_operand(x, prec)
    if stride == 1:
        y = F.conv2d(x, w, None, padding=1)
    else:
        y = F.conv2d(F.pad(x, (0, 1, 0, 1)), w, None, stride=stride)
    if b is not None:
        y = y + b.float()[None, :, None, None]
    return conv_result(y, prec)


def _norm(p, name, x):
    c = x.shape[1]
    y = F.group_norm(x.float(), min(8, c), p[f"{name}.weight"].float(),
                     p[f"{name}.bias"].float(), eps=GROUPNORM_EPS)
    return y.to(x.dtype)


def _block(p, name, x, prec, stride=1, use_norm=True):
    x = _conv3x3(p, f"{name}.conv", x, prec, stride)
    if use_norm:
        x = _norm(p, f"{name}.norm", x)
    return F.relu(x)


def _up(p, name, x, skip, prec, use_norm):
    w = conv_operand(p[f"{name}.up.weight"], prec)
    y = F.conv_transpose2d(conv_operand(x, prec), w, None, stride=2,
                           padding=1)
    y = conv_result(y + p[f"{name}.up.bias"].float()[None, :, None, None],
                    prec)
    merged = y + _conv3x3(p, f"{name}.skip", skip, prec)
    if use_norm:
        merged = _norm(p, f"{name}.norm", merged)
    return F.relu(merged)


def unet(p: Dict[str, torch.Tensor], x, model: dict, prec: Precision):
    ns = model["num_scales"]
    skips = []
    for i in range(ns):
        x = _block(p, f"unet.enc{i}a", x, prec, use_norm=i > 0)
        skips.append(x)
        x = _block(p, f"unet.enc{i}b", x, prec, stride=2)
    x = _block(p, "unet.bottleneck", x, prec)
    for i in reversed(range(ns)):
        x = _up(p, f"unet.dec{i}", x, skips[i], prec, use_norm=i > 0)
    return x


def predict(p: Dict[str, torch.Tensor], image, intrinsics, model: dict,
            prec: Precision = REFERENCE) -> LDI:
    """image (B, H, W, 3) in [0, 1], intrinsics (B, 3, 3) -> LDI."""
    b, h, w, _ = image.shape
    l = model["num_layers"]
    k = 2 ** model["num_scales"]
    if h % k or w % k:
        raise ValueError(f"image size {h}x{w} must be divisible by {k}")
    isolated = model["deep_heads_stopgrad_trunk"] and l > 1
    feats = unet(p, image.permute(0, 3, 1, 2), model, prec)
    if isolated:
        deep = torch.relu(_conv3x3(p, "deep_trunk", feats.detach(), prec))
        raw_disp = torch.cat([_conv3x3(p, "disp_head", feats, prec),
                              _conv3x3(p, "disp_head_deep", deep, prec)], 1)
    else:
        raw_disp = _conv3x3(p, "disp_head", feats, prec)
    sig = torch.sigmoid(raw_disp.float())
    lo, hi = model["min_disparity"], model["max_disparity"]
    floor, cap = model["ordering_floor"], model["ordering_cap"]
    disps = [lo + (hi - lo) * sig[:, 0]]
    for i in range(1, l):
        base = disps[-1].detach() if isolated else disps[-1]
        disps.append(base * (floor + (cap - floor) * sig[:, i]))
    disparity = torch.stack(disps, dim=1)[..., None]
    num_tex = l - 1 if model["layer0_texture_from_input"] else l
    chunks = []
    if model["layer0_texture_from_input"]:
        chunks.append(image.float()[:, None])
    if num_tex:
        if isolated:
            parts = ([] if model["layer0_texture_from_input"]
                     else [_conv3x3(p, "tex_head", feats, prec)])
            raw_tex = torch.cat(parts + [_conv3x3(p, "tex_head_deep", deep,
                                                  prec)], 1)
        else:
            raw_tex = _conv3x3(p, "tex_head", feats, prec)
        tex = torch.sigmoid(raw_tex.float())
        chunks.append(tex.reshape(b, num_tex, 3, h, w).permute(0, 1, 3, 4, 2))
    return LDI(torch.cat(chunks, dim=1).contiguous(), disparity.contiguous(),
               intrinsics.float())

