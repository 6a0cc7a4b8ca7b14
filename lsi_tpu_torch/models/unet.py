"""UNet encoder-decoder backbone.

PyTorch counterpart of ``lsi_tpu/models/unet.py``. Tensors inside are
NCHW; an NHWC input permuted to NCHW is already ``channels_last`` in
memory, which cuDNN's bf16 convolutions prefer, so the layout carries
through without copies.

Parameters stay float32; each layer casts them to the compute dtype of
its input, as Flax modules built with ``dtype=bfloat16`` do. Where Flax
and PyTorch differ, the port follows Flax:

* a 3x3 stride-2 ``"SAME"`` conv pads (0, 1) rows and columns, not (1, 1);
* the 4x4 stride-2 ``"SAME"`` transposed conv equals
  ``conv_transpose2d(stride=2, padding=1)`` with the kernel flipped
  spatially (the flip is done once, by the weight converter);
* GroupNorm uses eps 1e-6 and ``min(8, features)`` groups, and takes its
  statistics in float32 before casting back to the compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

GROUPNORM_EPS = 1e-6


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """Flax's default kernel init: truncated normal, variance 1 / fan_in."""
    # Std of a unit normal truncated to [-2, 2]; dividing by it keeps the
    # variance at 1 / fan_in after truncation.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class Conv3x3(nn.Module):
    """3x3 conv with Flax ``"SAME"`` padding, at stride 1 or 2."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 bias: bool = True):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.stride == 1:
            return F.conv2d(x, w, b, padding=1)
        # Even input, stride 2: Flax's SAME pads 0 before and 1 after.
        return F.conv2d(F.pad(x, (0, 1, 0, 1)), w, b, stride=self.stride)


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm``: float32 statistics, eps 1e-6."""

    def __init__(self, features: int):
        super().__init__()
        self.num_groups = min(8, features)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         eps=GROUPNORM_EPS)
        return y.to(x.dtype)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 use_norm: bool = True):
        super().__init__()
        self.conv = Conv3x3(cin, features, stride)
        self.norm = GroupNorm(features) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x)


class ConvTranspose4x4(nn.Module):
    """4x4 stride-2 transposed conv, torch weight layout (in, out, 4, 4).

    Holds the Flax kernel flipped spatially (the converter flips it), so
    ``conv_transpose2d(stride=2, padding=1)`` equals Flax's ``"SAME"``
    transposed conv and doubles H and W.
    """

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        # Flax's kernel (4, 4, in, out) has fan_in 16 * in.
        lecun_normal_(self.weight, 16 * self.weight.shape[0], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), stride=2, padding=1)


class UpBlock(nn.Module):
    """2x upsample by a transposed conv, plus a skip conv added to it
    (equal to a conv of the concatenation, which is never built)."""

    def __init__(self, cin: int, cskip: int, features: int,
                 use_norm: bool = True):
        super().__init__()
        self.up = ConvTranspose4x4(cin, features)
        self.skip = Conv3x3(cskip, features, bias=False)
        self.norm = GroupNorm(features) if use_norm else None

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        merged = self.up(x) + self.skip(skip)
        if self.norm is not None:
            merged = self.norm(merged)
        return F.relu(merged)


def scale_filters(base_filters: int, num_scales: int) -> Sequence[int]:
    """Channels per scale: doubling per downsampling, capped at 8x base."""
    return [min(base_filters * (2 ** i), base_filters * 8)
            for i in range(num_scales)]


class UNet(nn.Module):
    """(B, C, H, W) -> (B, base_filters, H, W) features in ``dtype``.

    Block names follow the Flax module (``enc{i}a``, ``enc{i}b``,
    ``bottleneck``, ``dec{i}``) so the weight converter maps them 1:1.
    """

    def __init__(self, in_channels: int = 3, base_filters: int = 32,
                 num_scales: int = 5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_scales = num_scales
        self.dtype = dtype
        filts = scale_filters(base_filters, num_scales)
        cin = in_channels
        for i, f in enumerate(filts):
            # Norm-free at full resolution, as in the reference.
            self.add_module(f"enc{i}a", ConvBlock(cin, f, use_norm=i > 0))
            self.add_module(f"enc{i}b", ConvBlock(f, f, stride=2))
            cin = f
        self.bottleneck = ConvBlock(cin, filts[-1])
        cin = filts[-1]
        for i in reversed(range(num_scales)):
            self.add_module(f"dec{i}",
                            UpBlock(cin, filts[i], filts[i], use_norm=i > 0))
            cin = filts[i]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        k = 2 ** self.num_scales
        if h % k or w % k:
            raise ValueError(
                f"image size {h}x{w} must be divisible by 2**num_scales={k}")
        x = x.to(self.dtype)
        skips = []
        for i in range(self.num_scales):
            x = getattr(self, f"enc{i}a")(x)
            skips.append(x)
            x = getattr(self, f"enc{i}b")(x)
        x = self.bottleneck(x)
        for i in reversed(range(self.num_scales)):
            x = getattr(self, f"dec{i}")(x, skips[i])
        return x
