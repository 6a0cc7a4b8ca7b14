"""In which precision the reference runs: float32 with TF32 off (the
reference), or one step below what the configuration states (the
control).

The configurations state bfloat16 convolutions (``compute_dtype``) and
float32 everywhere else. The step below is fp8 (e4m3, one scale per
tensor, float32 accumulation, bfloat16 outputs; gradients e5m2) for the
convolutions, and bfloat16 for the render, the splat and the gather and
for the parameters and the optimizer's moments (``CONTROL``). A second
control, ``CONTROL_COMPUTE``, lowers only the arithmetic (fp8
convolutions, a bfloat16 render) and keeps the parameters and moments in
float32, so that training's check has to see a lower precision of the
network and the render by itself, and not only through the state.
"""

from __future__ import annotations

import dataclasses

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@dataclasses.dataclass(frozen=True)
class Precision:
    conv: str            # "float32", "bfloat16" or "fp8"
    render: torch.dtype  # the splat's and the gather's arithmetic
    state: torch.dtype   # the parameters and the optimizer's moments


REFERENCE = Precision(conv="float32", render=torch.float32,
                      state=torch.float32)
CONTROL = Precision(conv="fp8", render=torch.bfloat16, state=torch.bfloat16)
CONTROL_COMPUTE = Precision(conv="fp8", render=torch.bfloat16,
                            state=torch.float32)
#: The configurations' own precisions (bfloat16 convolutions, float32
#: elsewhere): a witness, not a control.
BF16_CONVOLUTIONS = Precision(conv="bfloat16", render=torch.float32,
                              state=torch.float32)


def exact_float32() -> None:
    """Turn TF32 off for every float32 product of the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _quantize(x: torch.Tensor, dtype: torch.dtype, top: float):
    """``x`` rounded to ``dtype`` under one scale that maps its largest
    magnitude to ``top``, and back to float32."""
    x = x.float()
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """e4m3 forward; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return _quantize(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """The identity forward; the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _quantize(g, torch.float8_e5m2, E5M2_MAX).to(g.dtype)


def conv_operand(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """A convolution's input or weight as ``prec`` computes with it."""
    if prec.conv == "fp8":
        return _Fp8.apply(x)
    if prec.conv == "bfloat16":
        return x.to(torch.bfloat16)
    return x.float()


def conv_result(y: torch.Tensor, prec: Precision) -> torch.Tensor:
    """A convolution's output as ``prec`` stores it."""
    if prec.conv == "fp8":
        return _Fp8Grad.apply(y.to(torch.bfloat16))
    return y
