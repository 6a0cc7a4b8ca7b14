"""Small numeric helpers shared across the geometry / render stack.

PyTorch counterpart of ``lsi_tpu/utils/helpers.py``.
"""

from __future__ import annotations

import torch

# Epsilon used when normalizing splat accumulators by accumulated weight.
DEFAULT_EPS = 1e-8


def divide_safe(num: torch.Tensor, den: torch.Tensor,
                eps: float = DEFAULT_EPS) -> torch.Tensor:
    """``num / den`` that returns 0 where ``|den| <= eps``.

    The denominator is replaced by 1 BEFORE dividing, so the masked entries
    never hold inf/nan and their gradient is 0 as well (a ``where`` after
    an unguarded division would back-propagate nan).
    """
    den_ok = den.abs() > eps
    safe_den = torch.where(den_ok, den, torch.ones_like(den))
    return torch.where(den_ok, num / safe_den, torch.zeros_like(num))


def flatten_layers(x: torch.Tensor) -> torch.Tensor:
    """(B, L, H, W, C) -> (B*L, H, W, C): fold the layer axis into batch."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def unflatten_layers(x: torch.Tensor, num_layers: int) -> torch.Tensor:
    """(B*L, ...) -> (B, L, ...): inverse of :func:`flatten_layers`."""
    return x.reshape((x.shape[0] // num_layers, num_layers)
                     + tuple(x.shape[1:]))
