"""The device an entry point runs on.

A leaf module (``torch`` alone), so the data layer and the parallel
launcher can resolve a device without importing the model or the API.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (there is no
    fallback to the CPU: the caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch finds no CUDA device; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
