"""Convert model weights (the LDI predictor, the MPI baseline) between the
JAX (Flax) and PyTorch layouts.

Two JAX formats carry the same '/'-joined Flax parameter paths:

* ``lsi_tpu.api.LSIModel.save``: ``params/<path>`` keys plus a
  ``__config__`` JSON entry;
* ``lsi_tpu.train.checkpoint.export_params_npz``: bare ``<path>`` keys
  plus ``__meta_<name>`` scalars.

Names map 1:1 (``UNet_0`` -> ``unet``, ``Conv_0`` -> ``conv``,
``GroupNorm_0`` -> ``norm``, ``kernel``/``scale`` -> ``weight``; the heads
``disp_head``, ``tex_head`` and ``mpi_head`` keep their names), and
arrays change layout:

* conv kernel HWIO -> OIHW;
* transposed-conv kernel ``(4, 4, in, out)`` -> torch ``(in, out, 4, 4)``,
  flipped spatially (Flax applies it without the flip that torch's
  ``conv_transpose2d`` implies);
* GroupNorm ``scale`` -> ``weight``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from lsi_tpu_torch.config import ModelConfig

_MODULE_TO_TORCH = {"UNet_0": "unet", "Conv_0": "conv", "GroupNorm_0": "norm"}
_MODULE_TO_FLAX = {v: k for k, v in _MODULE_TO_TORCH.items()}
_SKIPPED_PREFIXES = ("__config__", "__meta_")


def _is_transposed(path) -> bool:
    return len(path) >= 2 and path[-2] == "up"


def torch_name(flax_key: str) -> str:
    """``UNet_0/enc1a/GroupNorm_0/scale`` -> ``unet.enc1a.norm.weight``."""
    *mods, leaf = flax_key.split("/")
    leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    return ".".join([_MODULE_TO_TORCH.get(m, m) for m in mods] + [leaf])


def flax_name(torch_key: str, is_norm: bool) -> str:
    """Inverse of :func:`torch_name` (``is_norm``: a GroupNorm weight)."""
    *mods, leaf = torch_key.split(".")
    if leaf == "weight":
        leaf = "scale" if is_norm else "kernel"
    return "/".join([_MODULE_TO_FLAX.get(m, m) for m in mods] + [leaf])


def to_torch(arr: np.ndarray, flax_key: str) -> torch.Tensor:
    """One Flax array -> the port's layout (a float32 copy)."""
    a = np.array(arr, np.float32)
    if flax_key.endswith("/kernel"):
        if _is_transposed(flax_key.split("/")):
            a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        else:
            a = a.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(a))


def to_flax(t: torch.Tensor, flax_key: str) -> np.ndarray:
    """One port tensor -> the Flax layout of ``flax_key``."""
    a = t.detach().float().cpu().numpy()
    if flax_key.endswith("/kernel"):
        if _is_transposed(flax_key.split("/")):
            a = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            a = a.transpose(2, 3, 1, 0)
    return np.ascontiguousarray(a)


def _expected_shapes(cfg: ModelConfig) -> dict:
    from lsi_tpu_torch.models import build_model

    with torch.device("meta"):
        net = build_model(cfg)
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def state_dict_from_jax(flat: Mapping[str, np.ndarray],
                        cfg: ModelConfig) -> dict:
    """Flax-path arrays (either JAX format) -> the port's ``state_dict``.

    ``__config__`` and ``__meta_*`` entries are skipped and a ``params/``
    prefix is stripped. Raises ``KeyError`` on a missing or left-over
    parameter and ``ValueError`` on a shape mismatch.
    """
    expected = _expected_shapes(cfg)
    out = {}
    for key, arr in flat.items():
        if key.startswith(_SKIPPED_PREFIXES):
            continue
        fkey = key[len("params/"):] if key.startswith("params/") else key
        name = torch_name(fkey)
        if name not in expected:
            raise KeyError(f"left-over parameter {key!r} (-> {name!r})")
        t = to_torch(arr, fkey)
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{key!r}: shape {tuple(t.shape)} after "
                             f"conversion, expected {expected[name]}")
        out[name] = t
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"missing parameters: {missing}")
    return out


def jax_from_state_dict(state: Mapping[str, torch.Tensor]) -> dict:
    """The port's ``state_dict`` -> '/'-joined Flax paths (numpy, float32)."""
    norm_weights = {k for k in state
                    if k.endswith(".weight") and state[k].ndim == 1}
    out = {}
    for name, t in state.items():
        fkey = flax_name(name, name in norm_weights)
        out[fkey] = to_flax(t, fkey)
    return out
