"""Checkpoints (save, rotate, resume) and the portable parameter export.

PyTorch counterpart of ``lsi_tpu/train/checkpoint.py``. Orbax gives way to
``torch.save`` of the parameters, the optimizer state and the step, one
file per step, written to a temporary name and renamed into place (a crash
leaves the previous checkpoint or the new one, never a torn file), with
the oldest files removed past ``max_to_keep``.

The ``.npz`` export keeps the JAX package's key format: '/'-joined Flax
parameter paths, Flax layouts, and ``__meta_<name>`` scalars inside the
same file. Each package reads the other's ``best_params.npz``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from lsi_tpu_torch.config import ModelConfig
from lsi_tpu_torch.models.convert import (jax_from_state_dict,
                                          state_dict_from_jax)

_CKPT = re.compile(r"^checkpoint_(\d+)\.pt$")


class CheckpointManager:
    """``checkpoint_<step>.pt`` files in ``directory``, newest
    ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self._dir = os.path.abspath(directory)
        self._keep = max(1, max_to_keep)
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"checkpoint_{step:08d}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_CKPT.match,
                                                   os.listdir(self._dir))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """Write ``state`` (a ``trainer.TrainState``) as step ``step``."""
        opt = dataclasses.asdict(dataclasses.replace(
            state.opt_state, mu={}, nu={}))
        opt["mu"] = _to_cpu(state.opt_state.mu)
        opt["nu"] = _to_cpu(state.opt_state.nu)
        blob = {"step": int(state.step),
                "params": _to_cpu(state.net.state_dict()),
                "opt_state": opt}
        path = self._path(step)
        torch.save(blob, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.steps()[:-self._keep]:
            os.remove(self._path(old))

    def restore_raw(self, step: Optional[int] = None) -> Optional[dict]:
        """The saved dict (``step``, ``params``, ``opt_state``) on the CPU,
        or None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load the latest checkpoint (or ``step``) into ``state`` in place
        and return it; unchanged when there is no checkpoint."""
        raw = self.restore_raw(step)
        if raw is None:
            return state
        state.net.load_state_dict(raw["params"])
        dev = next(state.net.parameters()).device
        opt = dict(raw["opt_state"])
        for key in ("mu", "nu"):
            opt[key] = {k: v.to(dev) for k, v in opt[key].items()}
        state.opt_state = type(state.opt_state)(**opt)
        state.step = int(raw["step"])
        return state


def _to_cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


#: Reserved key prefix for scalar metadata inside a params ``.npz``.
NPZ_META_PREFIX = "__meta_"


def export_params_npz(state_dict: Dict[str, torch.Tensor], path: str,
                      meta: Optional[dict] = None) -> None:
    """Write the port's parameters as the JAX package's ``.npz``: Flax
    paths and layouts, plus ``meta`` scalars as ``__meta_<name>`` entries
    in the same file (parameters and metadata commit together)."""
    out = jax_from_state_dict(state_dict)
    for k, v in (meta or {}).items():
        out[NPZ_META_PREFIX + k] = np.asarray(v)
    np.savez(path, **out)


def read_params_npz_meta(path: str) -> dict:
    """The ``meta`` dict stored by :func:`export_params_npz` (empty if
    none)."""
    with np.load(path) as data:
        return {k[len(NPZ_META_PREFIX):]: data[k].item()
                for k in data.files if k.startswith(NPZ_META_PREFIX)}


def import_params_npz(model_cfg: ModelConfig,
                      path: str) -> Dict[str, torch.Tensor]:
    """A JAX-format params ``.npz`` (either package's export) as the port's
    ``state_dict`` (float32, on the CPU)."""
    with np.load(path) as data:
        return state_dict_from_jax({k: data[k] for k in data.files},
                                   model_cfg)
