"""Batches: the ``Batch`` container, on-device decode, and the synthetic
batch stream.

PyTorch counterpart of ``lsi_tpu/data/pipeline.py`` (``Batch``,
``decode_batch``, the synthetic example and batch streams). Not ported
yet (ROADMAP Queue 1, M7): the KITTI and SYNTHIA readers, materialized
datasets (``data.root``) and the background prefetch thread; the stream
here builds each batch on the calling thread.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from lsi_tpu_torch.config import DataConfig
from lsi_tpu_torch.data import synthetic


@dataclasses.dataclass
class Batch:
    src_image: torch.Tensor       # (B, H, W, 3)
    trg_image: torch.Tensor       # (B, H, W, 3)
    intrinsics: torch.Tensor      # (B, 3, 3)
    pose_src2trg: torch.Tensor    # (B, 4, 4)
    gt_disparity: Optional[torch.Tensor] = None   # (B, H, W, 1)
    gt_valid: Optional[torch.Tensor] = None       # (B, H, W, 1)
    trg_gt_disparity: Optional[torch.Tensor] = None  # (B, H, W, 1)
    trg_gt_valid: Optional[torch.Tensor] = None      # (B, H, W, 1)


def decode_batch(batch: Batch) -> Batch:
    """Storage dtypes -> float32 on the batch's device: integer images are
    divided by 255 (float images pass as they are), every other field is
    cast (a no-op for float32)."""
    def decode(name, x):
        if x is None:
            return None
        if name.endswith("image"):
            return x if x.is_floating_point() else x.float() / 255.0
        return x.float()

    return Batch(**{f.name: decode(f.name, getattr(batch, f.name))
                    for f in dataclasses.fields(Batch)})


def _example_stream(cfg: DataConfig, seed: int, repeat: bool):
    """Stream of single-example numpy dicts (synthetic scenes only)."""
    if cfg.dataset != "synthetic" or cfg.root:
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} (root {cfg.root!r}) is not ported yet: "
            "the port streams generated synthetic scenes only (ROADMAP "
            "Queue 1, M7)")
    # The val split is a disjoint seed range.
    if cfg.split == "val":
        seed = seed + 0x5EED_0FF5
    epoch = 0
    while True:
        for i in range(1024):
            yield synthetic.scene_example(cfg.synthetic_scene, seed, epoch,
                                          i, cfg.height, cfg.width)
        if not repeat:
            return
        epoch += 1


def batch_stream(cfg: DataConfig, seed: int = 0, repeat: bool = True,
                 device="cuda", examples: Optional[slice] = None
                 ) -> Iterator[Batch]:
    """Batches of ``cfg.batch_size`` examples as tensors on ``device``
    (the card unless the caller asks for the CPU). With ``examples``, only
    that slice of each batch is kept: a data-parallel rank makes the whole
    global batch from the seed and keeps its share, so its batches are
    the ones JAX's sharded stream gives that shard."""
    buf = []
    for ex in _example_stream(cfg, seed, repeat):
        buf.append(ex)
        if len(buf) == cfg.batch_size:
            keep = buf if examples is None else buf[examples]
            yield Batch(**{k: torch.from_numpy(np.stack([e[k] for e in keep]))
                           .to(device) for k in keep[0]})
            buf = []
