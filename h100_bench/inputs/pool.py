"""The input pool of a run: synthetic scenes drawn from ``--seed``.

Scene ``i`` of a run comes from ``numpy.random.SeedSequence([seed, i])``
alone (every bit of the seed counts), so the same seed gives the same
pool however it is made. The scenes are made on a few threads, joined
before the pool is returned.
"""

from __future__ import annotations

import concurrent.futures
from typing import Dict, List

import numpy as np

from h100_bench.inputs import synthetic

FIELDS = ("src_image", "trg_image", "intrinsics", "pose_src2trg",
          "gt_disparity", "gt_valid")


def scene(kind: str, seed: int, index: int, height: int,
          width: int) -> Dict[str, np.ndarray]:
    """One example as the port's ``data.synthetic.scene_example`` lays it
    out (the fields a training batch reads)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    make = synthetic.make_scene_multi if kind == "multi" \
        else synthetic.make_scene
    s = make(rng, height, width)
    return {"src_image": s.src_image, "trg_image": s.trg_image,
            "intrinsics": s.intrinsics, "pose_src2trg": s.pose_src2trg,
            "gt_disparity": s.gt_visible_disparity[..., None],
            "gt_valid": np.ones((height, width, 1), np.float32)}


def make_scenes(kind: str, seed: int, count: int, height: int, width: int,
                workers: int = 4, fields=FIELDS) -> List[Dict[str, np.ndarray]]:
    """Scenes ``0 .. count - 1`` of ``seed``, in order, each with the
    ``fields`` its traffic reads, made on ``workers`` threads (NumPy
    releases the interpreter lock in its array work)."""
    seed = int(seed) % 2**64

    def one(i):
        return {k: v for k, v in scene(kind, seed, i, height, width).items()
                if k in fields}

    with concurrent.futures.ThreadPoolExecutor(max(1, workers)) as ex:
        return list(ex.map(one, range(count)))


def stack(scenes: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}
