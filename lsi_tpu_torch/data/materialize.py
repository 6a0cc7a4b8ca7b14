"""Materialize synthetic datasets to disk — decouple scene generation from
training.

A port of ``lsi_tpu/data/materialize.py`` (numpy only; the shards are the
same bytes for the same seed, ``tests/test_torch_materialize.py``). The
analytic scene renderers are host-side numpy and hold the GIL: one
training process makes a multi-object 256x768 batch of 8 far more slowly
than the card steps on it. So scenes are generated once by worker
processes, stored as compact shards, and streamed from disk, where the
reads release the GIL and the prefetch thread
(``data.pipeline.Prefetcher``) overlaps them with the card.

Shard format (``shard_%05d.npz``): uint8 RGB (what PNG datasets store —
quantization 1/255), float16 disparities, float32 camera geometry. The
per-index seeding matches the online stream exactly, so a materialized
dataset contains the SAME scenes the online pipeline would have produced
for the same seed.

CLI::

    python -m lsi_tpu_torch.data.materialize --out /data/multi_cache \
        --scene multi --height 256 --width 768 --count 4096 --workers 8

Training then points at it: ``--set data.root=/data/multi_cache`` with
``data.dataset=synthetic`` (the root switches the synthetic stream from
online generation to shard streaming).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

SHARD_SIZE = 64
META_NAME = "dataset.json"


def _pack(examples) -> dict:
    def stack(key):
        return np.stack([e[key] for e in examples])

    return {
        "src_image": (stack("src_image") * 255.0 + 0.5).astype(np.uint8),
        "trg_image": (stack("trg_image") * 255.0 + 0.5).astype(np.uint8),
        "intrinsics": stack("intrinsics").astype(np.float32),
        "pose_src2trg": stack("pose_src2trg").astype(np.float32),
        "gt_disparity": stack("gt_disparity").astype(np.float16),
        "trg_gt_disparity": stack("trg_gt_disparity").astype(np.float16),
    }


def materialize(out_dir: str, kind: str = "multi", seed: int = 0,
                count: int = 1024, height: int = 256, width: int = 768,
                workers: int = 0, shard_size: int = SHARD_SIZE) -> int:
    """Generate ``count`` scenes into npz shards; returns shards written.

    ``workers`` > 0 uses forkserver worker processes (numpy-only thanks to
    the lazy package inits); 0 generates in-process. Examples are seeded
    per-index exactly like the online stream (epoch 0, indices 0..count).
    """
    from lsi_tpu_torch.data import synthetic

    os.makedirs(out_dir, exist_ok=True)

    def index_iter():
        # Same (epoch, i) walk as the online stream's keys().
        n = 0
        epoch = 0
        while n < count:
            for i in range(1024):
                if n >= count:
                    return
                yield (epoch, i)
                n += 1
            epoch += 1

    if workers > 0:
        import collections
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        ex = ProcessPoolExecutor(
            max_workers=workers, mp_context=mp.get_context("forkserver"))
        try:
            pending: collections.deque = collections.deque()

            def results():
                for epoch, i in index_iter():
                    pending.append(ex.submit(
                        synthetic.scene_example, kind, seed, epoch, i,
                        height, width))
                    if len(pending) >= 4 * workers:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()

            nshards = _write_shards(results(), out_dir, shard_size)
        finally:
            ex.shutdown(wait=False, cancel_futures=True)
    else:
        def results():
            for epoch, i in index_iter():
                yield synthetic.scene_example(kind, seed, epoch, i,
                                              height, width)

        nshards = _write_shards(results(), out_dir, shard_size)

    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump({"kind": kind, "seed": seed, "count": count,
                   "height": height, "width": width,
                   "shard_size": shard_size, "format": "v1"}, f)
    return nshards


def _write_shards(example_iter, out_dir: str, shard_size: int) -> int:
    buf = []
    shard_idx = 0
    for ex in example_iter:
        buf.append(ex)
        if len(buf) == shard_size:
            np.savez(os.path.join(out_dir, f"shard_{shard_idx:05d}.npz"),
                     **_pack(buf))
            buf = []
            shard_idx += 1
    if buf:
        np.savez(os.path.join(out_dir, f"shard_{shard_idx:05d}.npz"),
                 **_pack(buf))
        shard_idx += 1
    return shard_idx


def cached_example_stream(cfg, seed: int, repeat: bool):
    """Stream example dicts from a materialized dataset directory.

    Shard-level train/val split (whole shards held out, like KITTI drives);
    shard order and intra-shard order are reshuffled deterministically per
    (seed, epoch). Examples stay in STORAGE dtypes (uint8 RGB, f16
    disparity): a quarter of the host-to-device bytes of float32, and the
    train and eval steps decode them on the card
    (``pipeline.decode_batch``).
    """
    import glob as globlib

    from lsi_tpu_torch.data.splits import split_records

    files = sorted(globlib.glob(os.path.join(cfg.root, "shard_*.npz")))
    if not files:
        raise FileNotFoundError(
            f"no materialized shards (shard_*.npz) under {cfg.root!r}; "
            "generate with python -m lsi_tpu_torch.data.materialize")
    files = split_records(files, lambda f: f, cfg.split, cfg.val_fraction)
    if not files:
        raise ValueError(f"split {cfg.split!r} selected zero shards")

    epoch = 0
    while True:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed & 0xFFFFFFFF, 0x5A7A, epoch]))
        order = rng.permutation(len(files))
        for fi in order:
            with np.load(files[fi]) as data:
                # Materialize each array ONCE per shard — NpzFile re-reads
                # the whole member from the zip on every __getitem__.
                arrs = {k: data[k] for k in data.files}
            n = arrs["src_image"].shape[0]
            ones = np.ones(arrs["gt_disparity"].shape[1:], np.float16)
            for j in rng.permutation(n):
                yield {
                    "src_image": arrs["src_image"][j],
                    "trg_image": arrs["trg_image"][j],
                    "intrinsics": arrs["intrinsics"][j],
                    "pose_src2trg": arrs["pose_src2trg"][j],
                    "gt_disparity": arrs["gt_disparity"][j],
                    "gt_valid": ones,
                    "trg_gt_disparity": arrs["trg_gt_disparity"][j],
                    "trg_gt_valid": ones,
                }
        if not repeat:
            return
        epoch += 1


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m lsi_tpu_torch.data.materialize")
    ap.add_argument("--out", required=True)
    ap.add_argument("--scene", default="multi",
                    choices=("multi", "two_plane"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--count", type=int, default=1024)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    n = materialize(args.out, kind=args.scene, seed=args.seed,
                    count=args.count, height=args.height, width=args.width,
                    workers=args.workers)
    print(f"wrote {n} shards ({args.count} examples) to {args.out}")


if __name__ == "__main__":
    main()
