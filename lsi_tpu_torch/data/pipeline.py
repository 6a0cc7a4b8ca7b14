"""Batches: the ``Batch`` container, on-device decode, the example streams
of every dataset, and the prefetch thread.

PyTorch counterpart of ``lsi_tpu/data/pipeline.py``. The datasets:
generated synthetic scenes, or with ``data.root`` the shards of
``data.materialize``; KITTI raw (``data.kitti``) and SYNTHIA-SEQS
(``data.synthia``). :func:`batch_stream` builds each batch on the calling
thread; :func:`make_dataset`, what the ``Trainer`` and the eval runner
read, builds them on a :class:`Prefetcher` thread that keeps
``data.prefetch`` batches on the device ahead of the consumer.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from lsi_tpu_torch.config import DataConfig
from lsi_tpu_torch.data import synthetic
from lsi_tpu_torch.device import resolve_device


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
    """Stream of single-example numpy dicts."""
    if cfg.dataset == "synthetic":
        if cfg.root:
            # Shards on disk (data.materialize) instead of generation.
            from lsi_tpu_torch.data.materialize import cached_example_stream
            yield from cached_example_stream(cfg, seed, repeat)
            return
        # The val split is a disjoint seed range.
        if cfg.split == "val":
            seed = seed + 0x5EED_0FF5
        epoch = 0
        while True:
            for i in range(1024):
                yield synthetic.scene_example(cfg.synthetic_scene, seed,
                                              epoch, i, cfg.height, cfg.width)
            if not repeat:
                return
            epoch += 1
    elif cfg.dataset == "kitti":
        from lsi_tpu_torch.data import kitti
        yield from kitti.example_stream(cfg, seed, repeat)
    elif cfg.dataset == "synthia":
        from lsi_tpu_torch.data import synthia
        yield from synthia.example_stream(cfg, seed, repeat)
    else:
        raise ValueError(f"unknown dataset {cfg.dataset!r}")


def _array_batches(cfg: DataConfig, seed: int, repeat: bool,
                   examples: Optional[slice]
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Examples stacked into numpy batches of ``cfg.batch_size``; with
    ``examples``, only that slice of each batch is stacked."""
    buf = []
    for ex in _example_stream(cfg, seed, repeat):
        buf.append(ex)
        if len(buf) == cfg.batch_size:
            keep = buf if examples is None else buf[examples]
            yield {k: np.stack([e[k] for e in keep]) for k in keep[0]}
            buf = []


def batch_stream(cfg: DataConfig, seed: int = 0, repeat: bool = True,
                 device="cuda", examples: Optional[slice] = None
                 ) -> Iterator[Batch]:
    """Batches of ``cfg.batch_size`` examples as tensors on ``device``
    (the card unless the caller asks for the CPU), built on the calling
    thread. With ``examples``, only that slice of each batch is kept: a
    data-parallel rank makes the whole global batch from the seed and
    keeps its share, so its batches are the ones JAX's sharded stream
    gives that shard."""
    for arrays in _array_batches(cfg, seed, repeat, examples):
        yield Batch(**{k: torch.from_numpy(v).to(device)
                       for k, v in arrays.items()})


class Prefetcher:
    """A thread that keeps ``depth`` batches on ``device`` ahead of the
    consumer (``lsi_tpu/data/pipeline.py:_Prefetcher``).

    On a CUDA device each batch is stacked into pinned host tensors and
    copied ``non_blocking`` on a side stream; the consumer's stream waits
    for the copy's event and the device tensors are recorded on that
    stream, so the caching allocator never hands their memory to another
    tensor early. The pinned buffers are a ring of ``depth + 1`` slots, and
    a slot is refilled only after its last copy has finished. On the CPU
    the stacked arrays are the batch: no pinning, no stream.

    A failure in the thread (a bad dataset root, a corrupt file, a copy
    error) is raised in the consumer, on this ``next`` and every later
    one; the consumer never hangs. :meth:`close` stops the thread.
    """

    def __init__(self, arrays: Iterator[Dict[str, np.ndarray]], depth: int,
                 device):
        self._it = arrays
        self._device = resolve_device(device)
        cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if cuda else None
        self._slots = [({}, [None]) for _ in range(depth + 1)] if cuda else []
        self._q: collections.deque = collections.deque()
        self._sem_space = threading.Semaphore(depth)
        self._sem_items = threading.Semaphore(0)
        self._closed = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, arrays: Dict[str, np.ndarray], index: int):
        """``arrays`` as a Batch on the device, and the event its copies
        recorded (None on the CPU)."""
        if self._stream is None:
            return Batch(**{k: torch.from_numpy(v)
                            for k, v in arrays.items()}), None
        pinned, copied = self._slots[index % len(self._slots)]
        if copied[0] is not None:
            copied[0].synchronize()
        out = {}
        with torch.cuda.stream(self._stream):
            for k, v in arrays.items():
                src = torch.from_numpy(v)
                buf = pinned.get(k)
                if buf is None or buf.shape != src.shape or \
                        buf.dtype != src.dtype:
                    buf = pinned[k] = torch.empty_like(src, pin_memory=True)
                buf.copy_(src)
                out[k] = buf.to(self._device, non_blocking=True)
            copied[0] = torch.cuda.Event()
            copied[0].record(self._stream)
        return Batch(**out), copied[0]

    def _fill(self):
        # Record any failure and ALWAYS release the item semaphore on exit,
        # so __next__ wakes up and re-raises instead of blocking.
        try:
            for i, arrays in enumerate(self._it):
                self._sem_space.acquire()
                if self._closed:
                    return
                self._q.append(self._put(arrays, i))
                self._sem_items.release()
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            self._error = e
        finally:
            self._sem_items.release()

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        self._sem_items.acquire()
        if not self._q:
            # Exhausted, failed or closed: stay so on every later call.
            self._sem_items.release()
            if self._error is not None:
                raise self._error
            raise StopIteration
        batch, copied = self._q.popleft()
        self._sem_space.release()
        if copied is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(copied)
            for f in dataclasses.fields(Batch):
                t = getattr(batch, f.name)
                if t is not None:
                    t.record_stream(stream)
        return batch

    def close(self) -> None:
        """Stop the thread (after the batch it may be making) and drop the
        batches in flight; ``next`` then raises StopIteration."""
        self._closed = True
        self._sem_space.release()
        self._thread.join(timeout=60)
        self._q.clear()


def make_dataset(cfg: DataConfig, seed: int = 0, repeat: bool = True,
                 device="cuda", examples: Optional[slice] = None
                 ) -> Prefetcher:
    """The input iterator for a config: :func:`batch_stream`'s batches,
    made on a :class:`Prefetcher` thread ``max(1, cfg.prefetch)`` deep.

    Args:
      cfg: data configuration (dataset, root, size, batch).
      seed: the stream's seed.
      repeat: loop forever (training) or one pass (eval).
      device: where the batches go; the card unless the caller asks for
        the CPU.
      examples: a data-parallel rank's share of each global batch.
    """
    return Prefetcher(_array_batches(cfg, seed, repeat, examples),
                      depth=max(1, cfg.prefetch), device=device)
