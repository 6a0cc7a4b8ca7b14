"""Deterministic train/val splitting at the group (drive/sequence) level.

A copy of ``lsi_tpu/data/splits.py``, owned by the port.

The reference evaluated view synthesis on held-out pairs (SURVEY.md §3.4);
splitting at the *group* level (a whole KITTI drive / SYNTHIA sequence goes
entirely to one side) prevents near-duplicate adjacent frames from leaking
between train and val, which a per-frame split would allow.
"""

from __future__ import annotations

from typing import Callable, List, TypeVar

T = TypeVar("T")


def split_records(records: List[T], key_fn: Callable[[T], str],
                  split: str, val_fraction: float = 0.1) -> List[T]:
    """Filter records to the requested split, grouping by ``key_fn``.

    Groups are sorted by key and every k-th group (k ≈ 1/val_fraction) is
    assigned to val — deterministic, order-independent, and stable as new
    groups are added at the end of the sort order.
    """
    if split == "all":
        return records
    if split not in ("train", "val"):
        raise ValueError(f"unknown split {split!r}; use train|val|all")
    if not records:
        return records
    keys = sorted({key_fn(r) for r in records})
    k = max(2, int(round(1.0 / max(val_fraction, 1e-6))))
    val_keys = {key for i, key in enumerate(keys) if i % k == k - 1}
    if not val_keys:  # fewer groups than 1/val_fraction: hold out the last
        val_keys = {keys[-1]}
    if split == "val":
        keep = val_keys
    else:
        keep = set(keys) - val_keys
        if not keep:  # single-group dataset: train sees everything
            keep = set(keys)
    return [r for r in records if key_fn(r) in keep]
