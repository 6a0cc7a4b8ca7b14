"""The card: presence, name, power limit and the memory peak."""

from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    pass


def require_cards(count: int) -> torch.device:
    """The first card, or NoCard where fewer than ``count`` are visible.
    The benchmark never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs on the card only")
    have = torch.cuda.device_count()
    if have < count:
        raise NoCard(f"the cell asks for {count} cards, {have} visible")
    return torch.device("cuda", 0)


def power_limit_w() -> float:
    """The card's power limit as ``nvidia-smi`` reads it (W)."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return float(out.splitlines()[0])


def describe(count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "power_limit_w": power_limit_w()}
