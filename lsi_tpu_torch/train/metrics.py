"""Metric logging: scalars to a jsonl file and to stdout.

PyTorch counterpart of ``lsi_tpu/train/metrics.py`` (the same lines, so
either package's ``train.jsonl`` reads the same).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricWriter:
    """Appends one JSON object per ``write`` to ``<log_dir>/<name>.jsonl``
    (line-buffered) and echoes a ``[step N] k=v ...`` line."""

    def __init__(self, log_dir: Optional[str] = None, name: str = "train"):
        self._file = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, f"{name}.jsonl"), "a",
                              buffering=1)
        self._t0 = time.time()

    def write(self, step: int, scalars: Dict[str, float],
              echo: bool = True) -> None:
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
        if echo:
            parts = " ".join(f"{k}={float(v):.5g}"
                             for k, v in scalars.items())
            print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
