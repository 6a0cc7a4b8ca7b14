"""Video export of a trajectory sweep: PNG frames and an animated GIF.

PyTorch counterpart of ``lsi_tpu/evaluation/video.py``. After
``trajectory.render_trajectory`` gives (T, B, H, W, 3) frames:
:func:`save_frames` writes one PNG per view with the standard library's
zlib (``png.write_png``; the same pixels as the JAX package's PIL
files), and :func:`save_gif` writes the GIF with PIL, as the JAX package
does, byte for byte the same file. Without PIL, :func:`save_gif` raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lsi_tpu_torch.evaluation.png import write_png


def _uint8_frames(frames, batch_index: int) -> np.ndarray:
    """(T, H, W, 3) uint8 of one batch entry: clipped to [0, 1], times 255,
    truncated (as JAX's export)."""
    if isinstance(frames, torch.Tensor):
        frames = frames.detach().cpu().numpy()
    arr = np.clip(np.asarray(frames), 0.0, 1.0)
    return (arr[:, batch_index] * 255).astype(np.uint8)


def save_frames(frames, out_dir: str, batch_index: int = 0,
                prefix: str = "view") -> list:
    """Write each trajectory frame as a PNG; returns the file paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for t, img in enumerate(_uint8_frames(frames, batch_index)):
        path = os.path.join(out_dir, f"{prefix}_{t:04d}.png")
        write_png(path, img)
        paths.append(path)
    return paths


def save_gif(frames, path: str, batch_index: int = 0,
             fps: int = 15, loop: int = 0) -> str:
    """Write the trajectory as an animated GIF (PIL); returns ``path``."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "save_gif writes the GIF with PIL, which is not installed here; "
            "write the frames as PNGs with video.save_frames instead") from e

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    imgs = [Image.fromarray(img)
            for img in _uint8_frames(frames, batch_index)]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(1, 1000 // fps), loop=loop)
    return path
